"""The poisoned replica's first decode step against float64, at several
seeds.

``chip_smoke.py``'s phase 9d ensemble (gemma3-1b at full width cut to 8
layers, 8 replicas, the last sign-flipped and scaled by 10) runs on one
device and on a (1, 2) mesh of two gloo ranks sharing the card, where
each rank decodes on the ``model`` halves of all 8 replicas (the split
forward), through ``tests/torch_serve_mesh_check.py``'s probe, each rank
also on the one-device run's first-step inputs (token, positions, the
poisoned replica's cache).  For each seed the script prints whether
``chip_smoke.hold_first_step`` holds and its line: per poisoned row and
over that row's largest |entry|, on the shared inputs the split row
against one device's and each of the two against the same step in
float64; on the runs' own caches the split row against one device's,
against float64 on its own cache, and how far the float64 steps on the
two caches part.  Needs one card:

    python3 scripts/torch_serve_witness.py --seeds 0 1
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_witness: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT / "tests"))
    import chip_smoke as cs
    import torch_serve_mesh_check as sm
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.dist.mesh import run_on_mesh
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    _build.build_all()
    base, _ = cs.shard_serve_settings(np, dict(get_config=get_config,
                                               get_reduced=get_reduced))
    ok = True
    for seed in args.seeds:
        setting = dict(base, seed=seed)
        single = run_on_mesh(sm.serve_settings, (1, 1), args=(
            [dict(setting, single=True)],), device="cuda", backend="gloo",
            timeout=600)[0][0]["token"]
        ranks = run_on_mesh(sm.serve_settings, cs.SHARD_SERVE_FULL, args=(
            [dict(setting, shape=cs.SHARD_SERVE_MODEL,
                  shared=single["inputs"])],), device="cuda",
            backend="gloo", timeout=600)
        for (r,) in ranks:
            run = r["token"]
            try:
                line, _ = cs.hold_first_step(run, single, f"seed {seed}")
                print(f"seed {seed} rank {r['coords']}: hold_first_step "
                      f"holds: {line}", flush=True)
            except cs.CheckFailed as exc:
                ok = False
                print(f"seed {seed} rank {r['coords']}: hold_first_step "
                      f"fails: {exc}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

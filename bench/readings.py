"""The readings that a cell's limits are set from, at the cell's own
size: the program's numbers on many seeds (sound runs), the control's
(the reference in TF32, put in the program's place) and each fault's,
all against the float32 reference.

    python3 bench/readings.py --workload <name> --seeds 1 2 3 ... \
        [--faults 3] [--out chiprun_out/readings.json]

One process reads every seed, so set-up is paid once.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "build" / "bench_cache" / "triton"))
sys.path = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path[1:] if pathlib.Path(p or ".").resolve()
    != ROOT / "bench"]

from bench import harness  # noqa: E402


def main(argv=None, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3,
                    help="seeds (the first ones) that also read each fault")
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds (the first ones) that also read the control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for i, seed in enumerate(args.seeds):
        cell = harness.Cell(args.workload, seed, 0.0, False, device)
        t0 = time.perf_counter()
        row = {"seed": seed}
        row.update(cell.kind.readings(cell, faults=i < args.faults,
                                      control=i < args.controls))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"workload": args.workload, "rows": rows,
           "power": harness.power_limit() if device == "cuda" else "cpu"}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

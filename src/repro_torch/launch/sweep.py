"""Run the full dry-run matrix: every (arch x shape x mesh) combination
as a subprocess (``python -m repro_torch.launch.dryrun``), one JSON
artifact each (counterpart of ``repro/launch/sweep.py``).  Resumable:
existing artifacts are skipped.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

ARCHS = [
    # smallest first so failures surface early
    "mamba2-130m", "gemma3-1b", "gemma-2b", "whisper-medium",
    "llama3.2-3b", "qwen1.5-4b", "llama-3.2-vision-11b",
    "llama4-scout-17b-a16e", "mixtral-8x22b", "jamba-1.5-large-398b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run(out: str, *, timeout: int = 3000, gar: str = "bulyan-krum",
        impl: str = "auto", pods: str = "both",
        only_arch: Optional[str] = None, archs: Sequence[str] = ARCHS,
        shapes: Sequence[str] = SHAPES) -> List[str]:
    """Run every combination not yet in ``out``.

    Args:
      out: the artifact directory (made when missing).
      timeout: seconds per combination.
      gar: the train steps' rule.
      impl: attention path.
      pods: ``"1"`` (16 x 16), ``"2"`` (2 x 16 x 16) or ``"both"``.
      only_arch: run this arch only.
      archs: the archs of the matrix.
      shapes: the input shapes of the matrix.

    Returns:
      One status line per combination, as printed.
    """
    os.makedirs(out, exist_ok=True)
    mps = {"1": [False], "2": [True], "both": [False, True]}[pods]
    todo = [(a, s, mp) for mp in mps for a in archs for s in shapes
            if only_arch in (None, a)]
    lines = []
    t_start = time.time()
    for i, (arch, shape, mp) in enumerate(todo):
        tag = f"{arch}.{shape}.pod{'2' if mp else '1'}"
        path = os.path.join(out, tag + ".json")
        if os.path.exists(path):
            lines.append(f"[{i+1}/{len(todo)}] {tag}: exists, skip")
            print(lines[-1], flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--gar", gar,
               "--impl", impl, "--out", path]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout)
            if r.returncode != 0:
                with open(path, "w") as fh:
                    json.dump({"arch": arch, "shape": shape,
                               "multi_pod": mp, "error":
                               r.stderr[-4000:]}, fh, indent=1)
                status = "FAIL"
            else:
                with open(path) as fh:
                    rec = json.load(fh)
                status = ("skip(n/a)" if rec.get("skipped")
                          else rec["roofline"]["dominant"]
                          if "roofline" in rec else "ok")
        except subprocess.TimeoutExpired:
            with open(path, "w") as fh:
                json.dump({"arch": arch, "shape": shape, "multi_pod": mp,
                           "error": f"timeout {timeout}s"}, fh, indent=1)
            status = "TIMEOUT"
        dt = time.time() - t0
        total = time.time() - t_start
        lines.append(f"[{i+1}/{len(todo)}] {tag}: {status} ({dt:.0f}s, "
                     f"total {total/60:.1f}m)")
        print(lines[-1], flush=True)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--gar", default="bulyan-krum")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--pods", default="both", choices=["1", "2", "both"])
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args()
    run(args.out, timeout=args.timeout, gar=args.gar, impl=args.impl,
        pods=args.pods, only_arch=args.only_arch)


if __name__ == "__main__":
    main()

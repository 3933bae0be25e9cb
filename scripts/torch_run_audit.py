"""One-command adversarial self-audit of the PyTorch port: corner sweep
plus leeway gate.

The counterpart of ``scripts/run_audit.py`` on ``src/repro_torch``:

    PYTHONPATH=src python scripts/torch_run_audit.py               # quick grid
    PYTHONPATH=src python scripts/torch_run_audit.py --full        # whole grid
    PYTHONPATH=src python scripts/torch_run_audit.py --device cpu

* the corner sweep (``repro_torch.audit.sweep``) walks every registered
  rule x attack x (n, f, tau, schedule) corner;
* the leeway meter (``repro_torch.audit.leeway``) measures the
  ε-poisoning margins over the dimension ladder and certifies the
  scaling slopes against ``benchmarks/artifacts/leeway_baseline.json``,
  which it only reads.

``--device`` picks the card (default ``cuda``, which raises when none
is present) or the CPU.  Exit status is the total number of violations.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

BASELINE = REPO / "benchmarks" / "artifacts" / "leeway_baseline.json"


def main(argv=None) -> int:
    """Run both audit gates against the checked-in baseline.

    Args:
      argv: command-line arguments (``None`` = ``sys.argv[1:]``):
        ``--full`` runs the whole sweep grid instead of the quick grid,
        ``--seed`` reseeds the sweep's synthetic stacks, ``--device``
        picks the card or the CPU.

    Returns:
      Process exit code: the total violation count across both gates.
    """
    from repro_torch.audit import leeway, sweep

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the whole sweep grid (default: the quick grid)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sweep seed (the leeway ladder keeps its own "
                         "fixed seed, as the baseline does)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    failures = sweep.main(([] if args.full else ["--quick"])
                          + ["--seed", str(args.seed),
                             "--device", args.device])
    leeway_args = ["--device", args.device]
    if BASELINE.exists():
        leeway_args += ["--baseline", str(BASELINE)]
    failures += leeway.main(leeway_args)
    print(f"torch_run_audit: {failures} total violations", flush=True)
    return failures


if __name__ == "__main__":
    raise SystemExit(main())

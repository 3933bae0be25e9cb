"""Defense report from the PyTorch port's aggregation forensics: is the
paper's attack live?

The counterpart of ``scripts/obs_report.py`` on ``src/repro_torch``:

    PYTHONPATH=src python scripts/torch_obs_report.py                # demo
    PYTHONPATH=src python scripts/torch_obs_report.py --quick        # smoke
    PYTHONPATH=src python scripts/torch_obs_report.py --input run.jsonl
    PYTHONPATH=src python scripts/torch_obs_report.py --device cpu

The **demo** mode trains the MNIST-scale flat model three times with
telemetry on (clean, under the paper's omniscient attack, and under a
defended signflip attack), drains the forensics rings, and prints the
detector report: selection entropy (collapses under the attack), the
suspicion ranking (Byzantine rows must rank first when the defense
holds), and the ε-margin trajectory.  ``--quick`` shrinks the run; the
exit status is 0 iff the attacked run's entropy drops below the clean
run's AND the defended run's suspicion ranking puts a Byzantine row on
top.  ``--device`` picks the card (default ``cuda``, which raises when
none is present) or the CPU.

The **input** mode replays the same report over a JSONL file of drained
records (one ``repro_torch.obs.export.write_jsonl`` row per recorded
step, plus an optional ``selection_frequency`` row).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))


def _train(gar: str, attack: str, n_workers: int, f: int, steps: int,
           seed: int = 0, device="cuda", params=None):
    """One telemetry-on flat training run; returns the drained report.

    ``params`` (default: ``init_mnist_mlp(seed)``) lets a caller start
    from given weights.
    """
    from repro_torch.data import ByzantineBatcher
    from repro_torch.models import simple
    from repro_torch.optim import get_optimizer
    from repro_torch.training import ByzantineSpec, ByzantineTrainer

    def loss_fn(params, x, y):
        return simple.classification_loss(
            simple.mnist_mlp_forward(params, x), y, params)

    kwargs = (("gar_name", gar),) if attack == "omniscient_lp" else ()
    spec = ByzantineSpec(n_workers=n_workers, f=f, gar=gar, attack=attack,
                         attack_kwargs=kwargs, telemetry=True)
    if params is None:
        params = simple.init_mnist_mlp(seed, device=device)
    trainer = ByzantineTrainer(loss_fn, params, get_optimizer("sgd", 0.05),
                               spec, seed=seed, device=device)
    trainer.run(ByzantineBatcher("mnist", spec.n_honest, 32), steps)
    return trainer.telemetry()


def _report(tag: str, drained: dict) -> dict:
    """Detector summary of one drained forensics ring."""
    from repro_torch.obs.detect import (margin_trajectory,
                                        selection_collapsed,
                                        selection_entropy,
                                        suspicion_scores)

    freq = np.asarray(drained["selection_frequency"], np.float64)
    records = drained["records"]
    suspicion = suspicion_scores(records, freq)
    margins = margin_trajectory(records)
    return {
        "tag": tag,
        "recorded_steps": len(records),
        "pushed": int(drained["pushed"]),
        "selection_entropy": selection_entropy(freq),
        "collapsed": bool(selection_collapsed(freq)),
        "selection_frequency": freq.round(4).tolist(),
        "suspicion": suspicion.round(4).tolist(),
        "most_suspect": int(np.argmax(suspicion)) if suspicion.size else -1,
        "margin_mean": float(margins.mean()) if margins.size else 1.0,
        "margin_min": float(margins.min()) if margins.size else 1.0,
    }


def _print_report(rep: dict) -> None:
    print(f"--- {rep['tag']} ---")
    print(f"  recorded steps      {rep['recorded_steps']} "
          f"(pushed {rep['pushed']})")
    print(f"  selection entropy   {rep['selection_entropy']:.4f} "
          f"{'[COLLAPSED]' if rep['collapsed'] else '[healthy]'}")
    print(f"  selection freq      {rep['selection_frequency']}")
    print(f"  suspicion           {rep['suspicion']}")
    print(f"  most suspect row    {rep['most_suspect']}")
    print(f"  eps-margin          mean {rep['margin_mean']:.4f}  "
          f"min {rep['margin_min']:.4f}")


def _input_mode(path: str, out: str | None) -> int:
    """Report over an exported JSONL of drained records."""
    from repro_torch.obs.export import read_jsonl, write_jsonl

    rows = read_jsonl(path)
    records = [r for r in rows if "dist_to_agg" in r]
    freq_rows = [r for r in rows if "selection_frequency" in r]
    if freq_rows:
        freq = np.asarray(freq_rows[-1]["selection_frequency"], np.float64)
    elif records:
        sel = np.sum([np.asarray(r["selected"], np.float64)
                      for r in records], axis=0)
        freq = sel / max(sel.sum(), 1e-12)
    else:
        freq = np.zeros((0,), np.float64)
    rep = _report(path, {"records": records, "selection_frequency": freq,
                         "pushed": len(records)})
    _print_report(rep)
    if out:
        write_jsonl(out, [rep])
        print(f"report written to {out}")
    return 0


def demo(gar: str, attack: str, n_workers: int, f: int, steps: int,
         device="cuda", params=None):
    """The three demo reports: clean, attacked, defended (signflip).

    Args:
      gar: defended GAR of the runs.
      attack: attack of the poisoned run.
      n_workers: committee size of the attacked runs.
      f: Byzantine rows of the attacked runs.
      steps: training steps per run.
      device: ``"cuda"`` or ``"cpu"``.
      params: initial weights of every run (default: seed 0's).

    Returns:
      ``(clean, attacked, defended)`` report dicts.
    """
    clean = _report("clean", _train(gar, "none", n_workers, 0, steps,
                                    device=device, params=params))
    attacked = _report(
        f"attacked ({attack})",
        _train(gar, attack, n_workers, f, steps, device=device,
               params=params))
    # the suspicion ranking needs a *defended* run: under the successful
    # omniscient attack the winning crafted row sits ON the aggregate
    # (zero distance, zero starvation), so blame only lands on the
    # Byzantine tail when the rule actually rejects it
    defended = _report("defended (signflip)",
                       _train(gar, "signflip", n_workers, f, steps,
                              device=device, params=params))
    return clean, attacked, defended


def main(argv=None) -> int:
    """Print the clean-vs-attacked defense report (demo) or replay a file.

    Args:
      argv: command-line arguments (``None`` = ``sys.argv[1:]``):
        ``--input`` replays an exported JSONL instead of training,
        ``--quick`` shrinks the demo, ``--gar`` / ``--attack`` /
        ``--steps`` parameterize the demo runs, ``--device`` picks the
        card or the CPU, ``--out`` writes the JSONL report artifact.

    Returns:
      Process exit status: 0 when the attacked demo run shows the
      entropy-collapse signature and the defended suspicion ranking
      blames a Byzantine row, 1 otherwise.
    """
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", default=None,
                    help="JSONL of drained records to report on "
                         "(skips the demo training)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: fewer steps, smaller committee")
    ap.add_argument("--gar", default="krum",
                    help="defended GAR of the demo runs")
    ap.add_argument("--attack", default="omniscient_lp",
                    help="attack of the poisoned demo run")
    ap.add_argument("--steps", type=int, default=None,
                    help="demo training steps (default 12, --quick 4)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None, help="JSONL report path")
    args = ap.parse_args(argv)

    if args.input:
        return _input_mode(args.input, args.out)

    steps = args.steps or (4 if args.quick else 12)
    n_workers, f = (9, 2) if args.quick else (15, 3)
    print(f"torch_obs_report demo: gar={args.gar} attack={args.attack} "
          f"n={n_workers} f={f} steps={steps} device={args.device}")
    clean, attacked, defended = demo(args.gar, args.attack, n_workers, f,
                                     steps, device=args.device)
    _print_report(clean)
    _print_report(attacked)
    _print_report(defended)

    # the paper's signature: the attacker monopolizes selection, so the
    # attacked run's entropy drops strictly below the clean run's
    collapse = (attacked["selection_entropy"]
                < clean["selection_entropy"] - 1e-9)
    blamed = defended["most_suspect"] >= n_workers - f
    print(f"entropy collapse reproduced: {collapse} "
          f"({clean['selection_entropy']:.4f} -> "
          f"{attacked['selection_entropy']:.4f})")
    print(f"defended suspicion blames Byzantine row: {blamed} "
          f"(row {defended['most_suspect']}, byz rows "
          f">= {n_workers - f})")
    if args.out:
        from repro_torch.obs.export import write_jsonl
        write_jsonl(args.out, [clean, attacked, defended])
        print(f"report written to {args.out}")
    return 0 if (collapse and blamed) else 1


if __name__ == "__main__":
    raise SystemExit(main())

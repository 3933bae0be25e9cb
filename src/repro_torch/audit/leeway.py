"""The empirical leeway meter: ε-poisoning margins as d grows
(counterpart of ``repro/audit/leeway.py``).

The paper's core quantitative claim is a pair of scaling laws.  The
attacker's *leeway* (the largest single-coordinate poison gamma_m a
selection rule still accepts) grows like Omega(sqrt(d)) for the
Krum/GeoMed family (§3.2/§B), so the aggregate a poisoned Krum emits
drifts from the honest mean by an amount that grows with d.  Bulyan's
coordinate phase cuts that drift back to O(sigma / sqrt(d)) relative to
the gradient's own scale (Proposition 2), so its relative margin
shrinks as d grows.

For each rule over a dimension ladder the meter records ``margin_abs``
(max per-coordinate deviation of the rule's aggregate from the honest
mean under the paper's omniscient attack, tuned by the exact gamma
search against Krum, margin 0.95), ``margin_rel`` (the same over the l2
norm of the honest mean) and, for the searchable selection rules,
``gamma`` (the measured gamma_m), and fits log-log slopes.
:func:`certify` gates the slopes against per-rule expectations and a
checked-in baseline artifact (ratio tolerances: summation order differs
across machines, and the port's honest stacks come from a
``torch.Generator``, not the reference's ``jax.random`` stream).

Every rule resolves through ``resolve_rule``, so ``fused-<base>`` names
run the CUDA aggregation kernels on the card.

CLI: ``python -m repro_torch.audit.leeway --out artifact.json`` writes
the JSON artifact, ``--baseline benchmarks/artifacts/leeway_baseline.json``
gates against the checked-in baseline (read only), ``--device cpu``
runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.agg.registry import resolve_rule
from repro_torch.core.attacks import (find_gamma_max, make_selection_checker,
                                      omniscient_lp)
from repro_torch.device import resolve_device

__all__ = ["BASELINE_RATIO", "DEFAULT_DIMS", "DEFAULT_EXPECTATIONS",
           "DEFAULT_RULES", "certify", "main", "measure_leeway", "slope"]

#: dimension ladder of the default measurement
DEFAULT_DIMS: Tuple[int, ...] = (64, 256, 1024)

#: rules the meter tracks by default: a rule name or a
#: ``(label, gar, f_used)`` triple (``f_used`` overrides the bound the
#: rule aggregates with: the weakened-rule injection path)
DEFAULT_RULES: Tuple[Union[str, Tuple[str, str, int]], ...] = (
    "average", "krum", "multikrum", "geomed", "cwmed", "bulyan-krum")

#: per-label slope expectations: (metric, lo, hi), ``None`` = open
DEFAULT_EXPECTATIONS: Dict[str, Tuple[str, Optional[float],
                                      Optional[float]]] = {
    "average": ("abs", 0.35, None),     # carries the poison ~ sqrt(d)
    "krum": ("abs", 0.35, None),        # selects it ~ sqrt(d)
    "multikrum": ("abs", 0.35, None),
    "geomed": ("abs", 0.35, None),
    "cwmed": ("rel", None, -0.10),      # coordinate-wise: shrinks
    "bulyan-krum": ("rel", None, -0.25),  # Proposition 2
}

#: ratio tolerance of the baseline gate
BASELINE_RATIO = 3.0

#: selection rules whose gamma_m the exact search can measure
_GAMMA_RULES = ("krum", "geomed")


def slope(dims: Sequence[int], values: Sequence[float]) -> float:
    """Log-log slope of ``values`` against ``dims``.

    Args:
      dims: dimension ladder (positive, increasing).
      values: measured positive values, one per dimension.

    Returns:
      The least-squares slope of ``log(values)`` vs ``log(dims)``.
    """
    v = np.maximum(np.asarray(values, float), 1e-12)
    return float(np.polyfit(np.log(np.asarray(dims, float)),
                            np.log(v), 1)[0])


def _rule_entries(rules) -> List[Tuple[str, str, Optional[int]]]:
    out = []
    for r in rules:
        if isinstance(r, str):
            out.append((r, r, None))
        else:
            label, gar, f_used = r
            out.append((str(label), str(gar), int(f_used)))
    return out


def _honest_stack(d: int, n_h: int, seed: int,
                  device: torch.device) -> torch.Tensor:
    """The ``(n_h, d)`` honest gradients of one rung, ~ ``N(1, 0.5)``.

    Drawn from a CPU ``torch.Generator`` seeded from ``(seed, d)``, then
    moved, so the card and the CPU measure the same stacks.
    """
    gen = torch.Generator().manual_seed(
        zlib.crc32(f"leeway/{seed}/{d}".encode()))
    honest = torch.randn((n_h, d), generator=gen) * 0.5 + 1.0
    return honest.to(device)


def measure_leeway(rules=DEFAULT_RULES, dims: Sequence[int] = DEFAULT_DIMS,
                   n_h: int = 12, f: int = 3, seed: int = 11,
                   margin: float = 0.95, device="cuda") -> Dict:
    """Measure per-rule poisoning margins over a dimension ladder.

    At each d: ``n_h`` honest gradients ~ ``N(1, 0.5)``, the paper's
    omniscient single-coordinate attack tuned by the exact gamma search
    against Krum at the given selection margin, then every rule
    aggregates the same poisoned stack and its deviation from the
    honest mean is recorded.

    Args:
      rules: rule names or ``(label, gar, f_used)`` triples
        (weakened-rule injection uses e.g.
        ``("bulyan-weak", "bulyan-krum", 0)``).
      dims: dimension ladder.
      n_h: honest worker count.
      f: Byzantine worker count (and the default aggregation bound).
      seed: seed of the honest stacks; the artifact is a function of
        the inputs (up to summation order on the device).
      margin: fraction of the measured gamma_m the attacker submits.
      device: ``"cuda"`` (default; raises when no card is present) or
        ``"cpu"``.

    Returns:
      JSON-ready report dict: config echo, per-rule ``margin_abs`` /
      ``margin_rel`` ladders with fitted ``slope_abs`` / ``slope_rel``,
      and the measured ``gamma`` ladders + slopes for the searchable
      selection rules.
    """
    dev = resolve_device(device)
    entries = _rule_entries(rules)
    per_rule: Dict[str, Dict] = {
        label: {"gar": gar, "f_used": f if f_used is None else f_used,
                "margin_abs": [], "margin_rel": []}
        for label, gar, f_used in entries}
    gammas: Dict[str, List[float]] = {r: [] for r in _GAMMA_RULES}
    for d in dims:
        honest = _honest_stack(d, n_h, seed, dev)
        e = torch.zeros((d,), dtype=honest.dtype, device=dev)
        e[0] = 1.0
        for gname in _GAMMA_RULES:
            check = make_selection_checker(gname, f)
            gammas[gname].append(
                float(find_gamma_max(honest, f, e, check)))
        byz = omniscient_lp(honest, f, None, gar_name="krum",
                            margin=margin)
        full = torch.cat([honest, byz])
        mean = torch.mean(honest, dim=0)
        mean_norm = float(torch.linalg.vector_norm(mean))
        for label, gar, f_used in entries:
            rule = resolve_rule(gar)
            fu = f if f_used is None else f_used
            agg = rule.dense_fn(full, fu).gradient
            dev_max = float(torch.max(torch.abs(agg - mean)))
            per_rule[label]["margin_abs"].append(dev_max)
            per_rule[label]["margin_rel"].append(dev_max / mean_norm)
    for label in per_rule:
        per_rule[label]["slope_abs"] = slope(
            dims, per_rule[label]["margin_abs"])
        per_rule[label]["slope_rel"] = slope(
            dims, per_rule[label]["margin_rel"])
    return {
        "config": {"dims": list(dims), "n_h": n_h, "f": f, "seed": seed,
                   "margin": margin},
        "rules": per_rule,
        "gamma": {g: {"values": v, "slope": slope(dims, v)}
                  for g, v in gammas.items()},
    }


def certify(report: Dict, expectations: Optional[Dict] = None,
            baseline: Optional[Dict] = None) -> List[str]:
    """Gate a leeway report against the scaling laws and a baseline.

    Args:
      report: a :func:`measure_leeway` report.
      expectations: per-label ``(metric, lo, hi)`` slope windows
        (``None`` = :data:`DEFAULT_EXPECTATIONS`; labels absent from
        the map are not slope-gated).  ``metric`` is ``"abs"`` or
        ``"rel"``; ``lo`` / ``hi`` are inclusive bounds, ``None`` =
        open.
      baseline: a previously saved report to regress against: every
        shared (label, dim) margin must stay within a factor of
        :data:`BASELINE_RATIO` of the baseline value, and the gamma
        slopes within +-0.2.  ``None`` skips the comparison.

    Returns:
      List of violation strings; empty when the artifact certifies.
    """
    exp = DEFAULT_EXPECTATIONS if expectations is None else expectations
    out: List[str] = []
    for label, rec in report["rules"].items():
        if label not in exp:
            continue
        metric, lo, hi = exp[label]
        s = rec[f"slope_{metric}"]
        if lo is not None and s < lo:
            out.append(
                f"{label}: {metric} margin slope {s:.3f} < {lo} — "
                f"expected to grow with d")
        if hi is not None and s > hi:
            out.append(
                f"{label}: {metric} margin slope {s:.3f} > {hi} — "
                f"expected to shrink with d")
    for gname, rec in report.get("gamma", {}).items():
        s = rec["slope"]
        if not 0.3 <= s <= 0.7:
            out.append(
                f"gamma_{gname}: log-log slope {s:.3f} outside "
                f"[0.3, 0.7] — the Omega(sqrt(d)) leeway law broke")
    if baseline is not None:
        dims = report["config"]["dims"]
        bdims = baseline["config"]["dims"]
        shared = [d for d in dims if d in bdims]
        for label, rec in report["rules"].items():
            brec = baseline["rules"].get(label)
            if brec is None:
                continue
            for d in shared:
                got = rec["margin_abs"][dims.index(d)]
                want = brec["margin_abs"][bdims.index(d)]
                lo_b = want / BASELINE_RATIO
                hi_b = want * BASELINE_RATIO
                if not lo_b <= got <= hi_b or (want < 1e-9 < got):
                    out.append(
                        f"{label}@d={d}: margin_abs {got:.4g} outside "
                        f"[{lo_b:.4g}, {hi_b:.4g}] of baseline "
                        f"{want:.4g}")
        for gname, rec in report.get("gamma", {}).items():
            brec = baseline.get("gamma", {}).get(gname)
            if brec and abs(rec["slope"] - brec["slope"]) > 0.2:
                out.append(
                    f"gamma_{gname}: slope {rec['slope']:.3f} drifted "
                    f"more than 0.2 from baseline {brec['slope']:.3f}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: measure, optionally write / gate the JSON artifact.

    Args:
      argv: command-line arguments (``None`` = ``sys.argv[1:]``);
        ``--dims``, ``--n-h``, ``--f``, ``--seed`` shape the
        measurement, ``--device`` picks the card or the CPU, ``--out``
        writes the artifact, ``--baseline`` gates against a checked-in
        artifact (read only).

    Returns:
      Process exit code: the number of certification violations.
    """
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", type=int, nargs="+",
                    default=list(DEFAULT_DIMS))
    ap.add_argument("--n-h", type=int, default=12,
                    help="honest worker count")
    ap.add_argument("--f", type=int, default=3,
                    help="Byzantine worker count")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", type=str, default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--baseline", type=str, default=None,
                    help="gate against this checked-in artifact")
    args = ap.parse_args(argv)
    report = measure_leeway(dims=tuple(args.dims), n_h=args.n_h,
                            f=args.f, seed=args.seed, device=args.device)
    baseline = None
    if args.baseline:
        with open(args.baseline) as fh:
            baseline = json.load(fh)
    violations = certify(report, baseline=baseline)
    for label, rec in sorted(report["rules"].items()):
        print(f"leeway/{label}: slope_abs={rec['slope_abs']:+.3f} "
              f"slope_rel={rec['slope_rel']:+.3f} "
              f"margin_abs={['%.3g' % m for m in rec['margin_abs']]}",
              flush=True)
    for gname, rec in sorted(report["gamma"].items()):
        print(f"leeway/gamma_{gname}: slope={rec['slope']:+.3f}",
              flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"leeway: artifact written to {args.out}", flush=True)
    for v in violations:
        print(f"VIOLATION: {v}", flush=True)
    print(f"leeway: {len(violations)} violations", flush=True)
    return len(violations)


if __name__ == "__main__":
    raise SystemExit(main())

"""Host-side attack detectors over drained aggregation forensics
(counterpart of ``repro/obs/detect.py``).

The paper's attack works by steering selection: a crafted Byzantine row
wins Krum's score every step, so the selection distribution collapses
onto the attacker while honest workers starve.  These detectors turn the
drained :class:`~repro_torch.obs.buffer.MetricsBuffer`
(``repro_torch.obs.buffer.drain``) into the three signals an operator
watches:

* **selection entropy** — normalized Shannon entropy of the per-worker
  selection frequency; ~1 for a healthy rotating committee, collapsing
  toward 0 when one row monopolizes selection (the attack signature);
* **suspicion ranking** — per-worker blend of distance-to-aggregate and
  selection starvation; under a *defended* attack the Byzantine rows
  rank most suspect;
* **margin trajectory** — the empirical ε-poisoning-leeway proxy
  ``1 - agg_dev / spread`` per record.

Everything here is plain numpy on drained host data, with the
reference's arithmetic.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

__all__ = ["margin_trajectory", "selection_collapsed",
           "selection_entropy", "suspicion_scores"]

_EPS = 1e-12


def selection_entropy(freq: np.ndarray) -> float:
    """Normalized Shannon entropy of a selection-frequency vector.

    Args:
      freq: ``(n,)`` nonnegative per-worker selection shares (need not
        be normalized; ``drain()['selection_frequency']`` already is).

    Returns:
      ``H(p) / log(n)`` in ``[0, 1]``: 1 for uniform selection, 0 when
      a single worker takes everything (and 0 for empty/zero input).
    """
    p = np.asarray(freq, np.float64).ravel()
    total = p.sum()
    if p.size <= 1 or total <= 0:
        return 0.0
    p = p / total
    h = -np.sum(p * np.log(np.maximum(p, _EPS)))
    return float(h / np.log(p.size))


def selection_collapsed(freq: np.ndarray, threshold: float = 0.5) -> bool:
    """Flag the paper's selection-monopoly signature.

    Args:
      freq: ``(n,)`` per-worker selection shares.
      threshold: entropy level below which selection counts as
        collapsed (0.5 ~ "half the committee's diversity lost").

    Returns:
      True when :func:`selection_entropy` fell below ``threshold``.
    """
    return selection_entropy(freq) < threshold


def suspicion_scores(records: Sequence[Dict[str, Any]],
                     freq: np.ndarray) -> np.ndarray:
    """Per-worker suspicion in ``[0, 1]`` from a drained run.

    Blends two signals, each normalized to ``[0, 1]``: the run-mean
    distance-to-aggregate and selection starvation
    ``1 - freq / max(freq)``.  Under a defended attack both point at the
    Byzantine rows, so sorting descending ranks them first.

    Args:
      records: chronological record dicts from ``drain()['records']``
        (each carrying a ``(n,)`` ``dist_to_agg``).
      freq: ``(n,)`` per-worker selection shares
        (``drain()['selection_frequency']``).

    Returns:
      ``(n,)`` fp64 suspicion scores (empty array for an empty run).
    """
    freq = np.asarray(freq, np.float64)
    if not records:
        return np.zeros_like(freq)
    dist = np.mean([np.asarray(r["dist_to_agg"], np.float64)
                    for r in records], axis=0)
    dist_n = dist / max(float(dist.max()), _EPS)
    starve = 1.0 - freq / max(float(freq.max()), _EPS)
    return 0.5 * (dist_n + starve)


def margin_trajectory(records: Sequence[Dict[str, Any]]) -> np.ndarray:
    """Empirical ε-leeway proxy per recorded step.

    ``1 - agg_dev / spread``: 1 when the aggregate sits on the honest
    mean, 0 when it drifted a full worker-spread away.  Clipped below at
    -1 so a catastrophically steered aggregate stays plottable.

    Args:
      records: chronological record dicts from ``drain()['records']``.

    Returns:
      ``(len(records),)`` fp64 margins.
    """
    out = []
    for r in records:
        spread = float(np.asarray(r["spread"]))
        dev = float(np.asarray(r["agg_dev"]))
        out.append(max(1.0 - dev / max(spread, _EPS), -1.0))
    return np.asarray(out, np.float64)

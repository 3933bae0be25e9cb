"""Common types for the Byzantine-robust aggregation core.

Every gradient aggregation rule (GAR) operates on a stacked gradient
matrix ``grads`` of shape ``(n, d)`` (one row per worker) plus a static
Byzantine bound ``f``.  Counterpart of ``repro/core/types.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AggResult"]


class AggResult(NamedTuple):
    """Result of one aggregation.

    gradient:  (d,) the aggregated gradient.
    selected:  (n,) float mask: 1.0 where the worker's submission took
               part in the final combination (selection rules), or
               fractional weights (e.g. averaging).  Diagnostic only.
    scores:    (n,) per-worker score used by the rule (lower = better),
               or zeros when the rule is score-free.
    """

    gradient: torch.Tensor
    selected: torch.Tensor
    scores: torch.Tensor

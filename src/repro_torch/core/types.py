"""Common types for the Byzantine-robust aggregation core.

Every gradient aggregation rule (GAR) operates on a stacked gradient
matrix ``grads`` of shape ``(n, d)`` (one row per worker) plus a static
Byzantine bound ``f``.  Counterpart of ``repro/core/types.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple

import torch

__all__ = ["AggResult", "AttackResult", "GarFn", "GarSpec"]


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


#: a GAR: ``(grads: (n, d), f: int) -> AggResult`` with ``f`` a plain int
GarFn = Callable[..., AggResult]


@dataclasses.dataclass(frozen=True)
class GarSpec:
    """Registry entry for a gradient aggregation rule (the historic form
    of :class:`repro_torch.agg.registry.AggregatorRule`)."""

    name: str
    fn: GarFn
    #: minimal worker count as a function of f (paper §2.3 / §4)
    min_n: Callable[[int], int]
    #: True when the rule is proven (alpha, f)-Byzantine-resilient
    byzantine_resilient: bool
    doc: str = ""

    def check_quorum(self, n: int, f: int) -> None:
        """Raise ``ValueError`` when ``n`` is below the rule's quorum.

        Args:
          n: worker count.
          f: Byzantine bound.

        Returns:
          None.
        """
        need = self.min_n(f)
        if n < need:
            raise ValueError(
                f"GAR {self.name!r} requires n >= {need} for f={f}, got n={n}"
            )


class AttackResult(NamedTuple):
    """Byzantine submissions plus diagnostics."""

    byzantine: torch.Tensor  # (f, d)
    info: Dict[str, Any]

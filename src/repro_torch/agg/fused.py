"""``fused-<base>`` registry composites (counterpart of
``repro/agg/fused.py``, dense path only).

``resolve_rule("fused-bulyan-krum")`` returns a rule with the base's
quorum, resilience flag and invariants whose dense path is
:func:`repro_torch.kernels.fused_agg.fused_aggregate`: the CUDA kernels
for a CUDA stack, their plain versions for a CPU one.  The multi-leaf
tree path waits for the port of ``agg/tree.py``.
"""
from __future__ import annotations

import torch

from repro_torch.agg.registry import AggregatorRule, resolve_rule
from repro_torch.core.types import AggResult
from repro_torch.kernels.fused_agg import FUSED_MODES, fused_aggregate

__all__ = ["FUSED_BASES", "make_fused"]

#: base GAR names with a fused lowering (== fused_agg.FUSED_MODES)
FUSED_BASES = FUSED_MODES


def make_fused(name: str) -> AggregatorRule:
    """Build the ``fused-<base>`` composite rule.

    Args:
      name: full composite name, e.g. ``"fused-bulyan-krum"``.

    Returns:
      An :class:`AggregatorRule` with the base rule's contract whose dense
      path is the fused aggregation.  Raises ``KeyError`` when the base
      has no fused lowering.
    """
    base = name[len("fused-"):]
    if base not in FUSED_BASES:
        raise KeyError(f"unknown GAR {name!r}: no fused lowering for "
                       f"{base!r}; have {sorted(FUSED_BASES)}")
    base_rule = resolve_rule(base)

    def dense_fn(grads: torch.Tensor, f: int) -> AggResult:
        agg, sel, scores = fused_aggregate(grads, f, mode=base)
        return AggResult(agg.to(grads.dtype), sel.to(grads.dtype),
                         scores.to(grads.dtype))

    return AggregatorRule(
        name=name, min_n=base_rule.min_n, dense_fn=dense_fn,
        byzantine_resilient=base_rule.byzantine_resilient,
        invariants=base_rule.invariants,
        doc=(f"{base} lowered onto the fused aggregation kernels "
             f"(repro_torch.kernels.fused_agg): distance accumulation, "
             f"selection and coordinate phase."))

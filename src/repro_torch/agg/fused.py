"""``fused-<base>`` registry composites (counterpart of
``repro/agg/fused.py``).

``resolve_rule("fused-bulyan-krum")`` returns a rule with the base's
quorum, resilience flag and invariants whose paths run on the CUDA
aggregation kernels (their plain versions for CPU tensors):

* the dense path is :func:`repro_torch.kernels.fused_agg.fused_aggregate`
  (K5) on the flat ``(n, d)`` stack;
* the tree path sends a single-leaf tree to K5 as well, while a
  multi-leaf tree takes the context's distance matrix (whatever backend
  produced it), derives the selection weights once with
  ``select_weights`` and runs K4 (``fused_coordinate``) once per leaf;
  cwmed and trimmed_mean need no weights.

:func:`fused_name` maps a rule name onto its ``fused-`` counterpart,
which is how ``distance_backend="fused"`` reroutes rules inside the
engine; wrapper prefixes are kept (``"stale-krum" ->
"stale-fused-krum"``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.agg.registry import AggregatorRule, TreeAgg, resolve_rule
from repro_torch.core.types import AggResult
from repro_torch.kernels.fused_agg import (COORD_MODES, FUSED_MODES,
                                           fused_aggregate, fused_coordinate,
                                           select_weights)
from repro_torch.obs.trace import named_span

__all__ = ["FUSED_BASES", "fused_name", "make_fused"]

#: base GAR names with a fused lowering (== fused_agg.FUSED_MODES)
FUSED_BASES = FUSED_MODES

#: stateful wrapper prefixes fused_name recurses through, longest first
#: so "stale-exp-" is not split as "stale-" + "exp-..."
_WRAPPER_PREFIXES = ("stale-exp-", "stale-inv-", "stale-", "buffered-",
                     "reputation-", "obs-")


def fused_name(gar: str) -> Optional[str]:
    """Map a GAR name to its fused counterpart, or ``None``.

    Args:
      gar: a base rule, a wrapper composite (``stale-``, ``buffered-``,
        ``reputation-``, ``obs-``) or an already-fused name (idempotent).

    Returns:
      The ``fused-``-prefixed name with the wrapper prefixes kept
      (``"stale-krum" -> "stale-fused-krum"``), or ``None`` when the
      base has no fused lowering (``brute``, ``average``, ...).
    """
    if gar.startswith("fused-"):
        return gar
    for prefix in _WRAPPER_PREFIXES:
        if gar.startswith(prefix):
            inner = fused_name(gar[len(prefix):])
            return None if inner is None else prefix + inner
    return f"fused-{gar}" if gar in FUSED_BASES else None


def make_fused(name: str) -> AggregatorRule:
    """Build the ``fused-<base>`` composite rule.

    Args:
      name: full composite name, e.g. ``"fused-bulyan-krum"``.

    Returns:
      An :class:`AggregatorRule` with the base rule's contract whose
      dense path is K5 and whose tree path is the selection kernel plus
      K4 per leaf.  Raises ``KeyError`` when the base has no fused
      lowering.
    """
    base = name[len("fused-"):]
    if base not in FUSED_BASES:
        raise KeyError(f"unknown GAR {name!r}: no fused lowering for "
                       f"{base!r}; have {sorted(FUSED_BASES)}")
    base_rule = resolve_rule(base)

    def dense_fn(grads: torch.Tensor, f: int) -> AggResult:
        with named_span("kernel/fused"):
            agg, sel, scores = fused_aggregate(grads, f, mode=base)
        return AggResult(agg.to(grads.dtype), sel.to(grads.dtype),
                         scores.to(grads.dtype))

    def tree_fn(ctx) -> TreeAgg:
        leaves, n, f = ctx.leaves, ctx.n, ctx.f
        if len(leaves) == 1:
            leaf = leaves[0]
            with named_span("kernel/fused"):
                agg, sel, scores = fused_aggregate(leaf.reshape(n, -1), f,
                                                   mode=base)
            return TreeAgg([agg.reshape(leaf.shape[1:]).to(ctx.cdt)],
                           sel.to(ctx.cdt), scores.to(ctx.cdt))
        if base in COORD_MODES:
            w, sel, scores = None, ctx.uniform(), ctx.zeros()
        else:
            w, sel, scores = select_weights(
                ctx.dists().to(torch.float32), n, f, base)
            sel, scores = sel[0].to(ctx.cdt), scores[0].to(ctx.cdt)
        grad = [fused_coordinate(leaf.reshape(n, -1), w, f, mode=base)
                .reshape(leaf.shape[1:]).to(ctx.cdt) for leaf in leaves]
        return TreeAgg(grad, sel, scores)

    return AggregatorRule(
        name=name, min_n=base_rule.min_n, dense_fn=dense_fn,
        tree_fn=tree_fn, byzantine_resilient=base_rule.byzantine_resilient,
        invariants=base_rule.invariants,
        doc=(f"{base} lowered onto the fused aggregation kernels "
             f"(repro_torch.kernels.fused_agg): distance accumulation, "
             f"selection and coordinate phase."))

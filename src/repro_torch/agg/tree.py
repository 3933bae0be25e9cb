"""Tree-path implementations of the stateless aggregation rules.

Counterpart of ``repro/agg/tree.py``.  Each consumes a
:class:`~repro_torch.agg.registry.TreeContext` prepared by the engine
(``repro_torch.dist.robust.distributed_aggregate``: leaves with a leading
worker axis, a distance-matrix closure over the configured backend, the
windowed coordinate phase) and returns a
:class:`~repro_torch.agg.registry.TreeAgg`.  Registered onto the dense
rules of ``repro_torch.core.gars``; the Bulyan family is attached by the
resolver, since its base is parametric.  The stateful rules (buffered
history, momentum centered clipping) live in ``repro_torch.agg.buffered``.
"""
from __future__ import annotations

import torch

from repro_torch.agg.registry import TreeAgg, TreeContext, register_tree_impl
from repro_torch.core import bulyan as bulyan_lib
from repro_torch.core import gars

__all__ = ["bulyan_tree"]


def _everyone(ctx: TreeContext) -> torch.Tensor:
    return torch.ones((ctx.n,), dtype=torch.bool,
                      device=ctx.leaves[0].device)


def _one_hot(i: torch.Tensor, ctx: TreeContext) -> torch.Tensor:
    return (torch.arange(ctx.n, device=i.device) == i).to(ctx.cdt)


@register_tree_impl("average")
def _average_tree(ctx: TreeContext) -> TreeAgg:
    return TreeAgg([torch.mean(l.to(ctx.cdt), dim=0) for l in ctx.leaves],
                   ctx.uniform(), ctx.zeros())


@register_tree_impl("cwmed")
def _cwmed_tree(ctx: TreeContext) -> TreeAgg:
    # jnp.median: the mean of the two middle values for even n
    return TreeAgg([gars._median0(l.to(ctx.cdt)) for l in ctx.leaves],
                   ctx.uniform(), ctx.zeros())


@register_tree_impl("trimmed_mean")
def _trimmed_mean_tree(ctx: TreeContext) -> TreeAgg:
    agg = [torch.mean(torch.sort(l.to(ctx.cdt), dim=0).values
                      [ctx.f:ctx.n - ctx.f], dim=0) for l in ctx.leaves]
    return TreeAgg(agg, ctx.uniform(), ctx.zeros())


@register_tree_impl("krum")
def _krum_tree(ctx: TreeContext) -> TreeAgg:
    scores = gars.krum_scores(ctx.dists(), _everyone(ctx), ctx.f, ctx.n)
    i = torch.argmin(scores)
    return TreeAgg(ctx.take_worker(i), _one_hot(i, ctx), scores)


@register_tree_impl("geomed")
def _geomed_tree(ctx: TreeContext) -> TreeAgg:
    scores = gars.geomed_scores(ctx.dists(), _everyone(ctx))
    i = torch.argmin(scores)
    return TreeAgg(ctx.take_worker(i), _one_hot(i, ctx), scores)


@register_tree_impl("multikrum")
def _multikrum_tree(ctx: TreeContext) -> TreeAgg:
    scores = gars.krum_scores(ctx.dists(), _everyone(ctx), ctx.f, ctx.n)
    m = max(1, ctx.n - ctx.f - 2)
    top = gars.top_k_total_order(-scores, m)
    selected = torch.zeros((ctx.n,), dtype=ctx.cdt, device=scores.device)
    selected[top] = 1.0 / m
    return TreeAgg(ctx.weighted_sum(selected), selected, scores)


@register_tree_impl("brute")
def _brute_tree(ctx: TreeContext) -> TreeAgg:
    diam = gars.brute_subset_diameters(ctx.dists(), ctx.n, ctx.f)
    selected, scores = gars._brute_weights(diam, ctx.n, ctx.f, ctx.cdt)
    return TreeAgg(ctx.weighted_sum(selected), selected, scores)


def bulyan_tree(ctx: TreeContext, base: str = "krum") -> TreeAgg:
    """Distributed Bulyan(base) for the distance-only bases (krum/geomed).

    Phase 1 runs on the ``(n, n)`` distance matrix alone
    (``select_indices_from_dists``); phase 2 is the engine's windowed
    coordinate phase, applied per leaf.

    Args:
      ctx: the engine-prepared tree context.
      base: phase-1 base rule, ``"krum"`` or ``"geomed"`` (bound by the
        resolver when it builds ``bulyan-<base>``).

    Returns:
      A ``TreeAgg`` whose ``selected`` marks the theta = n - 2f phase-1
      picks with 1.0.
    """
    idx = bulyan_lib.select_indices_from_dists(ctx.dists(), ctx.f,
                                               base=base)
    agg = [ctx.coordinate_phase(l.to(ctx.cdt)[idx], ctx.f)
           for l in ctx.leaves]
    selected = torch.zeros((ctx.n,), dtype=ctx.cdt,
                           device=ctx.leaves[0].device)
    selected[idx] = 1.0
    return TreeAgg(agg, selected, ctx.zeros())

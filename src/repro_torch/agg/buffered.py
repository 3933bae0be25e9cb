"""Stateful aggregation: history-buffered rules and momentum centered
clipping (counterpart of ``repro/agg/buffered.py``).

``buffered-<base>`` (Alistarh et al. 2018-style) keeps each worker's
last W submissions in a ring buffer carried by the caller's
:class:`~repro_torch.agg.state.AggState`, means each worker's window
(over the filled prefix until the ring is full) and hands the smoothed
stack to the base rule.

``centered_clip_momentum`` is ``centered_clip`` (Karimireddy et al.
2021) whose clipping center starts from the previous step's converged
center instead of the current mean.  Its fixed-point body is shared
with the tree path of ``centered_clip``; the per-worker deviation norm
is the global norm across leaves, as in the flat rule.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.agg.registry import (AggregatorRule, TreeAgg, TreeContext,
                                     register_rule, register_tree_impl)
from repro_torch.agg.state import AggState
from repro_torch.core.types import AggResult

__all__ = ["centered_clip_momentum", "make_buffered"]

_TAU = 10.0
_ITERS = 3


def _clip_fixed_point(leaves: Sequence[torch.Tensor], n: int, cdt,
                      v0: Sequence[torch.Tensor], tau: float = _TAU,
                      iters: int = _ITERS) -> List[torch.Tensor]:
    """Clip worker deviations from a running center, ``iters`` times.

    Args:
      leaves: worker-stacked ``(n, *dims)`` leaves, already in ``cdt``.
      n: worker count.
      cdt: compute dtype.
      v0: initial center leaves, ``(*dims,)`` each.
      tau: clipping radius.
      iters: fixed-point iterations.

    Returns:
      The converged center leaves.
    """
    v = list(v0)
    for _ in range(iters):
        deltas = [l - vi[None] for l, vi in zip(leaves, v)]
        norm2 = torch.zeros((n,), dtype=cdt, device=leaves[0].device)
        for dlt in deltas:
            norm2 = norm2 + torch.sum(dlt * dlt,
                                      dim=tuple(range(1, dlt.ndim)))
        scale = torch.clamp_max(
            tau / torch.clamp_min(torch.sqrt(norm2), 1e-12), 1.0)
        v = [vi + torch.mean(
            dlt * scale.reshape((n,) + (1,) * (dlt.ndim - 1)), dim=0)
             for vi, dlt in zip(v, deltas)]
    return v


@register_tree_impl("centered_clip")
def _centered_clip_tree(ctx: TreeContext) -> TreeAgg:
    leaves = [l.to(ctx.cdt) for l in ctx.leaves]
    v0 = [torch.mean(l, dim=0) for l in leaves]
    v = _clip_fixed_point(leaves, ctx.n, ctx.cdt, v0)
    return TreeAgg(v, ctx.uniform(), ctx.zeros())


@register_rule("centered_clip_momentum", min_n=lambda f: 2 * f + 1,
               stateful=True, state_fields=("center",),
               # the carried center is an earlier step's fixed point and
               # may sit outside the current stack's hull
               invariants=("finite",),
               doc="centered clipping with the center carried across steps")
def centered_clip_momentum(grads: torch.Tensor, f: int,
                           state: AggState) -> Tuple[AggResult, AggState]:
    """Momentum-carried centered clipping on a flat ``(n, d)`` matrix.

    Args:
      grads: ``(n, d)`` worker rows.
      f: Byzantine bound (unused by the clip; kept for the rule
        signature).
      state: carried ``AggState``; ``state.center`` seeds the center
        from step 1 on (step 0 starts from the current mean).

    Returns:
      ``(AggResult, new_state)`` with the converged center stored in
      ``center``.
    """
    del f
    n = grads.shape[0]
    g = grads.to(torch.float32)
    v0 = torch.mean(g, dim=0) if state.step == 0 else state.center
    (v,) = _clip_fixed_point([g], n, torch.float32, [v0])
    w = torch.full((n,), 1.0 / n, dtype=grads.dtype, device=grads.device)
    res = AggResult(v.to(grads.dtype), w, torch.zeros_like(w))
    return res, state._replace(step=state.step + 1, center=v)


@register_tree_impl("centered_clip_momentum")
def _centered_clip_momentum_tree(ctx: TreeContext, state: AggState
                                 ) -> Tuple[TreeAgg, AggState]:
    leaves = [l.to(ctx.cdt) for l in ctx.leaves]
    if state.step == 0:
        v0 = [torch.mean(l, dim=0) for l in leaves]
    else:
        v0 = [c.to(ctx.cdt) for c in state.center]
    v = _clip_fixed_point(leaves, ctx.n, ctx.cdt, v0)
    new = state._replace(step=state.step + 1,
                         center=tuple(c.to(torch.float32) for c in v))
    return TreeAgg(v, ctx.uniform(), ctx.zeros()), new


def _window_update(history: torch.Tensor, grads: torch.Tensor, step: int,
                   window: int):
    """Write ``grads`` into the ring buffer; return (buffer, smoothed).

    The buffer is copied, not written in place: the caller's state stays
    valid."""
    hist = history.clone()
    hist[step % window] = grads.to(history.dtype)
    filled = float(min(step + 1, window))
    return hist, torch.sum(hist, dim=0) / filled


def make_buffered(name: str, base: AggregatorRule,
                  window: int) -> AggregatorRule:
    """Build the ``buffered-<base>`` composite around a stateless rule.

    Args:
      name: composite registry name (``"buffered-<base>"``).
      base: the resolved stateless base rule; its tree side is wrapped
        only when it has one.
      window: sliding-window length W >= 1.

    Returns:
      A stateful :class:`AggregatorRule` with ``state_fields =
      ("history",)`` and the base's quorum.
    """
    if window < 1:
        raise ValueError(f"history window must be >= 1, got {window}")

    def dense(grads, f, state):
        hist, smoothed = _window_update(state.history, grads, state.step,
                                        window)
        res = base.dense_fn(smoothed.to(grads.dtype), f)
        return res, state._replace(step=state.step + 1, history=hist)

    tree_fn = None
    if base.tree_fn is not None:
        def tree_fn(ctx, state):
            pairs = [_window_update(h, l, state.step, window)
                     for h, l in zip(state.history, ctx.leaves)]
            out = base.tree_fn(ctx.with_leaves([s for _, s in pairs]))
            return out, state._replace(step=state.step + 1,
                                       history=tuple(h for h, _ in pairs))

    return AggregatorRule(
        name=name, min_n=base.min_n, dense_fn=dense, tree_fn=tree_fn,
        byzantine_resilient=base.byzantine_resilient, stateful=True,
        state_fields=("history",), history_window=window,
        invariants=base.invariants,
        doc=f"window-{window} history means fed to {base.name} "
            f"(Alistarh et al. 2018-style)")

"""Reputation-weighted aggregation: the ``reputation-<base>`` family
(counterpart of ``repro/agg/reputation.py``).

ByGARS-style (Regatti et al., arXiv:2006.13421): per-worker scores
``rep`` live in the carried :class:`~repro_torch.agg.state.AggState`
(ones at first).  Per step ``reputation-<base>``

1. normalizes weights ``w = rep / max(rep)``;
2. blends each worker row toward the trust-weighted mean,
   ``w_i * g_i + (1 - w_i) * g_w``; a row with ``w_i == 1`` passes
   untouched, so uniform reputation reproduces the base rule bitwise;
3. clamps the Byzantine bound to the largest ``f' <= f`` the base's
   quorum admits at this n (the composite's own quorum is
   ``base.min_n(0)``, constant in f);
4. runs the base on the blended stack, then updates the scores by an
   EMA of the cosine agreement between each raw row and the aggregate:
   ``rep <- clip(rep_decay * ((1 - rep_lr) * rep + rep_lr * s), 0, 1)``
   with ``s = (1 + cos) / 2``.

:func:`step_size_multiplier` maps the scores to a learning-rate factor
in ``(0, 1]`` that the trainers apply when ``spec.rep_lr`` is set.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.agg.registry import AggregatorRule
from repro_torch.agg.state import AggState

__all__ = ["DEFAULT_REP_DECAY", "DEFAULT_REP_LR", "blend_stack",
           "make_reputation", "reputation_scale", "reputation_scores",
           "step_size_multiplier", "tree_reputation_scores",
           "update_reputation"]

#: EMA rate of the per-step reputation update (``rep_lr``)
DEFAULT_REP_LR = 0.5

#: multiplicative forgetting factor applied after the EMA (``rep_decay``)
DEFAULT_REP_DECAY = 1.0

_EPS = 1e-12


def reputation_scale(state: AggState) -> torch.Tensor:
    """Per-worker weights ``w = rep / max(rep)`` in ``(0, 1]``.

    Args:
      state: carried ``AggState`` with a ``reputation`` buffer of shape
        ``(n,)`` (or ``(n, batch)``, normalized per column).

    Returns:
      fp32 weights of the buffer's shape; all exactly 1.0 for a
      uniform buffer.
    """
    rep = state.reputation.to(torch.float32)
    m = torch.amax(rep, dim=0, keepdim=True)
    return rep / torch.clamp_min(m, _EPS)


def _cosine_scores(num, g2, t2) -> torch.Tensor:
    cos = num / (torch.sqrt(g2) * torch.sqrt(t2)[None] + _EPS)
    return 0.5 * (1.0 + cos)


def reputation_scores(grads: torch.Tensor, target: torch.Tensor, *,
                      rep_ndim: int = 1) -> torch.Tensor:
    """Cosine-agreement scores ``(1 + cos(g_i, target)) / 2`` in [0, 1].

    Args:
      grads: worker-stacked ``(n, *dims)`` raw submissions.
      target: the trusted signal of shape ``dims`` (the aggregate, or a
        clean auxiliary gradient).
      rep_ndim: rank of the score array; 1 contracts everything after
        the worker axis.

    Returns:
      ``(n,)`` (or ``(n, batch)`` for ``rep_ndim=2``) fp32 scores.
    """
    g = grads.to(torch.float32)
    t = target.to(torch.float32)
    red = tuple(range(rep_ndim, g.ndim))
    tred = tuple(range(rep_ndim - 1, t.ndim))
    return _cosine_scores(torch.sum(g * t[None], dim=red),
                          torch.sum(g * g, dim=red),
                          torch.sum(t * t, dim=tred))


def update_reputation(rep: torch.Tensor, scores: torch.Tensor,
                      rep_lr: float = DEFAULT_REP_LR,
                      rep_decay: float = DEFAULT_REP_DECAY) -> torch.Tensor:
    """One EMA step of the schedule, clipped into [0, 1].

    Args:
      rep: current reputation.
      scores: agreement scores of the same shape.
      rep_lr: EMA rate in [0, 1].
      rep_decay: forgetting factor in (0, 1].

    Returns:
      ``clip(rep_decay * ((1 - rep_lr) * rep + rep_lr * scores), 0, 1)``
      in fp32.
    """
    new = ((1.0 - rep_lr) * rep.to(torch.float32)
           + rep_lr * scores.to(torch.float32))
    return torch.clamp(rep_decay * new, 0.0, 1.0)


def step_size_multiplier(state: AggState) -> torch.Tensor:
    """The learning-rate factor in (0, 1]: the mean of
    :func:`reputation_scale` (exactly 1 for a fully trusted committee).

    Args:
      state: carried ``AggState`` with a ``reputation`` buffer.

    Returns:
      fp32 scalar.
    """
    return torch.mean(reputation_scale(state))


def blend_stack(leaf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reputation blend of one worker-stacked leaf (bitwise at w == 1).

    Args:
      leaf: worker-stacked ``(n, *dims)`` tensor.
      w: weights in [0, 1] of shape ``(n,)`` (or ``(n, batch)``),
        broadcast over the trailing dims.

    Returns:
      ``w_i * g_i + (1 - w_i) * g_w`` per row, ``g_w`` the
      weight-normalized mean; a row with ``w_i == 1`` is returned as is.
    """
    wr = w.reshape(tuple(w.shape) + (1,) * (leaf.ndim - w.ndim)).to(
        leaf.dtype)
    den = torch.clamp_min(torch.sum(w, dim=0), _EPS).to(leaf.dtype)
    wmean = torch.sum(wr * leaf, dim=0) / den.reshape(
        tuple(den.shape) + (1,) * (leaf.ndim - 1 - den.ndim))
    # the where carries the bitwise contract: w == 1 returns the row
    # itself, untouched by the blend's rounding
    return torch.where(wr == 1.0, leaf, wr * leaf + (1.0 - wr) * wmean[None])


def tree_reputation_scores(leaves: Sequence[torch.Tensor],
                           agg_leaves: Sequence[torch.Tensor],
                           rep_ndim: int = 1) -> torch.Tensor:
    """:func:`reputation_scores` over a tree: the dot product and both
    squared norms accumulated leaf by leaf, one cosine over the
    concatenated coordinate space.

    Args:
      leaves: worker-stacked ``(n, *dims)`` leaves.
      agg_leaves: target leaves of shapes ``dims``.
      rep_ndim: rank of the score array.

    Returns:
      ``(n,)`` (or ``(n, batch)``) fp32 scores in [0, 1].
    """
    dev = leaves[0].device
    num = torch.zeros((), dtype=torch.float32, device=dev)
    g2 = torch.zeros((), dtype=torch.float32, device=dev)
    t2 = torch.zeros((), dtype=torch.float32, device=dev)
    for leaf, agg in zip(leaves, agg_leaves):
        g = leaf.to(torch.float32)
        t = agg.to(torch.float32)
        red = tuple(range(rep_ndim, g.ndim))
        tred = tuple(range(rep_ndim - 1, t.ndim))
        num = num + torch.sum(g * t[None], dim=red)
        g2 = g2 + torch.sum(g * g, dim=red)
        t2 = t2 + torch.sum(t * t, dim=tred)
    return _cosine_scores(num, g2, t2)


def _clamp_f(base: AggregatorRule, n: int, f: int) -> int:
    """Largest f' <= f the base quorum admits at this n."""
    f_eff = f
    while f_eff > 0 and base.min_n(f_eff) > n:
        f_eff -= 1
    return f_eff


def make_reputation(name: str, base: AggregatorRule,
                    rep_lr: float = DEFAULT_REP_LR,
                    rep_decay: float = DEFAULT_REP_DECAY) -> AggregatorRule:
    """Build the ``reputation-<base>`` composite around any registered rule.

    Args:
      name: composite registry name (``"reputation-<base>"``).
      base: the resolved base rule; a stateful base threads the same
        state.  Its tree side is wrapped only when it has one.
      rep_lr: EMA rate of the score update.
      rep_decay: forgetting factor of the schedule.

    Returns:
      A stateful :class:`AggregatorRule` with ``"reputation"`` first in
      its ``state_fields``, ``min_n = base.min_n(0)`` (constant in f)
      and the base's invariants without ``"trimmed"``.
    """
    state_fields: Tuple[str, ...] = (
        ("reputation",)
        + tuple(f for f in base.state_fields if f != "reputation"))
    min_n0 = base.min_n(0)

    def dense(grads, f, state):
        f_eff = _clamp_f(base, grads.shape[0], f)
        rep = state.reputation
        scaled = blend_stack(grads, reputation_scale(state).to(grads.dtype))
        if base.stateful:
            res, state = base.dense_fn(scaled, f_eff, state)
        else:
            res = base.dense_fn(scaled, f_eff)
            state = state._replace(step=state.step + 1)
        scores = reputation_scores(grads, res.gradient, rep_ndim=rep.ndim)
        return res, state._replace(
            reputation=update_reputation(rep, scores, rep_lr, rep_decay))

    tree_fn = None
    if base.tree_fn is not None:
        def tree_fn(ctx, state):
            f_eff = _clamp_f(base, ctx.n, ctx.f)
            rep = state.reputation
            w = reputation_scale(state).to(ctx.cdt)
            # blend in the compute dtype, then give each leaf back its
            # own dtype (exact at w == 1)
            scaled = [blend_stack(l.to(ctx.cdt), w).to(l.dtype)
                      for l in ctx.leaves]
            sctx = dataclasses.replace(ctx, leaves=tuple(scaled), f=f_eff)
            if base.stateful:
                out, state = base.tree_fn(sctx, state)
            else:
                out = base.tree_fn(sctx)
                state = state._replace(step=state.step + 1)
            scores = tree_reputation_scores(ctx.leaves, out.leaves,
                                            rep.ndim)
            return out, state._replace(
                reputation=update_reputation(rep, scores, rep_lr,
                                             rep_decay))

    return AggregatorRule(
        name=name, min_n=lambda f: min_n0, dense_fn=dense, tree_fn=tree_fn,
        byzantine_resilient=base.byzantine_resilient, stateful=True,
        state_fields=state_fields, history_window=base.history_window,
        invariants=tuple(i for i in base.invariants if i != "trimmed"),
        doc=f"reputation-blended worker stack fed to {base.name} "
            f"(ByGARS-style, arbitrary-f)")

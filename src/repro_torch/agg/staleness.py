"""Staleness-aware aggregation: the ``stale-<base>`` family (counterpart
of ``repro/agg/staleness.py``).

Under bounded staleness the master aggregates whatever the gradient bus
holds, and worker w's slot was computed ``s_w = step - versions[w]``
steps ago.  ``stale-<base>`` wraps any registered rule: it weights each
worker by ``inv`` ``1 / (1 + s)`` (the default) or ``exp``
``exp(-lam * (s - min(s)))``, normalizes by the freshest worker
(``w / max(w)``, so nobody is amplified and a uniformly fresh or stale
committee gets scale exactly 1, which reproduces the base rule
bitwise), scales the worker stack and hands it to the base.

Name grammar: ``stale-<base>``, ``stale-inv-<base>``,
``stale-exp-<base>``, e.g. ``stale-fused-bulyan-krum``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.agg.registry import AggregatorRule
from repro_torch.agg.state import AggState

__all__ = ["DEFAULT_STALE_LAMBDA", "make_stale", "stale_scale",
           "stale_weights"]

#: decay rate of the ``exp`` staleness-weight schedule
DEFAULT_STALE_LAMBDA = 0.5


def stale_weights(staleness: torch.Tensor, weight: str = "inv",
                  lam: float = DEFAULT_STALE_LAMBDA) -> torch.Tensor:
    """Per-worker staleness weights (fresh = 1, decreasing).

    Args:
      staleness: ``(n,)`` integer staleness values ``>= 0``.
      weight: ``"inv"`` for ``1 / (1 + s)``, ``"exp"`` for
        ``exp(-lam * (s - min(s)))``.
      lam: decay rate of ``exp`` (ignored by ``inv``).

    Returns:
      ``(n,)`` float32 weights in ``(0, 1]``.
    """
    s = staleness.to(torch.float32)
    if weight == "inv":
        return 1.0 / (1.0 + s)
    if weight == "exp":
        return torch.exp(-lam * (s - torch.min(s)))
    raise ValueError(
        f"staleness weight must be 'inv' or 'exp', got {weight!r}")


def stale_scale(state: AggState, weight: str = "inv",
                lam: float = DEFAULT_STALE_LAMBDA) -> torch.Tensor:
    """Per-worker scale in ``(0, 1]`` read from a carried state.

    Staleness is ``state.step - state.bus.versions``, clamped at 0 (a
    bus stamped ahead of the carried step counts as fresh), weighted by
    :func:`stale_weights` and normalized by the freshest worker.

    Args:
      state: carried ``AggState`` with a bus.
      weight: the weight schedule (see :func:`stale_weights`).
      lam: decay rate of ``exp``.

    Returns:
      ``(n,)`` float32 scale ``w / max(w)``.
    """
    staleness = torch.clamp_min(state.step - state.bus.versions, 0)
    w = stale_weights(staleness, weight, lam)
    return w / torch.max(w)


def make_stale(name: str, base: AggregatorRule, weight: str = "inv",
               lam: float = DEFAULT_STALE_LAMBDA) -> AggregatorRule:
    """Build the ``stale-<base>`` composite around any registered rule.

    Args:
      name: composite registry name (``"stale[-inv|-exp]-<base>"``).
      base: the resolved base rule; a stateful base threads the same
        state and owns the ``step`` increment.  Its tree side is wrapped
        only when it has one.
      weight: the weight schedule (see :func:`stale_weights`).
      lam: decay rate of ``exp``.

    Returns:
      A stateful :class:`AggregatorRule` with ``"bus"`` first in its
      ``state_fields`` and the base's quorum.
    """
    state_fields: Tuple[str, ...] = (
        ("bus",) + tuple(f for f in base.state_fields if f != "bus"))

    def dense(grads, f, state):
        scale = stale_scale(state, weight, lam).to(grads.dtype)
        scaled = grads * scale[:, None]
        if base.stateful:
            return base.dense_fn(scaled, f, state)
        return base.dense_fn(scaled, f), state._replace(step=state.step + 1)

    tree_fn = None
    if base.tree_fn is not None:
        def tree_fn(ctx, state):
            scale = stale_scale(state, weight, lam).to(ctx.cdt)
            sctx = ctx.with_leaves([
                l.to(ctx.cdt) * scale.reshape((ctx.n,) + (1,) * (l.ndim - 1))
                for l in ctx.leaves])
            if base.stateful:
                return base.tree_fn(sctx, state)
            return base.tree_fn(sctx), state._replace(step=state.step + 1)

    return AggregatorRule(
        name=name, min_n=base.min_n, dense_fn=dense, tree_fn=tree_fn,
        byzantine_resilient=base.byzantine_resilient, stateful=True,
        state_fields=state_fields, history_window=base.history_window,
        invariants=base.invariants,
        doc=f"staleness-weighted ({weight}) worker stack fed to "
            f"{base.name}")

"""Aggregation forensics: the ``obs-<base>`` telemetry rule family
(counterpart of ``repro/obs/forensics.py``).

``obs-<base>`` wraps any registered rule through the registry
(``resolve_rule("obs-krum")``, nesting outside the ``stale-`` /
``buffered-`` / ``reputation-`` / ``fused-`` / ``bulyan-`` composites)
and records one :class:`~repro_torch.obs.buffer.AggDiagnostics` row per
call into the :class:`~repro_torch.obs.buffer.MetricsBuffer` ring carried
in ``AggState.obs``.

The contract that makes telemetry free to enable: the wrapper never
touches the data path.  The base rule runs on the stack as given and its
result is returned as it is; the wrapper only reads the stack and the
result (no in-place op on either) to assemble the record.  Quorum,
resilience and declared invariants are the base's own.

The per-coordinate reductions run on a fixed-size coordinate sketch, at
most :data:`OBS_SKETCH` coordinates of the stack, with norms scaled by
``sqrt(d / S)`` back to full-space magnitude, so the cost is bounded by
the committee size, not the model size.  Order statistics on the sketch
are rank counts over the ``(n, n, S)`` cube with ties broken by row
index, as the reference computes them (a sort would put every NaN last).
Means by a constant count are the sum times the fp32 reciprocal, the
product XLA runs for the reference's ``jnp.mean``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.agg.registry import AggregatorRule, TreeContext
from repro_torch.obs.buffer import (DEFAULT_OBS_CAPACITY, AggDiagnostics,
                                    push_record)

__all__ = ["OBS_SKETCH", "dense_diagnostics", "make_obs", "obs_name",
           "sketch_spans", "tree_diagnostics"]

#: max coordinates the forensic reductions touch per record; the dense
#: path samples this many across evenly spaced contiguous blocks, the
#: tree path apportions it over the leaves
OBS_SKETCH = 512

#: evenly spaced contiguous blocks the dense sketch is drawn from
_SKETCH_BLOCKS = 16


def obs_name(gar: str) -> str:
    """The instrumented name of a GAR (idempotent).

    Args:
      gar: any name ``resolve_rule`` accepts.

    Returns:
      ``"obs-<gar>"``, or ``gar`` unchanged when already instrumented.
    """
    return gar if gar.startswith("obs-") else "obs-" + gar


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.mean`` as XLA runs it: the sum times the fp32 reciprocal of
    the count (a Python scalar multiplies an fp32 tensor in fp32)."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    count = math.prod(x.shape[k] for k in dims)
    return torch.sum(x, dim=dims) * (1.0 / count)


def _f32_scalar(step, device) -> torch.Tensor:
    """A step counter (Python int or tensor) as an fp32 ``()`` tensor;
    ``torch.full`` takes the value as a launch argument, no host copy."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.full((), float(step), dtype=torch.float32, device=device)


def _worker_snapshots(state, base: AggregatorRule, n: int,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reputation, staleness) ``(n,)`` fp32 snapshots from the state.

    Branches on the base's ``state_fields``.  The serving reputation
    layout ``(n, batch)`` is averaged over its trailing axes.
    """
    if "reputation" in base.state_fields:
        rep = state.reputation.to(torch.float32)
        if rep.ndim > 1:
            rep = _mean(rep, tuple(range(1, rep.ndim)))
    else:
        rep = torch.ones((n,), dtype=torch.float32, device=device)
    if "bus" in base.state_fields:
        stale = torch.clamp_min(state.step - state.bus.versions,
                                0).to(torch.float32)
    else:
        stale = torch.zeros((n,), dtype=torch.float32, device=device)
    return rep, stale


def _sketch_dense(flat: torch.Tensor) -> torch.Tensor:
    """Deterministic ``(n, S <= OBS_SKETCH)`` sketch of a flat stack.

    Evenly spaced contiguous blocks (block starts by Python's ``round``,
    halves to even, as the reference): representative across the
    coordinate space while reading only ``O(n * S)`` memory.
    """
    d = flat.shape[1]
    if d <= OBS_SKETCH:
        return flat
    blk = OBS_SKETCH // _SKETCH_BLOCKS
    starts = [round(i * (d - blk) / (_SKETCH_BLOCKS - 1))
              for i in range(_SKETCH_BLOCKS)]
    return torch.cat([flat[:, s:s + blk] for s in starts], dim=1)


def _trim_bounds(g: torch.Tensor, f: int):
    """Per-coordinate f-trimmed range of a ``(n, S)`` fp32 sketch.

    Rank-count order statistics with ties broken by row index (a stable
    sort's order): one broadcast compare over ``(n, n, S)``.
    """
    n = g.shape[0]
    f_eff = min(max(int(f), 0), (n - 1) // 2)
    lt = g[None, :, :] < g[:, None, :]
    tie = g[None, :, :] == g[:, None, :]
    idx = torch.arange(n, device=g.device)
    rank = torch.sum(
        lt | (tie & (idx[None, :, None] < idx[:, None, None])), dim=1)
    lo = torch.sum(torch.where(rank == f_eff, g, 0.0), dim=0)
    hi = torch.sum(torch.where(rank == n - 1 - f_eff, g, 0.0), dim=0)
    return lo, hi


def dense_diagnostics(grads: torch.Tensor, gradient: torch.Tensor,
                      selected: torch.Tensor, scores: torch.Tensor,
                      f: int, step, reputation: torch.Tensor,
                      staleness: torch.Tensor) -> AggDiagnostics:
    """Assemble one forensics row on the dense ``(n, d)`` path.

    fp32 reductions over a :data:`OBS_SKETCH`-bounded coordinate sketch
    of the stack the rule consumed and the result it emitted; nothing
    feeds back into the data path.  Norm-like fields (``dist_to_agg``,
    ``agg_dev``, ``spread``) are scaled by ``sqrt(d / S)``.

    Args:
      grads: the ``(n, *dims)`` worker stack the rule saw.
      gradient: the emitted aggregate, shape ``dims``.
      selected: ``(n,)`` selection mask / weights from the result.
      scores: ``(n,)`` per-worker rule scores from the result.
      f: declared Byzantine bound (clamped to ``(n-1)//2`` for the
        trimmed-range bound).
      step: aggregation step counter to stamp on the record (Python int
        or tensor).
      reputation: ``(n,)`` fp32 post-call reputation snapshot.
      staleness: ``(n,)`` fp32 staleness snapshot.

    Returns:
      A fully populated :class:`AggDiagnostics` on the stack's device.
    """
    n = grads.shape[0]
    d = grads[0].numel()
    g = _sketch_dense(grads.reshape(n, -1)).to(torch.float32)
    a = _sketch_dense(gradient.reshape(1, -1)).to(torch.float32)[0]
    scale = float(d / g.shape[1]) ** 0.5
    dist = torch.sqrt(torch.sum((g - a[None]) ** 2, dim=1)) * scale
    lo, hi = _trim_bounds(g, f)
    out_mask = (g < lo[None]) | (g > hi[None])
    trimmed = _mean(out_mask.to(torch.float32), 1)
    agg_dev = torch.linalg.vector_norm(a - _mean(g, 0)) * scale
    return AggDiagnostics(
        step=_f32_scalar(step, g.device),
        selected=selected.to(torch.float32),
        scores=scores.to(torch.float32),
        dist_to_agg=dist, trimmed_frac=trimmed,
        reputation=reputation, staleness=staleness,
        agg_dev=agg_dev, spread=_mean(dist, 0))


def sketch_spans(numels: Sequence[int]) -> List[Tuple[int, int]]:
    """The tree sketch's window of each leaf.

    The :data:`OBS_SKETCH` coordinate budget is apportioned over the
    leaves by size; each leaf contributes one centered contiguous slice
    of its flattened per-worker coordinates.

    Args:
      numels: each leaf's per-worker coordinate count, in leaf order.

    Returns:
      ``(start, size)`` of each leaf's window.
    """
    total = sum(numels)
    spans = []
    for d_leaf in numels:
        s_leaf = max(1, min(d_leaf, round(OBS_SKETCH * d_leaf / total)))
        spans.append(((d_leaf - s_leaf) // 2, s_leaf))
    return spans


def tree_diagnostics(leaves: Sequence[torch.Tensor],
                     agg_leaves: Sequence[torch.Tensor],
                     selected: torch.Tensor, scores: torch.Tensor,
                     f: int, step, reputation: torch.Tensor,
                     staleness: torch.Tensor,
                     sketch: Optional[Callable] = None) -> AggDiagnostics:
    """Assemble one forensics row on the tree path.

    The per-coordinate reductions run on :func:`sketch_spans`'s windows,
    so no flat ``(n, d)`` matrix is built.  Norm-like fields are scaled
    by ``sqrt(d / S)``.

    Args:
      leaves: worker-stacked ``(n, *dims)`` leaves the rule saw.
      agg_leaves: the emitted aggregate's leaves, shapes ``dims``.
      selected: ``(n,)`` selection mask / weights from the result.
      scores: ``(n,)`` per-worker rule scores from the result.
      f: declared Byzantine bound.
      step: aggregation step counter to stamp on the record.
      reputation: ``(n,)`` fp32 post-call reputation snapshot.
      staleness: ``(n,)`` fp32 staleness snapshot.
      sketch: ``TreeContext.sketch`` when the leaves are a rank's slices
        of a mesh's ``model`` axis: the windows are then read from the
        whole leaves the slices make up, so every rank records what one
        device records (``None``: the leaves are whole).

    Returns:
      A fully populated :class:`AggDiagnostics`.
    """
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if sketch is None:
        numels = [leaf[0].numel() for leaf in leaves]
        windows = []
        for (start, size), leaf, agg in zip(sketch_spans(numels), leaves,
                                             agg_leaves):
            # contiguous windows, as the gathered ones: the reductions
            # below then run in one order whatever the windows came from
            g = leaf.reshape(n, -1)[:, start:start + size].to(
                torch.float32).contiguous()
            a = agg.to(torch.float32).reshape(-1)[start:start + size] \
                .contiguous()
            windows.append((g, a))
    else:
        numels, rows = sketch(leaves, agg_leaves)
        windows = [(r[:n], r[n]) for r in rows]
    total = sum(numels)
    d2 = torch.zeros((n,), dtype=torch.float32, device=dev)
    dev2 = torch.zeros((), dtype=torch.float32, device=dev)
    out_count = torch.zeros((n,), dtype=torch.float32, device=dev)
    coords = 0
    for g, a in windows:
        d2 = d2 + torch.sum((g - a[None]) ** 2, dim=1)
        dev2 = dev2 + torch.sum((a - _mean(g, 0)) ** 2)
        lo, hi = _trim_bounds(g, f)
        out_mask = (g < lo[None]) | (g > hi[None])
        out_count = out_count + torch.sum(out_mask.to(torch.float32),
                                          dim=1)
        coords += g.shape[1]
    scale = float(total / max(coords, 1)) ** 0.5
    dist = torch.sqrt(d2) * scale
    return AggDiagnostics(
        step=_f32_scalar(step, dev),
        selected=selected.to(torch.float32),
        scores=scores.to(torch.float32),
        dist_to_agg=dist,
        trimmed_frac=out_count / max(coords, 1),
        reputation=reputation, staleness=staleness,
        agg_dev=torch.sqrt(dev2) * scale, spread=_mean(dist, 0))


def make_obs(name: str, base: AggregatorRule,
             capacity: Optional[int] = None) -> AggregatorRule:
    """Build the ``obs-<base>`` telemetry composite around any rule.

    The composite is stateful with ``"obs"`` prepended to the base's
    ``state_fields``; ``repro_torch.agg.state.init_state`` allocates the
    ring from the rule's ``obs_capacity``.  The base runs on the stack
    as given and its result is passed through unchanged; only the
    carried ring differs from the uninstrumented rule.  Quorum,
    resilience and invariants are the base's.

    Args:
      name: composite registry name (``"obs-<base>"``).
      base: the resolved base rule; its tree implementation is wrapped
        only when it has one.
      capacity: ring rows to allocate (``None`` =
        :data:`~repro_torch.obs.buffer.DEFAULT_OBS_CAPACITY`).

    Returns:
      A stateful :class:`AggregatorRule` recording one diagnostics row
      per application into ``AggState.obs``.
    """
    state_fields: Tuple[str, ...] = ("obs",) + tuple(
        fld for fld in base.state_fields if fld != "obs")

    def dense(grads, f, state):
        if base.stateful:
            res, state = base.dense_fn(grads, f, state)
        else:
            res = base.dense_fn(grads, f)
            state = state._replace(step=state.step + 1)
        rep, stale = _worker_snapshots(state, base, grads.shape[0],
                                       grads.device)
        rec = dense_diagnostics(grads, res.gradient, res.selected,
                                res.scores, f, state.step, rep, stale)
        return res, state._replace(obs=push_record(state.obs, rec))

    tree_fn = None
    if base.tree_fn is not None:
        def tree_fn(ctx: TreeContext, state):
            if base.stateful:
                out, state = base.tree_fn(ctx, state)
            else:
                out = base.tree_fn(ctx)
                state = state._replace(step=state.step + 1)
            rep, stale = _worker_snapshots(state, base, ctx.n,
                                           ctx.leaves[0].device)
            rec = tree_diagnostics(ctx.leaves, out.leaves, out.selected,
                                   out.scores, ctx.f, state.step, rep,
                                   stale, sketch=ctx.sketch)
            return out, state._replace(obs=push_record(state.obs, rec))

    return AggregatorRule(
        name=name, min_n=base.min_n, dense_fn=dense, tree_fn=tree_fn,
        byzantine_resilient=base.byzantine_resilient, stateful=True,
        state_fields=state_fields, history_window=base.history_window,
        invariants=base.invariants,
        obs_capacity=capacity or DEFAULT_OBS_CAPACITY,
        doc=f"forensics-recording wrapper around {base.name} "
            f"(bitwise data path)")

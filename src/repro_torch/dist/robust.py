"""Tree-aware robust aggregation: the engine behind every distributed
aggregation (counterpart of ``repro/dist/robust.py``).

Gradients stay a tree (a dict of ``(n, *dims)`` leaves with a shared
leading worker axis, in the reference's leaf order: sorted keys) rather
than one flat ``(n, d)`` matrix:

  * distance-based selection (Krum, GeoMed, Bulyan phase 1) needs only
    the ``(n, n)`` squared-distance matrix, accumulated as a sum of
    per-leaf partial Grams;
  * coordinate-wise phases (cwmed, trimmed mean, Bulyan phase 2) run per
    leaf; ``coordinate_phase_nd`` can window the flattened trailing dims
    to bound the sort's workspace.

The rule bodies live behind the registry (``repro_torch.agg.tree`` and
``repro_torch.agg.fused``); ``distributed_aggregate`` hands them this
machinery through a ``TreeContext``.

Accumulation dtype: the flat reference casts everything to fp32
(``repro_torch.core.pytree.stack_flatten``), so the default here is fp32
too; ``agg_dtype="bfloat16"`` computes the torch backend's Gram and the
coordinate phases in bf16.  The kernels always accumulate in fp32.

Distance backends (``distance_backend=``):

  "xla"     per-leaf matrix products in plain PyTorch (the reference's
            ``jnp.tensordot`` path; the name is kept so ``AggSpec``
            values carry over), the semantics reference;
  "pallas"  the port's K1 kernel (``pairwise_gram_tree``: one
            ``pairwise_gram_partial`` per leaf); the reference's name for
            its Pallas kernel is kept as the accepted string;
  "fused"   reroutes the rule onto its ``fused-<base>`` composite
            (``repro_torch.agg.fused``): the selection kernel and K4 per
            leaf, or K5 for a single-leaf tree; a rule with no fused
            lowering runs unchanged over K1;
  "auto"    "xla": the reference picks its kernel only for a mesh with a
            model axis, and the sharded runtime is not ported (ROADMAP
            item 9), so ``mesh`` must be ``None``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.core.attacks import _alie_z, _anti_or_ones, _closed_gamma
from repro_torch.core.bulyan import coordinate_phase
from repro_torch.core.pytree import tree_leaves, tree_unflatten
from repro_torch.kernels.pairwise_gram import (finalize_dists,
                                               pairwise_gram_tree)
from repro_torch.obs.trace import named_span

__all__ = ["DistAggResult", "coordinate_phase_nd", "distributed_aggregate",
           "inject_byzantine", "pairwise_sq_dists_tree",
           "resolve_distance_backend"]


class DistAggResult(NamedTuple):
    """Per-worker diagnostics of one distributed aggregation (the
    aggregate itself is returned as a tree alongside)."""

    selected: torch.Tensor  # (n,) weights of each worker in the output
    scores: torch.Tensor    # (n,) rule scores (lower = better), or zeros


def _leaves(tree) -> List[torch.Tensor]:
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty gradient tree")
    return leaves


def _worker_count(tree) -> int:
    leaves = _leaves(tree)
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != n:
            raise ValueError(
                f"every leaf needs a leading worker axis of {n}, got "
                f"shape {tuple(leaf.shape)}")
    return n


def _compute_dtype(agg_dtype: str) -> torch.dtype:
    if agg_dtype == "bfloat16":
        return torch.bfloat16
    if agg_dtype in ("native", "float32"):
        return torch.float32
    raise ValueError(f"unknown agg_dtype {agg_dtype!r}")


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------

def resolve_distance_backend(distance_backend: str, mesh=None) -> str:
    """Resolve the user-facing backend knob to a concrete implementation.

    Args:
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"`` (see the module docstring; ``"pallas"`` names the
        port's K1 kernel).
      mesh: must be ``None``: the sharded runtime is ROADMAP item 9.

    Returns:
      ``"xla"``, ``"pallas"`` or ``"fused"``; ``"auto"`` resolves to
      ``"xla"``, as the reference does without a mesh.  Raises
      ``NotImplementedError`` for a mesh and ``ValueError`` for an
      unknown name.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= needs the sharded runtime, which is not ported yet "
            "(ROADMAP item 9)")
    if distance_backend == "auto":
        return "xla"
    if distance_backend not in ("xla", "pallas", "fused"):
        raise ValueError(
            f"distance_backend must be 'xla', 'pallas', 'fused' or "
            f"'auto', got {distance_backend!r}")
    return distance_backend


def pairwise_sq_dists_tree(tree: Any, compute_dtype=torch.float32, *,
                           distance_backend: str = "xla",
                           mesh=None) -> torch.Tensor:
    """Squared euclidean distances over the concatenation of all leaves.

    Args:
      tree: dict (or list) of ``(n, *dims)`` worker-stacked gradients.
      compute_dtype: accumulation dtype of the ``"xla"`` backend and the
        dtype of the returned matrix (the kernel accumulates fp32).
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"``; ``"fused"`` takes the same K1 pass as ``"pallas"``.
      mesh: must be ``None`` (see :func:`resolve_distance_backend`).

    Returns:
      ``(n, n)`` squared distances in ``compute_dtype``, a sum of
      per-leaf partial Grams; no flat ``(n, d)`` copy is built.
    """
    n = _worker_count(tree)
    backend = resolve_distance_backend(distance_backend, mesh)
    with named_span("agg/gram"):
        if backend in ("pallas", "fused"):
            return pairwise_gram_tree(tree).to(compute_dtype)
        leaves = _leaves(tree)
        dev = leaves[0].device
        gram = torch.zeros((n, n), dtype=compute_dtype, device=dev)
        sq = torch.zeros((n,), dtype=compute_dtype, device=dev)
        for leaf in leaves:
            x = leaf.to(compute_dtype).reshape(n, -1)
            gram = gram + x @ x.T
            sq = sq + torch.sum(x * x, dim=1)
        return finalize_dists(sq[:, None] + sq[None, :] - 2.0 * gram)


# ---------------------------------------------------------------------------
# coordinate phase over arbitrary trailing dims
# ---------------------------------------------------------------------------

def coordinate_phase_nd(selected: torch.Tensor, f: int,
                        window: Optional[int] = None) -> torch.Tensor:
    """Bulyan's coordinate-wise phase over arbitrary trailing dims.

    Args:
      selected: ``(theta, *dims)`` stack of phase-1-selected gradients.
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.
      window: caps the coordinates processed at once (the sort and the
        two cumulative sums need O(theta * window) workspace); ``None``
        (or ``<= 0``) processes every coordinate in one shot.

    Returns:
      ``(*dims,)``: per coordinate, the mean of the beta values closest
      to the median (``repro_torch.core.bulyan.coordinate_phase`` on the
      flattened ``(theta, d)`` view, chunk by chunk when windowed).
    """
    trailing = selected.shape[1:]
    d = math.prod(trailing)
    flat = selected.reshape(selected.shape[0], d)
    with named_span("agg/coordinate"):
        if window is None or window <= 0 or d <= window:
            return coordinate_phase(flat, f).reshape(trailing)
        chunks = [coordinate_phase(flat[:, s:s + window], f)
                  for s in range(0, d, window)]
        return torch.cat(chunks, dim=0).reshape(trailing)


# ---------------------------------------------------------------------------
# the engine: registry rules over the distance / coordinate machinery
# ---------------------------------------------------------------------------

def distributed_aggregate(tree: Any, f: int, gar: str = "bulyan-krum", *,
                          agg_dtype: str = "native",
                          window: Optional[int] = None,
                          distance_backend: str = "auto", mesh=None,
                          state=None, history_window: Optional[int] = None,
                          rep_lr: Optional[float] = None,
                          rep_decay: Optional[float] = None):
    """Apply GAR ``gar`` across the leading worker axis of a gradient tree,
    leaf by leaf.

    Contract (the reference's): the result equals the flat rule on
    ``stack_flatten`` of the same tree, up to summation order.

    Args:
      tree: dict (or list, or one tensor) of ``(n, *dims)``
        worker-stacked gradients, fp32 or bf16.
      f: Byzantine bound the rule defends against (quorum-checked).
      gar: any rule with a tree implementation: the registered rules,
        ``bulyan-krum``, ``bulyan-geomed``, ``fused-<base>`` and the
        stateful ``buffered-<base>``, ``centered_clip_momentum``,
        ``stale[-inv|-exp]-<base>`` and ``reputation-<base>``.
      agg_dtype: ``"native"`` (fp32) | ``"float32"`` | ``"bfloat16"``.
      window: coordinate-phase window of the bulyan rules (see
        :func:`coordinate_phase_nd`).
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"`` (see the module docstring).
      mesh: must be ``None`` (ROADMAP item 9).
      state: carried ``AggState`` of a stateful rule (``None``
        zero-initializes one); stateless rules ignore it.
      history_window: ``buffered-*`` window (``None``: the registry's
        default).
      rep_lr: ``reputation-*`` EMA rate (``None``: the default).
      rep_decay: ``reputation-*`` forgetting factor (``None``: the
        default).

    Returns:
      ``(aggregated tree, DistAggResult)`` for a stateless rule and
      ``(aggregated tree, DistAggResult, new_state)`` for a stateful
      one; the aggregate's leaves keep their input dtypes.
    """
    from repro_torch.agg.registry import TreeContext, resolve_rule
    from repro_torch.agg.specs import check_quorum
    from repro_torch.agg.state import init_state

    n = _worker_count(tree)
    params = dict(history_window=history_window, rep_lr=rep_lr,
                  rep_decay=rep_decay)
    rule = resolve_rule(gar, **params)
    check_quorum(gar, n, f, distributed=True, history_window=history_window)
    backend = resolve_distance_backend(distance_backend, mesh)
    if backend == "fused":
        from repro_torch.agg.fused import fused_name
        lowered = fused_name(gar)
        if lowered is not None:
            rule = resolve_rule(lowered, **params)
    cdt = _compute_dtype(agg_dtype)
    leaves = _leaves(tree)

    def make_dists(ls):
        return pairwise_sq_dists_tree(list(ls), cdt,
                                      distance_backend=backend)

    ctx = TreeContext(
        leaves=tuple(leaves), n=n, f=f, cdt=cdt, make_dists=make_dists,
        coordinate_phase=partial(coordinate_phase_nd, window=window))
    if rule.stateful:
        if state is None:
            state = init_state(rule, tree, flat=False)
        with named_span("agg/select"):
            out, state = rule.tree_fn(ctx, state)
    else:
        with named_span("agg/select"):
            out = rule.tree_fn(ctx)
    agg = tree_unflatten(tree, [a.to(leaf.dtype)
                                for a, leaf in zip(out.leaves, leaves)])
    res = DistAggResult(out.selected, out.scores)
    return (agg, res, state) if rule.stateful else (agg, res)


# ---------------------------------------------------------------------------
# per-leaf Byzantine injection
# ---------------------------------------------------------------------------

def _tree_delta_bar(honest_leaves) -> torch.Tensor:
    """Paper §B.1 ``delta_bar`` over the concatenated coordinate space,
    accumulated per leaf: 2/sqrt(pi) times the mean over coordinates of
    the per-coordinate population std (``jnp.std``, ddof 0) across the
    honest workers."""
    total = torch.zeros((), dtype=torch.float32,
                        device=honest_leaves[0].device)
    count = 0
    for leaf in honest_leaves:
        x = leaf.to(torch.float32)
        total = total + torch.sum(torch.std(x, dim=0, correction=0))
        count += math.prod(leaf.shape[1:])
    c = 2.0 / torch.sqrt(torch.tensor(math.pi, dtype=torch.float32))
    return c.to(total.device) * total / max(count, 1)


def _lp_direction(means, leaves, coord, step):
    """(flat coordinate, sign) of ``omniscient_lp``'s one-hot direction,
    over the concatenated coordinate space in leaf order."""
    d = sum(math.prod(l.shape[1:]) for l in leaves)
    if coord == "rotate":
        return (0 if step is None else int(step)) % d, 1.0
    if coord == "top":
        # the coordinate where the honest mean is largest in magnitude,
        # attacked against its sign (first leaf, then first index, wins)
        flat = [m.reshape(-1) for m in means]
        maxes = torch.stack([torch.max(torch.abs(m)) for m in flat])
        j = int(torch.argmax(maxes))
        arg = int(torch.argmax(torch.abs(flat[j])))
        off = sum(math.prod(l.shape[1:]) for l in leaves[:j])
        return off + arg, -torch.sign(flat[j][arg])
    if isinstance(coord, int) and not 0 <= coord < d:
        raise ValueError(f"coord must be in [0, {d}), 'rotate' or 'top'; "
                         f"got {coord!r}")
    return int(coord), 1.0


def inject_byzantine(tree: Any, f: int, attack: str, generator=None, *,
                     gar_name: str = "krum", step=None, gamma=None,
                     scale: Optional[float] = None, eps: float = 0.5,
                     z: Optional[float] = None, target: int = 0,
                     coord=0, margin: float = 1.0,
                     direction: str = "ones", prev: Any = None,
                     hold: int = 0, build: int = 5) -> Any:
    """Replace the last ``f`` worker rows of every leaf with Byzantine
    submissions computed from the first ``n - f`` (honest) rows.

    All attacks run per leaf: the coordinate-wise ones (signflip, zero,
    mimic, ipm, alie, random) are exactly their flat counterparts; the
    omniscient ones use the paper's §B closed-form gamma (the exact
    search needs the flat rule inside its loop), as the reference's
    distributed runtime does.

    Args:
      tree: dict (or list, or one tensor) of ``(n, *dims)``
        worker-stacked gradients.
      f: number of rows to overwrite (``f <= 0`` is a no-op).
      attack: ``"none"``, ``"signflip"``, ``"zero"``, ``"mimic"``,
        ``"ipm"``, ``"alie"``, ``"random"``, ``"omniscient_linf"``,
        ``"omniscient_lp"``, ``"stale_replay"``, ``"slow_drift"``,
        ``"reputation_burn"`` or ``"colluding_majority"``.
      generator: the ``torch.Generator`` of ``random`` and of
        ``colluding_majority``'s random direction (``None``: one seeded
        with 0); its stream differs from the reference's ``jax.random``.
      gar_name: rule the omniscient adversary targets (closed-form gamma).
      step: training step (``omniscient_lp`` with ``coord="rotate"``,
        the delay attacks and ``reputation_burn``).
      gamma: ``None`` or ``"closed"`` for the §B estimate (times
        ``margin``), or a float used verbatim.
      scale: magnitude of signflip (default 1), random (10),
        stale_replay (1) and reputation_burn (3).
      eps: ipm's factor, slow_drift's drift per step and
        colluding_majority's offset, in units of delta_bar for the last
        two.
      z: alie's z-score (``None``: from n and f, as the reference).
      target: mimic's copied honest worker.
      coord: ``omniscient_lp``'s coordinate in the concatenated space
        of the whole tree (leaf order), ``"rotate"`` or ``"top"``.
      margin: factor on the estimated gamma.
      direction: ``omniscient_linf``'s and ``slow_drift``'s +-1 vector,
        ``"ones"`` or ``"anti"`` (against the sign of the honest mean);
        ``colluding_majority``'s offset, ``"anti"`` (the negated honest
        mean) or anything else (random).
      prev: the delay attacks' previous bus rows, a tree of ``(f,
        *dims)`` leaves in the same leaf order (``None``: both submit
        off the current mean).
      hold: ``stale_replay``'s re-record period (0: freeze).
      build: ``reputation_burn``'s trust-building steps.

    Returns:
      The tree with the last f rows of every leaf replaced; dtypes and
      shapes preserved.
    """
    if f <= 0 or attack == "none":
        return tree
    n = _worker_count(tree)
    n_h = n - f
    if n_h < 1:
        raise ValueError(f"need at least one honest worker (n={n}, f={f})")
    leaves = _leaves(tree)
    honest = [l[:n_h] for l in leaves]
    dev = leaves[0].device
    t = 0 if step is None else int(step)
    if generator is None and attack in ("random", "colluding_majority"):
        generator = torch.Generator(dev).manual_seed(0)

    def broadcast(byz_one, leaf):
        """Per-leaf Byzantine value -> f stacked rows, leaf dtype."""
        return byz_one[None].expand((f,) + tuple(leaf.shape[1:])).to(
            leaf.dtype)

    def means():
        return [torch.mean(h.to(torch.float32), dim=0) for h in honest]

    if attack == "signflip":
        s = 1.0 if scale is None else scale
        byz = [broadcast(-s * m, l) for m, l in zip(means(), leaves)]
    elif attack == "zero":
        byz = [torch.zeros((f,) + tuple(l.shape[1:]), dtype=l.dtype,
                           device=l.device) for l in leaves]
    elif attack == "mimic":
        byz = [broadcast(h[target], l) for h, l in zip(honest, leaves)]
    elif attack == "ipm":
        byz = [broadcast(-eps * m, l) for m, l in zip(means(), leaves)]
    elif attack == "random":
        s = 10.0 if scale is None else scale
        byz = [s * torch.randn((f,) + tuple(l.shape[1:]),
                               generator=generator, dtype=l.dtype,
                               device=dev) for l in leaves]
    elif attack == "alie":
        if z is None:
            z = _alie_z(n, f)
        byz = [broadcast(m - z * torch.std(h.to(torch.float32), dim=0,
                                           correction=0), l)
               for m, h, l in zip(means(), honest, leaves)]
    elif attack in ("stale_replay", "slow_drift"):
        ms = means()
        prevs = tree_leaves(prev) if prev is not None else [None] * len(
            leaves)
        if len(prevs) != len(leaves):
            raise ValueError(
                "prev must mirror the gradient tree's flat leaf order")
        if attack == "stale_replay":
            s = 1.0 if scale is None else scale
            refresh = t == 0 or (hold > 0 and t % hold == 0)
            byz = [broadcast(s * m, l) if p is None or refresh
                   else p.to(l.dtype)
                   for m, l, p in zip(ms, leaves, prevs)]
        else:
            db = _tree_delta_bar(honest)
            es = [_anti_or_ones(m, direction) for m in ms]
            byz = []
            for m, e, l, p in zip(ms, es, leaves, prevs):
                if p is None:
                    byz.append(broadcast(m + eps * db * e, l))
                elif t == 0:
                    byz.append(broadcast(m, l))
                else:
                    byz.append((p.to(torch.float32)
                                + eps * db * e[None]).to(l.dtype))
    elif attack == "reputation_burn":
        s = 3.0 if scale is None else scale
        factor = 1.0 if t < build else -s
        byz = [broadcast(factor * m, l) for m, l in zip(means(), leaves)]
    elif attack == "colluding_majority":
        # one unit direction over the concatenated coordinate space
        db = _tree_delta_bar(honest)
        ms = means()
        if direction == "anti":
            dirs = [-m for m in ms]
        else:
            dirs = [torch.randn(tuple(l.shape[1:]), generator=generator,
                                dtype=torch.float32, device=dev)
                    for l in leaves]
        norm = torch.sqrt(sum(torch.sum(e * e) for e in dirs)) + 1e-12
        byz = [broadcast(m + eps * db * e / norm, l)
               for m, e, l in zip(ms, dirs, leaves)]
    elif attack in ("omniscient_linf", "omniscient_lp"):
        db = _tree_delta_bar(honest)
        ms = means()
        # gamma None and "closed" both mean the §B closed form here;
        # margin applies to the estimate only
        estimated = gamma is None or gamma == "closed"
        fixed = (None if estimated
                 else torch.tensor(gamma, dtype=torch.float32,
                                   device=db.device))
        if attack == "omniscient_linf":
            g = db * margin if estimated else fixed
            es = [_anti_or_ones(m, direction) for m in ms]
            byz = [broadcast(m + g * e, l)
                   for m, e, l in zip(ms, es, leaves)]
        else:
            d = sum(math.prod(l.shape[1:]) for l in leaves)
            g = (_closed_gamma(gar_name, d, f, db) * margin if estimated
                 else fixed)
            c, sign = _lp_direction(ms, leaves, coord, step)
            byz, off = [], 0
            for m, l in zip(ms, leaves):
                e = torch.zeros_like(m).reshape(-1)
                if off <= c < off + e.numel():
                    e[c - off] = sign
                byz.append(broadcast(m + g * e.reshape(m.shape), l))
                off += e.numel()
    else:
        raise KeyError(f"unknown distributed attack {attack!r}")

    out = [torch.cat([l[:n_h], b], dim=0) for l, b in zip(leaves, byz)]
    return tree_unflatten(tree, out)

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
  "auto"    "pallas" for CUDA tensors under a mesh whose ``model``
            axis is larger than 1, "xla" everywhere else (the
            reference's rule, with the card in the place of the TPU).

With a ``mesh`` whose ``model`` axis is larger than 1 (``mesh=``, the
multi-rank runtime: ``repro_torch.dist.mesh``), every leaf a rank passes
is its local slice in the layout ``repro_torch.dist.sharding.gram_pspec``
gives the leaf's global shape, and ``specs`` says which (a tree of
``P``; ``None``: every leaf whole on every rank).  Each rank then runs
one K1 (``pallas``) or one matrix product (``xla``) per local slice and
the ``(n, n)`` partials of the sharded leaves are all-reduced over
``model``, the replicated leaves' partials added once outside that sum
(the reference's ``_pallas_sharded_dists``); ``fused`` degrades to
``pallas``, as in the reference.  The selection is then the same on
every rank, the coordinate phases run on the local slices, and every
reduction over coordinates (the attacks' ``delta_bar``, norms, the
reputation scores) is all-reduced the same way.  The ``obs-`` telemetry
sketch gathers its few hundred window coordinates of each leaf over
``model`` (``_Shards.sketch``), so every rank records what one device
records.  A replicated leaf must be the same on every rank of the
``model`` axis.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.attacks import _alie_z, _anti_or_ones, _closed_gamma
from repro_torch.core.bulyan import coordinate_phase
from repro_torch.core.pytree import tree_leaves, tree_unflatten
from repro_torch.device import host_index, host_value
from repro_torch.dist.mesh import mesh_axis_sizes
from repro_torch.kernels.pairwise_gram import (finalize_dists,
                                               pairwise_gram_partial,
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

def resolve_distance_backend(distance_backend: str, mesh=None,
                             device=None) -> str:
    """Resolve the user-facing backend knob to a concrete implementation.

    Args:
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"`` (see the module docstring; ``"pallas"`` names the
        port's K1 kernel).
      mesh: the mesh of the sharded pass, or ``None``.
      device: where the gradients live (``"auto"`` reads it).

    Returns:
      ``"xla"``, ``"pallas"`` or ``"fused"``: ``"auto"`` is ``"pallas"``
      only for CUDA tensors under a mesh whose ``model`` axis is larger
      than 1 (without the sharded pass the kernel would need every leaf
      whole), else ``"xla"``; ``"fused"`` is ``"pallas"`` under such a
      mesh (the fused composites run whole leaves).  Raises
      ``ValueError`` for an unknown name.
    """
    model = 1 if mesh is None else mesh_axis_sizes(mesh).get("model", 1)
    if distance_backend == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        return "pallas" if on_card and model > 1 else "xla"
    if distance_backend == "fused":
        return "pallas" if model > 1 else "fused"
    if distance_backend not in ("xla", "pallas"):
        raise ValueError(
            f"distance_backend must be 'xla', 'pallas', 'fused' or "
            f"'auto', got {distance_backend!r}")
    return distance_backend


class _Shards(NamedTuple):
    """Where a tree's local leaves sit on a mesh's ``model`` axis."""

    mesh: Any
    #: per leaf, the dimension of the worker-stacked leaf split over
    #: ``model``, or ``None`` for a leaf whole on every rank
    dims: Tuple[Optional[int], ...]

    def total(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """A reduction over the global coordinate space from per-leaf
        partials: the sharded leaves' partials summed in leaf order and
        all-reduced over ``model``, the replicated leaves' added once
        outside that sum."""
        sharded = torch.zeros_like(parts[0])
        replicated = torch.zeros_like(parts[0])
        for p, d in zip(parts, self.dims):
            if d is None:
                replicated = replicated + p
            else:
                sharded = sharded + p
        if any(d is not None for d in self.dims):
            sharded = self.mesh.all_reduce(sharded, "model")
        return sharded + replicated

    def factor(self, k: int) -> int:
        """How many slices leaf ``k`` is cut into."""
        return 1 if self.dims[k] is None else self.mesh.size("model")

    def global_shape(self, k: int, leaf: torch.Tensor) -> Tuple[int, ...]:
        """Leaf ``k``'s global per-worker shape from its local slice."""
        shape = list(leaf.shape[1:])
        if self.dims[k] is not None:
            shape[self.dims[k] - 1] *= self.factor(k)
        return tuple(shape)

    def sketch(self, leaves, agg_leaves):
        """``TreeContext.sketch``: the telemetry windows of the whole
        leaves from this rank's slices.

        Each rank reads the window coordinates its slice holds (global
        flat indices mapped through the split dimension), one
        ``all_gather`` over ``model`` brings every rank's reads, and each
        coordinate is taken from the rank that holds it: at most
        ``OBS_SKETCH * (n + 1)`` values per rank, and the values one
        device reads, bit for bit.

        Returns:
          ``(numels, windows)``: each whole leaf's per-worker coordinate
          count and its fp32 ``(n + 1, size)`` window (the workers' rows,
          then the aggregate's).
        """
        from repro_torch.obs.forensics import sketch_spans
        numels = [math.prod(self.global_shape(k, l))
                  for k, l in enumerate(leaves)]
        me = self.mesh.index("model")
        windows, reads, owners = [], [], []
        for k, ((start, size), leaf, agg) in enumerate(zip(
                sketch_spans(numels), leaves, agg_leaves)):
            n = leaf.shape[0]
            if self.dims[k] is None:
                windows.append(torch.cat([
                    leaf.reshape(n, -1)[:, start:start + size]
                    .to(torch.float32),
                    agg.reshape(1, -1)[:, start:start + size]
                    .to(torch.float32)]))
                continue
            idx = list(np.unravel_index(np.arange(start, start + size),
                                        self.global_shape(k, leaf)))
            dim, width = self.dims[k] - 1, leaf.shape[self.dims[k]]
            owner = idx[dim] // width
            # a coordinate another rank holds reads index 0 here; the
            # gather below takes it from its owner
            idx[dim] = np.where(owner == me, idx[dim] % width, 0)
            at = tuple(torch.as_tensor(i, device=leaf.device) for i in idx)
            reads.append(torch.cat([
                leaf[(slice(None),) + at].to(torch.float32),
                agg[at].to(torch.float32)[None]]))
            owners.append(owner)
            windows.append(None)
        if reads:
            every = self.mesh.all_gather(torch.cat(reads, dim=1)[None],
                                         "model", 0)
            col = 0
            for k, owner in zip([k for k, w in enumerate(windows)
                                 if w is None], owners):
                size = owner.size
                at = torch.arange(col, col + size, device=every.device)
                # contiguous rows, as one device's windows
                windows[k] = every[torch.as_tensor(owner,
                                                   device=every.device),
                                   :, at].T.contiguous()
                col += size
        return numels, windows


def _shards(mesh, specs, n_leaves: int) -> Optional[_Shards]:
    """The :class:`_Shards` of a tree's leaves under ``mesh`` (``None``
    without a ``model`` axis larger than 1: then every rank holds whole
    leaves and the single-device code runs unchanged)."""
    if mesh is None or mesh_axis_sizes(mesh).get("model", 1) <= 1:
        return None
    if specs is None:
        return _Shards(mesh, (None,) * n_leaves)
    from repro_torch.dist.sharding import _spec_leaves, model_dim
    spec_leaves = _spec_leaves(specs)
    if len(spec_leaves) != n_leaves:
        raise ValueError(f"specs has {len(spec_leaves)} leaves, the tree "
                         f"{n_leaves}")
    dims = tuple(model_dim(spec) for spec in spec_leaves)
    if 0 in dims:
        raise ValueError("the worker axis of a gradient leaf is never "
                         "split over 'model' (gram_pspec)")
    return _Shards(mesh, dims)


def pairwise_sq_dists_tree(tree: Any, compute_dtype=torch.float32, *,
                           distance_backend: str = "xla", mesh=None,
                           specs=None) -> torch.Tensor:
    """Squared euclidean distances over the concatenation of all leaves.

    Args:
      tree: dict (or list) of ``(n, *dims)`` worker-stacked gradients
        (under a mesh, this rank's slices; see the module docstring).
      compute_dtype: accumulation dtype of the ``"xla"`` backend and the
        dtype of the returned matrix (the kernel accumulates fp32).
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"``; ``"fused"`` takes the same K1 pass as ``"pallas"``.
      mesh: the mesh of the sharded pass, or ``None``.
      specs: the leaves' ``gram_pspec`` tree under a mesh (``None``:
        every leaf whole).

    Returns:
      ``(n, n)`` squared distances in ``compute_dtype``, a sum of
      per-leaf partial Grams (the same on every rank of a mesh); no flat
      ``(n, d)`` copy is built.
    """
    n = _worker_count(tree)
    leaves = _leaves(tree)
    backend = resolve_distance_backend(distance_backend, mesh,
                                       leaves[0].device)
    shards = _shards(mesh, specs, len(leaves))
    with named_span("agg/gram"):
        if shards is not None:
            return _sharded_dists(leaves, shards, backend, compute_dtype)
        if backend in ("pallas", "fused"):
            return pairwise_gram_tree(tree).to(compute_dtype)
        dev = leaves[0].device
        gram = torch.zeros((n, n), dtype=compute_dtype, device=dev)
        sq = torch.zeros((n,), dtype=compute_dtype, device=dev)
        for leaf in leaves:
            x = leaf.to(compute_dtype).reshape(n, -1)
            gram = gram + x @ x.T
            sq = sq + torch.sum(x * x, dim=1)
        return finalize_dists(sq[:, None] + sq[None, :] - 2.0 * gram)


def _sharded_dists(leaves, shards: _Shards, backend: str,
                   cdt) -> torch.Tensor:
    """The sharded distance pass: one K1 (``pallas``) or one product
    (``xla``) per local slice, then :meth:`_Shards.total` (the
    reference's ``_pallas_sharded_dists``, and for ``xla`` the layout
    GSPMD gives its per-leaf products)."""
    n = leaves[0].shape[0]
    if backend == "pallas":
        raw = shards.total([pairwise_gram_partial(l) for l in leaves])
        return finalize_dists(raw).to(cdt)
    parts = []
    for leaf in leaves:
        x = leaf.to(cdt).reshape(n, -1)
        parts.append(torch.cat([x @ x.T, torch.sum(x * x, dim=1)[:, None]],
                               dim=1))
    tot = shards.total(parts)
    gram, sq = tot[:, :n], tot[:, n]
    return finalize_dists(sq[:, None] + sq[None, :] - 2.0 * gram)


# ---------------------------------------------------------------------------
# coordinate phase over arbitrary trailing dims
# ---------------------------------------------------------------------------

#: coordinates of one pass of the coordinate phase when no window is
#: given: the sort's int64 indices and the prefix sums of a (theta, d)
#: stack take ~24 theta bytes per coordinate, ~2 GB at theta = 5, where a
#: whole (5, 150,994,944) embedding slice would take ~18 GB
_ONE_PASS = 2 ** 24

def coordinate_phase_nd(selected: torch.Tensor, f: int,
                        window: Optional[int] = None) -> torch.Tensor:
    """Bulyan's coordinate-wise phase over arbitrary trailing dims.

    Args:
      selected: ``(theta, *dims)`` stack of phase-1-selected gradients.
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.
      window: caps the coordinates processed at once (the sort and the
        two cumulative sums need O(theta * window) workspace); ``None``
        (or ``<= 0``) takes ``_ONE_PASS``.  Every coordinate is computed
        on its own, so the window changes the workspace, never a bit of
        the result.

    Returns:
      ``(*dims,)``: per coordinate, the mean of the beta values closest
      to the median (``repro_torch.core.bulyan.coordinate_phase`` on the
      flattened ``(theta, d)`` view, chunk by chunk).
    """
    trailing = selected.shape[1:]
    d = math.prod(trailing)
    flat = selected.reshape(selected.shape[0], d)
    if window is None or window <= 0:
        window = _ONE_PASS
    with named_span("agg/coordinate"):
        if d <= window:
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
                          rep_decay: Optional[float] = None, specs=None):
    """Apply GAR ``gar`` across the leading worker axis of a gradient tree,
    leaf by leaf.

    Contract (the reference's): the result equals the flat rule on
    ``stack_flatten`` of the same tree, up to summation order; under a
    mesh, on the tree the ranks' slices make up.

    Args:
      tree: dict (or list, or one tensor) of ``(n, *dims)``
        worker-stacked gradients, fp32 or bf16 (under a mesh with a
        ``model`` axis, this rank's slices).
      f: Byzantine bound the rule defends against (quorum-checked).
      gar: any rule with a tree implementation: the registered rules,
        ``bulyan-krum``, ``bulyan-geomed``, ``fused-<base>`` and the
        stateful ``buffered-<base>``, ``centered_clip_momentum``,
        ``stale[-inv|-exp]-<base>``, ``reputation-<base>`` and
        ``obs-<base>``.
      agg_dtype: ``"native"`` (fp32) | ``"float32"`` | ``"bfloat16"``.
      window: coordinate-phase window of the bulyan rules (see
        :func:`coordinate_phase_nd`).
      distance_backend: ``"xla"`` | ``"pallas"`` | ``"fused"`` |
        ``"auto"`` (see the module docstring).
      mesh: the mesh of the sharded pass (see the module docstring), or
        ``None``.
      state: carried ``AggState`` of a stateful rule (``None``
        zero-initializes one); stateless rules ignore it.  Under a mesh
        its buffers hold the same slices as the leaves.
      history_window: ``buffered-*`` window (``None``: the registry's
        default).
      rep_lr: ``reputation-*`` EMA rate (``None``: the default).
      rep_decay: ``reputation-*`` forgetting factor (``None``: the
        default).
      specs: under a mesh, the leaves' ``gram_pspec`` tree (``None``:
        every leaf whole on every rank).

    Returns:
      ``(aggregated tree, DistAggResult)`` for a stateless rule and
      ``(aggregated tree, DistAggResult, new_state)`` for a stateful
      one; the aggregate's leaves keep their input dtypes (under a mesh,
      this rank's slices; the ``DistAggResult`` is the same on every
      rank).
    """
    from repro_torch.agg.registry import TreeContext, resolve_rule
    from repro_torch.agg.specs import check_quorum
    from repro_torch.agg.state import init_state

    n = _worker_count(tree)
    params = dict(history_window=history_window, rep_lr=rep_lr,
                  rep_decay=rep_decay)
    rule = resolve_rule(gar, **params)
    check_quorum(gar, n, f, distributed=True, history_window=history_window)
    leaves = _leaves(tree)
    backend = resolve_distance_backend(distance_backend, mesh,
                                       leaves[0].device)
    if backend == "fused":
        from repro_torch.agg.fused import fused_name
        lowered = fused_name(gar)
        if lowered is not None:
            rule = resolve_rule(lowered, **params)
    shards = _shards(mesh, specs, len(leaves))
    cdt = _compute_dtype(agg_dtype)

    def make_dists(ls):
        return pairwise_sq_dists_tree(list(ls), cdt,
                                      distance_backend=backend, mesh=mesh,
                                      specs=specs)

    ctx = TreeContext(
        leaves=tuple(leaves), n=n, f=f, cdt=cdt, make_dists=make_dists,
        coordinate_phase=partial(coordinate_phase_nd, window=window),
        reduce=None if shards is None else shards.total,
        sketch=None if shards is None else shards.sketch)
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

def _tree_delta_bar(honest_leaves, shards: Optional[_Shards] = None
                    ) -> torch.Tensor:
    """Paper §B.1 ``delta_bar`` over the concatenated coordinate space,
    accumulated per leaf: 2/sqrt(pi) times the mean over coordinates of
    the per-coordinate population std (``jnp.std``, ddof 0) across the
    honest workers (under a mesh, over every rank's slices)."""
    if shards is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=honest_leaves[0].device)
        for leaf in honest_leaves:
            x = leaf.to(torch.float32)
            total = total + torch.sum(torch.std(x, dim=0, correction=0))
    else:
        total = shards.total([
            torch.sum(torch.std(leaf.to(torch.float32), dim=0,
                                correction=0)) for leaf in honest_leaves])
    count = _coord_count(honest_leaves, shards)
    c = 2.0 / torch.sqrt(torch.tensor(math.pi, dtype=torch.float32))
    return c.to(total.device) * total / max(count, 1)


def _coord_count(leaves, shards: Optional[_Shards]) -> int:
    """Coordinates per worker over the whole tree (every rank's slices)."""
    return sum(math.prod(l.shape[1:]) * (1 if shards is None
                                         else shards.factor(k))
               for k, l in enumerate(leaves))


def _to_global(k: int, q: int, leaf, shards: _Shards) -> int:
    """Leaf ``k``'s flat index ``q`` in this rank's slice -> its flat
    index in the whole leaf."""
    if shards.dims[k] is None:
        return q
    idx = list(np.unravel_index(q, tuple(leaf.shape[1:])))
    dim = shards.dims[k] - 1
    idx[dim] += shards.mesh.index("model") * leaf.shape[shards.dims[k]]
    return int(np.ravel_multi_index(idx, shards.global_shape(k, leaf)))


def _to_local(k: int, q: int, leaf, shards: _Shards) -> Optional[int]:
    """Leaf ``k``'s flat index ``q`` in the whole leaf -> its flat index
    in this rank's slice, or ``None`` when another rank holds it."""
    if shards.dims[k] is None:
        return q
    idx = list(np.unravel_index(q, shards.global_shape(k, leaf)))
    dim = shards.dims[k] - 1
    width = leaf.shape[shards.dims[k]]
    if idx[dim] // width != shards.mesh.index("model"):
        return None
    idx[dim] %= width
    return int(np.ravel_multi_index(idx, tuple(leaf.shape[1:])))


def _top_coordinate(means, leaves, shards: _Shards):
    """``omniscient_lp``'s ``"top"`` over every rank's slices: per leaf the
    largest |mean| and the first flat index of the whole leaf holding it
    (ranks' candidates gathered over ``model``), then the first leaf with
    the largest.  Returns (global flat coordinate, sign)."""
    rows = []
    for k, (m, l) in enumerate(zip(means, leaves)):
        a = torch.abs(m.reshape(-1))
        arg = host_index(torch.argmax(a))
        rows.append([host_value(a[arg]), _to_global(k, arg, l, shards),
                     host_value(m.reshape(-1)[arg])])
    mine = torch.tensor(rows, dtype=torch.float64)
    every = shards.mesh.all_gather(mine[None], "model", 0)
    best = []
    for k in range(len(leaves)):
        cands = mine[k:k + 1] if shards.dims[k] is None else every[:, k]
        top = cands[cands[:, 0] == torch.max(cands[:, 0])]
        best.append(top[torch.argmin(top[:, 1])])
    j = int(torch.argmax(torch.stack([b[0] for b in best])))
    off = sum(math.prod(shards.global_shape(i, l))
              for i, l in enumerate(leaves[:j]))
    return off + int(best[j][1]), -float(np.sign(float(best[j][2])))


def _lp_direction(means, leaves, coord, step, shards=None):
    """(flat coordinate, sign) of ``omniscient_lp``'s one-hot direction,
    over the concatenated coordinate space in leaf order."""
    d = _coord_count(leaves, shards)
    if coord == "rotate":
        return (0 if step is None else host_index(step)) % d, 1.0
    if coord == "top":
        if shards is not None:
            return _top_coordinate(means, leaves, shards)
        # the coordinate where the honest mean is largest in magnitude,
        # attacked against its sign (first leaf, then first index, wins)
        flat = [m.reshape(-1) for m in means]
        maxes = torch.stack([torch.max(torch.abs(m)) for m in flat])
        j = host_index(torch.argmax(maxes))
        arg = host_index(torch.argmax(torch.abs(flat[j])))
        off = sum(math.prod(l.shape[1:]) for l in leaves[:j])
        return off + arg, -torch.sign(flat[j][arg])
    if isinstance(coord, int) and not 0 <= coord < d:
        raise ValueError(f"coord must be in [0, {d}), 'rotate' or 'top'; "
                         f"got {coord!r}")
    return int(coord), 1.0


def _draws(generator, leaves, shards: Optional[_Shards], lead, dtype=None):
    """The random attacks' normal draws: each leaf's whole shape, with
    ``lead`` in front, drawn from ``generator`` leaf after leaf (in
    ``dtype``, else the leaf's), so a mesh draws what one device draws.

    Returns:
      ``(whole, local)``: the draws, and this rank's ``model`` slices of
      them (the draws themselves on one device and for replicated
      leaves).
    """
    whole, local = [], []
    for k, l in enumerate(leaves):
        shape = (tuple(l.shape[1:]) if shards is None
                 else shards.global_shape(k, l))
        x = torch.randn(tuple(lead) + shape, generator=generator,
                        dtype=l.dtype if dtype is None else dtype,
                        device=l.device)
        whole.append(x)
        if shards is not None and shards.dims[k] is not None:
            width = l.shape[shards.dims[k]]
            x = x.narrow(len(lead) + shards.dims[k] - 1,
                         shards.mesh.index("model") * width, width)
        local.append(x)
    return whole, local


def inject_byzantine(tree: Any, f: int, attack: str, generator=None, *,
                     gar_name: str = "krum", step=None, gamma=None,
                     scale: Optional[float] = None, eps: float = 0.5,
                     z: Optional[float] = None, target: int = 0,
                     coord=0, margin: float = 1.0,
                     direction: str = "ones", prev: Any = None,
                     hold: int = 0, build: int = 5, mesh=None,
                     specs=None) -> Any:
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
      mesh: the mesh of the sharded pass, or ``None``: under a ``model``
        axis larger than 1 the leaves are this rank's slices (``specs``:
        their ``gram_pspec`` tree, ``None`` for whole leaves); every
        reduction over coordinates covers all ranks' slices, ``coord``
        indexes the whole tree, and the random draws are the single
        device's (each leaf's whole shape drawn in leaf order, then this
        rank's slice cut from it).
      specs: the leaves' ``gram_pspec`` tree under a mesh.

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
    t = 0 if step is None else host_index(step)
    shards = _shards(mesh, specs, len(leaves))
    # a meta trace draws without a generator (none lives there)
    if (generator is None and attack in ("random", "colluding_majority")
            and dev.type != "meta"):
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
        byz = [s * x for x in _draws(generator, leaves, shards, (f,))[1]]
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
            db = _tree_delta_bar(honest, shards)
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
        db = _tree_delta_bar(honest, shards)
        ms = means()
        if direction == "anti":
            dirs = [-m for m in ms]
            sq = (sum(torch.sum(e * e) for e in dirs) if shards is None
                  else shards.total([torch.sum(e * e) for e in dirs]))
        else:
            # every rank holds the whole draw: its norm is one device's
            whole, dirs = _draws(generator, leaves, shards, (),
                                 torch.float32)
            sq = sum(torch.sum(e * e) for e in whole)
        norm = torch.sqrt(sq) + 1e-12
        byz = [broadcast(m + eps * db * e / norm, l)
               for m, e, l in zip(ms, dirs, leaves)]
    elif attack in ("omniscient_linf", "omniscient_lp"):
        db = _tree_delta_bar(honest, shards)
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
            d = _coord_count(leaves, shards)
            g = (_closed_gamma(gar_name, d, f, db) * margin if estimated
                 else fixed)
            c, sign = _lp_direction(ms, leaves, coord, step, shards)
            byz, off = [], 0
            for k, (m, l) in enumerate(zip(ms, leaves)):
                e = torch.zeros_like(m).reshape(-1)
                size = e.numel() * (1 if shards is None
                                    else shards.factor(k))
                if off <= c < off + size:
                    q = (c - off if shards is None
                         else _to_local(k, c - off, l, shards))
                    if q is not None:
                        e[q] = sign
                byz.append(broadcast(m + g * e.reshape(m.shape), l))
                off += size
    else:
        raise KeyError(f"unknown distributed attack {attack!r}")

    out = [torch.cat([l[:n_h], b], dim=0) for l, b in zip(leaves, byz)]
    return tree_unflatten(tree, out)

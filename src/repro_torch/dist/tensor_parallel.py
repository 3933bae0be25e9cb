"""Tensor parallelism over a mesh's ``model`` axis: the train step's
per-worker forward and backward, and the serving steps' prefill, decode
and verify, on each rank's ``param_shardings`` /
``ensemble_param_shardings`` slices (the reference leaves this to GSPMD,
which partitions each worker's or replica's parameters over ``model``
inside one program).

Four collectives, each a ``torch.autograd.Function`` around
:class:`repro_torch.dist.mesh.Mesh`'s (so ``Mesh.comm`` counts every
call, and ``repro_torch.launch.dryrun.RecordingMesh`` records it on
``meta``), in conjugate pairs:

  ======  ======================  ======================
  name    forward                 backward
  ======  ======================  ======================
  reduce  all-reduce (sum)        identity
  copy    identity                all-reduce (sum)
  gather  all-gather along a dim  this rank's slice
  split   this rank's slice       all-gather along a dim
  ======  ======================  ======================

``Mesh`` stages a collective's buffer detached from the graph, so the
gradient comes from these Functions' backward, never from the
collective.  ``torch.distributed.tensor`` (DTensor) is not used: its
collectives would bypass ``Mesh``'s counters, its host staging and the
dry-run's recording mesh.

The invariant the models keep under a :class:`Shard`: every activation
between these ops is the same on every ``model`` rank, and so is its
gradient.  A weight then enters in one of three ways
(:meth:`Shard.matmul`):

  * split on its contraction dim: this rank's columns of ``x`` times the
    local rows, all-reduced (``split`` then ``reduce``);
  * split on its output dim: the local output columns (``copy`` then the
    product), all-gathered over features unless the caller contracts
    them next (the FFN: one all-reduce forward, one backward);
  * split on a leading batch dim (an expert axis): this rank's entries
    of ``x`` through its entries of the weight, all-gathered.

A leaf that enters otherwise (norm scales, the router, the SSM's conv
and decay leaves) is gathered on use, one leaf at a time
(:meth:`Shard.get`); its gradient keeps this rank's slice.  The
gradients of the leaves whole on every rank are then equal on every
rank, and those of the split leaves are this rank's slices of the
whole leaf's gradient.

The serving steps run a rank's replicas through ``torch.func.vmap`` over
the leading replica axis.  ``vmap`` cannot pass a collective, so each
Function above has a ``vmap`` rule that runs its collective once on the
whole ``(n_local, ...)`` stack: a decode step makes as many collectives
with 8 replicas per rank as with 1, only larger ones.  A decode step
must not gather parameters on every token either, so the serving
layout (:func:`serving_specs`) keeps the leaves a layer reads whole
(:data:`READ_WHOLE`) whole on every rank, cut so from the whole tree
before the first step.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["READ_WHOLE", "Shard", "model_shard", "read_whole",
           "serving_specs", "vocab_parallel_nll"]

_AXIS = "model"


class _Reduce(torch.autograd.Function):
    """Sum over ``model`` forward, identity backward."""

    @staticmethod
    def forward(x, mesh):
        return mesh.all_reduce(x, _AXIS)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return mesh.all_reduce(x, _AXIS), in_dims[0]


class _Copy(torch.autograd.Function):
    """Identity forward, sum over ``model`` backward."""

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, _AXIS), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return x.view_as(x), in_dims[0]


def _narrow(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a view)."""
    w = x.shape[dim] // mesh.size(_AXIS)
    return x.narrow(dim, mesh.index(_AXIS) * w, w)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(x, dim, mesh):
        return mesh.all_gather(x, _AXIS, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.dim, ctx.mesh), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh):
        if in_dims[0] is None:
            return mesh.all_gather(x, _AXIS, dim), None
        return mesh.all_gather(x.movedim(in_dims[0], 0), _AXIS, dim + 1), 0


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(x, dim, mesh):
        return _narrow(x, dim, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, _AXIS, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh):
        if in_dims[0] is None:
            return _narrow(x, dim, mesh), None
        return _narrow(x.movedim(in_dims[0], 0), dim + 1, mesh), 0


class Shard:
    """Where one rank's parameter slices split over ``model``, for the
    sub-tree of the parameters a layer receives, and the mesh.

    Indexing by a key gives the sub-tree's :class:`Shard` (``shard["attn"]``
    for ``params["attn"]``); :meth:`dim` reads a leaf's split dim.  With
    one ``model`` rank every dim is ``None`` and every op below is the
    plain one.

    Args:
      mesh: this rank's mesh (a ``Mesh`` or a ``RecordingMesh``).
      dims: a tree in the parameters' structure whose leaves are the
        dim each leaf's local slice splits over ``model`` (``None``:
        whole on every rank).
      gathers: whether a leaf may be gathered on use (:meth:`get`,
        :meth:`entry`, :meth:`relayout`); the serving layout's shards
        say no, so a step that would gather a parameter on every call
        raises instead.
    """

    def __init__(self, mesh, dims: Any, gathers: bool = True):
        self.mesh = mesh
        self.dims = dims
        self.gathers = gathers
        self.size = mesh.size(_AXIS)
        self.index = mesh.index(_AXIS)

    def __getitem__(self, key) -> "Shard":
        return Shard(self.mesh, self.dims[key], self.gathers)

    def _gathering(self, what) -> None:
        if not self.gathers:
            raise ValueError(
                f"parameter leaf {what!r} is split over model in the "
                f"serving layout, so each step would gather it: "
                f"tensor_parallel.READ_WHOLE must name it")

    def dim(self, key) -> Optional[int]:
        """The split dim of leaf ``key`` of this sub-tree, or ``None``."""
        return self.dims[key]

    def entry(self, tree, i: int):
        """Entry ``i`` of a tree stacked on a leading axis and its
        :class:`Shard`: a leaf split on the stacked axis itself is
        gathered on use first."""
        from repro_torch.core.pytree import tree_leaves, tree_unflatten
        leaves, dims = [], []
        for x, d in zip(tree_leaves(tree), tree_leaves(self.dims)):
            if d == 0:
                self._gathering(tuple(x.shape))
                x, d = self.gather(x, 0), None
            leaves.append(x[i])
            dims.append(None if d is None else d - 1)
        return (tree_unflatten(tree, leaves),
                Shard(self.mesh, tree_unflatten(self.dims, dims),
                      self.gathers))

    # -- the collectives (identity with one rank) ---------------------------

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' ``x`` (partial sums become the total)."""
        return x if self.size == 1 else _Reduce.apply(x, self.mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering work split over the ranks: its gradient is the
        sum of theirs."""
        return x if self.size == 1 else _Copy.apply(x, self.mesh)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices concatenated along ``dim``."""
        if self.size == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.mesh)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim``."""
        if self.size == 1:
            return x
        return _Split.apply(x, dim % x.dim(), self.mesh)

    def divides(self, n: int) -> bool:
        """Whether ``model`` splits ``n`` evenly (always with one rank)."""
        return n % self.size == 0

    # -- leaves ---------------------------------------------------------------

    def get(self, p: dict, key) -> torch.Tensor:
        """Leaf ``key`` of ``p`` whole, gathered on use when split."""
        d = self.dims[key]
        if d is None:
            return p[key]
        self._gathering(key)
        return self.gather(p[key], d)

    def relayout(self, w: torch.Tensor, src: Optional[int],
                 dst: Optional[int]) -> torch.Tensor:
        """A leaf stored split on ``src`` as this rank's slice split on
        ``dst`` (its gradient comes back in the ``src`` layout)."""
        if src == dst:
            return w
        if src is not None:
            self._gathering(tuple(w.shape))
            w = self.gather(w, src)
        return w if dst is None else self.split(w, dst)

    def matmul(self, x: torch.Tensor, p: dict, key) -> torch.Tensor:
        """``x @ p[key]`` whole on every rank, the leaf this rank's slice
        (see the module docstring)."""
        w, d = p[key], self.dims[key]
        nd = w.dim()
        if d is None:
            return x @ w
        if d == nd - 2:
            return self.reduce(self.split(x, -1) @ w)
        if d == nd - 1:
            return self.gather(self.copy(x) @ w, -1)
        xd = x.dim() - nd + d
        return self.gather(self.split(x, xd) @ w, xd)


def model_shard(mesh, specs: Any, lead: int = 0,
                gathers: bool = True) -> Shard:
    """The :class:`Shard` of a parameter tree laid out by ``specs`` (the
    ``param_shardings`` tree of :class:`repro_torch.dist.sharding.P`).

    Args:
      mesh: this rank's mesh.
      specs: the parameters' specs, in the parameters' structure.
      lead: stacked axes in front of each leaf that the layers do not
        see (1 for a replica-stacked ensemble run under ``vmap``).
      gathers: whether the layers may gather a leaf on use (``False``
        for the serving layout, :func:`serving_specs`).

    Returns:
      A :class:`Shard` whose dims are each spec's ``model`` dim, less
      ``lead``.
    """
    from repro_torch.dist.sharding import model_dim

    def dim(s):
        d = model_dim(s)
        return None if d is None else d - lead

    return Shard(mesh, _map_specs(lambda path, s: dim(s), specs), gathers)


def _map_specs(fn, specs: Any, path=()) -> Any:
    """``fn(path, spec)`` over a tree of :class:`~repro_torch.dist.sharding.P`
    (a ``P`` is a tuple, so it is a leaf here)."""
    from repro_torch.dist.sharding import P
    if isinstance(specs, P):
        return fn(path, specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, path + (str(k),))
                for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, path + (str(i),))
                       for i, v in enumerate(specs))


#: the leaves a layer reads whole under a :class:`Shard` (``Shard.get``):
#: norm scales, biases, the MoE router, the SSM's conv and decay leaves
READ_WHOLE = frozenset({"scale", "b", "bq", "bk", "bv", "router", "conv_w",
                        "conv_b", "A_log", "D", "dt_bias"})


def read_whole(path, dim: Optional[int]) -> bool:
    """Whether the layers read the leaf at ``path``, split on its
    unstacked ``dim``, whole: its name is in :data:`READ_WHOLE`, or it is
    an encoder layer's leaf split on the layer axis (``Shard.entry``
    gathers it)."""
    if dim is None:
        return False
    return path[-1] in READ_WHOLE or ("encoder" in path and dim == 0)


def serving_specs(specs: Any, lead: int = 0) -> Any:
    """The serving layout of parameters laid out by ``specs``
    (``param_shardings``, or ``ensemble_param_shardings`` with ``lead =
    1``): the same specs with every leaf the layers read whole
    (:func:`read_whole`) replicated over ``model``.

    Args:
      specs: a tree of ``P``.
      lead: stacked axes in front of each leaf (the replica axis).

    Returns:
      A tree of ``P``.
    """
    from repro_torch.dist.sharding import P, model_dim

    def fix(path, s):
        d = model_dim(s)
        if d is None or not read_whole(path, d - lead):
            return s
        return P(*(None if i == d else e for i, e in enumerate(s)))

    return _map_specs(fix, specs)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       shard: Shard) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` of logits whose
    last dim is this rank's vocabulary columns (``[index * V, (index +
    1) * V)``), never gathered.

    Each rank takes the max and the sum of ``exp`` over its columns and
    the label's logit where it owns the label (0 elsewhere); one
    all-gather over ``model`` brings every rank's three, which combine
    into the whole ``logsumexp`` and the label's logit.

    Args:
      logits: ``(..., V)`` fp32, this rank's columns.
      labels: ``(...)`` integer labels over the whole vocabulary.
      shard: the step's :class:`Shard`.

    Returns:
      ``(...)`` fp32, the same on every ``model`` rank.
    """
    v = logits.shape[-1]
    local = labels.long() - shard.index * v
    mine = (local >= 0) & (local < v)
    # the max only steadies the exponent: no gradient flows through it
    top = torch.amax(logits.detach(), dim=-1)
    sumexp = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(local, 0, v - 1)[..., None])
    ll = torch.where(mine, ll[..., 0], torch.zeros_like(sumexp))
    parts = shard.gather(torch.stack([top, sumexp, ll])[None], 0)
    tops, sums, lls = parts.unbind(1)
    big = torch.amax(tops, dim=0)
    lse = big + torch.log(torch.sum(sums * torch.exp(tops - big), dim=0))
    return lse - torch.sum(lls, dim=0)

"""Sharding rules: trees -> partition specs, and the moves between a
rank's local shard and the whole leaf (counterpart of
``repro/dist/sharding.py``).

The rules are the reference's, leaf by leaf: structural (shape and tree
path), a dimension sharded only when it divides evenly by the mesh axis,
anything else replicated, and the stacked ``periods`` axis of scanned
layers never sharded.  Where the reference returns ``NamedSharding``s,
the port returns its own :class:`P` per leaf: the layout is all an
explicit-SPMD rank needs, since it holds its own slice.

:func:`local_shard` cuts a rank's slice out of a whole leaf, and
:func:`gather_shard` rebuilds the whole leaf from every rank's slice
(the collectives of :class:`repro_torch.dist.mesh.Mesh`);
:func:`shard_tree` / :func:`gather_tree` map them over trees.

``LEGACY_RULES`` is the reference's pre-iteration baseline (shard the
last dim only), read at call time.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_unflatten
from repro_torch.dist.mesh import mesh_axis_sizes

__all__ = ["LEGACY_RULES", "P", "batch_pspec", "cache_shardings",
           "ensemble_cache_shardings", "ensemble_param_shardings",
           "gather_replicas", "gather_shard", "gather_tree", "gram_pspec",
           "gram_shardings", "local_ensemble", "local_replicas",
           "local_shard", "local_shape",
           "logits_pspec", "model_dim", "param_shardings",
           "per_worker_specs", "replica_rows", "shard_tree",
           "tree_map_with_path"]

#: pre-iteration parameter rules (the reference's A/B baseline)
LEGACY_RULES = False


class P(tuple):
    """A partition spec: one entry per leading dimension, an axis name,
    a tuple of axis names or ``None`` (replicated); trailing ``None``s
    may be left out.  ``P()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _items(tree, path=()):
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; a path is the
    tuple of dict keys and sequence indices, as strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, t in enumerate(tree):
            yield from _items(t, path + (str(i),))
    else:
        yield path, tree


def tree_map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` leaf by leaf, in ``tree``'s structure.

    Args:
      fn: ``fn(path, leaf) -> new leaf``; ``path`` is the tuple of keys
        (and sequence indices) from the root, as strings.
      tree: a tensor or a dict / list / tuple of trees.

    Returns:
      ``tree``'s structure with ``fn``'s results.
    """
    return tree_unflatten(tree, [fn(p, x) for p, x in _items(tree)])


def _leaf_pspec(path, shape: Sequence[int], model: int) -> P:
    """Parameter rule: shard one dimension over ``model``.

    The largest evenly divisible dimension wins (ties: the later one, so
    square projections shard their output side).  Scalars, vectors and
    anything indivisible stay replicated; the leading stacked ``periods``
    axis is never sharded.
    """
    if model <= 1 or len(shape) < 2:
        return P()
    if LEGACY_RULES:
        if shape[-1] % model == 0 and shape[-1] >= model:
            return P(*([None] * (len(shape) - 1) + ["model"]))
        return P()
    in_periods = "periods" in tuple(path)
    order = sorted(range(len(shape)), key=lambda i: (-shape[i], -i))
    for i in order:
        if in_periods and i == 0:
            continue
        if shape[i] >= model and shape[i] % model == 0:
            spec = [None] * len(shape)
            spec[i] = "model"
            return P(*spec)
    return P()


def param_shardings(tree: Any, mesh) -> Any:
    """Partition specs of parameters and optimizer state.

    Parameters are replicated across ``data`` (each Byzantine worker
    holds a full replica) and sharded across ``model``; optimizer state
    mirrors its parameter's layout, scalar state replicates.

    Args:
      tree: parameter (or optimizer-state) tree; only ``.shape`` is read.
      mesh: the mesh (or anything ``mesh_axis_sizes`` reads).

    Returns:
      A tree of :class:`P` with ``tree``'s structure.
    """
    model = mesh_axis_sizes(mesh).get("model", 1)
    return tree_map_with_path(
        lambda path, leaf: _leaf_pspec(path, tuple(leaf.shape), model),
        tree)


def _first_fit(dim: int, sizes, options) -> Any:
    """First axis combination (in preference order) that evenly divides
    ``dim``."""
    for axes in options:
        if not all(a in sizes for a in axes):
            continue
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if prod > 1 and dim % prod == 0:
            return axes[0] if len(axes) == 1 else tuple(axes)
    return None


def batch_pspec(shape: Sequence[int], mesh, worker_axis: bool = True) -> P:
    """Partition spec of a model input.

    Args:
      shape: the input's global shape.
      mesh: the mesh.
      worker_axis: ``True`` for training inputs ``(n_workers,
        per_worker, ...)``: the worker axis on ``data``, the per-worker
        batch on ``pod`` when present.  ``False`` for serving inputs
        ``(batch, ...)``: the batch over every data-parallel axis that
        divides it.

    Returns:
      The :class:`P`, trailing ``None``s pruned.
    """
    sizes = mesh_axis_sizes(mesh)
    if not shape:
        return P()
    spec = [None] * len(shape)
    if worker_axis:
        spec[0] = _first_fit(shape[0], sizes, [("data",)])
        if len(shape) > 1:
            spec[1] = _first_fit(shape[1], sizes, [("pod",)])
    else:
        spec[0] = _first_fit(shape[0], sizes,
                             [("pod", "data"), ("data",), ("pod",)])
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def gram_pspec(shape: Sequence[int], mesh, path=()) -> P:
    """Partition spec of a worker-stacked gradient leaf on the sharded
    distance pass (and of everything laid out like one: the attack, the
    coordinate phase, the aggregate, stateful buffers).

    Args:
      shape: the leaf's global shape ``(n_workers, *param_dims)``.
      mesh: the mesh (only ``model`` matters).
      path: the leaf's tree path (keys as strings); recognizes the
        ``periods`` leaves.

    Returns:
      :class:`P` with the worker axis replicated (each shard's partial
      Gram needs all n rows of its slice) and the largest evenly
      divisible trailing dim on ``model``, never the ``periods`` axis
      (index 1 here); an indivisible leaf is fully replicated.
    """
    model = mesh_axis_sizes(mesh).get("model", 1)
    spec = [None] * len(shape)
    if model > 1 and len(shape) >= 2:
        in_periods = "periods" in tuple(path)
        order = sorted(range(1, len(shape)), key=lambda i: (-shape[i], -i))
        for i in order:
            if in_periods and i == 1:
                continue
            if shape[i] >= model and shape[i] % model == 0:
                spec[i] = "model"
                break
    return P(*spec)


def gram_shardings(tree: Any, mesh) -> Any:
    """:func:`gram_pspec` of each leaf's worker-stacked gradient.

    Args:
      tree: the parameter tree (``.shape`` of each leaf is read; the
        worker count does not change the rule).
      mesh: the mesh.

    Returns:
      A tree of :class:`P` for ``(n_workers, *leaf.shape)`` stacks.
    """
    return tree_map_with_path(
        lambda path, leaf: gram_pspec((1,) + tuple(leaf.shape), mesh, path),
        tree)


def ensemble_param_shardings(tree: Any, mesh) -> Any:
    """Partition specs of replica-stacked ensemble parameters: the
    leading replica axis on ``data`` (when it divides), the inner dims by
    the :func:`param_shardings` rule over ``model``.

    Args:
      tree: ``(n_replicas, *dims)``-stacked parameter tree (``.shape``).
      mesh: the mesh.

    Returns:
      A tree of :class:`P`.
    """
    sizes = mesh_axis_sizes(mesh)
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        inner = _leaf_pspec(path, shape[1:], model)
        entries = list(inner) + [None] * (len(shape) - 1 - len(inner))
        lead = ("data" if data > 1 and shape[0] % data == 0
                and shape[0] >= data else None)
        return P(lead, *entries)

    return tree_map_with_path(spec_for, tree)


def ensemble_cache_shardings(cache: Any, mesh) -> Any:
    """Partition specs of replica-stacked decode caches: the leading
    replica axis on ``data`` where it divides, the rest replicated.

    Args:
      cache: replica-stacked decode-cache tree (``.shape``).
      mesh: the mesh.

    Returns:
      A tree of :class:`P`.
    """
    data = mesh_axis_sizes(mesh).get("data", 1)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if (len(shape) >= 1 and data > 1 and shape[0] % data == 0
                and shape[0] >= data):
            return P("data")
        return P()

    return tree_map_with_path(spec_for, cache)


def replica_rows(n: int, mesh) -> Tuple[slice, bool]:
    """This rank's replicas of an ensemble of ``n`` and whether ``data``
    splits them: the leading entry of :func:`ensemble_param_shardings`
    (``data`` when it divides ``n``, else every replica on every rank).

    Args:
      n: the ensemble's size.
      mesh: this rank's mesh.

    Returns:
      ``(rows, split)``: the slice of the replica axis this rank holds.
    """
    data = mesh_axis_sizes(mesh).get("data", 1)
    if data > 1 and n % data == 0 and n >= data:
        per = n // data
        i = mesh.index("data")
        return slice(i * per, (i + 1) * per), True
    return slice(0, n), False


def local_replicas(tree: Any, mesh, n: Optional[int] = None) -> Any:
    """This rank's replicas of a replica-stacked tree (views).

    Args:
      tree: a tree of ``(n, ...)`` leaves (parameters or caches).
      mesh: this rank's mesh.
      n: the ensemble's size (``None``: the leaves' leading axis).

    Returns:
      The tree with each leaf's leading axis cut to :func:`replica_rows`.
    """
    leaves = tree_leaves(tree)
    rows, _ = replica_rows(leaves[0].shape[0] if n is None else n, mesh)
    return tree_unflatten(tree, [x[rows] for x in leaves])


def local_ensemble(tree: Any, mesh, specs: Any = None) -> Any:
    """This rank's share of a replica-stacked tree (views): its replicas
    (:func:`replica_rows` cuts the leading axis), each cut to its
    ``model`` slices (:func:`local_shard` of the inner dims).

    Args:
      tree: a tree of whole ``(n, ...)`` leaves.
      mesh: this rank's mesh.
      specs: the tree's layout (``None``: :func:`ensemble_param_shardings`
        of ``tree``); its leading entries are :func:`replica_rows`'.

    Returns:
      The tree of this rank's slices.
    """
    if specs is None:
        specs = ensemble_param_shardings(tree, mesh)
    leaves = tree_leaves(tree)
    rows, _ = replica_rows(leaves[0].shape[0], mesh)
    return tree_unflatten(tree, [
        local_shard(x[rows], P(None, *s[1:]), mesh)
        for x, s in zip(leaves, _spec_leaves(specs))])


def gather_replicas(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """Every replica's rows of ``x`` from this rank's (the inverse of
    :func:`local_replicas` on one tensor), in replica order.

    Args:
      x: ``(n_local, ...)``, this rank's replicas' rows.
      n: the ensemble's size.
      mesh: this rank's mesh.

    Returns:
      ``(n, ...)``, the same on every rank of ``data`` (``x`` itself
      when ``data`` does not split the ensemble).
    """
    _, split = replica_rows(n, mesh)
    return mesh.all_gather(x, "data", 0) if split else x


def logits_pspec(shape: Sequence[int], mesh) -> P:
    """Partition spec of a replica-stacked ``(n, ..., vocab)`` logits
    stack on the sharded aggregation: :func:`gram_pspec`'s, which puts
    the vocabulary on ``model`` whenever it divides (it is the largest
    trailing dim), else the stack whole on every rank.  The slot axis is
    never split: serving state is reset per slot on every rank.

    Args:
      shape: the stack's global shape.
      mesh: the mesh.

    Returns:
      :class:`P`: ``model`` on the last dim, or replicated.
    """
    spec = gram_pspec(shape, mesh)
    if model_dim(spec) != len(shape) - 1:
        return P()
    return spec


def cache_shardings(cache: Any, mesh) -> Any:
    """Partition specs of decode caches: the batch axis (axis 1 of the
    ``periods`` leaves, axis 0 of the ``tail`` ones) over the
    data-parallel axes, the rest replicated.

    Args:
      cache: decode-cache tree (``repro_torch.models.decode.init_cache``).
      mesh: the mesh.

    Returns:
      A tree of :class:`P`.
    """
    sizes = mesh_axis_sizes(mesh)

    def spec_for(path, leaf):
        batch_dim = 1 if "periods" in tuple(path) else 0
        shape = tuple(leaf.shape)
        if len(shape) <= batch_dim:
            return P()
        spec = [None] * len(shape)
        spec[batch_dim] = _first_fit(shape[batch_dim], sizes,
                                     [("pod", "data"), ("data",), ("pod",)])
        while spec and spec[-1] is None:
            spec.pop()
        return P(*spec)

    return tree_map_with_path(spec_for, cache)


# ---------------------------------------------------------------------------
# a rank's shard of a leaf
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def model_dim(spec: P) -> Optional[int]:
    """The dimension a spec splits over ``model``, or ``None``."""
    for d, entry in enumerate(spec):
        if "model" in _axes(entry):
            return d
    return None


def local_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of global ``shape``."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= math.prod(sizes.get(a, 1) for a in _axes(entry))
    return tuple(out)


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf.

    Args:
      x: the whole leaf (the same on every rank).
      spec: its :class:`P`; an entry naming several axes splits the dim
        over them in row-major order.
      mesh: this rank's :class:`repro_torch.dist.mesh.Mesh`.

    Returns:
      A view of ``x`` narrowed along each sharded dim.
    """
    sizes = mesh_axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes.get(a, 1)
            idx = idx * sizes.get(a, 1) + mesh.index(a)
        step = x.shape[d] // parts
        x = x.narrow(d, idx * step, step)
    return x


def gather_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice (inverse of
    :func:`local_shard`), the same on every rank.

    Args:
      x: this rank's slice.
      spec: the leaf's :class:`P`.
      mesh: this rank's mesh.

    Returns:
      The whole leaf (``x`` itself for a replicated spec).
    """
    for d, entry in enumerate(spec):
        # the innermost axis varies fastest in the row-major split
        for a in reversed(_axes(entry)):
            x = mesh.all_gather(x, a, dim=d)
    return x


def per_worker_specs(specs: Any) -> Any:
    """Worker-stacked specs (``gram_pspec``) without their worker entry:
    the layout of an aggregate, a mean over workers, one worker's row."""
    return _map_specs(lambda s: P(*s[1:]), specs)


def _map_specs(fn, specs: Any) -> Any:
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v) for v in specs)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`local_shard` leaf by leaf (``specs``: a tree of :class:`P`
    in ``tree``'s structure)."""
    return tree_unflatten(tree, [
        local_shard(x, s, mesh)
        for x, s in zip(tree_leaves(tree), _spec_leaves(specs))])


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`gather_shard` leaf by leaf."""
    return tree_unflatten(tree, [
        gather_shard(x, s, mesh)
        for x, s in zip(tree_leaves(tree), _spec_leaves(specs))])


def _spec_leaves(specs: Any) -> List[P]:
    """The :class:`P` leaves of a spec tree (a ``P`` is a tuple, so the
    generic flattening would descend into it)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for t in specs for s in _spec_leaves(t)]

"""Parameter-dict <-> flat-matrix adapters (counterpart of
``repro/core/pytree.py``).

The reference flattens pytrees in JAX's tree order, which sorts dict
keys.  The port holds parameters as dicts of tensors and flattens them in
the same sorted-key order, so coordinate ``i`` of a flat vector names the
same parameter entry in both packages.  :func:`aggregate_pytree` applies
a registered rule to a worker-stacked dict.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["aggregate_pytree", "stack_flatten", "sum_in_order",
           "tree_leaves", "tree_map", "tree_unflatten", "unflatten"]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a (nested) parameter dict in JAX's tree order.

    Args:
      tree: a tensor, or a dict / list / tuple of trees (the model zoo's
        parameters nest dicts, e.g. ``{"periods": {"s0": {...}}}``).

    Returns:
      The leaf tensors, depth first: keys sorted at every dict level,
      sequences in order.  Everything that is not a dict, list or tuple
      is a leaf.
    """
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """New leaves in the structure of ``tree`` (inverse of
    :func:`tree_leaves`).

    Args:
      tree: the tree the leaves came from (its structure is read, its
        leaves ignored).
      leaves: replacement leaves in :func:`tree_leaves` order.

    Returns:
      A tree of the same structure: dicts keep ``tree``'s key order,
      lists / tuples their type.
    """
    return _rebuild(tree, iter(leaves))


def _rebuild(t: Any, it) -> Any:
    """:func:`tree_unflatten`'s walk, a module function: a recursive
    closure would hold itself, and with it the iterator over
    ``leaves``, in a reference cycle, keeping every leaf alive until
    Python's cycle collector runs."""
    if isinstance(t, dict):
        by_key = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: by_key[k] for k in t}
    if isinstance(t, (list, tuple)):
        items = [_rebuild(x, it) for x in t]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of one structure.

    Args:
      fn: ``fn(leaf, *other_leaves) -> new leaf``.
      tree: the tree whose structure the result takes.
      *rest: trees of the same structure.

    Returns:
      ``tree``'s structure with ``fn`` of the corresponding leaves.
    """
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *others)])


def sum_in_order(parts: List[torch.Tensor]) -> torch.Tensor:
    """Per-leaf partial reductions added in leaf order, from zeros: one
    device's total over a tree's coordinates."""
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def stack_flatten(stacked_tree: Any) -> Tuple[torch.Tensor, Any]:
    """Dict of ``(n, *shape)`` leaves -> ``((n, d)`` float32 matrix, ctx).

    Args:
      stacked_tree: dict whose leaves share a leading worker axis.

    Returns:
      ``(flat, ctx)``: the ``(n, d)`` float32 concatenation in sorted-key
      order, and the context :func:`unflatten` needs.
    """
    keys = sorted(stacked_tree)
    leaves = [stacked_tree[k] for k in keys]
    n = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(n, -1).to(torch.float32)
                      for leaf in leaves], dim=1)
    shapes = [(tuple(leaf.shape[1:]), leaf.dtype) for leaf in leaves]
    return flat, (keys, shapes)


def unflatten(vec: torch.Tensor, ctx: Any) -> Any:
    """``(d,)`` vector -> dict of per-parameter leaves.

    Args:
      vec: flat vector in :func:`stack_flatten`'s coordinate order.
      ctx: the context :func:`stack_flatten` returned.

    Returns:
      A dict with the original keys, shapes and dtypes.
    """
    keys, shapes = ctx
    out, off = {}, 0
    for k, (shape, dtype) in zip(keys, shapes):
        size = math.prod(shape)
        out[k] = vec[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


def aggregate_pytree(stacked_tree: Any, gar_name: str, f: int):
    """Apply a stateless rule across the leading worker axis of a
    worker-stacked parameter dict.

    Args:
      stacked_tree: dict of ``(n, *shape)`` leaves.
      gar_name: any stateless rule name ``resolve_rule`` accepts.
      f: Byzantine bound.

    Returns:
      ``(aggregated dict, AggResult)``.
    """
    from repro_torch.core import gars
    flat, ctx = stack_flatten(stacked_tree)
    res = gars.get_gar(gar_name)(flat, f)
    return unflatten(res.gradient, ctx), res

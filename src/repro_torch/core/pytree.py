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
from typing import Any, List, Tuple

import torch

__all__ = ["aggregate_pytree", "stack_flatten", "tree_leaves",
           "tree_unflatten", "unflatten"]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a parameter dict in sorted-key order (JAX's tree order).

    Args:
      tree: a tensor, a dict of tensors or a list / tuple of tensors.

    Returns:
      The leaf tensors: keys sorted for a dict, in order for a sequence.
    """
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """New leaves in the structure of ``tree`` (inverse of
    :func:`tree_leaves`).

    Args:
      tree: the tensor, dict or list / tuple the leaves came from.
      leaves: replacement leaves in :func:`tree_leaves` order.

    Returns:
      A tree of the same kind: a dict with ``tree``'s keys, a list /
      tuple, or the single leaf.
    """
    if isinstance(tree, dict):
        by_key = dict(zip(sorted(tree), leaves))
        return {k: by_key[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(leaves)
    return leaves[0]


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

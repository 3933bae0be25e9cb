"""Pytree checkpointing: npz leaves plus a json manifest (counterpart of
``repro/checkpoint/store.py``, the same on-disk format).

Layout of ``<path>/``:
  manifest.json  key paths, shapes, dtypes, step, metadata
  arrays.npz     leaves keyed ``"{index:05d}:{key path}"``

Leaves are in JAX's tree order (dict keys sorted, depth first) with the
reference's key paths (``"periods/s0/attn/wq"``), and bfloat16 leaves are
stored as their ``uint16`` bits, so a checkpoint written by either
package loads in the other.  Loading restores host (CPU) tensors; the
caller moves them to its device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import tree_unflatten

__all__ = ["load_checkpoint", "save_checkpoint"]


def _flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs in :func:`tree_leaves` order, with the
    reference's path strings (dict keys, sequence indices,
    ``.field`` for a named tuple)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_path(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        names = ([f".{f}" for f in tree._fields] if hasattr(tree, "_fields")
                 else [str(i) for i in range(len(tree))])
        return [kv for name, t in zip(names, tree)
                for kv in _flatten_with_path(t, prefix + (name,))]
    return [("/".join(prefix), tree)]


def _treedef_str(tree: Any) -> str:
    """A description of the tree's structure in the form the reference
    writes (``PyTreeDef({'embed': {'table': *}, ...})``); informational,
    the load checks the key paths."""
    def s(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {s(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(s(x) for x in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(s(x) for x in t) + ")"
        return "*"
    return f"PyTreeDef({s(tree)})"


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (tensors, numpy arrays or Python numbers) to
    ``path``.

    Args:
      path: directory, created if missing.
      tree: the (nested) tree to save.
      step: the training step recorded in the manifest.
      metadata: any JSON-serializable dict.
    """
    os.makedirs(path, exist_ok=True)
    arrays, keys = {}, []
    for i, (kpath, leaf) in enumerate(_flatten_with_path(tree)):
        key = f"{i:05d}:{kpath}"
        arr, dtype = _to_numpy(leaf)
        arrays[key] = arr
        keys.append({"key": key, "dtype": dtype, "shape": list(arr.shape)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {"step": step, "treedef": _treedef_str(tree),
                "leaves": keys, "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)


def load_checkpoint(path: str, example_tree: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``example_tree`` (shapes must match).

    Args:
      path: a directory written by either package's ``save_checkpoint``.
      example_tree: a tree of the expected structure and shapes (its
        values are ignored).

    Returns:
      ``(tree of CPU tensors, step)``.  Raises ``ValueError`` with the
      reference's texts on a leaf count, key path or shape mismatch.
    """
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = _flatten_with_path(example_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, example tree "
            f"has {len(flat)}")
    leaves = []
    for (want, leaf), meta in zip(flat, manifest["leaves"]):
        got = meta["key"].split(":", 1)[1]
        if want != got:
            raise ValueError(f"leaf path mismatch: {want} vs {got}")
        arr = data[meta["key"]]
        want_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch at {want}: "
                             f"{arr.shape} vs {want_shape}")
        if meta["dtype"] == "bfloat16":
            leaves.append(torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16))
        else:
            leaves.append(torch.from_numpy(np.array(arr)))
    return tree_unflatten(example_tree, leaves), manifest["step"]

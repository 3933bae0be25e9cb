"""Input specs and their partition specs for every (arch x input shape)
(counterpart of ``repro/launch/specs.py``).

Nothing here allocates: parameters, optimizer state and caches are built
on the ``meta`` device (shapes and dtypes only, the port's form of
``jax.eval_shape``), inputs are hand-built ``meta`` tensors.  Each
function returns ``(tree of meta tensors, tree of sharding.P)`` at the
*global* shapes and dtypes; :func:`local_tree` cuts such a pair to one
rank's local shapes (``sharding.local_shape``), which is what the
dry-run traces.  A mesh here is anything with ``axis_names`` and a
``devices`` grid (a ``Mesh``, a ``RecordingMesh`` or a stand-in).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.dist.mesh import mesh_axis_sizes
from repro_torch.dist.sharding import (P, _spec_leaves, batch_pspec,
                                       cache_shardings,
                                       ensemble_cache_shardings,
                                       ensemble_param_shardings,
                                       local_shape, param_shardings)
from repro_torch.models import init_cache, init_model
from repro_torch.models.config import INPUT_SHAPES, ModelConfig
from repro_torch.models.layers import _dtype

__all__ = ["cache_specs", "ensemble_cache_specs", "ensemble_param_specs",
           "input_specs", "local_tree", "opt_specs", "param_specs", "sds"]


def sds(shape, dtype, mesh, spec: P) -> Tuple[torch.Tensor, P]:
    """One ``meta`` tensor of a global ``shape`` and its spec on ``mesh``
    (the reference's ``ShapeDtypeStruct`` with a ``NamedSharding``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta"), spec


def param_specs(cfg: ModelConfig, mesh) -> Tuple[Any, Any]:
    """``(meta parameter tree, P tree)`` of ``cfg``'s parameters."""
    shapes = init_model(0, cfg, device="meta")
    return shapes, param_shardings(shapes, mesh)


def _with_int_leaves(tree: Any) -> Any:
    """``tree`` with Python numbers as 0-d ``meta`` int32 tensors (the
    port's optimizers count steps in a Python int), so the sharding rules
    can read a shape."""
    return tree_map(lambda x: x if isinstance(x, torch.Tensor) else
                    torch.empty((), dtype=torch.int32, device="meta"), tree)


def opt_specs(param_structs, optimizer, mesh) -> Tuple[Any, Any]:
    """``(optimizer state, P tree)``: ``optimizer.init`` on the ``meta``
    parameters (its ``step`` stays the Python int the port's optimizers
    carry, replicated)."""
    state = optimizer.init(param_structs)
    return state, param_shardings(_with_int_leaves(state), mesh)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, mesh
                ) -> Tuple[Any, Any]:
    """``(meta decode caches, P tree)`` for ``batch`` sequences."""
    shapes = init_cache(cfg, batch, cache_len, device="meta")
    return shapes, cache_shardings(shapes, mesh)


def _stacked(tree: Any, n_replicas: int) -> Any:
    return tree_map(lambda s: torch.empty((n_replicas,) + tuple(s.shape),
                                          dtype=s.dtype, device="meta"),
                    tree)


def ensemble_param_specs(cfg: ModelConfig, mesh, n_replicas: int
                         ) -> Tuple[Any, Any]:
    """``(meta replica-stacked parameters, P tree)``: every leaf grown a
    leading ``(n_replicas,)`` axis, laid out by
    ``ensemble_param_shardings`` (replicas on ``data``, inner dims on
    ``model``), the layout ``repro_torch.dist.serve_robust`` consumes."""
    stacked = _stacked(init_model(0, cfg, device="meta"), n_replicas)
    return stacked, ensemble_param_shardings(stacked, mesh)


def ensemble_cache_specs(cfg: ModelConfig, n_replicas: int, batch: int,
                         cache_len: int, mesh) -> Tuple[Any, Any]:
    """``(meta replica-stacked decode caches, P tree)``."""
    stacked = _stacked(init_cache(cfg, batch, cache_len, device="meta"),
                       n_replicas)
    return stacked, ensemble_cache_shardings(stacked, mesh)


def input_specs(cfg: ModelConfig, shape_name: str, mesh
                ) -> Tuple[Dict[str, Any], Dict[str, P]]:
    """Model inputs of one assigned input shape, and their specs.

    train:    ``{"tokens", "labels"[, "extra"]}`` ``(n_workers,
              per_worker, S)``, one worker per ``data`` index
    prefill:  ``{"tokens"[, "extra"]}`` ``(B, S)``
    decode:   ``{"token", "pos"}`` ``(B, 1)`` and a 0-d int32

    Returns:
      ``(dict of meta tensors, dict of P)``.
    """
    shp = INPUT_SHAPES[shape_name]
    sizes = mesh_axis_sizes(mesh)
    dt = _dtype(cfg.param_dtype)
    enc = cfg.encoder_seq or cfg.vision_seq
    pairs: Dict[str, Tuple[torch.Tensor, P]] = {}
    if shp.kind == "train":
        n_workers = sizes["data"]
        pw = shp.global_batch // n_workers
        shape = (n_workers, pw, shp.seq_len)
        tspec = batch_pspec(shape, mesh, worker_axis=True)
        pairs["tokens"] = sds(shape, torch.int32, mesh, tspec)
        pairs["labels"] = sds(shape, torch.int32, mesh, tspec)
        if cfg.arch_type in ("audio", "vlm"):
            eshape = (n_workers, pw, enc, cfg.d_model)
            pairs["extra"] = sds(eshape, dt, mesh, batch_pspec(
                eshape, mesh, worker_axis=True))
    elif shp.kind == "prefill":
        shape = (shp.global_batch, shp.seq_len)
        pairs["tokens"] = sds(shape, torch.int32, mesh, batch_pspec(
            shape, mesh, worker_axis=False))
        if cfg.arch_type in ("audio", "vlm"):
            eshape = (shp.global_batch, enc, cfg.d_model)
            pairs["extra"] = sds(eshape, dt, mesh, batch_pspec(
                eshape, mesh, worker_axis=False))
    else:
        shape = (shp.global_batch, 1)
        pairs["token"] = sds(shape, torch.int32, mesh, batch_pspec(
            shape, mesh, worker_axis=False))
        pairs["pos"] = sds((), torch.int32, mesh, P())
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


def local_tree(tree: Any, specs: Any, mesh) -> Any:
    """One rank's ``meta`` slices of a global ``(tree, specs)`` pair:
    every tensor leaf at ``sharding.local_shape``, anything else (a
    Python step count) as it is."""
    spec_leaves = _spec_leaves(specs)
    leaves = tree_leaves(tree)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"specs has {len(spec_leaves)} leaves, the tree "
                         f"{len(leaves)}")
    return tree_unflatten(tree, [
        torch.empty(local_shape(tuple(x.shape), s, mesh), dtype=x.dtype,
                    device="meta") if isinstance(x, torch.Tensor) else x
        for x, s in zip(leaves, spec_leaves)])

"""Serving steps over the model zoo's prefill and decode paths
(counterpart of ``repro/dist/serve.py``).

Thin closures over ``repro_torch.models.prefill`` / ``decode_step``.
The Byzantine-resilient ensemble forms of these steps live in
``repro_torch.dist.serve_robust`` (``make_robust_prefill_step`` /
``make_robust_serve_step``), where every replica runs under
``torch.func.vmap`` and the per-token logits stack is aggregated through
the ``repro_torch.agg`` registry.

With ``mesh=`` (a rank's ``repro_torch.dist.mesh.Mesh``, or the
dry-run's ``RecordingMesh``) the steps are explicit SPMD's stand-in for
the reference's jit shardings: each rank takes its ``param_shardings``
slices over ``model`` in the serving layout (:func:`serve_specs`: the
leaves a layer reads whole are whole, so no step gathers a parameter)
and its slice of the batch and caches over the data-parallel axes
(``batch_pspec`` / ``cache_shardings``), and runs the split forward
(``shard=``, ``repro_torch.dist.tensor_parallel``).  The logits are then
this rank's vocabulary columns when the output table splits on the
vocabulary (``repro_torch.models.decode.logits_split``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step", "serve_shard",
           "serve_specs"]


def serve_specs(cfg: ModelConfig, mesh, n_replicas: Optional[int] = None
                ) -> Any:
    """The serving layout of ``cfg``'s parameters on ``mesh``.

    Args:
      cfg: the model configuration.
      mesh: the mesh (anything ``mesh_axis_sizes`` reads).
      n_replicas: ``None`` for one model (``param_shardings``), or the
        size of a replica-stacked ensemble (``ensemble_param_shardings``:
        the replica axis on ``data`` where it divides).

    Returns:
      The tree of ``sharding.P``, the leaves a layer reads whole
      replicated over ``model`` (``tensor_parallel.serving_specs``).
    """
    from repro_torch.core.pytree import tree_map
    from repro_torch.dist.sharding import (ensemble_param_shardings,
                                           param_shardings)
    from repro_torch.dist.tensor_parallel import serving_specs
    from repro_torch.models import init_model
    template = init_model(0, cfg, device="meta")
    if n_replicas is None:
        return serving_specs(param_shardings(template, mesh))
    stacked = tree_map(lambda x: torch.empty(
        (n_replicas,) + tuple(x.shape), dtype=x.dtype, device="meta"),
        template)
    return serving_specs(ensemble_param_shardings(stacked, mesh), lead=1)


def serve_shard(cfg: ModelConfig, mesh, n_replicas: Optional[int] = None):
    """The ``tensor_parallel.Shard`` of :func:`serve_specs`' layout as the
    layers see it (the replica axis, if any, left to ``vmap``; a leaf
    gathered on use raises), or ``None`` without a ``model`` axis larger
    than 1."""
    from repro_torch.dist.mesh import mesh_axis_sizes
    from repro_torch.dist.tensor_parallel import model_shard
    if mesh is None or mesh_axis_sizes(mesh).get("model", 1) <= 1:
        return None
    return model_shard(mesh, serve_specs(cfg, mesh, n_replicas),
                       lead=0 if n_replicas is None else 1, gathers=False)


def make_prefill_step(cfg: ModelConfig, impl: str = "auto",
                      mesh=None) -> Callable:
    """Build the full-sequence prefill step.

    Args:
      cfg: the model configuration.
      impl: attention path (``"auto"`` | ``"naive"`` | ``"blockwise"``).
      mesh: ``None``, or this rank's mesh: the step then takes the
        rank's slices in the :func:`serve_specs` layout and runs the
        split forward (see the module docstring).

    Returns:
      ``prefill_step(params, tokens[, extra]) -> (logits, cache)``: the
      full-sequence forward that also fills decode caches of the
      sequence's length.
    """
    shard = serve_shard(cfg, mesh)

    def prefill_step(params, tokens: torch.Tensor,
                     extra: Optional[torch.Tensor] = None):
        return prefill(params, cfg, tokens, extra=extra, impl=impl,
                       shard=shard)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """Build the single-token batched decode step.

    Args:
      cfg: the model configuration.
      mesh: ``None``, or this rank's mesh (as :func:`make_prefill_step`'s).

    Returns:
      ``serve_step(params, cache, token, pos) -> (logits, new_cache)``:
      one token for every sequence of the batch.  ``pos`` is a scalar
      (every sequence at one position) or ``(B,)`` int32 per-slot
      positions (continuous batching), as ``ServingEngine`` passes them
      from its int32 host counters.
    """
    shard = serve_shard(cfg, mesh)

    def serve_step(params, cache, token: torch.Tensor, pos):
        return decode_step(params, cfg, cache, token, pos, shard=shard)

    return serve_step

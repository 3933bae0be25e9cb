"""Serving steps over the model zoo's prefill and decode paths
(counterpart of ``repro/dist/serve.py``).

Thin closures over ``repro_torch.models.prefill`` / ``decode_step``.
The Byzantine-resilient ensemble forms of these steps live in
``repro_torch.dist.serve_robust`` (``make_robust_prefill_step`` /
``make_robust_serve_step``), where every replica runs under
``torch.func.vmap`` and the per-token logits stack is aggregated through
the ``repro_torch.agg`` registry.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, impl: str = "auto") -> Callable:
    """Build the full-sequence prefill step.

    Args:
      cfg: the model configuration.
      impl: attention path (``"auto"`` | ``"naive"`` | ``"blockwise"``).

    Returns:
      ``prefill_step(params, tokens[, extra]) -> (logits, cache)``: the
      full-sequence forward that also fills decode caches of the
      sequence's length.
    """

    def prefill_step(params, tokens: torch.Tensor,
                     extra: Optional[torch.Tensor] = None):
        return prefill(params, cfg, tokens, extra=extra, impl=impl)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """Build the single-token batched decode step.

    Args:
      cfg: the model configuration.

    Returns:
      ``serve_step(params, cache, token, pos) -> (logits, new_cache)``:
      one token for every sequence of the batch.  ``pos`` is a scalar
      (every sequence at one position) or ``(B,)`` int32 per-slot
      positions (continuous batching), as ``ServingEngine`` passes them
      from its int32 host counters.
    """

    def serve_step(params, cache, token: torch.Tensor, pos):
        return decode_step(params, cfg, cache, token, pos)

    return serve_step

"""Dispatchers between the aggregation kernels and their oracles.

Counterpart of ``repro/kernels/ops.py``.  The reference's flag
``use_pallas`` becomes ``use_kernel`` here: ``None`` picks the CUDA
kernel for a CUDA tensor and the plain oracle for a CPU one, ``True``
demands the kernel (a CPU tensor raises: it never quietly takes the
plain path) and ``False`` demands the oracle on either device.  The
reference's ``block_d`` (the kernels' VMEM tile) has no counterpart: the
CUDA kernels pick their own launch shape.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bulyan_select import bulyan_select as _bulyan_select
from repro_torch.kernels.pairwise_gram import pairwise_gram as _pairwise_gram

__all__ = ["bulyan_coordinate", "pairwise_distances"]


def _use_kernel(x: torch.Tensor, use_kernel: Optional[bool],
                what: str) -> bool:
    if use_kernel is None:
        return x.device.type == "cuda"
    if use_kernel and x.device.type != "cuda":
        raise ValueError(f"{what}: use_kernel=True needs a CUDA tensor, "
                         f"got one on {x.device}")
    return bool(use_kernel)


def pairwise_distances(grads: torch.Tensor, *,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Squared pairwise distances; kernel or oracle.

    Args:
      grads: ``(n, d)`` worker-stacked flat gradients.
      use_kernel: replaces the reference's ``use_pallas``.  ``None``: K1
        (``pairwise_gram``) for a CUDA tensor, the oracle
        ``ref.pairwise_gram_ref`` for a CPU one; ``True``: K1, raising on
        a CPU tensor; ``False``: the oracle.

    Returns:
      ``(n, n)`` float32 squared distances, zero diagonal.
    """
    if _use_kernel(grads, use_kernel, "pairwise_distances"):
        return _pairwise_gram(grads)
    return ref.pairwise_gram_ref(grads)


def bulyan_coordinate(selected: torch.Tensor, f: int, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Bulyan coordinate phase; kernel or oracle.

    Args:
      selected: ``(theta, d)`` selected-gradient stack.
      f: Byzantine bound (``beta = theta - 2f``).
      use_kernel: replaces the reference's ``use_pallas``.  ``None``: K2
        (``bulyan_select``) for a CUDA tensor,
        ``repro_torch.core.bulyan.coordinate_phase`` for a CPU one;
        ``True``: K2, raising on a CPU tensor; ``False``:
        ``coordinate_phase``.

    Returns:
      ``(d,)`` float32 coordinate-phase aggregate (``coordinate_phase``
      keeps the input dtype, as the reference's does).
    """
    if _use_kernel(selected, use_kernel, "bulyan_coordinate"):
        return _bulyan_select(selected, f)
    from repro_torch.core.bulyan import coordinate_phase
    return coordinate_phase(selected, f)

"""K3: coordinate-wise median and f-trimmed mean from one sort.

Counterpart of ``repro/kernels/coord_stats.py``.  Replaces the Pallas
kernel ``_make_kernel`` (``coord_stats.py:29``) reached through
``coord_stats`` (``:40``); the CUDA source is
``repro_torch/csrc/coord_stats.cu``.  Per coordinate of an ``(n, d)``
stack: one sort of the n values (the reference's odd-even network here,
Batcher's network in registers with a NaN flag in the kernel: the same
sorted values), then the median (the mean of the two middle values for
even n) and the mean of the sorted values ``f .. n - f - 1``.  The two rules share their sort, so the stack is
read once for both; the kernel is bounded by that read (n * d elements)
and the two ``(d,)`` float writes.

``coord_stats`` dispatches on the tensor's device: a CPU tensor takes
:func:`coord_stats_plain`, the reference's arithmetic step for step; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (coord_median, coord_trimmed_mean,
                                        oe_sort_rows)
from repro_torch.kernels.pairwise_gram import _check_stack, _plain_block_d

__all__ = ["coord_stats", "coord_stats_plain"]


def _check_trim(n: int, f: int) -> None:
    if n <= 2 * f:
        raise ValueError(f"need n > 2f (n={n}, f={f})")


def coord_stats_plain(grads: torch.Tensor, f: int, *,
                      block_d: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3, tile by tile as the reference.

    Args:
      grads: ``(n, d)`` worker rows, fp32 or bf16 (widened to fp32).
      f: trim count per side; requires ``n > 2f``.
      block_d: tile width along d, as the reference's tiles
        (``None``: the whole width at once); coordinates are independent,
        so the result does not depend on it.

    Returns:
      ``(median, trimmed_mean)``, each ``(d,)`` float32.
    """
    n, d = grads.shape
    _check_trim(n, f)
    x = grads.to(torch.float32)
    block_d = block_d or max(d, 1)
    med, trim = [], []
    for k0 in range(0, max(d, 1), block_d):
        blk = x[:, k0:k0 + block_d]
        rows = oe_sort_rows([blk[i] for i in range(n)])
        med.append(coord_median(rows))
        trim.append(coord_trimmed_mean(rows, f))
    return torch.cat(med), torch.cat(trim)


def coord_stats(grads: torch.Tensor, f: int, *,
                block_d: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused coordinate-wise median + f-trimmed mean.

    Args:
      grads: ``(n, d)`` worker-stacked flat gradients, fp32 or bf16,
        n <= 64, contiguous on the card; requires ``n > 2f``.
      f: trim count per side.
      block_d: tile width of the plain version, for a CPU tensor only
        (``None``: its default); a CUDA tensor with a ``block_d`` raises.

    Returns:
      ``(median, trimmed_mean)``, each ``(d,)`` float32.  A CPU tensor
      takes the plain version; a CUDA tensor launches the kernel or
      raises.
    """
    n, d = grads.shape
    _check_trim(n, f)
    kw = _plain_block_d(grads, block_d, "coord_stats")
    if grads.device.type == "cpu":
        return coord_stats_plain(grads, f, **kw)
    if grads.device.type != "cuda":
        raise ValueError(f"unsupported device {grads.device}")
    _check_stack(grads, "coord_stats")
    med = torch.empty((d,), dtype=torch.float32, device=grads.device)
    trim = torch.empty((d,), dtype=torch.float32, device=grads.device)
    lib = _build.library("coord_stats")
    fn = (lib.coord_stats_f32 if grads.dtype == torch.float32
          else lib.coord_stats_bf16)
    _build.check(fn(grads.data_ptr(), n, d, f, med.data_ptr(),
                    trim.data_ptr(), _build.stream_of(grads)), "coord_stats")
    _build.count("coord_stats")
    return med, trim

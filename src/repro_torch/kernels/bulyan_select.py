"""K2: Bulyan's coordinate phase, fused.

Counterpart of ``repro/kernels/bulyan_select.py``.  Replaces the Pallas
kernel ``_make_kernel`` (``bulyan_select.py:41``) reached through
``bulyan_select`` (``:51``); the CUDA source is
``repro_torch/csrc/bulyan_select.cu``, which launches
``csrc/common.cuh``'s ``coord_stats_kernel`` with its Bulyan output.  Per
coordinate of a ``(theta, d)`` stack: a sort of the theta values (the
reference's odd-even network here, Batcher's network in registers with a
NaN flag in the kernel: the same sorted values), then the mean of the
beta = theta - 2f sorted values closest to the lower-middle median,
found by prefix sums over the theta - beta + 1 contiguous windows with
the first window winning ties.  It is bounded by reading the stack once
(theta * d elements) and writing d floats.

``bulyan_select`` dispatches on the tensor's device: a CPU tensor takes
:func:`bulyan_select_plain`, the reference's arithmetic step for step; a
CUDA tensor launches the kernel or raises; a ``meta`` tensor (a
dry-run) gets an empty result of the kernel's shape and counts the
launch, building nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import bulyan_window, oe_sort_rows
from repro_torch.kernels.pairwise_gram import _check_stack, _plain_block_d

__all__ = ["bulyan_select", "bulyan_select_plain"]


def _check_beta(theta: int, f: int) -> None:
    if theta - 2 * f < 1:
        raise ValueError(f"need theta > 2f (theta={theta}, f={f})")


def bulyan_select_plain(selected: torch.Tensor, f: int, *,
                        block_d: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K2, tile by tile as the reference.

    Args:
      selected: ``(theta, d)`` selected rows, fp32 or bf16 (widened to
        fp32).
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.
      block_d: tile width along d, as the reference's tiles
        (``None``: the whole width at once); coordinates are independent,
        so the result does not depend on it.

    Returns:
      ``(d,)`` float32 coordinate-phase aggregate.
    """
    theta, d = selected.shape
    _check_beta(theta, f)
    x = selected.to(torch.float32)
    block_d = block_d or max(d, 1)
    out = []
    for k0 in range(0, max(d, 1), block_d):
        blk = x[:, k0:k0 + block_d]
        out.append(bulyan_window(oe_sort_rows([blk[i] for i in
                                               range(theta)]), f))
    return torch.cat(out)


def bulyan_select(selected: torch.Tensor, f: int, *,
                  block_d: Optional[int] = None) -> torch.Tensor:
    """Bulyan coordinate phase of a ``(theta, d)`` stack.

    Args:
      selected: ``(theta, d)`` stack of the theta selected gradients,
        fp32 or bf16, theta <= 64, any strides.
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.
      block_d: tile width of the plain version, for a CPU tensor only
        (``None``: its default); a CUDA tensor with a ``block_d`` raises.

    Returns:
      ``(d,)`` float32: per coordinate, the mean of the beta sorted
      values closest to the median.  A CPU tensor takes the plain
      version; a CUDA tensor launches the kernel or raises.
    """
    theta, d = selected.shape
    _check_beta(theta, f)
    kw = _plain_block_d(selected, block_d, "bulyan_select")
    if selected.device.type == "cpu":
        return bulyan_select_plain(selected, f, **kw)
    if selected.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {selected.device}")
    # the kernel reads rows: a strided stack is copied once, here
    selected = selected.contiguous()
    _check_stack(selected, "bulyan_select")
    out = torch.empty((d,), dtype=torch.float32, device=selected.device)
    if selected.device.type == "meta":
        # a dry-run's trace: the kernel's output, counted as its launch
        _build.count("bulyan_select")
        return out
    lib = _build.library("bulyan_select")
    fn = (lib.bulyan_select_f32 if selected.dtype == torch.float32
          else lib.bulyan_select_bf16)
    _build.check(fn(selected.data_ptr(), theta, d, f, out.data_ptr(),
                    _build.stream_of(selected)), "bulyan_select")
    _build.count("bulyan_select")
    return out

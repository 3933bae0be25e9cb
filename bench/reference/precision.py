"""The references' matrix products, and the lower precision their
control runs in.

The configurations state float32 with TF32 off.  The control is the
reference in TF32: on the card, cuBLAS's and cuDNN's own TF32 paths; on
the CPU, which has none, both operands rounded to TF32's 10-bit mantissa
(round to nearest even) before a float32 product, with the rounding
passed straight through in the backward.
"""
from __future__ import annotations

import contextlib

import torch

_EMULATE = [False]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    r = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the current precision."""
    if _EMULATE[0]:
        return _tf32(a) @ _tf32(b)
    return a @ b


def conv_in(x: torch.Tensor) -> torch.Tensor:
    """A convolution's operand in the current precision."""
    return _tf32(x) if _EMULATE[0] else x


@contextlib.contextmanager
def precision(name: str, device):
    """``"fp32"`` (TF32 off) or ``"tf32"`` around a block."""
    if name not in ("fp32", "tf32"):
        raise KeyError(name)
    cuda = torch.device(device).type == "cuda"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _EMULATE[0])
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on and cuda
    torch.backends.cudnn.allow_tf32 = on and cuda
    _EMULATE[0] = on and not cuda
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _EMULATE[0]) = saved

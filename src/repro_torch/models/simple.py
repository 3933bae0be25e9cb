"""The paper's own evaluation models (§5.1); counterpart of
``repro/models/simple.py``.

MNIST: fully connected 784 -> 100 -> 10 (d = 79,510 parameters).
CIFAR-10: conv(3x3, 16) -> maxpool(3x3, s2) -> conv(4x4, 64) ->
maxpool(4x4, s3) -> fc 384 -> fc 192 -> 10 (d = 486,346).

Parameters keep the reference's names and layouts (HWIO conv kernels,
``(in, out)`` dense weights), so a parameter dict copies across name for
name (``repro_torch.interop.params_from_jax``) and flattens in the same
sorted-key order.  The forward functions take such a dict, which is what
``torch.func`` differentiates per worker; :class:`MnistMLP` and
:class:`CifarCNN` wrap them as ``nn.Module``s.  Convolutions run NCHW /
OIHW inside ``forward``; the reference's ``"SAME"`` padding of the 4x4
convolution pads 1 before and 2 after, and its flatten before ``w1`` is
in NHWC order.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.pytree import tree_leaves
from repro_torch.device import resolve_device

__all__ = ["CifarCNN", "L2_REG", "MnistMLP", "accuracy",
           "cifar_cnn_forward", "classification_loss", "init_cifar_cnn",
           "init_mnist_mlp", "mnist_mlp_forward"]

L2_REG = 1e-4

Params = Dict[str, torch.Tensor]


def _xavier(gen: torch.Generator, shape, device) -> torch.Tensor:
    if len(shape) == 4:
        fan_in = shape[0] * shape[1] * shape[2]
    else:
        fan_in = shape[-2]
    lim = (6.0 / (fan_in + shape[-1])) ** 0.5
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * lim).to(device)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def init_mnist_mlp(seed: int = 0, device="cuda") -> Params:
    """Xavier-uniform MLP parameters from a seeded ``torch.Generator``.

    Args:
      seed: generator seed (the draw is made on the CPU, then moved).
      device: target device; ``"cuda"`` raises when no card is present.

    Returns:
      Dict with ``w1 (784, 100)``, ``b1``, ``w2 (100, 10)``, ``b2``.
    """
    dev = resolve_device(device)
    g = _generator(seed)
    return {"w1": _xavier(g, (784, 100), dev),
            "b1": torch.zeros((100,), device=dev),
            "w2": _xavier(g, (100, 10), dev),
            "b2": torch.zeros((10,), device=dev)}


def mnist_mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 784) -> logits (B, 10).

    Args:
      params: MLP parameter dict.
      x: input batch.

    Returns:
      Logits.
    """
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def init_cifar_cnn(seed: int = 0, device="cuda") -> Params:
    """Xavier-uniform CNN parameters from a seeded ``torch.Generator``.

    Args:
      seed: generator seed (the draw is made on the CPU, then moved).
      device: target device; ``"cuda"`` raises when no card is present.

    Returns:
      Dict with HWIO ``c1 (3, 3, 3, 16)``, ``c2 (4, 4, 16, 64)``, their
      biases ``cb1``/``cb2`` and dense ``w1``..``w3`` / ``b1``..``b3``.
    """
    dev = resolve_device(device)
    g = _generator(seed)
    return {
        "c1": _xavier(g, (3, 3, 3, 16), dev),
        "cb1": torch.zeros((16,), device=dev),
        "c2": _xavier(g, (4, 4, 16, 64), dev),
        "cb2": torch.zeros((64,), device=dev),
        # 32 -> conv 32 -> pool3 s2 -> 15 -> conv 15 -> pool4 s3 -> 4
        "w1": _xavier(g, (4 * 4 * 64, 384), dev),
        "b1": torch.zeros((384,), device=dev),
        "w2": _xavier(g, (384, 192), dev),
        "b2": torch.zeros((192,), device=dev),
        "w3": _xavier(g, (192, 10), dev),
        "b3": torch.zeros((10,), device=dev),
    }


def _conv_same(h: torch.Tensor, w_hwio: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Stride-1 ``"SAME"`` convolution of NCHW ``h`` with an HWIO kernel:
    XLA pads ``total // 2`` before and the rest after."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    pad = ((kw - 1) // 2, kw - 1 - (kw - 1) // 2,
           (kh - 1) // 2, kh - 1 - (kh - 1) // 2)
    return F.conv2d(F.pad(h, pad), w_hwio.permute(3, 2, 0, 1), b)


def cifar_cnn_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) NHWC -> logits (B, 10).

    Args:
      params: CNN parameter dict.
      x: NHWC input batch.

    Returns:
      Logits.
    """
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(_conv_same(h, params["c1"], params["cb1"]))
    h = F.max_pool2d(h, kernel_size=3, stride=2)       # "VALID"
    h = torch.relu(_conv_same(h, params["c2"], params["cb2"]))
    h = F.max_pool2d(h, kernel_size=4, stride=3)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
    h = torch.relu(h @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        params: Params) -> torch.Tensor:
    """Cross entropy + L2 over every parameter, biases included (§5.1).

    Args:
      logits: ``(B, C)``.
      labels: ``(B,)`` integer classes.
      params: parameter dict (the L2 term sums leaves in sorted order).

    Returns:
      Scalar loss.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
    l2 = sum(torch.sum(w * w) for w in tree_leaves(params))
    return nll + L2_REG * l2


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy.

    Args:
      logits: ``(B, C)``.
      labels: ``(B,)`` integer classes.

    Returns:
      Scalar float32 fraction correct.
    """
    return torch.mean((torch.argmax(logits, dim=1) == labels.long())
                      .to(torch.float32))


class _DictModel(nn.Module):
    """``nn.Module`` over a parameter dict with the reference's names."""

    _forward = None

    def __init__(self, params: Optional[Params] = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if params is None:
            params = self._init(seed, device)
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v.detach().clone()))

    def params(self) -> Params:
        """The parameters as a plain dict (name -> tensor)."""
        return dict(self.named_parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return type(self)._forward(self.params(), x)


class MnistMLP(_DictModel):
    """The paper's MNIST MLP as an ``nn.Module``."""

    _forward = staticmethod(mnist_mlp_forward)
    _init = staticmethod(init_mnist_mlp)


class CifarCNN(_DictModel):
    """The paper's CIFAR CNN as an ``nn.Module`` (NHWC input)."""

    _forward = staticmethod(cifar_cnn_forward)
    _init = staticmethod(init_cifar_cnn)

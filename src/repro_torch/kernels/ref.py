"""Plain PyTorch oracles for the aggregation kernels.

Counterpart of ``repro/kernels/ref.py``: straightforward, untiled
implementations that state what each kernel computes.  They are the
semantic ground truth the kernels' tests and the dispatcher
(:mod:`repro_torch.kernels.ops`) fall back to; the kernels' own plain
versions, which repeat the kernels' arithmetic step for step, live
beside each kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.gars import _median0

__all__ = ["bulyan_select_ref", "coord_stats_ref", "pairwise_gram_ref"]


def pairwise_gram_ref(grads: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) squared euclidean distances, fp32 accumulation.

    Args:
      grads: ``(n, d)`` worker rows, any float dtype.

    Returns:
      ``(n, n)`` float32, clamped at zero, zero diagonal.
    """
    g = grads.to(torch.float32)
    sq = torch.sum(g * g, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (g @ g.T)
    d2 = torch.clamp_min(d2, 0.0)
    return d2 * (1.0 - torch.eye(g.shape[0], dtype=torch.float32,
                                 device=g.device))


def bulyan_select_ref(selected: torch.Tensor, f: int) -> torch.Tensor:
    """(theta, d) -> (d,): per coordinate, the mean of the beta = theta - 2f
    values closest to the coordinate-wise (lower-middle) median.

    A literal transcription of the paper's formula: values ordered by
    their distance to the median (a stable sort, so equal distances keep
    row order as ``jnp.argsort`` does), the first beta averaged.

    Args:
      selected: ``(theta, d)`` stack, any float dtype.
      f: Byzantine bound; requires ``beta >= 1``.

    Returns:
      ``(d,)`` float32.
    """
    theta = selected.shape[0]
    beta = theta - 2 * f
    if beta < 1:
        raise ValueError(f"need theta > 2f (theta={theta}, f={f})")
    x = selected.to(torch.float32)
    s = torch.sort(x, dim=0).values
    med = s[(theta - 1) // 2]
    dist = torch.abs(x - med[None, :])
    order = torch.argsort(dist, dim=0, stable=True)[:beta]
    closest = torch.take_along_dim(x, order, dim=0)
    return torch.mean(closest, dim=0)


def coord_stats_ref(grads: torch.Tensor, f: int):
    """(n, d) -> (median, f-trimmed mean), fp32.

    Args:
      grads: ``(n, d)`` worker rows, any float dtype.
      f: trim count per side.

    Returns:
      ``(median, trimmed_mean)``, each ``(d,)`` float32; the median is
      the mean of the two middle values for even n, as ``jnp.median``.
    """
    x = torch.sort(grads.to(torch.float32), dim=0).values
    n = x.shape[0]
    return _median0(x), torch.mean(x[f:n - f], dim=0)

"""Shared building blocks of the aggregation kernels' plain versions.

Counterpart of ``repro/kernels/common.py``: the odd-even transposition
sorting network and the per-coordinate combine bodies (Bulyan's
beta-closest-to-median window, the coordinate-wise median and the
f-trimmed mean).  Each helper works on a list of equally shaped "rows",
treated as axis 0 of a ``(rows, ...)`` stack, with the reference's
arithmetic step for step.  Their CUDA twins are the device functions of
``repro_torch/csrc/common.cuh``: K2, K3 and K4 hold one coordinate's
values in registers, sort them with Batcher's network and a NaN flag
(the same sorted values, up to the sign of a zero), run these combine
bodies in the same order of additions, and scale means by the rounded
reciprocal of their count.
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["bulyan_window", "coord_median", "coord_trimmed_mean",
           "oe_sort_rows"]


def oe_sort_rows(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Odd-even transposition sort across a list of rows (axis 0).

    Args:
      rows: equally shaped tensors, one per row of the stack.

    Returns:
      A new list with the rows sorted ascending per element, by exactly
      ``m * (m - 1) / 2`` min/max pairs (the inputs are not mutated).
    """
    m = len(rows)
    rows = list(rows)
    for p in range(m):
        for i in range(p % 2, m - 1, 2):
            a, b = rows[i], rows[i + 1]
            rows[i] = torch.minimum(a, b)
            rows[i + 1] = torch.maximum(a, b)
    return rows


def bulyan_window(rows: List[torch.Tensor], f: int) -> torch.Tensor:
    """Bulyan's coordinate phase on an already sorted row list.

    Args:
      rows: ``theta`` sorted rows (ascending per element).
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.

    Returns:
      One row: per element, the mean of the best window of ``beta``
      consecutive sorted values around the lower-middle median (prefix
      sums, first window wins ties).
    """
    theta = len(rows)
    beta = theta - 2 * f
    med = rows[(theta - 1) // 2]

    if beta == theta:
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return acc / beta

    pref_v = [torch.zeros_like(med)]
    pref_d = [torch.zeros_like(med)]
    for r in rows:
        pref_v.append(pref_v[-1] + r)
        pref_d.append(pref_d[-1] + torch.abs(r - med))

    n_win = theta - beta + 1
    best_dev = pref_d[beta] - pref_d[0]
    best_sum = pref_v[beta] - pref_v[0]
    for w in range(1, n_win):
        dev = pref_d[w + beta] - pref_d[w]
        s = pref_v[w + beta] - pref_v[w]
        take = dev < best_dev                      # first-window tiebreak
        best_dev = torch.where(take, dev, best_dev)
        best_sum = torch.where(take, s, best_sum)
    return best_sum / beta


def coord_median(rows: List[torch.Tensor]) -> torch.Tensor:
    """Coordinate-wise median of an already sorted row list.

    Args:
      rows: ``n`` sorted rows.

    Returns:
      The middle row for odd ``n``, the mean of the two middle rows for
      even ``n`` (as ``jnp.median``; ``torch.median`` would return the
      lower one).
    """
    n = len(rows)
    if n % 2:
        return rows[n // 2]
    return 0.5 * (rows[n // 2 - 1] + rows[n // 2])


def coord_trimmed_mean(rows: List[torch.Tensor], f: int) -> torch.Tensor:
    """Coordinate-wise f-trimmed mean of an already sorted row list.

    Args:
      rows: ``n`` sorted rows; requires ``n > 2f``.
      f: trim count per side.

    Returns:
      The mean of rows ``f .. n - f - 1``.
    """
    n = len(rows)
    acc = rows[f]
    for r in rows[f + 1:n - f]:
        acc = acc + r
    return acc / (n - 2 * f)

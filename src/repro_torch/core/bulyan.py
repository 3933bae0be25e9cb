"""Bulyan(A), the paper's contribution (§4); counterpart of
``repro/core/bulyan.py`` for the distance-only bases krum and geomed.

Phase 1 repeatedly runs the base rule on the remaining set and moves its
winner into the selection, until theta = n - 2f vectors are selected.
Phase 2 outputs, per coordinate, the mean of the beta = theta - 2f values
closest to the coordinate-wise median.  The median here is the 1-D
medoid, the lower middle ``s[(theta - 1) // 2]`` of the sorted values.
"""
from __future__ import annotations

import torch

from repro_torch.core import gars
from repro_torch.core.types import AggResult

__all__ = ["coordinate_phase", "make_bulyan", "select_indices_from_dists"]


def _krum_pos(sub: torch.Tensor, f: int, n_rem: int) -> torch.Tensor:
    """Krum winner position on an (n_rem, n_rem) distance submatrix."""
    k = max(1, n_rem - f - 2)
    eye = torch.eye(n_rem, dtype=torch.bool, device=sub.device)
    dm = sub + torch.where(eye, float("inf"), 0.0).to(sub.dtype)
    snn = torch.sort(dm, dim=1).values[:, :k]
    return torch.argmin(torch.sum(snn, dim=1))


def _geomed_pos(sub: torch.Tensor) -> torch.Tensor:
    dist = torch.sqrt(torch.clamp_min(sub, 0.0))
    return torch.argmin(torch.sum(dist, dim=1))


def select_indices_from_dists(dist2: torch.Tensor, f: int,
                              base: str = "krum") -> torch.Tensor:
    """Phase 1 from the ``(n, n)`` squared-distance matrix alone.

    Args:
      dist2: ``(n, n)`` squared distances.
      f: Byzantine bound; requires ``n >= 4f + 3``.
      base: ``"krum"`` or ``"geomed"``.

    Returns:
      ``(theta,)`` int64 original-worker indices in pick order.
    """
    n = dist2.shape[0]
    theta = n - 2 * f
    if n < 4 * f + 3:
        raise ValueError(f"bulyan requires n >= 4f+3, got n={n}, f={f}")
    if base not in ("krum", "geomed"):
        raise KeyError(f"distance-only selection needs krum/geomed, "
                       f"got {base!r}")
    rem = torch.arange(n, device=dist2.device)
    picked = []
    for t in range(theta):
        n_rem = n - t
        sub = dist2[rem[:, None], rem[None, :]]
        pos = int(_krum_pos(sub, f, n_rem) if base == "krum"
                  else _geomed_pos(sub))
        picked.append(rem[pos])
        rem = torch.cat([rem[:pos], rem[pos + 1:]])
    return torch.stack(picked)


def coordinate_phase(selected: torch.Tensor, f: int) -> torch.Tensor:
    """Phase 2 on a ``(theta, d)`` stack.

    Args:
      selected: ``(theta, d)`` selected rows.
      f: Byzantine bound; requires ``beta = theta - 2f >= 1``.

    Returns:
      ``(d,)`` per-coordinate mean of the beta values closest to the
      lower-middle median: a contiguous window of the sorted order,
      found by prefix sums with the first window winning ties.
    """
    theta = selected.shape[0]
    beta = theta - 2 * f
    if beta < 1:
        raise ValueError(
            f"beta = theta - 2f must be >= 1 (theta={theta}, f={f})")
    s = torch.sort(selected, dim=0).values
    med = s[(theta - 1) // 2]
    if beta == theta:
        return torch.mean(s, dim=0)
    absdev = torch.abs(s - med[None, :])
    zeros = torch.zeros_like(s[:1])
    cd = torch.cat([zeros, torch.cumsum(absdev, dim=0)], dim=0)
    cv = torch.cat([zeros, torch.cumsum(s, dim=0)], dim=0)
    n_win = theta - beta + 1
    win_dev = cd[beta:] - cd[:n_win]
    win_sum = cv[beta:] - cv[:n_win]
    w = torch.argmin(win_dev, dim=0)
    best = torch.take_along_dim(win_sum, w[None, :], dim=0)[0]
    return best / beta


def make_bulyan(base: str = "krum"):
    """Build Bulyan(base) as a standard GAR callable.

    Args:
      base: ``"krum"`` or ``"geomed"``.

    Returns:
      ``bulyan(grads, f) -> AggResult``; ``selected`` marks the theta
      picks with 1.0 and ``scores`` is zeros, as in the reference.
    """
    if base not in ("krum", "geomed"):
        raise NotImplementedError(f"bulyan base {base!r} is not ported yet")
    def bulyan(grads: torch.Tensor, f: int) -> AggResult:
        n = grads.shape[0]
        idx = select_indices_from_dists(gars.pairwise_sq_dists(grads), f,
                                        base)
        agg = coordinate_phase(grads[idx], f)
        sel = torch.zeros((n,), dtype=grads.dtype, device=grads.device)
        sel[idx] = 1.0
        return AggResult(agg, sel, torch.zeros_like(sel))

    bulyan.__name__ = f"bulyan_{base}"
    return bulyan

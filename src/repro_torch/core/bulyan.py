"""Bulyan(A), the paper's contribution (§4); counterpart of
``repro/core/bulyan.py``.

Phase 1 repeatedly runs the base rule on the remaining set and moves its
winner into the selection, until theta = n - 2f vectors are selected.
For Krum and the Medoid the winner is the rule's own pick; for
``average`` and ``brute`` it is the remaining vector closest to the
rule's output.  Phase 2 outputs, per coordinate, the mean of the
beta = theta - 2f values closest to the coordinate-wise median.  The
median here is the 1-D medoid, the lower middle ``s[(theta - 1) // 2]``
of the sorted values.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import gars
from repro_torch.core.types import AggResult

__all__ = ["coordinate_phase", "coordinate_phase_ref", "make_bulyan",
           "select_indices", "select_indices_from_dists"]


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


def _closest_pos(grads_rem: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Position of the remaining vector closest to a rule's output."""
    return torch.argmin(torch.sum((grads_rem - out[None, :]) ** 2, dim=1))


def _brute_pos(sub: torch.Tensor, grads_rem: torch.Tensor, f: int,
               n_rem: int) -> torch.Tensor:
    """Brute on the remaining set: the min-diameter subset of size
    ``n_rem - f``, its average as the output, and the remaining vector
    closest to it as the winner."""
    subsets = torch.tensor(gars._subsets(n_rem, n_rem - f),
                           device=sub.device)
    block = sub[subsets[:, :, None], subsets[:, None, :]]
    diam = torch.amax(block.reshape(subsets.shape[0], -1), dim=1)
    best = subsets[torch.argmin(diam)]
    return _closest_pos(grads_rem, torch.mean(grads_rem[best], dim=0))


def _check(n: int, f: int) -> None:
    if n < 4 * f + 3:
        raise ValueError(f"bulyan requires n >= 4f+3, got n={n}, f={f}")


def _recurse(dist2: torch.Tensor, f: int, pos: Callable) -> torch.Tensor:
    """Phase 1's loop: ``pos(sub, rem, n_rem)`` names the winner's
    position among the remaining workers ``rem``."""
    n = dist2.shape[0]
    rem = torch.arange(n, device=dist2.device)
    picked = []
    for t in range(n - 2 * f):
        n_rem = n - t
        sub = dist2[rem[:, None], rem[None, :]]
        p = int(pos(sub, rem, n_rem))
        picked.append(rem[p])
        rem = torch.cat([rem[:p], rem[p + 1:]])
    return torch.stack(picked)


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
    _check(dist2.shape[0], f)
    if base not in ("krum", "geomed"):
        raise KeyError(f"distance-only selection needs krum/geomed, "
                       f"got {base!r}")
    if base == "krum":
        return _recurse(dist2, f, lambda sub, rem, n_rem:
                        _krum_pos(sub, f, n_rem))
    return _recurse(dist2, f, lambda sub, rem, n_rem: _geomed_pos(sub))


def select_indices(grads: torch.Tensor, f: int, base: str = "krum",
                   dist2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 1: ``(theta,)`` original-worker indices chosen by the
    recursion over any of the four bases.

    Args:
      grads: ``(n, d)`` worker rows.
      f: Byzantine bound; requires ``n >= 4f + 3``.
      base: ``"krum"``, ``"geomed"``, ``"average"`` or ``"brute"``.
      dist2: the ``(n, n)`` squared distances, when already computed.

    Returns:
      ``(theta,)`` int64 indices in pick order.  Raises ``KeyError`` for
      another base, as the reference does.
    """
    _check(grads.shape[0], f)
    if dist2 is None:
        dist2 = gars.pairwise_sq_dists(grads)
    if base == "krum":
        pos = lambda sub, rem, n_rem: _krum_pos(sub, f, n_rem)  # noqa: E731
    elif base == "geomed":
        pos = lambda sub, rem, n_rem: _geomed_pos(sub)  # noqa: E731
    elif base == "average":
        def pos(sub, rem, n_rem):
            g = grads[rem]
            return _closest_pos(g, torch.mean(g, dim=0))
    elif base == "brute":
        def pos(sub, rem, n_rem):
            return _brute_pos(sub, grads[rem], f, n_rem)
    else:
        raise KeyError(f"unsupported bulyan base {base!r}")
    return _recurse(dist2, f, pos)


def _row_prefix(s: torch.Tensor) -> torch.Tensor:
    """``(theta + 1, d)`` running sums of the rows, a zero row first.

    Added in row order in the input's dtype, as the reference's
    ``jnp.cumsum`` does on the CPU.  ``torch.cumsum`` would accumulate
    fp32 in float64 on the CPU and round each prefix once, which splits
    windows that tie in fp32.
    """
    acc = [torch.zeros_like(s[0])]
    for row in s:
        acc.append(acc[-1] + row)
    return torch.stack(acc)


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
    cd = _row_prefix(torch.abs(s - med[None, :]))
    cv = _row_prefix(s)
    n_win = theta - beta + 1
    win_dev = cd[beta:] - cd[:n_win]
    win_sum = cv[beta:] - cv[:n_win]
    w = torch.argmin(win_dev, dim=0)
    best = torch.take_along_dim(win_sum, w[None, :], dim=0)[0]
    return best / beta


def coordinate_phase_ref(selected: torch.Tensor, f: int) -> torch.Tensor:
    """The paper's formula taken literally (a stable argsort of
    ``|x - med|``): an independent oracle for :func:`coordinate_phase`.
    Exact ties may resolve differently.

    Args:
      selected: ``(theta, d)`` selected rows.
      f: Byzantine bound.

    Returns:
      ``(d,)`` per-coordinate mean of the beta values closest to the
      lower-middle median.
    """
    theta = selected.shape[0]
    beta = theta - 2 * f
    s = torch.sort(selected, dim=0).values
    med = s[(theta - 1) // 2]
    dist = torch.abs(selected - med[None, :])
    order = torch.argsort(dist, dim=0, stable=True)[:beta]
    closest = torch.take_along_dim(selected, order, dim=0)
    return torch.mean(closest, dim=0)


def make_bulyan(base: str = "krum",
                coordinate_impl: Optional[Callable] = None):
    """Build Bulyan(base) as a standard GAR callable.

    Args:
      base: ``"krum"``, ``"geomed"``, ``"average"`` or ``"brute"``
        (another base raises ``KeyError`` when the rule runs, as in the
        reference).
      coordinate_impl: phase 2, ``(stack, f) -> agg``
        (:func:`coordinate_phase` by default).

    Returns:
      ``bulyan(grads, f) -> AggResult``; ``selected`` marks the theta
      picks with 1.0 and ``scores`` is zeros, as in the reference.
    """
    cp = coordinate_impl or coordinate_phase

    def bulyan(grads: torch.Tensor, f: int) -> AggResult:
        n = grads.shape[0]
        idx = select_indices(grads, f, base=base)
        agg = cp(grads[idx], f)
        sel = torch.zeros((n,), dtype=grads.dtype, device=grads.device)
        sel[idx] = 1.0
        return AggResult(agg, sel, torch.zeros_like(sel))

    bulyan.__name__ = f"bulyan_{base}"
    return bulyan

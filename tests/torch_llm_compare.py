"""Comparisons the LLM train-step tests hold two runs to: the port
against the JAX reference on the CPU, the port on the card against
itself on the CPU, and the sharded step against the single-device one
(``tests/torch_mesh_check.py``, which ``chip_smoke.py`` phase 10 runs).
Numpy and torch only, so the card-only tests and ``chip_smoke.py`` can
use them where JAX is not installed; the torch functions run on the
tensors' own device, a column slice at a time.

A leaf is held at a tolerance of its own largest entry, so a leaf of
small values (a gradient, a parameter's change over a few steps) is
held as tightly as one of large values.  Bulyan's window may choose
differently on the two runs where two windows tie; those coordinates
are let off, as ``tests/test_torch_trainer.py`` does.
"""
import numpy as np
import torch

from repro_torch.kernels.fused_agg import select_weights_plain
from repro_torch.kernels.pairwise_gram import pairwise_gram_partial_plain

TOL = 1e-4
#: relative gap under which two Bulyan windows count as tied
TIE = 1e-5
#: the tie bit of :func:`leaf_windows`' codes (the bits below: the window)
TIED = 128
#: columns per slice of a float64 pass
SLICE = 2 ** 24


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.array(x))


def scaled_close(got, want, off=None, slack=0.0, tol=TOL, what=""):
    """``got`` against ``want`` at ``tol`` of ``want``'s largest entry,
    plus ``slack`` per coordinate, on the coordinates outside the flat
    mask ``off`` (``None``: all)."""
    got = _numpy(got).astype(np.float64).ravel()
    want = _numpy(want).astype(np.float64).ravel()
    assert got.shape == want.shape, what
    slack = np.broadcast_to(np.asarray(slack, dtype=np.float64).ravel(),
                            want.shape)
    if off is not None:
        keep = ~_numpy(off).ravel()
        got, want, slack = got[keep], want[keep], slack[keep]
    if not want.size:
        return
    err = np.abs(got - want)
    lim = tol * float(np.max(np.abs(want))) + slack
    worst = int(np.argmax(err - lim))
    assert err[worst] <= lim[worst], (what, float(err[worst]),
                                      float(lim[worst]))


def change_ratio(got, want, init, steps, off=None):
    """A parameter leaf's change from ``init`` against another run's:
    the worst ratio of its error to its limit, ``TOL`` of ``want``'s
    largest change plus one unit in the last place of ``want`` for each
    of the ``steps`` roundings of ``p + update`` (the two runs round
    independently), outside the flat mask ``off`` (``None``: all).

    Returns:
      A float; the leaf passes when it is ``<= 1`` (NaN fails).
    """
    w = _tensor(want).reshape(-1)
    g, p = (_tensor(x).reshape(-1).to(w.device) for x in (got, init))
    assert g.shape == w.shape == p.shape
    keep = None if off is None else ~_tensor(off).reshape(-1).to(w.device)
    scale = torch.zeros((), dtype=torch.float64, device=w.device)
    for c0 in range(0, w.numel(), SLICE):
        dw = w[c0:c0 + SLICE].double() - p[c0:c0 + SLICE].double()
        if keep is not None:
            dw = dw[keep[c0:c0 + SLICE]]
        if dw.numel():
            scale = torch.maximum(scale, dw.abs().max())
    worst = [torch.zeros((), dtype=torch.float64, device=w.device)]
    for c0 in range(0, w.numel(), SLICE):
        sl = slice(c0, c0 + SLICE)
        wa = w[sl].abs()
        ulp = (torch.nextafter(wa, torch.full_like(wa, np.inf))
               - wa).double()
        err = ((g[sl].double() - p[sl].double())
               - (w[sl].double() - p[sl].double())).abs()
        lim = TOL * scale + steps * ulp
        if keep is not None:
            err, lim = err[keep[sl]], lim[keep[sl]]
        if err.numel():
            worst.append((err / lim).max())
    # torch.stack(...).max() keeps a NaN, where max() would drop it
    return float(torch.stack(worst).max())


def close_change(got, want, init, steps, off=None, what=""):
    """Assert :func:`change_ratio` ``<= 1``."""
    ratio = change_ratio(got, want, init, steps, off)
    assert ratio <= 1.0, (what, ratio)


def leaf_windows(picked: torch.Tensor, f: int) -> torch.Tensor:
    """Bulyan's window choice per coordinate, and whether it rests on
    rounding, in float64 a column slice at a time.

    Args:
      picked: ``(theta, d)`` the phase-1 picks of one leaf (flattened).
      f: Byzantine bound; beta = theta - 2f values per window.

    Returns:
      ``(d,)`` uint8 codes: below bit 7 the index of the window of beta
      sorted values nearest the lower median (the first on ties, as the
      rule), in bit 7 (``TIED``) whether another window's deviation is
      within ``TIE`` (relative) of the best one's while its sum differs
      (by more than 1e-4 relative), so a run whose rounding differs may
      take it.
    """
    theta, d = picked.shape
    beta = theta - 2 * f
    assert theta - beta < TIED
    out = torch.zeros((d,), dtype=torch.uint8, device=picked.device)
    for c0 in range(0, d, SLICE):
        s = torch.sort(picked[:, c0:c0 + SLICE].double(), dim=0).values
        med = s[(theta - 1) // 2]
        devs = torch.stack([(s[i:i + beta] - med).abs().sum(0)
                            for i in range(theta - beta + 1)])
        sums = torch.stack([s[i:i + beta].sum(0)
                            for i in range(theta - beta + 1)])
        near = devs <= devs.min(dim=0).values * (1 + TIE)
        hi = torch.where(near, sums, -torch.inf).max(dim=0).values
        lo = torch.where(near, sums, torch.inf).min(dim=0).values
        tie = (hi - lo) > 1e-4 * torch.maximum(hi.abs(), lo.abs())
        out[c0:c0 + SLICE] = (torch.argmin(devs, dim=0)
                              + TIED * tie).to(torch.uint8)
    return out


def let_off(a, b):
    """Per leaf, a mask of the coordinates where Bulyan's window choice
    may legitimately differ between two runs: over all steps, tied on
    either run's submissions, or chosen differently on the two.  There
    the rounding noise between the runs flips the choice, and with it
    the coordinate's aggregate; after a step the two runs' parameters
    differ on those coordinates, so later submissions differ by more
    than rounding.

    Args:
      a, b: per step, per leaf, the two runs' :func:`leaf_windows`
        codes.
    """
    masks = None
    for wa, wb in zip(a, b):
        step = [((x | y) & TIED).bool() | ((x ^ y) & (TIED - 1)).bool()
                for x, y in zip(wa, wb)]
        masks = step if masks is None else [
            m | x for m, x in zip(masks, step)]
    return masks


def windows(leaves, f, w=None):
    """Per leaf, :func:`leaf_windows` of Bulyan(krum)'s picks of these
    submissions (on the CPU), and the selection weights used (``w``, or
    the first stack's, so two stacks are windowed over the same
    picks)."""
    n = leaves[0].shape[0]
    flat = [torch.as_tensor(np.array(_numpy(l))).reshape(n, -1)
            .to(torch.float32) for l in leaves]
    if w is None:
        w = select_weights_plain(pairwise_gram_partial_plain(
            torch.cat(flat, dim=1)), n, f, "bulyan-krum")[0]
    return [leaf_windows(w @ x, f) for x in flat], w


def window_ties(aleaves, bleaves, f):
    """Per leaf, :func:`let_off`'s flat mask for one step of two runs,
    from their submissions, windowed over the first run's picks."""
    ca, w = windows(aleaves, f)
    cb, _ = windows(bleaves, f, w)
    return let_off([ca], [cb])

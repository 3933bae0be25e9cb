"""Comparisons the LLM train-step tests hold two runs to: the port
against the JAX reference on the CPU, and the port on the card against
itself on the CPU.  Numpy and torch only, so the card-only tests can use
them where JAX is not installed.

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


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


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


def close_change(got, want, init, steps, off=None, what=""):
    """A parameter leaf's change from ``init`` at ``TOL`` of ``want``'s
    largest change, plus one fp32 unit in the last place of the parameter
    for each of the ``steps`` roundings of ``p + update`` (the two runs
    round independently)."""
    want = _numpy(want)
    init = _numpy(init).astype(np.float64)
    scaled_close(_numpy(got).astype(np.float64) - init,
                 want.astype(np.float64) - init, off,
                 slack=steps * np.spacing(np.abs(want)), what=what)


def windows(leaves, f, w=None):
    """Bulyan(krum)'s window on these submissions, per coordinate of the
    concatenated leaves: ``(choice, tie, w)``, the index of the window
    of beta sorted values nearest the medoid (first one on ties, as the
    rule), a mask of the coordinates where another window's deviation is
    within 1e-5 of the best one's and its sum differs, and the selection
    weights used (the first stack's, so two stacks are windowed over the
    same picks)."""
    n = leaves[0].shape[0]
    full = torch.cat([torch.as_tensor(np.array(_numpy(l))).reshape(n, -1)
                      .to(torch.float32) for l in leaves], dim=1)
    if w is None:
        w = select_weights_plain(pairwise_gram_partial_plain(full), n, f,
                                 "bulyan-krum")[0]
    s = torch.sort((w @ full).double(), dim=0).values
    theta = s.shape[0]
    beta = theta - 2 * f
    med = s[(theta - 1) // 2]
    devs = torch.stack([(s[i:i + beta] - med).abs().sum(0)
                        for i in range(theta - beta + 1)])
    sums = torch.stack([s[i:i + beta].sum(0)
                        for i in range(theta - beta + 1)])
    near = devs <= devs.min(dim=0).values * (1 + 1e-5)
    hi = torch.where(near, sums, -torch.inf).max(dim=0).values
    lo = torch.where(near, sums, torch.inf).min(dim=0).values
    tie = (hi - lo) > 1e-4 * torch.maximum(hi.abs(), lo.abs())
    return torch.argmin(devs, dim=0), tie, w


def window_ties(aleaves, bleaves, f):
    """Per leaf, a flat mask of the coordinates where Bulyan's window
    choice may legitimately differ between two runs: tied on either
    run's submissions, or chosen differently on the two.  There the
    rounding noise between the runs flips the choice, and with it the
    coordinate's aggregate; after a step the two runs' parameters differ
    on those coordinates, so later submissions differ by more than
    rounding."""
    ac, at, w = windows(aleaves, f)
    bc, bt, _ = windows(bleaves, f, w)
    mask = at | bt | (ac != bc)
    return list(torch.split(mask, [_numpy(l)[0].size for l in aleaves]))

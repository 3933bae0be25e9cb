"""The register form of the port's coordinate kernels, transcribed in
numpy float32 from ``src/repro_torch/csrc/common.cuh``, and the
comparisons the CPU parity tests hold it to.

K2 (``bulyan_select``), K3 (``coord_stats``) and K4 hold one
coordinate's values in registers padded with +inf to a size bucket,
sort them with Batcher's network fixed at compile time (``fminf`` /
``fmaxf``, which drop NaN, so a flag carries it), and run Bulyan's
window by running prefix sums over a barrel-shifted copy.  Means scale
by the rounded reciprocal of their count, as XLA rewrites the
reference's division by a constant.  The test files hold these against
the JAX reference bit for bit.
"""
import numpy as np

_F32 = np.float32


def bucket_of(m):
    """The size bucket of m values (``common.cuh::bucket_of``)."""
    return (m + 7) // 8 * 8 if m <= 48 else 64


def batcher_network(m):
    """Batcher's odd-even merge sort over the next power of two, only the
    comparators whose both slots are below m (``batcher_network``)."""
    big = 1
    while big < m:
        big *= 2
    net, p = [], 1
    while p < big:
        k = p
        while k >= 1:
            j = k % p
            while j + k < big:
                for i in range(min(k, big - j - k)):
                    if ((i + j) // (2 * p) == (i + j + k) // (2 * p)
                            and i + j + k < m):
                        net.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return net


def register_sort(rows):
    """(m, d) values -> ((M, d) sorted with +inf padding, (d,) NaN flag):
    fminf / fmaxf drop NaN, so the flag carries it."""
    m, d = rows.shape
    v = np.full((bucket_of(m), d), np.inf, dtype=_F32)
    v[:m] = rows
    nan = np.isnan(v).any(axis=0)
    for a, b in batcher_network(v.shape[0]):
        lo = np.fmin(v[a], v[b])
        v[b] = np.fmax(v[a], v[b])
        v[a] = lo
    return v, nan


def recip(k):
    return _F32(1) / _F32(k)


def median_regs(s, n):
    if n % 2:
        return s[n // 2]
    return (_F32(0.5) * (s[n // 2 - 1] + s[n // 2])).astype(_F32)


def trimmed_mean_regs(s, n, f):
    acc = s[f].copy()
    for r in range(f + 1, n - f):
        acc = (acc + s[r]).astype(_F32)
    return (acc * recip(n - 2 * f)).astype(_F32)


def bulyan_window_regs(s, theta, f):
    """Running prefix sums over s and over lo = s shifted up by beta."""
    beta = theta - 2 * f
    med = s[(theta - 1) // 2]
    if beta == theta:
        acc = s[0].copy()
        for r in range(1, theta):
            acc = (acc + s[r]).astype(_F32)
        return (acc * recip(beta)).astype(_F32)
    lo = s.copy()
    b = 0
    while (1 << b) < s.shape[0]:
        sh = 1 << b
        if beta & sh:
            lo[sh:] = lo[:-sh].copy()
        b += 1
    zero = np.zeros_like(med)
    pv_lo, pd_lo, pv_hi, pd_hi = zero, zero, zero, zero
    best_dev, best_sum = zero, zero
    for r in range(theta):
        pv_hi = (pv_hi + s[r]).astype(_F32)
        pd_hi = (pd_hi + np.abs(s[r] - med)).astype(_F32)
        if r >= beta:
            pv_lo = (pv_lo + lo[r]).astype(_F32)
            pd_lo = (pd_lo + np.abs(lo[r] - med)).astype(_F32)
        if r >= beta - 1:
            dev = (pd_hi - pd_lo).astype(_F32)
            take = np.full(dev.shape, r == beta - 1) | (dev < best_dev)
            best_dev = np.where(take, dev, best_dev)
            best_sum = np.where(take, (pv_hi - pv_lo).astype(_F32),
                                best_sum)
    return (best_sum * recip(beta)).astype(_F32)


def same(got, want):
    """Bit for bit up to the sign of zero, NaN in the same places."""
    got = np.asarray(got, dtype=_F32)
    want = np.asarray(want, dtype=_F32)
    assert got.shape == want.shape
    bad = ~((got == want) | (np.isnan(got) & np.isnan(want)))
    assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5],
                           want[bad][:5])


def close_nan(got, want, tol):
    """NaN in the same places, the rest (infinities included) within tol
    of max(1, max |finite want|)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf])
    ok = np.isfinite(want)
    if ok.any():
        scale = max(1.0, float(np.max(np.abs(want[ok]))))
        assert float(np.max(np.abs(got[ok] - want[ok]))) <= tol * scale

"""Port parity of K4 (``fused_coordinate``) and K3 (``coord_stats``) on
stacks that hold inf, NaN and -0.0, and of their register algorithm.

The reference contracts each slab with the selection weights by
``dot_general`` (``repro/kernels/fused_agg.py:246 _combine_tile``), so a
zero weight times an inf is NaN: an inf in an unselected row makes its
coordinate NaN, an inf in Krum's picked row stays inf, and a picked -0.0
comes out +0.0.  Its odd-even network spreads one NaN to every position
of a column.  These tests hold the port's plain versions to that on the
same numpy inputs, in all 7 modes, with the selection's weights,
all-zero weights and general (convex) weights.

The kernels (``csrc/fused_agg.cu``, ``csrc/combine.cuh``,
``csrc/common.cuh``) decode each weight row once into a pick, then per
coordinate gather the picked values (NaN when another row is not finite
there; Bulyan's distinct picks are NaN as soon as any row is), sort them
in registers with Batcher's network padded with +inf to a size bucket
and a NaN flag, and run Bulyan's window by running prefix sums over a
barrel-shifted copy.  :func:`combine_transcription` and
:func:`coord_stats_transcription` transcribe that in numpy float32 and
are held against the JAX reference bit for bit (``np.array_equal``,
which does not see the sign of a zero); a general weight row's fmaf
chain is held at 1e-5, the reference reducing in its own order.  The
means scale by the rounded reciprocal of their count, as XLA rewrites
the reference's division by a constant.  The kernels themselves run
only on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import coord_stats as jax_coord_stats  # noqa: E402
from repro.kernels import fused_agg as jfused  # noqa: E402
from repro.kernels.pairwise_gram import (  # noqa: E402
    pairwise_gram as jax_gram)
from repro_torch.kernels import fused_agg as tfused  # noqa: E402
from repro_torch.kernels.coord_stats import coord_stats_plain  # noqa: E402
from torch_register_form import (  # noqa: E402
    batcher_network, bucket_of, bulyan_window_regs, close_nan, median_regs,
    register_sort, same, trimmed_mean_regs)

FP32_TOL = 1e-4
BF16_TOL = 5e-2
_F32 = np.float32
ROW_ZERO, ROW_GENERAL = -1, -2


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# K4's weight decode and gather, transcribed from csrc/combine.cuh and
# fused_agg.cu (the register sort and window: torch_register_form.py)
# ---------------------------------------------------------------------------

def decode_rows(w):
    """Per weight row: the picked row of a one-hot row (one nonzero entry,
    exactly 1.0), ROW_ZERO, or ROW_GENERAL (NaN counts as nonzero)."""
    kinds = []
    for row in w:
        nz = np.flatnonzero(row != 0)
        if nz.size == 0:
            kinds.append(ROW_ZERO)
        elif nz.size == 1 and row[nz[0]] == 1:
            kinds.append(int(nz[0]))
        else:
            kinds.append(ROW_GENERAL)
    return kinds


def chain_rows(x, w):
    """(theta_w, d): each weight row's fmaf chain in row order from +0.0
    (``combine.cuh::chain_column``; the product is exact in float64)."""
    y = np.zeros((w.shape[0], x.shape[1]), dtype=_F32)
    for i in range(x.shape[0]):
        prod = w[:, i:i + 1].astype(np.float64) * x[i].astype(np.float64)
        y = (prod + y).astype(_F32)
    return y


def single_row(x, w):
    """The one weight row of krum / geomed / multikrum
    (``combine.cuh::single_row``): NaN where a row other than the pick
    is not finite, else x[pick] + 0.0; an all-zero row gives +0.0."""
    (kind,) = decode_rows(w)
    if kind == ROW_GENERAL:
        return chain_rows(x, w)[0]
    bad = (~np.isfinite(x)).sum(axis=0)
    v = x[kind] + _F32(0) if kind >= 0 else np.zeros(x.shape[1], _F32)
    own = (~np.isfinite(v)).astype(int)
    return np.where(bad - own > 0, np.nan, v).astype(_F32)


def bulyan_rows(x, w):
    """Bulyan's theta_w rows' values and NaN flag per coordinate
    (``fused_agg.cu::combine_bulyan_kernel``): distinct one-hot picks
    gather the picked rows and flag any row that is not finite (every
    other row is then read for its finiteness only); any other matrix
    takes the fmaf chain and flags its NaN."""
    kinds = decode_rows(w)
    if min(kinds) >= 0 and len(set(kinds)) == len(kinds):
        return x[kinds], (~np.isfinite(x)).any(axis=0)
    y = chain_rows(x, w)
    return y, np.isnan(y).any(axis=0)


@np.errstate(invalid="ignore")
def combine_transcription(x, w, f, mode):
    """K4 on a float32 (n, d) stack (inf - inf and 0 * inf are NaN, as
    on the card)."""
    n = x.shape[0]
    if mode in ("cwmed", "trimmed_mean"):
        s, nan = register_sort(x)
        out = (median_regs(s, n) if mode == "cwmed"
               else trimmed_mean_regs(s, n, f))
        return np.where(nan, np.nan, out).astype(_F32)
    if not mode.startswith("bulyan"):
        return single_row(x, w)
    y, bad = bulyan_rows(x, w)
    s, nan = register_sort(y)
    return np.where(nan | bad, np.nan,
                    bulyan_window_regs(s, y.shape[0], f)).astype(_F32)


@np.errstate(invalid="ignore")
def coord_stats_transcription(x, f):
    """K3 on a float32 (n, d) stack: (median, trimmed mean)."""
    n = x.shape[0]
    s, nan = register_sort(x)
    return (np.where(nan, np.nan, median_regs(s, n)).astype(_F32),
            np.where(nan, np.nan, trimmed_mean_regs(s, n, f)).astype(_F32))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

CASES = ("finite", "inf in an unselected row", "inf in a picked row",
         "NaN", "-0.0 in a picked row", "all-zero weights",
         "picks, then all-zero rows", "a row picked twice",
         "general weights")
COORD_CASES = ("finite", "inf in one row", "inf in f + 1 rows",
               "-inf and NaN", "-0.0 in every row", "ties")
COLS = [0, 3, 100, 254, 255]


def _stack(n, d, seed):
    """Gradient-like rows, the last f identical just off the mean."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 0.5 + 1.0).astype(_F32)


def _weights(x, f, mode):
    """The reference's selection weights on x's distances."""
    d2 = jax_gram(jnp.asarray(x), interpret=True)
    return np.array(jfused.select_weights(d2, x.shape[0], f, mode)[0])


def _case(case, n, f, mode, seed=7, d=256):
    """(stack, weights) of one case; weights None for coordinate modes."""
    x = _stack(n, d, seed)
    if mode in ("cwmed", "trimmed_mean"):
        half = COLS[:2], COLS[2:]
        if case == "inf in one row":
            x[0, COLS] = np.inf
        elif case == "inf in f + 1 rows":
            x[:f + 1, COLS] = np.inf
        elif case == "-inf and NaN":
            x[1, half[0]] = -np.inf
            x[2, half[1]] = np.nan
        elif case == "-0.0 in every row":
            x[:, COLS] = -0.0
        elif case == "ties":
            x = np.round(x * 2) / 2
        return x.astype(_F32), None
    w = _weights(x, f, mode)
    picked = int(np.flatnonzero(w[0])[0])
    unsel = int(np.flatnonzero(~(w != 0).any(axis=0))[0])
    if case == "inf in an unselected row":
        x[unsel, COLS] = np.inf
    elif case == "inf in a picked row":
        x[picked, COLS] = np.inf
    elif case == "NaN":
        x[unsel, COLS[:2]] = np.nan
        x[picked, COLS[2:]] = np.nan
    elif case == "-0.0 in a picked row":
        x[picked, COLS] = -0.0
    elif case == "all-zero weights":
        x[unsel, COLS] = np.inf
        w = np.zeros_like(w)
    elif case == "picks, then all-zero rows":
        x[unsel, COLS[:2]] = np.inf
        w[(w.shape[0] + 1) // 2:] = 0
    elif case == "a row picked twice":
        x[picked, COLS[:2]] = np.inf
        x[unsel, COLS[2:3]] = -np.inf
        w[-1] = w[0]
    elif case == "general weights":
        rng = np.random.default_rng(seed + 1)
        w = rng.random(w.shape).astype(_F32)
        w[w < 0.4] = 0
        x[unsel, COLS[:2]] = np.inf
        x[picked, COLS[2:]] = -np.inf
    return x, w


def _jax_combine(x, w, f, mode):
    return np.array(jfused.fused_coordinate(
        jnp.asarray(x), None if w is None else jnp.asarray(w), f,
        mode=mode, interpret=True))


def _is_general(w):
    return w is not None and ROW_GENERAL in decode_rows(w)


def _mode_cases():
    for mode in jfused.FUSED_MODES:
        cases = (COORD_CASES if mode in ("cwmed", "trimmed_mean")
                 else CASES)
        for case in cases:
            yield mode, case


MODE_CASES = list(_mode_cases())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", sorted({bucket_of(m) for m in range(1, 65)}))
def test_register_network_sorts_every_count_of_its_bucket(m):
    """The pruned network sorts any m' <= m values padded with +inf,
    ties, infinities and -0.0 included (values compared, so -0.0 and
    +0.0 may swap)."""
    rng = np.random.default_rng(m)
    for count in range(max(1, m - 7), m + 1):
        rows = np.round(rng.standard_normal((count, 400)) * 3) / 2
        rows[rng.random(rows.shape) < 0.05] = np.inf
        rows[rng.random(rows.shape) < 0.05] = -np.inf
        rows[rng.random(rows.shape) < 0.05] = -0.0
        s, nan = register_sort(rows.astype(_F32))
        assert not nan.any()
        assert np.array_equal(s[:count], np.sort(rows, axis=0))
        assert np.isposinf(s[count:]).all()


def test_network_sizes_and_buckets():
    """The comparator counts the kernels unroll (kMaxComparators = 543
    at 64) and the buckets the C dispatch uses."""
    counts = {m: len(batcher_network(m)) for m in (8, 16, 24, 32, 40, 48,
                                                   64)}
    assert counts == {8: 19, 16: 63, 24: 132, 32: 191, 40: 305, 48: 384,
                      64: 543}
    assert [bucket_of(m) for m in (1, 8, 9, 21, 39, 41, 48, 49, 64)] == [
        8, 8, 16, 24, 40, 48, 48, 64, 64]


@pytest.mark.parametrize("n,f", [(39, 9), (11, 2)])
@pytest.mark.parametrize("mode,case", MODE_CASES)
def test_transcription_is_the_reference_bit_for_bit(mode, case, n, f):
    x, w = _case(case, n, f, mode)
    got = combine_transcription(x, w, f, mode)
    want = _jax_combine(x, w, f, mode)
    if _is_general(w):
        close_nan(got, want, 1e-5)
    else:
        same(got, want)


@pytest.mark.parametrize("mode,case", MODE_CASES)
def test_plain_version_is_the_reference(mode, case):
    n, f = 39, 9
    x, w = _case(case, n, f, mode)
    want = _jax_combine(x, w, f, mode)
    got = tfused.fused_coordinate_plain(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w), f,
        mode=mode)
    close_nan(got.numpy(), want, FP32_TOL)
    if case == "-0.0 in a picked row" and mode in ("krum", "geomed"):
        assert not np.signbit(got.numpy()[COLS]).any()
        assert not np.signbit(want[COLS]).any()
    if case in ("inf in an unselected row", "all-zero weights"):
        assert np.isnan(want[COLS]).all()
    if case == "inf in a picked row" and mode in ("krum", "geomed"):
        assert np.isposinf(want[COLS]).all()


@pytest.mark.parametrize("mode", jfused.FUSED_MODES)
def test_plain_version_is_the_reference_in_bf16(mode):
    """bf16 stacks widen to fp32 in both packages, so the inf and NaN
    rules carry over."""
    case = "NaN" if mode in jfused.DIST_MODES else "-inf and NaN"
    x, w = _case(case, 39, 9, mode)
    want = np.array(jfused.fused_coordinate(
        jnp.asarray(x).astype(jnp.bfloat16),
        None if w is None else jnp.asarray(w), 9, mode=mode,
        interpret=True))
    got = tfused.fused_coordinate_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        None if w is None else torch.from_numpy(w), 9, mode=mode)
    close_nan(got.numpy(), want, BF16_TOL)


@pytest.mark.parametrize("n,f", [(3, 1), (8, 3), (9, 2), (33, 5), (39, 9),
                                 (40, 9), (41, 20), (64, 15)])
def test_coord_stats_transcription_and_plain_are_the_reference(n, f):
    x = _stack(n, 256, n)
    x[n // 2, 7] = np.nan
    x[0, 9] = np.inf
    x[:, 11] = -0.0
    x[1:3, 13] = -np.inf
    wm, wt = jax_coord_stats(jnp.asarray(x), f, interpret=True)
    gm, gt = coord_stats_transcription(x, f)
    same(gm, wm)
    same(gt, wt)
    pm, pt = coord_stats_plain(torch.from_numpy(x), f)
    close_nan(pm.numpy(), np.array(wm), FP32_TOL)
    close_nan(pt.numpy(), np.array(wt), FP32_TOL)
    assert np.isnan(np.array(wm)[7]) and np.isnan(np.array(wt)[7])


@pytest.mark.parametrize("n,f", [(3, 0), (7, 1), (16, 0), (17, 0), (25, 1),
                                 (40, 4), (44, 0), (49, 0), (64, 15)])
def test_bulyan_window_at_every_theta_bucket(n, f):
    """theta = n - 2f in every size bucket and at its edges, with picks
    in a shuffled order (the sort must not care) and a NaN and an inf in
    picked rows."""
    theta = n - 2 * f
    rng = np.random.default_rng(n)
    x = np.round(_stack(n, 256, n) * 8) / 8           # ties
    picks = rng.permutation(n)[:theta]
    w = np.zeros((theta, n), dtype=_F32)
    w[np.arange(theta), picks] = 1
    x[picks[0], 5] = np.nan
    x[picks[-1], 6] = np.inf
    x[picks[1], 8] = -0.0
    want = _jax_combine(x, w, f, "bulyan-krum")
    same(combine_transcription(x, w, f, "bulyan-krum"), want)
    got = tfused.fused_coordinate_plain(torch.from_numpy(x),
                                        torch.from_numpy(w), f,
                                        mode="bulyan-krum")
    close_nan(got.numpy(), want, FP32_TOL)


def test_decode_rows():
    w = np.array([[0, 1, 0], [0, 0, 0], [0, 0.5, 0.5], [1, 1, 0],
                  [0, 2, 0], [-0.0, 1, -0.0], [np.nan, 0, 0]], dtype=_F32)
    assert decode_rows(w) == [1, ROW_ZERO, ROW_GENERAL, ROW_GENERAL,
                              ROW_GENERAL, 1, ROW_GENERAL]

"""Port parity of the selection on worker stacks that hold a NaN, and of
the sort-once selection algorithm of ``csrc/fused_agg.cu``.

A Byzantine worker may send a gradient with a NaN coordinate.  The
reference's odd-even network (``jnp.minimum`` / ``jnp.maximum``) spreads
one NaN to every position of its column, so every Krum score of such a
column is NaN and the first-index argmin then picks no one; ``jnp.median``
returns NaN for a column that holds one.  These tests hold the port's
plain versions to both behaviours on the same numpy inputs.

The selection kernel sorts each column of the distance matrix once and,
in every round, sums the first ``k`` entries of that order whose row is
still available.  :func:`sort_once_select` below transcribes that
algorithm (one column sort, a walk over available rows, a NaN flag and a
NaN-propagating first-index argmin) in numpy float32, and hypothesis
holds it bit for bit against JAX's ``select_weights`` on symmetric
matrices with ties, zeros, +inf and NaN (Krum's modes; GeoMed's sums
follow the kernel's row order, which the reference's ``jnp.sum`` does
not, so there it is held bit for bit against the port's plain version
and to rounding against the reference).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.dist import robust as jrobust  # noqa: E402
from repro.kernels import fused_agg as jfused  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pairwise_gram import (  # noqa: E402
    pairwise_gram as jax_gram)
from repro_torch.core import gars  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.kernels import fused_agg as tfused  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FP32_TOL = 1e-4
_F32 = np.float32
_INF = _F32(np.inf)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _nan_stack(n=11, d=50, row=10, col=3, seed=23):
    """The fault's input: one worker with one NaN coordinate."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 0.5 + 1.0).astype(np.float32)
    x[row, col] = np.nan
    return x


def _same(got, want):
    """Equal values, NaN in the same places (bit for bit up to the sign
    of zero, which no comparison of the rules can see)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=True), (got, want)


def _close_nan(got, want, tol=FP32_TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        scale = max(1.0, float(np.max(np.abs(want[ok]))))
        assert np.max(np.abs(got[ok] - want[ok])) <= tol * scale


# ---------------------------------------------------------------------------
# the two repaired faults
# ---------------------------------------------------------------------------

class TestNaNSelection:
    @pytest.mark.parametrize("mode", jfused.DIST_MODES)
    def test_select_weights_matches_reference(self, mode):
        n, f = 11, 2
        d2 = np.array(jax_gram(jnp.asarray(_nan_stack()), interpret=True))
        w, sel, scores = jfused.select_weights(jnp.asarray(d2), n, f, mode)
        tw, tsel, tscores = tfused.select_weights(torch.from_numpy(d2), n,
                                                  f, mode)
        _same(tw.numpy(), w)
        _same(tsel.numpy(), sel)
        _same(tscores.numpy(), scores)

    @pytest.mark.parametrize("mode", ["bulyan-krum", "krum", "multikrum"])
    def test_one_nan_entry_scores_its_two_columns_nan(self, mode):
        """A NaN distance between two honest workers (not a NaN row)."""
        n, f = 11, 2
        d2 = np.array(jax_gram(jnp.asarray(_nan_stack()[:, :3]),
                               interpret=True))
        d2 = np.nan_to_num(d2)
        d2[2, 5] = d2[5, 2] = np.nan
        w, sel, scores = jfused.select_weights(jnp.asarray(d2), n, f, mode)
        tw, tsel, tscores = tfused.select_weights(torch.from_numpy(d2), n,
                                                  f, mode)
        _same(tw.numpy(), w)
        _same(tsel.numpy(), sel)
        _same(tscores.numpy(), scores)
        if mode != "bulyan-krum":
            assert np.isnan(tscores.numpy()[0, [2, 5]]).all()

    @pytest.mark.parametrize("mode", jfused.FUSED_MODES)
    def test_fused_aggregate_matches_reference(self, mode):
        n, f = 11, 2
        x = _nan_stack(d=300)
        agg, sel, scores = jfused.fused_aggregate(
            jnp.asarray(x), f, mode=mode, block_d=128, interpret=True)
        tagg, tsel, tscores = tfused.fused_aggregate(
            torch.from_numpy(x), f, mode=mode, block_d=128)
        _close_nan(tagg.numpy(), agg)
        _same(tsel.numpy(), sel)
        _same(tscores.numpy(), scores)


class TestNaNMedian:
    @pytest.mark.parametrize("n", [39, 40])
    def test_flat_cwmed(self, n):
        y = _nan_stack(n=n, d=40, row=3, col=2)
        want = jrobust.distributed_aggregate({"w": jnp.asarray(y)}, 9,
                                             "cwmed")[0]["w"]
        got = gars.cwmed(torch.from_numpy(y), 9).gradient
        assert np.isnan(got.numpy()[2])
        _same(got.numpy(), want)

    def test_tree_cwmed(self):
        tree = {"a": _nan_stack(n=39, d=40, row=3, col=2),
                "b": _nan_stack(n=39, d=12, row=0, col=11, seed=4)
                .reshape(39, 3, 4)}
        want, _ = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, 9, "cwmed")
        got, _ = robust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, 9, "cwmed")
        for k in tree:
            _same(got[k].numpy(), want[k])

    @pytest.mark.parametrize("n", [39, 40])
    def test_coord_stats_ref(self, n):
        y = _nan_stack(n=n, d=40, row=3, col=2)
        want = jref.coord_stats_ref(jnp.asarray(y), 9)
        got = tref.coord_stats_ref(torch.from_numpy(y), 9)
        _same(got[0].numpy(), want[0])
        _close_nan(got[1].numpy(), want[1])


# ---------------------------------------------------------------------------
# the sort-once selection, transcribed from csrc/fused_agg.cu
# ---------------------------------------------------------------------------

def _finalized(raw):
    """The kernel's finalize: negatives (not NaN) to 0, diagonal * 0."""
    n = raw.shape[0]
    v = np.where(raw < 0, _F32(0), raw).astype(np.float32)
    return (v * (_F32(1) - np.eye(n, dtype=np.float32))).astype(np.float32)


def _argmin(scores):
    """First index of the NaN-propagating minimum; None when it is NaN."""
    m = scores[0]
    for s in scores[1:]:
        m = m if (np.isnan(m) or m < s) else s
    if np.isnan(m):
        return None
    return int(np.flatnonzero(scores == m)[0])


def _krum_round(dm, order, avail, k):
    """Every column's score: the sum, in sorted order, of its first k
    entries on available rows; NaN if an available entry is NaN."""
    n = dm.shape[0]
    out = np.full(n, _INF, dtype=np.float32)
    for j in range(n):
        if not avail[j]:
            continue
        if any(avail[i] and np.isnan(dm[i, j]) for i in order[j]):
            out[j] = np.nan
            continue
        s, taken = None, 0
        for i in order[j]:
            if taken == k:
                break
            if avail[i]:
                s = dm[i, j] if s is None else _F32(s + dm[i, j])
                taken += 1
        # fewer than k rows left: the reference adds masked +inf entries
        out[j] = _INF if taken < k else s
    return out


def _geomed_round(root, avail):
    """Row-order sums of sqrt(distance) over available rows (masked and
    infinite entries add 0)."""
    n = root.shape[0]
    out = np.full(n, _INF, dtype=np.float32)
    for j in range(n):
        if avail[j]:
            s = _F32(0)
            for i in range(n):
                v = root[i, j] if (avail[i] and i != j) else _F32(0)
                s = _F32(s + v)
            out[j] = s
    return out


def sort_once_select(raw, n, f, mode):
    """The selection kernel's algorithm: ``(weights, selected, scores)``
    as ``select_weights`` returns them."""
    dm = _finalized(np.asarray(raw, dtype=np.float32))
    # each column sorted once; NaN last, ties by row (any order of equal
    # values gives the same sums); the diagonal never takes part
    order = [[int(i) for i in np.argsort(dm[:, j], kind="stable") if i != j]
             for j in range(n)]
    root = np.sqrt(np.where(np.isinf(dm), _F32(0), dm)).astype(np.float32)
    avail = np.ones(n, dtype=bool)

    def scores_of(n_rem, krum):
        if krum:
            return _krum_round(dm, order, avail, max(1, n_rem - f - 2))
        return _geomed_round(root, avail)

    if mode in ("krum", "geomed"):
        sc = scores_of(n, mode == "krum")
        w = np.zeros((1, n), dtype=np.float32)
        p = _argmin(sc)
        if p is not None:
            w[0, p] = 1.0
        return w, w, sc[None]
    if mode == "multikrum":
        sc = scores_of(n, True)
        m = max(1, n - f - 2)
        acc = np.zeros(n, dtype=np.float32)
        cur = sc.copy()
        for _ in range(m):
            p = _argmin(cur)
            if p is not None:
                acc[p] += 1.0
                cur[p] = _INF
        w = (acc / _F32(m)).astype(np.float32)[None]
        return w, w, sc[None]
    theta = n - 2 * f
    w = np.zeros((theta, n), dtype=np.float32)
    for t in range(theta):
        p = _argmin(scores_of(n - t, mode == "bulyan-krum"))
        if p is not None:
            w[t, p] = 1.0
            avail[p] = False
    return w, w.sum(axis=0, keepdims=True), np.zeros((1, n), np.float32)


def _max_f(n, mode):
    """The largest f the mode's quorum allows (``_check_mode_shape``)."""
    if mode.startswith("bulyan"):
        return (n - 3) // 4
    if mode in ("krum", "multikrum"):
        return n - 3
    return n - 1


@st.composite
def _matrices(draw, n_max):
    """A finalized-looking symmetric (n, n) matrix from a few levels (so
    entries tie), with zeros, +inf and NaN sprinkled in."""
    n = draw(st.integers(3, n_max))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    levels = draw(st.integers(1, 2 * n * n))
    p_zero, p_inf, p_nan = (draw(st.sampled_from(p)) for p in (
        (0.0, 0.05, 0.3), (0.0, 0.02, 0.2), (0.0, 0.0, 0.01, 0.05)))
    rng = np.random.default_rng(seed)
    v = (rng.integers(1, levels + 1, (n, n)) * 0.37).astype(np.float32)
    u = rng.random((n, n))
    v[u < p_zero] = 0.0
    v[(u >= p_zero) & (u < p_zero + p_inf)] = np.inf
    v[(u >= p_zero + p_inf) & (u < p_zero + p_inf + p_nan)] = np.nan
    v = np.triu(v, 1)
    v = v + v.T
    np.fill_diagonal(v, 0.0)
    return v.astype(np.float32)


def _check_sort_once(d2, n, f, mode):
    """The transcription against the reference and the plain version."""
    want = jfused.select_weights(jnp.asarray(d2), n, f, mode)
    got = sort_once_select(d2, n, f, mode)
    plain = tfused.select_weights_plain(torch.from_numpy(d2), n, f, mode)
    for g, p in zip(got, plain):
        _same(g, p.numpy())
    if "geomed" not in mode:
        for g, w in zip(got, want):
            _same(g, w)
        return
    # GeoMed sums square roots in row order (the kernel's order); the
    # reference's jnp.sum reduces in XLA's order, so exactly tied scores
    # may differ by an ulp there and its argmin may pick another of the
    # tied workers.  Scores agree to rounding, NaN in the same places,
    # and a round picks someone in both or in neither.
    _close_nan(got[2], want[2])
    _same(got[0].sum(axis=1), np.asarray(want[0]).sum(axis=1))


@pytest.mark.parametrize("mode", jfused.DIST_MODES)
@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_sort_once_selection_is_the_reference_bit_for_bit(mode, data):
    d2 = data.draw(_matrices(64))
    n = d2.shape[0]
    f = data.draw(st.integers(0, _max_f(n, mode)))
    _check_sort_once(d2, n, f, mode)


@pytest.mark.parametrize("mode", jfused.DIST_MODES)
@pytest.mark.parametrize("n", [3, 4, 7, 38, 64])
def test_sort_once_selection_at_the_largest_f(mode, n):
    """The quorum edge, where the last Bulyan rounds have no neighbour
    left (f = 0 at n = 3) and Krum keeps one neighbour."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    d2 = np.array(jax_gram(jnp.asarray(x), interpret=True))
    _check_sort_once(d2, n, _max_f(n, mode), mode)

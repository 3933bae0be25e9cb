"""Port parity of the aggregation kernels: repro_torch.kernels against the
JAX reference's Pallas kernels in interpret mode.

On the CPU every wrapper of the port takes its plain PyTorch version, so
these tests hold the plain versions to the reference at the shapes of
tests/test_fused_agg.py (n = 11, f = 2, d = 300, block_d = 128; d edges;
odd / even n; the Bulyan quorum edge n = 4f + 3).  Tolerances are the
reference's: 1e-4 for fp32, 5e-2 for bf16 inputs with fp32 accumulation;
selections are compared exactly.  The CUDA kernels themselves run only on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.agg.specs import check_quorum as jax_check_quorum  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import fused_agg as jfused  # noqa: E402
from repro.kernels.pairwise_gram import (  # noqa: E402
    finalize_dists as jax_finalize, pairwise_gram_partial as jax_partial)
from repro_torch.agg.specs import check_quorum  # noqa: E402
from repro_torch.kernels import _build, common  # noqa: E402
from repro_torch.kernels import fused_agg as tfused  # noqa: E402
from repro_torch.kernels.pairwise_gram import (  # noqa: E402
    finalize_dists, pairwise_gram, pairwise_gram_partial,
    pairwise_gram_partial_plain)

FP32_TOL = 1e-4
BF16_TOL = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack(n, d, seed=23):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 0.5 + 1.0).astype(np.float32)


def _both(g, dtype="float32"):
    """The same values as a JAX array and a CPU torch tensor."""
    if dtype == "bfloat16":
        j = jnp.asarray(g).astype(jnp.bfloat16)
        return j, torch.from_numpy(g).to(torch.bfloat16)
    return jnp.asarray(g), torch.from_numpy(g)


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * scale, (
        np.max(np.abs(got - want)), scale)


# ---------------------------------------------------------------------------
# shared helpers (kernels/common.py)
# ---------------------------------------------------------------------------

class TestCommonHelpers:
    @pytest.mark.parametrize("m", [1, 2, 5, 8])
    def test_oe_sort_rows(self, m):
        rows = _stack(m, 64, seed=m)
        want = jcommon.oe_sort_rows([jnp.asarray(r) for r in rows])
        got = common.oe_sort_rows([torch.from_numpy(r) for r in rows])
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("theta,f", [(5, 0), (7, 1), (9, 2), (13, 3)])
    def test_bulyan_window(self, theta, f):
        rows = np.sort(_stack(theta, 100, seed=theta), axis=0)
        want = jcommon.bulyan_window([jnp.asarray(r) for r in rows], f)
        got = common.bulyan_window([torch.from_numpy(r) for r in rows], f)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_median_trap_even_n_averages_middle_pair(self):
        """jnp.median averages the two middle values; torch.median would
        return the lower one."""
        rows = [torch.tensor([float(v)]) for v in (1, 2, 3, 4)]
        assert float(common.coord_median(rows)[0]) == 2.5
        assert float(torch.median(torch.tensor([1., 2., 3., 4.]))) == 2.0
        want = jcommon.coord_median([jnp.asarray([float(v)])
                                     for v in (1, 2, 3, 4)])
        assert float(want[0]) == 2.5

    @pytest.mark.parametrize("n,f", [(5, 1), (6, 1), (9, 2)])
    def test_median_and_trimmed_mean(self, n, f):
        rows = np.sort(_stack(n, 50, seed=n), axis=0)
        jr = [jnp.asarray(r) for r in rows]
        tr = [torch.from_numpy(r) for r in rows]
        assert np.array_equal(common.coord_median(tr).numpy(),
                              np.asarray(jcommon.coord_median(jr)))
        assert np.array_equal(common.coord_trimmed_mean(tr, f).numpy(),
                              np.asarray(jcommon.coord_trimmed_mean(jr, f)))


# ---------------------------------------------------------------------------
# K1: Gram partial and finalize
# ---------------------------------------------------------------------------

class TestGram:
    @pytest.mark.parametrize("n,d", [(5, 64), (9, 129), (11, 300),
                                     (16, 1000)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_partial_matches_reference(self, n, d, dtype):
        j, t = _both(_stack(n, d) * 3.0, dtype)
        want = jax_partial(j, block_d=128, interpret=True)
        got = pairwise_gram_partial(t, block_d=128)
        tol = FP32_TOL if dtype == "float32" else BF16_TOL
        _close(got.numpy(), np.asarray(want), tol)

    def test_partials_over_slices_add_up(self):
        g = torch.from_numpy(_stack(7, 300))
        whole = pairwise_gram_partial(g, block_d=128)
        parts = (pairwise_gram_partial(g[:, :100].contiguous())
                 + pairwise_gram_partial(g[:, 100:].contiguous()))
        _close(parts.numpy(), whole.numpy(), FP32_TOL)

    def test_finalize_matches_reference(self):
        raw = _stack(6, 6) - 1.2          # has negatives and a diagonal
        want = jax_finalize(jnp.asarray(raw))
        got = finalize_dists(torch.from_numpy(raw))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.all(np.diag(got.numpy()) == 0.0)

    def test_pairwise_gram_is_finalized_partial(self):
        g = torch.from_numpy(_stack(7, 130))
        assert torch.equal(pairwise_gram(g, block_d=128),
                           finalize_dists(pairwise_gram_partial_plain(
                               g, block_d=128)))


# ---------------------------------------------------------------------------
# selection, K4 and K5
# ---------------------------------------------------------------------------

def _jax_dists(g):
    return jax_finalize(jax_partial(jnp.asarray(g), block_d=128,
                                    interpret=True))


class TestSelectWeights:
    @pytest.mark.parametrize("mode", jfused.DIST_MODES)
    def test_matches_reference(self, mode):
        n, f = 11, 2
        d2 = np.array(_jax_dists(_stack(n, 300)))
        w, sel, scores = jfused.select_weights(jnp.asarray(d2), n, f, mode)
        tw, tsel, tscores = tfused.select_weights(torch.from_numpy(d2), n, f,
                                                  mode)
        assert np.array_equal(tw.numpy(), np.asarray(w))
        assert np.array_equal(tsel.numpy(), np.asarray(sel))
        _close(tscores.numpy(), np.asarray(scores), FP32_TOL)

    def test_tied_byzantine_rows_first_index_wins(self):
        """Identical Byzantine rows tie exactly: the first one is picked
        (the aggregate would not tell; ``selected`` does)."""
        n, f = 11, 2
        g = _stack(n, 300)
        g[n - f:] = g.mean(axis=0)        # f identical central rows
        d2 = np.array(_jax_dists(g))
        w, sel, _ = jfused.select_weights(jnp.asarray(d2), n, f, "krum")
        tw, tsel, _ = tfused.select_weights(torch.from_numpy(d2), n, f,
                                            "krum")
        assert int(np.argmax(np.asarray(w))) == n - f
        assert np.array_equal(tsel.numpy(), np.asarray(sel))

    def test_raw_input_is_finalized_first(self):
        n, f = 11, 2
        t = torch.from_numpy(_stack(n, 300))
        raw = pairwise_gram_partial(t, block_d=128)
        for a, b in zip(tfused.select_weights(raw, n, f, "bulyan-krum"),
                        tfused.select_weights(finalize_dists(raw), n, f,
                                              "bulyan-krum")):
            assert torch.equal(a, b)


class TestFusedCoordinate:
    @pytest.mark.parametrize("mode", jfused.FUSED_MODES)
    def test_matches_reference(self, mode):
        n, f = 11, 2
        g = _stack(n, 300)
        if mode in jfused.COORD_MODES:
            w = None
        else:
            w = np.array(jfused.select_weights(_jax_dists(g), n, f,
                                                 mode)[0])
        want = jfused.fused_coordinate(
            jnp.asarray(g), None if w is None else jnp.asarray(w), f,
            mode=mode, block_d=128, interpret=True)
        got = tfused.fused_coordinate(
            torch.from_numpy(g), None if w is None else torch.from_numpy(w),
            f, mode=mode)
        _close(got.numpy(), np.asarray(want), FP32_TOL)

    def test_weights_contract_texts(self):
        g = torch.from_numpy(_stack(11, 40))
        with pytest.raises(ValueError, match="needs selection weights"):
            tfused.fused_coordinate(g, None, 2, mode="krum")
        with pytest.raises(ValueError, match="takes no selection weights"):
            tfused.fused_coordinate(g, torch.ones(1, 11), 2, mode="cwmed")


class TestFusedAggregate:
    @pytest.mark.parametrize("mode", jfused.FUSED_MODES)
    def test_matches_reference(self, mode):
        n, f = 11, 2
        j, t = _both(_stack(n, 300))
        agg, sel, scores = jfused.fused_aggregate(j, f, mode=mode,
                                                  block_d=128,
                                                  interpret=True)
        tagg, tsel, tscores = tfused.fused_aggregate(t, f, mode=mode,
                                                     block_d=128)
        _close(tagg.numpy(), np.asarray(agg), FP32_TOL)
        assert np.array_equal(tsel.numpy(), np.asarray(sel))
        _close(tscores.numpy(), np.asarray(scores), FP32_TOL)

    @pytest.mark.parametrize("mode", jfused.DIST_MODES)
    def test_is_gram_plus_select_plus_coordinate(self, mode):
        """K5 == K1 + select + K4, bit for bit."""
        n, f = 11, 2
        t = torch.from_numpy(_stack(n, 257))
        agg, sel, scores = tfused.fused_aggregate(t, f, mode=mode,
                                                  block_d=128)
        raw = pairwise_gram_partial(t, block_d=128)
        w, sel2, scores2 = tfused.select_weights(raw, n, f, mode)
        agg2 = tfused.fused_coordinate(t, w, f, mode=mode)
        assert torch.equal(agg, agg2)
        assert torch.equal(sel, sel2[0])
        assert torch.equal(scores, scores2[0])

    @pytest.mark.parametrize("d", [1, 100, 128, 129, 257])
    @pytest.mark.parametrize("mode", ["bulyan-krum", "cwmed"])
    def test_d_edges(self, mode, d):
        n, f = 11, 2
        j, t = _both(_stack(n, d))
        want = jfused.fused_aggregate(j, f, mode=mode, block_d=128,
                                      interpret=True)[0]
        got = tfused.fused_aggregate(t, f, mode=mode, block_d=128)[0]
        assert got.shape == (d,)
        _close(got.numpy(), np.asarray(want), FP32_TOL)

    @pytest.mark.parametrize("n", [5, 6])
    def test_median_branch_odd_even(self, n):
        g = _stack(n, 130)
        got = tfused.fused_aggregate(torch.from_numpy(g), 1,
                                     mode="cwmed")[0]
        _close(got.numpy(), np.asarray(jnp.median(jnp.asarray(g), axis=0)),
               1e-6)

    @pytest.mark.parametrize("f", [1, 2])
    @pytest.mark.parametrize("mode", ["bulyan-krum", "bulyan-geomed"])
    def test_exact_quorum(self, mode, f):
        n = 4 * f + 3
        j, t = _both(_stack(n, 200))
        agg, sel, _ = jfused.fused_aggregate(j, f, mode=mode, block_d=128,
                                             interpret=True)
        tagg, tsel, _ = tfused.fused_aggregate(t, f, mode=mode,
                                               block_d=128)
        _close(tagg.numpy(), np.asarray(agg), FP32_TOL)
        assert np.array_equal(tsel.numpy(), np.asarray(sel))

    @pytest.mark.parametrize("mode", ["bulyan-krum", "krum",
                                      "trimmed_mean"])
    def test_bf16_inputs(self, mode):
        n, f = 11, 2
        j, t = _both(_stack(n, 512), "bfloat16")
        agg, sel, _ = jfused.fused_aggregate(j, f, mode=mode, block_d=256,
                                             interpret=True)
        tagg, tsel, _ = tfused.fused_aggregate(t, f, mode=mode,
                                               block_d=256)
        _close(tagg.numpy(), np.asarray(agg), BF16_TOL)
        assert np.array_equal(tsel.numpy(), np.asarray(sel))


class TestErrorTexts:
    @pytest.mark.parametrize("n,f,mode", [
        (6, 1, "bulyan-krum"),      # below 4f + 3
        (3, 1, "krum"),             # krum needs n >= f + 3
        (4, 2, "trimmed_mean"),     # need n > 2f
        (65, 1, "cwmed"),           # n above the unroll bound
        (6, 1, "brute"),            # unknown mode
    ])
    def test_check_mode_shape_texts(self, n, f, mode):
        with pytest.raises((KeyError, ValueError)) as want:
            jfused._check_mode_shape(n, f, mode)
        with pytest.raises(want.type) as got:
            tfused._check_mode_shape(n, f, mode)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("gar,n,f", [("fused-bulyan-krum", 10, 2),
                                         ("krum", 4, 1),
                                         ("bulyan-geomed", 6, 1)])
    def test_check_quorum_texts(self, gar, n, f):
        with pytest.raises(ValueError) as want:
            jax_check_quorum(gar, n, f)
        with pytest.raises(ValueError) as got:
            check_quorum(gar, n, f)
        assert str(got.value) == str(want.value)


class TestDispatch:
    def test_cpu_tensor_takes_plain_version_and_counts_nothing(self):
        _build.reset_launches()
        t = torch.from_numpy(_stack(11, 64))
        tfused.fused_aggregate(t, 2, mode="bulyan-krum")
        assert all(v == 0 for v in _build.LAUNCHES.values())

    def test_other_devices_raise(self):
        t = torch.zeros((5, 8), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            pairwise_gram_partial(t)
        with pytest.raises(ValueError, match="unsupported device"):
            tfused.fused_aggregate(t, 1, mode="cwmed")


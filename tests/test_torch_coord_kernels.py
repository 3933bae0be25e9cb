"""Port parity of the coordinate kernels K2 (``bulyan_select``) and K3
(``coord_stats``), the oracles of ``kernels/ref.py``, the dispatcher
``kernels/ops.py`` and the fp32-contract probes of ``kernels/probes.py``.

On the CPU every wrapper of the port takes its plain PyTorch version, so
these tests hold the plain versions to the JAX reference's Pallas
kernels run with ``interpret=True``, on the shapes and at the
tolerances of tests/test_kernels.py (K2: rtol 2e-5 / atol 1e-5; K3:
rtol 1e-5 / atol 1e-6).  Inputs are made with numpy from a seed and
handed to both packages.  The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bulyan_select as jax_bulyan_select  # noqa: E402
from repro.kernels import coord_stats as jax_coord_stats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import probes as jprobes  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import ops, probes, ref  # noqa: E402
from repro_torch.kernels.bulyan_select import (  # noqa: E402
    bulyan_select, bulyan_select_plain)
from repro_torch.kernels.coord_stats import (  # noqa: E402
    coord_stats, coord_stats_plain)

PROBE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype="float32"):
    """The same values as a JAX array and a CPU torch tensor."""
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _allclose(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# K2: bulyan_select
# ---------------------------------------------------------------------------

class TestBulyanSelect:
    @pytest.mark.parametrize("theta,f", [(5, 0), (7, 1), (9, 2), (11, 2),
                                         (13, 3), (16, 3), (31, 7)])
    @pytest.mark.parametrize("d", [100, 129, 1024])
    def test_matches_reference_kernel(self, theta, f, d):
        j, t = _both(_normal((theta, d), seed=theta * d))
        want = jax_bulyan_select(j, f, block_d=256, interpret=True)
        got = bulyan_select(t, f, block_d=256)
        assert got.dtype == torch.float32 and got.shape == (d,)
        _allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes_accept_every_tie_optimal_window(self, dtype):
        """bf16 quantization makes window ties likely; any window of
        minimal deviation is a valid Bulyan output (the paper's arg min
        is a set), as tests/test_kernels.py accepts."""
        theta, f, d = 9, 2, 512
        beta = theta - 2 * f
        j, t = _both(_normal((theta, d), seed=7), dtype)
        out = bulyan_select(t, f).numpy()
        _allclose(out, jax_bulyan_select(j, f, interpret=True),
                  rtol=2e-5, atol=1e-5)
        sv = np.sort(t.to(torch.float32).numpy(), axis=0)
        med = sv[(theta - 1) // 2]
        devs = [np.abs(sv[w:w + beta] - med).sum(0)
                for w in range(theta - beta + 1)]
        best = np.min(devs, axis=0)
        eps = 1e-5 if dtype == "float32" else 1e-2
        ok = np.zeros((d,), bool)
        for w, dev in enumerate(devs):
            mean = sv[w:w + beta].mean(0)
            ok |= ((dev <= best * (1 + eps) + eps)
                   & (np.abs(out - mean) <= 1e-2 + 1e-3 * np.abs(mean)))
        assert ok.all(), f"{(~ok).sum()} coords not a tie-optimal mean"

    def test_block_size_invariance(self):
        t = torch.from_numpy(_normal((11, 1000), seed=3))
        outs = [bulyan_select(t, 2, block_d=b) for b in (128, 256, 1024)]
        for o in outs[1:]:
            assert torch.equal(outs[0], o)

    def test_nan_propagates_like_the_reference(self):
        x = _normal((9, 300), seed=5)
        x[3, 7] = np.nan
        j, t = _both(x)
        want = np.asarray(jax_bulyan_select(j, 2, block_d=128,
                                            interpret=True))
        got = bulyan_select(t, 2, block_d=128).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        _allclose(np.nan_to_num(got), np.nan_to_num(want), 2e-5, 1e-5)

    def test_beta_check_text(self):
        t = torch.zeros((5, 10))
        with pytest.raises(ValueError) as got:
            bulyan_select(t, 3)
        with pytest.raises(ValueError) as want:
            jax_bulyan_select(jnp.zeros((5, 10)), 3, interpret=True)
        assert str(got.value) == str(want.value)

    def test_plain_version_is_what_the_cpu_takes(self):
        t = torch.from_numpy(_normal((13, 700), seed=9))
        assert torch.equal(bulyan_select(t, 3), bulyan_select_plain(t, 3))


# ---------------------------------------------------------------------------
# K3: coord_stats
# ---------------------------------------------------------------------------

class TestCoordStats:
    @pytest.mark.parametrize("n,f,d", [(7, 1, 200), (9, 2, 1000),
                                       (16, 3, 513), (15, 0, 128)])
    def test_matches_reference_kernel(self, n, f, d):
        j, t = _both(_normal((n, d), seed=n * d, scale=2.0))
        wmed, wtrim = jax_coord_stats(j, f, block_d=256, interpret=True)
        med, trim = coord_stats(t, f, block_d=256)
        assert med.dtype == trim.dtype == torch.float32
        _allclose(med.numpy(), wmed, rtol=1e-5, atol=1e-6)
        _allclose(trim.numpy(), wtrim, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("n", [6, 38])
    def test_even_n_median_is_mean_of_middle_pair(self, n):
        j, t = _both(_normal((n, 64), seed=n), "bfloat16")
        med, _ = coord_stats(t, 1)
        wmed, _ = jax_coord_stats(j, 1, interpret=True)
        _allclose(med.numpy(), wmed, rtol=1e-5, atol=1e-6)
        s = np.sort(t.to(torch.float32).numpy(), axis=0)
        assert np.array_equal(med.numpy(),
                              0.5 * (s[n // 2 - 1] + s[n // 2]))

    def test_trim_check_text(self):
        with pytest.raises(ValueError) as got:
            coord_stats(torch.zeros((4, 10)), 2)
        with pytest.raises(ValueError) as want:
            jax_coord_stats(jnp.zeros((4, 10)), 2, interpret=True)
        assert str(got.value) == str(want.value)

    def test_plain_version_is_what_the_cpu_takes(self):
        t = torch.from_numpy(_normal((11, 300), seed=2))
        for a, b in zip(coord_stats(t, 2), coord_stats_plain(t, 2)):
            assert torch.equal(a, b)

    def test_unsupported_device_raises(self):
        with pytest.raises(ValueError, match="unsupported device"):
            coord_stats(torch.zeros((5, 10), device="meta"), 1)
        with pytest.raises(ValueError, match="unsupported device"):
            bulyan_select(torch.zeros((5, 10), device="meta"), 1)


# ---------------------------------------------------------------------------
# ref: the oracles
# ---------------------------------------------------------------------------

class TestRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pairwise_gram_ref(self, dtype):
        j, t = _both(_normal((9, 129), seed=1, scale=3.0), dtype)
        _allclose(ref.pairwise_gram_ref(t).numpy(),
                  jref.pairwise_gram_ref(j), rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("theta,f", [(5, 0), (9, 2), (16, 3)])
    def test_bulyan_select_ref(self, theta, f):
        j, t = _both(_normal((theta, 300), seed=theta))
        _allclose(ref.bulyan_select_ref(t, f).numpy(),
                  jref.bulyan_select_ref(j, f), rtol=2e-5, atol=1e-5)

    def test_bulyan_select_ref_ties_keep_row_order(self):
        """Equal distances to the median are ordered by row (a stable
        argsort), so the averaged set is the reference's."""
        # median 0; rows 1 and 2 tie at distance 1 and beta = 2
        x = np.array([[0.], [1.], [-1.], [5.]], np.float32)
        j, t = _both(x)
        got = ref.bulyan_select_ref(t, 1)
        assert float(got[0]) == 0.5
        assert float(got[0]) == float(jref.bulyan_select_ref(j, 1)[0])

    @pytest.mark.parametrize("n,f", [(7, 1), (10, 2)])
    def test_coord_stats_ref(self, n, f):
        j, t = _both(_normal((n, 200), seed=n))
        for a, b in zip(ref.coord_stats_ref(t, f),
                        jref.coord_stats_ref(j, f)):
            _allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ops: the dispatcher
# ---------------------------------------------------------------------------

class TestOps:
    def test_cpu_default_is_the_oracle(self):
        j, t = _both(_normal((9, 300), seed=4))
        _allclose(ops.pairwise_distances(t).numpy(),
                  jops.pairwise_distances(j, use_pallas=False),
                  rtol=1e-4, atol=1e-4)
        _allclose(ops.bulyan_coordinate(t, 2).numpy(),
                  jops.bulyan_coordinate(j, 2, use_pallas=False),
                  rtol=1e-5, atol=1e-5)
        assert torch.equal(ops.pairwise_distances(t, use_kernel=False),
                           ref.pairwise_gram_ref(t))

    def test_kernel_flag_matches_the_reference_kernel(self):
        j, _ = _both(_normal((9, 300), seed=4))
        t = torch.from_numpy(_normal((9, 300), seed=4))
        # the port's kernels on a CPU tensor are their plain versions
        _allclose(tkernels.pairwise_gram(t).numpy(),
                  jops.pairwise_distances(j, use_pallas=True, block_d=128),
                  rtol=1e-4, atol=1e-4)
        _allclose(tkernels.bulyan_select(t, 2).numpy(),
                  jops.bulyan_coordinate(j, 2, use_pallas=True,
                                         block_d=128),
                  rtol=1e-5, atol=1e-5)

    def test_use_kernel_true_on_cpu_raises(self):
        t = torch.from_numpy(_normal((9, 30), seed=4))
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            ops.pairwise_distances(t, use_kernel=True)
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            ops.bulyan_coordinate(t, 2, use_kernel=True)


# ---------------------------------------------------------------------------
# probes: the fp32-accumulation contract
# ---------------------------------------------------------------------------

class TestProbes:
    @pytest.mark.parametrize("d,block_d", [(512, 256), (1536, 512)])
    def test_gram_and_coord(self, d, block_d):
        assert probes.gram_fp32_contract_error(
            n=8, d=d, block_d=block_d, device="cpu") <= PROBE_TOL
        assert probes.coord_fp32_contract_error(
            theta=9, f=2, d=d, block_d=block_d, device="cpu") <= PROBE_TOL

    @pytest.mark.parametrize("mode", ["bulyan-krum", "trimmed_mean",
                                      "krum"])
    def test_fused(self, mode):
        assert probes.fused_fp32_contract_error(
            n=11, f=2, d=1536, mode=mode, block_d=512,
            device="cpu") <= PROBE_TOL

    def test_reference_probes_agree_on_the_bound(self):
        """The reference's probes pass the same bound at these sizes."""
        assert jprobes.coord_fp32_contract_error(
            theta=9, f=2, d=512, block_d=256, interpret=True) <= PROBE_TOL

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probes.gram_fp32_contract_error(d=64)

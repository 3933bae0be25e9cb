"""K2 (``bulyan_select``) against the reference on columns that hold NaN,
+-inf, -0.0 and ties, at every size bucket of theta.

The kernel (``csrc/bulyan_select.cu``, which launches ``csrc/common.cuh``'s
``coord_stats_kernel`` with its Bulyan output) holds a coordinate's
theta values in registers padded with +inf to a size bucket, sorts them
with Batcher's network and a NaN flag, runs Bulyan's window by running
prefix sums over a barrel-shifted copy and scales the best window's sum
by the rounded reciprocal of beta.  :func:`bulyan_select_transcription`
chains those steps in numpy float32 (``torch_register_form.py``) and is
held against the JAX ``bulyan_select(..., interpret=True)`` bit for bit
(NaN in the same places; ``==`` does not see the sign of a zero), for
theta in every bucket and at its edges, from f = 0 to the largest f
that beta >= 1 allows (:func:`_fs`).  The port's plain version is held against the same output at
1e-4, with NaN and the infinities in the same places.

K2 has no weights, so unlike K4's Bulyan modes an inf is not a NaN: one
NaN makes its column NaN (the reference's network spreads it to every
position), a +inf falls out of the best window once f >= 1, and a -inf
gives -inf (every later window's deviation is inf - inf = NaN, which
never wins).  The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bulyan_select as jax_bulyan_select  # noqa: E402
from repro_torch.kernels.bulyan_select import (  # noqa: E402
    bulyan_select_plain)
from torch_register_form import (  # noqa: E402
    bucket_of, bulyan_window_regs, close_nan, recip, register_sort, same)

FP32_TOL = 1e-4
_F32 = np.float32
D = 256
#: theta in every size bucket and at its edges
THETAS = (3, 8, 9, 16, 17, 21, 24, 25, 40, 48, 49, 64)


def _fs(theta):
    """Every f that beta = theta - 2f >= 1 allows up to theta = 25; from
    the 40 bucket on, where the reference's interpret mode takes 5-18 s
    to compile each f, f = 0, 1, the middle one and the largest (the
    card-only tests take every f there)."""
    top = (theta - 1) // 2
    if theta <= 25:
        return range(top + 1)
    return sorted({0, 1, top // 2, top})


CASES = [(theta, f) for theta in THETAS for f in _fs(theta)]
#: the poisoned columns, repeated at D // 2 + col among rounded values
NAN, POS_INF, NEG_INF, BOTH_INF, NEG_ZERO, HALF_POS, HALF_NEG, ZEROS, TIE = (
    range(9))


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@np.errstate(invalid="ignore")
def bulyan_select_transcription(x, f):
    """K2 on a float32 (theta, d) stack: bucket, Batcher's network with
    a NaN flag, the window, the rounded reciprocal of beta."""
    s, nan = register_sort(x)
    assert s.shape[0] == bucket_of(x.shape[0])
    return np.where(nan, np.nan,
                    bulyan_window_regs(s, x.shape[0], f)).astype(_F32)


def _stack(theta, seed=0):
    """Gradient-like rows; the right half rounded to quarters (ties);
    columns holding one NaN, one +inf, one -inf, a +inf and a -inf, all
    -0.0, +inf or -inf in half the rows, +-0.0 mixed, one value, in
    rows picked at random (the sort must not care)."""
    rng = np.random.default_rng(seed + theta)
    x = (rng.standard_normal((theta, D)) * 0.5 + 1.0).astype(_F32)
    x[:, D // 2:] = np.round(x[:, D // 2:] * 4) / 4
    half = max(1, theta // 2)
    for base in (0, D // 2):
        rows = rng.permutation(theta)
        x[rows[0], base + NAN] = np.nan
        x[rows[0], base + POS_INF] = np.inf
        x[rows[0], base + NEG_INF] = -np.inf
        x[rows[0], base + BOTH_INF] = np.inf
        x[rows[1], base + BOTH_INF] = -np.inf
        x[:, base + NEG_ZERO] = -0.0
        x[rows[:half], base + HALF_POS] = np.inf
        x[rows[:half], base + HALF_NEG] = -np.inf
        x[:, base + ZEROS] = np.where(rng.random(theta) < 0.5, -0.0, 0.0)
        x[:, base + TIE] = 0.75
    return x


def _reference(x, f):
    return np.asarray(jax_bulyan_select(jnp.asarray(x), f, interpret=True))


@pytest.mark.parametrize("theta,f", CASES)
def test_transcription_is_the_reference_bit_for_bit(theta, f):
    x = _stack(theta)
    want = _reference(x, f)
    same(bulyan_select_transcription(x, f), want)
    for base in (0, D // 2):
        assert np.isnan(want[base + NAN])
        assert np.isneginf(want[base + NEG_INF])
        assert (np.isposinf(want[base + POS_INF]) if f == 0
                else np.isfinite(want[base + POS_INF]))
        assert want[base + NEG_ZERO] == 0
        assert abs(want[base + TIE] - 0.75) <= 1e-6


@pytest.mark.parametrize("theta,f", CASES)
def test_plain_version_is_the_reference(theta, f):
    x = _stack(theta)
    got = bulyan_select_plain(torch.from_numpy(x), f)
    assert got.dtype == torch.float32 and got.shape == (D,)
    close_nan(got.numpy(), _reference(x, f), FP32_TOL)


def test_mean_scales_by_the_rounded_reciprocal():
    """The reference's ``best_sum / beta`` runs as a product with the
    rounded reciprocal of beta on its interpret path too (XLA's rewrite
    of a division by a constant), so the kernel multiplies: with f = 0
    the window is every value, summed in sorted order, and the quotient
    differs from the product in the last bit on some coordinates."""
    theta, d = 21, 4096
    rng = np.random.default_rng(3)
    x = rng.standard_normal((theta, d)).astype(_F32)
    want = np.asarray(jax_bulyan_select(jnp.asarray(x), 0, interpret=True))
    acc = np.sort(x, axis=0)[0].copy()
    for r in np.sort(x, axis=0)[1:]:
        acc = (acc + r).astype(_F32)
    product = (acc * recip(theta)).astype(_F32)
    quotient = (acc / _F32(theta)).astype(_F32)
    assert (product != quotient).any()
    assert np.array_equal(want, product)
    assert np.array_equal(bulyan_select_transcription(x, 0), product)

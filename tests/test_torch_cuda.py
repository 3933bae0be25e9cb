"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips without a card; run them
there with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX, so it runs where
only the port is installed.  ``chip_smoke.py`` runs the same comparisons
at the main path's full widths.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_agg as fa  # noqa: E402
from repro_torch.kernels.bulyan_select import (  # noqa: E402
    bulyan_select, bulyan_select_plain)
from repro_torch.kernels.coord_stats import (  # noqa: E402
    coord_stats, coord_stats_plain)
from repro_torch.kernels.pairwise_gram import (  # noqa: E402
    pairwise_gram_partial, pairwise_gram_partial_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stack(n, d, dtype, card, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g) * 0.5 + 1.0
    return x.to(device=card, dtype=dtype).contiguous()


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.double().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("n,f,d", [(11, 2, 4097), (39, 9, 1000),
                                   (64, 15, 129)])
def test_every_kernel_matches_plain(card, n, f, d, dtype, tol):
    x = _stack(n, d, dtype, card)
    raw = pairwise_gram_partial(x)
    assert _rel(raw, pairwise_gram_partial_plain(x)) <= tol
    for mode in fa.FUSED_MODES:
        got = fa.fused_aggregate(x, f, mode=mode)
        want = fa.fused_aggregate_plain(x, f, mode=mode)
        assert _rel(got[0], want[0]) <= tol, mode
        assert torch.equal(got[1], want[1]), mode
        if mode in fa.DIST_MODES:
            w, sel, _ = fa.select_weights(raw, n, f, mode)
            wp, selp, _ = fa.select_weights_plain(raw, n, f, mode)
            assert torch.equal(w, wp) and torch.equal(sel, selp), mode


def test_fused_aggregate_is_the_kernel_pair_bitwise(card):
    n, f = 39, 9
    x = _stack(n, 5000, torch.float32, card, seed=3)
    for mode in fa.DIST_MODES:
        agg, sel, scores = fa.fused_aggregate(x, f, mode=mode)
        w, sel2, scores2 = fa.select_weights(pairwise_gram_partial(x),
                                             n, f, mode)
        assert torch.equal(agg, fa.fused_coordinate(x, w, f, mode=mode))
        assert torch.equal(sel, sel2[0]) and torch.equal(scores,
                                                         scores2[0])


def test_launches_are_counted_once_per_kernel(card):
    x = _stack(11, 300, torch.float32, card)
    _build.reset_launches()
    fa.fused_aggregate(x, 2, mode="bulyan-krum")
    assert _build.LAUNCHES == {"pairwise_gram_partial": 1,
                               "select_weights": 1, "fused_coordinate": 1,
                               "fused_aggregate": 3, "bulyan_select": 0,
                               "coord_stats": 0}
    _build.reset_launches()
    fa.fused_aggregate(x, 2, mode="cwmed")
    assert _build.LAUNCHES["fused_coordinate"] == 1
    assert _build.LAUNCHES["fused_aggregate"] == 1
    assert _build.LAUNCHES["pairwise_gram_partial"] == 0


def test_block_d_is_refused_on_the_card(card):
    x = _stack(11, 300, torch.float32, card)
    with pytest.raises(ValueError, match="picks its own chunking"):
        pairwise_gram_partial(x, block_d=128)
    with pytest.raises(ValueError, match="picks its own chunking"):
        fa.fused_aggregate(x, 2, mode="krum", block_d=128)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = _stack(11, 300, torch.float32, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pairwise_gram_partial(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_coordinate(x.T.contiguous().T, None, 2, mode="cwmed")
    with pytest.raises(ValueError, match="n <= 64"):
        pairwise_gram_partial(_stack(65, 10, torch.float32, card))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("theta,f,d", [(21, 9, 4097), (3, 1, 129),
                                       (64, 15, 1000), (9, 2, 1)])
def test_bulyan_select_matches_plain(card, theta, f, d, dtype, tol):
    x = _stack(theta, d, dtype, card, seed=theta)
    got = bulyan_select(x, f)
    assert got.dtype == torch.float32 and got.shape == (d,)
    assert _rel(got, bulyan_select_plain(x, f)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("n,f,d", [(39, 9, 4097), (3, 1, 129),
                                   (38, 9, 1000), (64, 15, 1)])
def test_coord_stats_matches_plain(card, n, f, d, dtype, tol):
    x = _stack(n, d, dtype, card, seed=n)
    for got, want in zip(coord_stats(x, f), coord_stats_plain(x, f)):
        assert got.dtype == torch.float32 and got.shape == (d,)
        assert _rel(got, want) <= tol


def test_coord_kernels_count_one_launch_per_call(card):
    x = _stack(21, 300, torch.float32, card)
    _build.reset_launches()
    bulyan_select(x, 9)
    assert _build.LAUNCHES["bulyan_select"] == 1
    coord_stats(x, 9)
    coord_stats(x, 9)
    assert _build.LAUNCHES["coord_stats"] == 2
    bulyan_select_plain(x, 9)
    coord_stats_plain(x, 9)
    assert sum(_build.LAUNCHES.values()) == 3


def test_coord_kernels_refuse_block_d_on_the_card(card):
    x = _stack(21, 300, torch.float32, card)
    with pytest.raises(ValueError, match="picks its own chunking"):
        bulyan_select(x, 9, block_d=128)
    with pytest.raises(ValueError, match="picks its own chunking"):
        coord_stats(x, 9, block_d=128)

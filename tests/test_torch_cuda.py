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


def _max_f(n, mode):
    """The largest f the mode's quorum allows (``_check_mode_shape``)."""
    if mode.startswith("bulyan"):
        return (n - 3) // 4
    if mode in ("krum", "multikrum"):
        return n - 3
    return n - 1


def _same(got, want):
    """Equal values with NaN in the same places."""
    return torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
        torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("d", [1, 2, 3, 129, 4097, 79_510])
def test_gram_is_exactly_symmetric_and_repeats(card, d, dtype, tol):
    for n in (1, 2, 7, 8, 9, 39, 40, 41, 63, 64):
        x = _stack(n, d, dtype, card, seed=n + d)
        raw = pairwise_gram_partial(x)
        assert torch.equal(raw, raw.T), (n, d)
        assert torch.equal(raw, pairwise_gram_partial(x)), (n, d)
        assert _rel(raw, _gram64(x)) <= tol, (n, d)


def _gram64(x):
    """The raw distances in float64 (the plain version's per-tile fp32
    cancellation leaves up to ~5e-4 on a zero diagonal at d = 79,510)."""
    x = x.double()
    sq = (x * x).sum(dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_every_n_and_unaligned_rows(card, dtype):
    """Every n from 1 to 64, and stacks whose base is not 16-byte
    aligned (a contiguous view one row into a bigger stack)."""
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for n in range(1, 65):
        x = _stack(n, 131, dtype, card, seed=n)
        assert _rel(pairwise_gram_partial(x),
                    pairwise_gram_partial_plain(x)) <= tol, n
    for d in (5, 6, 130, 4098):
        big = _stack(40, d, dtype, card, seed=d)
        x = big[1:]                       # offset d elements
        assert x.is_contiguous()
        raw = pairwise_gram_partial(x)
        assert torch.equal(raw, raw.T)
        assert _rel(raw, pairwise_gram_partial_plain(x)) <= tol, d


def test_identical_rows_are_at_distance_zero(card):
    x = _stack(39, 79_510, torch.float32, card, seed=5)
    x[30:] = x[:30].mean(dim=0)
    raw = pairwise_gram_partial(x)
    assert bool((raw[30:, 30:] == 0).all())


@pytest.mark.parametrize("mode", fa.DIST_MODES)
@pytest.mark.parametrize("n", [3, 4, 7, 38, 39, 64])
def test_select_matches_plain_at_the_largest_f(card, n, mode):
    f = _max_f(n, mode) if n != 39 else 9
    x = _stack(n, 257, torch.float32, card, seed=n)
    raw = pairwise_gram_partial(x)
    for got, want in zip(fa.select_weights(raw, n, f, mode),
                         fa.select_weights_plain(raw, n, f, mode)):
        assert _same(got, want), (n, f, mode)


@pytest.mark.parametrize("mode", fa.DIST_MODES)
def test_select_matches_plain_with_ties_inf_and_nan(card, mode):
    """Symmetric matrices drawn from a few levels (ties), with zeros, +inf
    and NaN entries, and a stack with one NaN coordinate."""
    gen = torch.Generator().manual_seed(11)
    for trial in range(40):
        n = int(torch.randint(3, 65, (1,), generator=gen))
        f = int(torch.randint(0, _max_f(n, mode) + 1, (1,), generator=gen))
        levels = int(torch.randint(1, 2 * n * n, (1,), generator=gen))
        v = torch.randint(1, levels + 1, (n, n), generator=gen) * 0.37
        u = torch.rand((n, n), generator=gen)
        v[u < 0.1] = 0.0
        v[(u >= 0.1) & (u < 0.15)] = float("inf")
        if trial % 3 == 0:
            v[(u >= 0.15) & (u < 0.16)] = float("nan")
        v = torch.triu(v, 1)
        v = (v + v.T).float().to(card)
        for got, want in zip(fa.select_weights(v, n, f, mode),
                             fa.select_weights_plain(v, n, f, mode)):
            assert _same(got, want), (trial, n, f, mode)
    x = _stack(11, 300, torch.float32, card, seed=9)
    x[10, 3] = float("nan")
    raw = pairwise_gram_partial(x)
    for got, want in zip(fa.select_weights(raw, 11, 2, mode),
                         fa.select_weights_plain(raw, 11, 2, mode)):
        assert _same(got, want), mode
    agg, sel, sc = fa.fused_aggregate(x, 2, mode=mode)
    aggp, selp, scp = fa.fused_aggregate_plain(x, 2, mode=mode)
    assert torch.equal(sel, selp) and _same(sc, scp), mode
    assert torch.equal(torch.isnan(agg), torch.isnan(aggp)), mode


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


# ---------------------------------------------------------------------------
# K4 and K3 in registers: every size bucket, the non-finite contract
# ---------------------------------------------------------------------------

def _k4_weights(x, n, f, mode):
    raw = pairwise_gram_partial_plain(x)
    return fa.select_weights_plain(raw, n, f, mode)[0]


def _close_same_nan(got, want, tol):
    """NaN and +-inf in the same places (the infinities with the same
    signs), the rest within tol of max(1, max |finite want|)."""
    got, want = got.double(), want.double()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return False
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf])):
        return False
    fin = torch.isfinite(want)
    return _rel(got[fin], want[fin]) <= tol if bool(fin.any()) else True


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("mode", fa.DIST_MODES)
def test_combine_holds_the_zero_times_x_rule(card, mode, dtype, tol):
    """An inf in an unselected row is NaN there (0 * inf), an inf in
    krum's picked row stays inf, a picked -0.0 comes out +0.0, all-zero
    weights give +0.0 or NaN, and a general (convex) matrix or a row
    picked twice takes the fmaf chain: each against the plain version."""
    n, f, d = 39, 9, 1000
    base = _stack(n, d, dtype, card, seed=41)
    w = _k4_weights(base, n, f, mode)
    mw = _k4_weights(base, n, f, "multikrum").expand(w.shape[0], n)
    picked = int(torch.nonzero(w[0]).flatten()[0])
    unsel = int(torch.nonzero(~(w != 0).any(dim=0)).flatten()[0])
    cols = [0, 5, 500, 998, 999]
    for row, value, weights in (
            (unsel, float("inf"), w), (picked, float("inf"), w),
            (unsel, float("nan"), w), (picked, float("nan"), w),
            (picked, -0.0, w), (unsel, float("inf"), torch.zeros_like(w)),
            (picked, -float("inf"), mw.contiguous()),
            (picked, float("inf"), torch.cat([w[:-1], w[:1]]))):
        x = base.clone()
        x[row, cols] = value
        got = fa.fused_coordinate(x, weights, f, mode=mode)
        want = fa.fused_coordinate_plain(x, weights, f, mode=mode)
        assert _close_same_nan(got, want, tol), (mode, row, value)
        if row == unsel and weights is not mw:
            assert bool(torch.isnan(got[cols]).all()), (mode, value)
        if mode == "krum" and row == picked and weights is w:
            assert _same(got[cols], x[picked, cols].float())
            assert not torch.signbit(got[cols]).any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_coordinate_modes_and_k3_at_every_n(card, dtype, tol):
    """Every n from 3 to 64 (every size bucket and its edges), f at the
    largest and a middle value, one column with a NaN."""
    for n in range(3, 65):
        for f in sorted({(n - 1) // 2, n // 4}):
            x = _stack(n, 131, dtype, card, seed=n + f)
            x[n // 2, 7] = float("nan")
            med, trim = coord_stats(x, f)
            medp, trimp = coord_stats_plain(x, f)
            assert _close_same_nan(med, medp, tol), (n, f)
            assert _close_same_nan(trim, trimp, tol), (n, f)
            assert bool(torch.isnan(med[7])) and bool(torch.isnan(trim[7]))
            for mode, want in (("cwmed", medp), ("trimmed_mean", trimp)):
                got = fa.fused_coordinate(x, None, f, mode=mode)
                assert _close_same_nan(got, want, tol), (n, f, mode)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_bulyan_combine_at_every_theta_bucket(card, dtype, tol):
    """Bulyan's theta = n - 2f in every size bucket and at its edges,
    with the selection's weights and with a general matrix."""
    gen = torch.Generator().manual_seed(5)
    for n, f in ((3, 0), (7, 1), (8, 0), (16, 0), (17, 0), (24, 0),
                 (25, 1), (39, 9), (40, 4), (48, 0), (49, 0), (56, 5),
                 (64, 0), (64, 15)):
        x = _stack(n, 257, dtype, card, seed=n)
        for mode in ("bulyan-krum", "bulyan-geomed"):
            w = _k4_weights(x, n, f, mode)
            general = torch.rand(w.shape, generator=gen).to(card)
            for weights in (w, general):
                got = fa.fused_coordinate(x, weights, f, mode=mode)
                want = fa.fused_coordinate_plain(x, weights, f, mode=mode)
                assert _rel(got, want) <= tol, (n, f, mode)


#: K2's theta in every size bucket and at its edges
K2_THETAS = (3, 8, 9, 16, 17, 21, 24, 25, 40, 48, 49, 64)
#: K2's poisoned columns: one NaN, one +inf, one -inf, a +inf and a -inf,
#: all -0.0, +-0.0 mixed
K2_NAN, K2_POS, K2_NEG, K2_BOTH, K2_NEG_ZERO, K2_ZEROS = range(6)


def _k2_stack(theta, d, dtype, card, seed):
    """Gradient-like rows, the right half rounded to quarters (ties), and
    K2's poisoned columns in rows picked at random."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((theta, d), generator=g) * 0.5 + 1.0
    x[:, d // 2:] = torch.round(x[:, d // 2:] * 4) / 4
    rows = torch.randperm(theta, generator=g)
    x[rows[0], K2_NAN] = float("nan")
    x[rows[0], K2_POS] = float("inf")
    x[rows[0], K2_NEG] = -float("inf")
    x[rows[0], K2_BOTH] = float("inf")
    x[rows[1], K2_BOTH] = -float("inf")
    x[:, K2_NEG_ZERO] = -0.0
    x[:, K2_ZEROS] = torch.where(torch.rand(theta, generator=g) < 0.5,
                                 -0.0, 0.0)
    return x.to(device=card, dtype=dtype).contiguous()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_bulyan_select_at_every_theta_bucket_on_non_finite_columns(
        card, dtype, tol):
    """K2 in registers: theta in every size bucket and at its edges, every
    f that beta >= 1 allows, NaN and +-inf in the plain version's places
    (an inf is not a NaN here: a +inf leaves the window once f >= 1, a
    -inf gives -inf)."""
    for theta in K2_THETAS:
        for f in range((theta - 1) // 2 + 1):
            x = _k2_stack(theta, 257, dtype, card, seed=theta * 64 + f)
            got = bulyan_select(x, f)
            want = bulyan_select_plain(x, f)
            assert got.dtype == torch.float32 and got.shape == (257,)
            assert _close_same_nan(got, want, tol), (theta, f)
            assert bool(torch.isnan(got[K2_NAN])), (theta, f)
            assert float(got[K2_NEG]) == -float("inf"), (theta, f)
            assert (bool(torch.isfinite(got[K2_POS])) if f
                    else float(got[K2_POS]) == float("inf")), (theta, f)
            assert float(got[K2_NEG_ZERO]) == 0.0, (theta, f)


def test_k4_and_k3_take_unaligned_rows(card):
    """A contiguous stack that starts one row into a bigger one (rows
    only 4-byte aligned)."""
    big = _stack(40, 4098, torch.float32, card, seed=2)
    x = big[1:]
    for got, want in zip(coord_stats(x, 9), coord_stats_plain(x, 9)):
        assert _rel(got, want) <= 1e-4
    w = _k4_weights(x, 39, 9, "bulyan-krum")
    assert _rel(fa.fused_coordinate(x, w, 9, mode="bulyan-krum"),
                fa.fused_coordinate_plain(x, w, 9, mode="bulyan-krum")) <= 1e-4


# ---------------------------------------------------------------------------
# the stateful composites and the flat async trainer on the card
# ---------------------------------------------------------------------------

FUSED_COMPOSITES = ["stale-fused-bulyan-krum", "reputation-fused-bulyan-krum",
                    "buffered-fused-cwmed", "buffered-fused-krum",
                    "stale-exp-fused-cwmed"]


@pytest.mark.parametrize("name", FUSED_COMPOSITES)
def test_fused_composites_match_the_unfused_rule(card, name):
    """Three steps of a wrapper over a ``fused-`` base on the kernels
    against the same wrapper over the unfused rule, state carried."""
    from repro_torch.agg.registry import resolve_rule
    from repro_torch.agg.state import init_state
    n, f, d = 11, 2, 3000
    fused, plain = resolve_rule(name), resolve_rule(name.replace("fused-",
                                                                 ""))
    sf = init_state(fused, torch.zeros((n, d), device=card))
    sp = init_state(plain, torch.zeros((n, d), device=card))
    for t in range(3):
        x = _stack(n, d, torch.float32, card, seed=t)
        x[n - f:] = -x[:n - f].mean(dim=0)
        if sf.bus != ():
            v = torch.arange(n, device=card, dtype=torch.int32) % 3
            v = torch.clamp_min(t - v, 0)
            sf = sf._replace(bus=sf.bus._replace(versions=v))
            sp = sp._replace(bus=sp.bus._replace(versions=v))
        got, sf = fused.dense_fn(x, f, sf)
        want, sp = plain.dense_fn(x, f, sp)
        assert _rel(got.gradient, want.gradient) <= 1e-4, (name, t)
        assert torch.equal(got.selected, want.selected), (name, t)


def test_uniform_reputation_and_staleness_are_the_base_bitwise(card):
    from repro_torch.agg.registry import resolve_rule
    from repro_torch.agg.state import init_state
    n, f = 39, 9
    x = _stack(n, 5000, torch.float32, card, seed=4)
    for base in ("fused-bulyan-krum", "fused-cwmed", "fused-krum"):
        want = resolve_rule(base).dense_fn(x, f)
        rep = resolve_rule(f"reputation-{base}")
        got, _ = rep.dense_fn(x, f, init_state(rep, x))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), base
        stale = resolve_rule(f"stale-{base}")
        st = init_state(stale, x)._replace(step=4)
        got, _ = stale.dense_fn(x, f, st)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), base


def test_brute_on_the_card_matches_the_cpu(card):
    from repro_torch.core.gars import brute
    x = _stack(11, 20000, torch.float32, card, seed=5)
    got = brute(x, 5)
    want = brute(x.cpu(), 5)
    assert _rel(got.gradient.cpu(), want.gradient) <= 1e-4
    assert torch.equal(got.selected.cpu(), want.selected)


def test_async_trainer_at_tau_zero_is_the_sync_trainer(card):
    from repro_torch.agg.specs import AggSpec
    from repro_torch.data.synthetic import ByzantineBatcher
    from repro_torch.models import simple
    from repro_torch.optim import get_optimizer
    from repro_torch.training import AsyncByzantineTrainer, ByzantineTrainer

    def loss(p, x, y):
        return simple.classification_loss(simple.mnist_mlp_forward(p, x),
                                          y, p)

    spec = AggSpec(n_workers=11, f=2, gar="stale-fused-bulyan-krum",
                   attack="omniscient_linf",
                   attack_kwargs=(("gamma", "closed"), ("margin", 0.8)))
    out = []
    for cls in (AsyncByzantineTrainer, ByzantineTrainer):
        tr = cls(loss, simple.init_mnist_mlp(1, device=card),
                 get_optimizer("sgd", 0.1), spec, seed=1)
        tr.run(ByzantineBatcher("mnist", 9, 4, seed=1), 3)
        out.append(tr.params)
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])

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
                               "coord_stats": 0, "grouped_gemm": 0,
                               "decode_attention": 0}
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


# ---------------------------------------------------------------------------
# telemetry and the leeway meter on the card
# ---------------------------------------------------------------------------

def test_obs_is_off_equals_on_through_k5(card):
    """``obs-fused-bulyan-krum`` on a Fig. 4 stack (n = 39, f = 9): the
    result bit for bit ``fused-bulyan-krum``'s, the same launches, and
    the ring row against ``dense_diagnostics`` on a CPU copy at 1e-4."""
    from repro_torch.agg.registry import resolve_rule
    from repro_torch.agg.state import init_state
    from repro_torch.obs.buffer import drain
    from repro_torch.obs.forensics import dense_diagnostics
    n, f = 39, 9
    x = _stack(n, 79_510, torch.float32, card, seed=6)
    x[n - f:] = -x[:n - f].mean(dim=0)
    obs = resolve_rule("obs-fused-bulyan-krum")
    state = init_state(obs, x)
    counts = []
    for rule, args in ((resolve_rule("fused-bulyan-krum"), ()),
                       (obs, (state,))):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = rule.dense_fn(x, f, *args)
        torch.cuda.synchronize()
        counts.append(dict(_build.LAUNCHES))
        if args:
            got, state = out
        else:
            want = out
    assert counts[0] == counts[1]
    assert counts[1]["fused_aggregate"] == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    row = drain(state.obs)["records"][0]
    ref = dense_diagnostics(
        x.cpu(), want.gradient.cpu(), want.selected.cpu(),
        want.scores.cpu(), f, 1, torch.ones(n), torch.zeros(n))
    for fld, v in ref._asdict().items():
        if fld in ("selected", "scores", "step"):
            assert torch.equal(torch.as_tensor(row[fld]), v), fld
        else:
            assert _rel(torch.as_tensor(row[fld]), v) <= 1e-4, fld


def test_obs_fused_tree_path(card):
    """``obs-fused-bulyan-krum`` through the tree engine's ``fused``
    backend: leaves bit for bit ``fused-bulyan-krum``'s, the ring row
    against ``tree_diagnostics`` on the CPU at 1e-4."""
    from repro_torch.dist.robust import distributed_aggregate
    from repro_torch.obs.buffer import drain
    from repro_torch.obs.forensics import tree_diagnostics
    n, f = 39, 9
    x = _stack(n, 6000, torch.float32, card, seed=7)
    # contiguous leaves (strided ones are copied at the wrappers'
    # boundary; test_strided_leaves_reach_the_kernels covers those)
    tree = {"a": x[:, :1000].reshape(n, 10, 100).contiguous(),
            "b": x[:, 1000:5990].contiguous(), "c": x[:, 5990:].contiguous()}
    want, wres = distributed_aggregate(tree, f, "fused-bulyan-krum",
                                       distance_backend="fused")
    got, gres, state = distributed_aggregate(tree, f, "obs-bulyan-krum",
                                             distance_backend="fused")
    for k in tree:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(gres.selected, wres.selected)
    row = drain(state.obs)["records"][0]
    ref = tree_diagnostics(
        [tree[k].cpu() for k in sorted(tree)],
        [want[k].cpu() for k in sorted(tree)], wres.selected.cpu(),
        wres.scores.cpu(), f, 1, torch.ones(n), torch.zeros(n))
    for fld, v in ref._asdict().items():
        assert _rel(torch.as_tensor(row[fld]), v) <= 1e-4, fld


def test_leeway_point_at_the_mlp_width(card):
    """The leeway meter at d = 1024 and 79,510 on the card:
    ``fused-krum``'s margin equals ``krum``'s (K1, select and K4 ran)."""
    from repro_torch.audit.leeway import measure_leeway
    _build.reset_launches()
    rep = measure_leeway(rules=("krum", "fused-krum"),
                         dims=(1024, 79_510), device=card)
    assert _build.LAUNCHES["fused_aggregate"] == 6   # 3 per rung
    for i in range(2):
        got = rep["rules"]["fused-krum"]["margin_abs"][i]
        want = rep["rules"]["krum"]["margin_abs"][i]
        assert abs(got - want) <= 1e-4 * abs(want)
    assert rep["gamma"]["krum"]["values"][1] > 100.0


def _strided(n, d, card, seed=0):
    """An ``(n, d)`` stack with strides ``(1, n)``: the layout of a
    ``vmap`` output whose worker axis was moved to the front."""
    x = _stack(d, n, torch.float32, card, seed=seed).T
    assert not x.is_contiguous()
    return x


@pytest.mark.parametrize("n,f,d", [(7, 1, 1152), (39, 9, 4097)])
def test_strided_leaves_reach_the_kernels(card, n, f, d):
    """K1, the selection, K4 and K2 / K3 take a strided stack (copied
    once at the wrapper's boundary) and equal their plain versions at
    1e-4 with equal selections; the tree engine's ``fused`` and
    ``pallas`` backends take strided leaves.  On the parent tree every
    kernel wrapper raised ``needs a contiguous (n, d) stack``."""
    from repro_torch.dist.robust import distributed_aggregate
    x = _strided(n, d, card)
    _build.reset_launches()
    raw = pairwise_gram_partial(x)
    assert _build.LAUNCHES["pairwise_gram_partial"] == 1
    assert _rel(raw, pairwise_gram_partial_plain(x)) <= 1e-4
    w, sel, _ = fa.select_weights(raw.T, n, f, "bulyan-krum")
    wp, selp, _ = fa.select_weights_plain(raw, n, f, "bulyan-krum")
    assert torch.equal(w, wp) and torch.equal(sel, selp)
    got = fa.fused_coordinate(x, w, f, mode="bulyan-krum")
    assert _build.LAUNCHES["fused_coordinate"] == 1
    assert _rel(got, fa.fused_coordinate_plain(x, wp, f,
                                               mode="bulyan-krum")) <= 1e-4
    agg, sel5, _ = fa.fused_aggregate(x, f, mode="bulyan-krum")
    assert torch.equal(agg, got) and torch.equal(sel5[None], sel)
    med, trim = coord_stats(x, f)
    pmed, ptrim = coord_stats_plain(x, f)
    assert _rel(med, pmed) <= 1e-4 and _rel(trim, ptrim) <= 1e-4
    picked = x[: n - 2 * f]
    assert _rel(bulyan_select(picked, f),
                bulyan_select_plain(picked, f)) <= 1e-4
    tree = {"a": x, "b": _strided(n, 300, card, seed=1)}
    want, wres = distributed_aggregate(tree, f, "bulyan-krum",
                                       distance_backend="xla")
    for backend in ("pallas", "fused"):
        out, res = distributed_aggregate(tree, f, "bulyan-krum",
                                         distance_backend=backend)
        assert torch.equal(res.selected, wres.selected), backend
        for k in tree:
            assert _rel(out[k], want[k]) <= 1e-4, (backend, k)


def test_llm_step_on_the_card_matches_the_cpu(card):
    """Two steps of the zoo's train step (reduced gemma3-1b, n = 7,
    f = 1, ``fused-bulyan-krum`` under ``omniscient_linf``, momentum) on
    the card against the same steps on the CPU (the kernels' plain
    versions there): each leaf's change at 1e-4 of its largest off
    Bulyan's window ties, equal ``byz_weight``, and K1 / select / K4
    launched once per leaf / once / once per leaf per step."""
    import numpy as np
    from torch_llm_compare import close_change, window_ties
    from repro_torch.configs import get_reduced
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.dist.train import (DistByzantineSpec, byzantine_grads,
                                        make_loss_fn, make_train_step)
    from repro_torch.models import init_model
    from repro_torch.optim import get_optimizer
    cfg = get_reduced("gemma3_1b")
    n, f = 7, 1
    spec = DistByzantineSpec(f=f, gar="fused-bulyan-krum",
                             attack="omniscient_linf",
                             distance_backend="fused")
    opt = get_optimizer("momentum", 1e-2)
    loss = make_loss_fn(cfg)
    step = make_train_step(cfg, spec, opt)
    init = init_model(0, cfg, device="cpu")
    params = {dev: tree_map(lambda p: p.to(dev), init)
              for dev in ("cpu", card)}
    state = {dev: opt.init(p) for dev, p in params.items()}
    ties = None
    k = len(tree_leaves(init))
    for t in range(2):
        toks, labs = zip(*(lm_batches(cfg.vocab_size, 2, 32, t * n + w,
                                      seed=7) for w in range(n)))
        batch = {"tokens": np.stack(toks), "labels": np.stack(labs)}
        subs = [tree_leaves(byzantine_grads(loss, spec, params[dev], batch,
                                            t)[1]) for dev in params]
        tie = window_ties(subs[0], subs[1], f)
        ties = tie if ties is None else [a | b for a, b in zip(ties, tie)]
        metrics = {}
        for dev in params:
            _build.reset_launches()
            params[dev], state[dev], metrics[dev] = step(params[dev],
                                                         state[dev], batch)
            if dev != "cpu":
                assert _build.LAUNCHES["pairwise_gram_partial"] == k
                assert _build.LAUNCHES["select_weights"] == 1
                assert _build.LAUNCHES["fused_coordinate"] == k
        mc, mg = metrics["cpu"], metrics[card]
        assert float(mc["byz_weight"]) == float(mg["byz_weight"])
        assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-4 * abs(
            float(mc["loss"]))
        for i, (a, b, p0) in enumerate(zip(tree_leaves(params["cpu"]),
                                           tree_leaves(params[card]),
                                           tree_leaves(init))):
            close_change(b, a, p0, t + 1, ties[i], what=(t, i))


def test_robust_serve_step_on_the_card_matches_the_cpu(card):
    """The ensemble's prefill and three decode steps (reduced
    llama3.2-3b, 7 replicas jittered from a CPU generator, the last one
    poisoned, ``bulyan-krum`` over ``fused``) on the card against the
    same steps on the CPU (the kernels' plain versions there): each
    call launches exactly K1, the selection and K4 once (K5's counter
    reads its 3 parts), each decode step one decode attention per layer
    besides, never selects the poisoned replica, and gives
    the CPU's aggregate at 1e-4 of its largest entry off Bulyan's window
    ties (tied or windowed differently on the two devices' logits
    stacks, fewer than 1 in 1,000 coordinates)."""
    import numpy as np
    from torch_llm_compare import window_ties
    from repro_torch.agg import AggSpec
    from repro_torch.configs import get_reduced
    from repro_torch.core.pytree import tree_map
    from repro_torch.dist.serve_robust import (make_robust_prefill_step,
                                               make_robust_serve_step,
                                               poison_replicas,
                                               replicate_params)
    from repro_torch.models import decode_step, init_model
    cfg = get_reduced("llama3_2_3b")
    n, f = 7, 1
    stacked = poison_replicas(replicate_params(
        init_model(0, cfg, device="cpu"), n, jitter=1e-3,
        generator=torch.Generator().manual_seed(3)), f, "signflip",
        scale=10.0)
    spec = AggSpec(f=f, gar="bulyan-krum", distance_backend="fused")
    params = {dev: tree_map(lambda p: p.to(dev), stacked)
              for dev in ("cpu", card)}
    prefill = make_robust_prefill_step(cfg, spec, cache_len=32)
    step = make_robust_serve_step(cfg, spec)
    tokens = np.asarray([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    want = {"pairwise_gram_partial": 1, "select_weights": 1,
            "fused_coordinate": 1, "fused_aggregate": 3, "bulyan_select": 0,
            "coord_stats": 0, "grouped_gemm": 0, "decode_attention": 0}
    # a decode step also runs one decode attention per layer
    want_step = dict(want, decode_attention=cfg.n_layers)
    aggs, caches = {}, {}
    for dev in params:
        _build.reset_launches()
        aggs[dev], caches[dev], res = prefill(
            params[dev], torch.as_tensor(tokens, device=dev))
        assert float(res.selected[-1]) == 0.0
        if dev != "cpu":
            assert _build.LAUNCHES == want
    token = torch.argmax(aggs["cpu"], dim=-1).to(torch.int32)[:, None]
    for t in range(3):
        pos = np.full((2,), 5 + t, np.int32)
        stacks = {}
        for dev in params:
            stacks[dev] = torch.func.vmap(lambda p, c: decode_step(
                p, cfg, c, token.to(dev), pos))(params[dev],
                                                caches[dev])[0][:, :, 0]
            _build.reset_launches()
            aggs[dev], caches[dev], res, _ = step(
                params[dev], caches[dev], token.to(dev), pos)
            assert float(res.selected[-1]) == 0.0
            if dev != "cpu":
                assert _build.LAUNCHES == want_step
        off = window_ties([stacks["cpu"]], [stacks[card].cpu()], f)[0]
        assert int(off.sum()) * 1000 < off.numel(), int(off.sum())
        got = aggs[card].cpu().reshape(-1)[~off]
        ref = aggs["cpu"].reshape(-1)[~off]
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), t
        token = torch.argmax(aggs["cpu"], dim=-1).to(torch.int32)[:, None]


def test_two_gloo_ranks_share_the_card_through_k1(card):
    """The sharded train step on a (1, 2) mesh of gloo ranks sharing the
    card (reduced gemma3-1b, n = 7, f = 1, ``bulyan-krum`` over
    ``fused``, which is ``pallas`` under the model axis): each rank
    launches K1 exactly once per local leaf slice and step and nothing
    else, the ranks agree, step 0's aggregate equals the single-device
    ``xla`` backend's on the same submissions, and the parameters after
    two steps equal the single-device run's (window ties let off)."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.data.synthetic import lm_batches
    import torch_mesh_check as mesh_check
    from torch_llm_compare import change_ratio, let_off
    from repro_torch.dist.mesh import run_on_mesh
    from repro_torch.dist.sharding import (gram_shardings, param_shardings,
                                           per_worker_specs)
    from repro_torch.models import init_model

    cfg = get_reduced("gemma3_1b")
    n, f, steps = 7, 1, 2
    batches = []
    for t in range(steps):
        toks, labs = zip(*(lm_batches(cfg.vocab_size, 1, 64, t * n + w,
                                      seed=7) for w in range(n)))
        batches.append({"tokens": np.stack(toks),
                        "labels": np.stack(labs)})
    args = ("gemma3_1b", None, n, f, batches, steps, 1e-2, 0, None)
    single = run_on_mesh(mesh_check.single_rank, (1, 1), args=args,
                         device="cuda", backend="gloo", timeout=600)[0]
    res = run_on_mesh(mesh_check.llm_rank, (1, 2), args=args,
                      device="cuda", backend="gloo", timeout=600)
    params = init_model(0, cfg, device="cuda")
    n_leaves = len(tree_leaves(params))
    for r in res:
        for counts in r["launches"]:
            assert counts == {k: (n_leaves if k == "pairwise_gram_partial"
                                  else 0) for k in _build.LAUNCHES}
        assert r["losses"] == res[0]["losses"]
        assert r["selected"] == single["selected"]
        assert r["k1"]["rel_err"] <= 1e-4
    assert res[0]["step0"]["agg_rel"] <= 1e-4
    template = tree_map(lambda p: p.to("meta"), params)
    grid = type("Grid", (), {"axis_names": ("data", "model"),
                             "devices": np.empty((1, 2))})()
    got = mesh_check.gather_slices([r["params"] for r in res],
                                   param_shardings(template, grid))
    ties = let_off(mesh_check.whole_windows(
        [r["windows"] for r in res],
        per_worker_specs(gram_shardings(template, grid))),
        single["windows"])
    for g, w, p, tie in zip(got, single["after"], tree_leaves(params),
                            ties):
        assert change_ratio(g.cuda(), w.cuda(), p, steps,
                            tie.cuda()) <= 1.0


def test_two_gloo_ranks_serve_through_k5(card):
    """``ServingEngine(mesh=)`` on a (2, 1) mesh of gloo ranks sharing the
    card (reduced llama3.2-3b, 8 replicas, 4 per rank, the last
    sign-flipped, ``bulyan-krum`` over ``fused``): every admission and
    decode step of a rank launches exactly one K5 (a decode step also one
    decode attention per layer for the rank's replicas), the poisoned
    replica is never selected, the first decode step's gathered stack
    matches the single-device engine's and the rank's aggregate equals
    ``aggregate_logits`` on one device on it bit for bit, and the streams
    equal the single-device engine's."""
    import numpy as np

    import torch_serve_mesh_check as serve_check
    from repro_torch.dist.mesh import run_on_mesh

    rng = np.random.default_rng(5)
    reqs = [(rid, rng.integers(0, 1024, 8).astype(np.int32), 4)
            for rid in range(3)]
    setting = dict(arch="llama3_2_3b", layers=None, n=8, f=1, seed=1,
                   reqs=reqs, slots=2, cache_len=32, runs=("token",))
    single = run_on_mesh(serve_check.serve_rank, (1, 1),
                         args=(dict(setting, single=True),), device="cuda",
                         backend="gloo", timeout=600)[0]["token"]
    res = run_on_mesh(serve_check.serve_rank, (2, 1), args=(setting,),
                      device="cuda", backend="gloo", timeout=600)
    k5 = {k: 0 for k in _build.LAUNCHES}
    k5.update(pairwise_gram_partial=1, select_weights=1, fused_coordinate=1,
              fused_aggregate=3)
    per_call = {"admit": k5, "decode": dict(k5, decode_attention=2)}
    for r in res:
        run = r["token"]
        assert r["n_local"] == 4
        for kind in ("admit", "decode"):
            assert run["calls"][kind]
            for c in run["calls"][kind]:
                assert c["launches"] == per_call[kind] and c["byz"] == 0.0
        assert run["on_stack"]
        got, want = run["stack"].double(), single["stack"].double()
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
        assert run["streams"] == single["streams"]


# ---------------------------------------------------------------------------
# the grouped GEMM of the dropless expert layer
# ---------------------------------------------------------------------------

def _groups(sizes, extra, card):
    from itertools import accumulate
    offs = torch.tensor([0] + list(accumulate(sizes)), device=card)
    return offs, sum(sizes) + extra


@pytest.mark.parametrize("k,n", [(64, 96), (136, 40), (512, 72)])
def test_grouped_gemm_matches_its_oracle(card, k, n):
    """Forward, the transposed product (dX) and dW against the per-group
    ``torch.mm`` loop, on groups of 0, 1, 130, 127 and 300 rows with 37
    rows past the last: empty groups, ragged tiles, rows of no group
    zero; the row counter counts each group once per counted call."""
    from repro_torch.kernels import grouped_gemm as gg
    sizes = [0, 1, 130, 127, 300]
    offs, m = _groups(sizes, 37, card)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(m, k, generator=g).to(card)
    w = torch.randn(len(sizes), k, n, generator=g).to(card)
    dy = torch.randn(m, n, generator=g).to(card)
    s, e = offs[:-1], offs[1:]
    gg.reset_expert_rows()
    _build.reset_launches()
    got = torch.ops.repro_torch.gmm(x, w, s, e, False, 3 * gg.COUNTER_EXPERTS)
    want = gg.grouped_mm_plain(x, w, s.tolist(), e.tolist())
    assert _rel(got, want) < 1e-5 and torch.all(got[sum(sizes):] == 0)
    got = torch.ops.repro_torch.gmm(dy, w, s, e, True, -1)
    want = gg.grouped_mm_plain(dy, w, s.tolist(), e.tolist(), trans_w=True)
    assert _rel(got, want) < 1e-5
    got = torch.ops.repro_torch.gmm_dw(x, dy, s, e)
    want = torch.stack([x[a:b].T @ dy[a:b] for a, b in
                        zip(s.tolist(), e.tolist())])
    assert _rel(got, want) < 1e-5 and torch.all(got[0] == 0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["grouped_gemm"] == 3
    assert gg.expert_rows()[3, :len(sizes)].tolist() == sizes


def test_grouped_gemm_vmap_grad_on_the_card(card):
    """The train step's form: ``vmap(grad)`` over 3 workers with their
    own groups, against the CPU oracle's gradients."""
    from repro_torch.kernels import grouped_gemm as gg
    g = torch.Generator().manual_seed(4)
    k, n, m = 32, 48, 200
    w = torch.randn(4, k, n, generator=g)
    x = torch.randn(3, m, k, generator=g)
    offs = torch.tensor([[0, 50, 50, 120, 190], [0, 0, 200, 200, 200],
                         [0, 10, 20, 30, 40]])

    def loss(xb, wb, ob):
        y = gg.grouped_mm(xb, wb, ob)
        return (y * y).sum()
    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                           in_dims=(0, None, 0))
    gx, gw = grad(x, w, offs)
    cx, cw = grad(x.to(card), w.to(card), offs.to(card))
    assert _rel(cx.cpu(), gx) < 1e-5 and _rel(cw.cpu(), gw) < 1e-5


# ---------------------------------------------------------------------------
# the decode attention over the serving cache
# ---------------------------------------------------------------------------

def _attn_inputs(card, n, b, length, hkv, g, sq, d, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, device=card, generator=gen).to(dtype)
    return (draw(n, b, sq, hkv * g, d), draw(n, b, length, hkv, d),
            draw(n, b, length, hkv, d))


def _attn_plain(q, k, v, lens):
    """The op's plain path (the ``einsum`` body), run on the card."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k, v, lens)


#: serve-chat's slot lengths at the edges of a piece and a tile
CELL_LENGTHS = [1, 127, 128, 129, 1020, 2047, 2048, 1, 2048, 255, 1190,
                1500]


def test_decode_attention_at_the_serving_cells_shapes(card):
    """84 rows (7 replicas x 12 slots), 20 heads of 128, 2,048
    positions, lengths at the pieces' and tiles' edges: within 1e-5 of
    the plain path's largest entry, one launch counted."""
    q, k, v = _attn_inputs(card, 7, 12, 2048, 20, 1, 1, 128, torch.float32,
                           0)
    lens = torch.tensor(CELL_LENGTHS, dtype=torch.int32,
                        device=card).repeat(7, 1)[:, :, None]
    _build.reset_launches()
    got = torch.ops.repro_torch.decode_attention(q, k, v, lens)
    assert _build.LAUNCHES == dict(dict.fromkeys(_build.LAUNCHES, 0),
                                   decode_attention=1)
    assert _rel(got, _attn_plain(q, k, v, lens)) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
def test_decode_attention_matches_plain(card, d, g, dtype, tol):
    """Every head dim, GQA groups of 1, 4 and 8, and blocks of 1 to 5
    queries each attending to its own causal prefix (as a verify block),
    over lengths that take one piece and several."""
    for sq in range(1, 6):
        for length in (61, 700):
            q, k, v = _attn_inputs(card, 2, 3, length, 2, g, sq, d, dtype,
                                   sq)
            gen = torch.Generator(device=card).manual_seed(sq)
            first = torch.randint(1, length - sq + 2, (2, 3, 1), device=card,
                                  generator=gen, dtype=torch.int32)
            lens = first + torch.arange(sq, device=card, dtype=torch.int32)
            got = torch.ops.repro_torch.decode_attention(q, k, v, lens)
            assert got.dtype == dtype
            assert _rel(got, _attn_plain(q, k, v, lens)) <= tol, (sq, length)


def test_decode_attention_identical_rows_give_identical_bits(card):
    """Rows holding the same queries, cache and lengths agree bit for bit
    within one launch (the serving cell's six honest replicas), with the
    length split into pieces and not."""
    for length in (200, 2048):
        q, k, v = _attn_inputs(card, 1, 6, length, 4, 2, 2, 64,
                               torch.float32, 3)
        q, k, v = (t[:, :1].expand(7, 6, *t.shape[2:]).contiguous()
                   for t in (q, k, v))
        lens = torch.tensor([[[length // 3, length // 3 + 1]]], device=card,
                            dtype=torch.int32).expand(7, 6, 2).contiguous()
        got = torch.ops.repro_torch.decode_attention(q, k, v, lens)
        assert all(torch.equal(got[i, j], got[0, 0]) for i in range(7)
                   for j in range(6))


def test_decode_attention_vmap_on_a_period_view_is_the_replica_loop(card):
    """The robust steps' form: ``vmap`` over the replicas of a period
    view of a replica-stacked cache leaf ``(R, P, B, L, H, D)`` (read in
    place), one launch for every replica, against one call per replica
    bit for bit and the plain path at 1e-5."""
    from repro_torch.models.attention import decode_attention
    r, p, b, length, hkv, d = 3, 2, 4, 1000, 4, 64
    gen = torch.Generator(device=card).manual_seed(8)
    k = torch.randn(r, p, b, length, hkv, d, device=card, generator=gen)
    v = torch.randn(r, p, b, length, hkv, d, device=card, generator=gen)
    q = torch.randn(r, b, 1, 2 * hkv, d, device=card, generator=gen)
    valid = torch.tensor([1, 300, 999, 1000], device=card)
    _build.reset_launches()
    got = torch.func.vmap(lambda qq, kk, vv: decode_attention(
        qq, kk[1], vv[1], valid))(q, k, v)
    assert _build.LAUNCHES["decode_attention"] == 1
    loop = torch.stack([decode_attention(q[i], k[i, 1], v[i, 1], valid)
                        for i in range(r)])
    assert torch.equal(got, loop)
    lens = valid[None, :, None].expand(r, b, 1)
    assert _rel(got, _attn_plain(q, k[:, 1], v[:, 1], lens)) <= 1e-5


def test_decode_step_at_the_serving_cells_shapes_copies_no_cache(card):
    """One ensemble decode step at serve-chat's shapes (qwen1.5-4b's
    widths at 4 layers, 7 replicas, 12 slots of 2,048 positions): each
    layer's decode attention grows the allocated memory by under 64 MiB
    over what it is handed (one layer's keys alone are 1.76 GB), and the
    whole step by less than one layer's keys."""
    import dataclasses

    from repro_torch.agg import AggSpec
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_robust import (make_robust_serve_step,
                                               replicate_cache,
                                               replicate_params)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import init_cache, init_model
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), n_layers=4)
    params = replicate_params(init_model(0, cfg, device=card), 7)
    cache = replicate_cache(init_cache(cfg, 12, 2048, device=card), 7)
    step = make_robust_serve_step(cfg, AggSpec(f=1, gar="bulyan-krum",
                                               distance_backend="fused"))
    token = torch.zeros((12, 1), dtype=torch.int32, device=card)
    pos = torch.tensor([l - 1 for l in CELL_LENGTHS], dtype=torch.int32,
                       device=card)
    growth, op, depth = [], da._decode_attention, [0]

    def measured(*args):
        # the vmap rule calls the op again, on the folded replicas
        depth[0] += 1
        if depth[0] > 1:
            out = op(*args)
        else:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = op(*args)
            torch.cuda.synchronize()
            growth.append(torch.cuda.max_memory_allocated() - before)
        depth[0] -= 1
        return out

    step(params, cache, token, pos)  # warm
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    da._decode_attention = measured
    try:
        step(params, cache, token, pos)
    finally:
        da._decode_attention = op
    torch.cuda.reset_peak_memory_stats()
    step(params, cache, token, pos)
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - resident
    layer_keys = cache["periods"]["s0"]["k"][:, 0].numel() * 4
    assert len(growth) == 4
    assert max(growth) < 64 * 2 ** 20, growth
    assert whole < layer_keys, (whole, layer_keys)


def test_decode_attention_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _attn_inputs(card, 1, 2, 64, 2, 2, 1, 64, torch.float32, 9)
    lens = torch.full((1, 2, 1), 64, dtype=torch.int32, device=card)
    op = torch.ops.repro_torch.decode_attention
    with pytest.raises(TypeError):
        op(q.half(), k.half(), v.half(), lens)
    with pytest.raises(TypeError):
        op(q, k.to(torch.bfloat16), v, lens)
    with pytest.raises(ValueError):  # head dim 48
        op(q[..., :48].contiguous(), k[..., :48].contiguous(),
           v[..., :48].contiguous(), lens)
    with pytest.raises(ValueError):  # (L, Hkv, D) not dense
        op(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, lens)
    with pytest.raises(ValueError):
        op(q, k, v, lens[..., :0])

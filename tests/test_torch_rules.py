"""Port parity of the aggregation rules, the registry and the attacks:
repro_torch.core / repro_torch.agg against repro.core / repro.agg on the
same numpy inputs, at the reference's fp32 tolerance (1e-4), with
selections compared exactly.  Includes the traps found in the reference:
population std, the even-n median, and the sign of zero in the "anti"
direction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import registry as jreg  # noqa: E402
from repro.agg.specs import AggSpec as JaxSpec  # noqa: E402
from repro.core import attacks as jatk  # noqa: E402
from repro.core import bulyan as jbul  # noqa: E402
from repro.core import gars as jgars  # noqa: E402
from repro_torch.agg import registry as treg  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.core import attacks as tatk  # noqa: E402
from repro_torch.core import bulyan as tbul  # noqa: E402
from repro_torch.core import gars as tgars  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack(n, d, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 0.5 + 1.0).astype(np.float32)


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    scale = max(1.0, float(np.max(np.abs(want[finite]), initial=0.0)))
    assert np.max(np.abs(got[finite] - want[finite]), initial=0.0) <= (
        tol * scale)


RULES = ["average", "krum", "multikrum", "geomed", "cwmed", "trimmed_mean",
         "bulyan-krum", "bulyan-geomed", "fused-krum", "fused-bulyan-krum",
         "fused-cwmed"]


#: rules whose arithmetic branches on the parity of n
EVEN_N_RULES = ["cwmed", "trimmed_mean", "multikrum", "fused-cwmed"]


class TestDenseRules:
    @pytest.mark.parametrize("name,n,f",
                             [(r, 11, 2) for r in RULES]
                             + [(r, 12, 2) for r in EVEN_N_RULES])
    def test_matches_reference(self, name, n, f):
        g = _stack(n, 60, seed=n)
        want = jax.jit(jreg.resolve_rule(name).dense_fn,
                       static_argnums=1)(jnp.asarray(g), f)
        got = treg.resolve_rule(name).dense_fn(torch.from_numpy(g), f)
        _close(got.gradient.numpy(), np.asarray(want.gradient))
        assert np.array_equal(got.selected.numpy(),
                              np.asarray(want.selected))
        _close(got.scores.numpy(), np.asarray(want.scores))

    def test_cwmed_even_n_is_mean_of_middle_pair(self):
        """The median trap: torch.median returns the lower middle value,
        jnp.median the mean of the two middle ones."""
        g = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
        got = tgars.cwmed(torch.from_numpy(g), 1).gradient
        want = jgars.cwmed(jnp.asarray(g), 1).gradient
        assert float(got[0]) == float(want[0]) == 2.5

    def test_pairwise_sq_dists(self):
        g = _stack(9, 40)
        _close(tgars.pairwise_sq_dists(torch.from_numpy(g)).numpy(),
               np.asarray(jgars.pairwise_sq_dists(jnp.asarray(g))))

    @pytest.mark.parametrize("n_rem", [9, 7])
    def test_scores_with_mask(self, n_rem):
        n, f = 9, 2
        g = _stack(n, 40)
        mask = np.arange(n) < n_rem
        d2 = np.asarray(jgars.pairwise_sq_dists(jnp.asarray(g)))
        tj, mj = jnp.asarray(d2), jnp.asarray(mask)
        tt, mt = torch.from_numpy(d2.copy()), torch.from_numpy(mask)
        _close(tgars.krum_scores(tt, mt, f, n_rem).numpy(),
               np.asarray(jgars.krum_scores(tj, mj, f, n_rem)))
        _close(tgars.geomed_scores(tt, mt).numpy(),
               np.asarray(jgars.geomed_scores(tj, mj)))
        assert int(tgars.krum_select(tt, mt, f, n_rem)) == int(
            jgars.krum_select(tj, mj, f, n_rem))
        assert int(tgars.geomed_select(tt, mt)) == int(
            jgars.geomed_select(tj, mj))


class TestBulyan:
    @pytest.mark.parametrize("base", ["krum", "geomed"])
    @pytest.mark.parametrize("f", [1, 2])
    def test_select_indices_from_dists(self, base, f):
        n = 4 * f + 4
        d2 = np.array(jgars.pairwise_sq_dists(jnp.asarray(_stack(n, 50))))
        want = jax.jit(jbul.select_indices_from_dists,
                       static_argnums=(1, 2))(jnp.asarray(d2), f, base)
        got = tbul.select_indices_from_dists(torch.from_numpy(d2), f, base)
        assert np.array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("theta,f", [(5, 0), (7, 1), (11, 2), (13, 3)])
    def test_coordinate_phase(self, theta, f):
        s = _stack(theta, 80, seed=theta)
        _close(tbul.coordinate_phase(torch.from_numpy(s), f).numpy(),
               np.asarray(jbul.coordinate_phase(jnp.asarray(s), f)))

    def test_quorum_errors(self):
        g = torch.from_numpy(_stack(6, 10))
        with pytest.raises(ValueError, match="bulyan requires n >= 4f"):
            tbul.make_bulyan("krum")(g, 1)
        # Bulyan over a base without a recursion resolves, and raises the
        # reference's KeyError when it runs
        g = _stack(7, 10)
        text = "unsupported bulyan base 'cwmed'"
        with pytest.raises(KeyError, match=text):
            treg.resolve_rule("bulyan-cwmed").dense_fn(torch.from_numpy(g), 1)
        with pytest.raises(KeyError, match=text):
            jreg.resolve_rule("bulyan-cwmed").dense_fn(jnp.asarray(g), 1)


# ---------------------------------------------------------------------------
# the two parity faults of the re-anchor after PR 15, pinned on their inputs
# ---------------------------------------------------------------------------

def _f1_stack():
    """Values on a 0.1 grid: many window deviations tie exactly in fp32,
    so the order of the prefix sums decides the window."""
    return np.round(np.random.default_rng(0).standard_normal((39, 2000)),
                    1).astype(np.float32)


def _f2_stack():
    """Worker 4's Krum score is a NaN with the sign bit set (inf - inf)."""
    x = np.random.default_rng(0).standard_normal((11, 37)).astype(np.float32)
    x[4, 6] = np.inf
    return x


def _same_nonfinite(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))


class TestFaults:
    """F1: Bulyan's window sums must be fp32 sums in row order.  F2:
    multikrum's top-m must rank a NaN score by its sign bit, as
    ``lax.top_k`` does."""

    def test_f1_coordinate_phase(self):
        s = _f1_stack()[:21]
        got = tbul.coordinate_phase(torch.from_numpy(s), 9).numpy()
        want = np.asarray(jbul.coordinate_phase(jnp.asarray(s), 9))
        _close(got, want)

    @pytest.mark.parametrize("name", ["bulyan-krum", "bulyan-geomed"])
    def test_f1_flat_bulyan(self, name):
        x = _f1_stack()
        want = jreg.resolve_rule(name).dense_fn(jnp.asarray(x), 9)
        got = treg.resolve_rule(name).dense_fn(torch.from_numpy(x), 9)
        _close(got.gradient.numpy(), np.asarray(want.gradient))
        assert np.array_equal(got.selected.numpy(),
                              np.asarray(want.selected))

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_f1_tree_bulyan(self, backend):
        from repro.dist import robust as jrobust
        from repro_torch.dist import robust as trobust
        x = _f1_stack()
        tree = {"a": x[:, :1200], "b": x[:, 1200:]}
        jagg, jres = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, 9, "bulyan-krum",
            distance_backend=backend)
        tagg, tres = trobust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, 9,
            "bulyan-krum", distance_backend=backend)
        for k in tree:
            _close(tagg[k].numpy(), np.asarray(jagg[k]))
        assert np.array_equal(tres.selected.numpy(),
                              np.asarray(jres.selected))

    def test_f2_flat_multikrum(self):
        x = _f2_stack()
        want = jgars.multikrum(jnp.asarray(x), 2)
        got = tgars.multikrum(torch.from_numpy(x), 2)
        assert np.array_equal(got.selected.numpy(),
                              np.asarray(want.selected))
        _same_nonfinite(got.gradient.numpy(), np.asarray(want.gradient))
        _close(got.gradient.numpy(), np.asarray(want.gradient))

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_f2_tree_multikrum(self, backend):
        from repro.dist import robust as jrobust
        from repro_torch.dist import robust as trobust
        x = _f2_stack()
        tree = {"a": x[:, :20], "b": x[:, 20:]}
        jagg, jres = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, 2, "multikrum",
            distance_backend=backend)
        tagg, tres = trobust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, 2,
            "multikrum", distance_backend=backend)
        assert np.array_equal(tres.selected.numpy(),
                              np.asarray(jres.selected))
        for k in tree:
            _same_nonfinite(tagg[k].numpy(), np.asarray(jagg[k]))
            _close(tagg[k].numpy(), np.asarray(jagg[k]))

    @pytest.mark.parametrize("vals", [
        [1.0, float("nan"), -float("nan"), -0.0, 0.0, float("inf"),
         -float("inf"), 1.0, 2.0],
        [float("nan")] * 3 + [0.5] * 3,
        [-0.0, 0.0, -0.0, 0.0]])
    def test_top_k_total_order_matches_lax_top_k(self, vals):
        v = np.array(vals, np.float32)
        m = len(vals)
        want = np.asarray(jax.lax.top_k(jnp.asarray(v), m)[1])
        got = tgars.top_k_total_order(torch.from_numpy(v), m).numpy()
        assert np.array_equal(got, want), (got, want)


class TestRegistry:
    def test_unknown_name_keyerror_text(self):
        with pytest.raises(KeyError) as got:
            treg.resolve_rule("no-such-gar")
        with pytest.raises(KeyError) as want:
            jreg.resolve_rule("no-such-gar")
        # same template; each package lists its own registered rules
        assert str(got.value) == str(want.value).replace(
            repr(sorted(jreg.RULES)), repr(sorted(treg.RULES)))

    @pytest.mark.parametrize("name", ["buffered-krum", "stale-krum",
                                      "reputation-krum", "obs-krum",
                                      "brute", "centered_clip"])
    def test_unported_families_raise(self, name):
        """Only the telemetry family is still unported; the others resolve
        with the reference's contract."""
        if name.startswith("obs-"):
            with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
                treg.resolve_rule(name)
            return
        t, j = treg.resolve_rule(name), jreg.resolve_rule(name)
        for f in (0, 2):
            assert t.min_n(f) == j.min_n(f)
        assert (t.stateful, t.state_fields, t.history_window,
                t.byzantine_resilient, t.invariants) == (
            j.stateful, j.state_fields, j.history_window,
            j.byzantine_resilient, j.invariants)

    @pytest.mark.parametrize("name", ["krum", "bulyan-krum", "cwmed",
                                      "fused-bulyan-krum", "fused-krum",
                                      "geomed", "average"])
    @pytest.mark.parametrize("f", [0, 2, 9])
    def test_quorum_and_flags(self, name, f):
        assert treg.quorum(name, f) == jreg.quorum(name, f)
        t, j = treg.resolve_rule(name), jreg.resolve_rule(name)
        assert t.byzantine_resilient == j.byzantine_resilient
        assert t.invariants == j.invariants

    def test_fused_unknown_base(self):
        with pytest.raises(KeyError, match="no fused lowering"):
            treg.resolve_rule("fused-average")


class TestSpec:
    @pytest.mark.parametrize("kw", [
        dict(n_workers=10, f=2, gar="fused-bulyan-krum"),
        dict(n_workers=4, f=1, gar="krum"),
        dict(n_workers=None, f=1, gar="krum"),
        dict(n_workers=6, f=2, declared_f=3, gar="geomed"),
    ])
    def test_validate_texts(self, kw):
        with pytest.raises(ValueError) as want:
            JaxSpec(**kw).validate()
        with pytest.raises(ValueError) as got:
            AggSpec(**kw).validate()
        assert str(got.value) == str(want.value)

    def test_fields(self):
        s = AggSpec(n_workers=39, f=9, gar="fused-bulyan-krum")
        j = JaxSpec(n_workers=39, f=9, gar="fused-bulyan-krum")
        assert (s.n_honest, s.f_declared) == (j.n_honest, j.f_declared)
        s.validate()


class TestAttacks:
    def test_delta_bar_is_population_std(self):
        """The std trap: jnp.std is the population std (ddof 0)."""
        h = _stack(6, 30)
        got = float(tatk._delta_bar(torch.from_numpy(h)))
        want = float(jatk._delta_bar(jnp.asarray(h)))
        assert abs(got - want) <= TOL * abs(want)
        ddof1 = 2.0 / np.sqrt(np.pi) * np.mean(np.std(h, axis=0, ddof=1))
        assert abs(got - ddof1) > 10 * TOL * abs(want)

    @pytest.mark.parametrize("direction", ["anti", "ones"])
    @pytest.mark.parametrize("gamma", ["closed", 0.7])
    def test_omniscient_linf(self, direction, gamma):
        h = _stack(8, 50)
        kw = dict(gamma=gamma, gar_name="krum", margin=0.8,
                  direction=direction)
        want = jatk.omniscient_linf(jnp.asarray(h), 3, None, **kw)
        got = tatk.omniscient_linf(torch.from_numpy(h), 3, None, **kw)
        assert got.shape == (3, 50)
        _close(got.numpy(), np.asarray(want))

    def test_sign_of_zero_counts_as_plus_one(self):
        """jnp.sign(0) = 0 is mapped to +1 in the "anti" direction."""
        h = _stack(4, 6)
        h[:, 2] = [1.0, -1.0, 2.0, -2.0]      # honest mean exactly 0
        kw = dict(gamma=0.5, direction="anti")
        got = tatk.omniscient_linf(torch.from_numpy(h), 1, None, **kw)
        want = jatk.omniscient_linf(jnp.asarray(h), 1, None, **kw)
        assert float(got[0, 2]) == float(want[0, 2]) == 0.5

    @pytest.mark.parametrize("coord", [0, 7, "top", "rotate"])
    def test_omniscient_lp_closed(self, coord):
        h = _stack(8, 40)
        kw = dict(gamma="closed", coord=coord, gar_name="bulyan-krum",
                  margin=0.8, step=13)
        want = jatk.omniscient_lp(jnp.asarray(h), 2, None, **kw)
        got = tatk.omniscient_lp(torch.from_numpy(h), 2, None, **kw)
        _close(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("attack", ["omniscient_lp", "omniscient_linf"])
    def test_gamma_search(self, attack):
        """gamma=None: growth + bisection against the rule itself."""
        h = _stack(8, 20)
        kw = dict(gamma=None, gar_name="krum")
        want = jatk.get_attack(attack)(jnp.asarray(h), 3,
                                       jax.random.PRNGKey(0), **kw)
        got = tatk.get_attack(attack)(torch.from_numpy(h), 3, None, **kw)
        _close(got.numpy(), np.asarray(want), 1e-3)

    @pytest.mark.parametrize("rule", ["krum", "geomed", "brute"])
    def test_gamma_closed_form(self, rule):
        assert tatk.gamma_closed_form(rule, 1000, 9, 0.3) == (
            jatk.gamma_closed_form(rule, 1000, 9, 0.3))

    @pytest.mark.parametrize("name", ["zero", "signflip"])
    def test_baselines(self, name):
        h = _stack(5, 30)
        want = jatk.get_attack(name)(jnp.asarray(h), 2, None)
        got = tatk.get_attack(name)(torch.from_numpy(h), 2, None)
        _close(got.numpy(), np.asarray(want))

    def test_unported_and_unknown(self):
        """Every attack of the reference is ported; an unknown name raises
        the reference's KeyError."""
        assert sorted(tatk.ATTACKS) == sorted(jatk.ATTACKS)
        with pytest.raises(KeyError) as got:
            tatk.get_attack("nope")
        with pytest.raises(KeyError) as want:
            jatk.get_attack("nope")
        assert str(got.value) == str(want.value)

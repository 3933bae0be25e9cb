"""Port parity of the flat asynchronous runtime: the gradient bus
(``repro_torch.dist.async_train``), ``async_extras``, the stateful
attacks, and ``make_async_byzantine_step`` / ``AsyncByzantineTrainer``
against the JAX reference.

The asynchronous step runs 5 steps on a narrow two-layer MLP (12 inputs,
8 tanh units, 3 classes), n = 7, f = 1, under the ``fixed`` delay
schedule with tau = 0, 2 and a bound per worker, from the same numpy
parameters and batches in both packages.  Parameters agree to 1e-4
relative (1e-6 absolute floor) after every step, ``byz_weight`` and the
staleness metrics exactly.  tau = 0 reproduces the synchronous step bit
for bit on the port, as in the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg.specs import AggSpec as JaxSpec  # noqa: E402
from repro.core import attacks as jatk  # noqa: E402
from repro.dist import async_train as jasync  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.optim import get_optimizer as jget  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.core import attacks as tatk  # noqa: E402
from repro_torch.dist import async_train as tasync  # noqa: E402
from repro_torch.dist import robust as trobust  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402

N, F, STEPS = 7, 1, 5
N_IN, N_HID, N_OUT, BATCH = 12, 8, 3, 6
LINF = (("gar_name", "krum"), ("gamma", "closed"), ("direction", "anti"),
        ("margin", 0.8))
TAUS = {"tau0": 0, "tau2": 2, "per_worker": (0, 1, 2, 3, 0, 1, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (0.4 * rng.standard_normal((N_IN, N_HID))).astype(
                np.float32),
            "b1": np.zeros(N_HID, np.float32),
            "w2": (0.4 * rng.standard_normal((N_HID, N_OUT))).astype(
                np.float32),
            "b2": np.zeros(N_OUT, np.float32)}


class _Batcher:
    """Per-honest-worker batches from a seed: the class shifts the
    inputs' mean, so the task is learnable."""

    def __init__(self, n_honest, seed=1):
        self.n_honest, self.seed = n_honest, seed

    def batch(self, t):
        rng = np.random.default_rng((self.seed, t))
        y = rng.integers(0, N_OUT, (self.n_honest, BATCH))
        x = rng.standard_normal((self.n_honest, BATCH, N_IN)) + y[..., None]
        return x.astype(np.float32), y.astype(np.int32)


def _jloss(p, x, y):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _tloss(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.nn.functional.cross_entropy(h @ p["w2"] + p["b2"], y)


def _close_params(got, want):
    for k in want:
        g = got[k].numpy().astype(np.float64)
        w = np.asarray(want[k], np.float64)
        bad = np.abs(g - w) > 1e-4 * np.abs(w) + 1e-6
        assert not bad.any(), (k, g[bad][:5], w[bad][:5])


def _run_both(spec_kw, steps=STEPS):
    """The asynchronous step in both packages from the same parameters
    and batches; returns both parameter dicts and metric lists after
    checking the parameters after every step."""
    jspec, tspec = JaxSpec(**spec_kw), AggSpec(**spec_kw)
    n_h = tspec.n_honest
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jopt, topt = jget("sgd", 0.1), get_optimizer("sgd", 0.1)
    jo, to = jopt.init(jp), topt.init(tp)
    js = jtrainer.init_flat_async_state(jspec, jp)
    ts = ttrainer.init_flat_async_state(tspec, tp)
    jstep = jax.jit(jtrainer.make_async_byzantine_step(_jloss, jopt, jspec))
    tstep = ttrainer.make_async_byzantine_step(_tloss, topt, tspec)
    batcher = _Batcher(n_h)
    jm, tm = [], []
    for t in range(steps):
        x, y = batcher.batch(t)
        jp, jo, m1, js = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y),
                               jax.random.PRNGKey(t), js)
        tp, to, m2, ts = tstep(tp, to, torch.from_numpy(x),
                               torch.from_numpy(y).long(), None, ts)
        _close_params(tp, jp)
        jm.append({k: float(v) for k, v in m1.items()})
        tm.append({k: float(v) for k, v in m2.items()})
    return tp, jp, tm, jm, ts, js


RULES = ["krum", "stale-krum", "stale-bulyan-krum", "reputation-krum",
         "buffered-cwmed", "stale-exp-reputation-krum"]


class TestAsyncStep:
    @pytest.mark.parametrize("tau", list(TAUS))
    @pytest.mark.parametrize("gar", RULES)
    def test_matches_reference(self, gar, tau):
        kw = dict(n_workers=N, f=F, gar=gar, attack="omniscient_linf",
                  attack_kwargs=LINF, async_tau=TAUS[tau])
        _, _, tm, jm, ts, js = _run_both(kw)
        assert sorted(tm[0]) == sorted(jm[0])
        for a, b in zip(tm, jm):
            for key in ("byz_weight", "staleness_mean", "staleness_max",
                        "staleness_excess", "delivered"):
                assert a[key] == b[key], key
            for key in ("loss", "agg_dev", "grad_norm"):
                assert abs(a[key] - b[key]) <= 1e-4 * max(1.0, abs(b[key]))
        assert np.array_equal(ts.bus.versions.numpy(),
                              np.asarray(js.bus.versions))

    @pytest.mark.parametrize("attack,akw", [
        ("stale_replay", (("hold", 3),)), ("slow_drift", ()),
        ("reputation_burn", (("build", 2),)),
        ("colluding_majority", (("direction", "anti"),))])
    def test_stateful_attacks_through_the_step(self, attack, akw):
        kw = dict(n_workers=N, f=F, gar="stale-krum", attack=attack,
                  attack_kwargs=akw, async_tau=2)
        _, _, tm, jm, ts, js = _run_both(kw)
        n_h = N - F
        np.testing.assert_allclose(ts.bus.grads[n_h:].numpy(),
                                   np.asarray(js.bus.grads[n_h:]),
                                   rtol=1e-4, atol=1e-6)

    def test_clean_run_has_n_honest_rows(self):
        kw = dict(n_workers=N, f=F, gar="stale-cwmed", attack="none",
                  async_tau=1)
        _, _, tm, jm, ts, js = _run_both(kw, steps=3)
        assert tuple(ts.bus.grads.shape) == tuple(js.bus.grads.shape)
        assert [m["delivered"] for m in tm] == [m["delivered"] for m in jm]


class TestTauZeroIsSynchronous:
    @pytest.mark.parametrize("gar", ["krum", "stale-krum",
                                     "stale-bulyan-krum", "reputation-krum",
                                     "buffered-krum"])
    def test_bitwise(self, gar):
        """tau = 0: every worker delivers every step, so the async step
        gives the synchronous step's parameters bit for bit."""
        spec = AggSpec(n_workers=N, f=F, gar=gar, attack="omniscient_linf",
                       attack_kwargs=LINF, async_tau=0)
        opt = get_optimizer("sgd", 0.1)
        p0 = {k: torch.from_numpy(v) for k, v in _params().items()}
        ap, ao = dict(p0), opt.init(p0)
        sp, so = dict(p0), opt.init(p0)
        astate = ttrainer.init_flat_async_state(spec, p0)
        sstate = ttrainer.init_flat_agg_state(spec, p0)
        astep = ttrainer.make_async_byzantine_step(_tloss, opt, spec)
        sstep = ttrainer.make_byzantine_step(_tloss, opt, spec)
        batcher = _Batcher(N - F)
        for t in range(3):
            x, y = batcher.batch(t)
            x, y = torch.from_numpy(x), torch.from_numpy(y).long()
            ap, ao, am, astate = astep(ap, ao, x, y, None, astate)
            if sstate is None:
                sp, so, sm = sstep(sp, so, x, y)
            else:
                sp, so, sm, sstate = sstep(sp, so, x, y, None, sstate)
            for k in p0:
                assert torch.equal(ap[k], sp[k]), (gar, t, k)
            for k in sm:
                assert torch.equal(am[k], sm[k]), (gar, t, k)


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------

class TestBus:
    @pytest.mark.parametrize("tau", [0, 1, 3, (0, 1, 2, 3, 4, 0, 2)])
    def test_fixed_schedule_matches_reference(self, tau):
        jt, tt = jasync.resolve_tau(tau, N), tasync.resolve_tau(tau, N)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        v = np.zeros(N, np.int32)
        for step in range(12):
            want = jasync.delivery_mask(step, jnp.asarray(v), jt)
            got = tasync.delivery_mask(step, torch.from_numpy(v), tt)
            assert np.array_equal(got.numpy(), np.asarray(want)), step
            v = np.where(np.asarray(want), step, v).astype(np.int32)

    @pytest.mark.parametrize("tau", [0, 2, (0, 1, 2, 3, 4, 0, 2)])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_random_schedule_keeps_its_bound(self, tau, seed):
        t_tau = tasync.resolve_tau(tau, N)
        v = torch.zeros(N, dtype=torch.int32)
        for step in range(40):
            m = tasync.delivery_mask(step, v, t_tau, "random", seed)
            if step == 0 or tau == 0:
                assert bool(m.all())
            again = tasync.delivery_mask(step, v, t_tau, "random", seed)
            assert torch.equal(m, again)      # a function of (seed, step)
            v = torch.where(m, torch.full_like(v, step), v)
            assert bool(((step - v) <= t_tau).all())

    def test_update_bus_and_excess_match_reference(self):
        rng = np.random.default_rng(3)
        x0 = rng.standard_normal((N, 5)).astype(np.float32)
        x1 = rng.standard_normal((N, 5)).astype(np.float32)
        deliver = np.array([1, 0, 1, 1, 0, 0, 1], bool)
        jb = jasync.update_bus(jasync.init_bus(jnp.asarray(x0)),
                               jnp.asarray(x0), 0, jnp.ones(N, bool))
        tb = tasync.update_bus(tasync.init_bus(torch.from_numpy(x0)),
                               torch.from_numpy(x0), 0,
                               torch.ones(N, dtype=torch.bool))
        jb = jasync.update_bus(jb, jnp.asarray(x1), 4, jnp.asarray(deliver))
        tb = tasync.update_bus(tb, torch.from_numpy(x1), 4,
                               torch.from_numpy(deliver))
        assert torch.equal(tb.grads, torch.from_numpy(np.asarray(jb.grads)))
        assert np.array_equal(tb.versions.numpy(), np.asarray(jb.versions))
        assert np.array_equal(tb.arrival_step.numpy(),
                              np.asarray(jb.arrival_step))
        tau = (1, 1, 2, 3, 4, 5, 0)
        want = jasync.staleness_excess(jb, 6, jasync.resolve_tau(tau, N))
        got = tasync.staleness_excess(tb, 6, tasync.resolve_tau(tau, N))
        assert np.array_equal(got.numpy(), np.asarray(want))
        deliver_t = torch.from_numpy(deliver)
        want_m = jschema.async_extras(6 - jb.versions, want,
                                      jnp.asarray(deliver))
        got_m = tschema.async_extras(6 - tb.versions, got, deliver_t)
        assert {k: float(v) for k, v in got_m.items()} == {
            k: float(v) for k, v in want_m.items()}

    def test_tree_bus_mirrors_the_template(self):
        tree = {"a": torch.zeros((N, 2, 3)), "b": torch.zeros((N, 4),
                                                              dtype=torch.bfloat16)}
        bus = tasync.init_bus(tree)
        assert {k: (tuple(v.shape), v.dtype) for k, v in bus.grads.items()} \
            == {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}
        assert bus.versions.dtype == torch.int32

    @pytest.mark.parametrize("tau", [-1, (0, 1), (0, 0, 0, 0, 0, 0, -2)])
    def test_resolve_tau_errors(self, tau):
        with pytest.raises(ValueError) as want:
            jasync.resolve_tau(tau, N)
        with pytest.raises(ValueError) as got:
            tasync.resolve_tau(tau, N)
        assert str(got.value) == str(want.value)

    def test_unknown_schedule(self):
        with pytest.raises(ValueError) as want:
            jasync.delivery_mask(1, jnp.zeros(N, jnp.int32),
                                 jasync.resolve_tau(1, N), "poisson")
        with pytest.raises(ValueError) as got:
            tasync.delivery_mask(1, torch.zeros(N, dtype=torch.int32),
                                 tasync.resolve_tau(1, N), "poisson")
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("gar,attack", [("krum", "signflip"),
                                            ("stale-krum", "none"),
                                            ("reputation-buffered-krum",
                                             "signflip")])
    def test_init_flat_async_state(self, gar, attack):
        kw = dict(n_workers=N, f=F, gar=gar, attack=attack)
        p = _params()
        js = jtrainer.init_flat_async_state(JaxSpec(**kw),
                                            {k: jnp.asarray(v)
                                             for k, v in p.items()})
        ts = ttrainer.init_flat_async_state(AggSpec(**kw),
                                            {k: torch.from_numpy(v)
                                             for k, v in p.items()})
        assert tuple(ts.bus.grads.shape) == tuple(js.bus.grads.shape)
        for field in ("history", "reputation", "center"):
            jv, tv = getattr(js, field), getattr(ts, field)
            assert isinstance(jv, tuple) == isinstance(tv, tuple)
            if not isinstance(tv, tuple):
                assert tuple(tv.shape) == tuple(jv.shape)


# ---------------------------------------------------------------------------
# the stateful attacks, flat and per leaf
# ---------------------------------------------------------------------------

def _honest(seed=2, n_h=6, d=20):
    rng = np.random.default_rng(seed)
    return (1.0 + rng.standard_normal((n_h, d))).astype(np.float32)


STATEFUL = [
    ("stale_replay", dict(step=0)), ("stale_replay", dict(step=4)),
    ("stale_replay", dict(step=6, hold=3, scale=-2.0)),
    ("stale_replay", dict(step=5, hold=3)),
    ("slow_drift", dict(step=0)), ("slow_drift", dict(step=3)),
    ("slow_drift", dict(step=3, eps=2.0, direction="ones")),
    ("reputation_burn", dict(step=2)), ("reputation_burn", dict(step=5)),
    ("reputation_burn", dict(step=9, build=10, scale=1.5)),
    ("colluding_majority", dict(direction="anti")),
    ("colluding_majority", dict(direction="anti", eps=1.0)),
]


class TestStatefulAttacks:
    @pytest.mark.parametrize("with_prev", [False, True])
    @pytest.mark.parametrize("name,kw", STATEFUL)
    def test_flat_matches_reference(self, name, kw, with_prev):
        h = _honest()
        f = 2
        prev = np.full((f, h.shape[1]), 0.25, np.float32)
        kw = dict(kw)
        jkw, tkw = dict(kw), dict(kw)
        if with_prev and name != "colluding_majority":
            jkw["prev"], tkw["prev"] = jnp.asarray(prev), torch.from_numpy(
                prev)
        want = jatk.get_attack(name)(jnp.asarray(h), f, None, **jkw)
        got = tatk.get_attack(name)(torch.from_numpy(h), f, None, **tkw)
        assert got.shape == (f, h.shape[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)

    def test_colluding_random_direction(self):
        """A random unit direction from the generator passed in."""
        h = torch.from_numpy(_honest())
        got = tatk.colluding_majority(h, 3, torch.Generator().manual_seed(5))
        u = torch.randn(h.shape[1], generator=torch.Generator().manual_seed(5))
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        want = h.mean(0) + 4.0 * tatk._delta_bar(h) * u
        assert torch.allclose(got, want.expand(3, -1))
        with pytest.raises(ValueError) as jerr:
            jatk.colluding_majority(jnp.asarray(h.numpy()), 3,
                                    direction="up")
        with pytest.raises(ValueError) as terr:
            tatk.colluding_majority(h, 3, direction="up")
        assert str(terr.value) == str(jerr.value)

    @pytest.mark.parametrize("name,kw", [
        ("stale_replay", dict(step=4)), ("stale_replay", dict(step=3,
                                                              hold=3)),
        ("slow_drift", dict(step=2)), ("slow_drift", dict(step=0)),
        ("slow_drift", dict(step=2, direction="anti"))])
    def test_per_leaf_with_prev(self, name, kw):
        rng = np.random.default_rng(4)
        tree = {"a": rng.standard_normal((N, 3, 2)).astype(np.float32),
                "b": rng.standard_normal((N, 5)).astype(np.float32)}
        prev = {k: np.full((F,) + v.shape[1:], -0.5, np.float32)
                for k, v in tree.items()}
        want = jrobust.inject_byzantine(
            {k: jnp.asarray(v) for k, v in tree.items()}, F, name,
            prev={k: jnp.asarray(v) for k, v in prev.items()}, **kw)
        got = trobust.inject_byzantine(
            {k: torch.from_numpy(v) for k, v in tree.items()}, F, name,
            prev={k: torch.from_numpy(v) for k, v in prev.items()}, **kw)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class TestAsyncTrainer:
    def test_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        p = {k: torch.from_numpy(v) for k, v in _params().items()}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.AsyncByzantineTrainer(
                _tloss, p, get_optimizer("sgd", 0.1),
                AggSpec(n_workers=N, f=F, gar="stale-krum"))

    def test_run_matches_reference_trainer(self):
        kw = dict(n_workers=N, f=F, gar="stale-bulyan-krum",
                  attack="omniscient_linf", attack_kwargs=LINF, async_tau=2)
        p0 = _params()
        jtr = jtrainer.AsyncByzantineTrainer(
            _jloss, {k: jnp.asarray(v) for k, v in p0.items()},
            jget("sgd", 0.1), JaxSpec(**kw))
        jtr.run(_Batcher(N - F), 4)
        ttr = ttrainer.AsyncByzantineTrainer(
            _tloss, {k: torch.from_numpy(v) for k, v in p0.items()},
            get_optimizer("sgd", 0.1), AggSpec(**kw), device="cpu")
        ttr.run(_Batcher(N - F), 4)
        _close_params(ttr.params, jtr.params)
        assert [sorted(h) for h in ttr.history] == [sorted(h)
                                                    for h in jtr.history]
        assert [h["staleness_max"] for h in ttr.history] == [
            h["staleness_max"] for h in jtr.history]
        # telemetry off: both drains are empty
        tel, jtel = ttr.telemetry(), jtr.telemetry()
        assert (tel["pushed"], tel["records"]) == (jtel["pushed"],
                                                   jtel["records"]) == (0,
                                                                        [])
        assert tel["selection_frequency"].shape == (0,)

    def test_sync_trainer_threads_the_state(self):
        """The synchronous trainer carries a stateful rule's state across
        ``run`` calls and restarts the row-count dependent buffers when
        the attack stops, as the reference's does."""
        kw = dict(n_workers=N, f=F, gar="reputation-buffered-krum",
                  attack="signflip")
        p0 = _params()
        jtr = jtrainer.ByzantineTrainer(
            _jloss, {k: jnp.asarray(v) for k, v in p0.items()},
            jget("sgd", 0.1), JaxSpec(**kw))
        ttr = ttrainer.ByzantineTrainer(
            _tloss, {k: torch.from_numpy(v) for k, v in p0.items()},
            get_optimizer("sgd", 0.1), AggSpec(**kw), device="cpu")
        for tr in (jtr, ttr):
            tr.run(_Batcher(N - F), 2, attack_until=3)
            tr.run(_Batcher(N - F), 3, attack_until=3, start_step=2)
        _close_params(ttr.params, jtr.params)
        assert int(ttr.agg_state.step) == int(jtr.agg_state.step)
        assert tuple(ttr.agg_state.history.shape) == tuple(
            jtr.agg_state.history.shape)
        np.testing.assert_allclose(ttr.agg_state.reputation.numpy(),
                                   np.asarray(jtr.agg_state.reputation),
                                   rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("rep_lr", [None, 0.3])
    def test_reputation_with_aux_batch_and_step_scale(self, rep_lr):
        """ByGARS proper: scores against a clean auxiliary batch's
        gradient, and a set ``rep_lr`` scales the update by the mean
        trust; both trainers, three steps, against the reference."""
        xa, ya = _Batcher(1, seed=9).batch(0)
        kw = dict(n_workers=N, f=F, gar="reputation-krum",
                  attack="signflip", rep_lr=rep_lr)
        p0 = _params()
        jtr = jtrainer.ByzantineTrainer(
            _jloss, {k: jnp.asarray(v) for k, v in p0.items()},
            jget("sgd", 0.1),
            JaxSpec(aux_batch=(jnp.asarray(xa[0]), jnp.asarray(ya[0])),
                    **kw))
        ttr = ttrainer.ByzantineTrainer(
            _tloss, {k: torch.from_numpy(v) for k, v in p0.items()},
            get_optimizer("sgd", 0.1), AggSpec(aux_batch=(xa[0], ya[0]),
                                               **kw), device="cpu")
        for tr in (jtr, ttr):
            tr.run(_Batcher(N - F), 3)
        _close_params(ttr.params, jtr.params)
        np.testing.assert_allclose(ttr.agg_state.reputation.numpy(),
                                   np.asarray(jtr.agg_state.reputation),
                                   rtol=1e-4, atol=1e-6)
        for a, b in zip(ttr.history, jtr.history):
            assert abs(a["step_scale"] - b["step_scale"]) <= 1e-6

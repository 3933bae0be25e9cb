"""Port parity of the stateful composites: ``buffered-``, ``stale-``
(``inv`` / ``exp``), ``reputation-`` and ``centered_clip_momentum``,
alone, nested and over the ``fused-`` bases, dense and tree, against the
JAX reference over several steps with the state carried in each package.

Each step's stack is fresh seeded numpy data whose last f rows are a
sign-flipped honest mean, so reputation falls for them and the blend
is exercised; the stale rules see a bus whose versions lag by 0, 1 or 2
steps per worker.  Aggregates, scores and carried buffers agree at 1e-4
relative to ``max(1, max |want|)``, selections exactly.  The reference's
bitwise identities hold on the port: uniform reputation, uniform
staleness and a window of 1 each reproduce the base rule bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.agg import registry as jreg  # noqa: E402
from repro.agg import state as jstate  # noqa: E402
from repro.agg import staleness as jstale  # noqa: E402
from repro.agg import buffered as jbuf  # noqa: E402
from repro.agg.specs import check_quorum as jcheck  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro_torch.agg import registry as treg  # noqa: E402
from repro_torch.agg import state as tstate  # noqa: E402
from repro_torch.agg import staleness as tstale  # noqa: E402
from repro_torch.agg import buffered as tbuf  # noqa: E402
from repro_torch.agg.specs import check_quorum as tcheck  # noqa: E402
from repro_torch.dist import robust as trobust  # noqa: E402

TOL = 1e-4
N, F, D, STEPS = 11, 2, 40, 3
SHAPES = {"w": (4, 5), "b": (7,), "c": (2, 3, 2)}

BASES = ["krum", "cwmed", "bulyan-krum"]
COMPOSITES = (
    [f"{w}{b}" for w in ("buffered-", "stale-", "stale-exp-",
                         "reputation-") for b in BASES]
    + ["stale-reputation-krum", "reputation-stale-krum",
       "stale-buffered-cwmed", "reputation-buffered-krum",
       "stale-inv-centered_clip_momentum", "centered_clip_momentum",
       "stale-fused-bulyan-krum", "reputation-fused-bulyan-krum",
       "buffered-fused-cwmed", "buffered-fused-krum",
       "reputation-stale-fused-krum"])
#: every wrapper over the bases and their fused forms: the names the
#: resolver must accept, each held to the reference dense and tree
WRAPPED = [f"{p}{b}" for p in ("buffered-", "stale-", "stale-inv-",
                               "stale-exp-", "reputation-")
           for b in ("krum", "bulyan-krum", "cwmed", "fused-krum",
                     "fused-bulyan-krum", "fused-cwmed")]
ACCEPTED = ["brute", "centered_clip", "centered_clip_momentum",
            "bulyan-brute", "bulyan-average"] + WRAPPED
DENSE_COMPOSITES = sorted(set(COMPOSITES) | set(WRAPPED))
TREE_COMPOSITES = sorted(set(WRAPPED) | {
    "stale-reputation-krum", "centered_clip_momentum",
    "reputation-centered_clip_momentum", "reputation-stale-fused-krum"})


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _stack(t, d=D, n=N, f=F):
    """Step t's submissions: honest worker i spreads 0.3 + 0.1 i around a
    shared mean, the last f rows are the sign-flipped honest mean."""
    rng = np.random.default_rng(100 + t)
    spread = 0.3 + 0.1 * np.arange(n)
    x = (1.0 + rng.standard_normal(d)[None]
         + spread[:, None] * rng.standard_normal((n, d)))
    x[n - f:] = -x[:n - f].mean(axis=0)
    return x.astype(np.float32)


def _tree(t):
    x = _stack(t, d=sum(int(np.prod(s)) for s in SHAPES.values()))
    out, off = {}, 0
    for k in sorted(SHAPES):
        size = int(np.prod(SHAPES[k]))
        out[k] = x[:, off:off + size].reshape((N,) + SHAPES[k])
        off += size
    return out


def _versions(t, n=N):
    """Slot versions lagging 0, 1 or 2 steps behind step t."""
    return np.maximum(t - (np.arange(n) % 3), 0).astype(np.int32)


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    scale = max(1.0, float(np.max(np.abs(want[finite]), initial=0.0)))
    err = np.max(np.abs(got[finite] - want[finite]), initial=0.0)
    assert err <= tol * scale, (err, scale)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _with_versions(js, ts, t):
    """Both states with the bus versions of step t, when they carry a
    bus."""
    if js.bus == ():
        return js, ts
    v = _versions(t)
    js = js._replace(bus=js.bus._replace(versions=jnp.asarray(v)))
    ts = ts._replace(bus=ts.bus._replace(versions=torch.from_numpy(v)))
    return js, ts


def _same_state(ts, js):
    assert int(ts.step) == int(js.step)
    for field in ("history", "center", "reputation"):
        tv, jv = getattr(ts, field), getattr(js, field)
        if isinstance(jv, tuple):
            assert len(tv) == len(jv)
            for a, b in zip(tv, jv):
                _close(_np(a), _np(b))
        else:
            _close(_np(tv), _np(jv))


# ---------------------------------------------------------------------------
# the composites against the reference, state carried
# ---------------------------------------------------------------------------

class TestDenseComposites:
    @pytest.mark.parametrize("name", DENSE_COMPOSITES)
    def test_steps_match_reference(self, name):
        jr, tr = jreg.resolve_rule(name), treg.resolve_rule(name)
        assert tr.stateful and jr.stateful
        assert tr.state_fields == jr.state_fields
        js = jstate.init_state(jr, jnp.zeros((N, D), jnp.float32))
        ts = tstate.init_state(tr, torch.zeros((N, D)))
        for t in range(STEPS):
            js, ts = _with_versions(js, ts, t)
            x = _stack(t)
            jres, js = jr.dense_fn(jnp.asarray(x), F, js)
            tres, ts = tr.dense_fn(torch.from_numpy(x), F, ts)
            _close(tres.gradient.numpy(), np.asarray(jres.gradient))
            assert np.array_equal(tres.selected.numpy(),
                                  np.asarray(jres.selected)), t
            _close(tres.scores.numpy(), np.asarray(jres.scores))
            _same_state(ts, js)


class TestTreeComposites:
    @pytest.mark.parametrize("backend", ["xla", "fused"])
    @pytest.mark.parametrize("name", TREE_COMPOSITES)
    def test_steps_match_reference(self, name, backend):
        jr, tr = jreg.resolve_rule(name), treg.resolve_rule(name)
        tree0 = _tree(0)
        js = jstate.init_state(
            jr, {k: jnp.asarray(v) for k, v in tree0.items()}, flat=False)
        ts = tstate.init_state(
            tr, {k: torch.from_numpy(v) for k, v in tree0.items()},
            flat=False)
        for t in range(STEPS):
            js, ts = _with_versions(js, ts, t)
            tree = _tree(t)
            jagg, jres, js = jrobust.distributed_aggregate(
                {k: jnp.asarray(v) for k, v in tree.items()}, F, name,
                state=js, distance_backend=backend)
            tagg, tres, ts = trobust.distributed_aggregate(
                {k: torch.from_numpy(v) for k, v in tree.items()}, F, name,
                state=ts, distance_backend=backend)
            for k in tree:
                _close(tagg[k].numpy(), np.asarray(jagg[k]))
            assert np.array_equal(tres.selected.numpy(),
                                   np.asarray(jres.selected)), t
            _close(tres.scores.numpy(), np.asarray(jres.scores))
            _same_state(ts, js)

    def test_self_initialized_state(self):
        """With no state given, the engine zero-initializes one, as the
        reference does."""
        tree = _tree(0)
        _, _, js = jrobust.distributed_aggregate(
            {k: jnp.asarray(v) for k, v in tree.items()}, F,
            "buffered-cwmed")
        _, _, ts = trobust.distributed_aggregate(
            {k: torch.from_numpy(v) for k, v in tree.items()}, F,
            "buffered-cwmed")
        _same_state(ts, js)


class TestCenteredClipMomentum:
    def test_center_is_carried(self):
        jr = jreg.resolve_rule("centered_clip_momentum")
        tr = treg.resolve_rule("centered_clip_momentum")
        js = jstate.init_state(jr, jnp.zeros((N, D), jnp.float32))
        ts = tstate.init_state(tr, torch.zeros((N, D)))
        for t in range(4):
            x = _stack(t) * (1.0 + 5.0 * t)
            jres, js = jbuf.centered_clip_momentum(jnp.asarray(x), F, js)
            tres, ts = tbuf.centered_clip_momentum(torch.from_numpy(x), F,
                                                   ts)
            _close(tres.gradient.numpy(), np.asarray(jres.gradient))
            _close(ts.center.numpy(), np.asarray(js.center))


# ---------------------------------------------------------------------------
# the reference's bitwise identities
# ---------------------------------------------------------------------------

def _dense_base(base, x):
    return treg.resolve_rule(base).dense_fn(torch.from_numpy(x), F)


def _same_bits(got, want):
    assert torch.equal(got.gradient, want.gradient)
    assert torch.equal(got.selected, want.selected)
    assert torch.equal(got.scores, want.scores)


IDENTITY_BASES = ["krum", "cwmed", "bulyan-krum", "fused-bulyan-krum",
                  "fused-cwmed", "multikrum"]


class TestBitwiseIdentities:
    @pytest.mark.parametrize("base", IDENTITY_BASES)
    def test_uniform_reputation_is_the_base(self, base):
        rule = treg.resolve_rule(f"reputation-{base}")
        x = _stack(0)
        state = tstate.init_state(rule, torch.from_numpy(x))
        got, _ = rule.dense_fn(torch.from_numpy(x), F, state)
        want = _dense_base(base, x)
        _same_bits(got, want)
        jwant = jreg.resolve_rule(base).dense_fn(jnp.asarray(x), F)
        _close(got.gradient.numpy(), np.asarray(jwant.gradient))

    @pytest.mark.parametrize("weight", ["", "inv-", "exp-"])
    @pytest.mark.parametrize("base", IDENTITY_BASES)
    def test_uniform_staleness_is_the_base(self, base, weight):
        rule = treg.resolve_rule(f"stale-{weight}{base}")
        x = _stack(1)
        state = tstate.init_state(rule, torch.from_numpy(x))
        state = state._replace(step=5, bus=state.bus._replace(
            versions=torch.full((N,), 2, dtype=torch.int32)))
        got, new = rule.dense_fn(torch.from_numpy(x), F, state)
        _same_bits(got, _dense_base(base, x))
        assert new.step == 6
        jwant = jreg.resolve_rule(base).dense_fn(jnp.asarray(x), F)
        _close(got.gradient.numpy(), np.asarray(jwant.gradient))

    @pytest.mark.parametrize("base", ["krum", "cwmed", "bulyan-krum",
                                      "fused-cwmed", "fused-bulyan-krum"])
    def test_window_one_is_the_base(self, base):
        rule = treg.resolve_rule(f"buffered-{base}", history_window=1)
        assert rule.history_window == 1
        state = tstate.init_state(rule, torch.zeros((N, D)))
        for t in range(STEPS):
            x = _stack(t)
            got, state = rule.dense_fn(torch.from_numpy(x), F, state)
            _same_bits(got, _dense_base(base, x))
            jwant = jreg.resolve_rule(base).dense_fn(jnp.asarray(x), F)
            _close(got.gradient.numpy(), np.asarray(jwant.gradient))

    @pytest.mark.parametrize("prefix", ["reputation-", "stale-"])
    @pytest.mark.parametrize("backend", ["xla", "fused"])
    def test_tree_identities(self, prefix, backend):
        tree = {k: torch.from_numpy(v) for k, v in _tree(2).items()}
        rule = treg.resolve_rule(f"{prefix}bulyan-krum")
        state = tstate.init_state(rule, tree, flat=False)
        if state.bus != ():
            state = state._replace(step=3)  # everyone 3 steps stale
        got, gres, _ = trobust.distributed_aggregate(
            tree, F, f"{prefix}bulyan-krum", state=state,
            distance_backend=backend)
        want, wres = trobust.distributed_aggregate(
            tree, F, "bulyan-krum", distance_backend=backend)
        for k in tree:
            assert torch.equal(got[k], want[k])
        assert torch.equal(gres.selected, wres.selected)


# ---------------------------------------------------------------------------
# the resolver: accepted names, flags, caching and the reference's errors
# ---------------------------------------------------------------------------

class TestResolver:
    @pytest.mark.parametrize("name", ACCEPTED)
    def test_accepted_names_carry_the_reference_contract(self, name):
        t, j = treg.resolve_rule(name), jreg.resolve_rule(name)
        for f in range(4):
            assert t.min_n(f) == j.min_n(f)
        assert (t.stateful, t.state_fields, t.history_window,
                t.byzantine_resilient, t.invariants,
                t.tree_fn is None) == (
            j.stateful, j.state_fields, j.history_window,
            j.byzantine_resilient, j.invariants, j.tree_fn is None)

    def test_composites_cache_on_window_and_schedule(self):
        a = treg.resolve_rule("buffered-krum", history_window=3)
        assert a is treg.resolve_rule("buffered-krum", history_window=3)
        assert a is not treg.resolve_rule("buffered-krum")
        assert treg.DEFAULT_HISTORY_WINDOW == jreg.DEFAULT_HISTORY_WINDOW
        assert treg.resolve_rule("buffered-krum").history_window == (
            treg.DEFAULT_HISTORY_WINDOW)
        r = treg.resolve_rule("reputation-krum", rep_lr=0.1)
        assert r is treg.resolve_rule("reputation-krum", rep_lr=0.1)
        assert r is not treg.resolve_rule("reputation-krum", rep_lr=0.2)

    @pytest.mark.parametrize("name", [
        "buffered-centered_clip_momentum", "stale-stale-krum",
        "stale-exp-stale-krum", "reputation-reputation-krum",
        "reputation-stale-reputation-krum", "stale-nope", "stalekrum",
        "buffered-nope", "reputation-fused-average"])
    def test_error_texts(self, name):
        with pytest.raises(KeyError) as want:
            jreg.resolve_rule(name)
        with pytest.raises(KeyError) as got:
            treg.resolve_rule(name)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("name", ["obs-krum", "stale-obs-krum",
                                      "obs-stale-fused-bulyan-krum"])
    def test_obs_waits_for_telemetry(self, name):
        """The telemetry family is ported: each nesting resolves with the
        reference's contract."""
        j, t = jreg.resolve_rule(name), treg.resolve_rule(name)
        assert (t.name, t.stateful, t.state_fields, t.history_window,
                t.invariants, t.obs_capacity, t.tree_fn is None) == (
            j.name, j.stateful, j.state_fields, j.history_window,
            j.invariants, j.obs_capacity, j.tree_fn is None)
        for f in (0, 2):
            assert t.min_n(f) == j.min_n(f)

    def test_value_error_texts(self):
        pairs = [
            (lambda: jbuf.make_buffered("b", jreg.resolve_rule("krum"), 0),
             lambda: tbuf.make_buffered("b", treg.resolve_rule("krum"), 0)),
            (lambda: jstale.stale_weights(jnp.zeros(3, jnp.int32), "lin"),
             lambda: tstale.stale_weights(torch.zeros(3, dtype=torch.int32),
                                          "lin")),
            (lambda: jstate.init_state(
                jreg.AggregatorRule("h", lambda f: 1, state_fields=(
                    "history",)), jnp.zeros((3, 2))),
             lambda: tstate.init_state(
                 treg.AggregatorRule("h", lambda f: 1, state_fields=(
                     "history",)), torch.zeros((3, 2)))),
        ]
        for jcall, tcall in pairs:
            with pytest.raises(ValueError) as want:
                jcall()
            with pytest.raises(ValueError) as got:
                tcall()
            assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("gar,n,f,distributed", [
        ("reputation-krum", 4, 5, False), ("reputation-bulyan-krum", 2, 0,
                                           False),
        ("buffered-bulyan-krum", 10, 2, False),
        ("buffered-bulyan-brute", 11, 2, True),
        ("stale-bulyan-average", 11, 2, True),
        ("stale-brute", 11, 2, True), ("buffered-brute", 4, 2, False),
        ("stale-centered_clip_momentum", 4, 2, True)])
    def test_check_quorum(self, gar, n, f, distributed):
        try:
            jcheck(gar, n, f, distributed=distributed, history_window=2)
        except (KeyError, ValueError) as e:
            with pytest.raises(type(e)) as got:
                tcheck(gar, n, f, distributed=distributed, history_window=2)
            assert str(got.value) == str(e)
        else:
            tcheck(gar, n, f, distributed=distributed, history_window=2)

    def test_check_quorum_reads_the_window(self):
        """``history_window`` reaches the resolver: the window-2 rule is
        the one cached afterwards."""
        tcheck("buffered-krum", 11, 2, history_window=2)
        assert treg._COMPOSITES[("buffered-krum", 2, 0.5, 1.0)] \
            .history_window == 2

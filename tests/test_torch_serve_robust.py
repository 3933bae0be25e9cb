"""Port parity of Byzantine-resilient ensemble serving
(``repro_torch.dist.serve_robust``, ``repro_torch.dist.serve`` and the
engine's plain and ensemble modes) against the JAX reference, on the
CPU.  Random inputs (weights, replica jitter, logits) come from the
reference or numpy and cross over as arrays.  Tolerance: 1e-4 of the
largest entry of what is compared.

* ``aggregate_logits`` equals the reference's and the flat rule for
  every tree rule (stateful ones threaded over steps), under the
  ``xla`` and ``fused`` backends;
* ``stack_replicas`` / ``replicate_params`` / ``replicate_cache`` /
  ``poison_replicas`` / ``init_ensemble_state`` / ``reset_slot_state``;
* the engine: plain and ensemble streams against the reference's token
  by token (a divergence is let off only after a reference near-tie,
  counted and asserted rare), identical replicas equal the plain
  engine, a poisoned replica and a decode-time logits attack are
  rejected, ``AggState`` is carried across tokens, positions stay int32,
  telemetry off equals on bit for bit;
* ``mesh=`` takes a rank's ``Mesh`` (the sharded serving paths
  themselves are ``tests/test_torch_serve_sharded.py``'s).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import AggSpec as JSpec  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist import serve_robust as jsr  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.agg import AggSpec  # noqa: E402
from repro_torch.agg import resolve_rule, rule_names  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist import serve as tserve  # noqa: E402
from repro_torch.dist import serve_robust as tsr  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import init_cache, prefill  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from torch_serving_compare import (GapRecorder,  # noqa: E402
                                   assert_streams_match)

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
#: the rules the reference's ``tests/test_serve_robust.py`` holds to the
#: flat core
FLAT_RULES = ["average", "cwmed", "trimmed_mean", "krum", "geomed",
              "multikrum", "centered_clip", "bulyan-krum", "bulyan-geomed"]
#: the reference's list of rules that must serve unchanged
SERVE_EXTRA = ["bulyan-krum", "bulyan-geomed", "buffered-cwmed",
               "buffered-krum", "buffered-bulyan-krum", "reputation-krum",
               "reputation-buffered-cwmed", "reputation-bulyan-krum"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(float(np.max(np.abs(want))), 1e-30), (
        what, err)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _logits(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jagg(f, gar, **kw):
    """The reference's ``aggregate_logits`` under ``jax.jit`` (compiling
    it whole is far quicker on the CPU than running it op by op)."""
    return jax.jit(lambda x, state=None: jsr.aggregate_logits(
        x, f, gar, state=state, **kw))


def _ensemble(arch, n, seed=7, poison=False):
    """The reference's jittered replicas (and, with ``poison``, the last
    replica sign-flipped at scale 10), in both packages."""
    cfg = jget_reduced(arch)
    params = jinit_model(KEY, cfg)

    def build(p, key):
        honest = jsr.replicate_params(p, n, jitter=1e-3, key=key)
        if poison:
            honest = jsr.poison_replicas(honest, 1, "signflip", scale=10.0)
        return honest

    honest = jax.jit(build)(params, jax.random.PRNGKey(seed))
    return cfg, get_reduced(arch), honest, _to_torch(honest)


def _run_pair(jcfg, tcfg, jparams, tparams, requests, jspec=None, tspec=None,
              n_slots=1, cache_len=32):
    """The same requests through the reference's and the port's engines:
    ``(reference streams, port streams, reference gaps)``."""
    jeng = JEngine(jparams, jcfg, n_slots=n_slots, cache_len=cache_len,
                   ensemble=jspec)
    rec = GapRecorder(jeng)
    if jspec is None:
        with rec.plain_prefill():
            want = jeng.run([JReq(r, np.asarray(p, np.int32), m)
                             for r, p, m in requests], max_steps=40)
    else:
        want = jeng.run([JReq(r, np.asarray(p, np.int32), m)
                         for r, p, m in requests], max_steps=40)
    teng = ServingEngine(tparams, tcfg, n_slots=n_slots,
                         cache_len=cache_len, ensemble=tspec)
    got = teng.run([Request(r, np.asarray(p, np.int32), m)
                    for r, p, m in requests], max_steps=40)
    return want, got, rec.gaps


# ---------------------------------------------------------------------------
# 1. aggregate_logits against the reference and the flat core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gar", FLAT_RULES)
def test_aggregate_logits_matches_flat_core(gar):
    n, b, v, f = 11, 3, 32, 2
    logits = _logits((n, b, v), 0)
    want, wres = _jagg(f, gar)(jnp.asarray(logits))
    flat = resolve_rule(gar).dense_fn(_t(logits).reshape(n, -1), f)
    for backend in ("xla", "fused"):
        got, res = tsr.aggregate_logits(_t(logits), f, gar,
                                        distance_backend=backend)
        assert got.shape == (b, v) and res.selected.shape == (n,)
        _close(got, want, what=f"{gar} {backend}")
        _close(got, flat.gradient.reshape(b, v), what=f"{gar} flat")
        np.testing.assert_array_equal(res.selected.numpy(),
                                      np.asarray(wres.selected))


def test_every_tree_rule_serves():
    """Every registry rule with a tree path serves unchanged; stateful
    ones over two steps with the state carried, each step against the
    reference's."""
    b, v, f = 2, 16, 1
    names = [n for n in rule_names() if resolve_rule(n).tree_fn is not None]
    names += SERVE_EXTRA
    assert "krum" in names and "centered_clip_momentum" in names
    for i, name in enumerate(names):
        rule = resolve_rule(name)
        n = max(rule.min_n(f), 4)
        if rule.stateful:
            jst = jsr.init_ensemble_state(JSpec(f=f, gar=name), n, b, v)
            tst = tsr.init_ensemble_state(AggSpec(f=f, gar=name), n, b, v,
                                          device="cpu")
            jfn = _jagg(f, name)
            for step in range(2):
                logits = _logits((n, b, v), 100 * i + step)
                want, _, jst = jfn(jnp.asarray(logits), jst)
                got, _, tst = tsr.aggregate_logits(_t(logits), f, name,
                                                   state=tst)
                _close(got, want, what=f"{name} step {step}")
            assert tst.step == 2 == int(jst.step)
        else:
            logits = _logits((n, b, v), 100 * i)
            want, _ = _jagg(f, name)(jnp.asarray(logits))
            got, _ = tsr.aggregate_logits(_t(logits), f, name)
            _close(got, want, what=name)
        assert bool(torch.isfinite(got).all()), name


def test_stateful_dense_tree_parity_across_steps():
    """Threading the state through ``aggregate_logits`` equals threading
    the dense rule over the flat stacks, step for step."""
    n, b, v, f, w = 5, 2, 16, 1, 3
    rule = resolve_rule("buffered-cwmed", history_window=w)
    spec = AggSpec(f=f, gar="buffered-cwmed", history_window=w)
    t_state = tsr.init_ensemble_state(spec, n, b, v, device="cpu")
    from repro_torch.agg import init_state
    d_state = init_state(rule, torch.zeros((n, b * v)), flat=True)
    for step in range(4):
        logits = _t(_logits((n, b, v), step))
        agg, _, t_state = tsr.aggregate_logits(
            logits, f, "buffered-cwmed", state=t_state, history_window=w)
        d_res, d_state = rule.dense_fn(logits.reshape(n, -1), f, d_state)
        _close(agg, d_res.gradient.reshape(b, v).numpy())
    assert t_state.step == 4


# ---------------------------------------------------------------------------
# 2. replica stacks, caches, poisoning, the state layout
# ---------------------------------------------------------------------------

def test_stack_replicate_and_poison():
    jcfg = jget_reduced("gemma_2b")
    params = _to_torch(jinit_model(KEY, jcfg))
    stacked = tsr.stack_replicas([params, params, params])
    bcast = tsr.replicate_params(params, 3)
    for a, b in zip(tree_leaves(stacked), tree_leaves(bcast)):
        assert torch.equal(a, b)
    jit = tsr.replicate_params(params, 3, jitter=1e-3,
                               generator=torch.Generator().manual_seed(5))
    for leaf, base in zip(tree_leaves(jit), tree_leaves(params)):
        assert leaf.shape == (3,) + base.shape and leaf.dtype == base.dtype
        rms = float(torch.sqrt(torch.mean(base.double() ** 2)))
        if rms > 0:
            dev = (leaf.double() - base.double()).std() / rms
            assert 5e-4 < float(dev) < 2e-3
    emb = tree_leaves(jit)[0]
    assert not torch.allclose(emb[0], emb[1])
    again = tsr.replicate_params(params, 3, jitter=1e-3,
                                 generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(jit),
                                                 tree_leaves(again)))
    # poisoning equals the reference's on the same stack
    jstack = jax.jit(lambda p, k: jsr.replicate_params(
        p, 4, jitter=1e-3, key=k))(jinit_model(KEY, jcfg),
                                   jax.random.PRNGKey(1))
    want = jax.jit(lambda s: jsr.poison_replicas(s, 1, "signflip",
                                                 scale=10.0))(jstack)
    got = tsr.poison_replicas(_to_torch(jstack), 1, "signflip", scale=10.0)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w)
    with pytest.raises(ValueError, match="n_replicas must be >= 1"):
        tsr.replicate_params(params, 0)
    with pytest.raises(ValueError, match="at least one replica"):
        tsr.stack_replicas([])


def test_replicate_cache_and_state_layout():
    jcfg, tcfg = jget_reduced("gemma3_1b"), get_reduced("gemma3_1b")
    want = jsr.replicate_cache(jinit_cache(jcfg, 2, 40), 3)
    got = tsr.replicate_cache(init_cache(tcfg, 2, 40, device="cpu"), 3)
    assert [tuple(a.shape) for a in tree_leaves(got)] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]
    for gar in ("buffered-krum", "reputation-buffered-krum",
                "centered_clip_momentum", "obs-krum"):
        ws = jsr.init_ensemble_state(JSpec(f=1, gar=gar), 5, 3, 8)
        ts = tsr.init_ensemble_state(AggSpec(f=1, gar=gar), 5, 3, 8,
                                     device="cpu")
        for field in ("history", "center", "reputation"):
            assert [tuple(a.shape) for a in tree_leaves(getattr(ts, field))] \
                == [a.shape for a in jax.tree_util.tree_leaves(
                    getattr(ws, field))], (gar, field)
    assert tsr.init_ensemble_state(AggSpec(f=1, gar="krum"), 5, 3, 8,
                                   device="cpu") is None


def test_reset_slot_state_against_the_reference():
    spec = dict(f=1, gar="reputation-buffered-krum")
    ws = jsr.init_ensemble_state(JSpec(**spec), 5, 3, 8)
    ts = tsr.init_ensemble_state(AggSpec(**spec), 5, 3, 8, device="cpu")
    rng = np.random.default_rng(0)
    hist = rng.standard_normal(ws.history[0].shape).astype(np.float32)
    rep = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    ws = ws._replace(history=(jnp.asarray(hist),),
                     reputation=jnp.asarray(rep))
    ts = ts._replace(history=(_t(hist),), reputation=_t(rep))
    want = jsr.reset_slot_state(ws, 1)
    got = tsr.reset_slot_state(ts, 1)
    assert np.array_equal(got.history[0].numpy(), np.asarray(want.history[0]))
    assert np.array_equal(got.reputation.numpy(),
                          np.asarray(want.reputation))
    assert (got.reputation[:, 1] == 1).all() and (got.history[0][:, :, 1]
                                                  == 0).all()
    # the input state is not written
    assert np.array_equal(ts.history[0].numpy(), hist)
    cc = tsr.init_ensemble_state(AggSpec(f=1, gar="centered_clip_momentum"),
                                 5, 3, 8, device="cpu")
    cc = cc._replace(center=(torch.ones(3, 8),))
    out = tsr.reset_slot_state(cc, 2)
    assert (out.center[0][2] == 0).all() and (out.center[0][:2] == 1).all()
    assert tsr.reset_slot_state(None, 0) is None


# ---------------------------------------------------------------------------
# 3. the steps
# ---------------------------------------------------------------------------

def test_serve_steps_match_the_reference():
    """``make_prefill_step`` / ``make_serve_step`` (plain) and three
    chained ``make_robust_serve_step`` calls carrying cache and
    ``centered_clip_momentum``'s state, against the reference's."""
    jcfg, tcfg, jsp, tsp = _ensemble("gemma_2b", 5)
    n, b = 5, 2
    tokens = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    jp0 = jax.tree_util.tree_map(lambda x: x[0], jsp)
    tp0 = jax.tree_util.tree_map(lambda x: x[0], tsp)
    from repro.dist import serve as jserve
    want, wcache = jserve.make_prefill_step(jcfg)(jp0, tokens)
    got, cache = tserve.make_prefill_step(tcfg)(tp0, _t(tokens))
    _close(got, want)
    want1, _ = jserve.make_serve_step(jcfg)(jp0, wcache, tokens[:, :1], 3)
    got1, _ = tserve.make_serve_step(tcfg)(tp0, cache, _t(tokens[:, :1]), 3)
    _close(got1, want1)

    jspec = JSpec(f=1, gar="centered_clip_momentum")
    tspec = AggSpec(f=1, gar="centered_clip_momentum")
    jstep = jax.jit(jsr.make_robust_serve_step(jcfg, jspec))
    tstep = tsr.make_robust_serve_step(tcfg, tspec)
    jc = jsr.replicate_cache(jinit_cache(jcfg, b, 16), n)
    tc = tsr.replicate_cache(init_cache(tcfg, b, 16, device="cpu"), n)
    jst = jsr.init_ensemble_state(jspec, n, b, jcfg.vocab_size)
    tst = tsr.init_ensemble_state(tspec, n, b, tcfg.vocab_size,
                                  device="cpu")
    token = np.asarray([[1], [2]], np.int32)
    for i in range(3):
        pos = np.full((b,), i, np.int32)
        want, jc, wres, jst = jstep(jsp, jc, token, jnp.asarray(pos), jst)
        got, tc, res, tst = tstep(tsp, tc, _t(token), pos, tst)
        assert got.shape == (b, tcfg.vocab_size)
        _close(got, want, what=f"step {i}")
        _close(res.selected, wres.selected)
        for g, w in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            _close(g, w, what=f"step {i} cache")
    assert tst.step == 3 == int(jst.step)
    _close(tst.center[0], jst.center[0])


def test_robust_prefill_step_matches_the_reference():
    """The ensemble prefill against the reference's (eager, as its engine
    runs it).  Replicas 1e-3 apart tie Bulyan's window on a few of the
    1024 coordinates, where the two packages' last-bit differences in
    the logits flip the choice: those coordinates (tied on either stack,
    or windowed differently) are let off, counted and held rare, and on
    the reference's own stack the port's aggregate is its bit for bit."""
    from repro.models import prefill as jprefill
    from torch_llm_compare import window_ties
    jcfg, tcfg, jsp, tsp = _ensemble("llama3_2_3b", 7)
    tokens = np.asarray([[5, 6, 7, 8]], np.int32)
    jstack = np.asarray(jax.vmap(lambda p: jprefill(
        p, jcfg, tokens, cache_len=16)[0])(jsp))[:, :, -1]
    for gar in ("bulyan-krum", "reputation-krum"):
        want, wcache, wres = jsr.make_robust_prefill_step(
            jcfg, JSpec(f=1, gar=gar), cache_len=16)(jsp, tokens)
        spec = AggSpec(f=1, gar=gar, distance_backend="fused")
        got, cache, res = tsr.make_robust_prefill_step(
            tcfg, spec, cache_len=16)(tsp, _t(tokens))
        tstack = torch.func.vmap(lambda p: prefill(
            p, tcfg, _t(tokens), cache_len=16)[0])(tsp)[:, :, -1]
        off = np.zeros(got.numel(), bool)
        if gar == "bulyan-krum":
            off = window_ties([jstack], [tstack], 1)[0].numpy()
            assert off.sum() <= 0.01 * off.size, int(off.sum())
        keep = ~off.reshape(got.shape)
        _close(got.numpy()[keep], np.asarray(want)[keep], what=gar)
        np.testing.assert_array_equal(res.selected.numpy(),
                                      np.asarray(wres.selected))
        on_ref = tsr.aggregate_logits(_t(jstack), 1, gar,
                                      distance_backend="fused")[0]
        _close(on_ref, want, what=f"{gar} on the reference's stack")
        for g, w in zip(tree_leaves(cache),
                        jax.tree_util.tree_leaves(wcache)):
            _close(g, w, what=f"{gar} cache")


def test_mesh_must_be_a_mesh():
    """``mesh=`` on every serving entry point takes a rank's ``Mesh`` and
    names what it got otherwise; a mesh with a ``data`` axis needs the
    ensemble's size."""
    tcfg = get_reduced("llama3_2_3b")
    spec = AggSpec(f=1, gar="krum")
    want = "takes a repro_torch.dist.mesh.Mesh .* got object"
    for build in (tsr.make_robust_serve_step, tsr.make_robust_verify_step,
                  lambda c, s, mesh: tsr.make_robust_prefill_step(
                      c, s, mesh=mesh)):
        with pytest.raises(TypeError, match=want):
            build(tcfg, spec, mesh=object())
    with pytest.raises(TypeError, match=want):
        tsr.aggregate_logits(torch.zeros(5, 2, 3), 1, "krum", mesh=object())
    with pytest.raises(TypeError, match=want):
        tsr.init_ensemble_state(AggSpec(f=1, gar="buffered-krum"), 5, 2, 3,
                                device="cpu", mesh=object())
    with pytest.raises(TypeError, match=want):
        ServingEngine([{"w": torch.zeros(2)}] * 3, tcfg, ensemble=spec,
                      mesh=object())
    grid = type("Grid", (), dict(axis_names=("data", "model"),
                                 devices=np.empty((2, 1)),
                                 index=lambda self, a: 0,
                                 all_gather=None))()
    with pytest.raises(ValueError, match="needs n_replicas="):
        tsr.make_robust_serve_step(tcfg, spec, mesh=grid)


# ---------------------------------------------------------------------------
# 4. the engine end to end
# ---------------------------------------------------------------------------

REQS = [(0, [1, 2, 3, 4, 5], 6), (1, [9, 8, 7], 5), (2, [4, 4, 2, 2], 4)]


def test_plain_engine_matches_the_reference():
    """Batched plain serving with slot reuse (3 requests, 2 slots) and a
    request served alone against its hand-rolled prefill + greedy
    decode."""
    jcfg = jget_reduced("gemma_2b")
    jp = jinit_model(KEY, jcfg)
    tp = _to_torch(jp)
    tcfg = get_reduced("gemma_2b")
    want, got, gaps = _run_pair(jcfg, tcfg, jp, tp, REQS, n_slots=2)
    assert assert_streams_match(want, got, gaps) <= 1
    solo = ServingEngine(tp, tcfg, n_slots=1, cache_len=32).run(
        [Request(0, np.asarray(REQS[0][1], np.int32), 5)], 20)[0]
    from repro_torch.models import decode_step
    logits, cache = prefill(tp, tcfg, torch.tensor([REQS[0][1]]),
                            cache_len=32)
    cur = int(torch.argmax(logits[0, -1]))
    hand, pos = [cur], len(REQS[0][1])
    for _ in range(4):
        l1, cache = decode_step(tp, tcfg, cache, torch.tensor([[cur]]), pos)
        cur = int(torch.argmax(l1[0, 0]))
        hand.append(cur)
        pos += 1
    assert solo == hand


def test_identical_replicas_match_the_plain_engine():
    jcfg = jget_reduced("llama3_2_3b")
    tp = _to_torch(jinit_model(KEY, jcfg))
    tcfg = get_reduced("llama3_2_3b")
    prompt = np.asarray([1, 2, 3, 4, 5], np.int32)
    want = ServingEngine(tp, tcfg, n_slots=1, cache_len=32).run(
        [Request(0, prompt, 5)], 20)[0]
    stacked = tsr.replicate_params(tp, 4)   # a power of two: exact mean
    got = ServingEngine(stacked, tcfg, n_slots=1, cache_len=32,
                        ensemble=AggSpec(f=0, gar="average")).run(
        [Request(0, prompt, 5)], 20)[0]
    assert got == want


def test_poisoned_replica_rejected_end_to_end():
    """Under krum / bulyan-krum / reputation-krum (over the ``fused``
    backend) the poisoned ensemble decodes the clean ensemble's stream,
    and both match the reference's streams; ``average`` is steered."""
    jcfg, tcfg, jh, th = _ensemble("llama3_2_3b", 7)
    _, _, jpo, tpo = _ensemble("llama3_2_3b", 7, poison=True)
    req = [(0, [1, 2, 3, 4, 5], 6)]
    let_off = 0
    for gar in ("krum", "bulyan-krum", "reputation-krum"):
        spec = AggSpec(f=1, gar=gar, distance_backend="fused")
        clean = ServingEngine(th, tcfg, n_slots=1, cache_len=32,
                              ensemble=spec).run(
            [Request(0, np.asarray(req[0][1], np.int32), 6)], 20)
        want, got, gaps = _run_pair(jcfg, tcfg, jpo, tpo, req,
                                    JSpec(f=1, gar=gar), spec)
        let_off += assert_streams_match(want, got, gaps)
        assert got == clean, gar
    assert let_off <= 1
    avg = AggSpec(f=1, gar="average")
    clean = ServingEngine(th, tcfg, n_slots=1, cache_len=32,
                          ensemble=avg).run([Request(0, np.asarray(
                              req[0][1], np.int32), 6)], 20)
    attacked = ServingEngine(tpo, tcfg, n_slots=1, cache_len=32,
                             ensemble=avg).run([Request(0, np.asarray(
                                 req[0][1], np.int32), 6)], 20)
    assert attacked != clean


def test_decode_time_logits_attack_rejected():
    jcfg, tcfg, jsp, tsp = _ensemble("llama3_2_3b", 7, seed=3)
    req = [(0, [2, 4, 6], 6)]
    akw = (("scale", 20.0),)
    want, clean, gaps = _run_pair(jcfg, tcfg, jsp, tsp, req,
                                  JSpec(f=1, gar="bulyan-krum"),
                                  AggSpec(f=1, gar="bulyan-krum"))
    assert assert_streams_match(want, clean, gaps) <= 1
    jatt = JSpec(f=1, gar="bulyan-krum", attack="signflip",
                 attack_kwargs=akw)
    tatt = AggSpec(f=1, gar="bulyan-krum", attack="signflip",
                   attack_kwargs=akw, distance_backend="fused")
    want, got, gaps = _run_pair(jcfg, tcfg, jsp, tsp, req, jatt, tatt)
    assert assert_streams_match(want, got, gaps) <= 1
    assert got == clean
    avg = AggSpec(f=1, gar="average", attack="signflip", attack_kwargs=akw)
    steered = ServingEngine(tsp, tcfg, n_slots=1, cache_len=32,
                            ensemble=avg).run(
        [Request(0, np.asarray(req[0][1], np.int32), 6)], 20)
    assert steered != clean


def test_random_logits_attack_is_seeded_by_positions():
    """A random decode-time attack draws from a generator seeded from
    ``(spec.seed, sum(pos))``: two runs agree, another seed differs."""
    stack = torch.zeros((5, 2, 8))
    pos = np.asarray([3, 9], np.int32)
    spec = AggSpec(f=1, gar="krum", attack="random")
    a = tsr._maybe_attack_logits(stack, spec, pos)
    b = tsr._maybe_attack_logits(stack, spec, pos)
    assert torch.equal(a, b) and bool((a[-1] != 0).any())
    assert torch.equal(a[:-1], stack[:-1])
    c = tsr._maybe_attack_logits(stack, dataclasses.replace(spec, seed=1),
                                 pos)
    assert not torch.equal(a, c)
    assert tsr._maybe_attack_logits(
        stack, dataclasses.replace(spec, attack="none"), pos) is stack


def test_engine_threads_agg_state_and_keeps_int32():
    jcfg, tcfg, jsp, tsp = _ensemble("gemma_2b", 5, seed=0)
    spec = AggSpec(f=1, gar="buffered-cwmed", history_window=3)
    eng = ServingEngine(tsp, tcfg, n_slots=2, cache_len=32, ensemble=spec)
    assert eng.agg_state is not None and eng.agg_state.step == 0
    assert eng.positions.dtype == np.int32
    eng.admit(Request(0, np.asarray([1, 2, 3], np.int32), 10))
    for _ in range(3):
        eng.step()
    assert eng.agg_state.step == 3
    hist = eng.agg_state.history[0]
    assert hist.shape[:2] == (3, 5) and bool((hist != 0).any())
    assert eng.positions.dtype == np.int32
    assert eng.last_token.dtype == np.int32
    assert eng.positions.tolist() == [6, 0]
    # against the reference's engine, state and all
    jeng = JEngine(jsp, jcfg, n_slots=2, cache_len=32,
                   ensemble=JSpec(f=1, gar="buffered-cwmed",
                                  history_window=3))
    jeng.admit(JReq(0, np.asarray([1, 2, 3], np.int32), 10))
    for _ in range(3):
        jeng.step()
    assert jeng.active[0].generated == eng.active[0].generated
    _close(hist, jeng.agg_state.history[0])


def test_telemetry_off_equals_on():
    """``telemetry=True`` (``obs-bulyan-krum``) leaves the streams the
    same bit for bit, and the ring counts one row per aggregation: one
    per admission-free decode step (admissions aggregate statelessly)."""
    _, tcfg, _, tsp = _ensemble("llama3_2_3b", 7)
    reqs = lambda: [Request(r, np.asarray(p, np.int32), m)
                    for r, p, m in REQS]
    spec = AggSpec(f=1, gar="bulyan-krum", distance_backend="fused")
    off = ServingEngine(tsp, tcfg, n_slots=2, cache_len=32, ensemble=spec)
    on = ServingEngine(tsp, tcfg, n_slots=2, cache_len=32,
                       ensemble=dataclasses.replace(spec, telemetry=True))
    want, got = off.run(reqs(), 40), on.run(reqs(), 40)
    assert got == want
    steps = sum(m for _, _, m in REQS) - len(REQS)
    report = on.telemetry()
    assert 0 < report["pushed"] == on.agg_state.step <= steps
    assert off.telemetry()["pushed"] == 0
    assert report["accept_mean"] == 0.0
    assert report["accept_counts"].shape == (0, 2)


def test_serve_demo_ensemble_on_the_cpu():
    """``examples/serve_demo_torch.py`` in ensemble mode at the demo's
    size (8 replicas raised to Bulyan's quorum of 11, 2 poisoned) on the
    CPU: Bulyan rejects the poisoned replicas, ``average`` is steered,
    and neither JAX nor the reference is imported."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve_demo_torch', '--device', 'cpu', '--ensemble',"
        " '8', '--serve-f', '2', '--serve-gar', 'bulyan']\n"
        "runpy.run_path('examples/serve_demo_torch.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "raising ensemble from 8 to 11" in out.stdout
    assert "bulyan rejects the poisoned replica: YES" in out.stdout
    assert "average is steered by the poisoned replica: YES" in out.stdout

"""Port parity of robust speculative decoding
(``repro_torch.serving.speculative``, ``make_robust_verify_step`` and the
engine's speculative mode) against the JAX reference, on the CPU, from
the reference's weights and jittered replicas, at 1e-4 of the largest
entry of what is compared.  The counterparts of the reference's
``tests/test_speculative.py``:

* the robust verify step aggregates per position in stream order,
  threading ``AggState``, equal to ``k`` per-position aggregations and
  to the reference's verify step;
* ``k = 1`` reproduces the per-token engine bit for bit for every tree
  rule; greedy speculation with a stateless rule is lossless at any k;
* a poisoned draft and poisoned verifiers at the quorum edge leave the
  clean stream; continuous batching admits mid-stream; a reused slot
  is reset; the draft proposal equals greedy decode (and the
  reference's) and ``k = 1`` never runs the draft;
* ``accept_block`` against the reference's on the same logits, ties and
  NaN rows included; ``fused`` equals ``xla`` on block stacks and
  through the verify step; the engine's ``telemetry()`` acceptance
  record.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agg import AggSpec as JSpec  # noqa: E402
from repro.dist import serve_robust as jsr  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import verify_step as jverify_step  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro_torch.agg import AggSpec, resolve_rule, rule_names  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.dist import serve_robust as tsr  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, prefill, verify_step  # noqa
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.serving import (Request, ServingEngine,  # noqa: E402
                                 accept_block, draft_cache_view,
                                 make_draft_propose)
from torch_serving_compare import (GapRecorder,  # noqa: E402
                                   assert_streams_match)

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
_MICRO = dict(name="spec-test", arch_type="dense", n_layers=1, d_model=64,
              n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
              head_dim=32, ffn_act="swiglu", layer_pattern=("attn",),
              tie_embeddings=True, param_dtype="float32")
JCFG, TCFG = JConfig(**_MICRO), TConfig(**_MICRO)


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


_CACHE = {}


def _weights(n=None, poison=False):
    """The reference's micro-model weights (``n``: its jittered replica
    stack, the last one sign-flipped at scale 10 with ``poison``), in
    both packages; built once per module."""
    key = (n, poison)
    if key not in _CACHE:
        params = jinit_model(KEY, JCFG)
        if n is not None:
            params = jsr.replicate_params(params, n, jitter=1e-3,
                                          key=jax.random.PRNGKey(7))
            if poison:
                params = jsr.poison_replicas(params, 1, "signflip",
                                             scale=10.0)
        _CACHE[key] = (params, params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return _CACHE[key]


def _req(rid, seed, n_new, plen=5, cls=Request):
    rng = np.random.RandomState(seed)
    return cls(rid, rng.randint(0, JCFG.vocab_size, size=(plen,)
                                ).astype(np.int32), n_new)


def _serve(params, spec, reqs, n_slots=2):
    return ServingEngine(params, TCFG, n_slots=n_slots, cache_len=64,
                         ensemble=spec).run(reqs, 64)


def _block_inputs(b=2, p=5, k=4, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab_size, (b, p)).astype(np.int32)
    block = rng.integers(0, JCFG.vocab_size, (b, k)).astype(np.int32)
    return toks, block, np.full((b,), p, np.int32)


# ---------------------------------------------------------------------------
# 1. robust verify == k per-position aggregations (AggState included)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gar", ["krum", "cwmed", "bulyan-krum",
                                 "buffered-krum", "centered_clip_momentum",
                                 "reputation-krum",
                                 "reputation-buffered-krum"])
def test_robust_verify_matches_per_position_aggregation(gar):
    """The port's verify step against ``k`` ``aggregate_logits`` calls
    on its own block stack, threading the state by hand (bit for bit);
    its block stack against the reference's; and its per-position
    aggregation of the reference's stack against the reference's verify
    step (1e-4, ``selected`` equal, the carried state too)."""
    n, f, length = 7, 1, 32
    jsp, tsp = _weights(n)
    toks, block, pos = _block_inputs()
    jcache = jax.vmap(lambda p: jprefill(p, JCFG, toks, cache_len=length)[1])(
        jsp)
    tcache = torch.func.vmap(lambda p: prefill(p, TCFG, _t(toks),
                                               cache_len=length)[1])(tsp)
    spec = AggSpec(f=f, gar=gar)
    state = tsr.init_ensemble_state(spec, n, 2, JCFG.vocab_size,
                                    device="cpu")
    agg_k, _, diag, st_new = tsr.make_robust_verify_step(TCFG, spec)(
        tsp, tcache, _t(block), pos, state)
    assert agg_k.shape == (2, 4, JCFG.vocab_size)
    assert diag.selected.shape == (4, n)
    stack = torch.func.vmap(lambda p, c: verify_step(p, TCFG, c, _t(block),
                                                     pos))(tsp, tcache)[0]
    stateful = spec.rule().stateful
    st_ref = state
    for j in range(4):
        out = tsr.aggregate_logits(stack[:, :, j], f, gar,
                                   state=st_ref if stateful else None)
        if stateful:
            st_ref = out[2]
        assert torch.equal(agg_k[:, j], out[0]), j
    if stateful:
        assert st_new.step == st_ref.step == 4
        for a, b in zip(tree_leaves(st_new), tree_leaves(st_ref)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    # the reference: its block stack, then its verify step; the port's
    # aggregation runs on the reference's stack, so a near-tie in the
    # replicas' scores (1e-3 jitter) cannot pick differently
    jstack = jax.vmap(lambda p, c: jverify_step(p, JCFG, c, block, pos))(
        jsp, jcache)[0]
    _close(stack, jstack, what="block stack")
    jstate = jsr.init_ensemble_state(JSpec(f=f, gar=gar), n, 2,
                                     JCFG.vocab_size)
    want, _, wdiag, jst = jax.jit(jsr.make_robust_verify_step(
        JCFG, JSpec(f=f, gar=gar)))(jsp, jcache, block, jnp.asarray(pos),
                                     jstate)
    st = state
    for j in range(4):
        out = tsr.aggregate_logits(_t(np.asarray(jstack)[:, :, j]), f, gar,
                                   state=st if stateful else None)
        if stateful:
            st = out[2]
        _close(out[0], np.asarray(want)[:, j], what=f"position {j}")
        np.testing.assert_array_equal(out[1].selected.numpy(),
                                      np.asarray(wdiag.selected)[j])
    if stateful:
        for field in ("history", "center", "reputation"):
            for a, b in zip(tree_leaves(getattr(st, field)),
                            jax.tree_util.tree_leaves(getattr(jst, field))):
                _close(a, b, what=field)


# ---------------------------------------------------------------------------
# 2. the engine: k = 1 identity, lossless k > 1, against the reference
# ---------------------------------------------------------------------------

def _tree_rules():
    names = [r for r in rule_names() if resolve_rule(r).tree_fn is not None]
    return names + ["bulyan-krum", "buffered-krum", "fused-krum",
                    "reputation-krum"]


@pytest.mark.parametrize("gar", _tree_rules())
def test_engine_speculative_k1_bitwise_identity(gar):
    f = 1
    n = max(resolve_rule(gar).min_n(f), 3)
    _, tsp = _weights(7)
    tsp = tree_map(lambda x: x[:n], tsp)
    reqs = lambda: [_req(0, 0, 6), _req(1, 1, 9)]
    base = AggSpec(f=f, gar=gar)
    ref = _serve(tsp, base, reqs())
    out = _serve(tsp, dataclasses.replace(base, speculative_k=1), reqs())
    assert out == ref


def test_per_token_and_speculative_streams_match_the_reference():
    """The port's per-token ensemble stream against the reference's
    (token by token, near-ties let off and counted), and the port's
    k = 4 stream equal to its per-token stream, as the reference's is
    (stateless greedy speculation is lossless)."""
    jsp, tsp = _weights(7)
    let_off = 0
    for gar in ("krum", "bulyan-krum", "cwmed"):
        jeng = JEngine(jsp, JCFG, n_slots=2, cache_len=64,
                       ensemble=JSpec(f=1, gar=gar))
        rec = GapRecorder(jeng)
        want = jeng.run([_req(0, 0, 8, cls=JReq), _req(1, 1, 12, cls=JReq)],
                        64)
        base = AggSpec(f=1, gar=gar)
        got = _serve(tsp, base, [_req(0, 0, 8), _req(1, 1, 12)])
        let_off += assert_streams_match(want, got, rec.gaps)
        for k in (2, 4):
            spec = dataclasses.replace(base, speculative_k=k)
            assert _serve(tsp, spec, [_req(0, 0, 8), _req(1, 1, 12)]) == got
    assert let_off <= 1


def test_speculative_engine_matches_the_reference():
    """The speculative engine (k = 4, ``bulyan-krum`` over ``fused``)
    against the reference's: streams and the acceptance record."""
    jsp, tsp = _weights(7)
    reqs = [(0, 0, 10), (1, 1, 7), (2, 2, 6)]
    jeng = JEngine(jsp, JCFG, n_slots=2, cache_len=64,
                   ensemble=JSpec(f=1, gar="bulyan-krum", speculative_k=4))
    want = jeng.run([_req(r, s, m, cls=JReq) for r, s, m in reqs], 64)
    teng = ServingEngine(tsp, TCFG, n_slots=2, cache_len=64,
                         ensemble=AggSpec(f=1, gar="bulyan-krum",
                                          speculative_k=4,
                                          distance_backend="fused"))
    got = teng.run([_req(r, s, m) for r, s, m in reqs], 64)
    assert got == want
    tel, jtel = teng.telemetry(), jeng.telemetry()
    np.testing.assert_array_equal(tel["accept_counts"],
                                  jtel["accept_counts"])
    assert tel["accept_mean"] == jtel["accept_mean"] > 1.0
    assert tel["accept_counts"].dtype == np.int32
    assert ((tel["accept_counts"] >= 1) & (tel["accept_counts"] <= 4)).all()


# ---------------------------------------------------------------------------
# 3. Byzantine acceptance
# ---------------------------------------------------------------------------

def test_poisoned_draft_and_verifiers_cannot_change_the_stream():
    """The last replica is poisoned; whether it drafts or only verifies,
    at the n = 4f + 3 quorum edge the stream is the clean ensemble's
    per-token greedy stream."""
    _, honest = _weights(7)
    _, poisoned = _weights(7, poison=True)
    reqs = lambda: [_req(0, 3, 12, plen=6)]
    clean = _serve(honest, AggSpec(f=1, gar="bulyan-krum"), reqs(), 1)
    for draft in (6, 0):
        spec = AggSpec(f=1, gar="bulyan-krum", speculative_k=4,
                       draft_replica=draft)
        assert _serve(poisoned, spec, reqs(), 1) == clean, draft
    with pytest.raises(ValueError, match="draft_replica 7 out of range"):
        ServingEngine(honest, TCFG, n_slots=1, cache_len=64,
                      ensemble=AggSpec(f=1, gar="krum", speculative_k=2,
                                       draft_replica=7))


# ---------------------------------------------------------------------------
# 4. continuous batching and slot reuse
# ---------------------------------------------------------------------------

def test_submit_step_admits_mid_stream():
    _, tp = _weights()
    eng = ServingEngine(tp, TCFG, n_slots=1, cache_len=64)
    a = _req(0, 0, 3)
    eng.submit(a)
    eng.step()          # admits a, decodes one token
    assert eng.active[0] is a and len(a.generated) == 2
    b = _req(1, 1, 4)
    eng.submit(b)       # queued: the only slot is busy
    eng.step()          # a reaches max_new_tokens, the slot frees
    assert a.done and eng.active[0] is None
    eng.step()          # b admitted into the freed slot mid-stream
    assert eng.active[0] is b and b.generated
    for _ in range(8):
        eng.step()
    assert b.done and len(b.generated) == 4
    assert eng.positions.dtype == np.int32


@pytest.mark.parametrize("spec_k", [0, 4])
def test_slot_reuse_staggered_lengths_matches_solo(spec_k):
    _, tsp = _weights(7)
    spec = AggSpec(f=1, gar="krum", speculative_k=spec_k)
    out = _serve(tsp, spec, [_req(0, 0, 3), _req(1, 1, 12), _req(2, 2, 6)])
    for seed, n_new in ((0, 3), (1, 12), (2, 6)):
        solo = _serve(tsp, spec, [_req(seed, seed, n_new)], 1)
        assert out[seed] == solo[seed]


def test_slot_reuse_resets_stateful_history():
    _, tsp = _weights(7)
    tsp = tree_map(lambda x: x[:5], tsp)
    spec = AggSpec(f=1, gar="buffered-krum")

    def stream_after(first_seed):
        return _serve(tsp, spec, [_req(0, first_seed, 3), _req(1, 1, 12),
                                  _req(2, 2, 6)])[2]

    assert stream_after(0) == stream_after(9)


# ---------------------------------------------------------------------------
# 5. draft proposal and acceptance
# ---------------------------------------------------------------------------

def test_draft_propose_k1_never_runs_the_draft():
    propose = make_draft_propose(TCFG, 1)
    token = torch.tensor([3, 5], dtype=torch.int32)
    cache = {"sentinel": torch.zeros((2, 4))}
    block, out_cache = propose(None, cache, token,
                               torch.zeros((2,), dtype=torch.int32))
    assert block.tolist() == [[3], [5]]
    assert out_cache is cache
    with pytest.raises(ValueError, match="must be >= 1"):
        make_draft_propose(TCFG, 0)


def test_draft_propose_matches_greedy_decode_and_the_reference():
    jp, tp = _weights()
    toks, _, pos = _block_inputs()
    _, jcache = jprefill(jp, JCFG, toks, cache_len=32)
    _, cache = prefill(tp, TCFG, _t(toks), cache_len=32)
    token = np.asarray([1, 2], np.int32)
    block, new_cache = make_draft_propose(TCFG, 4)(tp, cache, _t(token), pos)
    want, wcache = jspec.make_draft_propose(JCFG, 4)(jp, jcache, token,
                                                     jnp.asarray(pos))
    np.testing.assert_array_equal(block.numpy(), np.asarray(want))
    for a, b in zip(tree_leaves(new_cache), jax.tree_util.tree_leaves(
            wcache)):
        _close(a, b)
    assert block[:, 0].tolist() == token.tolist()
    tok, seq = _t(token), cache
    for j in range(1, 4):
        lj, seq = decode_step(tp, TCFG, seq, tok[:, None], pos + j - 1)
        tok = torch.argmax(lj[:, 0], dim=-1).to(torch.int32)
        assert torch.equal(block[:, j], tok)


def _accept_cases():
    agg = np.asarray([
        [[0., 1., 9., 0.], [9., 0., 1., 0.], [0., 9., 0., 1.],
         [0., 0., 1., 9.]],
        [[0., 9., 0., 0.], [0., 9., 0., 0.], [0., 9., 0., 0.],
         [0., 9., 0., 0.]]], np.float32)
    block = np.asarray([[7, 2, 0, 2], [7, 0, 1, 1]], np.int32)
    near = agg.copy()
    near[0, 2, 2] = 8.5                     # a draft 0.5 below the argmax
    ties = np.zeros((2, 4, 4), np.float32)  # every entry tied
    ties[1, :, 3] = 2.0
    ties[1, :, 1] = 2.0
    nan = agg.copy()
    nan[0, 1, 3] = np.nan                   # a NaN row: argmax is the NaN
    nan[1, 0, :] = np.nan
    rng = np.random.default_rng(0)
    rand = np.round(rng.standard_normal((3, 5, 6)), 1).astype(np.float32)
    rblock = rng.integers(0, 6, (3, 5)).astype(np.int32)
    return [(block, agg, 0.0), (block, near, 0.0), (block, near, 1.0),
            (block[:, :1], agg[:, :1], 0.0), (block, ties, 0.0),
            (block, nan, 0.0), (block, nan, 1.0), (rblock, rand, 0.0),
            (rblock, rand, 0.15)]


@pytest.mark.parametrize("case", range(9))
def test_accept_block_against_the_reference(case):
    """The reference's semantics (its ``test_accept_block_semantics``
    cases, margins, k = 1) and its outputs on ties (the first index
    wins), NaN rows (a NaN is the argmax, as ``jnp.argmax``) and a
    0.1-grid of random logits with many ties."""
    block, agg, margin = _accept_cases()[case]
    want = jspec.accept_block(jnp.asarray(block), jnp.asarray(agg),
                              margin=margin)
    got = accept_block(_t(block), _t(agg), margin=margin)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == 0:
        assert got[1].tolist() == [3, 1]
        assert got[0][0, :3].tolist() == [2, 0, 1]


def test_draft_cache_view_slices_one_replica():
    stacked = {"k": torch.arange(12.).reshape(3, 2, 2)}
    view = draft_cache_view(stacked, 1)
    assert torch.equal(view["k"], torch.arange(4., 8.).reshape(2, 2))


# ---------------------------------------------------------------------------
# 6. the fused backend through the verify path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gar", ["krum", "geomed", "bulyan-krum"])
def test_fused_backend_matches_xla_on_block_stacks(gar):
    n, f, b, k, v = 7, 1, 2, 4, 64
    stack = np.random.default_rng(3).standard_normal((n, b * k, v)).astype(
        np.float32)
    a_xla, r_xla = tsr.aggregate_logits(_t(stack), f, gar,
                                        distance_backend="xla")
    a_fused, r_fused = tsr.aggregate_logits(_t(stack), f, gar,
                                            distance_backend="fused")
    np.testing.assert_allclose(a_fused.numpy(), a_xla.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(r_fused.selected, r_xla.selected)
    want, _ = jax.jit(lambda x: jsr.aggregate_logits(
        x, f, gar, distance_backend="xla"))(jnp.asarray(stack))
    _close(a_fused, want)


def test_fused_backend_through_robust_verify_step():
    n, f, length = 7, 1, 32
    _, tsp = _weights(n)
    toks, block, pos = _block_inputs()
    cache = torch.func.vmap(lambda p: prefill(p, TCFG, _t(toks),
                                              cache_len=length)[1])(tsp)
    out = {}
    for backend in ("xla", "fused"):
        spec = AggSpec(f=f, gar="krum", distance_backend=backend,
                       speculative_k=4)
        out[backend] = tsr.make_robust_verify_step(TCFG, spec)(
            tsp, cache, _t(block), pos, None)[0]
    assert torch.equal(out["fused"], out["xla"])


def test_make_robust_verify_step_gates_unsupported_configs():
    from repro_torch.configs import get_reduced
    with pytest.raises(ValueError, match="speculative verify unsupported"):
        tsr.make_robust_verify_step(get_reduced("mixtral_8x22b"),
                                    AggSpec(f=1, gar="krum"))

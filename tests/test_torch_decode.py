"""Port parity of the model zoo's serving path
(``repro_torch.models.decode`` and the decode halves of ``attention.py``
and ``ssm.py``) against the JAX reference, on the CPU, from the
reference's weights (carried across with ``params_from_jax``) and numpy
inputs, at the reference's fp32 tolerance: 1e-4 of the largest entry of
what is compared.

* ``decode_attention`` / ``verify_attention`` with masks, GQA and
  ``Sq = 1`` (where verify is decode bit for bit, in both packages);
* ``ssd_recurrent_step``, ``mamba_prefill`` (a conv history shorter
  than the kernel is zero-padded), ``init_mamba_cache`` and
  ``mamba_decode_step``;
* every family's reduced config: prefill, then decode steps, logits and
  caches against the reference's, and the port's decode against its own
  full ``forward`` (the reference's ``tests/test_serving.py`` contract);
* ``verify_step`` against sequential decode and the reference's, with
  staggered per-slot positions; a ring cache past its window;
* ``verify_supported``'s gate with the reference's reason texts, and
  ``init_cache``'s layout and device default.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs import get_reduced as tget_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

TOL = 1e-4
FAMILIES = ["llama3_2_3b", "mamba2_130m", "whisper_medium",
            "jamba_1_5_large", "mixtral_8x22b", "gemma3_1b",
            "llama4_scout", "llama3_2_vision", "gemma_2b", "qwen1_5_4b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _close_tree(got, want, what=""):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, what=f"{what} leaf {i}")


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _micro(window=0, pattern=("attn",)):
    """The reference's one-layer micro model (``tests/test_speculative.py``),
    optionally with a sliding window."""
    kw = dict(name="spec-test", arch_type="dense", n_layers=len(pattern),
              d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
              vocab_size=128, head_dim=32, ffn_act="swiglu",
              layer_pattern=pattern, tie_embeddings=True,
              param_dtype="float32", window=window)
    return JConfig(**kw), TConfig(**kw)


def _weights(jcfg, seed=0):
    params = jinit_model(jax.random.PRNGKey(seed), jcfg)
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                   "cpu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_decode_attention(masked):
    b, s, hq, hkv, d = 3, 19, 8, 2, 16
    q, k, v = _rand((b, 1, hq, d), 0), _rand((b, s, hkv, d), 1), \
        _rand((b, s, hkv, d), 2)
    valid = np.asarray([1, 7, 19], np.int32) if masked else None
    want = jattn.decode_attention(q, k, v, None if valid is None
                                  else jnp.asarray(valid))
    got = tattn.decode_attention(_t(q), _t(k), _t(v), None if valid is None
                                 else _t(valid))
    _close(got, want)
    # Sq = 1 verify is decode bit for bit, in both packages
    qv = None if valid is None else valid[:, None]
    assert torch.equal(tattn.verify_attention(
        _t(q), _t(k), _t(v), None if qv is None else _t(qv)), got)
    jv = jattn.verify_attention(q, k, v, None if qv is None
                                else jnp.asarray(qv))
    assert np.array_equal(np.asarray(jv), np.asarray(want))


def test_verify_attention_per_query_prefix():
    b, sq, s, hq, hkv, d = 2, 4, 12, 4, 1, 8
    q, k, v = _rand((b, sq, hq, d), 3), _rand((b, s, hkv, d), 4), \
        _rand((b, s, hkv, d), 5)
    q_valid = np.asarray([[3, 4, 5, 6], [9, 10, 11, 12]], np.int32)
    want = jattn.verify_attention(q, k, v, jnp.asarray(q_valid))
    _close(tattn.verify_attention(_t(q), _t(k), _t(v), _t(q_valid)), want)
    _close(tattn.verify_attention(_t(q), _t(k), _t(v)),
           jattn.verify_attention(q, k, v))


# ---------------------------------------------------------------------------
# the SSM's serving half
# ---------------------------------------------------------------------------

def test_ssd_recurrent_step():
    b, h, n, p = 2, 3, 5, 4
    state, x1 = _rand((b, h, n, p), 6), _rand((b, h, p), 7)
    dt = np.abs(_rand((b, h), 8, 0.5)) + 0.01
    a = -np.abs(_rand((h,), 9)) - 0.1
    bb, cc = _rand((b, n), 10), _rand((b, n), 11)
    want = jssm.ssd_recurrent_step(state, x1, dt, a, bb, cc)
    got = tssm.ssd_recurrent_step(*(_t(v) for v in (state, x1, dt, a, bb,
                                                    cc)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s", [2, 21])
def test_mamba_prefill_and_decode(s):
    """Prefill (chunk 8, a padded last chunk at s = 21; at s = 2 the conv
    history is shorter than ssm_conv - 1 and zero-padded), then three
    recurrent decode steps, against the reference."""
    jcfg, tcfg = jget_reduced("mamba2_130m"), tget_reduced("mamba2_130m")
    p = jax.tree_util.tree_map(np.asarray, jssm.init_mamba(
        jax.random.PRNGKey(12), jcfg, jnp.float32))
    tp = params_from_jax(p, "cpu")
    x = _rand((2, s, jcfg.d_model), 13)
    want, wcache = jax.jit(partial(jssm.mamba_prefill, cfg=jcfg, chunk=8))(
        p, x)
    got, cache = tssm.mamba_prefill(tp, _t(x), tcfg, chunk=8)
    _close(got, want)
    _close_tree(cache, wcache, "prefill cache")
    _close(tssm.mamba_forward(tp, _t(x), tcfg, chunk=8), want)
    init = tssm.init_mamba_cache(tcfg, 2, torch.float32, device="cpu")
    winit = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(init)] == [
        (a.shape, torch.float32) for a in jax.tree_util.tree_leaves(winit)]
    for t in range(3):
        x1 = _rand((2, 1, jcfg.d_model), 20 + t)
        wcache, want1 = jssm.mamba_decode_step(p, wcache, x1, jcfg)
        cache, got1 = tssm.mamba_decode_step(tp, cache, _t(x1), tcfg)
        _close(got1, want1, what=f"decode {t}")
        _close_tree(cache, wcache, f"decode {t} cache")


# ---------------------------------------------------------------------------
# prefill and decode over every family
# ---------------------------------------------------------------------------

def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = None
    if cfg.arch_type in ("audio", "vlm"):
        extra = rng.standard_normal(
            (b, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)
        ).astype(np.float32)
    return tokens, extra


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_every_family(arch):
    """Prefill 16 tokens, then 2 decode steps with a per-slot position
    vector: logits and every cache leaf against the reference's; and the
    port's own decode against its full ``forward`` at the reference's
    ``tests/test_serving.py`` tolerances (no-drop MoE capacity: the
    capacity dispatch depends on the batch by design)."""
    jcfg = dataclasses.replace(jget_reduced(arch), capacity_factor=100.0)
    tcfg = dataclasses.replace(tget_reduced(arch), capacity_factor=100.0)
    params, tp = _weights(jcfg, 1)
    b, s0, steps = 2, 16, 2
    tokens, extra = _inputs(jcfg, b, s0 + steps)
    textra = None if extra is None else _t(extra)
    want, wcache = jdecode.prefill(params, jcfg, tokens[:, :s0], extra,
                                   cache_len=s0 + steps)
    got, cache = tdecode.prefill(tp, tcfg, _t(tokens[:, :s0]), textra,
                                 cache_len=s0 + steps)
    _close(got, want, what="prefill")
    _close_tree(cache, wcache, "prefill cache")
    full, _ = tmodels.forward(tp, tcfg, _t(tokens), textra)
    for t in range(steps):
        pos = np.full((b,), s0 + t, np.int32)
        want1, wcache = jdecode.decode_step(
            params, jcfg, wcache, tokens[:, s0 + t:s0 + t + 1],
            jnp.asarray(pos))
        got1, cache = tdecode.decode_step(
            tp, tcfg, cache, _t(tokens[:, s0 + t:s0 + t + 1]), pos)
        _close(got1, want1, what=f"decode {t}")
        _close_tree(cache, wcache, f"decode {t} cache")
        np.testing.assert_allclose(got1[:, 0].numpy(),
                                   full[:, s0 + t].numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_init_cache_layout_and_device():
    """The reference's layout (periods stacked ``(n_periods, B, ...)``,
    ring slots bounded by the window) in the parameters' dtype; the
    default device is the card, so without one it raises."""
    for arch in FAMILIES:
        jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
        want = jdecode.init_cache(jcfg, 2, 96)
        got = tdecode.init_cache(tcfg, 2, 96, device="cpu")
        assert [(tuple(a.shape), str(a.dtype).split(".")[-1])
                for a in tree_leaves(got)] == [
            (a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(want)]
        assert all(not bool(a.any()) for a in tree_leaves(got))
    assert tdecode.slot_cache_len(tget_reduced("mixtral_8x22b"), "swa",
                                  4096) == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodels.init_cache(tget_reduced("gemma_2b"), 1, 8)


def test_ring_cache_wraps_past_the_window():
    """A sliding-window slot with an 8-position ring, decoded 14 steps
    past a 5-token prompt: writes land at ``pos % 8`` and the logits
    track the reference's throughout."""
    jcfg, tcfg = _micro(window=8, pattern=("swa",))
    params, tp = _weights(jcfg, 2)
    tokens, _ = _inputs(jcfg, 2, 19, seed=3)
    _, wcache = jdecode.prefill(params, jcfg, tokens[:, :5], cache_len=32)
    _, cache = tdecode.prefill(tp, tcfg, _t(tokens[:, :5]), cache_len=32)
    assert cache["periods"]["s0"]["k"].shape[2] == 8
    for pos in range(5, 19):
        want, wcache = jdecode.decode_step(params, jcfg, wcache,
                                           tokens[:, pos:pos + 1], pos)
        got, cache = tdecode.decode_step(tp, tcfg, cache,
                                         _t(tokens[:, pos:pos + 1]), pos)
        _close(got, want, what=f"pos {pos}")
    _close_tree(cache, wcache, "ring cache")


# ---------------------------------------------------------------------------
# the verify block
# ---------------------------------------------------------------------------

def _verify_against_sequential(jcfg, tcfg, pos0, seed=0):
    params, tp = _weights(jcfg)
    b, k, length = 2, 4, 32
    tokens, _ = _inputs(jcfg, b, 6, seed)
    block, _ = _inputs(jcfg, b, k, seed + 1)
    _, wcache = jdecode.prefill(params, jcfg, tokens, cache_len=length)
    _, cache = tdecode.prefill(tp, tcfg, _t(tokens), cache_len=length)
    pos = np.asarray(pos0, np.int32)
    want, wnew = jdecode.verify_step(params, jcfg, wcache, block,
                                     jnp.asarray(pos))
    got, new = tdecode.verify_step(tp, tcfg, cache, _t(block), pos)
    _close(got, want, what="verify")
    _close_tree(new, wnew, "verify cache")
    seq = cache
    for j in range(k):
        lj, seq = tdecode.decode_step(tp, tcfg, seq, _t(block[:, j:j + 1]),
                                      pos + j)
        np.testing.assert_allclose(got[:, j].numpy(), lj[:, 0].numpy(),
                                   atol=1e-5)
        assert torch.equal(torch.argmax(got[:, j], -1),
                           torch.argmax(lj[:, 0], -1))


@pytest.mark.parametrize("arch", ["llama3_2_3b", "gemma_2b"])
def test_verify_step_matches_sequential_decode(arch):
    _verify_against_sequential(jget_reduced(arch), tget_reduced(arch),
                               [6, 6])


def test_verify_step_staggered_positions():
    """Per-slot position vectors: slot 1 verifies behind slot 0."""
    _verify_against_sequential(*_micro(), [6, 4], seed=5)


def test_verify_supported_gate():
    """The gate and its reason texts are the reference's for every
    family; a ring or SSM slot raises inside ``verify_step`` too."""
    for arch in FAMILIES:
        assert tdecode.verify_supported(tget_reduced(arch)) == \
            jdecode.verify_supported(jget_reduced(arch)), arch
    ok, why = tdecode.verify_supported(tget_reduced("mixtral_8x22b"))
    assert not ok and why.startswith("swa: ring cache")
    ok, why = tdecode.verify_supported(tget_reduced("mamba2_130m"))
    assert not ok and why.startswith("mamba: recurrent SSM state")
    _, tcfg = _micro(window=8, pattern=("swa",))
    tp = tmodels.init_model(0, tcfg, device="cpu")
    cache = tdecode.init_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="does not support 'swa' slots"):
        tdecode.verify_step(tp, tcfg, cache,
                            torch.zeros((1, 2), dtype=torch.int32), 0)


def test_package_exports():
    from repro import models as jmodels
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert hasattr(tmodels, name), name

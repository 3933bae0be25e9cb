"""Port parity of the paper's models, the flat adapters and the optimizers:
repro_torch.models.simple / core.pytree / optim against the JAX reference
from the same parameters (carried over by ``params_from_jax``), at 1e-5.
Includes the traps found in the reference: ``"SAME"`` padding of the 4x4
convolution (1 before, 2 after), the NHWC flatten before ``w1`` and the
L2 term over every leaf, biases included.

The model zoo (``models/{layers,attention,moe,ssm,transformer}.py`` and
``configs``) at the reference's fp32 tolerance, 1e-4 of max(1, max
|want|): RoPE, every mask kind, naive against blockwise attention,
RMSNorm, each FFN activation, both MoE dispatch forms with a capacity
overflow and a routing tie, the chunked SSD with a padded last chunk,
the Mamba block, and ``forward``'s logits and aux loss for every one of
the ten ``reduced()`` configs from the reference's weights; one bf16
variant at 5e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import pytree as jpt  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    assert np.max(np.abs(got - want)) <= tol * scale, (
        np.max(np.abs(got - want)), scale)


def _jax_params(kind, seed=3, bias=True):
    """Reference init, with nonzero biases so every leaf matters."""
    init = (jsimple.init_mnist_mlp if kind == "mnist"
            else jsimple.init_cifar_cnn)
    params = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if bias and v.ndim == 1:
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _batch(kind, b=4, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 784) if kind == "mnist" else (b, 32, 32, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return x, y


_FWD = {"mnist": (jsimple.mnist_mlp_forward, tsimple.mnist_mlp_forward),
        "cifar": (jsimple.cifar_cnn_forward, tsimple.cifar_cnn_forward)}


def _losses(kind):
    jf, tf = _FWD[kind]

    def jloss(p, x, y):
        return jsimple.classification_loss(jf(p, x), y, p)

    def tloss(p, x, y):
        return tsimple.classification_loss(tf(p, x), y, p)

    return jloss, tloss


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
class TestModels:
    def test_published_width(self, kind):
        p = _jax_params(kind)
        d = sum(v.size for v in p.values())
        assert d == {"mnist": 79_510, "cifar": 486_346}[kind]
        init = (tsimple.init_mnist_mlp if kind == "mnist"
                else tsimple.init_cifar_cnn)
        t = init(0, device="cpu")
        assert {k: tuple(v.shape) for k, v in t.items()} == {
            k: v.shape for k, v in p.items()}

    def test_forward_and_loss(self, kind):
        p = _jax_params(kind)
        x, y = _batch(kind)
        jf, tf = _FWD[kind]
        jloss, tloss = _losses(kind)
        tp = params_from_jax(p, device="cpu")
        _close(tf(tp, torch.from_numpy(x)).numpy(),
               np.asarray(jf(p, jnp.asarray(x))))
        _close(float(tloss(tp, torch.from_numpy(x), torch.from_numpy(y))),
               float(jloss(p, jnp.asarray(x), jnp.asarray(y))))

    def test_per_worker_grads_and_flatten_order(self, kind):
        p = _jax_params(kind)
        xs = np.stack([_batch(kind, seed=w)[0] for w in range(3)])
        ys = np.stack([_batch(kind, seed=w)[1] for w in range(3)])
        jloss, tloss = _losses(kind)
        jg = jax.jit(jax.vmap(lambda xi, yi: jax.grad(jloss)(p, xi, yi)))(
            jnp.asarray(xs), jnp.asarray(ys))
        jflat, _ = jpt.stack_flatten(jg)
        tp = params_from_jax(p, device="cpu")
        tg = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0, 0))(
            tp, torch.from_numpy(xs), torch.from_numpy(ys).long())
        tflat, ctx = tpt.stack_flatten(tg)
        _close(tflat.numpy(), np.asarray(jflat))
        # unflatten inverts flatten, leaf for leaf
        back = tpt.unflatten(tflat[1], ctx)
        for k in tg:
            assert torch.equal(back[k], tg[k][1])

    def test_module_wrapper(self, kind):
        p = params_from_jax(_jax_params(kind), device="cpu")
        cls = tsimple.MnistMLP if kind == "mnist" else tsimple.CifarCNN
        x = torch.from_numpy(_batch(kind)[0])
        with torch.no_grad():
            assert torch.equal(cls(p)(x), _FWD[kind][1](p, x))


def test_same_padding_pads_one_before_two_after():
    """XLA's "SAME" for a 4x4 kernel pads 1 before and 2 after."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 15, 15, 16)).astype(np.float32)
    w = rng.standard_normal((4, 4, 16, 64)).astype(np.float32)
    b = np.zeros((64,), np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tsimple._conv_same(xt, torch.from_numpy(w), torch.from_numpy(b))
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    wrong = F.conv2d(F.pad(xt, (2, 1, 2, 1)),
                     torch.from_numpy(w).permute(3, 2, 0, 1))
    assert not np.allclose(wrong.permute(0, 2, 3, 1).numpy(),
                           np.asarray(want), atol=1e-3)


def test_flatten_before_w1_is_nhwc():
    """An NCHW flatten before ``w1`` would scramble the dense input."""
    p = params_from_jax(_jax_params("cifar"), device="cpu")
    x = torch.from_numpy(_batch("cifar")[0])
    want = np.asarray(jsimple.cifar_cnn_forward(
        _jax_params("cifar"), jnp.asarray(x.numpy())))
    _close(tsimple.cifar_cnn_forward(p, x).numpy(), want)
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.relu(tsimple._conv_same(h, p["c1"], p["cb1"])),
                     3, 2)
    h = F.max_pool2d(torch.relu(tsimple._conv_same(h, p["c2"], p["cb2"])),
                     4, 3)
    h = torch.relu(h.reshape(h.shape[0], -1) @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    assert not np.allclose((h @ p["w3"] + p["b3"]).numpy(), want, atol=1e-3)


def test_l2_covers_biases():
    p = _jax_params("mnist")
    x, y = _batch("mnist")
    jloss, tloss = _losses("mnist")
    tp = params_from_jax(p, device="cpu")
    bump = dict(p, b2=p["b2"] + 1.0)
    tbump = params_from_jax(bump, device="cpu")
    logits_shift = float(tloss(tbump, torch.from_numpy(x),
                               torch.from_numpy(y)))
    # a constant shift of every logit leaves the NLL unchanged, so the
    # whole difference is the L2 term of b2
    diff = logits_shift - float(tloss(tp, torch.from_numpy(x),
                                      torch.from_numpy(y)))
    want = float(jloss(bump, jnp.asarray(x), jnp.asarray(y))) - float(
        jloss(p, jnp.asarray(x), jnp.asarray(y)))
    l2 = tsimple.L2_REG * float(np.sum((p["b2"] + 1.0) ** 2 - p["b2"] ** 2))
    assert abs(diff - want) <= 1e-6 and abs(diff - l2) <= 1e-6


def test_accuracy():
    logits = np.random.default_rng(0).standard_normal((20, 10)).astype(
        np.float32)
    y = np.arange(20, dtype=np.int32) % 10
    assert float(tsimple.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(y))) == float(
        jsimple.accuracy(jnp.asarray(logits), jnp.asarray(y)))


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("adam", {}), ("adamw", {})])
def test_optimizers(name, kw):
    rng = np.random.default_rng(2)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal((3,)).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    jo = jopt.get_optimizer(name, jopt.fading_lr(0.3, 10.0), **kw)
    to = topt.get_optimizer(name, topt.fading_lr(0.3, 10.0), **kw)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, None
    tp, ts = params_from_jax(p, device="cpu"), None
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(params_from_jax(g, device="cpu"), ts, tp)
    for k in p:
        _close(tp[k].numpy(), np.asarray(jp[k]), 1e-6)
    assert ts["step"] == int(js["step"]) == 3


def test_fading_lr_values():
    for step in (0, 1, 17, 9999):
        assert float(topt.fading_lr(0.3, 1e4)(step)) == float(
            jopt.fading_lr(0.3, 1e4)(jnp.asarray(step, jnp.int32)))


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------

from functools import partial  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_reduced as tget_reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import forward as tforward  # noqa: E402
from repro_torch.models import init_model as tinit_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ZOO_TOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def test_rope_half_split():
    x = _rand((2, 12, 3, 16), 0)
    pos = np.arange(5, 17)
    for theta in (1e4, 5e5):
        want = jattn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tattn.rope(_t(x), _t(pos), theta)
        _close(got, want, ZOO_TOL)


@pytest.mark.parametrize("kind", ["attn", "swa", "chunked", "bidir",
                                  "cross"])
def test_mask_bias(kind):
    q = np.arange(3, 23)
    k = np.arange(0, 23)
    want = np.asarray(jattn._mask_bias(jnp.asarray(q), jnp.asarray(k), kind,
                                       5, 4))
    got = tattn._mask_bias(_t(q), _t(k), kind, 5, 4).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind,window,chunk", [
    ("attn", 0, 0), ("swa", 7, 0), ("chunked", 0, 8), ("bidir", 0, 0),
    ("cross", 0, 0)])
def test_attention_naive_and_blockwise(kind, window, chunk):
    """GQA (8 query heads on 2 kv heads), both paths against the
    reference's at a length with a padded last block (37), and the
    blockwise path (8 x 8 blocks, so the static block skipping of swa /
    chunked runs) against the naive one at a whole number of blocks
    (40): the reference's blockwise path attends to its zero-padded keys
    under ``bidir`` and ``cross``, and the port keeps that."""
    b, hq, hkv, d = 2, 8, 2, 16
    kw = dict(kind=kind, window=window, chunk=chunk)
    for s in (37, 40):
        q, k, v = (_rand((b, s, h, d), i)
                   for i, h in enumerate((hq, hkv, hkv)))
        want = jax.jit(partial(jattn.attention_naive, **kw))(q, k, v)
        naive = tattn.attention_naive(_t(q), _t(k), _t(v), **kw)
        _close(naive, want, ZOO_TOL)
        jblock = jax.jit(partial(jattn.attention_blockwise, block_q=8,
                                 block_k=8, **kw))(q, k, v)
        block = tattn.attention_blockwise(_t(q), _t(k), _t(v), block_q=8,
                                          block_k=8, **kw)
        _close(block, jblock, ZOO_TOL)
        if s % 8 == 0 or kind not in ("bidir", "cross"):
            _close(block, naive, ZOO_TOL)
        auto = tattn.attention(_t(q), _t(k), _t(v), impl="auto", **kw)
        assert torch.equal(auto, naive)


def test_rmsnorm():
    x = _rand((3, 5, 48), 1, 3.0)
    scale = _rand((48,), 2)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(tlayers.rmsnorm({"scale": _t(scale)}, _t(x)), want, ZOO_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_ffn(act):
    p = jlayers.init_ffn(jax.random.PRNGKey(3), 32, 64, act, jnp.float32)
    x = _rand((2, 9, 32), 4)
    want = jlayers.ffn(p, jnp.asarray(x), act)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p), "cpu")
    _close(tlayers.ffn(tp, _t(x), act), want, ZOO_TOL)


def _moe_params(tie: bool):
    p = jmoe.init_moe(jax.random.PRNGKey(5), 32, 48, 4, 1, "swiglu",
                      jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, p)
    if tie:
        # experts 1 and 2 score every token alike: each top-2 pick that
        # reaches them ties, and the lower index must win
        p["router"] = p["router"].copy()
        p["router"][:, 2] = p["router"][:, 1]
    return p


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("tie,capacity_factor", [(False, 1.25),
                                                 (False, 0.5),
                                                 (True, 0.5)])
def test_moe_ffn(impl, tie, capacity_factor):
    """Both dispatch forms against the reference's, at a roomy capacity
    and at one that overflows (tokens dropped), with and without a
    routing tie; the two forms agree with each other."""
    p = _moe_params(tie)
    x = _rand((2, 20, 32), 6)
    kw = dict(top_k=2, act="swiglu", capacity_factor=capacity_factor)
    want, waux = jax.jit(partial(jmoe.moe_ffn, impl=impl, **kw))(p, x)
    tp = params_from_jax(p, "cpu")
    got, aux = tmoe.moe_ffn(tp, _t(x), impl=impl, **kw)
    _close(got, want, ZOO_TOL)
    _close(aux, waux, ZOO_TOL)
    other = tmoe.moe_ffn(tp, _t(x), impl="einsum" if impl == "scatter"
                         else "scatter", **kw)[0]
    _close(got, other, ZOO_TOL)
    if capacity_factor < 1:
        # the overflow really drops tokens: some token gets no expert
        dense = tmoe.moe_ffn(tp, _t(x), impl=impl, top_k=2, act="swiglu",
                             capacity_factor=4.0)[0]
        assert float((dense - got).abs().max()) > 1e-3


def test_ssd_chunked_with_a_padded_chunk():
    b, s, h, p_, n, chunk = 2, 40, 3, 4, 5, 16
    x = _rand((b, s, h, p_), 7)
    dt = np.abs(_rand((b, s, h), 8, 0.5)) + 0.01
    a = -np.abs(_rand((h,), 9)) - 0.1
    bb, cc = _rand((b, s, n), 10), _rand((b, s, n), 11)
    want = jax.jit(partial(jssm.ssd_chunked, chunk=chunk))(x, dt, a, bb, cc)
    got = tssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bb, cc)),
                           chunk=chunk)
    _close(got, want, ZOO_TOL)


def test_mamba_forward():
    cfg = jget_reduced("mamba2_130m")
    p = jax.tree_util.tree_map(np.asarray, jssm.init_mamba(
        jax.random.PRNGKey(12), cfg, jnp.float32))
    x = _rand((2, 21, cfg.d_model), 13)
    want = jax.jit(partial(jssm.mamba_forward, cfg=cfg, chunk=8))(p, x)
    got = tssm.mamba_forward(params_from_jax(p, "cpu"), _t(x),
                             tget_reduced("mamba2_130m"), chunk=8)
    _close(got, want, ZOO_TOL)


def _zoo_inputs(cfg, seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = None
    if cfg.arch_type in ("audio", "vlm"):
        extra = rng.standard_normal(
            (b, cfg.encoder_seq or cfg.vision_seq, cfg.d_model)
        ).astype(np.float32)
    return tokens, extra


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_every_reduced_config(arch):
    """Logits and aux loss from the reference's weights (carried across
    with ``params_from_jax``); whisper and the vlm get ``extra`` from
    numpy.  The port's ``init_model`` has the reference's tree: the
    same key paths, shapes and dtypes."""
    cfg = jget_reduced(arch)
    params = jinit_model(jax.random.PRNGKey(1), cfg)
    tokens, extra = _zoo_inputs(cfg)
    want, waux = jax.jit(lambda p, t, e: jtransformer.forward(
        p, cfg, t, e))(params, tokens, extra)
    tcfg = tget_reduced(arch)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    got, aux = tforward(tp, tcfg, _t(tokens),
                        None if extra is None else _t(extra))
    assert got.dtype == torch.float32
    _close(got, want, ZOO_TOL)
    _close(aux, waux, ZOO_TOL)
    mine = tinit_model(0, tcfg, device="cpu")
    ref = [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
           for k, v in jax.tree_util.tree_flatten_with_path(params)[0]]
    from repro_torch.checkpoint.store import _flatten_with_path
    got_paths = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
                 for k, v in _flatten_with_path(mine)]
    assert [(r[1], r[2]) for r in ref] == [(g[1], g[2]) for g in got_paths]
    assert [r[0] for r in ref] == [
        "".join(f"['{p}']" for p in g[0].split("/")) for g in got_paths]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count(arch):
    """``param_count`` is the reference's analytic formula: it equals the
    leaf sizes except where the reference's own formula leaves a gap
    (mamba's conv bias and dt_bias, whisper's encoder), and there the
    gap is the reference's."""
    jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    jsize = sum(x.size for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), jcfg))))
    tsize = sum(x.numel() for x in tpt.tree_leaves(
        tinit_model(0, tcfg, device="cpu")))
    assert tsize == jsize
    assert tsize - tcfg.param_count() == jsize - jcfg.param_count()
    if arch not in ("mamba2_130m", "jamba_1_5_large", "whisper_medium"):
        assert tsize == tcfg.param_count()


def test_forward_bf16_variant():
    """A bf16 variant of reduced llama3.2-3b (``param_dtype`` and
    ``logits_dtype`` bfloat16; no reduced config is bf16) at the
    reference's bf16 tolerance, 5e-2."""
    import dataclasses
    jcfg = dataclasses.replace(jget_reduced("llama3_2_3b"),
                               param_dtype="bfloat16",
                               logits_dtype="bfloat16")
    tcfg = dataclasses.replace(tget_reduced("llama3_2_3b"),
                               param_dtype="bfloat16",
                               logits_dtype="bfloat16")
    params = jinit_model(jax.random.PRNGKey(2), jcfg)
    tokens, _ = _zoo_inputs(jcfg, seed=3)
    want, _ = jax.jit(lambda p, t: jtransformer.forward(p, jcfg, t))(
        params, tokens)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    assert tpt.tree_leaves(tp)[0].dtype == torch.bfloat16
    got, _ = tforward(tp, tcfg, _t(tokens))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 5e-2)

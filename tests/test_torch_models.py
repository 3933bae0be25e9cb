"""Port parity of the paper's models, the flat adapters and the optimizers:
repro_torch.models.simple / core.pytree / optim against the JAX reference
from the same parameters (carried over by ``params_from_jax``), at 1e-5.
Includes the traps found in the reference: ``"SAME"`` padding of the 4x4
convolution (1 before, 2 after), the NHWC flatten before ``w1`` and the
L2 term over every leaf, biases included.
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

"""The port's slice as a whole: repro_torch's ByzantineTrainer against the
JAX reference's, plus the port's hygiene (no JAX, no ``repro`` import;
no silent drop to the CPU).

Both trainers run 3 steps of ``fused-bulyan-krum`` under the paper's
Fig. 4 attack (``omniscient_linf``, closed-form gamma, "anti" direction,
margin 0.8) on the MNIST MLP at its published width, n = 7, f = 1, 4
samples per worker, from the same initial parameters and the same
batcher.  Parameters must agree to 1e-4 relative, element by element,
and ``byz_weight`` exactly.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import ByzantineBatcher as JaxBatcher  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.optim import fading_lr as jfading  # noqa: E402
from repro.optim import get_optimizer as jget  # noqa: E402
from repro.training import ByzantineSpec as JaxSpec  # noqa: E402
from repro.training import ByzantineTrainer as JaxTrainer  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.data.synthetic import ByzantineBatcher  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels.fused_agg import select_weights_plain  # noqa: E402
from repro_torch.kernels.pairwise_gram import (  # noqa: E402
    pairwise_gram_partial_plain)
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.obs import schema as tschema  # noqa: E402
from repro_torch.optim import fading_lr, get_optimizer  # noqa: E402
from repro_torch.training.trainer import (ByzantineTrainer,  # noqa: E402
                                          byzantine_stack,
                                          make_byzantine_step)

LINF = (("gar_name", "krum"), ("gamma", "closed"), ("direction", "anti"),
        ("margin", 0.8))


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jloss(p, x, y):
    return jsimple.classification_loss(jsimple.mnist_mlp_forward(p, x), y, p)


def _tloss(p, x, y):
    return tsimple.classification_loss(tsimple.mnist_mlp_forward(p, x), y, p)


def _window_ties(full, f, rel=1e-5):
    """Coordinates where Bulyan's window choice ties: another window's
    deviation from the medoid is within ``rel`` of the best one's, and its
    sum differs.  There 1e-8 of gradient noise between two frameworks
    legitimately flips the choice, and with it the coordinate's update."""
    n = full.shape[0]
    w = select_weights_plain(pairwise_gram_partial_plain(full), n, f,
                             "bulyan-krum")[0]
    s = torch.sort((w @ full).double(), dim=0).values
    theta = s.shape[0]
    beta = theta - 2 * f
    med = s[(theta - 1) // 2]
    devs = torch.stack([(s[i:i + beta] - med).abs().sum(0)
                        for i in range(theta - beta + 1)])
    sums = torch.stack([s[i:i + beta].sum(0)
                        for i in range(theta - beta + 1)])
    near = devs <= devs.min(dim=0).values * (1 + rel)
    hi = torch.where(near, sums, -torch.inf).max(dim=0).values
    lo = torch.where(near, sums, torch.inf).min(dim=0).values
    return (hi - lo) > 1e-4 * torch.maximum(hi.abs(), lo.abs())


def test_three_steps_match_reference_trainer():
    n, f, steps = 7, 1, 3
    p0 = jsimple.init_mnist_mlp(jax.random.PRNGKey(1))
    np0 = {k: np.asarray(v) for k, v in p0.items()}
    kw = dict(n_workers=n, f=f, gar="fused-bulyan-krum",
              attack="omniscient_linf", attack_kwargs=LINF)
    jtr = JaxTrainer(_jloss, p0, jget("sgd", jfading(0.3, 1e4)),
                     JaxSpec(**kw), seed=1)
    jtr.run(JaxBatcher("mnist", n - f, 4, seed=1, noise=0.5), steps)
    spec = AggSpec(**kw)
    ttr = ByzantineTrainer(_tloss, params_from_jax(np0, device="cpu"),
                           get_optimizer("sgd", fading_lr(0.3, 1e4)),
                           spec, seed=1, device="cpu")
    batcher = ByzantineBatcher("mnist", n - f, 4, seed=1, noise=0.5)
    ties = None
    for t in range(steps):
        x, y = batcher.batch(t)
        full = byzantine_stack(_tloss, spec, ttr.params, torch.as_tensor(x),
                               torch.as_tensor(y).long(),
                               step=ttr.opt_state["step"])[0]
        tie = _window_ties(full, f)
        ties = tie if ties is None else ties | tie
        ttr.run(batcher, 1, start_step=t)
    # Three coordinates of w1 tie here; at step 1 one of them ties to one
    # ulp (two windows mirror each other around the medoid) and flips.
    assert int(ties.sum()) <= 3, int(ties.sum())
    keys = sorted(np0)
    want = np.concatenate([np.asarray(jtr.params[k], np.float64).ravel()
                           for k in keys])
    got = np.concatenate([ttr.params[k].numpy().astype(np.float64).ravel()
                          for k in keys])
    # 1e-4 relative, with a 1e-7 absolute floor for parameters near zero
    # (float32's ulp at the weights' scale of 0.05 is 4e-9)
    ok = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-7
    bad = np.flatnonzero(~ok & ~ties.numpy())
    assert bad.size == 0, (bad[:10], got[bad[:10]], want[bad[:10]])
    for jh, th in zip(jtr.history, ttr.history):
        assert th["byz_weight"] == jh["byz_weight"]
        for key in ("loss", "agg_dev", "grad_norm"):
            assert abs(th[key] - jh[key]) <= 1e-4 * max(1.0, abs(jh[key]))
    assert [h["byz_weight"] for h in ttr.history] == [1.0] * steps


def test_batches_are_bit_identical():
    for kind in ("mnist", "cifar"):
        a = JaxBatcher(kind, 3, 2, seed=4, noise=0.3).batch(5)
        b = ByzantineBatcher(kind, 3, 2, seed=4, noise=0.3).batch(5)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_metric_schema_matches_reference():
    assert tschema.METRIC_SCHEMA == jschema.METRIC_SCHEMA
    tree = {"a": np.ones((3, 2), np.float32), "b": np.arange(4.0)}
    assert abs(float(tschema.global_norm(params_from_jax(tree, "cpu")))
               - float(jschema.global_norm(
                   {k: jnp.asarray(v) for k, v in tree.items()}))) < 1e-6


def test_stateful_and_unported_rules_raise():
    """The stateful rules build a step with the state in its signature,
    the telemetry family (``obs-krum``, or ``telemetry=True``) included,
    as in the reference."""
    import inspect
    opt = get_optimizer("sgd", 0.1)
    for kw in ({"gar": "buffered-krum"}, {"gar": "reputation-krum"},
               {"gar": "obs-krum"}, {"gar": "krum", "telemetry": True}):
        step = make_byzantine_step(_tloss, opt, AggSpec(n_workers=9, f=1,
                                                        **kw))
        assert list(inspect.signature(step).parameters)[-1] == "agg_state"


def test_import_pulls_in_no_jax_and_no_reference():
    """The port imports torch and numpy only: no jax, nothing of repro."""
    code = (
        "import sys\n"
        "import repro_torch.training.trainer, repro_torch.agg.fused\n"
        "import repro_torch.interop, repro_torch.kernels._build\n"
        "import repro_torch.data, repro_torch.optim\n"
        "import repro_torch.agg, repro_torch.core, repro_torch.dist\n"
        "import repro_torch.obs, repro_torch.training\n"
        "import repro_torch.audit, repro_torch.audit.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**__import__("os").environ,
                              "PYTHONPATH": "src"},
                         cwd=__import__("pathlib").Path(__file__)
                         .resolve().parent.parent)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device given, nothing drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsimple.init_mnist_mlp(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsimple.init_cifar_cnn(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    params = tsimple.init_mnist_mlp(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ByzantineTrainer(_tloss, params, get_optimizer("sgd", 0.1),
                         AggSpec(n_workers=7, f=1, gar="fused-krum"))

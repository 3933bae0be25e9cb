"""The sharded train step with the split forward (``make_train_step(mesh=)``
on ``forward(shard=)``) against the reference's single-device step and
the single-device port, on the CPU.

One gloo world, ``(1, 2)``, spawned once (the rank function is
``tests/torch_tp_cases.py``'s ``zoo_case``), runs from the reference's
weights, with ``attn_shard="batch"`` (the full configs' setting) and two
sequences of 16 tokens per worker, so the ``model`` axis splits each
attention by sequences:

* reduced llama3.2-3b, 2 steps of ``bulyan-krum`` with ``f = 0`` and
  n = 4 under momentum SGD (the reference's own sharded-step setting):
  against the reference's single-device step at its sharded-step bounds
  (5e-2 on parameters, 1e-3 on the loss) and under the port's LLM rule
  (``tests/torch_llm_compare.py``: each leaf's change at 1e-4 of its
  largest, Bulyan window ties let off), and against the single-device
  port under the LLM rule;
* every one of the ten configs' ``reduced()``, one step of ``average``
  with n = 2: the submissions at 1e-4 of each leaf's largest entry and
  the parameters under the LLM rule, against the single-device port.
  A leaf whose gradient is zero in exact arithmetic (whisper's
  cross-attention key bias: the softmax is invariant to a shift of all
  keys, and no rotary embedding varies it by position) carries only
  rounding noise on both runs; it is held to 1e-4 of the tree's largest
  entry instead of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_cases as cases  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist.train import DistByzantineSpec as JSpec  # noqa: E402
from repro.dist.train import make_train_step as jmake_train_step  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.dist.train import make_train_step  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from torch_llm_compare import close_change, scaled_close, window_ties  # noqa: E402

ARCH = "llama3_2_3b"
F0 = dict(f=0, gar="bulyan-krum", attack="none")
ZOO = dict(f=0, gar="average", attack="none")
#: a leaf whose largest entry is below this share of the tree's largest
#: is rounding noise of a gradient that is zero in exact arithmetic
NOISE = 1e-6


def _params_np(arch, seed=1):
    return jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(seed),
                                jget_reduced(arch)))


def _batches(cfg, n, steps):
    out = []
    for t in range(steps):
        b = cases.lm_batch(cfg.vocab_size, n, 2, t)
        extra = cases.extra_of(cfg, n, 2)
        if extra is not None:
            b["extra"] = extra
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setting():
    """The world's settings: name -> (arch, params, batches, spec)."""
    out = {"llama_f0": (ARCH, _params_np(ARCH),
                        _batches(cases.step_cfg(ARCH), 4, 2), F0)}
    for arch in ARCH_IDS:
        out[arch] = (arch, _params_np(arch, 2),
                     _batches(cases.step_cfg(arch), 2, 1), ZOO)
    return out


@pytest.fixture(scope="module")
def world(setting):
    return run_on_mesh(cases.zoo_case, (1, 2), args=(
        [(name,) + s for name, s in setting.items()],), device="cpu",
        num_threads=1, timeout=600)


def _single(setting, name):
    """The single-device port on a setting: per step the parameters,
    the submissions and the metrics."""
    torch.set_num_threads(1)
    arch, params_np, batches, kw = setting[name]
    cfg = cases.step_cfg(arch)
    params = params_from_jax(params_np, "cpu")
    opt = get_optimizer("momentum", cases.LR)
    subs = []
    step = make_train_step(cfg, AggSpec(distance_backend="pallas", **kw),
                           opt, observe=lambda sub, res: subs.append(sub))
    state = opt.init(params)
    rows = []
    for b in batches:
        params, state, m = step(params, state, b)
        rows.append({"params": params, "sub": subs[-1],
                     "metrics": {k: float(v) for k, v in m.items()}})
    return rows


def _np(x):
    """A leaf as numpy in its own dtype (the LLM rule reads the ulp of
    the parameters' own precision)."""
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _init(params_np):
    return [np.asarray(x, dtype=np.float64)
            for x in jax.tree_util.tree_leaves(params_np)]


def _hold(got_rows, want_rows, init, ties=None, floor=None, what=""):
    """Each step's parameters under the LLM rule; a leaf of ``floor``
    (its index) at 1e-4 of the tree's largest change instead."""
    for t, (g, w) in enumerate(zip(got_rows, want_rows)):
        gl = [_np(x) for x in tree_leaves(g["params"])]
        wl = [_np(x) for x in (tree_leaves(w["params"]) if isinstance(
            w["params"], dict) else w["params"])]
        big = max(float(np.max(np.abs(b - p))) for b, p in zip(wl, init))
        for i, (a, b, p) in enumerate(zip(gl, wl, init)):
            if floor is not None and i in floor:
                err = np.max(np.abs(a.astype(np.float64) - b))
                assert err <= 1e-4 * big, (what, t, i)
                continue
            close_change(a, b, p, t + 1, None if ties is None else ties[i],
                         what=(what, t, i))


def _noise_leaves(sub):
    """Leaves whose largest entry is rounding noise (see :data:`NOISE`)."""
    leaves = [_np(x).astype(np.float64) for x in tree_leaves(sub)]
    big = max(float(np.max(np.abs(x))) for x in leaves)
    return {i for i, x in enumerate(leaves)
            if float(np.max(np.abs(x))) <= NOISE * big}


@pytest.fixture(scope="module")
def reference(setting):
    """The reference's single-device jitted step on the llama setting."""
    arch, params_np, batches, kw = setting["llama_f0"]
    cfg = jget_reduced(arch)
    opt = jget_optimizer("momentum", cases.LR)
    step = jax.jit(jmake_train_step(cfg, JSpec(**kw), opt))
    p = jax.tree_util.tree_map(jnp.asarray, params_np)
    s = opt.init(p)
    rows = []
    for b in batches:
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        rows.append({"params": [np.asarray(x) for x in
                                jax.tree_util.tree_leaves(p)],
                     "metrics": {k: float(v) for k, v in m.items()}})
    return rows


def test_every_rank_ends_with_the_same_parameters(world, setting):
    for name in setting:
        for r in world[1:]:
            for a, b in zip(r[name]["rows"], world[0][name]["rows"]):
                for x, y in zip(tree_leaves(a["params"]),
                                tree_leaves(b["params"])):
                    assert torch.equal(x, y), name


def test_batch_split_step_matches_the_reference(world, setting, reference):
    """The reference's sharded-step bounds and the LLM rule."""
    port = world[0]["llama_f0"]["rows"]
    init = _init(setting["llama_f0"][1])
    last = [_np(x).astype(np.float64) for x in tree_leaves(
        port[-1]["params"])]
    diff = max(float(np.max(np.abs(a - b)))
               for a, b in zip(last, reference[-1]["params"]))
    assert diff < 5e-2
    assert abs(port[-1]["metrics"]["loss"]
               - reference[-1]["metrics"]["loss"]) < 1e-3
    _hold(port, reference, init, what="reference")
    for t in range(2):
        for k in ("loss", "grad_norm"):
            scaled_close(port[t]["metrics"][k], reference[t]["metrics"][k],
                         what=(t, k))


def test_batch_split_step_matches_the_single_device_port(world, setting):
    port = world[0]["llama_f0"]["rows"]
    single = _single(setting, "llama_f0")
    ties = None
    for t in range(2):
        tie = window_ties(tree_leaves(single[t]["sub"]),
                          tree_leaves(port[t]["sub"]), 0)
        ties = tie if ties is None else [a | b for a, b in zip(ties, tie)]
    _hold(port, single, _init(setting["llama_f0"][1]),
          [m.numpy() for m in ties], what="port")
    for t in range(2):
        assert port[t]["metrics"]["byz_weight"] == single[t]["metrics"][
            "byz_weight"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_step_matches_the_single_device_port(world, setting,
                                                          arch):
    port = world[0][arch]["rows"]
    single = _single(setting, arch)
    floor = _noise_leaves(single[0]["sub"])
    for i, (a, b) in enumerate(zip(tree_leaves(port[0]["sub"]),
                                   tree_leaves(single[0]["sub"]))):
        if i in floor:
            assert float((a - b).abs().max()) <= NOISE * max(
                float(x.abs().max()) for x in tree_leaves(
                    single[0]["sub"])), (arch, i)
        else:
            scaled_close(a, b, what=(arch, i))
    _hold(port, single, _init(setting[arch][1]), floor=floor, what=arch)
    scaled_close(port[0]["metrics"]["loss"], single[0]["metrics"]["loss"],
                 what=(arch, "loss"))
    # the model axis ran the split forward: collectives over it
    assert port[0]["comm"]["all_reduce"]["calls"] > 0


def test_only_whisper_has_a_noise_leaf(world, setting):
    """The floor of :func:`_hold` covers one leaf kind only."""
    for arch in ARCH_IDS:
        floor = _noise_leaves(world[0][arch]["rows"][0]["sub"])
        paths = sorted(floor)
        assert (len(paths) > 0) == (arch == "whisper_medium"), (arch, paths)

"""The shared half of the sharded-runtime tests
(``tests/test_torch_sharded.py``, ``test_torch_sharded_train.py`` and
``test_torch_sharded_replicate.py``): their inputs, the reference's
subprocess on 4 host devices, the single-device port on the same cases,
and the comparisons.

Each test file spawns its own world (``repro_torch.dist.mesh
.run_on_mesh``) with the rank functions of ``tests/torch_shard_cases.py``
and, where it holds the port to the reference, runs only its part of the
reference's script beside it: ``"engine"`` (the shard-mapped Pallas
distance pass and aggregates on the distance-backend tree) or
``"train"`` (the single-device and sharded ``f = 0`` steps, the
attacked, reputation and asynchronous steps).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch

import torch_shard_cases as cases
from repro.configs import get_reduced as jget_reduced
from repro.models import init_model as jinit_model
from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_leaves
from repro_torch.dist.async_train import (init_async_state,
                                          make_async_train_step)
from repro_torch.dist.train import (byzantine_grads, init_agg_state,
                                    make_loss_fn, make_train_step)
from repro_torch.interop import params_from_jax
from repro_torch.optim import get_optimizer
from torch_llm_compare import close_change, window_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 1
TOL = 1e-4

#: the reference's script, by part: its head and tail run every time
_REF_HEAD = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.dist import robust
    from repro.dist.async_train import init_async_state, make_async_train_step
    from repro.dist.mesh import make_host_mesh
    from repro.dist.sharding import batch_pspec, param_shardings
    from repro.dist.train import (DistByzantineSpec, init_agg_state,
                                  make_loss_fn, make_train_step)
    from repro.optim import get_optimizer

    inp = pickle.load(open(sys.argv[1], "rb"))
    assert jax.device_count() == 4
    mesh = make_host_mesh((2, 2), ("data", "model"))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = {}

""")
_REF_PARTS = {
    "engine": textwrap.dedent("""    tree = jax.tree_util.tree_map(jnp.asarray, inp["tree"])
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), tree)
    with mesh:
        out["dists"] = np.asarray(jax.jit(lambda t: robust.pairwise_sq_dists_tree(
            t, distance_backend="pallas", mesh=mesh, interpret=True))(sharded))
        for gar in ("krum", "bulyan-krum"):
            agg, res = jax.jit(lambda t: robust.distributed_aggregate(
                t, 1, gar, distance_backend="pallas", mesh=mesh))(sharded)
            out[("agg", gar)] = (to_np(agg), np.asarray(res.selected))

"""),
    "train": textwrap.dedent("""    cfg = get_reduced("llama3_2_3b")
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    opt = get_optimizer("momentum", 1e-2)

    def batch(n, t):
        return {k: jnp.asarray(v) for k, v in inp["batches"][(n, t)].items()}

    def run(spec, n, steps, on_mesh=False, asynchronous=False):
        if asynchronous:
            step = jax.jit(make_async_train_step(cfg, spec, opt))
            agg = init_async_state(spec, params, n)
        else:
            step = jax.jit(make_train_step(cfg, spec, opt))
            agg = init_agg_state(spec, params, n)
        p, s = params, opt.init(params)
        if on_mesh:
            p = jax.device_put(p, param_shardings(p, mesh))
            s = jax.device_put(s, param_shardings(s, mesh))
        rows = []
        for t in range(steps):
            b = batch(n, t)
            if on_mesh:
                b = jax.tree_util.tree_map(lambda x: jax.device_put(
                    x, NamedSharding(mesh, batch_pspec(x.shape, mesh))), b)
                with mesh:
                    p, s, m = step(p, s, b)
            elif agg is None:
                p, s, m = step(p, s, b)
            else:
                p, s, m, agg = step(p, s, b, agg)
            rows.append({"params": to_np(p), "m": to_np(s.get("m")),
                         "metrics": {k: float(v) for k, v in m.items()}})
            if asynchronous:
                rows[-1]["bus"] = to_np(agg.bus.grads)
                rows[-1]["versions"] = np.asarray(agg.bus.versions)
        return rows

    vg = jax.value_and_grad(make_loss_fn(cfg))

    @jax.jit
    def submissions(p, tokens, labels):
        grads = jax.vmap(lambda t, l: vg(p, t, l)[1])(tokens, labels)
        return robust.inject_byzantine(grads, 1, "omniscient_linf",
                                       gar_name="bulyan-krum")

    f0 = DistByzantineSpec(f=0, gar="bulyan-krum", attack="none")
    out["f0"] = run(f0, 4, 2)
    out["f0_mesh"] = run(f0, 4, 2, on_mesh=True)
    attacked = DistByzantineSpec(f=1, gar="bulyan-krum",
                                 attack="omniscient_linf")
    out["attacked"] = run(attacked, 8, 2)
    subs, p, s = [], params, opt.init(params)
    step = jax.jit(make_train_step(cfg, attacked, opt))
    for t in range(2):
        b = batch(8, t)
        subs.append(to_np(submissions(p, b["tokens"], b["labels"])))
        p, s, _ = step(p, s, b)
    out["attacked_sub"] = subs
    out["reputation"] = run(DistByzantineSpec(
        f=1, gar="reputation-krum", attack="omniscient_linf", rep_lr=0.5,
        aux_batch=tuple(inp["aux"])), 8, 2)
    out["async"] = run(DistByzantineSpec(
        f=1, gar="stale-bulyan-krum", attack="omniscient_linf",
        async_tau=2), 8, 2, asynchronous=True)
"""),
}
_REF_TAIL = """pickle.dump(out, open(sys.argv[2], "wb"))\n"""


def _tree(n=8, seed=3):
    """The distance-backend tree (the reference test's shapes), from
    numpy."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal((n,) + s).astype(np.float32)
    return {"a": {"w": g(8, 16)}, "b": g(64), "c": g(2, 3, 4), "v": g(5)}


def make_inputs() -> dict:
    """The worlds' numpy inputs: the distance-backend tree, reduced
    llama3.2-3b's weights from the reference, the worker batches and the
    clean batch."""
    cfg = jget_reduced(cases.ARCH)
    params = jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(1), cfg))
    batches = {(n, t): cases.lm_batch(cfg.vocab_size, n, t)
               for n in (4, 8) for t in range(2)}
    aux = cases.lm_batches(cfg.vocab_size, 2, 16, 999, seed=7)
    return {"tree": _tree(), "params": params, "batches": batches,
            "aux": aux}


def start_reference(part: str, inputs: dict, d) -> tuple:
    """The reference's ``part`` in a subprocess on 4 host devices:
    ``(process, output path)``."""
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    script = _REF_HEAD + _REF_PARTS[part] + _REF_TAIL
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(d / "in.pkl"),
         str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, d / "out.pkl"


def finish_reference(proc, path) -> dict:
    """The reference's results, once its process has ended well."""
    try:
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _whole(tree_np):
    return params_from_jax(tree_np, "cpu")


def _leaves_np(tree):
    """A tree's leaves (tensors or numpy arrays) as numpy, in tree
    order."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_leaves(tree)]


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


class _FakeMesh:
    """What ``mesh_axis_sizes`` reads."""

    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


def _port_single(world, name):
    """The single-device port on the same case (its submissions too for
    the attacked one)."""
    kind, n, steps, kw = cases.TRAIN_CASES[name]
    kw = dict(kw)
    if name == "reputation":
        kw["aux_batch"] = world["inputs"]["aux"]
    cfg = get_reduced(cases.ARCH)
    params = params_from_jax(world["inputs"]["params"], "cpu")
    opt = get_optimizer("momentum", cases.LR)
    spec = AggSpec(distance_backend="pallas", **kw)
    state = opt.init(params)
    rows = []
    if kind == "async":
        step = make_async_train_step(cfg, spec, opt)
        agg = init_async_state(spec, params, n)
    else:
        step = make_train_step(cfg, spec, opt)
        agg = init_agg_state(spec, params, n)
    for t in range(steps):
        batch = world["inputs"]["batches"][(n, t)]
        sub = None
        if name == "attacked":
            sub = byzantine_grads(make_loss_fn(cfg), spec, params, batch,
                                  state["step"])[1]
        if agg is None:
            params, state, m = step(params, state, batch)
        else:
            params, state, m, agg = step(params, state, batch, agg)
        rows.append({"params": params, "metrics": {
            k: float(v) for k, v in m.items()}, "sub": sub})
        if kind == "async":
            rows[-1]["bus"] = agg.bus.grads
            rows[-1]["versions"] = agg.bus.versions.clone()
    return rows


def single_runs(world):
    """``get(name)``: :func:`_port_single` of a case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _port_single(world, name)
        return cache[name]

    return get


def _ties(world, single):
    """Bulyan window ties over the attacked case's two steps: on the
    port's or the reference's submissions, or chosen differently."""
    ties = None
    for t in range(2):
        tie = window_ties(tree_leaves(single("attacked")[t]["sub"]),
                          jax.tree_util.tree_leaves(
                              world["ref"]["attacked_sub"][t]), F)
        ties = tie if ties is None else [a | b for a, b in zip(ties, tie)]
    return [m.numpy() for m in ties]


def _stale_ties(a_rows, b_rows):
    """Bulyan window ties of ``stale-bulyan-krum`` over two runs' steps:
    each step's bus scaled by its staleness weights (``1 / (1 + s)`` over
    the freshest, the rule's default), as the base rule sees it."""
    ties = None
    for t, (a, b) in enumerate(zip(a_rows, b_rows)):
        stacks = []
        for row in (a, b):
            s = np.maximum(t - np.asarray(row["versions"]), 0)
            w = 1.0 / (1.0 + s.astype(np.float32))
            w = (w / w.max()).astype(np.float32)
            stacks.append([x * w.reshape((-1,) + (1,) * (x.ndim - 1))
                           for x in _leaves_np(row["bus"])])
        tie = window_ties(stacks[0], stacks[1], F)
        ties = tie if ties is None else [x | y for x, y in zip(ties, tie)]
    return [m.numpy() for m in ties]


def _hold_params(got_rows, want_rows, init, ties=None, what=""):
    for t, (g, w) in enumerate(zip(got_rows, want_rows)):
        gl = _leaves_np(g["params"])
        wl = _leaves_np(w["params"])
        assert len(gl) == len(wl)
        for i, (a, b, p0) in enumerate(zip(gl, wl, init)):
            close_change(a, b, p0, t + 1, None if ties is None else ties[i],
                         what=(what, t, i))


def _init(world):
    return [np.asarray(x, dtype=np.float64)
            for x in jax.tree_util.tree_leaves(world["inputs"]["params"])]



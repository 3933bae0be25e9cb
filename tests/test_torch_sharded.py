"""The port's multi-rank runtime (``mesh=``) against the single-device port
and the reference, on the CPU.

The port's ranks are gloo processes over a ``FileStore`` (spawned by
``repro_torch.dist.mesh.run_on_mesh``, one thread each); three worlds
run every case:

* a ``(2, 2)`` mesh over the distance-backend tree of
  ``tests/test_distance_backend.py`` (``a/w (8, 8, 16)``, ``b (8, 64)``,
  ``c (8, 2, 3, 4)`` and the indivisible ``v (8, 5)``, which stays whole
  on every rank): ``pairwise_sq_dists_tree`` under every backend,
  ``distributed_aggregate`` for eight rules and four stateful ones over
  three calls, and the attacks on the slices;
* a ``(2, 2)`` mesh over the train steps of reduced llama3.2-3b with
  momentum SGD: ``f = 0`` ``bulyan-krum`` with n = 4 (the reference's
  ``tests/test_dist.py`` setting), ``bulyan-krum`` under
  ``omniscient_linf`` with n = 8, f = 1, ``reputation-krum`` with a clean
  ``aux_batch``, and the asynchronous step at tau = 2 (``stale-``) and
  tau = 0;
* a ``(3, 1)`` mesh, whose data axis does not divide the 8 workers (the
  reference's replicate rule), under the ``pallas`` and ``fused``
  backends.

The reference runs in a subprocess with 4 host devices (its mesh
``make_host_mesh((2, 2))``), beside the port's worlds: its shard-mapped
Pallas distance pass (interpret mode) and aggregates on the same tree,
its single-device and sharded ``f = 0`` steps, and its single-device
attacked, reputation and asynchronous steps.

Tolerances: distances and aggregates at 1e-4 (the reference's own for
its shard-mapped pass); the ``f = 0`` step within the reference's own
sharded-step bounds (5e-2 on parameters, 1e-3 on the loss) and within
the port's LLM rule (``tests/torch_llm_compare.py``: each leaf's change
at 1e-4 of its largest, Bulyan window ties let off); the sharded port
against the single-device port at the same rule; the tau = 0
asynchronous step equal to the synchronous one bit for bit.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_shard_cases as cases  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.dist import robust as jrobust  # noqa: E402
from repro.models import init_model as jinit_model  # noqa: E402
from repro_torch.agg.specs import AggSpec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.dist import robust  # noqa: E402
from repro_torch.dist.async_train import (init_async_state,  # noqa: E402
                                          make_async_train_step)
from repro_torch.dist.mesh import run_on_mesh  # noqa: E402
from repro_torch.dist.train import (byzantine_grads,  # noqa: E402
                                    init_agg_state, make_loss_fn,
                                    make_train_step)
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from torch_llm_compare import (close_change, scaled_close,  # noqa: E402
                               window_ties)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 1
TOL = 1e-4

_REF_SCRIPT = textwrap.dedent("""
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

    tree = jax.tree_util.tree_map(jnp.asarray, inp["tree"])
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), tree)
    with mesh:
        out["dists"] = np.asarray(jax.jit(lambda t: robust.pairwise_sq_dists_tree(
            t, distance_backend="pallas", mesh=mesh, interpret=True))(sharded))
        for gar in ("krum", "bulyan-krum"):
            agg, res = jax.jit(lambda t: robust.distributed_aggregate(
                t, 1, gar, distance_backend="pallas", mesh=mesh))(sharded)
            out[("agg", gar)] = (to_np(agg), np.asarray(res.selected))

    cfg = get_reduced("llama3_2_3b")
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
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _tree(n=8, seed=3):
    """The distance-backend tree (the reference test's shapes), from
    numpy."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal((n,) + s).astype(np.float32)
    return {"a": {"w": g(8, 16)}, "b": g(64), "c": g(2, 3, 4), "v": g(5)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every world's results and the reference's, computed once."""
    d = tmp_path_factory.mktemp("sharded")
    cfg = jget_reduced(cases.ARCH)
    params = jax.tree_util.tree_map(
        np.asarray, jinit_model(jax.random.PRNGKey(1), cfg))
    batches = {(n, t): cases.lm_batch(cfg.vocab_size, n, t)
               for n in (4, 8) for t in range(2)}
    aux = cases.lm_batches(cfg.vocab_size, 2, 16, 999, seed=7)
    inputs = {"tree": _tree(), "params": params, "batches": batches,
              "aux": aux}
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(d / "in.pkl"),
         str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        engine = run_on_mesh(cases.engine_case, (2, 2),
                             args=(inputs["tree"], F), device="cpu",
                             num_threads=1, timeout=300)
        train = run_on_mesh(cases.train_case, (2, 2),
                            args=(params, aux, tuple(cases.TRAIN_CASES)),
                            device="cpu", num_threads=1, timeout=300)
        replicate = run_on_mesh(cases.replicated_rule_case, (3, 1),
                                args=(params,), device="cpu",
                                num_threads=1, timeout=300)
        _, err = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(d / "out.pkl", "rb") as fh:
        jout = pickle.load(fh)
    return {"engine": engine, "train": train, "replicate": replicate,
            "ref": jout, "inputs": inputs}


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


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_every_rank_sees_its_own_coordinates(world):
    coords = [r["coords"] for r in world["engine"]]
    assert coords == [{"data": i, "model": j} for i in (0, 1)
                      for j in (0, 1)]


@pytest.mark.parametrize("backend", ["xla", "pallas", "auto", "fused"])
def test_sharded_dists_match(world, backend):
    tree = _whole(world["inputs"]["tree"])
    want = robust.pairwise_sq_dists_tree(tree, distance_backend="xla")
    ref = world["ref"]["dists"]
    for r in world["engine"]:
        got = r["dists"][backend]
        assert torch.equal(got, world["engine"][0]["dists"][backend])
        assert float((got - want).abs().max()) < 1e-4
        assert float(np.max(np.abs(got.numpy() - ref))) < 1e-4
    # on CPU tensors "auto" is the xla pass; "fused" degrades to pallas
    r0 = world["engine"][0]
    assert (r0["resolved_auto"], r0["resolved_fused"]) == ("xla", "pallas")
    assert robust.resolve_distance_backend(
        "auto", _FakeMesh((1, 2)), "cuda") == "pallas"
    assert robust.resolve_distance_backend(
        "auto", _FakeMesh((4, 1)), "cuda") == "xla"
    assert robust.resolve_distance_backend("fused", _FakeMesh((4, 1))) == (
        "fused")


class _FakeMesh:
    """What ``mesh_axis_sizes`` reads."""

    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("gar", cases.ENGINE_RULES)
def test_sharded_aggregate_matches(world, gar, backend):
    tree = _whole(world["inputs"]["tree"])
    want, wres = robust.distributed_aggregate(tree, F, gar,
                                              distance_backend=backend)
    for r in world["engine"]:
        got, sel = r["agg"][(gar, backend)]
        assert torch.equal(sel, wres.selected)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) < 1e-4
    if ("agg", gar) in world["ref"]:
        jagg, jsel = world["ref"][("agg", gar)]
        got, sel = world["engine"][0]["agg"][(gar, backend)]
        np.testing.assert_array_equal(sel.numpy(), jsel)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(jagg)):
            assert float(np.max(np.abs(a.numpy() - b))) < 1e-4


@pytest.mark.parametrize("gar", cases.STATEFUL_RULES)
def test_sharded_stateful_rules_match(world, gar):
    tree = _whole(world["inputs"]["tree"])
    state = None
    for t in range(3):
        step_tree = {k: (v * (1.0 + 0.25 * t) if not isinstance(v, dict)
                         else {kk: vv * (1.0 + 0.25 * t)
                               for kk, vv in v.items()})
                     for k, v in tree.items()}
        want, wres, state = robust.distributed_aggregate(
            step_tree, F, gar, distance_backend="pallas", state=state)
        for r in world["engine"]:
            got, sel = r["stateful"][gar][t]
            assert torch.equal(sel, wres.selected), (gar, t)
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                _close(a, b, what=(gar, t))


@pytest.mark.parametrize("i", range(len(cases.ATTACKS)))
def test_sharded_attacks_match(world, i):
    attack, kw = cases.ATTACKS[i]
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, attack, **kw)
    jwant = jrobust.inject_byzantine(
        jax.tree_util.tree_map(np.asarray, world["inputs"]["tree"]), F,
        attack, **kw)
    for r in world["engine"]:
        got = r["attack"][i]
        for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                           jax.tree_util.tree_leaves(jwant)):
            _close(a, b, what=(attack, kw))
            _close(a, np.asarray(c), what=(attack, kw, "reference"))


def test_random_attack_draws_per_leaf_and_slice(world):
    """Each leaf's draw and each rank's slice of it are the single-device
    port's from the same generator, bit for bit (the reference's
    ``jax.random`` stream differs); the honest rows stay untouched."""
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, "random",
                                   torch.Generator().manual_seed(5))
    for r in world["engine"]:
        for a, b in zip(tree_leaves(r["random"]), tree_leaves(want)):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(want), tree_leaves(tree)):
        assert torch.equal(a[:-F], b[:-F]) and not torch.equal(a[-F:],
                                                               b[-F:])


def test_colluding_random_direction_matches_the_single_device_port(world):
    """``colluding_majority``'s random direction: the same draw, and its
    norm over the whole tree, as on one device (the rows differ only by
    the order of delta_bar's reduction over the ranks)."""
    tree = _whole(world["inputs"]["tree"])
    want = robust.inject_byzantine(tree, F, "colluding_majority",
                                   torch.Generator().manual_seed(6))
    for r in world["engine"]:
        for a, b in zip(tree_leaves(r["colluding_random"]),
                        tree_leaves(want)):
            assert torch.equal(a[:-F], b[:-F])
            _close(a, b, what="colluding_majority")


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def single(world):
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


def test_f0_step_matches_the_reference(world):
    """The reference's own sharded-step setting: its single-device and
    sharded steps, within its bounds and within the port's rule."""
    ref, ref_mesh = world["ref"]["f0"], world["ref"]["f0_mesh"]
    port = world["train"][0]["f0"]
    for want in (ref, ref_mesh):
        last = _leaves_np(port[-1]["params"])
        diff = max(float(np.max(np.abs(a - b))) for a, b in
                   zip(last, _leaves_np(want[-1]["params"])))
        assert diff < 5e-2
        assert abs(port[-1]["metrics"]["loss"]
                   - want[-1]["metrics"]["loss"]) < 1e-3
        _hold_params(port, want, _init(world), what="f0")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))


def test_f0_step_matches_the_single_device_port(world, single):
    _hold_params(world["train"][0]["f0"], single("f0"), _init(world))


def test_every_rank_ends_with_the_same_parameters(world):
    for name in cases.TRAIN_CASES:
        for r in world["train"][1:]:
            for a, b in zip(r[name], world["train"][0][name]):
                for x, y in zip(tree_leaves(a["params"]),
                                tree_leaves(b["params"])):
                    assert torch.equal(x, y), name
                assert a["metrics"]["byz_weight"] == b["metrics"][
                    "byz_weight"]


def test_attacked_step_matches_the_reference(world, single):
    ties = _ties(world, single)
    tied = sum(int(m.sum()) for m in ties)
    assert tied <= 1e-4 * sum(m.size for m in ties), tied
    port = world["train"][0]["attacked"]
    ref = world["ref"]["attacked"]
    _hold_params(port, ref, _init(world), ties, what="attacked")
    for t in range(2):
        for i, (a, b) in enumerate(zip(
                _leaves_np(port[t]["m"]),
                jax.tree_util.tree_leaves(ref[t]["m"]))):
            scaled_close(a, np.asarray(b), ties[i], what=(t, "m", i))
        for k, v in ref[t]["metrics"].items():
            _close(port[t]["metrics"][k], v, what=(t, k))
        assert port[t]["metrics"]["byz_weight"] == ref[t]["metrics"][
            "byz_weight"]


def test_attacked_submissions_match_the_single_device_port(world, single):
    """The sharded submissions (each rank's slices, gathered) against the
    single-device port's at 1e-4 of each leaf's largest entry."""
    for t in range(2):
        got = world["train"][0]["attacked"][t]["sub"]
        for a, b in zip(tree_leaves(got),
                        tree_leaves(single("attacked")[t]["sub"])):
            scaled_close(a, b, what=t)


def test_attacked_step_matches_the_single_device_port(world, single):
    _hold_params(world["train"][0]["attacked"], single("attacked"),
                 _init(world), _ties(world, single))


def test_reputation_step_matches_the_reference(world, single):
    port = world["train"][0]["reputation"]
    for want in (world["ref"]["reputation"], single("reputation")):
        _hold_params(port, want, _init(world), what="reputation")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))


def test_async_step_matches_the_reference(world, single):
    """tau = 2 with ``stale-bulyan-krum``: the sharded step against the
    reference's and the single-device port's."""
    port = world["train"][0]["async"]
    for want in (world["ref"]["async"], single("async")):
        ties = _stale_ties(port, want)
        assert sum(int(m.sum()) for m in ties) <= 1e-4 * sum(
            m.size for m in ties)
        _hold_params(port, want, _init(world), ties, what="async")
        for t in range(2):
            for k, v in want[t]["metrics"].items():
                _close(port[t]["metrics"][k], v, what=(t, k))
    assert port[1]["metrics"]["delivered"] < 8


def test_single_device_async_matches_the_reference(world, single):
    want = world["ref"]["async"]
    _hold_params(single("async"), want, _init(world),
                 _stale_ties(single("async"), want), what="async single")
    for a, b in zip(single("async"), want):
        np.testing.assert_array_equal(a["versions"].numpy(), b["versions"])


def test_async_tau0_is_the_sync_step_bit_for_bit(world, single):
    for rows in (world["train"][0], {"async0": single("async0"),
                                     "attacked": single("attacked")}):
        for a, b in zip(rows["async0"], rows["attacked"]):
            for x, y in zip(tree_leaves(a["params"]),
                            tree_leaves(b["params"])):
                assert torch.equal(x, y)
            for k in ("loss", "grad_norm", "agg_dev", "byz_weight"):
                assert a["metrics"][k] == b["metrics"][k]


def test_replicate_rule_and_fused_on_a_data_only_mesh(world, single):
    """Data axis 3 against 8 workers: every rank computes every worker;
    with no model axis ``fused`` stays fused.  Both equal the
    single-device step."""
    want = single("attacked")[0]
    for r in world["replicate"]:
        for backend in ("pallas", "fused"):
            got, m = r[backend]
            for a, b in zip(tree_leaves(got), tree_leaves(want["params"])):
                assert float((a - b).abs().max()) <= 1e-6 * max(
                    1.0, float(b.abs().max())), backend
            assert m["byz_weight"] == want["metrics"]["byz_weight"]
    # no model axis: the only collectives are the parameter gathers (none)
    assert world["replicate"][0]["comm_calls"] == 0

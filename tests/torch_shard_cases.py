"""Rank functions of the sharded-runtime tests (``tests/test_torch_sharded.py``
and ``tests/test_torch_sharding.py``).

Each runs on every rank of a ``repro_torch.dist.mesh.run_on_mesh`` world
(so it lives in an importable module, and imports the port only), takes
numpy inputs, drives the port's ``mesh=`` paths and returns whole
tensors on the CPU (gathered from the ranks' slices) for the test
process to hold against the single-device port and the reference.
"""
import numpy as np
import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_map
from repro_torch.data.synthetic import lm_batches
from repro_torch.dist import robust
from repro_torch.dist.async_train import (init_async_state,
                                          make_async_train_step)
from repro_torch.dist.sharding import (gather_tree, gram_shardings,
                                       param_shardings, per_worker_specs,
                                       shard_tree)
from repro_torch.dist.train import (byzantine_grads, init_agg_state,
                                    make_loss_fn, make_train_step)
from repro_torch.interop import params_from_jax
from repro_torch.optim import get_optimizer

#: the LLM cases: reduced llama3.2-3b, momentum SGD (the reference's own
#: sharded-step test), sequences of 16 tokens, 2 per worker
ARCH = "llama3_2_3b"
LR = 1e-2
SEQ, PER_WORKER = 16, 2


def lm_batch(vocab: int, n: int, step: int) -> dict:
    """Worker batch ``(n, PER_WORKER, SEQ)`` of one step."""
    toks, labs = zip(*(lm_batches(vocab, PER_WORKER, SEQ, step * n + w,
                                  seed=7) for w in range(n)))
    return {"tokens": np.stack(toks), "labels": np.stack(labs)}


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def _stack_specs(tree, mesh):
    """``gram_pspec`` of a worker-stacked tree (shapes ``(n, *dims)``)."""
    return gram_shardings(tree_map(lambda x: x[0], tree), mesh)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# the engine on the distance-backend tree
# ---------------------------------------------------------------------------

#: rules of the engine case, each over several calls with its state
ENGINE_RULES = ("krum", "bulyan-krum", "multikrum", "geomed", "cwmed",
                "average", "centered_clip", "brute")
STATEFUL_RULES = ("buffered-krum", "centered_clip_momentum",
                  "reputation-bulyan-krum", "stale-krum")
#: attacks of the engine case: (name, keyword arguments)
ATTACKS = (("omniscient_linf", {}), ("omniscient_linf",
                                     {"direction": "anti"}),
           ("omniscient_lp", {"coord": "top"}),
           ("omniscient_lp", {"coord": "rotate", "step": 37}),
           ("omniscient_lp", {"coord": 200}),
           ("colluding_majority", {"direction": "anti"}),
           ("alie", {}), ("signflip", {}), ("slow_drift", {}))


def engine_case(mesh, tree_np: dict, f: int) -> dict:
    """Sharded distances, aggregates, stateful rules and attacks on one
    gradient tree, gathered whole."""
    torch.set_num_threads(1)
    tree = params_from_jax(tree_np, "cpu")
    specs = _stack_specs(tree, mesh)
    local = shard_tree(tree, specs, mesh)
    agg_specs = per_worker_specs(specs)
    out = {"dists": {}, "agg": {}, "stateful": {}, "attack": {}}
    for backend in ("xla", "pallas", "auto", "fused"):
        out["dists"][backend] = robust.pairwise_sq_dists_tree(
            local, distance_backend=backend, mesh=mesh, specs=specs)
        out["resolved_" + backend] = robust.resolve_distance_backend(
            backend, mesh, "cpu")
    for gar in ENGINE_RULES:
        for backend in ("xla", "pallas"):
            agg, res = robust.distributed_aggregate(
                local, f, gar, distance_backend=backend, mesh=mesh,
                specs=specs)
            out["agg"][(gar, backend)] = (
                _cpu(gather_tree(agg, agg_specs, mesh)),
                res.selected.clone())
    for gar in STATEFUL_RULES:
        state, rows = None, []
        for t in range(3):
            step_tree = tree_map(lambda x: x * (1.0 + 0.25 * t), local)
            agg, res, state = robust.distributed_aggregate(
                step_tree, f, gar, distance_backend="pallas", mesh=mesh,
                specs=specs, state=state)
            rows.append((_cpu(gather_tree(agg, agg_specs, mesh)),
                         res.selected.clone()))
        out["stateful"][gar] = rows
    for i, (attack, kw) in enumerate(ATTACKS):
        got = robust.inject_byzantine(local, f, attack, mesh=mesh,
                                      specs=specs, **kw)
        out["attack"][i] = _cpu(gather_tree(got, specs, mesh))
    # the random draws, from one generator as on one device
    out["random"] = _cpu(gather_tree(robust.inject_byzantine(
        local, f, "random", torch.Generator().manual_seed(5), mesh=mesh,
        specs=specs), specs, mesh))
    out["colluding_random"] = _cpu(gather_tree(robust.inject_byzantine(
        local, f, "colluding_majority", torch.Generator().manual_seed(6),
        mesh=mesh, specs=specs), specs, mesh))
    out["coords"] = dict(mesh.coords)
    return out


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def _sharded_model(mesh, params_np):
    params = params_from_jax(params_np, "cpu")
    template = tree_map(lambda p: p.to("meta"), params)
    specs = param_shardings(params, mesh)
    local = tree_map(lambda x: x.clone(), shard_tree(params, specs, mesh))
    return params, template, specs, local


def _sync_run(mesh, params_np, n, steps, observe=False, **spec_kw):
    """``steps`` sharded steps: whole parameters and momentum after each,
    the metrics, and (``observe``) each step's submissions gathered
    whole (taken before the step from the same parameters)."""
    cfg = get_reduced(ARCH)
    params, template, specs, local = _sharded_model(mesh, params_np)
    opt = get_optimizer("momentum", LR)
    spec = AggSpec(distance_backend="pallas", **spec_kw)
    step = make_train_step(cfg, spec, opt, mesh=mesh, template=template)
    agg_state = init_agg_state(spec, template, n, mesh=mesh)
    state = opt.init(local)
    rows = []
    for t in range(steps):
        batch = lm_batch(cfg.vocab_size, n, t)
        sub = None
        if observe:
            _, g = byzantine_grads(make_loss_fn(cfg), spec, local, batch,
                                   state["step"], mesh=mesh,
                                   template=template)
            sub = _cpu(gather_tree(g, gram_shardings(template, mesh), mesh))
        if agg_state is None:
            local, state, m = step(local, state, batch)
        else:
            local, state, m, agg_state = step(local, state, batch, agg_state)
        rows.append({"params": _cpu(gather_tree(local, specs, mesh)),
                     "m": _cpu(gather_tree(state["m"], specs, mesh)),
                     "metrics": _metrics(m), "sub": sub})
    return rows


def _async_run(mesh, params_np, n, steps, **spec_kw):
    cfg = get_reduced(ARCH)
    params, template, specs, local = _sharded_model(mesh, params_np)
    opt = get_optimizer("momentum", LR)
    spec = AggSpec(distance_backend="pallas", **spec_kw)
    step = make_async_train_step(cfg, spec, opt, mesh=mesh,
                                 template=template)
    agg_state = init_async_state(spec, template, n, mesh=mesh)
    state = opt.init(local)
    rows = []
    for t in range(steps):
        local, state, m, agg_state = step(
            local, state, lm_batch(cfg.vocab_size, n, t), agg_state)
        rows.append({"params": _cpu(gather_tree(local, specs, mesh)),
                     "metrics": _metrics(m),
                     "bus": _cpu(gather_tree(agg_state.bus.grads,
                                             gram_shardings(template, mesh),
                                             mesh)),
                     "versions": agg_state.bus.versions.clone()})
    return rows


#: the train cases of one world: name -> (run kind, n, steps, spec)
TRAIN_CASES = {
    "f0": ("sync", 4, 2, dict(f=0, gar="bulyan-krum", attack="none")),
    "attacked": ("sync", 8, 2, dict(f=1, gar="bulyan-krum",
                                    attack="omniscient_linf")),
    "reputation": ("sync", 8, 2, dict(f=1, gar="reputation-krum",
                                      attack="omniscient_linf",
                                      rep_lr=0.5)),
    "async": ("async", 8, 2, dict(f=1, gar="stale-bulyan-krum",
                                  attack="omniscient_linf", async_tau=2)),
    "async0": ("async", 8, 2, dict(f=1, gar="bulyan-krum",
                                   attack="omniscient_linf", async_tau=0)),
}


def train_case(mesh, params_np, aux_np, names) -> dict:
    """The named :data:`TRAIN_CASES` on this mesh (results on every
    rank; the test reads rank 0's)."""
    torch.set_num_threads(1)
    out = {}
    for name in names:
        kind, n, steps, kw = TRAIN_CASES[name]
        kw = dict(kw)
        if name == "reputation":
            kw["aux_batch"] = aux_np
        if kind == "sync":
            out[name] = _sync_run(mesh, params_np, n, steps,
                                  observe=name == "attacked", **kw)
        else:
            out[name] = _async_run(mesh, params_np, n, steps, **kw)
    out["coords"] = dict(mesh.coords)
    out["comm_calls"] = mesh.comm["calls"]
    return out


def failing_rank(mesh):
    """Rank 1 fails while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    return mesh.all_reduce(torch.ones(3), "model")


def mesh_view(mesh):
    """What a rank sees of its mesh, and one of each collective."""
    torch.set_num_threads(1)
    x = torch.full((2,), float(mesh.rank))
    return {"coords": dict(mesh.coords), "shape": mesh.shape,
            "axis_names": mesh.axis_names, "backend": mesh.backend,
            "sum_model": mesh.all_reduce(x, "model"),
            "gather_data": mesh.all_gather(x[None], "data", 0),
            "bcast_model": mesh.broadcast(x, "model", 1),
            "gather_model": mesh.gather(x[None], "model", 1, dst=1),
            "comm": dict(mesh.comm)}


def replicated_rule_case(mesh, params_np) -> dict:
    """Data axis 3 against 8 workers: every rank computes all workers
    (the reference's replicate rule); one sharded and one fused step."""
    torch.set_num_threads(1)
    out = {}
    for backend in ("pallas", "fused"):
        cfg = get_reduced(ARCH)
        params, template, specs, local = _sharded_model(mesh, params_np)
        opt = get_optimizer("momentum", LR)
        spec = AggSpec(f=1, gar="bulyan-krum", attack="omniscient_linf",
                       distance_backend=backend)
        step = make_train_step(cfg, spec, opt, mesh=mesh, template=template)
        state = opt.init(local)
        local, state, m = step(local, state, lm_batch(cfg.vocab_size, 8, 0))
        out[backend] = (_cpu(gather_tree(local, specs, mesh)), _metrics(m))
    out["comm_calls"] = mesh.comm["calls"]
    return out

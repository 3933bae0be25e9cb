"""Rank functions of the sharded-serving tests
(``tests/test_torch_serve_sharded.py``).

Each runs on every rank of a ``repro_torch.dist.mesh.run_on_mesh`` world
(so it lives in an importable module and imports the port only), takes
numpy inputs, drives the port's ``mesh=`` serving paths and returns what
the test holds against the single-device port and the reference, on the
CPU: aggregates whole (the same on every rank), stateful buffers
gathered over ``model``, caches of the rank's own replicas with their
replica rows, token streams and telemetry.
"""
import numpy as np
import torch

import torch_shard_cases as shard_cases
from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.dist import robust
from repro_torch.dist import serve_robust as sr
from repro_torch.dist.serve import serve_shard
from repro_torch.dist.sharding import (P, gather_shard, gather_tree,
                                       gram_pspec, gram_shardings,
                                       logits_pspec, per_worker_specs,
                                       replica_rows, shard_tree)
from repro_torch.dist.train import init_agg_state, make_train_step
from repro_torch.interop import params_from_jax
from repro_torch.models import decode_step, prefill, verify_step
from repro_torch.models.decode import logits_split
from repro_torch.optim import get_optimizer
from repro_torch.serving import Request, ServingEngine

#: the ensemble: reduced llama3.2-3b, 8 replicas, the last sign-flipped
ARCH, N, F = "llama3_2_3b", 8, 1
SLOTS, CACHE, NEW, SPEC_K = 2, 64, 4, 4
#: ``aggregate_logits`` cases: rules, backends, calls with the state
AGG_RULES = ("krum", "multikrum", "bulyan-krum", "cwmed", "trimmed_mean",
             "buffered-bulyan-krum", "reputation-krum", "obs-bulyan-krum")
BACKENDS = ("xla", "pallas", "fused")
AGG_CALLS = 3
#: a vocabulary ``model`` does not divide: the stack whole on every rank
ODD_RULES = ("bulyan-krum", "buffered-bulyan-krum")
#: F4: the obs- rules on ROADMAP's tree, ``"a"`` split over ``model``
F4_RULES = ("obs-krum", "obs-bulyan-krum")
F4_BACKENDS = ("xla", "pallas")


def serve_spec(**kw) -> AggSpec:
    """The engine's spec: ``bulyan-krum`` over ``fused``."""
    return AggSpec(f=F, gar="bulyan-krum", distance_backend="fused", **kw)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone()
                    if isinstance(x, torch.Tensor) else x, tree)


def f4_scaled(tree, t: int):
    """Call ``t``'s tree of the carried-state cases (every leaf times
    ``1 + t / 4``)."""
    return tree_map(lambda x: x * (1.0 + 0.25 * t), tree)


def whole_state(state, spec: P, mesh):
    """A serving ``AggState`` with its ``model``-sliced buffers gathered
    (window buffers ``(W, n, B, V)``, centers ``(B, V)``), on the CPU."""
    if state is None:
        return None
    history = tuple(gather_shard(h, P(None, *spec), mesh)
                    for h in state.history) if state.history != () else ()
    center = tuple(gather_shard(c, P(*spec[1:]), mesh)
                   for c in state.center) if state.center != () else ()
    return _cpu(state._replace(history=history, center=center))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _f4(mesh, tree_np: dict) -> dict:
    """The obs- rules on the tree, ``"a"`` split over ``model``: each
    call's gathered aggregate, selection and scores, and the ring."""
    tree = params_from_jax(tree_np, "cpu")
    # "b" whole on every rank, so both kinds of leaf reach the sketch
    specs = {"a": gram_pspec(tuple(tree["a"].shape), mesh), "b": P()}
    local = shard_tree(tree, specs, mesh)
    out = {"specs": specs}
    for gar in F4_RULES:
        for backend in F4_BACKENDS:
            state, rows = None, []
            for t in range(AGG_CALLS):
                agg, res, state = robust.distributed_aggregate(
                    f4_scaled(local, t), F, gar, distance_backend=backend,
                    mesh=mesh, specs=specs, state=state)
                rows.append((_cpu(gather_tree(agg, per_worker_specs(specs),
                                              mesh)),
                             res.selected.clone(), res.scores.clone()))
            out[(gar, backend)] = (rows, _cpu(state.obs))
    return out


def _aggregates(mesh, stacks, rules=AGG_RULES, backends=BACKENDS) -> dict:
    """``aggregate_logits(mesh=)`` for every rule and backend over the
    calls' stacks, the state carried."""
    out = {}
    for gar in rules:
        spec = AggSpec(f=F, gar=gar)
        for backend in backends:
            state = sr.init_ensemble_state(spec, *stacks[0].shape,
                                           device=mesh.device, mesh=mesh)
            rows = []
            for x in stacks:
                got = sr.aggregate_logits(
                    torch.from_numpy(x), F, gar, distance_backend=backend,
                    mesh=mesh, state=state)
                if len(got) == 3:
                    state = got[2]
                rows.append((got[0].clone(), got[1].selected.clone(),
                             got[1].scores.clone()))
            out[(gar, backend)] = (rows, whole_state(
                state, logits_pspec(stacks[0].shape, mesh), mesh))
    return out


def _local_stack(fn, local, mesh, shard=None) -> torch.Tensor:
    """A step's gathered ``(n, ...)`` logits, outside the step: the
    forward ``fn(..., shard)`` under ``vmap`` over this rank's share,
    gathered over ``data`` (and over ``model`` where the logits are the
    rank's vocabulary columns)."""
    stack = torch.func.vmap(lambda *a: fn(*a, shard))(*local).to(
        torch.float32)
    if mesh is None:
        return stack
    return sr.gathered_logits(stack, N, mesh,
                              logits_split(get_reduced(ARCH), shard))


def steps_case(params, prompt, block, mesh=None) -> dict:
    """The prefill, one decode and one verify step (under ``mesh``, or on
    one device), each with the stack it aggregated (recomputed from the
    rank's share) and the caches of the rank's replicas."""
    cfg = get_reduced(ARCH)
    spec = serve_spec()
    if mesh is None:
        rows, local, shard = slice(0, N), params, None
    else:
        rows, _ = replica_rows(N, mesh)
        local = sr.ensemble_share(params, cfg, mesh, N)
        shard = serve_shard(cfg, mesh)
    kw = dict(mesh=mesh, n_replicas=N)
    tokens = torch.as_tensor(prompt[None])
    agg_p, cache, diag_p = sr.make_robust_prefill_step(
        cfg, spec, cache_len=CACHE, **kw)(local, tokens)
    stack_p = _local_stack(lambda p, s: prefill(p, cfg, tokens,
                                                cache_len=CACHE,
                                                shard=s)[0][:, -1],
                           (local,), mesh, shard)
    token = torch.argmax(agg_p, dim=-1).to(torch.int32)[:, None]
    pos = np.full((1,), len(prompt), np.int32)
    agg_d, cache_d, diag_d, _ = sr.make_robust_serve_step(
        cfg, spec, **kw)(local, cache, token, pos)
    stack_d = _local_stack(lambda p, c, s: decode_step(
        p, cfg, c, token, pos, shard=s)[0][:, 0], (local, cache), mesh,
        shard)
    blk = torch.as_tensor(block[None])
    pos_v = pos + 1
    agg_v, cache_v, diag_v, _ = sr.make_robust_verify_step(
        cfg, spec, **kw)(local, cache_d, blk, pos_v)
    stack_v = _local_stack(lambda p, c, s: verify_step(
        p, cfg, c, blk, pos_v, shard=s)[0], (local, cache_d), mesh, shard)
    return {"rows": (rows.start, rows.stop),
            "prefill": (agg_p, _cpu(cache), diag_p.selected, stack_p),
            "decode": (agg_d, _cpu(cache_d), diag_d.selected, stack_d),
            "verify": (agg_v, _cpu(cache_v), diag_v.selected, stack_v)}


class _Replay:
    """While active, every ``serve_robust.aggregate_logits`` call that
    carries a state (the engine's decode steps) is replayed on one
    device: ``aggregate_logits`` without a mesh, under the backend the
    mesh resolves, on the whole stack the call aggregated (its
    vocabulary slice gathered over ``model``) and the whole state it
    took.  ``pairs`` keeps each call's new telemetry ring and the
    replay's, on the CPU."""

    def __init__(self, mesh):
        self.mesh, self.pairs = mesh, []
        self.orig = sr.aggregate_logits

    def __enter__(self):
        sr.aggregate_logits = self._call
        return self

    def __exit__(self, *exc):
        sr.aggregate_logits = self.orig

    def _call(self, logits, f, gar, *, mesh=None, state=None,
              vocab_slice=False, **kw):
        out = self.orig(logits, f, gar, mesh=mesh, state=state,
                        vocab_slice=vocab_slice, **kw)
        if state is None:
            return out
        whole = (self.mesh.all_gather(logits, "model", logits.dim() - 1)
                 if vocab_slice else logits)
        kw["distance_backend"] = robust.resolve_distance_backend(
            kw["distance_backend"], self.mesh)
        one = self.orig(whole.cpu(), f, gar, state=whole_state(
            state, logits_pspec(tuple(whole.shape), self.mesh), self.mesh),
            **kw)
        self.pairs.append((_cpu(out[2].obs), one[2].obs))
        return out


def engine_runs(params, prompts, mesh=None) -> dict:
    """The engine per token, with ``speculative_k = 4`` (draft replica 0)
    and per token with ``telemetry=True``: streams, the telemetry
    drain and the accepted counts, the replicas the engine keeps and
    each of its parameter leaves' and its draft's element counts; under
    a mesh the telemetry run also ``"replay"``, :class:`_Replay`'s
    pairs of rings."""
    cfg = get_reduced(ARCH)
    out = {}
    for name, spec in (
            ("token", serve_spec()),
            ("spec", serve_spec(speculative_k=SPEC_K, draft_replica=0)),
            ("telemetry", serve_spec(telemetry=True))):
        eng = ServingEngine(params, cfg, n_slots=SLOTS, cache_len=CACHE,
                            ensemble=spec, mesh=mesh)
        replay = _Replay(mesh)
        reqs = [Request(rid, np.asarray(p, np.int32), NEW)
                for rid, p in enumerate(prompts)]
        if mesh is not None and spec.telemetry:
            with replay:
                streams = eng.run(reqs, max_steps=40)
        else:
            streams = eng.run(reqs, max_steps=40)
        rep = eng.telemetry()
        out[name] = {"streams": streams, "telemetry": rep,
                     "replay": replay.pairs,
                     "n_local": tree_leaves(eng.params)[0].shape[0],
                     "numels": [x.numel() for x in tree_leaves(eng.params)],
                     "draft_numels": [x.numel() for x in tree_leaves(
                         getattr(eng, "draft_params", {}))]}
    return out


def train_step(params_np, batch, mesh=None) -> dict:
    """One ``make_train_step`` step (``mesh=``, or one device),
    ``obs-bulyan-krum`` under ``omniscient_linf``: the whole parameters,
    the submissions the step aggregated, the metrics and the ring."""
    cfg = get_reduced(ARCH)
    opt = get_optimizer("momentum", shard_cases.LR)
    spec = train_spec()
    seen = {}
    if mesh is None:
        local = params_from_jax(params_np, "cpu")
        template = local

        def observe(sub, res):
            seen["sub"] = _cpu(sub)
    else:
        _, template, specs, local = shard_cases._sharded_model(mesh,
                                                               params_np)
        gspecs = gram_shardings(template, mesh)

        def observe(sub, res):
            seen["sub"] = _cpu(gather_tree(sub, gspecs, mesh))
    step = make_train_step(cfg, spec, opt, mesh=mesh, template=template,
                           observe=observe)
    agg_state = init_agg_state(spec, template, N, mesh=mesh)
    state = opt.init(local)
    local, state, m, agg_state = step(local, state, batch, agg_state)
    if mesh is not None:
        local = gather_tree(local, specs, mesh)
    return {"params": _cpu(local), "sub": seen["sub"],
            "metrics": {k: float(v) for k, v in m.items()},
            "obs": _cpu(agg_state.obs)}


def train_spec() -> AggSpec:
    """The train case's spec."""
    return AggSpec(f=F, gar="obs-bulyan-krum", attack="omniscient_linf",
                   distance_backend="pallas")


def serve_case(mesh, inputs: dict, cases) -> dict:
    """The named cases on this rank: ``"f4"``, ``"agg"``, ``"steps"``,
    ``"engine"``, ``"train"``."""
    torch.set_num_threads(1)
    out = {"coords": dict(mesh.coords)}
    params = params_from_jax(inputs["params"], "cpu")
    if "f4" in cases:
        out["f4"] = _f4(mesh, inputs["f4_tree"])
    if "agg" in cases:
        out["agg"] = _aggregates(mesh, inputs["stacks"])
        out["odd"] = _aggregates(mesh, inputs["odd_stacks"], ODD_RULES,
                                 ("fused",))
    if "steps" in cases:
        out["steps"] = steps_case(params, inputs["prompts"][0],
                                  inputs["block"], mesh)
    if "engine" in cases:
        out["engine"] = engine_runs(params, inputs["prompts"], mesh=mesh)
    if "train" in cases:
        out["train"] = train_step(inputs["train_params"],
                                  inputs["train_batch"], mesh)
    out["comm"] = dict(mesh.comm)
    return out

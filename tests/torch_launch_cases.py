"""Rank functions of the launch harness's tests
(``tests/test_torch_launch_dryrun.py``).

Each runs on every rank of a ``repro_torch.dist.mesh.run_on_mesh`` world
on the CPU and returns what the rank's collectives were, per kind
(``Mesh.comm["by_kind"]``), for the test to hold against
``repro_torch.launch.dryrun.RecordingMesh``'s prediction of the same
rank's step.  Only the step's own collectives are counted: the counters
are zeroed just before the step call and read just after it.  Also
:class:`Elsewhere`, a tensor on a device the port does not run on.
"""
import numpy as np
import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.dist import serve_robust as sr
from repro_torch.dist.async_train import (init_async_state,
                                          make_async_train_step)
from repro_torch.dist.mesh import comm_snapshot
from repro_torch.dist.sharding import param_shardings, shard_tree
from repro_torch.dist.train import make_train_step
from repro_torch.models import init_cache, init_model
from repro_torch.optim import get_optimizer

#: reduced llama3.2-3b, as the sharded-runtime tests
ARCH = "llama3_2_3b"
SEQ, PER_WORKER = 8, 1

#: the train settings held: name -> (n, spec fields, asynchronous)
TRAIN = {
    "bulyan-fused": (8, dict(f=1, gar="bulyan-krum",
                             attack="omniscient_linf",
                             distance_backend="fused"), False),
    "krum-xla": (8, dict(f=1, gar="krum", attack="omniscient_lp",
                         attack_kwargs=(("coord", "top"),),
                         distance_backend="xla"), False),
    "stale-async": (8, dict(f=1, gar="stale-bulyan-krum",
                            attack="stale_replay", async_tau=2,
                            distance_backend="pallas"), True),
}

#: the serving setting held: replicas, slots, cache positions
SERVE_N, SERVE_SLOTS, SERVE_CACHE = 8, 2, 32
SERVE_SPEC = dict(f=1, gar="bulyan-krum", distance_backend="fused")


def train_batch(vocab: int, n: int, seed: int = 0) -> dict:
    """A worker batch ``(n, PER_WORKER, SEQ)``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, PER_WORKER, SEQ), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}


def _by_kind(mesh) -> dict:
    return comm_snapshot(mesh.comm)["by_kind"]


def train_comm(mesh, names) -> dict:
    """One step of each named :data:`TRAIN` setting on this rank:
    ``{name: by_kind}`` of the step call's collectives."""
    torch.set_num_threads(1)
    cfg = get_reduced(ARCH)
    params = init_model(0, cfg, device="cpu")
    template = tree_map(lambda p: p.to("meta"), params)
    out = {"coords": dict(mesh.coords)}
    for name in names:
        n, kw, asynchronous = TRAIN[name]
        spec = AggSpec(**kw)
        opt = get_optimizer("momentum", 1e-2)
        local = tree_map(lambda x: x.clone(), shard_tree(
            params, param_shardings(params, mesh), mesh))
        state = opt.init(local)
        batch = train_batch(cfg.vocab_size, n)
        if asynchronous:
            step = make_async_train_step(cfg, spec, opt, mesh=mesh,
                                         template=template)
            args = (local, state, batch,
                    init_async_state(spec, template, n, mesh=mesh))
        else:
            step = make_train_step(cfg, spec, opt, mesh=mesh,
                                   template=template)
            args = (local, state, batch)
        mesh.reset_comm()
        step(*args)
        out[name] = _by_kind(mesh)
    return out


def serve_comm(mesh) -> dict:
    """One robust decode step of a reduced llama3.2-3b ensemble of
    :data:`SERVE_N` replicas on this rank, as ``ServingEngine(mesh=)``
    calls it (the rank's share of the ensemble, per-slot numpy
    positions): ``by_kind`` of the step call's collectives."""
    torch.set_num_threads(1)
    cfg = get_reduced(ARCH)
    params = init_model(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    stacked = sr.replicate_params(params, SERVE_N, jitter=1e-3,
                                  generator=gen)
    spec = AggSpec(**SERVE_SPEC)
    step = sr.make_robust_serve_step(cfg, spec, mesh=mesh,
                                     n_replicas=SERVE_N)
    mine = sr.ensemble_share(stacked, cfg, mesh, SERVE_N)
    n_local = tree_leaves(mine)[0].shape[0]
    cache = sr.replicate_cache(init_cache(cfg, SERVE_SLOTS, SERVE_CACHE,
                                          device="cpu"), n_local)
    token = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32)
    pos = np.zeros((SERVE_SLOTS,), np.int32)
    mesh.reset_comm()
    step(mine, cache, token, pos, None)
    return {"coords": dict(mesh.coords), "decode": _by_kind(mesh)}


def train_and_serve_comm(mesh, names) -> dict:
    """:func:`train_comm` of the named settings and :func:`serve_comm`'s
    decode step, in one world."""
    out = train_comm(mesh, names)
    out.update({k: v for k, v in serve_comm(mesh).items()
                if k != "coords"})
    return out



class Elsewhere(torch.Tensor):
    """A tensor that reports a device the port does not run on
    (``xpu``), its ops run on ``meta`` underneath: what a kernel wrapper
    must refuse now that ``meta`` has a branch of its own."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(
            cls, tuple(shape), dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map as map_

        def down(x):
            return (torch.empty(x.shape, dtype=x.dtype, device="meta")
                    if isinstance(x, Elsewhere) else x)

        out = func(*map_(down, args), **map_(down, kwargs or {}))
        return map_(lambda o: Elsewhere(o.shape, o.dtype)
                    if isinstance(o, torch.Tensor) else o, out)

"""Rank functions of the tensor-parallel serving tests
(``tests/test_torch_tp_decode.py``).

Each runs on every rank of a ``repro_torch.dist.mesh.run_on_mesh`` world
on the CPU (so it lives in an importable module, and imports the port
only), takes numpy inputs, runs the serving path on the rank's
``model`` slices (``prefill`` / ``decode_step`` / ``verify_step`` with
``shard=``, and the robust ensemble steps on the rank's share) and
returns whole tensors on the CPU (logits gathered over ``model`` where
they are the rank's vocabulary columns), with the collectives of each
call, for the test process to hold against the reference.
"""
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.dist import serve_robust as sr
from repro_torch.dist.mesh import comm_snapshot
from repro_torch.dist.serve import (make_serve_step, serve_shard,
                                    serve_specs)
from repro_torch.dist.sharding import _spec_leaves, model_dim, shard_tree
from repro_torch.interop import params_from_jax
from repro_torch.models import (decode_step, init_cache, prefill,
                                verify_step, verify_supported)
from repro_torch.models.decode import logits_split
from repro_torch.serving import ServingEngine

#: the families held: a dense model (two), an MoE, a hybrid with Mamba
#: slots, an SSM and a cross-attention model
FAMILIES = ("llama3_2_3b", "gemma3_1b", "mixtral_8x22b", "jamba_1_5_large",
            "mamba2_130m", "whisper_medium")
#: slots, prompt length, decode steps, verify block, cache positions
B, S0, STEPS, K, CACHE = 2, 12, 2, 3, 24
#: the ensembles: reduced llama3.2-3b of 2 and of 8 replicas
ENS_ARCH, ENS_SIZES = "llama3_2_3b", (2, 8)
#: the attacked ensemble step: a random logits attack on 8 replicas, Krum
#: (a selection: no Bulyan window ties between the two runs' stacks)
ATTACK_SPEC = dict(f=1, gar="krum", attack="random",
                   distance_backend="pallas", seed=3)


def tp_cfg(arch: str):
    """The reduced config, no MoE drops (capacity counts the batch)."""
    return dataclasses.replace(get_reduced(arch), capacity_factor=100.0)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def _calls(mesh) -> Dict[str, Dict[str, int]]:
    return comm_snapshot(mesh.comm)["by_kind"]


def family_case(mesh, arch: str, params_np, tokens, extra, block) -> Dict:
    """Prefill ``S0`` tokens, ``STEPS`` decode steps, and a ``K``-token
    verify block from the prefilled cache where ``verify_supported``,
    each on the rank's slices with ``shard=``: whole logits and caches,
    and each decode step's collectives."""
    cfg = tp_cfg(arch)
    params = params_from_jax(params_np, "cpu")
    specs = serve_specs(cfg, mesh)
    local = shard_tree(params, specs, mesh)
    shard = serve_shard(cfg, mesh)
    split = logits_split(cfg, shard)

    def whole(lg):
        return _cpu(shard.gather(lg, -1) if split else lg)

    toks = torch.as_tensor(tokens)
    ext = None if extra is None else torch.as_tensor(extra)
    out: Dict[str, Any] = {"split": split, "decode": [], "comm": []}
    lg, cache = prefill(local, cfg, toks[:, :S0], ext, cache_len=CACHE,
                        shard=shard)
    out["prefill"] = (whole(lg), _cpu(cache))
    prefilled = cache
    for t in range(STEPS):
        pos = np.full((B,), S0 + t, np.int32)
        mesh.reset_comm()
        lg, cache = decode_step(local, cfg, cache,
                                toks[:, S0 + t:S0 + t + 1], pos, shard=shard)
        out["comm"].append(_calls(mesh))
        out["decode"].append((whole(lg), _cpu(cache)))
    if verify_supported(cfg)[0]:
        pos = np.full((B,), S0, np.int32)
        lg, cache = verify_step(local, cfg, prefilled,
                                torch.as_tensor(block), pos, shard=shard)
        out["verify"] = (whole(lg), _cpu(cache))
    # the plain decode step of dist/serve.py: the same call
    step = make_serve_step(cfg, mesh=mesh)
    pos = np.full((B,), S0, np.int32)
    lg, _ = step(local, prefilled, toks[:, S0:S0 + 1], pos)
    out["serve_step"] = whole(lg)
    return out


def _ensemble(cfg, n: int, seed: int = 0):
    from repro_torch.models import init_model
    params = init_model(seed, cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return sr.replicate_params(params, n, jitter=1e-3, generator=gen)


def share_case(mesh, n: int) -> Dict:
    """``ServingEngine(mesh=)``'s share of an ``n``-replica ensemble:
    per leaf ``(local numel, whole numel, split over model)``, and the
    share's and the whole ensemble's bytes."""
    cfg = tp_cfg(ENS_ARCH)
    stacked = _ensemble(cfg, n)
    eng = ServingEngine(stacked, cfg, n_slots=B, cache_len=CACHE,
                        ensemble=AggSpec(f=0, gar="average"), mesh=mesh)
    specs = serve_specs(cfg, mesh, n)
    rows = []
    for x, w, s in zip(tree_leaves(eng.params), tree_leaves(stacked),
                       _spec_leaves(specs)):
        rows.append((x.numel(), w.numel(), model_dim(s) is not None))
    return {"leaves": rows,
            "share_bytes": sum(x.numel() * x.element_size()
                               for x in tree_leaves(eng.params)),
            "whole_bytes": sum(x.numel() * x.element_size()
                               for x in tree_leaves(stacked)),
            "n_local": tree_leaves(eng.params)[0].shape[0]}


def ensemble_comm(mesh, n: int) -> Dict:
    """One robust decode step of an ``n``-replica ensemble (``average``)
    on the rank's share: the step call's collectives per kind."""
    cfg = tp_cfg(ENS_ARCH)
    stacked = _ensemble(cfg, n)
    share = sr.ensemble_share(stacked, cfg, mesh, n)
    n_local = tree_leaves(share)[0].shape[0]
    cache = sr.replicate_cache(init_cache(cfg, B, CACHE, device="cpu"),
                               n_local)
    step = sr.make_robust_serve_step(cfg, AggSpec(f=0, gar="average"),
                                     mesh=mesh, n_replicas=n)
    token = torch.ones((B, 1), dtype=torch.int32)
    pos = np.zeros((B,), np.int32)
    mesh.reset_comm()
    agg, _, _, _ = step(share, cache, token, pos)
    return {"by_kind": _calls(mesh), "agg": _cpu(agg)}


def attacked_step(mesh, params_np) -> Dict:
    """One robust decode step of :data:`ATTACK_SPEC` on the rank's share
    of the ensemble ``params_np`` (its logits gathered over ``model`` for
    the attack), or on one device (``mesh=None``): the aggregate and
    selection."""
    cfg = tp_cfg(ENS_ARCH)
    stacked = params_from_jax(params_np, "cpu")
    n = tree_leaves(stacked)[0].shape[0]
    share = (stacked if mesh is None
             else sr.ensemble_share(stacked, cfg, mesh, n))
    n_local = tree_leaves(share)[0].shape[0]
    cache = sr.replicate_cache(init_cache(cfg, B, CACHE, device="cpu"),
                               n_local)
    step = sr.make_robust_serve_step(cfg, AggSpec(**ATTACK_SPEC), mesh=mesh,
                                     n_replicas=n)
    token = torch.full((B, 1), 5, dtype=torch.int32)
    pos = np.array([0, 3], np.int32)
    agg, _, diag, _ = step(share, cache, token, pos)
    return {"agg": _cpu(agg), "selected": _cpu(diag.selected)}


def tp_case(mesh, inputs: Dict) -> Dict:
    """Everything a world runs on this rank: each family's
    :func:`family_case`, the shares and decode collectives of both
    ensembles, and the attacked step."""
    torch.set_num_threads(1)
    out = {"coords": dict(mesh.coords)}
    for arch in FAMILIES:
        out[arch] = family_case(mesh, arch, *inputs[arch])
    out["share"] = {n: share_case(mesh, n) for n in ENS_SIZES}
    out["ensemble"] = {n: ensemble_comm(mesh, n) for n in ENS_SIZES}
    out["attacked"] = attacked_step(mesh, inputs["attack_params"])
    return out

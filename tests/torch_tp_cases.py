"""Rank functions of the tensor-parallel tests
(``tests/test_torch_tensor_parallel*.py``).

Each runs on every rank of a ``repro_torch.dist.mesh.run_on_mesh`` world
on the CPU (so it lives in an importable module, and imports the port
only), takes numpy inputs, runs the split forward or the sharded step
and returns whole tensors on the CPU (gathered from the ranks' slices)
for the test process to hold against the plain ``shard=None`` forms,
the single-device port and the reference.
"""
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.agg.specs import AggSpec
from repro_torch.configs import get_reduced
from repro_torch.core.pytree import tree_map
from repro_torch.dist.mesh import comm_snapshot
from repro_torch.dist.sharding import (P, gather_shard, gather_tree,
                                       gram_shardings, local_shard,
                                       param_shardings, shard_tree)
from repro_torch.dist.tensor_parallel import Shard, vocab_parallel_nll
from repro_torch.dist.train import (byzantine_grads, make_loss_fn,
                                    make_train_step)
from repro_torch.interop import params_from_jax
from repro_torch.models import layers, moe, transformer
from repro_torch.optim import get_optimizer

#: the ops' shapes: every split dim divides 4, so (1, 2) and (1, 4) run
#: the same inputs
OPS = dict(b=4, s=8, d=8, f=12, v=16, e=4, c=6, hq=4, hkv=2, hd=4)
#: a batch no model axis of 2 or 4 divides: the query-split attention
ODD_B = 3


def op_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """The ops' numpy inputs and cotangents."""
    rng = np.random.default_rng(seed)
    o = OPS

    def g(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    hq, hkv, hd = o["hq"], o["hkv"], o["hd"]
    return {
        "x": g(o["b"], o["s"], o["d"]),
        "w_in": g(o["d"], o["f"], scale=0.3),
        "w_out": g(o["f"], o["d"], scale=0.3),
        "w_exp": g(o["e"], o["d"], o["f"], scale=0.3),
        "x_exp": g(o["e"], o["c"], o["d"]),
        "cot_f": g(o["b"], o["s"], o["f"]),
        "cot_d": g(o["b"], o["s"], o["d"]),
        "cot_exp": g(o["e"], o["c"], o["f"]),
        "tokens": rng.integers(0, o["v"], (o["b"], o["s"])),
        "labels": rng.integers(0, o["v"], (o["b"], o["s"])),
        "table": g(o["v"], o["d"], scale=0.5),
        "scale": (1.0 + 0.1 * rng.standard_normal(o["d"])).astype(
            np.float32),
        "q": g(o["b"], o["s"], hq, hd), "k": g(o["b"], o["s"], hkv, hd),
        "v": g(o["b"], o["s"], hkv, hd),
        "cot_o": g(o["b"], o["s"], hq, hd),
        "q3": g(ODD_B, o["s"], hq, hd), "k3": g(ODD_B, o["s"], hkv, hd),
        "v3": g(ODD_B, o["s"], hkv, hd),
        "cot_o3": g(ODD_B, o["s"], hq, hd),
        "ffn": {"wi": g(o["d"], o["f"], scale=0.3),
                "wg": g(o["d"], o["f"], scale=0.3),
                "wo": g(o["f"], o["d"], scale=0.3)},
        "moe": {"router": g(o["d"], o["e"]),
                "experts": {"wi": g(o["e"], o["d"], o["f"], scale=0.3),
                            "wg": g(o["e"], o["d"], o["f"], scale=0.3),
                            "wo": g(o["e"], o["f"], o["d"], scale=0.3)}},
        "x_moe": g(2, 6, o["d"]),
        "cot_moe": g(2, 6, o["d"]),
    }


#: the attention setting of the ops (the batch / query split reads only
#: ``attn_shard``, ``window`` and ``chunk``)
ATTN_CFG = dict(name="ops", arch_type="dense", n_layers=1,
                d_model=OPS["hq"] * OPS["hd"], n_heads=OPS["hq"],
                n_kv_heads=OPS["hkv"], d_ff=OPS["f"], vocab_size=OPS["v"],
                head_dim=OPS["hd"], attn_shard="batch")

#: the ops :func:`ops_case` runs, each on every rank
OP_NAMES = ("matmul_contraction", "matmul_output", "matmul_experts",
            "embed_vocab", "embed_features", "unembed_loss", "norm_scale",
            "relayout", "attention_batch", "attention_queries",
            "attention_swa", "ffn", "moe_expert_gather")


def _t(x, grad=False):
    t = torch.as_tensor(np.array(x))
    return t.requires_grad_() if grad else t


def _grads(out, cot, inputs):
    """``d sum(out * cot) / d inputs``."""
    return torch.autograd.grad(torch.sum(out * cot), inputs)


def plain_op(name: str, inp: Dict[str, Any]):
    """The op's plain ``shard=None`` form: ``(out, {input: grad})``."""
    return _op(name, inp, None)


def _op(name: str, inp, shard):
    """One op on this rank (``shard``: its :class:`Shard`, whose dims say
    the weights' splits) or plainly (``None``): ``(out, grads)`` with the
    weights' gradients in the rank's slices."""
    from repro_torch.models.attention import attention
    from repro_torch.models.config import ModelConfig

    def cut(x, d):
        x = _t(x)
        return x if shard is None or d is None else local_shard(
            x, P(*([None] * d + ["model"])), shard.mesh).clone()

    def sh(dims):
        return None if shard is None else Shard(shard.mesh, dims)

    x = _t(inp["x"], True)
    if name.startswith("matmul"):
        d, key, xin, cot = {
            "matmul_contraction": (0, "w_in", x, _t(inp["cot_f"])),
            "matmul_output": (1, "w_in", x, _t(inp["cot_f"])),
            "matmul_experts": (0, "w_exp", _t(inp["x_exp"], True),
                               _t(inp["cot_exp"]))}[name]
        w = cut(inp[key], d).requires_grad_()
        s = sh({"w": d})
        out = xin @ w if s is None else s.matmul(xin, {"w": w}, "w")
        gx, gw = _grads(out, cot, (xin, w))
        return out, {"x": gx, "w": gw}
    if name.startswith("embed"):
        d = 0 if name == "embed_vocab" else 1
        table = cut(inp["table"], d).requires_grad_()
        out = layers.embed({"table": table}, _t(inp["tokens"]),
                           shard=sh({"table": d}))
        (gt,) = _grads(out, _t(inp["cot_d"]), (table,))
        return out, {"table": gt}
    if name == "unembed_loss":
        table = cut(inp["table"], 0).requires_grad_()
        s = sh({"table": 0})
        logits = layers.unembed({"table": table}, x, shard=s)
        labels = _t(inp["labels"])
        if s is None:
            nll = (torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, labels[..., None])[..., 0])
        else:
            nll = vocab_parallel_nll(logits, labels, s)
        loss = torch.mean(nll)
        gx, gt = torch.autograd.grad(loss, (x, table))
        return loss, {"x": gx, "table": gt}
    if name == "norm_scale":
        scale = cut(inp["scale"], 0).requires_grad_()
        out = layers.rmsnorm({"scale": scale}, x, shard=sh({"scale": 0}))
        gx, gs = _grads(out, _t(inp["cot_d"]), (x, scale))
        return out, {"x": gx, "scale": gs}
    if name == "relayout":
        # stored split on the contraction dim, used split on the output
        w = cut(inp["w_in"], 0).requires_grad_()
        s = sh({"w": 0})
        used = w if s is None else s.relayout(w, 0, 1)
        out = (x @ used if s is None
               else s.gather(s.copy(x) @ used, -1))
        gx, gw = _grads(out, _t(inp["cot_f"]), (x, w))
        return out, {"x": gx, "w": gw}
    if name.startswith("attention"):
        odd = name == "attention_queries"
        sfx = "3" if odd else ""
        q, k, v = (_t(inp[n + sfx], True) for n in ("q", "k", "v"))
        kind = "swa" if name == "attention_swa" else "attn"
        cfg = ModelConfig(**dict(ATTN_CFG, window=3))
        if shard is None:
            out = attention(q, k, v, kind=kind, window=3)
        else:
            out = transformer._attend(q, k, v, cfg, kind, "auto", shard)
        gq, gk, gv = _grads(out, _t(inp["cot_o" + sfx]), (q, k, v))
        return out, {"q": gq, "k": gk, "v": gv}
    if name == "ffn":
        dims = {"wi": 1, "wg": 1, "wo": 0}
        p = {k: cut(w, dims[k]).requires_grad_()
             for k, w in inp["ffn"].items()}
        out = layers.ffn(p, x, "swiglu", shard=sh(dims))
        grads = _grads(out, _t(inp["cot_d"]), (x,) + tuple(
            p[k] for k in sorted(p)))
        return out, dict(zip(("x",) + tuple(sorted(p)), grads))
    if name == "moe_expert_gather":
        # experts stored split on the expert axis, used column / row
        # parallel under EXPERT_WEIGHT_GATHER
        xm = _t(inp["x_moe"], True)
        router = _t(inp["moe"]["router"]).requires_grad_()
        experts = {k: cut(w, 0).requires_grad_()
                   for k, w in inp["moe"]["experts"].items()}
        p = {"router": router, "experts": experts}
        s = sh({"router": None, "experts": {k: 0 for k in experts}})
        before = moe.EXPERT_WEIGHT_GATHER
        moe.EXPERT_WEIGHT_GATHER = True
        try:
            out, aux = moe.moe_ffn(p, xm, top_k=2, act="swiglu",
                                   capacity_factor=1.0, shard=s)
        finally:
            moe.EXPERT_WEIGHT_GATHER = before
        keys = sorted(experts)
        grads = torch.autograd.grad(
            torch.sum(out * _t(inp["cot_moe"])) + aux,
            (xm, router) + tuple(experts[k] for k in keys))
        return out, dict(zip(("x", "router") + tuple(keys), grads))
    raise KeyError(name)


#: per op, the dim each weight gradient's slices concatenate along
GRAD_DIMS = {"matmul_contraction": {"w": 0}, "matmul_output": {"w": 1},
             "matmul_experts": {"w": 0}, "embed_vocab": {"table": 0},
             "embed_features": {"table": 1}, "unembed_loss": {"table": 0},
             "norm_scale": {"scale": 0}, "relayout": {"w": 0},
             "ffn": {"wi": 1, "wg": 1, "wo": 0},
             "moe_expert_gather": {"wi": 0, "wg": 0, "wo": 0}}


def ops_case(mesh, inp) -> Dict[str, Any]:
    """Every op of :data:`OP_NAMES` on this rank: its output and input
    gradients (whole on every rank) and the weights' gradients gathered
    whole from the ranks' slices, with the collectives each op ran."""
    torch.set_num_threads(1)
    shard = Shard(mesh, {})
    out = {"coords": dict(mesh.coords)}
    for name in OP_NAMES:
        mesh.reset_comm()
        y, grads = _op(name, inp, shard)
        comm = comm_snapshot(mesh.comm)["by_kind"]
        whole = {}
        for k, g in grads.items():
            d = GRAD_DIMS.get(name, {}).get(k)
            whole[k] = (g if d is None else gather_shard(
                g, P(*([None] * d + ["model"])), mesh)).detach().clone()
        out[name] = {"out": y.detach().clone(), "grads": whole,
                     "comm": comm}
    return out


# ---------------------------------------------------------------------------
# the zoo's steps
# ---------------------------------------------------------------------------

#: the step settings: momentum SGD, sequences of 16 tokens
LR, SEQ = 1e-2, 16


def lm_batch(vocab: int, n: int, per_worker: int, step: int,
             seed: int = 11) -> Dict[str, np.ndarray]:
    """A worker batch ``(n, per_worker, SEQ)`` of one step."""
    rng = np.random.default_rng([seed, step])
    toks = rng.integers(0, vocab, (n, per_worker, SEQ), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}


def extra_of(cfg, n: int, per_worker: int, seed: int = 5):
    """The stubbed modality embeddings of an audio / vlm config, or
    ``None``."""
    if cfg.arch_type not in ("audio", "vlm"):
        return None
    rng = np.random.default_rng(seed)
    enc = cfg.encoder_seq or cfg.vision_seq
    return (0.5 * rng.standard_normal((n, per_worker, enc, cfg.d_model))
            ).astype(np.float32)


def step_cfg(arch: str, attn_shard: str = "batch"):
    """A reduced config with the attention split of the full one."""
    return dataclasses.replace(get_reduced(arch), attn_shard=attn_shard)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def sharded_steps(mesh, arch: str, params_np, batches, spec_kw,
                  attn_shard: str = "batch") -> Dict[str, Any]:
    """``len(batches)`` sharded steps of one reduced config from the
    reference's weights: per step the submissions (gathered whole), the
    parameters after it (whole) and the metrics, and the step's
    collectives."""
    cfg = step_cfg(arch, attn_shard)
    params = params_from_jax(params_np, "cpu")
    template = tree_map(lambda p: p.to("meta"), params)
    specs = param_shardings(params, mesh)
    gspecs = gram_shardings(params, mesh)
    local = tree_map(lambda x: x.clone(), shard_tree(params, specs, mesh))
    opt = get_optimizer("momentum", LR)
    spec = AggSpec(distance_backend="pallas", **spec_kw)
    subs = []
    # the slices are gathered after the step, out of its counted calls
    step = make_train_step(cfg, spec, opt, mesh=mesh, template=template,
                           observe=lambda sub, res: subs.append(_cpu(sub)))
    state = opt.init(local)
    rows = []
    for batch in batches:
        mesh.reset_comm()
        local, state, m = step(local, state, batch)
        comm = comm_snapshot(mesh.comm)["by_kind"]
        rows.append({"params": _cpu(gather_tree(local, specs, mesh)),
                     "sub": _cpu(gather_tree(subs[-1], gspecs, mesh)),
                     "metrics": {k: float(v) for k, v in m.items()},
                     "comm": comm})
    return {"coords": dict(mesh.coords), "rows": rows}


def zoo_case(mesh, settings) -> Dict[str, Any]:
    """:func:`sharded_steps` for each ``(name, arch, params_np, batches,
    spec_kw)`` of ``settings``."""
    torch.set_num_threads(1)
    out = {"coords": dict(mesh.coords)}
    for name, arch, params_np, batches, spec_kw in settings:
        out[name] = sharded_steps(mesh, arch, params_np, batches, spec_kw)
    return out


def pod_case(mesh, arch: str, params_np, batches, spec_kw) -> Dict:
    """:func:`sharded_steps` on a mesh with a ``pod`` axis, and one
    worker's submissions through ``byzantine_grads``."""
    torch.set_num_threads(1)
    out = sharded_steps(mesh, arch, params_np, batches, spec_kw)
    cfg = step_cfg(arch)
    params = params_from_jax(params_np, "cpu")
    template = tree_map(lambda p: p.to("meta"), params)
    local = tree_map(lambda x: x.clone(), shard_tree(
        params, param_shardings(params, mesh), mesh))
    mesh.reset_comm()
    losses, sub = byzantine_grads(make_loss_fn(cfg), AggSpec(**spec_kw),
                                  local, batches[0], 0, mesh=mesh,
                                  template=template)
    out["losses"] = losses.clone()
    out["pod_comm"] = comm_snapshot(mesh.comm)["by_kind"]
    out["sub"] = _cpu(gather_tree(sub, gram_shardings(template, mesh),
                                  mesh))
    return out

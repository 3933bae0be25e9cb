"""Mixture-of-Experts FFN with capacity-based (GShard / Switch-style)
dispatch (counterpart of ``repro/models/moe.py``).

Tokens are routed to per-expert capacity buffers, the experts run as one
batched matmul over a leading expert axis, and the results are combined
with the gate weights.  Tokens overflowing an expert's capacity are
dropped (their FFN output is zero; the residual carries them), as in
Switch Transformer.  Two dispatch forms with identical routing:
``impl="einsum"`` (dense one-hot ``(T, E, C)`` dispatch / combine) and
``impl="scatter"`` (scatter-add into the ``(E, C, D)`` buffers, gather
back).  Both return the Switch load-balance auxiliary loss.

Routing follows the reference exactly: top-k ties go to the lower
expert index (``lax.top_k``'s rule, here a stable descending sort,
since ``torch.topk`` promises no order among ties), and an expert's
positions count tokens in token order, slot by slot.

Under a ``shard`` (``repro_torch.dist.tensor_parallel.Shard``, the
multi-rank train step) routing runs on the same tokens on every
``model`` rank with the router gathered on use, so capacity and drops
are the one-device step's; the experts run on this rank's slices
(``layers.ffn``).  :data:`EXPERT_WEIGHT_GATHER` is the reference's
process-wide toggle: when set, expert ``wi`` / ``wg`` are taken
column-parallel and ``wo`` row-parallel at their use, whatever dims
their storage splits (re-laid out there), as the reference's sharding
constraint pins them.

:func:`grouped_moe_ffn` is the dropless layer of a held share
(``cfg.moe_impl == "grouped"``, DeepSeek-V2's routed experts), which the
JAX package does not have: routing over every expert, the held experts'
tokens multiplied in a grouped GEMM, no capacity.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_gemm import COUNTER_EXPERTS, grouped_mm
from repro_torch.models import layers
from repro_torch.obs.trace import named_span

__all__ = ["EXPERT_WEIGHT_GATHER", "grouped_moe_ffn", "grouped_route",
           "init_grouped_moe", "init_moe", "moe_ffn"]

#: process-wide toggle (set by the launcher, read at call time): under a
#: shard, expert weights are re-laid out to tensor-parallel-only specs at
#: their use (``wi`` / ``wg`` column-parallel, ``wo`` row-parallel)
EXPERT_WEIGHT_GATHER: bool = False


def _gathered_experts(experts: dict, shard):
    """``(experts, shard)`` as the expert FFN takes them: with
    :data:`EXPERT_WEIGHT_GATHER` under a shard whose ``model`` axis
    divides the hidden width, each weight re-laid out to the
    column / row-parallel spec."""
    if shard is None or not EXPERT_WEIGHT_GATHER:
        return experts, shard
    nd = experts["wi"].dim()
    hidden = experts["wo"].shape[nd - 2] * (
        shard.size if shard.dim("wo") == nd - 2 else 1)
    if not shard.divides(hidden):
        return experts, shard
    want = {k: (nd - 2 if k == "wo" else nd - 1) for k in experts}
    out = {k: shard.relayout(w, shard.dim(k), want[k])
           for k, w in experts.items()}
    return out, type(shard)(shard.mesh, want)


def init_moe(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int, act: str, dtype,
             lead: Tuple[int, ...] = ()) -> dict:
    """Router ``(d, E)`` (fp32), expert FFNs stacked on an expert axis,
    and the always-on shared FFN of width ``d_ff * n_shared`` when
    ``n_shared > 0``."""
    experts = layers.init_ffn(gen, d, d_ff, act, dtype,
                              lead=tuple(lead) + (n_experts,))
    p = {"router": layers.he_init(gen, (d, n_experts), torch.float32,
                                  lead=lead),
         "experts": experts}
    if n_shared > 0:
        p["shared"] = layers.init_ffn(gen, d, d_ff * n_shared, act, dtype,
                                      lead=lead)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows; an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: dict, xt: torch.Tensor, top_k: int, shard=None):
    """Gates ``(T, E)``, the renormalized top-k gate values and their
    expert indices ``(T, k)``, lower index first among ties."""
    router = p["router"] if shard is None else shard.get(p, "router")
    logits = xt.to(torch.float32) @ router
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return gates, gate_vals, gate_idx


def _positions(gate_idx: torch.Tensor, slot: int, fill: torch.Tensor,
               e: int):
    """Expert one-hot ``(T, E)`` of one top-k slot, each token's position
    in its expert's buffer (tokens counted in order, after ``fill``
    tokens of the earlier slots) and the updated fill."""
    onehot = _one_hot(gate_idx[:, slot], e, torch.int64)
    pos = fill[None, :] + torch.cumsum(onehot, dim=0) - onehot
    pos_tok = torch.sum(pos * onehot, dim=1)
    return onehot, pos_tok, fill + torch.sum(onehot, dim=0)


def _aux_loss(gates: torch.Tensor, gate_idx: torch.Tensor,
              e: int) -> torch.Tensor:
    """Switch load balance: ``E * sum_e mean gate_e * mean dispatch_e``."""
    me = torch.mean(gates, dim=0)
    ce = torch.mean(_one_hot(gate_idx[:, 0], e, torch.float32), dim=0)
    return e * torch.sum(me * ce)


def moe_ffn(p: dict, x: torch.Tensor, *, top_k: int, act: str,
            capacity_factor: float = 1.25, impl: str = "einsum",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN.

    Args:
      p: :func:`init_moe`'s parameters.
      x: ``(B, S, D)`` activations.
      top_k: experts per token.
      act: the experts' FFN activation.
      capacity_factor: buffer slack; capacity is ``max(1, ceil(top_k * T
        / E * capacity_factor))``.
      impl: ``"einsum"`` or ``"scatter"`` (same routing and drops).
      shard: ``None``, or the ``Shard`` of ``p`` (see the module
        docstring).

    Returns:
      ``(out (B, S, D), aux_loss scalar)``.
    """
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    xt = x.reshape(t, d)
    gates, gate_vals, gate_idx = _route(p, xt, top_k, shard)
    experts, eshard = _gathered_experts(
        p["experts"], None if shard is None else shard["experts"])
    capacity = max(1, int(math.ceil(top_k * t / e * capacity_factor)))
    fill = torch.zeros((e,), dtype=torch.int64, device=x.device)

    if impl == "scatter":
        exp_in = torch.zeros((e, capacity, d), dtype=x.dtype,
                             device=x.device)
        slots = []
        for slot in range(top_k):
            idx = gate_idx[:, slot]
            _, pos_tok, fill = _positions(gate_idx, slot, fill, e)
            keep = pos_tok < capacity
            pc = torch.clamp_max(pos_tok, capacity - 1)
            add = torch.where(keep[:, None], xt, torch.zeros_like(xt))
            exp_in = exp_in.index_put((idx, pc), add.to(exp_in.dtype),
                                      accumulate=True)
            slots.append((idx, pc, keep))
        exp_out = layers.ffn(experts, exp_in, act, eshard)  # (E, C, D)
        out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        for slot, (idx, pc, keep) in enumerate(slots):
            # gather and weight in the compute dtype, accumulate in fp32
            y = exp_out[idx, pc]
            w = (gate_vals[:, slot] * keep.to(torch.float32)).to(y.dtype)
            out = out + (y * w[:, None]).to(torch.float32)
    else:
        dispatch = torch.zeros((t, e, capacity), dtype=torch.bool,
                               device=x.device)
        combine = torch.zeros((t, e, capacity), dtype=torch.float32,
                              device=x.device)
        for slot in range(top_k):
            onehot, pos_tok, fill = _positions(gate_idx, slot, fill, e)
            keep = pos_tok < capacity
            disp = (_one_hot(pos_tok, capacity, torch.float32)[:, None, :]
                    * onehot[:, :, None].to(torch.float32))
            disp = disp * keep[:, None, None]
            dispatch = dispatch | (disp > 0)
            combine = combine + disp * gate_vals[:, slot][:, None, None]
        exp_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
        exp_out = layers.ffn(experts, exp_in, act, eshard)  # (E, C, D)
        out = torch.einsum("ecd,tec->td", exp_out.to(torch.float32),
                           combine)
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + layers.ffn(p["shared"], x, act,
                               None if shard is None else shard["shared"])
    return out, _aux_loss(gates, gate_idx, e)


# ---------------------------------------------------------------------------
# the dropless expert layer on a held share (DeepSeek-V2's routed experts)
# ---------------------------------------------------------------------------

def init_grouped_moe(gen: torch.Generator, cfg, dtype,
                     lead: Tuple[int, ...] = ()) -> dict:
    """Router ``(d, moe_experts)`` (fp32: it scores every expert), the
    held experts' FFNs stacked on an expert axis of ``held_experts``,
    and the shared FFN of width ``expert_d_ff * moe_shared``."""
    d, width = cfg.d_model, cfg.expert_d_ff
    p = {"router": layers.he_init(gen, (d, cfg.moe_experts), torch.float32,
                                  lead=lead),
         "experts": layers.init_ffn(gen, d, width, cfg.ffn_act, dtype,
                                    lead=tuple(lead) + (cfg.held_experts,))}
    if cfg.moe_shared > 0:
        p["shared"] = layers.init_ffn(gen, d, width * cfg.moe_shared,
                                      cfg.ffn_act, dtype, lead=lead)
    return p


def grouped_route(router: torch.Tensor, xt: torch.Tensor, cfg):
    """Scores ``(T, E)`` (softmax over every expert, fp32) and the greedy
    top-k gate values and experts ``(T, k)``, the lower index first
    among ties; the gates renormalized when ``cfg.moe_norm_topk``, then
    times ``cfg.moe_scaling``."""
    scores = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    if cfg.moe_norm_topk:
        vals = vals / torch.clamp_min(
            torch.sum(vals, dim=-1, keepdim=True), 1e-20)
    return scores, vals * cfg.moe_scaling, idx


def _seq_aux_loss(scores: torch.Tensor, idx: torch.Tensor, b: int,
                  cfg) -> torch.Tensor:
    """DeepSeek's sequence-wise balance loss: per sequence, each expert's
    share of the top-k picks over ``k / E``, times its mean score,
    summed over experts; the mean over sequences times the weight."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    picks = _one_hot(idx.reshape(b, -1), e, torch.float32).sum(dim=1)
    s = idx.shape[0] // b
    ce = picks / (s * k / e)
    mean_score = scores.reshape(b, s, e).mean(dim=1)
    return cfg.moe_seq_aux * torch.mean(torch.sum(ce * mean_score, dim=-1))


def grouped_moe_ffn(p: dict, x: torch.Tensor, cfg, layer: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless routed experts of the held share, plus the shared FFN.

    Every token is routed over all ``cfg.moe_experts`` experts
    (:func:`grouped_route`); of its top-k (token, expert) pairs, those
    whose expert is held (``[moe_held_start, moe_held_start +
    held_experts)``) are sorted by expert, stably, so a group holds its
    tokens in token order, and each group is multiplied by its expert's
    FFN in the grouped GEMM (``repro_torch.kernels.grouped_gemm``): no
    capacity, no token dropped, and no row counts read on the host.
    The pairs of the experts not held come last and take no product;
    their gates are zeroed.  Each token's output is the sum over its
    pairs, in its top-k order, of gate times the expert's output, plus
    the shared FFN.  What the absent experts would add lies on other
    chips and is left out.

    Args:
      p: :func:`init_grouped_moe`'s parameters.
      x: ``(B, S, D)`` activations.
      cfg: the model configuration.
      layer: the layer's index, whose row-counter slots the first
        product's groups count into (``-1``: none).

    Returns:
      ``(out (B, S, D), aux)``: ``aux`` the sequence-wise balance loss
      times ``cfg.moe_seq_aux`` (0 when the weight is 0).
    """
    b, s, d = x.shape
    t, k, h = b * s, cfg.moe_top_k, cfg.held_experts
    xt = x.reshape(t, d)
    with named_span("moe/route"):
        scores, vals, idx = grouped_route(p["router"], xt, cfg)
        local = idx.reshape(-1) - cfg.moe_held_start
        held = (local >= 0) & (local < h)
        local = torch.where(held, local, torch.full_like(local, h))
        order = torch.argsort(local, stable=True)
        counts = torch.sum(_one_hot(local, h, torch.int32), dim=0,
                           dtype=torch.int32)
        offsets = torch.cat([torch.zeros_like(counts[:1]),
                             torch.cumsum(counts, dim=0, dtype=torch.int32)])
        rows = xt[torch.div(order, k, rounding_mode="floor")]
        gates = torch.where(held, vals.reshape(-1), torch.zeros_like(
            vals.reshape(-1))).reshape(t, k)
    with named_span("moe/experts"):
        w = p["experts"]
        base = layer * COUNTER_EXPERTS if layer >= 0 else -1
        hid = (F.silu(grouped_mm(rows, w["wg"], offsets, base))
               * grouped_mm(rows, w["wi"], offsets))
        y = grouped_mm(hid, w["wo"], offsets)
        # back to (token, top-k slot) order
        y = y[torch.argsort(order)].reshape(t, k, d)
        out = torch.einsum("tkd,tk->td", y, gates.to(y.dtype))
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        with named_span("moe/shared"):
            out = out + layers.ffn(p["shared"], x, cfg.ffn_act)
    aux = (_seq_aux_loss(scores, idx, b, cfg) if cfg.moe_seq_aux > 0
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return out, aux

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
positions count tokens in token order, slot by slot.  The reference's
expert-weight sharding constraint is a no-op without a mesh and has no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import layers

__all__ = ["init_moe", "moe_ffn"]


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


def _route(p: dict, xt: torch.Tensor, top_k: int):
    """Gates ``(T, E)``, the renormalized top-k gate values and their
    expert indices ``(T, k)``, lower index first among ties."""
    logits = xt.to(torch.float32) @ p["router"]
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
            capacity_factor: float = 1.25, impl: str = "einsum"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN.

    Args:
      p: :func:`init_moe`'s parameters.
      x: ``(B, S, D)`` activations.
      top_k: experts per token.
      act: the experts' FFN activation.
      capacity_factor: buffer slack; capacity is ``max(1, ceil(top_k * T
        / E * capacity_factor))``.
      impl: ``"einsum"`` or ``"scatter"`` (same routing and drops).

    Returns:
      ``(out (B, S, D), aux_loss scalar)``.
    """
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    xt = x.reshape(t, d)
    gates, gate_vals, gate_idx = _route(p, xt, top_k)
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
        exp_out = layers.ffn(p["experts"], exp_in, act)     # (E, C, D)
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
        exp_out = layers.ffn(p["experts"], exp_in, act)     # (E, C, D)
        out = torch.einsum("ecd,tec->td", exp_out.to(torch.float32),
                           combine)
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + layers.ffn(p["shared"], x, act)
    return out, _aux_loss(gates, gate_idx, e)

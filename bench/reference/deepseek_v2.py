"""Plain float32 reference of DeepSeek-V2 (arXiv:2405.04434; the
published ``modeling_deepseek.py``): pre-norm RMSNorm layers of
multi-head latent attention (no query LoRA) with YaRN on the decoupled
rope dims, a leading dense SwiGLU layer, then layers of routed experts
(softmax over every expert, greedy top-k, the gates unnormalized times
the scaling factor) plus shared experts; a final RMSNorm and an untied
output head.

Written from the published description, not from the program; it reads
the weights in the benchmark's leaf layout (``lead/l0/...`` for the
dense layer, ``periods/s0/...`` stacked on a leading layer axis for the
expert layers).  Of the routed experts it holds the share that the
weights carry (``experts`` leaves of ``held`` experts, the first being
expert ``held_start``): each held expert is applied to exactly the
tokens whose top-k includes it, and what the experts not held would add
is left out, as the chip's share of an expert-parallel layer.
Attention materializes its scores.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.precision import mm


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * scale


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations, dim, base, original):
    return (dim * math.log(original / (rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_cos_sin(seq: int, c: dict, device):
    """``(S, rope)`` cos and sin of the published YaRN rotary embedding
    (``DeepseekV2YarnRotaryEmbedding``), float32."""
    dim, base, y = c["rope"], c["rope_theta"], c["yarn"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (y["factor"] * base ** exps)
    low = max(math.floor(_yarn_correction_dim(
        y["beta_fast"], dim, base, y["original_max_position_embeddings"])),
        0)
    high = min(math.ceil(_yarn_correction_dim(
        y["beta_slow"], dim, base, y["original_max_position_embeddings"])),
        dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    m = (_yarn_get_mscale(y["factor"], y["mscale"])
         / _yarn_get_mscale(y["factor"], y["mscale_all_dim"]))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(c: dict) -> float:
    y = c["yarn"]
    s = (c["nope"] + c["rope"]) ** -0.5
    if y["mscale_all_dim"]:
        m = _yarn_get_mscale(y["factor"], y["mscale_all_dim"])
        s = s * m * m
    return s


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat((-x[..., h:], x[..., :h]), dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """``x`` ``(H, S, d)``: pairs de-interleaved, then rotated."""
    h, s, d = x.shape
    x = x.view(h, s, d // 2, 2).transpose(3, 2).reshape(h, s, d)
    return x * cos[None] + _rotate_half(x) * sin[None]


def _mla(a: dict, i, h: torch.Tensor, c: dict, cos, sin) -> torch.Tensor:
    s = h.shape[0]
    heads, nope, rope, dv = c["heads"], c["nope"], c["rope"], c["v"]
    r = c["kv_lora"]
    q = mm(h, a["wq"][i]).view(s, heads, nope + rope).transpose(0, 1)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    ckv = mm(h, a["wkv_a"][i])
    ckv, k_pe = torch.split(ckv, [r, rope], dim=-1)
    k_pe = k_pe.view(s, 1, rope).transpose(0, 1)
    kv = mm(_rms(ckv, a["kv_norm"]["scale"][i], c["eps"]), a["wkv_b"][i])
    kv = kv.view(s, heads, nope + dv).transpose(0, 1)
    k_nope, v = torch.split(kv, [nope, dv], dim=-1)
    q_pe = _apply_rope(q_pe, cos, sin)
    k_pe = _apply_rope(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(heads, s, rope)], dim=-1)
    scores = mm(q, k.transpose(1, 2)) * softmax_scale(c)
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1, dtype=torch.float32), v)
    return mm(o.transpose(0, 1).reshape(s, heads * dv), a["wo"][i])


def _swiglu(p: dict, i, h: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(h, p["wg"][i])) * mm(h, p["wi"][i]), p["wo"][i])


def _moe(p: dict, i: int, h: torch.Tensor, c: dict) -> torch.Tensor:
    """The held experts' part of the routed output plus the shared
    experts."""
    scores = torch.softmax(mm(h, p["router"][i]), dim=-1,
                           dtype=torch.float32)
    weight, idx = torch.topk(scores, k=c["top_k"], dim=-1, sorted=False)
    if c["norm_topk"]:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    else:
        weight = weight * c["scaling"]
    ex = p["experts"]
    out = torch.zeros_like(h)
    for e in range(ex["wi"].shape[1]):
        hit = idx == c["held_start"] + e                   # (S, k)
        tokens = torch.nonzero(hit.any(dim=-1))[:, 0]
        if tokens.numel() == 0:
            continue
        gate = (weight * hit)[tokens].sum(dim=-1)
        y = mm(F.silu(mm(h[tokens], ex["wg"][i, e]))
               * mm(h[tokens], ex["wi"][i, e]), ex["wo"][i, e])
        out = out.index_add(0, tokens, y * gate[:, None])
    return out + _swiglu(p["shared"], i, h)


def _layer(p: dict, i, x: torch.Tensor, c: dict, cos, sin) -> torch.Tensor:
    x = x + _mla(p["attn"], i, _rms(x, p["ln"]["scale"][i], c["eps"]), c,
                 cos, sin)
    h = _rms(x, p["ln_f"]["scale"][i], c["eps"])
    if "moe" in p:
        return x + _moe(p["moe"], i, h, c)
    return x + _swiglu(p["ffn"], i, h)


def _unstacked(tree):
    """A leaf tree given a leading axis of one (a leading layer)."""
    if isinstance(tree, dict):
        return {k: _unstacked(v) for k, v in tree.items()}
    return tree[None]


def logits(params: dict, tokens: torch.Tensor, c: dict) -> torch.Tensor:
    """``(S, V)`` float32 logits of one sequence ``tokens`` ``(S,)``.

    ``c``: ``heads``, ``nope``, ``rope``, ``v``, ``kv_lora``, ``eps``,
    ``rope_theta``, ``yarn`` (the published ``rope_scaling`` keys),
    ``dense`` (leading dense layers), ``layers`` (all layers),
    ``top_k``, ``norm_topk``, ``scaling``, ``held_start``."""
    s = tokens.shape[0]
    cos, sin = yarn_cos_sin(s, c, tokens.device)
    x = params["embed"]["table"][tokens.long()]
    for i in range(c["dense"]):
        x = _layer(_unstacked(params["lead"][f"l{i}"]), 0, x, c, cos, sin)
    p = params["periods"]["s0"]
    for i in range(c["layers"] - c["dense"]):
        x = _layer(p, i, x, c, cos, sin)
    x = _rms(x, params["final_norm"]["scale"], c["eps"])
    return mm(x, params["lm_head"]["w"])

"""Plain float32 reference of a dense decoder (Qwen1.5 / Qwen2 family):
pre-norm RMSNorm, causal multi-head attention with q/k/v biases and
half-split RoPE, a SwiGLU feed-forward, a final RMSNorm and the output
head tied to the embedding.

Written from the published architecture, not from the program; it reads
the weights in the benchmark's leaf layout (``periods/s0/...``, each
leaf stacked on a leading layer axis).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.precision import mm


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` ``(S, H, D)`` rotated in halves, angles in float32 as the
    published implementation computes them."""
    s, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device)
                           .float() / d))
    ang = torch.arange(s, device=x.device).float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(p: dict, i: int, x: torch.Tensor, c: dict) -> torch.Tensor:
    a, fp = p["attn"], p["ffn"]
    s = x.shape[0]
    heads, kv, hd = c["heads"], c["kv_heads"], c["head_dim"]
    h = _rms(x, p["ln"]["scale"][i], c["eps"])
    q = (mm(h, a["wq"][i]) + a["bq"][i]).view(s, heads, hd)
    k = (mm(h, a["wk"][i]) + a["bk"][i]).view(s, kv, hd)
    v = (mm(h, a["wv"][i]) + a["bv"][i]).view(s, kv, hd)
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    g = heads // kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v.transpose(0, 1))
    x = x + mm(o.transpose(0, 1).reshape(s, heads * hd), a["wo"][i])
    h = _rms(x, p["ln_f"]["scale"][i], c["eps"])
    return x + mm(F.silu(mm(h, fp["wg"][i])) * mm(h, fp["wi"][i]),
                  fp["wo"][i])


def logits(params: dict, tokens: torch.Tensor, c: dict) -> torch.Tensor:
    """``(S, V)`` float32 logits of one sequence ``tokens`` ``(S,)``.

    ``c``: ``heads``, ``kv_heads``, ``head_dim``, ``layers``, ``eps``,
    ``rope_theta``."""
    table = params["embed"]["table"]
    x = table[tokens.long()]
    p = params["periods"]["s0"]
    for i in range(c["layers"]):
        x = _layer(p, i, x, c)
    x = _rms(x, params["final_norm"]["scale"], c["eps"])
    return mm(x, table.t())


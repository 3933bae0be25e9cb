"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1) with
YaRN rope scaling, the ``mla`` slot of the transformer.

No counterpart in the JAX package: the port's own slot, written from the
published equations (``modeling_deepseek.py``'s ``DeepseekV2Attention``
without a query LoRA).  Per layer, with ``H`` heads:

  q = x W_q                          (H, nope + rope) per position
  [c, k_rope] = x W_kv_a             c: the latent (``kv_lora_rank``),
                                     k_rope: one rope key for all heads
  [k_nope, v] = RMSNorm(c) W_kv_b    (H, nope + v) per position
  q_rope, k_rope rotated by YaRN's frequencies
  o = softmax([q_nope, q_rope] . [k_nope, k_rope] * scale) v
  out = o W_o

The rotary convention is the published one: each rope vector's pairs are
de-interleaved (even entries first, then odd) before the half-split
rotation, and stay so.  YaRN (arXiv:2309.00071) blends each frequency
between its original and its ``1 / factor`` interpolated value over the
ramp that ``beta_fast`` / ``beta_slow`` set on the original context, and
multiplies cos and sin by ``mscale(factor, mscale) / mscale(factor,
mscale_all_dim)``; the softmax scale is ``(nope + rope) ** -0.5`` times
``mscale(factor, mscale_all_dim) ** 2``.

Parameters (``(in, out)`` weights, as every layer of the port): ``wq``
``(D, H (nope + rope))``, ``wkv_a`` ``(D, kv_lora_rank + rope)``,
``kv_norm/scale`` ``(kv_lora_rank,)``, ``wkv_b`` ``(kv_lora_rank, H (nope
+ v))``, ``wo`` ``(H v, D)``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import named_span

__all__ = ["init_mla", "mla_attention", "softmax_scale", "yarn_inv_freq",
           "yarn_mscale"]


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor ``0.1 mscale ln(scale) + 1`` (1 at
    ``scale <= 1``)."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    original: int) -> float:
    return (dim * math.log(original / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """``(rope / 2,)`` float32 inverse frequencies of the rope dims:
    plain RoPE's without YaRN, else each blended between the original
    and the interpolated one (``1 / factor``) by YaRN's linear ramp."""
    dim = cfg.qk_rope_head_dim
    base = float(cfg.rope_theta)
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** pos)
    if cfg.yarn_factor <= 0:
        return extra
    inter = 1.0 / (cfg.yarn_factor * base ** pos)
    low = max(math.floor(_correction_dim(
        cfg.yarn_beta_fast, dim, base, cfg.yarn_original_len)), 0)
    high = min(math.ceil(_correction_dim(
        cfg.yarn_beta_slow, dim, base, cfg.yarn_original_len)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0.0, 1.0)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def _rope_mscale(cfg: ModelConfig) -> float:
    if cfg.yarn_factor <= 0:
        return 1.0
    return (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
            / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))


def softmax_scale(cfg: ModelConfig) -> float:
    """The scores' factor: ``(nope + rope) ** -0.5``, times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` when it scales."""
    s = float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor > 0 and cfg.yarn_mscale_all_dim:
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        s = s * m * m
    return s


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """``x`` ``(B, S, H, rope)`` de-interleaved, then rotated in halves
    by YaRN's frequencies (angles and products in fp32)."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    ang = (positions.to(torch.float32)[:, None]
           * yarn_inv_freq(cfg, x.device)[None])           # (S, rope / 2)
    m = _rope_mscale(cfg)
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    x1 = x[..., :d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def init_mla(gen, cfg: ModelConfig, dtype, lead=()) -> dict:
    """The slot's weights (see the module docstring)."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    return {
        "wq": layers.he_init(gen, (d, h * (nope + rope)), dtype, lead=lead),
        "wkv_a": layers.he_init(gen, (d, r + rope), dtype, lead=lead),
        "kv_norm": layers.init_rmsnorm(r, dtype, gen.device, lead),
        "wkv_b": layers.he_init(gen, (r, h * (nope + dv)), dtype,
                                lead=lead),
        "wo": layers.he_init(gen, (h * dv, d), dtype, fan_in=h * dv,
                             lead=lead),
    }


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, impl: str = "auto"
                  ) -> torch.Tensor:
    """Causal latent attention of ``x`` ``(B, S, D)``; ``(B, S, D)``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    with named_span("model/mla"):
        q = (x @ p["wq"]).reshape(b, s, h, nope + rope)
        kva = x @ p["wkv_a"]
        c, k_rope = torch.split(kva, [r, rope], dim=-1)
        kv = (layers.rmsnorm(p["kv_norm"], c) @ p["wkv_b"]).reshape(
            b, s, h, nope + dv)
        k_nope, v = torch.split(kv, [nope, dv], dim=-1)
        q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
        q = torch.cat([q_nope, _rotate(q_rope, positions, cfg)], dim=-1)
        k_rope = _rotate(k_rope[:, :, None, :], positions, cfg)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
        o = attention(q, k, v, kind="attn", impl=impl,
                      scale=softmax_scale(cfg))
        return o.reshape(b, s, h * dv) @ p["wo"]

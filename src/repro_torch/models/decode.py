"""Serving path: KV / SSM caches, prefill, single-token decode and the
speculative verify block (counterpart of ``repro/models/decode.py``).

The cache layout mirrors the parameter layout: per-period leaves
stacked on a leading ``n_periods`` axis (``periods/s{j}``, shapes
``(n_periods, B, ...)``) and one unstacked cache per tail layer
(``tail/t{t}``).  Attention slots keep a full cache of ``cache_len``
positions; sliding-window and chunked slots keep a ring of ``window`` /
``chunk`` positions, so their KV state does not grow with the context.

Every function here returns new caches and never writes one in place
(each write is an out-of-place ``index_put``), so the serving layer can
run the replicas of an ensemble through ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pytree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.models.attention import (decode_attention, rope,
                                          verify_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype
from repro_torch.models.transformer import (_apply_layer, _proj, _run_encoder,
                                            _stack_len, _stacked)

__all__ = ["decode_step", "init_cache", "prefill", "slot_cache_len",
           "verify_step", "verify_supported"]

_RING_SLOTS = ("swa", "chunked")


def slot_cache_len(cfg: ModelConfig, slot: str, cache_len: int) -> int:
    """Cache positions of one layer slot: the window (``swa``) or the
    chunk (``chunked``) when set and shorter, else ``cache_len``."""
    if slot == "swa" and cfg.window > 0:
        return min(cfg.window, cache_len)
    if slot == "chunked" and cfg.chunk > 0:
        return min(cfg.chunk, cache_len)
    return cache_len


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def _init_slot_cache(cfg: ModelConfig, slot: str, batch: int,
                     cache_len: int, dtype, device) -> dict:
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    if slot == "mamba":
        return ssm.init_mamba_cache(cfg, batch, dtype, device=device)
    length = slot_cache_len(cfg, slot, cache_len)
    c = {"k": torch.zeros((batch, length, hkv, hd), dtype=dtype,
                          device=device),
         "v": torch.zeros((batch, length, hkv, hd), dtype=dtype,
                          device=device)}
    if slot == "xattn":
        se = cfg.encoder_seq or cfg.vision_seq
        c["xk"] = torch.zeros((batch, se, hkv, hd), dtype=dtype,
                              device=device)
        c["xv"] = torch.zeros((batch, se, hkv, hd), dtype=dtype,
                              device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Zeroed decode caches for ``batch`` sequences.

    Args:
      cfg: the model configuration.
      batch: sequences (the serving engine's slots).
      cache_len: positions of a full attention cache.
      device: where the caches live (``"cuda"`` raises without a card;
        ``"meta"`` gives shapes and dtypes only).

    Returns:
      ``{"periods": {"s{j}": ...}, "tail": {"t{t}": ...}}``: period
      leaves are ``(n_periods, batch, ...)``, tail leaves ``(batch,
      ...)``, in ``cfg.param_dtype`` (a Mamba state in fp32).
    """
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    periods = {}
    for j, slot in enumerate(cfg.layer_pattern):
        one = _init_slot_cache(cfg, slot, batch, cache_len, dtype, dev)
        periods[f"s{j}"] = tree_map(
            lambda x: x[None].expand((cfg.n_periods,) + tuple(x.shape))
            .clone(), one)
    tail = {}
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        tail[f"t{t}"] = _init_slot_cache(cfg, slot, batch, cache_len, dtype,
                                         dev)
    return {"periods": periods, "tail": tail}


# ---------------------------------------------------------------------------
# the shared per-layer pieces
# ---------------------------------------------------------------------------

def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (a scalar, or ``(B,)`` per-slot positions) as a ``(B,)``
    int32 tensor on ``device``."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(b)


def _write(cache: torch.Tensor, idx: torch.Tensor,
           new: torch.Tensor) -> torch.Tensor:
    """``cache`` with ``new[b, j]`` written at position ``idx[b, j]`` of
    sequence ``b``: an out-of-place ``index_put`` (``.at[].set``)."""
    b = cache.shape[0]
    bidx = torch.arange(b, device=cache.device)[:, None].expand_as(idx)
    return cache.index_put((bidx, idx.long()), new.to(cache.dtype))


def _ffn_part(p, x, cfg: ModelConfig) -> torch.Tensor:
    if "ffn" in p:
        return x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln_f"], x),
                              cfg.ffn_act)
    if "moe" in p:
        y, _ = moe.moe_ffn(p["moe"], layers.rmsnorm(p["ln_f"], x),
                           top_k=cfg.moe_top_k, act=cfg.ffn_act,
                           capacity_factor=cfg.capacity_factor,
                           impl=cfg.moe_impl)
        return x + y
    return x


def _cross_part(p, c, x, cfg: ModelConfig) -> torch.Tensor:
    """An ``xattn`` slot's cross-attention over its cached encoder keys."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = layers.rmsnorm(p["ln_x"], x)
    q = _proj(h, p["xatt"], "wq", "bq").reshape(b, s, cfg.n_heads, hd)
    o = verify_attention(q, c["xk"], c["xv"])
    return x + o.reshape(b, s, cfg.n_heads * hd) @ p["xatt"]["wo"]


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, the output projection and the soft cap (the serving
    path keeps the parameters' dtype, as the reference's does)."""
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["lm_head"], x)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _run_layers(params, cfg: ModelConfig, cache: dict, x: torch.Tensor,
                layer_fn):
    """``layer_fn(p, c, x, slot) -> (new_c, x)`` over the periods (in
    order, the period caches restacked) and then the tail."""
    period_caches = []
    periods = params["periods"]
    for i in range(_stack_len(periods)):
        period_p = _stacked(periods, i)
        period_c = _stacked(cache["periods"], i)
        newc = {}
        for j, slot in enumerate(cfg.layer_pattern):
            newc[f"s{j}"], x = layer_fn(period_p[f"s{j}"],
                                        period_c[f"s{j}"], x, slot)
        period_caches.append(newc)
    new_periods = tree_map(lambda *xs: torch.stack(xs), *period_caches)
    new_tail = {}
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        new_tail[f"t{t}"], x = layer_fn(params["tail"][f"t{t}"],
                                        cache["tail"][f"t{t}"], x, slot)
    return x, {"periods": new_periods, "tail": new_tail}


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _decode_attn_slot(p, c, x, cfg: ModelConfig, slot: str, pos):
    """One token per sequence, each at its own position ``pos[b]``:
    rope and the cache write use it (ring slots at ``pos % L``, full
    slots at ``min(pos, L - 1)``)."""
    b = x.shape[0]
    hd = cfg.head_dim
    h = layers.rmsnorm(p["ln"], x)
    q = _proj(h, p["attn"], "wq", "bq").reshape(b, 1, cfg.n_heads, hd)
    k = _proj(h, p["attn"], "wk", "bk").reshape(b, 1, cfg.n_kv_heads, hd)
    v = _proj(h, p["attn"], "wv", "bv").reshape(b, 1, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        posv = pos[:, None]                     # (B, 1): rope per sequence
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
    length = c["k"].shape[1]
    if slot in _RING_SLOTS:
        idx = torch.remainder(pos, length)
    else:
        idx = torch.clamp_max(pos, length - 1)
    kc = _write(c["k"], idx[:, None], k[:, 0:1])
    vc = _write(c["v"], idx[:, None], v[:, 0:1])
    valid = torch.clamp_max(pos + 1, length)
    o = decode_attention(q, kc, vc, valid_len=valid)
    y = o.reshape(b, 1, cfg.n_heads * hd) @ p["attn"]["wo"]
    newc = dict(c)
    newc["k"], newc["v"] = kc, vc
    return newc, y


def _decode_layer(p, c, x, cfg: ModelConfig, slot: str, pos):
    if slot == "mamba":
        newc, y = ssm.mamba_decode_step(p["mix"], c,
                                        layers.rmsnorm(p["ln"], x), cfg)
        x = x + y
    else:
        newc, y = _decode_attn_slot(p, c, x, cfg, slot, pos)
        x = x + y
        if slot == "xattn":
            x = _cross_part(p, c, x, cfg)
    return newc, _ffn_part(p, x, cfg)


def decode_step(params, cfg: ModelConfig, cache: dict, token: torch.Tensor,
                pos) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence of the batch.

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      cache: the decode caches (:func:`init_cache` layout).
      token: ``(B, 1)`` integer tokens.
      pos: a scalar, or ``(B,)`` int32 per-sequence positions
        (continuous batching: each sequence ropes and writes its cache
        at its own index).

    Returns:
      ``(logits (B, 1, V), new_cache)``.
    """
    x = layers.embed(params["embed"], token)
    pos = _positions(pos, x.shape[0], x.device)
    x, new_cache = _run_layers(
        params, cfg, cache, x,
        lambda p, c, x, slot: _decode_layer(p, c, x, cfg, slot, pos))
    return _logits(params, cfg, x), new_cache


# ---------------------------------------------------------------------------
# verify step (a causal block of new tokens: the speculative-decoding path)
# ---------------------------------------------------------------------------

def verify_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether :func:`verify_step` (and so speculative decoding) applies.

    The verify block relies on positional cache rollback: a rejected
    draft suffix leaves entries above the accepted position, which
    per-query causal masking hides until the next block overwrites them.
    Ring caches (``swa`` / ``chunked``) wrap rejected writes onto valid
    window entries, and a Mamba state advances destructively, so both
    break it.

    Args:
      cfg: the model configuration.

    Returns:
      ``(ok, reason)``; ``reason`` names the offending slot (the
      reference's texts) and is empty when ``ok``.
    """
    slots = set(cfg.layer_pattern)
    slots.update(cfg.slot(cfg.n_periods * cfg.period + t)
                 for t in range(cfg.n_tail))
    for slot in sorted(slots):
        if slot == "mamba":
            return False, ("mamba: recurrent SSM state cannot roll back "
                           "a rejected draft suffix")
        if slot in _RING_SLOTS:
            return False, (f"{slot}: ring cache wraps rejected draft "
                           f"writes onto valid window entries")
    return True, ""


def _verify_attn_slot(p, c, x, cfg: ModelConfig, slot: str, pos):
    """One attention layer over a ``(B, S)`` block, token ``j`` at
    position ``pos + j``: all S keys are written first, then each query
    attends its own causal prefix."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    qpos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                       device=x.device)[None, :]  # (B, S)
    h = layers.rmsnorm(p["ln"], x)
    q = _proj(h, p["attn"], "wq", "bq").reshape(b, s, cfg.n_heads, hd)
    k = _proj(h, p["attn"], "wk", "bk").reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(h, p["attn"], "wv", "bv").reshape(b, s, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
    if slot in _RING_SLOTS or slot == "mamba":
        raise ValueError(
            f"verify_step does not support {slot!r} slots (ring/SSM "
            f"caches cannot roll back rejected draft tokens)")
    length = c["k"].shape[1]
    idx = torch.clamp_max(qpos, length - 1)
    kc = _write(c["k"], idx, k)
    vc = _write(c["v"], idx, v)
    q_valid = torch.clamp_max(qpos + 1, length)
    o = verify_attention(q, kc, vc, q_valid=q_valid)
    y = o.reshape(b, s, cfg.n_heads * hd) @ p["attn"]["wo"]
    newc = dict(c)
    newc["k"], newc["v"] = kc, vc
    return newc, y


def _verify_layer(p, c, x, cfg: ModelConfig, slot: str, pos):
    newc, y = _verify_attn_slot(p, c, x, cfg, slot, pos)
    x = x + y
    if slot == "xattn":
        x = _cross_part(p, c, x, cfg)
    return newc, _ffn_part(p, x, cfg)


def verify_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, dict]:
    """A causal block of ``S`` tokens in one forward pass.

    ``tokens[:, j]`` is consumed at position ``pos + j`` and
    ``logits[:, j]`` predicts the token at ``pos + j + 1``: what ``S``
    sequential :func:`decode_step` calls on the same tokens give, with
    one pass.  Needs full attention caches (:func:`verify_supported`).

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      cache: the decode caches.
      tokens: ``(B, S)`` integer tokens.
      pos: a scalar, or ``(B,)`` int32 position of ``tokens[:, 0]``.

    Returns:
      ``(logits (B, S, V), new_cache)`` with the block's ``S`` keys and
      values written into every attention layer's cache.
    """
    x = layers.embed(params["embed"], tokens)
    pos = _positions(pos, x.shape[0], x.device)
    x, new_cache = _run_layers(
        params, cfg, cache, x,
        lambda p, c, x, slot: _verify_layer(p, c, x, cfg, slot, pos))
    return _logits(params, cfg, x), new_cache


# ---------------------------------------------------------------------------
# prefill (fills the caches: the serving engine's admission)
# ---------------------------------------------------------------------------

def _prefill_slot(p, x, cfg: ModelConfig, slot: str, positions, enc_out,
                  cache_len: int, impl: str):
    """One layer over the whole sequence, and its filled cache."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    if slot == "mamba":
        y, cache = ssm.mamba_prefill(p["mix"], layers.rmsnorm(p["ln"], x),
                                     cfg)
        return _ffn_part(p, x + y, cfg), cache
    # attention slots: k and v again for the cache (cheap beside the
    # attention itself)
    h = layers.rmsnorm(p["ln"], x)
    k = _proj(h, p["attn"], "wk", "bk").reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(h, p["attn"], "wv", "bv").reshape(b, s, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        k = rope(k, positions, cfg.rope_theta)
    length = slot_cache_len(cfg, slot, cache_len)
    if s >= length:
        kc, vc = k[:, s - length:], v[:, s - length:]
    else:
        kc = F.pad(k, (0, 0, 0, 0, 0, length - s))
        vc = F.pad(v, (0, 0, 0, 0, 0, length - s))
    cache = {"k": kc, "v": vc}
    if slot == "xattn":
        se = enc_out.shape[1]
        cache["xk"] = _proj(enc_out, p["xatt"], "wk", "bk").reshape(
            b, se, cfg.n_kv_heads, hd)
        cache["xv"] = _proj(enc_out, p["xatt"], "wv", "bv").reshape(
            b, se, cfg.n_kv_heads, hd)
    x, _ = _apply_layer(p, x, cfg, slot, positions, enc_out, impl)
    return x, cache


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[torch.Tensor] = None, cache_len: int = 0,
            impl: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns filled decode caches.

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      tokens: ``(B, S)`` integer tokens (the prompts).
      extra: the whisper encoder's frames or the vlm's patch embeddings
        ``(B, S_enc, d_model)``.
      cache_len: positions of a full attention cache (``0``: ``S``).
      impl: attention path, ``"auto"`` | ``"naive"`` | ``"blockwise"``.

    Returns:
      ``(logits (B, S, V), cache)`` in :func:`init_cache`'s layout.
    """
    b, s = tokens.shape
    cache_len = cache_len or s
    x = layers.embed(params["embed"], tokens)
    if cfg.arch_type == "audio":
        enc_out = _run_encoder(params, cfg, extra, impl)
    elif cfg.arch_type == "vlm":
        enc_out = extra
    else:
        enc_out = None
    positions = torch.arange(s, device=x.device)

    period_caches = []
    periods = params["periods"]
    for i in range(_stack_len(periods)):
        period_p = _stacked(periods, i)
        caches = {}
        for j, slot in enumerate(cfg.layer_pattern):
            x, caches[f"s{j}"] = _prefill_slot(
                period_p[f"s{j}"], x, cfg, slot, positions, enc_out,
                cache_len, impl)
        period_caches.append(caches)
    tail_caches = {}
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        x, tail_caches[f"t{t}"] = _prefill_slot(
            params["tail"][f"t{t}"], x, cfg, slot, positions, enc_out,
            cache_len, impl)
    return _logits(params, cfg, x), {
        "periods": tree_map(lambda *xs: torch.stack(xs), *period_caches),
        "tail": tail_caches}

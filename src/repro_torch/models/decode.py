"""Serving path: KV / SSM caches, prefill, single-token decode and the
speculative verify block (counterpart of ``repro/models/decode.py``).

The cache layout mirrors the parameter layout: per-period leaves
stacked on a leading ``n_periods`` axis (``periods/s{j}``, shapes
``(n_periods, B, ...)``) and one unstacked cache per tail layer
(``tail/t{t}``).  Attention slots keep a full cache of ``cache_len``
positions; sliding-window and chunked slots keep a ring of ``window`` /
``chunk`` positions, so their KV state does not grow with the context.

The decode core writes the caches in place: :func:`decode_step_` and
:func:`verify_step_` write each step's keys and values (and a Mamba
slot's new conv and SSM state) into the ``cache`` tree they are given,
through views of its stacked leaves, and return only the logits.  The
caller owns that tree as one persistent buffer (the serving engine's
``cache`` and ``draft_cache``); no step allocates or copies a whole
cache leaf.  In-place writes on views of a ``torch.func.vmap``-batched
leaf land in the caller's storage, so the serving layer runs the
replicas of an ensemble through ``vmap`` on the core.  The functional
entry points :func:`decode_step` and :func:`verify_step` clone the tree
once and call the core, so they leave their input unwritten, as the
reference's do.

``prefill`` and the decode and verify steps take ``shard=`` (a
``repro_torch.dist.tensor_parallel.Shard``, ``None`` on one device): the
parameters are then one rank's slices split over a mesh's ``model``
axis, in the serving layout (``tensor_parallel.serving_specs``: the
leaves a layer reads whole are whole, so no step gathers a parameter).
The projections run through the training forward's split products
(``transformer._projections`` / ``_out_proj``, ``layers.ffn``,
``moe.moe_ffn``), so q, k and v come out whole on every rank and the
caches keep the reference's layout, whole along ``model``
(``cache_shardings`` never splits KV heads); decode attention runs whole
on every rank.  When the output table splits on the vocabulary the
logits are this rank's vocabulary columns (:func:`logits_split`).  The
collectives have ``vmap`` rules, so the replicas of a rank's ensemble
share each one.
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
from repro_torch.models.transformer import (_apply_layer, _entry, _head,
                                            _out_proj, _proj, _projections,
                                            _run_encoder, _stack_len,
                                            _stacked, _sub, logits_split)
from repro_torch.obs.trace import named_span

__all__ = ["decode_step", "decode_step_", "init_cache", "logits_split",
           "prefill", "slot_cache_len", "verify_step", "verify_step_",
           "verify_supported"]

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


def _require_serving(cfg: ModelConfig) -> None:
    """``NotImplementedError`` naming what serving lacks for ``cfg`` (an
    ``mla`` slot's latent cache, the grouped expert layer's decode)."""
    why = cfg.unsupported("serving")
    if why:
        raise NotImplementedError(why)


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
    _require_serving(cfg)
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
           new: torch.Tensor) -> None:
    """Write ``new[b, j]`` at position ``idx[b, j]`` of sequence ``b``
    of ``cache``, in place (``index_put_``)."""
    with named_span("model/cache"):
        b = cache.shape[0]
        bidx = torch.arange(b, device=cache.device)[:, None].expand_as(idx)
        cache.index_put_((bidx, idx.long()), new.to(cache.dtype))


def _norm(p, key, x, shard) -> torch.Tensor:
    return layers.rmsnorm(p[key], x, shard=_sub(shard, key))


def _ffn_part(p, x, cfg: ModelConfig, shard=None) -> torch.Tensor:
    if "ffn" in p:
        return x + layers.ffn(p["ffn"], _norm(p, "ln_f", x, shard),
                              cfg.ffn_act, shard=_sub(shard, "ffn"))
    if "moe" in p:
        y, _ = moe.moe_ffn(p["moe"], _norm(p, "ln_f", x, shard),
                           top_k=cfg.moe_top_k, act=cfg.ffn_act,
                           capacity_factor=cfg.capacity_factor,
                           impl=cfg.moe_impl, shard=_sub(shard, "moe"))
        return x + y
    return x


def _q_proj(p, h, shard) -> torch.Tensor:
    """The query projection alone (whole on every rank)."""
    if shard is None:
        return _proj(h, p, "wq", "bq")
    y = shard.matmul(h, p, "wq")
    return y + shard.get(p, "bq") if "bq" in p else y


def _cross_part(p, c, x, cfg: ModelConfig, shard=None) -> torch.Tensor:
    """An ``xattn`` slot's cross-attention over its cached encoder keys."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _norm(p, "ln_x", x, shard)
    xs = _sub(shard, "xatt")
    q = _q_proj(p["xatt"], h, xs).reshape(b, s, cfg.n_heads, hd)
    o = verify_attention(q, c["xk"], c["xv"])
    return x + _out_proj(o.reshape(b, s, cfg.n_heads * hd), p["xatt"], xs)


def _logits(params, cfg: ModelConfig, x: torch.Tensor,
            shard=None) -> torch.Tensor:
    """Final norm, the output projection and the soft cap (the serving
    path keeps the parameters' dtype, as the reference's does)."""
    x = _norm(params, "final_norm", x, shard)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    return _head(params[head], x, cfg, shard)


def _run_layers(params, cfg: ModelConfig, cache: dict, x: torch.Tensor,
                layer_fn, shard=None) -> torch.Tensor:
    """``layer_fn(p, c, x, slot, shard) -> x`` over the periods, in
    order, and then the tail; each layer's ``c`` is a view of
    ``cache``'s leaves (a period's entry of the stacked leaves), which
    ``layer_fn`` writes in place."""
    periods = params["periods"]
    for i in range(_stack_len(periods)):
        period_p, period_s = _entry(periods, i, _sub(shard, "periods"))
        period_c = _stacked(cache["periods"], i)
        for j, slot in enumerate(cfg.layer_pattern):
            x = layer_fn(period_p[f"s{j}"], period_c[f"s{j}"], x, slot,
                         _sub(period_s, f"s{j}"))
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        x = layer_fn(params["tail"][f"t{t}"], cache["tail"][f"t{t}"], x,
                     slot, _sub(_sub(shard, "tail"), f"t{t}"))
    return x


def _step_(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
           pos, layer, shard=None) -> torch.Tensor:
    """The logits of ``tokens`` at ``pos`` through every layer's
    ``layer(p, c, x, cfg, slot, pos, shard) -> x``, which writes its
    cache ``c`` in place."""
    _require_serving(cfg)
    x = layers.embed(params["embed"], tokens, shard=_sub(shard, "embed"))
    pos = _positions(pos, x.shape[0], x.device)
    x = _run_layers(
        params, cfg, cache, x,
        lambda p, c, x, slot, s: layer(p, c, x, cfg, slot, pos, s), shard)
    return _logits(params, cfg, x, shard)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _decode_attn_slot(p, c, x, cfg: ModelConfig, slot: str, pos,
                      shard=None):
    """One token per sequence, each at its own position ``pos[b]``:
    rope and the cache write use it (ring slots at ``pos % L``, full
    slots at ``min(pos, L - 1)``).  Writes ``c``'s k and v in place and
    returns the layer's attention output."""
    b = x.shape[0]
    hd = cfg.head_dim
    h = _norm(p, "ln", x, shard)
    q, k, v = _projections(p["attn"], h, h, _sub(shard, "attn"))
    q = q.reshape(b, 1, cfg.n_heads, hd)
    k = k.reshape(b, 1, cfg.n_kv_heads, hd)
    v = v.reshape(b, 1, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        posv = pos[:, None]                     # (B, 1): rope per sequence
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
    length = c["k"].shape[1]
    if slot in _RING_SLOTS:
        idx = torch.remainder(pos, length)
    else:
        idx = torch.clamp_max(pos, length - 1)
    _write(c["k"], idx[:, None], k[:, 0:1])
    _write(c["v"], idx[:, None], v[:, 0:1])
    valid = torch.clamp_max(pos + 1, length)
    o = decode_attention(q, c["k"], c["v"], valid_len=valid)
    return _out_proj(o.reshape(b, 1, cfg.n_heads * hd), p["attn"],
                     _sub(shard, "attn"))


def _decode_layer(p, c, x, cfg: ModelConfig, slot: str, pos, shard=None):
    if slot == "mamba":
        newc, y = ssm.mamba_decode_step(p["mix"], c,
                                        _norm(p, "ln", x, shard), cfg,
                                        shard=_sub(shard, "mix"))
        with named_span("model/cache"):
            for key, leaf in newc.items():
                c[key].copy_(leaf)
        x = x + y
    else:
        x = x + _decode_attn_slot(p, c, x, cfg, slot, pos, shard)
        if slot == "xattn":
            x = _cross_part(p, c, x, cfg, shard)
    return _ffn_part(p, x, cfg, shard)


def decode_step_(params, cfg: ModelConfig, cache: dict, token: torch.Tensor,
                 pos, shard=None) -> torch.Tensor:
    """One token for every sequence of the batch, its keys and values
    (and a Mamba slot's new state) written into ``cache`` in place.

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      cache: the decode caches (:func:`init_cache` layout), which the
        caller owns; written in place.
      token: ``(B, 1)`` integer tokens.
      pos: a scalar, or ``(B,)`` int32 per-sequence positions
        (continuous batching: each sequence ropes and writes its cache
        at its own index).
      shard: ``None``, or the ``Shard`` of ``params`` (this rank's
        slices in the serving layout; see the module docstring).

    Returns:
      ``logits (B, 1, V)``; ``V`` is this rank's columns when
      :func:`logits_split`.
    """
    return _step_(params, cfg, cache, token, pos, _decode_layer, shard)


def decode_step(params, cfg: ModelConfig, cache: dict, token: torch.Tensor,
                pos, shard=None) -> Tuple[torch.Tensor, dict]:
    """:func:`decode_step_` on a copy of ``cache``: ``cache`` is left
    unwritten.

    Args:
      params, cfg, cache, token, pos, shard: as :func:`decode_step_`'s.

    Returns:
      ``(logits (B, 1, V), new_cache)``.
    """
    cache = tree_map(torch.clone, cache)
    return decode_step_(params, cfg, cache, token, pos, shard), cache


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


def _verify_attn_slot(p, c, x, cfg: ModelConfig, slot: str, pos,
                      shard=None):
    """One attention layer over a ``(B, S)`` block, token ``j`` at
    position ``pos + j``: all S keys are written into ``c`` in place
    first, then each query attends its own causal prefix."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    qpos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                       device=x.device)[None, :]  # (B, S)
    h = _norm(p, "ln", x, shard)
    q, k, v = _projections(p["attn"], h, h, _sub(shard, "attn"))
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
    if slot in _RING_SLOTS or slot == "mamba":
        raise ValueError(
            f"verify_step does not support {slot!r} slots (ring/SSM "
            f"caches cannot roll back rejected draft tokens)")
    length = c["k"].shape[1]
    idx = torch.clamp_max(qpos, length - 1)
    _write(c["k"], idx, k)
    _write(c["v"], idx, v)
    q_valid = torch.clamp_max(qpos + 1, length)
    o = verify_attention(q, c["k"], c["v"], q_valid=q_valid)
    return _out_proj(o.reshape(b, s, cfg.n_heads * hd), p["attn"],
                     _sub(shard, "attn"))


def _verify_layer(p, c, x, cfg: ModelConfig, slot: str, pos, shard=None):
    x = x + _verify_attn_slot(p, c, x, cfg, slot, pos, shard)
    if slot == "xattn":
        x = _cross_part(p, c, x, cfg, shard)
    return _ffn_part(p, x, cfg, shard)


def verify_step_(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                 pos, shard=None) -> torch.Tensor:
    """A causal block of ``S`` tokens in one forward pass, its keys and
    values written into ``cache`` in place.

    ``tokens[:, j]`` is consumed at position ``pos + j`` and
    ``logits[:, j]`` predicts the token at ``pos + j + 1``: what ``S``
    sequential :func:`decode_step_` calls on the same tokens give, with
    one pass.  Needs full attention caches (:func:`verify_supported`).

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      cache: the decode caches, which the caller owns; the block's ``S``
        keys and values are written into every attention layer's cache.
      tokens: ``(B, S)`` integer tokens.
      pos: a scalar, or ``(B,)`` int32 position of ``tokens[:, 0]``.
      shard: ``None``, or the ``Shard`` of ``params`` (as
        :func:`decode_step_`'s).

    Returns:
      ``logits (B, S, V)``; ``V`` as :func:`decode_step_`'s.
    """
    return _step_(params, cfg, cache, tokens, pos, _verify_layer, shard)


def verify_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos, shard=None) -> Tuple[torch.Tensor, dict]:
    """:func:`verify_step_` on a copy of ``cache``: ``cache`` is left
    unwritten.

    Args:
      params, cfg, cache, tokens, pos, shard: as :func:`verify_step_`'s.

    Returns:
      ``(logits (B, S, V), new_cache)``.
    """
    cache = tree_map(torch.clone, cache)
    return verify_step_(params, cfg, cache, tokens, pos, shard), cache


# ---------------------------------------------------------------------------
# prefill (fills the caches: the serving engine's admission)
# ---------------------------------------------------------------------------

def _prefill_slot(p, x, cfg: ModelConfig, slot: str, positions, enc_out,
                  cache_len: int, impl: str, shard=None):
    """One layer over the whole sequence, and its filled cache."""
    s = x.shape[1]
    if slot == "mamba":
        y, cache = ssm.mamba_prefill(p["mix"], _norm(p, "ln", x, shard),
                                     cfg, shard=_sub(shard, "mix"))
        return _ffn_part(p, x + y, cfg, shard), cache
    # attention slots: the layer hands back its keys and values
    kv = {}
    x, _ = _apply_layer(p, x, cfg, slot, positions, enc_out, impl, shard,
                        keep=kv)
    k, v = kv["k"], kv["v"]
    length = slot_cache_len(cfg, slot, cache_len)
    if s >= length:
        kc, vc = k[:, s - length:], v[:, s - length:]
    else:
        kc = F.pad(k, (0, 0, 0, 0, 0, length - s))
        vc = F.pad(v, (0, 0, 0, 0, 0, length - s))
    cache = {"k": kc, "v": vc}
    if slot == "xattn":
        cache["xk"], cache["xv"] = kv["xk"], kv["xv"]
    return x, cache


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[torch.Tensor] = None, cache_len: int = 0,
            impl: str = "auto", shard=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns filled decode caches.

    Args:
      params: one model's parameter tree.
      cfg: the model configuration.
      tokens: ``(B, S)`` integer tokens (the prompts).
      extra: the whisper encoder's frames or the vlm's patch embeddings
        ``(B, S_enc, d_model)``.
      cache_len: positions of a full attention cache (``0``: ``S``).
      impl: attention path, ``"auto"`` | ``"naive"`` | ``"blockwise"``.
      shard: ``None``, or the ``Shard`` of ``params`` (as
        :func:`decode_step_`'s; attention then splits over ``model`` as
        the training forward's does, ``cfg.attn_shard``).

    Returns:
      ``(logits (B, S, V), cache)`` in :func:`init_cache`'s layout;
      ``V`` as :func:`decode_step_`'s.
    """
    _require_serving(cfg)
    b, s = tokens.shape
    cache_len = cache_len or s
    x = layers.embed(params["embed"], tokens, shard=_sub(shard, "embed"))
    if cfg.arch_type == "audio":
        enc_out = _run_encoder(params, cfg, extra, impl, shard, remat=False)
    elif cfg.arch_type == "vlm":
        enc_out = extra
    else:
        enc_out = None
    positions = torch.arange(s, device=x.device)

    period_caches = []
    periods = params["periods"]
    for i in range(_stack_len(periods)):
        period_p, period_s = _entry(periods, i, _sub(shard, "periods"))
        caches = {}
        for j, slot in enumerate(cfg.layer_pattern):
            x, caches[f"s{j}"] = _prefill_slot(
                period_p[f"s{j}"], x, cfg, slot, positions, enc_out,
                cache_len, impl, _sub(period_s, f"s{j}"))
        period_caches.append(caches)
    tail_caches = {}
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        x, tail_caches[f"t{t}"] = _prefill_slot(
            params["tail"][f"t{t}"], x, cfg, slot, positions, enc_out,
            cache_len, impl, _sub(_sub(shard, "tail"), f"t{t}"))
    return _logits(params, cfg, x, shard), {
        "periods": tree_map(lambda *xs: torch.stack(xs), *period_caches),
        "tail": tail_caches}

"""Model assembly: embeddings, layer periods and the full-sequence forward
(counterpart of ``repro/models/transformer.py``).

The layer stack is grouped into repeating *periods*
(``cfg.layer_pattern``): the parameters of each slot are stacked on a
leading period axis (``periods/s{j}``) and the forward loops over that
axis, as the reference scans it; remainder layers (``tail/t{t}``, when
``n_layers % period != 0``) have their own parameters.  The reference
wraps each period in ``jax.checkpoint``, a memory choice with no effect
on values; the port keeps every activation instead
(``torch.utils.checkpoint`` does not compose with ``torch.func.vmap``).
The serving path (``prefill``, ``decode_step``) is ``models/decode.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.models.attention import attention, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype

__all__ = ["forward", "init_model"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, dtype, lead) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": layers.he_init(gen, (d, cfg.n_heads * hd), dtype, lead=lead),
        "wk": layers.he_init(gen, (d, cfg.n_kv_heads * hd), dtype,
                             lead=lead),
        "wv": layers.he_init(gen, (d, cfg.n_kv_heads * hd), dtype,
                             lead=lead),
        "wo": layers.he_init(gen, (cfg.n_heads * hd, d), dtype,
                             fan_in=cfg.n_heads * hd, lead=lead),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(tuple(lead) + (heads * hd,), dtype=dtype,
                                  device=gen.device)
    return p


def _init_slot(gen, cfg: ModelConfig, slot: str, layer_idx: int, dtype,
               enc: bool = False, lead=()) -> dict:
    d = cfg.d_model
    dev = gen.device
    p: Dict[str, Any] = {"ln": layers.init_rmsnorm(d, dtype, dev, lead)}
    if slot == "mamba":
        p["mix"] = ssm.init_mamba(gen, cfg, dtype, lead=lead)
    else:
        p["attn"] = _init_attn(gen, cfg, dtype, lead)
        if slot == "xattn":
            p["ln_x"] = layers.init_rmsnorm(d, dtype, dev, lead)
            p["xatt"] = _init_attn(gen, cfg, dtype, lead)
    if cfg.d_ff > 0:
        p["ln_f"] = layers.init_rmsnorm(d, dtype, dev, lead)
        act = "gelu" if enc else cfg.ffn_act
        if not enc and cfg.is_moe_layer(layer_idx):
            p["moe"] = moe.init_moe(gen, d, cfg.d_ff, cfg.moe_experts,
                                    cfg.moe_shared, act, dtype, lead=lead)
        else:
            p["ffn"] = layers.init_ffn(gen, d, cfg.d_ff, act, dtype,
                                       lead=lead)
    return p


def init_model(key: Union[int, torch.Generator], cfg: ModelConfig,
               device="cuda") -> dict:
    """Random parameters with the reference's names, shapes and layout.

    Args:
      key: an int seed or a ``torch.Generator`` (whose device then sets
        where the weights are drawn).  The values differ from the
        reference's ``jax.random`` draws; parity tests carry the
        reference's weights across with ``repro_torch.interop``.
      cfg: the model configuration.
      device: where the weights live when ``key`` is a seed (``"cuda"``
        raises when no card is present; ``"meta"`` gives the shapes and
        dtypes without drawing, as the reference's ``eval_shape``).

    Returns:
      The nested parameter dict: ``embed``, ``final_norm``,
      ``lm_head`` (untied), ``periods/s{j}`` (stacked on a leading axis
      of ``max(n_periods, 1)``, as the reference), ``tail/t{t}`` and,
      for an encoder, ``encoder/{layers, final_norm}``.
    """
    if isinstance(key, torch.Generator):
        gen = key
    elif resolve_device(device).type == "meta":
        gen = layers.MetaGenerator()
    else:
        gen = torch.Generator(resolve_device(device)).manual_seed(int(key))
    dev = gen.device
    dtype = _dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(gen, cfg.d_model,
                                               cfg.vocab_size, dtype)
    lead = (max(cfg.n_periods, 1),)
    params["periods"] = {
        f"s{j}": _init_slot(gen, cfg, slot, j, dtype, lead=lead)
        for j, slot in enumerate(cfg.layer_pattern)}
    tail = {}
    for t in range(cfg.n_tail):
        layer_idx = cfg.n_periods * cfg.period + t
        tail[f"t{t}"] = _init_slot(gen, cfg, cfg.slot(layer_idx),
                                   layer_idx, dtype)
    params["tail"] = tail
    if cfg.encoder_layers > 0:
        params["encoder"] = {
            "layers": _init_slot(gen, cfg, "bidir", 0, dtype, enc=True,
                                 lead=(cfg.encoder_layers,)),
            "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        }
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, p: dict, w: str, b: str) -> torch.Tensor:
    y = x @ p[w]
    return y + p[b] if b in p else y


_KINDS = {"attn": "attn", "attn_nope": "attn", "swa": "swa",
          "chunked": "chunked", "bidir": "bidir", "xattn": "attn"}


def _self_attention(p, x, cfg: ModelConfig, slot: str, positions,
                    impl: str) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _proj(x, p, "wq", "bq").reshape(b, s, cfg.n_heads, hd)
    k = _proj(x, p, "wk", "bk").reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(x, p, "wv", "bv").reshape(b, s, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, kind=_KINDS[slot], window=cfg.window,
                  chunk=cfg.chunk, impl=impl)
    return o.reshape(b, s, cfg.n_heads * hd) @ p["wo"]


def _cross_attention(p, x, enc_out, cfg: ModelConfig,
                     impl: str) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    se = enc_out.shape[1]
    q = _proj(x, p, "wq", "bq").reshape(b, s, cfg.n_heads, hd)
    k = _proj(enc_out, p, "wk", "bk").reshape(b, se, cfg.n_kv_heads, hd)
    v = _proj(enc_out, p, "wv", "bv").reshape(b, se, cfg.n_kv_heads, hd)
    o = attention(q, k, v, kind="cross", impl=impl)
    return o.reshape(b, s, cfg.n_heads * hd) @ p["wo"]


def _apply_layer(p, x, cfg: ModelConfig, slot: str, positions, enc_out,
                 impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if slot == "mamba":
        x = x + ssm.mamba_forward(p["mix"], layers.rmsnorm(p["ln"], x), cfg)
    else:
        x = x + _self_attention(p["attn"], layers.rmsnorm(p["ln"], x), cfg,
                                slot, positions, impl)
        if slot == "xattn":
            x = x + _cross_attention(p["xatt"],
                                     layers.rmsnorm(p["ln_x"], x), enc_out,
                                     cfg, impl)
    if "ffn" in p:
        x = x + layers.ffn(p["ffn"], layers.rmsnorm(p["ln_f"], x),
                           cfg.ffn_act)
    elif "moe" in p:
        y, a = moe.moe_ffn(p["moe"], layers.rmsnorm(p["ln_f"], x),
                           top_k=cfg.moe_top_k, act=cfg.ffn_act,
                           capacity_factor=cfg.capacity_factor,
                           impl=cfg.moe_impl)
        x = x + y
        aux = aux + a
    return x, aux


def _stacked(tree, i: int):
    """Entry ``i`` of a tree stacked on a leading axis."""
    return tree_map(lambda a: a[i], tree)


def _stack_len(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                 impl: str) -> torch.Tensor:
    positions = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)
    stack = params["encoder"]["layers"]
    x = enc_embeds
    for i in range(_stack_len(stack)):
        x, _ = _apply_layer(_stacked(stack, i), x, cfg, "bidir", positions,
                            None, impl)
    return layers.rmsnorm(params["encoder"]["final_norm"], x)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[torch.Tensor] = None, impl: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.

    Args:
      params: :func:`init_model`'s tree (or the reference's, carried
        across).
      cfg: the model configuration.
      tokens: ``(B, S)`` integer tokens.
      extra: stubbed modality embeddings ``(B, S_enc, d_model)``: the
        whisper encoder's frame embeddings, or the vlm's patch
        embeddings that ``xattn`` layers attend to.
      impl: attention path, ``"auto"`` | ``"naive"`` | ``"blockwise"``.

    Returns:
      ``(logits (B, S, V), aux_loss scalar fp32)``; logits in
      ``cfg.logits_dtype`` (bf16 casts the final activations and the
      output table), soft-capped when ``cfg.logit_softcap > 0``.
    """
    x = layers.embed(params["embed"], tokens)
    if cfg.arch_type == "audio":
        assert extra is not None, "whisper needs encoder frame embeddings"
        enc_out = _run_encoder(params, cfg, extra, impl)
    elif cfg.arch_type == "vlm":
        assert extra is not None, "vlm needs patch embeddings"
        enc_out = extra
    else:
        enc_out = None

    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    periods = params["periods"]
    for i in range(_stack_len(periods)):
        period_p = _stacked(periods, i)
        for j, slot in enumerate(cfg.layer_pattern):
            x, a = _apply_layer(period_p[f"s{j}"], x, cfg, slot, positions,
                                enc_out, impl)
            aux = aux + a
    for t in range(cfg.n_tail):
        slot = cfg.slot(cfg.n_periods * cfg.period + t)
        x, a = _apply_layer(params["tail"][f"t{t}"], x, cfg, slot,
                            positions, enc_out, impl)
        aux = aux + a

    x = layers.rmsnorm(params["final_norm"], x)
    emb = params.get("lm_head", params["embed"])
    if cfg.logits_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
        emb = tree_map(lambda w: w.to(torch.bfloat16), emb)
    if cfg.tie_embeddings:
        logits = layers.unembed(emb, x)
    else:
        logits = layers.linear(emb, x)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits, aux

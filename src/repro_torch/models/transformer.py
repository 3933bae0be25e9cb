"""Model assembly: embeddings, layer periods and the full-sequence forward
(counterpart of ``repro/models/transformer.py``).

The layer stack is grouped into repeating *periods*
(``cfg.layer_pattern``): the parameters of each slot are stacked on a
leading period axis (``periods/s{j}``) and the forward loops over that
axis, as the reference scans it; remainder layers (``tail/t{t}``, when
``n_layers % period != 0``) have their own parameters.  The reference
wraps each period and tail layer in ``jax.checkpoint``, a memory choice
with no effect on values.  On one device the port keeps every activation
(``torch.utils.checkpoint`` does not compose with the train step's
``torch.func.vmap``); under a ``shard`` (the multi-rank train step, one
worker per ``torch.autograd`` pass) each period, tail layer and encoder
layer runs under ``torch.utils.checkpoint``, as the reference's.

``forward(..., shard=)`` runs the forward on one rank's
``param_shardings`` slices, split over the mesh's ``model`` axis
(``repro_torch.dist.tensor_parallel``): activations whole on every rank
between the layers, the logits this rank's vocabulary columns when the
output table splits on the vocabulary.  Attention follows the
reference's ``_attn_constrain``: with ``cfg.attn_shard == "batch"``
each ``model`` rank attends for ``B / model`` of the sequences, or,
when ``model`` does not divide the batch, for ``S / model`` of every
sequence's queries; otherwise every rank runs the whole attention.
The serving path (``prefill``, ``decode_step``, ``verify_step``, with
the same ``shard=``) is ``models/decode.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.attention import attention, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype

__all__ = ["forward", "init_model", "logits_split"]


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
    elif slot == "mla":
        p["attn"] = mla.init_mla(gen, cfg, dtype, lead)
    else:
        p["attn"] = _init_attn(gen, cfg, dtype, lead)
        if slot == "xattn":
            p["ln_x"] = layers.init_rmsnorm(d, dtype, dev, lead)
            p["xatt"] = _init_attn(gen, cfg, dtype, lead)
    if cfg.d_ff > 0:
        p["ln_f"] = layers.init_rmsnorm(d, dtype, dev, lead)
        act = "gelu" if enc else cfg.ffn_act
        if not enc and cfg.is_moe_layer(layer_idx):
            if cfg.moe_impl == "grouped":
                p["moe"] = moe.init_grouped_moe(gen, cfg, dtype, lead=lead)
            else:
                p["moe"] = moe.init_moe(gen, d, cfg.d_ff, cfg.moe_experts,
                                        cfg.moe_shared, act, dtype,
                                        lead=lead)
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
      ``lm_head`` (untied), ``lead/l{i}`` (the ``n_dense_lead`` leading
      dense layers, when there are any), ``periods/s{j}`` (stacked on a
      leading axis of ``max(n_periods, 1)``, as the reference),
      ``tail/t{t}`` and, for an encoder, ``encoder/{layers,
      final_norm}``.
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
    if cfg.n_dense_lead > 0:
        params["lead"] = {
            f"l{i}": _init_slot(gen, cfg, cfg.slot(i), i, dtype)
            for i in range(cfg.n_dense_lead)}
    lead = (max(cfg.n_periods, 1),)
    params["periods"] = {
        f"s{j}": _init_slot(gen, cfg, slot, cfg.n_dense_lead + j, dtype,
                            lead=lead)
        for j, slot in enumerate(cfg.layer_pattern)}
    tail = {}
    for t in range(cfg.n_tail):
        layer_idx = cfg.n_dense_lead + cfg.n_periods * cfg.period + t
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


def _sub(shard, key):
    """``shard[key]``, or ``None`` without a shard."""
    return None if shard is None else shard[key]


def _projections(p, x: torch.Tensor, kv: torch.Tensor, shard):
    """``q`` from ``x``, ``k`` and ``v`` from ``kv``, each ``(B, S,
    heads * hd)`` whole on every rank.  Under a shard that splits all
    three weights on their contraction dim (and ``x`` is ``kv``), the
    three partial products take one all-reduce."""
    keys = (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))
    if shard is None:
        return [_proj(t, p, w, b) for t, (w, b) in zip((x, kv, kv), keys)]
    if x is kv and all(shard.dim(w) == 0 for w, _ in keys):
        xs = shard.split(x, -1)
        parts = [xs @ p[w] for w, _ in keys]
        out = torch.split(shard.reduce(torch.cat(parts, dim=-1)),
                          [t.shape[-1] for t in parts], dim=-1)
    else:
        out = [shard.matmul(t, p, w) for t, (w, _) in zip((x, kv, kv),
                                                          keys)]
    return [y + shard.get(p, b) if b in p else y
            for y, (_, b) in zip(out, keys)]


_KINDS = {"attn": "attn", "attn_nope": "attn", "swa": "swa",
          "chunked": "chunked", "bidir": "bidir", "xattn": "attn"}


def _attend(q, k, v, cfg: ModelConfig, kind: str, impl: str, shard):
    """``attention`` of whole ``q, k, v``, split over ``model`` as the
    module docstring says; the output whole on every rank."""
    b, s, hq = q.shape[:3]
    hkv = k.shape[2]
    kw = dict(kind=kind, window=cfg.window, chunk=cfg.chunk, impl=impl)
    if shard is None or shard.size == 1 or cfg.attn_shard != "batch":
        return attention(q, k, v, **kw)
    if shard.divides(b):
        q, k, v = torch.split(shard.split(torch.cat([q, k, v], dim=2), 0),
                              [hq, hkv, hkv], dim=2)
        return shard.gather(attention(q, k, v, **kw), 0)
    if shard.divides(s):
        k, v = torch.split(shard.copy(torch.cat([k, v], dim=2)),
                           [hkv, hkv], dim=2)
        o = attention(shard.split(q, 1), k, v,
                      q_offset=shard.index * (s // shard.size), **kw)
        return shard.gather(o, 1)
    return attention(q, k, v, **kw)


def _out_proj(o: torch.Tensor, p: dict, shard) -> torch.Tensor:
    return o @ p["wo"] if shard is None else shard.matmul(o, p, "wo")


def _self_attention(p, x, cfg: ModelConfig, slot: str, positions,
                    impl: str, shard=None,
                    keep: Optional[dict] = None) -> torch.Tensor:
    """Self-attention; ``keep`` (a dict) receives the whole ``k`` (after
    rope) and ``v``, ``(B, S, kv_heads, hd)``: the prefill's cache."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = _projections(p, x, x, shard)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if slot != "attn_nope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if keep is not None:
        keep["k"], keep["v"] = k, v
    o = _attend(q, k, v, cfg, _KINDS[slot], impl, shard)
    return _out_proj(o.reshape(b, s, cfg.n_heads * hd), p, shard)


def _cross_attention(p, x, enc_out, cfg: ModelConfig,
                     impl: str, shard=None,
                     keep: Optional[dict] = None) -> torch.Tensor:
    """Cross-attention over ``enc_out``; ``keep`` receives its ``k`` and
    ``v`` as ``xk`` and ``xv``."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    se = enc_out.shape[1]
    q, k, v = _projections(p, x, enc_out, shard)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, se, cfg.n_kv_heads, hd)
    v = v.reshape(b, se, cfg.n_kv_heads, hd)
    if keep is not None:
        keep["xk"], keep["xv"] = k, v
    o = attention(q, k, v, kind="cross", impl=impl)
    return _out_proj(o.reshape(b, s, cfg.n_heads * hd), p, shard)


def _apply_layer(p, x, cfg: ModelConfig, slot: str, positions, enc_out,
                 impl: str, shard=None,
                 keep: Optional[dict] = None, layer: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: ``(x, aux)`` after it; ``keep`` (a dict) receives an
    attention slot's keys and values (see :func:`_self_attention`);
    ``layer`` is its index, which a grouped expert layer counts its rows
    under."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def norm(key):
        return layers.rmsnorm(p[key], x, shard=_sub(shard, key))

    if slot == "mamba":
        x = x + ssm.mamba_forward(p["mix"], norm("ln"), cfg,
                                  shard=_sub(shard, "mix"))
    elif slot == "mla":
        x = x + mla.mla_attention(p["attn"], norm("ln"), cfg, positions,
                                  impl)
    else:
        x = x + _self_attention(p["attn"], norm("ln"), cfg, slot, positions,
                                impl, _sub(shard, "attn"), keep)
        if slot == "xattn":
            x = x + _cross_attention(p["xatt"], norm("ln_x"), enc_out, cfg,
                                     impl, _sub(shard, "xatt"), keep)
    if "ffn" in p:
        x = x + layers.ffn(p["ffn"], norm("ln_f"), cfg.ffn_act,
                           shard=_sub(shard, "ffn"))
    elif "moe" in p and cfg.moe_impl == "grouped":
        y, a = moe.grouped_moe_ffn(p["moe"], norm("ln_f"), cfg, layer)
        x = x + y
        aux = aux + a
    elif "moe" in p:
        y, a = moe.moe_ffn(p["moe"], norm("ln_f"), top_k=cfg.moe_top_k,
                           act=cfg.ffn_act,
                           capacity_factor=cfg.capacity_factor,
                           impl=cfg.moe_impl, shard=_sub(shard, "moe"))
        x = x + y
        aux = aux + a
    return x, aux


def _stacked(tree, i: int):
    """Entry ``i`` of a tree stacked on a leading axis."""
    return tree_map(lambda a: a[i], tree)


def _entry(tree, i: int, shard):
    """Entry ``i`` of a stacked tree and its shard (``None``)."""
    if shard is None:
        return _stacked(tree, i), None
    return shard.entry(tree, i)


def _stack_len(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _run(fn, shard, *args):
    """``fn(*args)``; under a shard with its activations recomputed in
    the backward (the reference's ``jax.checkpoint``)."""
    if shard is None:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                 impl: str, shard=None, remat: bool = True) -> torch.Tensor:
    """The encoder stack; under a shard with each layer's activations
    recomputed in the backward unless ``remat`` is off (serving runs no
    backward)."""
    positions = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)
    stack = params["encoder"]["layers"]
    enc = _sub(shard, "encoder")
    x = enc_embeds
    for i in range(_stack_len(stack)):
        lp, ls = _entry(stack, i, _sub(enc, "layers"))
        x, _ = _run(_apply_layer, shard if remat else None, lp, x, cfg,
                    "bidir", positions, None, impl, ls)
    return layers.rmsnorm(params["encoder"]["final_norm"], x,
                          shard=_sub(enc, "final_norm"))


def _period(period_p, x, aux, cfg: ModelConfig, positions, enc_out,
            impl: str, shard, layer0: int):
    """One period's layers: ``(x, aux)`` after them; ``layer0`` is the
    index of its first layer."""
    for j, slot in enumerate(cfg.layer_pattern):
        x, a = _apply_layer(period_p[f"s{j}"], x, cfg, slot, positions,
                            enc_out, impl, _sub(shard, f"s{j}"),
                            layer=layer0 + j)
        aux = aux + a
    return x, aux


def logits_split(cfg: ModelConfig, shard) -> bool:
    """Whether the logits under ``shard`` are this rank's vocabulary
    columns (the output table splits on the vocabulary), ``[index * V /
    model, (index + 1) * V / model)`` of the whole; else they are whole
    on every rank."""
    if shard is None or shard.size == 1:
        return False
    if cfg.tie_embeddings:
        return shard["embed"].dim("table") == 0
    return shard["lm_head"].dim("w") == 1


def _head(emb: dict, x: torch.Tensor, cfg: ModelConfig,
          shard) -> torch.Tensor:
    """The output projection of the final activations through ``emb``
    (the tied embedding or ``lm_head``), soft-capped; this rank's
    vocabulary columns when :func:`logits_split`, never gathered."""
    if cfg.tie_embeddings:
        logits = layers.unembed(emb, x, shard=_sub(shard, "embed"))
    elif logits_split(cfg, shard):
        logits = shard.copy(x) @ emb["w"]
    else:
        logits = layers.linear(emb, x, shard=_sub(shard, "lm_head"))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[torch.Tensor] = None, impl: str = "auto",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
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
      shard: ``None`` on one device, or the
        ``repro_torch.dist.tensor_parallel.Shard`` of ``params`` (then
        this rank's ``param_shardings`` slices; see the module
        docstring).

    Returns:
      ``(logits (B, S, V), aux_loss scalar fp32)``; logits in
      ``cfg.logits_dtype`` (bf16 casts the final activations and the
      output table), soft-capped when ``cfg.logit_softcap > 0``.  Under
      a shard whose output table splits on the vocabulary, ``V`` is this
      rank's columns, ``[index * V, (index + 1) * V)`` of the whole.
    """
    if shard is not None and cfg.unsupported("mesh"):
        raise NotImplementedError(cfg.unsupported("mesh"))
    x = layers.embed(params["embed"], tokens, shard=_sub(shard, "embed"))
    if cfg.arch_type == "audio":
        assert extra is not None, "whisper needs encoder frame embeddings"
        enc_out = _run_encoder(params, cfg, extra, impl, shard)
    elif cfg.arch_type == "vlm":
        assert extra is not None, "vlm needs patch embeddings"
        enc_out = extra
    else:
        enc_out = None

    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_dense_lead):
        x, a = _apply_layer(params["lead"][f"l{i}"], x, cfg, cfg.slot(i),
                            positions, enc_out, impl, layer=i)
        aux = aux + a
    periods = params["periods"]
    first = cfg.n_dense_lead
    for i in range(_stack_len(periods)):
        period_p, period_s = _entry(periods, i, _sub(shard, "periods"))
        x, aux = _run(_period, shard, period_p, x, aux, cfg, positions,
                      enc_out, impl, period_s, first + i * cfg.period)
    for t in range(cfg.n_tail):
        layer = first + cfg.n_periods * cfg.period + t
        x, a = _run(_apply_layer, shard, params["tail"][f"t{t}"], x, cfg,
                    cfg.slot(layer), positions, enc_out, impl,
                    _sub(_sub(shard, "tail"), f"t{t}"), None, layer)
        aux = aux + a

    x = layers.rmsnorm(params["final_norm"], x,
                       shard=_sub(shard, "final_norm"))
    head = "embed" if cfg.tie_embeddings else "lm_head"
    emb = params[head]
    if cfg.logits_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
        emb = tree_map(lambda w: w.to(torch.bfloat16), emb)
    return _head(emb, x, cfg, shard), aux

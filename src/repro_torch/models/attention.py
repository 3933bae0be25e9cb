"""Attention (counterpart of ``repro/models/attention.py``): GQA / MQA
with RoPE, full /
sliding-window / chunked-local / bidirectional / cross variants, a naive
einsum path and a blockwise (flash-style, online-softmax) path.

Shapes: q ``(B, Sq, Hq, D)``; k, v ``(B, Sk, Hkv, D)`` with
``Hq = G * Hkv``.  Softmax statistics are fp32 whatever the input dtype;
scores of bf16 inputs are products taken in fp32, as the reference's
``preferred_element_type=float32``.  The serving half,
:func:`decode_attention` (one new token against a KV cache) and
:func:`verify_attention` (a causal block of new tokens, the
speculative-verify path), are plain products too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "attention", "attention_blockwise",
           "attention_naive", "decode_attention", "rope",
           "verify_attention"]

NEG_INF = -1e30


# -- RoPE ---------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form: the first and second halves of
    the head dim rotate as one complex pair per frequency.

    Args:
      x: ``(..., S, H, D)``.
      positions: ``(S,)`` (or broadcastable) integer positions.
      theta: the RoPE base.

    Returns:
      ``x`` rotated, in ``x``'s dtype (the rotation runs in fp32).
    """
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs      # (S, half)
    cos = torch.cos(ang)[..., None, :]                        # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# -- masks --------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str,
               window: int, chunk: int) -> torch.Tensor:
    """``(Sq, Sk)`` additive fp32 bias: 0 where attendable, NEG_INF
    elsewhere."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    if kind in ("bidir", "cross"):
        ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                        device=q_pos.device)
    else:
        ok = kp <= qp  # causal
        if kind == "swa" and window > 0:
            ok = ok & ((qp - kp) < window)
        elif kind == "chunked" and chunk > 0:
            ok = ok & (torch.div(qp, chunk, rounding_mode="floor")
                       == torch.div(kp, chunk, rounding_mode="floor"))
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


# -- naive path ---------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """-> ``(B, Hkv, G, Sq, Sk)`` fp32 scores."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                        k.to(torch.float32))


def _sqrt_d(d: int, device) -> torch.Tensor:
    """``sqrt(d)`` rounded to fp32, as ``jnp.sqrt(d)``."""
    # torch.full, not torch.tensor: a traced ``meta`` step (the launch
    # harness's dry-run) cannot build a tensor from host data
    return torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                 device=device))


def attention_naive(q, k, v, *, kind: str = "attn", window: int = 0,
                    chunk: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Materialized-scores attention.

    Args:
      q: ``(B, Sq, Hq, D)`` queries.
      k: ``(B, Sk, Hkv, D)`` keys.
      v: ``(B, Sk, Hkv, D)`` values.
      kind: ``"attn"`` (causal), ``"swa"``, ``"chunked"``, ``"bidir"`` or
        ``"cross"``.
      window: the ``swa`` window.
      chunk: the ``chunked`` span.
      q_offset: position of the first query.

    Returns:
      ``(B, Sq, Hq, D)`` in ``v``'s dtype.
    """
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    scores = _gqa_scores(q, k) / _sqrt_d(d, q.device)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    bias = _mask_bias(q_pos, k_pos, kind, window, chunk)
    scores = scores + bias[None, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


# -- blockwise (flash-style) path --------------------------------------------

def attention_blockwise(q, k, v, *, kind: str = "attn", window: int = 0,
                        chunk: int = 0, q_offset: int = 0,
                        block_q: int = 1024,
                        block_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention with ``O(block_q * block_k)`` live scores.

    A static loop over q blocks; for the causal and local kinds the k
    blocks a q block can never attend to are skipped (block sparsity for
    sliding-window and chunked layouts), as in the reference.

    Args:
      q, k, v, kind, window, chunk, q_offset: as :func:`attention_naive`
        (``q_offset`` a Python int).
      block_q: queries per block.
      block_k: keys per block.

    Returns:
      ``(B, Sq, Hq, D)`` in ``q``'s dtype.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    pad_q = (-sq) % block_q
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    pad_k = (-sk) % block_k
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq = q.shape[1] // block_q
    nk = k.shape[1] // block_k
    scale = 1.0 / float(d) ** 0.5
    dev = q.device

    outs = []
    for iq in range(nq):
        qb = q[:, iq * block_q:(iq + 1) * block_q].reshape(
            b, block_q, hkv, g, d).to(torch.float32)
        q_pos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        lo_blk, hi_blk = 0, nk
        if kind in ("attn", "swa", "chunked"):
            q_lo = q_offset + iq * block_q
            q_hi = q_offset + (iq + 1) * block_q - 1
            hi_blk = min(nk, (q_hi // block_k) + 1)           # causal
            if kind == "swa" and window > 0:
                lo_blk = max(0, (q_lo - window + 1) // block_k)
            elif kind == "chunked" and chunk > 0:
                lo_blk = max(0, ((q_lo // chunk) * chunk) // block_k)
        if hi_blk - lo_blk <= 0:
            outs.append(torch.zeros((b, block_q, hq, d), dtype=q.dtype,
                                    device=dev))
            continue
        m = torch.full((b, block_q, hkv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, block_q, hkv, g), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, block_q, hkv, g, d), dtype=torch.float32,
                          device=dev)
        for ik in range(lo_blk, hi_blk):
            kb = k[:, ik * block_k:(ik + 1) * block_k]
            vb = v[:, ik * block_k:(ik + 1) * block_k]
            k_pos = ik * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb,
                             kb.to(torch.float32)) * scale
            bias = _mask_bias(q_pos, k_pos, kind, window, chunk)
            s = s + bias[None, :, None, None, :]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vb.dtype), vb).to(torch.float32)
            m = m_new
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(o.reshape(b, block_q, hq, d).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def attention(q, k, v, *, kind: str = "attn", window: int = 0,
              chunk: int = 0, q_offset: int = 0,
              impl: str = "auto") -> torch.Tensor:
    """Attention through ``impl``: ``"naive"``, ``"blockwise"`` or
    ``"auto"`` (blockwise once either sequence exceeds 8192, as the
    reference decides)."""
    if impl == "auto":
        impl = ("blockwise" if max(q.shape[1], k.shape[1]) > 8192
                else "naive")
    fn = attention_blockwise if impl == "blockwise" else attention_naive
    return fn(q, k, v, kind=kind, window=window, chunk=chunk,
              q_offset=q_offset)


# -- decode (single new token against a cache) --------------------------------

def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Queries ``(B, Sq, Hq, D)`` against ``(B, L, Hkv, D)`` caches;
    ``mask`` is ``(B, Sq, L)`` (True = attendable) or ``None``."""
    b, sq, hq, d = q.shape
    scores = _gqa_scores(q, k_cache) / _sqrt_d(d, q.device)
    if mask is not None:
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
        scores = torch.where(mask[:, None, None, :, :], scores, neg)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, sq, hq, d)


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One new token's queries against a KV cache.

    Args:
      q1: ``(B, 1, Hq, D)`` queries.
      k_cache: ``(B, S, Hkv, D)`` keys.
      v_cache: ``(B, S, Hkv, D)`` values.
      valid_len: ``(B,)`` count of leading cache entries each sequence
        attends to (``None``: the whole cache).

    Returns:
      ``(B, 1, Hq, D)`` in ``v_cache``'s dtype; scores in fp32, scaled by
      ``sqrt(D)`` rounded to fp32, masked entries at ``NEG_INF``.
    """
    mask = None
    if valid_len is not None:
        s = k_cache.shape[1]
        mask = (torch.arange(s, device=q1.device)[None, :]
                < valid_len[:, None])[:, None, :]              # (B, 1, S)
    return _cached_attention(q1, k_cache, v_cache, mask)


# -- verify (a block of new tokens against a cache, causal) --------------------

def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     q_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-query decode attention for speculative verify blocks.

    Each query ``j`` attends to the first ``q_valid[:, j]`` cache
    entries (the block's own keys must already be in the cache).  At
    ``Sq = 1`` with ``q_valid = valid_len[:, None]`` this is
    :func:`decode_attention` bit for bit: both run the same products on
    the same mask.

    Args:
      q: ``(B, Sq, Hq, D)`` queries of a block of ``Sq`` new tokens.
      k_cache: ``(B, L, Hkv, D)`` keys.
      v_cache: ``(B, L, Hkv, D)`` values.
      q_valid: ``(B, Sq)`` per-query causal prefix lengths (``None``:
        the whole cache, the cross-attention case).

    Returns:
      ``(B, Sq, Hq, D)`` in ``v_cache``'s dtype.
    """
    mask = None
    if q_valid is not None:
        s = k_cache.shape[1]
        mask = (torch.arange(s, device=q.device)[None, None, :]
                < q_valid[:, :, None])                         # (B, Sq, S)
    return _cached_attention(q, k_cache, v_cache, mask)

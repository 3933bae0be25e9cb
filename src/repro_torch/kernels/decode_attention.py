"""Decode attention over a KV cache, read where it lies: the queries of a
few new tokens per slot against that slot's cache, each up to its valid
length (``models/attention.py::decode_attention`` and
``verify_attention``, the serving steps' cached attention).

No counterpart in the JAX package (its ``decode_attention`` is plain
``jnp``): the port's own kernel, added because the plain path's
``einsum``\\ s copy K and V into ``(b, h, k, d)`` order and read every
position of the cache.  The CUDA source is
``repro_torch/csrc/decode_attention.cu``: fp32 FFMA (TF32 off, as the
configurations run), 16-byte ``cp.async`` tiles of one KV head's rows
shared by all of its ``G x Sq`` queries, an online softmax, nothing read
past the largest valid length of a block's queries.  What bounds it on
an H100: the K/V bytes up to the valid lengths at 3.35 TB/s.

One ``torch.library`` custom op,

  ``repro_torch::decode_attention(q, k, v, valid)``
      q ``(N, B, Sq, Hq, D)``, k and v ``(N, B, L, Hkv, D)``, valid
      ``(N, B, Sq)`` integers: query ``j`` of row ``(n, b)`` attends to
      the first ``valid[n, b, j]`` positions of that row's cache ->
      ``(N, B, Sq, Hq, D)`` in v's dtype.

Its two leading batch axes (a replica and a slot) are read through
their strides, so a period view of the replica-stacked cache leaf
``(R, P, B, L, H, D)`` goes in as it lies, with no copy.  Its ``vmap``
rule folds the vmapped axis into the first batch axis (a view), so the
robust steps' ``torch.func.vmap`` over replicas makes one launch for
every replica; a cache whose strides allow no such view is refused
(every caller passes one entry on that axis, which always folds).  A CPU tensor takes the plain path (the oracle:
``models/attention.py``'s ``einsum`` body, once per entry of the first
axis), a CUDA tensor the kernel (or raises), a ``meta`` tensor an empty
result and one launch counted (the launch harness's dry-run).

The kernel splits the length into pieces of ``_split_len(L)``
positions, chosen from ``L`` alone, and combines them in a second,
fixed-order pass: every row is computed the same way whatever the
number of rows, so a replica run alone and run among the ensemble agree
bit for bit.  A valid length is clamped to ``[0, L]``; every caller
passes at least 1 (a query with none gets 0 from the kernel, and the
mean of the values from the plain path).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_gemm import _front

__all__ = ["cached_attention", "decode_attention_plain"]

#: head dims the kernel is built for
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: positions of one piece of the length, at most this many pieces
_PIECE, _MAX_PIECES = 256, 64
#: at most this many queries of a KV head share a block
_MAX_QUERIES = 64


def _split_len(length: int) -> int:
    """Positions per piece: 256, or a multiple of it that keeps the
    pieces at most 64 (from ``L`` alone, so from the shapes alone)."""
    return _PIECE * -(-length // (_PIECE * _MAX_PIECES))


def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                           valid: Tensor) -> Tensor:
    """The oracle: ``models/attention.py``'s ``einsum`` path on each
    entry of the first axis, its mask from ``valid``.

    Args:
      q: ``(N, B, Sq, Hq, D)`` queries.
      k, v: ``(N, B, L, Hkv, D)`` keys and values.
      valid: ``(N, B, Sq)`` valid lengths.

    Returns:
      ``(N, B, Sq, Hq, D)`` in ``v``'s dtype.
    """
    # imported here: models.attention imports this module
    from repro_torch.models.attention import _cached_attention
    pos = torch.arange(k.shape[2], device=q.device)
    return torch.stack([
        _cached_attention(q[i], k[i], v[i],
                          pos[None, None, :] < valid[i][:, :, None])
        for i in range(q.shape[0])])


def _check(q: Tensor, k: Tensor, v: Tensor, valid: Tensor) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 5 or k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q (N, B, Sq, Hq, D) and k, "
                         f"v (N, B, L, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    n, b, sq, hq, d = q.shape
    hkv = k.shape[3]
    if (k.shape[:2] != q.shape[:2] or k.shape[4] != d
            or hkv == 0 or hq % hkv or valid.shape != (n, b, sq)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and valid {tuple(valid.shape)} "
                         f"do not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    vec = 16 // k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride()[2:] != (hkv * d, d, 1):
            raise ValueError(f"decode_attention reads the cache where it "
                             f"lies: {name}'s (L, Hkv, D) must be dense, "
                             f"got strides {t.stride()}")
        if t.data_ptr() % 16 or t.stride(0) % vec or t.stride(1) % vec:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             f"aligned in its rows (pointer and leading "
                             f"strides)")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention(q: Tensor, k: Tensor, v: Tensor,
                      valid: Tensor) -> Tensor:
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, valid)
    n, b, sq, hq, d = q.shape
    length, hkv = k.shape[2], k.shape[3]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if length == 0:
        return out.zero_()
    if q.stride()[2:] != (hq * d, d, 1):
        q = q.contiguous()  # the queries, never the cache
    lens = valid.to(torch.int32).contiguous()
    split_len = _split_len(length)
    splits = -(-length // split_len)
    qn = hq // hkv * sq
    qper = min(qn, _MAX_QUERIES, 8192 // d)
    qgroups = -(-qn // qper)
    part = (torch.empty(n * b * hkv * qn * splits * (d + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    lib = _build.library("decode_attention")
    _build.check(lib.decode_attention_run(
        int(q.dtype == torch.bfloat16), q.data_ptr(), q.stride(0),
        q.stride(1), k.data_ptr(), k.stride(0), k.stride(1), v.data_ptr(),
        v.stride(0), v.stride(1), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), n, b, sq, hq, hkv,
        length, d, split_len, splits, qgroups, qper, _build.stream_of(q)),
        "decode_attention")
    _build.count("decode_attention")
    return out


@_decode_attention.register_fake
def _(q, k, v, valid):
    if q.device.type == "meta":
        _build.count("decode_attention")
    return q.new_empty(q.shape, dtype=v.dtype)


def _folded(t: Tensor) -> Tensor:
    """The first two axes as one, as a view (never a copy of a cache)."""
    try:
        return t.view((-1,) + tuple(t.shape[2:]))
    except RuntimeError:
        raise ValueError(f"decode_attention under vmap reads the cache "
                         f"where it lies: its vmapped axis and first batch "
                         f"axis (sizes {tuple(t.shape[:2])}, strides "
                         f"{t.stride()[:2]}) do not fold into one") from None


def _decode_attention_vmap(info, in_dims, q, k, v, valid):
    size = info.batch_size
    q, k, v, valid = (_front(t, dim, size)
                      for t, dim in zip((q, k, v, valid), in_dims))
    kf, vf = _folded(k), _folded(v)
    out = _decode_attention(q.reshape(kf.shape[:2] + q.shape[3:]), kf, vf,
                            valid.reshape(kf.shape[:2] + valid.shape[3:]))
    return out.view(q.shape[:2] + out.shape[1:]), 0


torch.library.register_vmap("repro_torch::decode_attention",
                            _decode_attention_vmap)


def cached_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     valid: Optional[Tensor] = None) -> Tensor:
    """Queries against KV caches through the op.

    Args:
      q: ``(B, Sq, Hq, D)`` queries.
      k_cache, v_cache: ``(B, L, Hkv, D)`` keys and values.
      valid: ``(B, Sq)`` per-query valid lengths (``None``: all ``L``).

    Returns:
      ``(B, Sq, Hq, D)`` in ``v_cache``'s dtype.
    """
    if valid is None:
        valid = torch.full(q.shape[:2], k_cache.shape[1], dtype=torch.int32,
                           device=q.device)
    return _decode_attention(q[None], k_cache[None], v_cache[None],
                             valid[None])[0]

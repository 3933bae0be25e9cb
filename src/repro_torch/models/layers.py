"""Primitive layers: norms, linear, embedding, FFN (counterpart of
``repro/models/layers.py``).

Pure-function style, as the reference: ``init_*`` builds a parameter
dict, the layer itself is a plain function of that dict, so
``torch.func`` can differentiate a nested dict of tensors per worker.
Weights are ``(in, out)`` as in the reference (``x @ w``), so a
reference parameter crosses over without a transpose.  Initializers draw
from an explicit ``torch.Generator`` on the device the weights go to;
``lead`` prepends stacking axes (the transformer's period axis), with
fan-in read from the unstacked shape as the reference's ``vmap``-ed
initializers do.

Each layer takes an optional ``shard`` (a
``repro_torch.dist.tensor_parallel.Shard`` of its parameter dict): its
weights are then one rank's slices split over a mesh's ``model`` axis,
its input and output are whole on every rank, and the collectives run
inside; ``shard=None`` is the one-device layer.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["MetaGenerator", "embed", "ffn", "he_init", "init_embedding",
           "init_ffn", "init_linear", "init_rmsnorm", "linear", "rmsnorm",
           "unembed"]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where weights are built on the
    ``meta`` device: shapes and dtypes only, nothing drawn (a
    ``torch.Generator`` cannot live there)."""

    device = torch.device("meta")


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def he_init(gen: torch.Generator, shape, dtype,
            fan_in: Optional[int] = None, lead: Tuple[int, ...] = ()
            ) -> torch.Tensor:
    """Standard normal over ``sqrt(fan_in)``.

    Args:
      gen: the generator (its device is where the weight is drawn).
      shape: the unstacked weight shape; fan-in defaults to ``shape[0]``.
      dtype: the weight's dtype.
      fan_in: explicit fan-in.
      lead: stacking axes prepended to ``shape``.

    Returns:
      A ``lead + shape`` tensor.
    """
    fan = fan_in if fan_in is not None else shape[0]
    return (_normal(gen, tuple(lead) + tuple(shape))
            / math.sqrt(fan)).to(dtype)


# -- rmsnorm -----------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device=None,
                 lead: Tuple[int, ...] = ()) -> dict:
    """``{"scale": ones(lead + (d,))}``."""
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6,
            shard=None) -> torch.Tensor:
    """RMSNorm computed in fp32 (``rsqrt`` of the mean square), cast back
    to ``x``'s dtype (under a shard the scale is gathered on use)."""
    scale = p["scale"] if shard is None else shard.get(p, "scale")
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# -- linear ------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, lead: Tuple[int, ...] = ()) -> dict:
    """``{"w": (d_in, d_out)[, "b": zeros]}``."""
    p = {"w": he_init(gen, (d_in, d_out), dtype, lead=lead)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor, shard=None) -> torch.Tensor:
    """``x @ w (+ b)`` (under a shard whole on every rank, the bias added
    once after the product's collective)."""
    if shard is None:
        y = x @ p["w"]
        return y + p["b"] if "b" in p else y
    y = shard.matmul(x, p, "w")
    return y + shard.get(p, "b") if "b" in p else y


# -- embedding ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   lead: Tuple[int, ...] = ()) -> dict:
    """``{"table": (vocab, d)}``, normal times 0.02."""
    return {"table": (_normal(gen, tuple(lead) + (vocab, d))
                      * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor, shard=None) -> torch.Tensor:
    """Row lookup: ``(..., )`` int tokens -> ``(..., d)``.  A table split
    on the vocabulary looks up its own rows (zeros for the others'
    tokens), then all-reduces: each token's row comes from one rank, so
    the sum is that row bit for bit."""
    tokens = tokens.long()
    d = None if shard is None else shard.dim("table")
    if d is None:
        return p["table"][tokens]
    table = p["table"]
    if d == 1:
        return shard.gather(table[tokens], -1)
    rows = table.shape[0]
    local = tokens - shard.index * rows
    mine = (local >= 0) & (local < rows)
    out = table[torch.clamp(local, 0, rows - 1)]
    return shard.reduce(torch.where(mine[..., None], out,
                                    torch.zeros_like(out)))


def unembed(p: dict, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Tied output projection ``x @ table.T``.  Under a shard whose table
    is split on the vocabulary: this rank's vocabulary columns of the
    logits, never gathered (the loss is vocabulary-parallel)."""
    table = p["table"].to(x.dtype)
    d = None if shard is None else shard.dim("table")
    if d is None:
        return x @ table.T
    if d == 0:
        return shard.copy(x) @ table.T
    return shard.reduce(shard.split(x, -1) @ table.T)


# -- dense FFN ---------------------------------------------------------------

def init_ffn(gen: torch.Generator, d: int, d_ff: int, act: str, dtype,
             lead: Tuple[int, ...] = ()) -> dict:
    """Gated (``swiglu`` / ``geglu``: ``wi``, ``wg``, ``wo``) or plain
    (``gelu``: ``wi``, ``wo``) FFN weights."""
    if act in ("swiglu", "geglu"):
        return {"wi": he_init(gen, (d, d_ff), dtype, lead=lead),
                "wg": he_init(gen, (d, d_ff), dtype, lead=lead),
                "wo": he_init(gen, (d_ff, d), dtype, lead=lead)}
    return {"wi": he_init(gen, (d, d_ff), dtype, lead=lead),
            "wo": he_init(gen, (d_ff, d), dtype, lead=lead)}


def ffn(p: dict, x: torch.Tensor, act: str, shard=None) -> torch.Tensor:
    """The FFN; weights with a leading expert axis run batched over it
    (``x`` then carries the same leading axis).  ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu(approximate=True)``.

    Under a shard whose ``wi`` (and ``wg``) split on their output dim and
    ``wo`` on its contraction dim, the hidden units stay split from the
    first products to the last (one all-reduce forward, one backward);
    any other layout takes each product whole (``Shard.matmul``)."""
    def local(h, key):
        return h @ p[key]

    if shard is None:
        return _ffn_body(local, x, act)
    nd = p["wi"].dim()
    if shard.dim("wo") == nd - 2 and all(
            shard.dim(k) == nd - 1 for k in ("wi", "wg") if k in p):
        return shard.reduce(_ffn_body(local, shard.copy(x), act))
    return _ffn_body(lambda h, key: shard.matmul(h, p, key), x, act)


def _ffn_body(mm, x: torch.Tensor, act: str) -> torch.Tensor:
    """The FFN's activations around ``mm(input, weight key)``."""
    if act == "swiglu":
        h = F.silu(mm(x, "wg")) * mm(x, "wi")
    elif act == "geglu":
        h = F.gelu(mm(x, "wg"), approximate="tanh") * mm(x, "wi")
    else:
        h = F.gelu(mm(x, "wi"), approximate="tanh")
    return mm(h, "wo")

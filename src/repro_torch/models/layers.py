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


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 (``rsqrt`` of the mean square), cast back
    to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# -- linear ------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, lead: Tuple[int, ...] = ()) -> dict:
    """``{"w": (d_in, d_out)[, "b": zeros]}``."""
    p = {"w": he_init(gen, (d_in, d_out), dtype, lead=lead)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- embedding ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   lead: Tuple[int, ...] = ()) -> dict:
    """``{"table": (vocab, d)}``, normal times 0.02."""
    return {"table": (_normal(gen, tuple(lead) + (vocab, d))
                      * 0.02).to(dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup: ``(..., )`` int tokens -> ``(..., d)``."""
    return p["table"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection ``x @ table.T``."""
    return x @ p["table"].T.to(x.dtype)


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


def ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The FFN; weights with a leading expert axis run batched over it
    (``x`` then carries the same leading axis).  ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu(approximate=True)``."""
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif act == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]

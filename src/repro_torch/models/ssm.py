"""Mamba-2 (SSD, state-space duality) mixer (counterpart of
``repro/models/ssm.py``).

The chunked SSD algorithm of the Mamba-2 paper (arXiv:2405.21060,
Listing 1): inside a chunk the recurrence runs in its "attention dual"
form (a causally masked ``(Q, Q)`` score matmul); across chunks a short
loop carries the ``(H, N, P)`` state.  Serving prefills with the same
chunked form (:func:`mamba_prefill` keeps the final state and the conv
history) and decodes one token at a time with the exact recurrent form
(:func:`mamba_decode_step`), whose state has a constant size.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

__all__ = ["init_mamba", "init_mamba_cache", "mamba_decode_step",
           "mamba_forward", "mamba_prefill", "ssd_chunked",
           "ssd_recurrent_step"]


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive running sums along ``dim``, added one step at a time in
    ``x``'s dtype.  ``torch.cumsum`` of fp32 accumulates in float64 on
    the CPU and rounds each prefix once, so the CPU and the card would
    disagree in the last bits; this form gives fp32 sums in order on
    both."""
    steps = torch.unbind(x, dim=dim)
    acc = [steps[0]]
    for s in steps[1:]:
        acc.append(acc[-1] + s)
    return torch.stack(acc, dim=dim)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                chunk: int = 128, return_final_state: bool = False):
    """The SSM ``h' = exp(dt A) h + dt B x``, ``y = C h`` by chunks.

    Args:
      x: ``(b, s, h, p)`` inputs.
      dt: ``(b, s, h)`` positive step sizes.
      A: ``(h,)`` negative decay rates.
      B: ``(b, s, n)`` input projections.
      C: ``(b, s, n)`` output projections.
      chunk: chunk length; ``s`` is padded up to a multiple (a padded
        step has dt = 0: decay 1, increment 0, so the final state is
        unchanged by the padding).
      return_final_state: also return the state after the last step.

    Returns:
      ``y``: ``(b, s, h, p)``, and the final ``(b, h, n, p)`` state
      when ``return_final_state``.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    da = dtc * A[None, None, None, :]                  # (b,nc,q,h), negative
    seg = _prefix_sum(da, dim=2)                       # inclusive prefix
    xd = xc * dtc[..., None]                           # dt-weighted input

    # --- intra-chunk (the "attention dual") -------------------------------
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)       # (b,nc,q,q)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # mask the exponent before exp: the non-causal entries' exponents are
    # positive and their exp overflows, and where(mask, exp, 0) would
    # still send 0 * inf = NaN through the backward pass
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    diff = torch.where(causal[None, None, :, :, None], diff,
                       torch.full((), -1e30, dtype=diff.dtype,
                                  device=x.device))
    scores = cb[..., None] * torch.exp(diff)           # (b,nc,l,s,h)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xd)

    # --- chunk boundary states --------------------------------------------
    seg_end = seg[:, :, -1:, :]                        # (b,nc,1,h)
    decay_to_end = torch.exp(seg_end - seg)            # (b,nc,q,h)
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", decay_to_end, Bc, xd)
    chunk_decay = torch.exp(seg_end[:, :, 0, :])       # (b,nc,h)

    # --- inter-chunk recurrence -------------------------------------------
    hprev = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    carried = []
    for c in range(nc):
        carried.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    hstack = torch.stack(carried, dim=1)               # (b,nc,h,n,p)

    y_inter = torch.einsum("bclh,bcln,bchnp->bclhp", torch.exp(seg), Cc,
                           hstack)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    if return_final_state:
        return y, hprev
    return y


def ssd_recurrent_step(state: torch.Tensor, x1: torch.Tensor,
                       dt1: torch.Tensor, A: torch.Tensor, B1: torch.Tensor,
                       C1: torch.Tensor):
    """One decode step of the SSM in its recurrent form.

    Args:
      state: ``(b, h, n, p)`` carried state.
      x1: ``(b, h, p)`` input.
      dt1: ``(b, h)`` step sizes.
      A: ``(h,)`` decay rates.
      B1: ``(b, n)`` input projection.
      C1: ``(b, n)`` output projection.

    Returns:
      ``(new_state (b, h, n, p), y (b, h, p))``.
    """
    decay = torch.exp(dt1 * A[None, :])                # (b,h)
    inc = torch.einsum("bn,bhp->bhnp", B1, x1 * dt1[..., None])
    new_state = state * decay[:, :, None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", C1, new_state)
    return new_state, y


# ---------------------------------------------------------------------------
# the mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """The block's parameters, with the reference's names and shapes."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = d_in + 2 * n
    lead = tuple(lead)
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        "in_proj": layers.he_init(gen, (d, 2 * d_in + 2 * n + h), dtype,
                                  lead=lead),
        "conv_w": (layers._normal(gen, lead + (cfg.ssm_conv, conv_ch))
                   * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (h,)).clone(),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32,
                               device=dev),
        "norm": layers.init_rmsnorm(d_in, dtype, device=dev, lead=lead),
        "out_proj": layers.he_init(gen, (d_in, d), dtype, lead=lead),
    }


def _split_proj(proj: torch.Tensor, d_in: int, n: int, h: int):
    """``in_proj``'s output -> ``(z, xBC, dt)``."""
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _mamba_sequence(p: dict, x: torch.Tensor, cfg, chunk: int):
    """The block over a whole sequence: ``(out (B, S, D), xBC (B, S,
    C), final SSM state)``."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    n, h, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, d_in, n, h)

    # causal depthwise conv over the (x, B, C) channels
    k = p["conv_w"].shape[0]
    xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = xbc_pad[:, 0:s] * p["conv_w"][0][None, None, :]
    for i in range(1, k):
        conv = conv + xbc_pad[:, i:i + s] * p["conv_w"][i][None, None, :]
    conv = F.silu(conv + p["conv_b"])

    xs = conv[..., :d_in].reshape(b, s, h, hd)
    B_ = conv[..., d_in:d_in + n]
    C_ = conv[..., d_in + n:]

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, h_final = ssd_chunked(xs.to(torch.float32), dt, A,
                             B_.to(torch.float32), C_.to(torch.float32),
                             chunk=chunk, return_final_state=True)
    y = y + xs.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(x.dtype)

    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    return y @ p["out_proj"], xbc, h_final


def mamba_forward(p: dict, x: torch.Tensor, cfg,
                  chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba-2 block: ``(B, S, D) -> (B, S, D)``."""
    return _mamba_sequence(p, x, cfg, chunk)[0]


def mamba_prefill(p: dict, x: torch.Tensor, cfg, chunk: int = 128):
    """:func:`mamba_forward` that also returns the decode cache.

    Args:
      p: the block's parameters.
      x: ``(B, S, D)`` normalized inputs.
      cfg: the model configuration.
      chunk: the SSD chunk length.

    Returns:
      ``(y (B, S, D), cache)``: ``cache["state"]`` is the final fp32 SSM
      state and ``cache["conv"]`` the last ``ssm_conv - 1`` raw conv
      inputs, zero-padded in front when ``S < ssm_conv - 1``.
    """
    s = x.shape[1]
    out, xbc, h_final = _mamba_sequence(p, x, cfg, chunk)
    k = p["conv_w"].shape[0]
    hist = F.pad(xbc, (0, 0, k - 1, 0))[:, s:s + k - 1]
    return out, {"conv": hist, "state": h_final}


def init_mamba_cache(cfg, batch: int, dtype, device="cuda") -> dict:
    """Zeroed decode cache of one Mamba block: ``conv`` ``(batch,
    ssm_conv - 1, d_in + 2 n)`` in ``dtype`` and ``state`` ``(batch, h,
    n, head_dim)`` in fp32, on ``device``."""
    d_in = cfg.ssm_expand * cfg.d_model
    n, h, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = d_in + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                             device=device),
    }


def mamba_decode_step(p: dict, cache: dict, x1: torch.Tensor, cfg):
    """One token through the block in its recurrent form.

    Args:
      p: the block's parameters.
      cache: ``{"conv", "state"}`` (:func:`init_mamba_cache`).
      x1: ``(B, 1, D)`` normalized input.
      cfg: the model configuration.

    Returns:
      ``(new_cache, y (B, 1, D))``; the cache is new, never written in
      place.
    """
    b, _, d = x1.shape
    d_in = cfg.ssm_expand * d
    n, h, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    proj = x1[:, 0] @ p["in_proj"]                     # (B, ...)
    z, xbc, dt = _split_proj(proj, d_in, n, h)

    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)
    new_conv = hist[:, 1:]

    xs = conv[..., :d_in].reshape(b, h, hd)
    B_ = conv[..., d_in:d_in + n]
    C_ = conv[..., d_in + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    new_state, y = ssd_recurrent_step(
        cache["state"], xs.to(torch.float32), dt, A, B_.to(torch.float32),
        C_.to(torch.float32))
    y = y + xs.to(torch.float32) * p["D"][None, :, None]
    y = y.reshape(b, d_in).to(x1.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    out = (y @ p["out_proj"])[:, None, :]
    return {"conv": new_conv, "state": new_state}, out

"""Plain float32 reference of Mamba-2 (arXiv:2405.21060): per layer a
pre-norm RMSNorm, the input projection to ``(z, x, B, C, dt)``, a causal
depthwise convolution with SiLU over ``(x, B, C)``, the selective SSM
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t``
(one group, so ``B`` and ``C`` are shared by the heads), the gated
RMSNorm ``norm(y * silu(z))`` and the output projection; a final RMSNorm
and the tied output head.

The SSM runs in its quadratic ("attention dual") form over the whole
sequence, ``y_t = sum_{s <= t} (C_t . B_s) exp(seg_t - seg_s) dt_s x_s``,
with the running sums ``seg`` of ``dt A`` taken in float64, and no
chunks: another algorithm than the program's chunked scan.  Each layer
is recomputed in the backward (``torch.utils.checkpoint``), so one
layer's ``(S, S, heads)`` tensors are live at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from bench.reference.precision import conv_in, mm


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * scale


def _ssd(xs, dt, a, b, cc):
    """``xs`` ``(S, H, P)``, ``dt`` ``(S, H)``, ``a`` ``(H,)``, ``b``,
    ``cc`` ``(S, N)`` -> ``y`` ``(S, H, P)``."""
    s = xs.shape[0]
    seg = torch.cumsum((dt * a).double(), dim=0)                # (S, H)
    diff = seg[:, None, :] - seg[None, :, :]                    # (T, S, H)
    causal = torch.ones((s, s), dtype=torch.bool, device=xs.device).tril()
    decay = torch.exp(diff.masked_fill(~causal[..., None], float("-inf"))
                      ).float()
    g = mm(cc, b.t())                                           # (T, S)
    m = (g[..., None] * decay).permute(2, 0, 1)                 # (H, T, S)
    u = (xs * dt[..., None]).transpose(0, 1)                    # (H, S, P)
    return mm(m, u).transpose(0, 1)                             # (T, H, P)


def _layer(lp: dict, x: torch.Tensor, c: dict) -> torch.Tensor:
    mx = lp["mix"]
    s = x.shape[0]
    d_in, n, heads, hd = c["d_inner"], c["d_state"], c["heads"], c["head_dim"]
    h = _rms(x, lp["ln"]["scale"], c["eps"])
    proj = mm(h, mx["in_proj"])
    z = proj[:, :d_in]
    xbc = proj[:, d_in:2 * d_in + 2 * n]
    dt = proj[:, 2 * d_in + 2 * n:]
    k = mx["conv_w"].shape[0]
    w = mx["conv_w"].t()[:, None, :]                            # (C, 1, k)
    conv = F.conv1d(F.pad(conv_in(xbc).t()[None], (k - 1, 0)), conv_in(w),
                    bias=mx["conv_b"], groups=w.shape[0])[0].t()
    conv = F.silu(conv)
    xs = conv[:, :d_in].reshape(s, heads, hd)
    b, cc = conv[:, d_in:d_in + n], conv[:, d_in + n:]
    dt = F.softplus(dt + mx["dt_bias"])
    a = -torch.exp(mx["A_log"])
    y = _ssd(xs, dt, a, b, cc) + xs * mx["D"][None, :, None]
    y = _rms(y.reshape(s, d_in) * F.silu(z), mx["norm"]["scale"], c["eps"])
    return x + mm(y, mx["out_proj"])


def logits(params: dict, tokens: torch.Tensor, c: dict,
           remat: bool = True) -> torch.Tensor:
    """``(S, V)`` float32 logits of one sequence ``tokens`` ``(S,)``.

    ``c``: ``layers``, ``d_inner``, ``d_state``, ``heads``, ``head_dim``,
    ``eps``."""
    table = params["embed"]["table"]
    x = table[tokens.long()]
    stack = params["periods"]["s0"]
    for i in range(c["layers"]):
        lp = {"ln": {"scale": stack["ln"]["scale"][i]},
              "mix": {k: ({"scale": v["scale"][i]} if isinstance(v, dict)
                          else v[i]) for k, v in stack["mix"].items()}}
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _layer, lp, x, c, use_reentrant=False)
        else:
            x = _layer(lp, x, c)
    x = _rms(x, params["final_norm"]["scale"], c["eps"])
    return mm(x, table.t())


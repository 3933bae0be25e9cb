"""mamba2-130m: how its weights are drawn, its plain reference and its
work formulas (the yardstick's; see ``mamba2-130m.json``).

FLOPs count the matrix products (the tied head included; a
multiply-add counts 2), the depthwise convolution's multiply-adds, and
the SSM in its linear recurrent form, the least work: per token and
head, one multiply-add per state entry to write ``B x`` into the state
and one to read it with ``C`` (``4 H N P``).  Training is three times
the forward.
"""
from __future__ import annotations

from bench.reference import mamba2


def init_rule(path, shape):
    """How the benchmark draws each leaf: the embedding normal times
    0.02, projections normal over the square root of their fan-in, the
    convolution normal times 0.1, ``A_log`` the log of 1..16 over the
    heads, ``D`` and norm scales ones, biases zeros."""
    name = path[-1]
    if path[0] == "embed":
        return ("normal", 0.02)
    if name in ("scale", "D"):
        return ("const", 1.0)
    if name in ("conv_b", "dt_bias"):
        return ("const", 0.0)
    if name == "conv_w":
        return ("normal", 0.1)
    if name == "A_log":
        return ("log_linspace", 1.0, 16.0)
    return ("normal", shape[-2] ** -0.5)


def _dims(cfg):
    d = cfg["d_model"]
    d_in = cfg["expand"] * d
    heads = d_in // cfg["headdim"]
    return d, d_in, cfg["d_state"], heads, cfg["headdim"]


def _c(cfg):
    d, d_in, n, heads, hd = _dims(cfg)
    return {"layers": cfg["n_layer"], "d_inner": d_in, "d_state": n,
            "heads": heads, "head_dim": hd, "eps": cfg["norm_epsilon"]}


def reference_logits(tree, tokens, cfg):
    """``(S, V)`` logits of one sequence from the plain reference."""
    return mamba2.logits(tree, tokens, _c(cfg))


def projection_flops(cfg) -> int:
    """Per token and layer: the in and out projections."""
    d, d_in, n, heads, _ = _dims(cfg)
    return 2 * d * (2 * d_in + 2 * n + heads) + 2 * d_in * d


def conv_flops(cfg) -> int:
    d, d_in, n, _, _ = _dims(cfg)
    return 2 * cfg["d_conv"] * (d_in + 2 * n)


def ssm_flops(cfg) -> int:
    """Per token and layer, the recurrent form."""
    _, _, n, heads, hd = _dims(cfg)
    return 4 * heads * n * hd


def forward_flops(cfg, seqs: int, seq: int) -> int:
    per_token = (cfg["n_layer"] * (projection_flops(cfg) + conv_flops(cfg)
                                   + ssm_flops(cfg))
                 + 2 * cfg["d_model"] * cfg["vocab_size"])
    return seqs * seq * per_token


def train_flops(cfg, seqs: int, seq: int, causal: bool = True) -> int:
    """Model FLOPs of one training step's forward and backward."""
    del causal
    return 3 * forward_flops(cfg, seqs, seq)

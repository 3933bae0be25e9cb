"""qwen1.5-4b-l4: how its weights are drawn, its plain reference and its
work formulas (the yardstick's; see ``qwen1.5-4b-l4.json``).

FLOPs count the matrix products (the tied head included; a
multiply-add counts 2) and causal attention's lower triangle, diagonal
included; training is three times the forward.  Bytes count each weight
and each cache entry read once and each written once.
"""
from __future__ import annotations

from bench.reference import dense


def init_rule(path, shape):
    """How the benchmark draws each leaf: the embedding normal times
    0.02, projections normal over the square root of their fan-in,
    norm scales ones, biases zeros."""
    name = path[-1]
    if path[0] == "embed":
        return ("normal", 0.02)
    if name == "scale":
        return ("const", 1.0)
    if name in ("bq", "bk", "bv"):
        return ("const", 0.0)
    return ("normal", shape[-2] ** -0.5)


def _c(cfg):
    return {"heads": cfg["num_attention_heads"],
            "kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["head_dim"],
            "layers": cfg["num_hidden_layers"],
            "eps": cfg["rms_norm_eps"], "rope_theta": cfg["rope_theta"]}


def reference_logits(tree, tokens, cfg):
    """``(S, V)`` logits of one sequence from the plain reference."""
    return dense.logits(tree, tokens, _c(cfg))


def layer_matmul_params(cfg) -> int:
    """Weights that one token multiplies in one layer."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    return d * (q + 2 * kv) + q * d + 3 * d * cfg["intermediate_size"]


def _attn_pairs(seq: int, causal: bool) -> int:
    return seq * (seq + 1) // 2 if causal else seq * seq


def forward_flops(cfg, seqs: int, seq: int, causal: bool = True,
                  head_positions=None) -> int:
    """Forward FLOPs of ``seqs`` sequences of ``seq`` tokens
    (``head_positions``: positions whose logits are needed per
    sequence, all by default)."""
    layers = cfg["num_hidden_layers"]
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    heads = seq if head_positions is None else head_positions
    per_seq = (2 * seq * layers * layer_matmul_params(cfg)
               + 2 * heads * cfg["hidden_size"] * cfg["vocab_size"]
               + 4 * layers * qd * _attn_pairs(seq, causal))
    return seqs * per_seq


def train_flops(cfg, seqs: int, seq: int, causal: bool = True) -> int:
    """Model FLOPs of one training step's forward and backward."""
    return 3 * forward_flops(cfg, seqs, seq, causal)


def weight_bytes(cfg) -> int:
    """One replica's weights in float32."""
    d = cfg["hidden_size"]
    layers = cfg["num_hidden_layers"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    per_layer = layer_matmul_params(cfg) + (q + 2 * kv) + 2 * d
    return 4 * (cfg["vocab_size"] * d + layers * per_layer + d)


def kv_bytes_per_token(cfg) -> int:
    """One replica's cache entries for one position, float32."""
    return (4 * 2 * cfg["num_hidden_layers"] * cfg["num_key_value_heads"]
            * cfg["head_dim"])


def decode_work(cfg, replicas: int, positions):
    """``(bytes, FLOPs)`` of one decode step of every replica over slots
    at ``positions`` (each reads its cache up to and including it)."""
    layers = cfg["num_hidden_layers"]
    qd = cfg["num_attention_heads"] * cfg["head_dim"]
    keys = sum(int(p) + 1 for p in positions)
    kvt = kv_bytes_per_token(cfg)
    nbytes = replicas * (weight_bytes(cfg) + keys * kvt
                         + len(positions) * kvt)
    flops = replicas * (forward_flops(cfg, len(positions), 1)
                        - len(positions) * 4 * layers * qd
                        + 4 * layers * qd * keys)
    return nbytes, flops


def prefill_work(cfg, replicas: int, prompt: int):
    """``(bytes, FLOPs)`` of one admission's prefill of every replica:
    the prompt's cache written and the last position's logits."""
    nbytes = replicas * (weight_bytes(cfg) + prompt * kv_bytes_per_token(cfg))
    flops = replicas * forward_flops(cfg, 1, prompt, head_positions=1)
    return nbytes, flops

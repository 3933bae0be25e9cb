"""deepseek-v2-lite-l5: how its weights are drawn, its plain reference and
its work formulas (the yardstick's; see ``deepseek-v2-lite-l5.json``).

FLOPs count the matrix products (a multiply-add counts 2) and causal
attention's lower triangle, diagonal included.  The held routed experts
count what uniform routing gives them: each token's top-k picks fall on
the held share ``k * held / routed`` times on average (6 x 8 / 64 = 0.75
expert products a token); the router scores every expert.  Training is
three times the forward.  The grouped GEMM's work counts the rows it
actually multiplied (the program's row counter), each input byte read
once and each output byte written once.
"""
from __future__ import annotations

from bench.reference import deepseek_v2
from bench.roofline import least_s


def init_rule(path, shape):
    """How the benchmark draws each leaf: the embedding standard normal
    (as T5 draws it), norm scales ones, every projection (the router and
    the output head too) normal over the square root of its fan-in, so
    that the embedding and every layer's output are of one scale.

    The embedding's scale sets how the router sees its tokens.  At 0.02
    the layers' outputs outweigh it in the residual stream and share one
    direction across tokens (its norm a fifth to a third of a token's),
    so a random router sends most pairs to a few experts, differently
    for each seed: the held share's pairs per layer swung 2,227-3,500
    of a 3,072 mean, and the busiest held expert took 2.1-3.5 times the
    mean.  At 1 the tokens' own parts dominate and the routing is as
    balanced as a load-balanced trained router's: 2,850-3,320 pairs, the
    busiest of 64 experts 1.1-1.3 times the mean (PERF.md §6)."""
    if path[0] == "embed":
        return ("normal", 1.0)
    if path[-1] == "scale":
        return ("const", 1.0)
    return ("normal", shape[-2] ** -0.5)


def _c(cfg):
    return {"heads": cfg["num_attention_heads"],
            "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
            "v": cfg["v_head_dim"], "kv_lora": cfg["kv_lora_rank"],
            "eps": cfg["rms_norm_eps"], "rope_theta": float(cfg["rope_theta"]),
            "yarn": cfg["rope_scaling"], "dense": cfg["first_k_dense_replace"],
            "layers": cfg["num_hidden_layers"],
            "top_k": cfg["num_experts_per_tok"],
            "norm_topk": cfg["norm_topk_prob"],
            "scaling": float(cfg["routed_scaling_factor"]),
            "held_start": cfg["held_start"]}


def reference_logits(tree, tokens, cfg):
    """``(S, V)`` logits of one sequence from the plain reference."""
    return deepseek_v2.logits(tree, tokens, _c(cfg))


def _mla_params(cfg) -> int:
    """Weights one token multiplies in one latent attention."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) \
        + h * dv * d


def _moe_params(cfg) -> float:
    """Weights one token multiplies in one expert layer, on average."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    held_share = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
                  / cfg["routed_experts"])
    return (d * cfg["routed_experts"] + 3 * d * f * cfg["n_shared_experts"]
            + held_share * 3 * d * f)


def forward_flops(cfg, seqs: int, seq: int, causal: bool = True) -> float:
    """Forward FLOPs of ``seqs`` sequences of ``seq`` tokens."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    per_seq = (2 * seq * layers * _mla_params(cfg)
               + 2 * layers * h * (qk + cfg["v_head_dim"]) * pairs
               + 2 * seq * dense * 3 * d * cfg["intermediate_size"]
               + 2 * seq * (layers - dense) * _moe_params(cfg)
               + 2 * seq * d * cfg["vocab_size"])
    return seqs * per_seq


def train_flops(cfg, seqs: int, seq: int, causal: bool = True) -> float:
    """Model FLOPs of one training step's forward and backward."""
    return 3 * forward_flops(cfg, seqs, seq, causal)


def gmm_work(cfg, rows: float):
    """``[(bytes, FLOPs)]`` of the 9 grouped-GEMM launches of one expert
    layer in one worker's forward and backward over ``rows`` held
    (token, expert) pairs: the gate, up and down products, their input
    gradients and their weights' gradients.  Each reads its rows (or
    their gradients) and the held experts' weights, or writes the
    weights' gradients, once."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    held = cfg["n_routed_experts"]
    one = (4 * (rows * (d + f) + held * d * f), 2 * rows * d * f)
    return [one] * 9


def gmm_least_s(cfg, rows_by_layer, workers: int) -> float:
    """Least seconds of one step's grouped GEMMs: ``rows_by_layer`` the
    mean held pairs of each expert layer in one worker's pass."""
    return workers * sum(least_s(b, fl) for rows in rows_by_layer
                         for b, fl in gmm_work(cfg, rows))

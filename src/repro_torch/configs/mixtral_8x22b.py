"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = True  # sliding-window attention bounds the KV cache


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", arch_type="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        ffn_act="swiglu", layer_pattern=("swa",), window=4096,
        moe_impl="scatter", moe_experts=8, moe_top_k=2, moe_every=1,
        rope_theta=1e6, tie_embeddings=False, attn_shard="batch", param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-reduced", arch_type="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1024, head_dim=32,
        ffn_act="swiglu", layer_pattern=("swa",), window=64,
        moe_experts=4, moe_top_k=2, moe_every=1,
        tie_embeddings=False, param_dtype="float32",
    )

"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + 1 shared expert,
iRoPE layout (3 chunked-local RoPE layers : 1 global NoPE layer), early
fusion (vision tokens stubbed as pre-projected embeddings in the stream).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = True  # 3/4 layers chunk-local (8192) KV; global NoPE
                      # layers decode linearly in S at batch=1


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", arch_type="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128,
        ffn_act="swiglu",
        layer_pattern=("chunked", "chunked", "chunked", "attn_nope"),
        chunk=8192,
        moe_impl="scatter", moe_experts=16, moe_top_k=1, moe_every=1, moe_shared=1,
        rope_theta=500000.0, tie_embeddings=False, attn_shard="batch", param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-reduced", arch_type="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1024, head_dim=32,
        ffn_act="swiglu", layer_pattern=("chunked", "attn_nope"), chunk=64,
        moe_experts=4, moe_top_k=1, moe_every=1, moe_shared=1,
        tie_embeddings=False, param_dtype="float32",
    )

"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave (one
attention layer per 8-layer block), MoE 16e top-2 on every other layer.
[arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = True  # 7/8 of layers are constant-state mamba; batch=1 KV


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", arch_type="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab_size=65536, head_dim=128,
        ffn_act="swiglu",
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        moe_impl="scatter", moe_experts=16, moe_top_k=2, moe_every=2, moe_offset=1,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        tie_embeddings=False, attn_shard="batch", param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-reduced", arch_type="hybrid",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1024, head_dim=32,
        ffn_act="swiglu", layer_pattern=("mamba", "attn"),
        moe_experts=4, moe_top_k=2, moe_every=2, moe_offset=1,
        ssm_state=32, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        tie_embeddings=False, param_dtype="float32",
    )

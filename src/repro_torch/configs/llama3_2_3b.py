"""llama3.2-3b [dense] — small llama3, GQA kv=8.
[hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # pure full attention -> skip long_500k (DESIGN.md §6)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", arch_type="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=128256, head_dim=128,
        ffn_act="swiglu", layer_pattern=("attn",),
        rope_theta=500000.0, tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-reduced", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1024, head_dim=32,
        ffn_act="swiglu", layer_pattern=("attn",),
        tie_embeddings=True, param_dtype="float32",
    )

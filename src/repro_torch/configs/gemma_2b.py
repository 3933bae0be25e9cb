"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1). [arXiv:2403.08295]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # pure full attention -> skip long_500k (DESIGN.md §6)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", arch_type="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab_size=256000, head_dim=256,
        ffn_act="geglu", layer_pattern=("attn",),
        tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
        d_ff=512, vocab_size=1024, head_dim=64,
        ffn_act="geglu", layer_pattern=("attn",),
        tie_embeddings=True, param_dtype="float32",
    )

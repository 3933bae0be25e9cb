"""qwen1.5-4b [dense] — QKV bias, full MHA (kv=20). [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # pure full attention -> skip long_500k (DESIGN.md §6)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", arch_type="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936, head_dim=128,
        ffn_act="swiglu", qkv_bias=True, layer_pattern=("attn",),
        tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-reduced", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=1024, head_dim=64,
        ffn_act="swiglu", qkv_bias=True, layer_pattern=("attn",),
        tie_embeddings=True, param_dtype="float32",
    )

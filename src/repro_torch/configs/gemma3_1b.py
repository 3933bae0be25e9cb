"""gemma3-1b [dense] — 5:1 local(sliding-window):global attention, 128k+
context, MQA (kv=1), head_dim=256, huge vocab.  [hf:google/gemma-3-1b-pt]

26 layers = 4 full (5 local + 1 global) periods + 2 tail local layers.
"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = True  # 5/6 layers have bounded (window=512) KV; batch=1
                      # global layers decode linearly in S


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", arch_type="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        d_ff=6912, vocab_size=262144, head_dim=256,
        ffn_act="geglu",
        layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=512, rope_theta=1e6,
        tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-reduced", arch_type="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
        d_ff=512, vocab_size=1024, head_dim=64,
        ffn_act="geglu", layer_pattern=("swa", "attn"), window=64,
        tie_embeddings=True, param_dtype="float32",
    )

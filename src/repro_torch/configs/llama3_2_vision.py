"""llama-3.2-vision-11b [vlm] — language decoder with cross-attention image
layers every 5th layer; the ViT tower + projector are STUBBED (input_specs
provides (B, 1601, d_model) projected patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # full attention + cross-attn -> skip long_500k


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", arch_type="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, head_dim=128,
        ffn_act="swiglu",
        layer_pattern=("xattn", "attn", "attn", "attn", "attn"),
        vision_seq=1601,
        rope_theta=500000.0, tie_embeddings=False, attn_shard="batch", param_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-vision-reduced", arch_type="vlm",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1024, head_dim=32,
        ffn_act="swiglu", layer_pattern=("xattn", "attn"), vision_seq=16,
        tie_embeddings=False, param_dtype="float32",
    )

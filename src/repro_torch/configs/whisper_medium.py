"""whisper-medium [audio] — encoder-decoder; conv/mel frontend is STUBBED
(input_specs provides (B, 1500, d_model) frame embeddings).  Every decoder
layer cross-attends to the encoder output.  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # real decoder context is 448; 500k decode meaningless


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", arch_type="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865,
        ffn_act="gelu", qkv_bias=True, layer_pattern=("xattn",),
        encoder_layers=24, encoder_seq=1500,
        tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-reduced", arch_type="audio",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=1024,
        ffn_act="gelu", qkv_bias=True, layer_pattern=("xattn",),
        encoder_layers=2, encoder_seq=64,
        tie_embeddings=True, param_dtype="float32",
    )

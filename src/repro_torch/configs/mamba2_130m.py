"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = True  # constant-size SSM state


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", arch_type="ssm",
        n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=0, vocab_size=50280,
        layer_pattern=("mamba",),
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        tie_embeddings=True, attn_shard="batch", param_dtype="float32",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-reduced", arch_type="ssm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=1024,
        layer_pattern=("mamba",),
        ssm_state=32, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        tie_embeddings=True, param_dtype="float32",
    )

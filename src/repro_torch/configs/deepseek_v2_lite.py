"""deepseek-v2-lite [moe] — MLA (no q LoRA), YaRN, 1 leading dense layer,
64 routed experts top-6 unnormalized plus 2 shared.
[hf:deepseek-ai/DeepSeek-V2-Lite, config.json; arXiv:2405.04434]

The port's own configuration (the JAX package has neither MLA nor the
dropless expert layer), reachable through ``configs.ALIASES`` but kept
out of ``ARCH_IDS``, whose lists the JAX-parity tests iterate.  Float32
weights: the grouped GEMM runs fp32 only (the published weights are
bfloat16).  ``moe_seq_aux`` is the published ``aux_loss_alpha`` of its
sequence-wise balance loss.
"""
from repro_torch.models.config import ModelConfig

SUPPORTS_LONG = False  # full (latent) attention; serving is not written


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite", arch_type="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400, head_dim=128,
        ffn_act="swiglu", layer_pattern=("mla",), n_dense_lead=1,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rope_theta=10000.0, yarn_factor=40.0,
        yarn_original_len=4096, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
        yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
        moe_impl="grouped", moe_experts=64, moe_top_k=6, moe_shared=2,
        moe_d_ff=1408, moe_norm_topk=False, moe_scaling=1.0,
        moe_seq_aux=0.001, tie_embeddings=False, param_dtype="float32",
    )


def reduced() -> ModelConfig:
    """One leading dense layer and two MoE layers at small widths: 16
    routed experts (top-4), a held share of 4 (experts 4..7), YaRN as
    published, every part of the block in its published form."""
    return ModelConfig(
        name="deepseek-v2-lite-reduced", arch_type="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16,
        ffn_act="swiglu", layer_pattern=("mla",), n_dense_lead=1,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, rope_theta=10000.0, yarn_factor=40.0,
        yarn_original_len=4096, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
        yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
        moe_impl="grouped", moe_experts=16, moe_top_k=4, moe_shared=2,
        moe_d_ff=32, moe_norm_topk=False, moe_scaling=1.0,
        moe_held_start=4, moe_held=4, tie_embeddings=False,
        param_dtype="float32",
    )

"""Model configuration (the port's own copy of ``repro/models/config.py``,
data only, so the port imports nothing of the reference).

One ``ModelConfig`` describes every assigned architecture.  Heterogeneous
layer stacks (hybrid/local-global/cross-attn interleaves) are expressed as a
repeating ``layer_pattern`` of slot descriptors; the model scans over full
periods (params stacked on a leading period axis) and unrolls any remainder
("tail") layers.  Slot descriptors:

  attn      full causal self-attention
  swa       sliding-window causal self-attention (cfg.window)
  chunked   chunked-local causal self-attention (cfg.chunk, llama4 iRoPE)
  attn_nope full attention without RoPE (llama4 global layers)
  mamba     Mamba-2 SSD mixer (attention-free)
  xattn     cross-attention to encoder/vision states (+ self-attention)
  bidir     bidirectional self-attention (encoder)

Each slot is followed by its FFN, which is MoE on layers where
``layer_idx % moe_every == moe_offset`` (when ``moe_experts > 0``),
dense otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # ffn
    ffn_act: str = "swiglu"        # swiglu | geglu | gelu
    qkv_bias: bool = False

    # layer layout
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                # swa window
    chunk: int = 0                 # chunked-attention span

    # moe
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    moe_shared: int = 0            # shared (always-on) experts, llama4
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"       # einsum (GShard baseline) | scatter

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # enc-dec / cross-attn stubs
    encoder_layers: int = 0
    encoder_seq: int = 0           # whisper: 1500 stubbed frame embeddings
    vision_seq: int = 0            # vlm: stubbed patch embeddings

    # misc
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    param_dtype: str = "float32"   # bf16 for the very large archs
    logit_softcap: float = 0.0
    #: unroll the scan-over-periods (analysis-grade dry-runs: XLA cost
    #: analysis and HLO collective parsing see while bodies once, so the
    #: rolled form undercounts per-step work by ~n_periods)
    unroll_scan: bool = False
    #: "batch": constrain attention q/k/v/o to batch-sharding over the
    #: `model` axis (head counts rarely divide a 16-way axis; without this
    #: XLA splits head_dim and all-reduces partial score tensors — §Perf)
    attn_shard: str = "none"
    #: dtype of the unembedding matmul; "bfloat16" halves logits HBM
    #: traffic on huge-vocab models (gemma3: 262k vocab — §Perf).  The
    #: loss's logsumexp stays fp32 either way.
    logits_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_periods * self.period

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def slot(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.period]

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.moe_experts > 0
                and layer_idx % self.moe_every == self.moe_offset)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dff, hd = self.d_model, self.d_ff, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        n_ffn_mats = 3 if self.ffn_act in ("swiglu", "geglu") else 2
        for i in range(self.n_layers):
            slot = self.slot(i)
            if slot == "mamba":
                d_in = self.ssm_expand * d
                h = self.ssm_heads
                total += d * (2 * d_in + 2 * self.ssm_state + h)  # in_proj
                total += self.ssm_conv * (d_in + 2 * self.ssm_state)
                total += 2 * h + d_in                     # A_log, D, dt_bias? norm
                total += d_in * d                         # out_proj
                total += d                                # pre-norm
            else:
                total += d * hd * (nq + 2 * nkv) + hd * nq * d  # qkv + o
                if self.qkv_bias:
                    total += hd * (nq + 2 * nkv)
                total += d                                # pre-norm
                if slot == "xattn":                       # extra cross-attn
                    total += d * hd * (nq + 2 * nkv) + hd * nq * d + d
            if dff > 0:  # every slot (incl. mamba in hybrids) carries a FFN
                if self.is_moe_layer(i):
                    per_e = n_ffn_mats * d * dff
                    total += (self.moe_experts + self.moe_shared) * per_e
                    total += d * self.moe_experts         # router
                else:
                    total += n_ffn_mats * d * dff
                total += d                                # ffn pre-norm
        total += d                                        # final norm
        # encoder stack (whisper)
        for _ in range(self.encoder_layers):
            total += d * hd * (nq + 2 * nkv) + hd * nq * d + d
            total += 2 * d * dff + d                      # gelu mlp
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe_experts == 0:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        n_ffn_mats = 3 if self.ffn_act in ("swiglu", "geglu") else 2
        per_e = n_ffn_mats * d * dff
        inactive = 0
        for i in range(self.n_layers):
            if dff > 0 and self.is_moe_layer(i):
                inactive += (self.moe_experts - self.moe_top_k) * per_e
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input-shape row."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

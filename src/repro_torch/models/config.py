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
  mla       multi-head latent attention (DeepSeek-V2): queries and a
            shared low-rank latent of keys and values, decoupled RoPE
            keys (``qk_rope_head_dim``) shared by every head

Each slot is followed by its FFN, which is MoE on layers where
``layer_idx % moe_every == moe_offset`` (when ``moe_experts > 0``),
dense otherwise.  ``n_dense_lead`` leading layers (DeepSeek's
``first_k_dense_replace``) come before the periods, each with the slot
``layer_pattern[0]`` and a dense FFN of width ``d_ff``; the periods then
hold the remaining ``n_layers - n_dense_lead`` layers.

``moe_impl="grouped"`` is the dropless routed-expert layer
(``models/moe.py::grouped_moe_ffn``): routing over all ``moe_experts``,
no capacity, and only the held share ``[moe_held_start, moe_held_start +
moe_held)`` of the experts computed here (expert parallelism's share of
one chip), plus the shared FFN.
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
                                   # | grouped (dropless, held share)
    #: the routed experts' FFN width (0: ``d_ff``); DeepSeek's
    #: ``moe_intermediate_size``, the shared experts' too
    moe_d_ff: int = 0
    #: routing of the grouped layer: gate scores ``softmax`` over all
    #: experts, greedy top-k, the top-k gates renormalized or not, then
    #: times ``moe_scaling`` (DeepSeek's ``routed_scaling_factor``)
    moe_norm_topk: bool = True
    moe_scaling: float = 1.0
    #: weight of the sequence-wise balance loss (DeepSeek's ``seq_aux``
    #: with ``aux_loss_alpha``); 0 computes none
    moe_seq_aux: float = 0.0
    #: the held share of the grouped layer: experts ``[moe_held_start,
    #: moe_held_start + moe_held)`` (0: all of them)
    moe_held_start: int = 0
    moe_held: int = 0
    #: leading dense layers before the periods (``first_k_dense_replace``)
    n_dense_lead: int = 0

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # mla (DeepSeek-V2 latent attention; q_lora_rank none)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # YaRN rope scaling (``yarn_factor`` 0: none)
    yarn_factor: float = 0.0
    yarn_original_len: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

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
        return (self.n_layers - self.n_dense_lead) // self.period

    @property
    def n_tail(self) -> int:
        return (self.n_layers - self.n_dense_lead
                - self.n_periods * self.period)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def held_experts(self) -> int:
        """Routed experts whose weights this model holds."""
        return self.moe_held or self.moe_experts

    def unsupported(self, what: str) -> Optional[str]:
        """Why ``what`` (``"serving"`` or ``"mesh"``) cannot run this
        configuration, or ``None``: the latent cache and absorbed decode
        of an ``mla`` slot, and a tensor-parallel split of MLA or of the
        grouped expert layer, are not written yet."""
        parts = []
        if "mla" in self.layer_pattern:
            parts.append("the mla slot's " + (
                "latent KV cache and absorbed decode" if what == "serving"
                else "model-axis split"))
        if self.moe_impl == "grouped":
            parts.append("the grouped expert layer's " + (
                "decode path" if what == "serving"
                else "expert-parallel exchange"))
        if not parts:
            return None
        return (f"{self.name}: {what} does not support "
                + " nor ".join(parts) + " yet")

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def slot(self, layer_idx: int) -> str:
        if layer_idx < self.n_dense_lead:
            return self.layer_pattern[0]
        return self.layer_pattern[(layer_idx - self.n_dense_lead)
                                  % self.period]

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.moe_experts > 0 and layer_idx >= self.n_dense_lead
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
            elif slot == "mla":
                qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                r = self.kv_lora_rank
                total += d * nq * qd                      # q
                total += d * (r + self.qk_rope_head_dim) + r  # kv_a, norm
                total += r * nq * (self.qk_nope_head_dim
                                   + self.v_head_dim)     # kv_b
                total += nq * self.v_head_dim * d + d     # o, pre-norm
            else:
                total += d * hd * (nq + 2 * nkv) + hd * nq * d  # qkv + o
                if self.qkv_bias:
                    total += hd * (nq + 2 * nkv)
                total += d                                # pre-norm
                if slot == "xattn":                       # extra cross-attn
                    total += d * hd * (nq + 2 * nkv) + hd * nq * d + d
            if dff > 0:  # every slot (incl. mamba in hybrids) carries a FFN
                if self.is_moe_layer(i):
                    per_e = n_ffn_mats * d * self.expert_d_ff
                    total += (self.held_experts + self.moe_shared) * per_e
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
        per_e = n_ffn_mats * d * self.expert_d_ff
        inactive = 0
        for i in range(self.n_layers):
            if dff > 0 and self.is_moe_layer(i):
                inactive += max(0, self.held_experts
                                - self.moe_top_k) * per_e
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

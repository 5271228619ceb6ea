"""Architecture config schema for the LM zoo + LDA configs.

Every LM architecture is an ``ArchConfig``; reduced smoke variants are
derived with ``ArchConfig.reduced()``. LDA runs use ``LDAArchConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""

    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 2.0
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # group-local dispatch (GShard-style): capacity and the one-hot
    # dispatch/combine einsums are per token-group, so dispatch flops are
    # O(T * ts * ...) instead of O(T^2 * cf / E) — at 1M tokens the global
    # formulation costs more than the experts themselves (§Perf a1)
    group_size: int = 1024


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int = 1  # 1 = Mamba (falcon-mamba), 2 = Mamba2/SSD (zamba2)
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2  # d_inner = expand * d_model
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    num_heads: int = 0  # mamba2: d_inner // head_dim
    head_dim: int = 64  # mamba2
    chunk: int = 128  # mamba2 SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention flavor
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen1.5
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # gemma3: different theta on global layers
    sliding_window: int = 0  # 0 = full attention
    local_global_pattern: int = 0  # gemma3: N local then 1 global (N=5)
    mla: Optional[MLAConfig] = None  # minicpm3
    mrope: bool = False  # qwen2-vl (3-component M-RoPE)
    # MoE / SSM / hybrid / enc-dec
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0  # zamba2: shared attn block period
    encoder_decoder: bool = False  # whisper
    num_encoder_layers: int = 0
    # misc
    norm_style: str = "rmsnorm"  # rmsnorm | layernorm (whisper)
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated MLP (false for whisper)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # training
    remat_policy: str = "nothing_saveable"  # nothing_saveable|dots|none
    optimizer: str = "adamw"  # adamw | adafactor (giant MoEs)
    # which shapes this arch supports (DESIGN.md §4 skip rules)
    skip_shapes: Tuple[str, ...] = ()
    # roofline instrumentation: python-loop the layer stacks instead of
    # lax.scan so HLO cost_analysis counts every layer (scan bodies are
    # counted once); used only by shallow fit-compiles, never production
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab_size(self) -> int:
        """Embedding-table rows padded to 512 (Megatron-style vocab
        padding) so the vocab dim shards on any production axis; logits
        columns >= vocab_size are masked in the loss / sliced at decode."""
        return ((self.vocab_size + 511) // 512) * 512

    @property
    def is_sub_quadratic(self) -> bool:
        return (
            self.ssm is not None
            or self.hybrid_attn_every > 0
            or self.local_global_pattern > 0
        )

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/flavor, tiny dims."""
        changes = dict(
            num_layers=min(self.num_layers, 4) if not self.hybrid_attn_every
            else 4,
            d_model=128,
            num_heads=max(2, min(4, self.num_heads)),
            num_kv_heads=1 if self.num_kv_heads < self.num_heads else 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.num_kv_heads == self.num_heads:
            changes["num_kv_heads"] = changes["num_heads"]
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=48,
                qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
            )
            changes["head_dim"] = 32
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4), top_k=2
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm,
                state_dim=min(self.ssm.state_dim, 16),
                head_dim=32,
                chunk=16,
            )
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        if self.num_encoder_layers:
            changes["num_encoder_layers"] = 2
        if self.local_global_pattern:
            changes["local_global_pattern"] = min(self.local_global_pattern, 2)
        if self.sliding_window:
            changes["sliding_window"] = 16
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)


@dataclasses.dataclass(frozen=True)
class LDAArchConfig:
    """An LDA training run as a dry-runnable "architecture"."""

    name: str
    num_words: int
    num_topics: int
    docs_per_step: int  # documents resident per iteration (streamed corpus)
    avg_doc_len: int
    algorithm: str = "zen_cdf"
    max_kd: int = 64
    delta_dtype: str = "int32"
    kd_dtype: str = "int32"  # int16 halves every N_kd pass (§Perf l4)

    @property
    def tokens_per_step(self) -> int:
        return self.docs_per_step * self.avg_doc_len


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what to lower and with which sizes."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

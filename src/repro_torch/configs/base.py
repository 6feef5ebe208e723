"""Config dataclasses for model architectures and run shapes.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``).
Every assigned architecture is expressed as a :class:`ModelConfig`; the
reduced smoke variants reuse the same dataclass (see ``reduced()``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "HybridConfig",
    "XLSTMConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    n_dense_layers: int = 0          # leading layers that use a dense MLP
    d_ff_dense: int = 0              # their hidden size (0 ⇒ use d_ff)
    capacity_factor: float = 1.25
    router_type: str = "softmax"     # "softmax" | "sigmoid" (deepseek-v3)
    # GShard-style dispatch groups: queue positions are cumsum'd *within*
    # a group (one per data shard) with per-group capacity, so the dispatch
    # needs no global sequential cumsum (perf iteration M2).  Must divide
    # the per-step token count; falls back to 1 group otherwise.
    dispatch_groups: int = 16


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + one *shared* attention+MLP block
    invoked every ``shared_every`` layers (weights reused per invocation)."""

    shared_every: int = 6


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: mLSTM blocks with an sLSTM block every ``slstm_every`` (7:1)."""

    slstm_every: int = 8
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    input_kind: str = "tokens"       # tokens | embeddings (stub frontends)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    mtp: bool = False                # DeepSeek-V3 multi-token prediction head
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def block_kind(self) -> str:
        if self.xlstm is not None:
            return "xlstm"
        if self.hybrid is not None:
            return "hybrid"
        if self.ssm is not None:
            return "ssm"
        return "transformer"

    def reduced(self, **over) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            tie_embeddings=self.tie_embeddings,
            input_kind=self.input_kind,
            mtp=self.mtp,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=8,
                top_k=2,
                d_ff_expert=32,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                n_dense_layers=min(self.moe.n_dense_layers, 1),
                d_ff_dense=64 if self.moe.n_dense_layers else 0,
            )
        if self.mla:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32
            )
        if self.hybrid:
            kw["hybrid"] = HybridConfig(shared_every=2)
        if self.xlstm:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2)
        kw.update(over)
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

"""zamba2-2.7b — [hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; hf]."""

from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    hybrid=HybridConfig(shared_every=6),
    notes="Mamba2 backbone; one shared attention+MLP block every 6 layers "
          "(weights reused).  Sub-quadratic ⇒ runs long_500k.",
)

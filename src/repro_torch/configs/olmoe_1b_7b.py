"""olmoe-1b-7b — [moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 — 64 experts top-8  [arXiv:2409.02060; hf]."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    qk_norm=True,            # OLMoE uses qk-norm
    moe=MoEConfig(
        n_experts=64,
        top_k=8,
        d_ff_expert=1024,
        n_shared_experts=0,
        n_dense_layers=0,
        router_type="softmax",
    ),
    notes="64 experts, top-8, softmax router, no shared expert",
)

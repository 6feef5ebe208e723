"""deepseek-v3-671b — [moe] 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared+256 routed top-8, MTP
[arXiv:2412.19437; hf].

``d_ff = 2048`` is the per-expert width; the 3 leading dense layers use
``d_ff_dense = 18432`` (the published dense-MLP width).  Attention is MLA
(latent KV cache), router is sigmoid-scoring top-8 with 1 shared expert,
and the MTP (multi-token-prediction) head adds one extra dense block.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129_280,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        n_dense_layers=3,
        d_ff_dense=18_432,
        router_type="sigmoid",
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp=True,
    notes="MLA + sigmoid-routed 256e top-8 MoE + shared expert + MTP",
)

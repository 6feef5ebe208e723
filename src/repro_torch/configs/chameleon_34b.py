"""chameleon-34b — [vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens  [arXiv:2405.09818; unverified].

The modality frontend (VQ-VAE image tokenizer) is a STUB: ``input_specs()``
provides precomputed patch/VQ-token *embeddings* (B, S, d_model); the
backbone is the early-fusion decoder over the shared 65536 vocab.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,            # chameleon adds qk-norm for training stability
    input_kind="embeddings",
    notes="early-fusion VLM backbone; frontend stubbed to embeddings",
)

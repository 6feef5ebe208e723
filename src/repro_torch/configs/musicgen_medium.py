"""musicgen-medium — [audio] 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens  [arXiv:2306.05284; hf].

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed
audio-frame embeddings (B, S, d_model); the backbone decodes over the
2048-entry codebook vocabulary.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    input_kind="embeddings",
    notes="decoder-only over EnCodec codebook tokens; frontend stubbed",
)

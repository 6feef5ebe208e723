"""Data: synthetic streams and the resumable token pipeline with SSSJ dedup."""

from .pipeline import DedupFilter, TokenPipeline, hashing_embed  # noqa: F401
from .synth import dense_embedding_stream, topic_drift_stream  # noqa: F401

"""Data: synthetic streams and the resumable token pipeline with SSSJ dedup."""

from .pipeline import DedupFilter, TokenPipeline, hashing_embed  # noqa: F401
from .synth import (  # noqa: F401
    bursty_tenant_traffic,
    dense_embedding_stream,
    topic_drift_stream,
)

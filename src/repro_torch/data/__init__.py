"""Data: synthetic streams and the resumable token pipeline with SSSJ dedup."""

from .pipeline import DedupFilter, TokenPipeline, hashing_embed  # noqa: F401
from .synth import (  # noqa: F401
    DATASET_SPECS,
    StreamSpec,
    bursty_tenant_traffic,
    dense_embedding_stream,
    planted_duplicates,
    synthetic_stream,
    topic_drift_stream,
)

"""Observability: the metrics registry, span tracing and bridges."""

from .bridge import publish_counters, publish_flat  # noqa: F401
from .registry import (  # noqa: F401
    LATENCY_BOUNDS_S,
    Counter,
    Gauge,
    Histogram,
    Info,
    MetricsRegistry,
    histogram_percentile,
    log_buckets,
    merge_disjoint,
)
from .spans import PIPELINE_STAGES, SpanTracer  # noqa: F401

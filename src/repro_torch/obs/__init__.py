from .registry import Counter, Gauge, MetricsRegistry  # noqa: F401

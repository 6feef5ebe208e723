from .synth import dense_embedding_stream, topic_drift_stream  # noqa: F401

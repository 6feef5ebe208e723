"""Serving: the single-stream streaming similarity self-join service."""

from .service import SSSJService, ServiceStats  # noqa: F401

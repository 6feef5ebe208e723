"""Logical-axis rules: which mesh axis each logical axis shards over."""

from .sharding import AxisRules, DEFAULT_RULES  # noqa: F401

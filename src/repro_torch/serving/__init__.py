"""Serving: the streaming similarity self-join services, single- and
multi-tenant, and the LM embedder that feeds them."""

from .embedder import LMEmbedder, pooled_unit_embed  # noqa: F401
from .service import MultiTenantSSSJService, SSSJService, ServiceStats  # noqa: F401

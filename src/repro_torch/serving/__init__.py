"""Serving: the streaming similarity self-join services, single- and
multi-tenant."""

from .service import MultiTenantSSSJService, SSSJService, ServiceStats  # noqa: F401

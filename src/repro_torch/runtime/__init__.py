"""Multi-tenant streaming runtime: K logical streams on one engine.

  * :mod:`~repro_torch.runtime.tenants` — the per-stream ``(θ, λ)`` table;
  * :mod:`~repro_torch.runtime.router` — admission queue and request
    coalescer with per-tenant backpressure and queue telemetry;
  * :mod:`~repro_torch.runtime.runtime` — :class:`MultiTenantRuntime`:
    the stream-tagged engine facade (fixed-span dispatch, per-tenant
    drain, admission→emission latency) on one device
    (:class:`SingleDeviceFacade`) or a device mesh (:class:`ShardedFacade`),
    and the fused embed→join (:class:`FusedEmbedder`).
"""

from .router import (  # noqa: F401
    RequestRouter,
    RouterTelemetry,
    TenantBackpressure,
)
from .runtime import (  # noqa: F401
    EngineFacade,
    FusedEmbedder,
    MultiTenantRuntime,
    ShardedFacade,
    SingleDeviceFacade,
    make_tenant_batch_step,
)
from .tenants import TenantTable  # noqa: F401

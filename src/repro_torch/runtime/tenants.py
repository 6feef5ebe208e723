"""Per-stream join parameters: the tenant table.

Counterpart of ``repro.runtime.tenants``.  The runtime keeps a small
device-resident table of ``(θ_k, λ_k)`` and the join looks a row's
parameters up by its stream id.  A pair's stream is its query row's
stream (the join's stream-equality mask guarantees both sides agree), so
query-side values govern the whole pair.

The table is uploaded once per device and reused by every micro-batch:
:meth:`TenantTable.lookup` is a gather on the device, with no host sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.similarity import time_horizon

__all__ = ["TenantTable"]


class TenantTable:
    """Immutable per-stream ``(theta, lam)`` table with device mirrors.

    ``thetas``/``lams`` are host float32 arrays of length ``n_tenants``;
    :meth:`lookup` turns a stream-id lane into per-row parameter lanes (or
    ``None`` when every tenant shares the same values, which keeps the
    join's scalar path).
    """

    def __init__(self, thetas: Sequence[float], lams: Sequence[float]) -> None:
        thetas = np.asarray(thetas, np.float32).reshape(-1)
        lams = np.asarray(lams, np.float32).reshape(-1)
        if thetas.size == 0:
            raise ValueError("tenant table must have at least one stream")
        if thetas.shape != lams.shape:
            raise ValueError(
                f"thetas ({thetas.shape}) and lams ({lams.shape}) disagree"
            )
        for k, (th, lm) in enumerate(zip(thetas.tolist(), lams.tolist())):
            if not 0.0 < th <= 1.0:
                raise ValueError(f"tenant {k}: theta must be in (0, 1], got {th}")
            if lm < 0.0:
                raise ValueError(f"tenant {k}: lam must be ≥ 0, got {lm}")
        self.thetas = thetas
        self.lams = lams
        self._uniform = bool(np.all(thetas == thetas[0]) and np.all(lams == lams[0]))
        self._device_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def uniform(cls, n_tenants: int, theta: float, lam: float) -> "TenantTable":
        return cls([theta] * n_tenants, [lam] * n_tenants)

    # ------------------------------------------------------------------ #
    @property
    def n_tenants(self) -> int:
        return int(self.thetas.size)

    @property
    def is_uniform(self) -> bool:
        return self._uniform

    @property
    def tau_max(self) -> float:
        """The widest tenant horizon: what sizes the shared ring window
        (and its live-slot overflow accounting, conservatively)."""
        return max(
            time_horizon(float(t), float(l))
            for t, l in zip(self.thetas, self.lams)
        )

    def device_tables(self, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(thetas, lams)`` as f32 tensors on ``device`` (``None`` =
        CUDA), uploaded on first use and kept."""
        dev = resolve_device(device)
        if dev not in self._device_tables:
            self._device_tables[dev] = (
                torch.from_numpy(self.thetas).to(dev),
                torch.from_numpy(self.lams).to(dev),
            )
        return self._device_tables[dev]

    def spec(self, tenant: int) -> Tuple[float, float]:
        return float(self.thetas[tenant]), float(self.lams[tenant])

    def validate_id(self, tenant: int) -> int:
        tenant = int(tenant)
        if not 0 <= tenant < self.n_tenants:
            raise ValueError(
                f"unknown stream id {tenant} (table has {self.n_tenants})"
            )
        return tenant

    # ------------------------------------------------------------------ #
    @staticmethod
    def lookup_rows(
        theta_d: torch.Tensor, lam_d: torch.Tensor, sq: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row lookup from explicit device tables.  Pad rows carry ``sq =
        -1``; the clip sends them to tenant 0, whose finite values are
        inert: pad rows never emit (uid = -1) and never loosen the
        min-based pruning bounds."""
        idx = torch.clamp(sq.long(), 0, theta_d.shape[0] - 1)
        return theta_d[idx], lam_d[idx]

    def lookup(
        self, sq: torch.Tensor
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Stream-id lane → per-row ``(theta_q, lam_q)`` lanes on ``sq``'s
        device; ``None`` for a uniform table (the join keeps its scalars:
        identical results, no lanes through the kernel)."""
        if self.is_uniform:
            return None
        tables = self._device_tables.get(sq.device) or self.device_tables(sq.device)
        return self.lookup_rows(*tables, sq)

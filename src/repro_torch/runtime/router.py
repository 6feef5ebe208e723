"""Request router: admission queue + coalescer for multi-tenant streams.

A copy of ``repro.runtime.router`` (numpy only).  The router admits
sub-batch arrivals from many tenants into one global FIFO (strict
admission order: results are invariant to coalescing boundaries) and
hands the runtime exact row counts back out when it packs micro-batches:

  * **admission order is the only order** — items leave exactly as they
    arrived, across all tenants;
  * **backpressure** — a per-tenant cap on queued rows; an over-cap submit
    raises :class:`TenantBackpressure` *before* anything is enqueued (all
    or nothing);
  * **telemetry** — queued depth per tenant, admitted/rejected counts, and
    queue-delay (admission → take) sums/maxima.

The router never touches the payload beyond concatenation.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np

__all__ = ["RequestRouter", "RouterTelemetry", "TenantBackpressure"]


class TenantBackpressure(RuntimeError):
    """A tenant's queued rows would exceed its backpressure cap."""

    def __init__(self, tenant: int, queued: int, incoming: int, cap: int):
        super().__init__(
            f"stream {tenant}: {queued} rows queued + {incoming} incoming "
            f"exceeds the backpressure cap ({cap}); drain with flush() or "
            f"raise max_queue_per_tenant"
        )
        self.tenant = tenant


@dataclasses.dataclass
class RouterTelemetry:
    items_admitted: int = 0
    items_rejected: int = 0     # rows refused by backpressure (submit raised)
    items_dispatched: int = 0   # rows handed to the device packer
    queue_delay_sum_s: float = 0.0  # admission → take, summed over rows
    queue_delay_max_s: float = 0.0


@dataclasses.dataclass
class _Chunk:
    tenant: int
    payload: np.ndarray      # (b, ...) vectors or token rows
    ts: np.ndarray           # (b,) f64
    uids: np.ndarray         # (b,) i32 — global, assigned at admission
    t_admit: float           # wall clock, for queue-delay telemetry
    start: int = 0           # rows [0, start) already taken


class RequestRouter:
    """Order-preserving admission queue with per-tenant backpressure."""

    def __init__(self, n_tenants: int, max_queue_per_tenant: int = 65536):
        if max_queue_per_tenant < 1:
            raise ValueError("max_queue_per_tenant must be ≥ 1")
        self.n_tenants = n_tenants
        self.max_queue_per_tenant = max_queue_per_tenant
        self._queue: Deque[_Chunk] = deque()
        self._queued_rows = 0
        self.queued_by_tenant: Dict[int, int] = {t: 0 for t in range(n_tenants)}
        self.telemetry = RouterTelemetry()

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        """Rows currently queued (all tenants)."""
        return self._queued_rows

    def admit(
        self,
        tenant: int,
        payload: np.ndarray,
        ts: np.ndarray,
        uids: np.ndarray,
    ) -> None:
        b = payload.shape[0]
        queued = self.queued_by_tenant[tenant]
        if queued + b > self.max_queue_per_tenant:
            self.telemetry.items_rejected += b
            raise TenantBackpressure(tenant, queued, b, self.max_queue_per_tenant)
        self._queue.append(
            _Chunk(tenant, payload, ts, uids, t_admit=time.monotonic())
        )
        self.queued_by_tenant[tenant] = queued + b
        self._queued_rows += b
        self.telemetry.items_admitted += b

    def take(
        self, n: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pop exactly ``n`` rows (``n ≤ len(self)``) in admission order.

        Returns ``(payload (n, ...), ts (n,), uids (n,), sids (n,),
        t_admit (n,))`` — ``t_admit`` is each row's monotonic admission
        stamp, the anchor for admission→emission latency.  A partially
        consumed head chunk stays queued with its cursor advanced, so
        micro-batch boundaries never reorder or drop rows.
        """
        if n > self._queued_rows:
            raise ValueError(f"take({n}) exceeds {self._queued_rows} queued rows")
        now = time.monotonic()
        tel = self.telemetry
        parts: List[Tuple[_Chunk, int, int]] = []   # (chunk, lo, hi)
        got = 0
        while got < n:
            c = self._queue[0]
            avail = c.payload.shape[0] - c.start
            k = min(avail, n - got)
            parts.append((c, c.start, c.start + k))
            delay = max(0.0, now - c.t_admit)
            tel.queue_delay_sum_s += delay * k
            tel.queue_delay_max_s = max(tel.queue_delay_max_s, delay)
            self.queued_by_tenant[c.tenant] -= k
            got += k
            if k == avail:
                self._queue.popleft()
            else:
                c.start += k
        self._queued_rows -= n
        tel.items_dispatched += n
        payload = np.concatenate([c.payload[lo:hi] for c, lo, hi in parts])
        ts = np.concatenate([c.ts[lo:hi] for c, lo, hi in parts])
        uids = np.concatenate([c.uids[lo:hi] for c, lo, hi in parts])
        sids = np.concatenate(
            [np.full(hi - lo, c.tenant, np.int32) for c, lo, hi in parts]
        )
        t_admit = np.concatenate(
            [np.full(hi - lo, c.t_admit, np.float64) for c, lo, hi in parts]
        )
        return payload, ts, uids, sids, t_admit

"""Metrics registry: counters, gauges and snapshots.

A copy of the counter/gauge part of ``repro.obs.registry`` (the port
imports nothing of ``repro``).  The engine publishes under the names
pinned in ``tests/metrics_schema.json`` (``engine/…``, ``engine/prune/…``)
through a collector that runs at :meth:`MetricsRegistry.snapshot` time,
so a snapshot is coherent with the device state when it is taken.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

__all__ = ["Counter", "Gauge", "MetricsRegistry"]

Number = Union[int, float]


class Counter:
    """Monotonic total.  ``inc`` for live events; ``set`` for collectors
    that re-publish an externally-owned total (device telemetry)."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v

    def read(self) -> Number:
        return self.value


class Gauge:
    """Point-in-time reading (queue depth, ring liveness, ratios)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def read(self) -> Number:
        return self.value


class MetricsRegistry:
    """Create-or-get metric instruments plus snapshot-time collectors.

    Getters are idempotent: asking for an existing name returns the
    existing instrument, and raises if the kind differs.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _get(self, cls, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """``fn(registry)`` runs (in registration order) at the start of
        every :meth:`snapshot` to publish externally-owned state."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn(self)

    def schema(self) -> Dict[str, str]:
        """``{name: kind}`` for every registered metric."""
        self.collect()
        return {name: m.kind for name, m in sorted(self._metrics.items())}

    def snapshot(self) -> dict:
        """One coherent ``{name: value}`` view of every metric."""
        self.collect()
        return {name: m.read() for name, m in sorted(self._metrics.items())}

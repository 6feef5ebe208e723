"""Metrics registry: counters, gauges, infos and fixed log-bucket histograms.

A copy of ``repro.obs.registry`` (the port imports nothing of ``repro``).
One registry is the stats surface of a serving stack: every layer
publishes under namespaced keys (``engine/…``, ``engine/prune/…``,
``span/<stage>/…``, ``paper/…``), the names pinned in
``tests/metrics_schema.json``.

Two publishing styles coexist:

  * **live instruments** — ``registry.counter(name).inc()`` /
    ``registry.histogram(name).observe(v)`` for host-side events as they
    happen (span timings, latency observations);
  * **collectors** — ``registry.register_collector(fn)`` for state that
    lives elsewhere (the engine's device telemetry): ``fn(registry)`` runs
    at :meth:`MetricsRegistry.snapshot` time and ``.set()``\\ s the
    current totals, so a snapshot is coherent with the device state at
    the moment it is taken.

Snapshots are plain JSON-able dicts (histograms expand to ``{"bounds",
"counts", "sum", "count"}``); :meth:`MetricsRegistry.prometheus_text`
renders the same data in Prometheus text exposition format (histograms as
cumulative ``_bucket{le=…}`` series), byte for byte as the reference does.
Nothing here touches torch, so any layer (the drain copy thread included)
may import it.
"""

from __future__ import annotations

import bisect
import json
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Info",
    "LATENCY_BOUNDS_S",
    "MetricsRegistry",
    "histogram_percentile",
    "log_buckets",
    "merge_disjoint",
]

Number = Union[int, float]


def log_buckets(lo: float, hi: float, growth: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds ``lo, lo·g, lo·g², … ≥ hi``.

    The first bound is exactly ``lo`` and bounds grow by repeated
    multiplication (no rounding), so bucket boundaries are reproducible
    floats — a value observed exactly at a boundary lands in the bucket
    whose upper bound equals it (``le`` semantics, as in Prometheus).
    """
    if not (lo > 0.0 and hi > lo and growth > 1.0):
        raise ValueError(
            f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
            f"growth={growth}"
        )
    out: List[float] = []
    b = float(lo)
    while b < hi:
        out.append(b)
        b *= growth
    out.append(b)                      # first bound ≥ hi closes the range
    return tuple(out)


# admission→emission latency vocabulary: 10 µs … ~84 s in ×2 steps
LATENCY_BOUNDS_S: Tuple[float, ...] = log_buckets(1e-5, 64.0, 2.0)


class Counter:
    """Monotonic total.  ``inc`` for live events; ``set`` for collectors
    that re-publish an externally-owned total (device telemetry) at
    snapshot time."""

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


class Info:
    """String-valued metric (policy names, modes).  Rendered in
    Prometheus exposition as a ``…_info{value="…"} 1`` series."""

    __slots__ = ("name", "value")
    kind = "info"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: str = ""

    def set(self, v: str) -> None:
        self.value = str(v)

    def read(self) -> str:
        return self.value


class Histogram:
    """Fixed-bucket histogram with ``le`` (inclusive-upper) semantics.

    ``counts[i]`` holds observations in ``(bounds[i-1], bounds[i]]``
    (``(-inf, bounds[0]]`` for ``i = 0``); ``counts[-1]`` is the +inf
    overflow bucket.  Bounds are fixed at construction —
    :data:`LATENCY_BOUNDS_S` by default — so histograms merged across
    snapshots or tenants always share boundaries.
    """

    __slots__ = ("name", "bounds", "counts", "sum", "count")
    kind = "histogram"

    def __init__(
        self, name: str, bounds: Sequence[float] = LATENCY_BOUNDS_S
    ) -> None:
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError(f"bounds must be strictly increasing: {bounds}")
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def observe_many(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        idx = np.searchsorted(self.bounds, values, side="left")
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(i)] += int(c)
        self.sum += float(values.sum())
        self.count += int(values.size)

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile, ``q ∈ [0, 1]``; 0.0 if empty."""
        return histogram_percentile(
            {"bounds": self.bounds, "counts": self.counts, "count": self.count},
            q,
        )

    def read(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


def histogram_percentile(h: dict, q: float) -> float:
    """Percentile from a snapshot-form histogram dict (``bounds``,
    ``counts``, ``count``), linearly interpolated inside the bucket; the
    overflow bucket reports its lower bound (no honest upper edge)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    count = h["count"]
    if count == 0:
        return 0.0
    bounds, counts = h["bounds"], h["counts"]
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            lo = 0.0 if i == 0 else bounds[i - 1]
            if i >= len(bounds):            # +inf overflow bucket
                return float(bounds[-1])
            frac = (target - cum) / c
            return float(lo + frac * (bounds[i] - lo))
        cum += c
    return float(bounds[-1])


def merge_disjoint(*dicts: dict) -> dict:
    """Merge stats dicts, refusing silent key collisions (a colliding key
    means two layers published under the same name — one of them must
    namespace)."""
    out: dict = {}
    for d in dicts:
        clash = out.keys() & d.keys()
        if clash:
            raise ValueError(
                f"stats key collision across layers: {sorted(clash)}; "
                f"namespace the keys at the publishing layer"
            )
        out.update(d)
    return out


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return "_" + n if n[:1].isdigit() else n


def _prom_num(v: Number) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


class MetricsRegistry:
    """Create-or-get metric instruments plus snapshot-time collectors.

    Instrument getters are idempotent: asking for an existing name
    returns the existing instrument (and raises if the kind differs —
    a kind change is a schema break, not a merge).
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # ------------------------------------------------------------------ #
    def _get(self, cls, name: str, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
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

    def info(self, name: str) -> Info:
        return self._get(Info, name)

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        if bounds is None:
            return self._get(Histogram, name, LATENCY_BOUNDS_S)
        h = self._get(Histogram, name, bounds)
        if tuple(float(b) for b in bounds) != h.bounds:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"bounds"
            )
        return h

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """``fn(registry)`` runs (in registration order) at the start of
        every :meth:`snapshot` to publish externally-owned state."""
        self._collectors.append(fn)

    # ------------------------------------------------------------------ #
    def collect(self) -> None:
        for fn in self._collectors:
            fn(self)

    def schema(self) -> Dict[str, str]:
        """``{name: kind}`` for every registered metric (collectors run
        first so lazily-created instruments are included)."""
        self.collect()
        return {name: m.kind for name, m in sorted(self._metrics.items())}

    def snapshot(self) -> dict:
        """One coherent ``{name: value}`` view of every metric; histogram
        values expand to their bucket dicts.  JSON-serializable as-is."""
        self.collect()
        return {name: m.read() for name, m in sorted(self._metrics.items())}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the current snapshot."""
        snap = self.snapshot()
        kinds = {name: m.kind for name, m in self._metrics.items()}
        lines: List[str] = []
        for name, value in snap.items():
            pname, kind = _prom_name(name), kinds[name]
            if kind == "info":
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f'{pname}{{value="{value}"}} 1')
            elif kind == "histogram":
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for b, c in zip(value["bounds"], value["counts"]):
                    cum += c
                    lines.append(
                        f'{pname}_bucket{{le="{_prom_num(float(b))}"}} {cum}'
                    )
                lines.append(
                    f'{pname}_bucket{{le="+Inf"}} {value["count"]}'
                )
                lines.append(f"{pname}_sum {_prom_num(value['sum'])}")
                lines.append(f"{pname}_count {value['count']}")
            else:
                lines.append(f"# TYPE {pname} {kind}")
                lines.append(f"{pname} {_prom_num(value)}")
        return "\n".join(lines) + "\n"

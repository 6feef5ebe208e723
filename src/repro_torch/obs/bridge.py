"""Bridges from other stats surfaces into the metrics registry.

Counterpart of ``repro.obs.bridge``.  Two kinds of vocabulary publish
through here so they land in one snapshot under one naming scheme:

  * the paper's host-side ``Counters`` dataclass (entries traversed,
    candidates generated, full similarities — the Fig. 2/6 vocabulary),
    or any dataclass of numbers;
  * flat namespaced dicts computed from device state at snapshot time.
"""

from __future__ import annotations

import dataclasses

from .registry import MetricsRegistry

__all__ = ["publish_counters", "publish_flat"]

# flat-dict keys whose last path segment names a point-in-time reading
# (everything else a flat publisher emits is a monotonic total)
_GAUGE_LEAVES = frozenset({"live_slots", "cursor", "n_shards"})


def publish_counters(
    registry: MetricsRegistry, counters, prefix: str = "paper"
) -> None:
    """Register a collector republishing a counters dataclass under
    ``<prefix>/<field>`` keys.

    The dataclass stays the live owner — the collector re-reads it at
    every snapshot, so one instance threaded through a joiner keeps the
    registry current with no further calls.  ``peak_*`` fields publish as
    gauges (they are maxima, not totals).
    """
    fields = [f.name for f in dataclasses.fields(type(counters))]

    def collect(reg: MetricsRegistry) -> None:
        for name in fields:
            v = getattr(counters, name)
            if name.startswith("peak_"):
                reg.gauge(f"{prefix}/{name}").set(v)
            else:
                reg.counter(f"{prefix}/{name}").set(v)

    registry.register_collector(collect)


def publish_flat(registry: MetricsRegistry, flat: dict) -> None:
    """Publish a flat ``{namespaced_key: number}`` dict, classifying each
    key as gauge or counter by its leaf name (see ``_GAUGE_LEAVES``)."""
    for name, v in flat.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in _GAUGE_LEAVES:
            registry.gauge(name).set(v)
        else:
            registry.counter(name).set(v)

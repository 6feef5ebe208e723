"""Pipeline span tracing: per-stage wall time for the serving path.

Counterpart of ``repro.obs.spans``.  The serving pipeline is a fixed
sequence of host-side stages — ``admit → coalesce → h2d → scan → drain →
emit`` — and each stage's wall time accumulates into the shared
:class:`~repro_torch.obs.registry.MetricsRegistry` under
``span/<stage>/time_s`` (a float counter) and ``span/<stage>/calls``.

Timing uses :func:`time.monotonic`.  Two caveats the keys are named
around:

  * ``scan`` measures the host loop that *enqueues* a request's
    micro-batches on the CUDA stream, not device execution: the device
    time hides inside whichever later stage first waits on the result
    (normally ``drain``, the copy thread's D2H, recorded via
    :meth:`SpanTracer.record` with a duration measured on that thread);
  * for device-side attribution, wrap a region in
    :meth:`SpanTracer.torch_trace` — a guarded hook around a
    ``torch.profiler`` capture that degrades to a no-op when the profiler
    cannot start.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Tuple

from .registry import MetricsRegistry

__all__ = ["PIPELINE_STAGES", "SpanTracer"]

# canonical serving-pipeline stage names, in pipeline order
PIPELINE_STAGES: Tuple[str, ...] = (
    "admit", "coalesce", "h2d", "scan", "drain", "emit",
)


class SpanTracer:
    """Accumulate per-stage wall time into a metrics registry."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "span") -> None:
        self.registry = registry
        self.prefix = prefix

    def record(self, stage: str, seconds: float) -> None:
        """Record one completed span measured elsewhere (e.g. on the
        drain copy thread, whose duration is stamped by the worker)."""
        p = f"{self.prefix}/{stage}"
        self.registry.counter(f"{p}/calls").inc(1)
        self.registry.counter(f"{p}/time_s").inc(float(seconds))

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        """Time a pipeline stage: ``with tracer.span("coalesce"): …``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(stage, time.monotonic() - t0)

    @contextlib.contextmanager
    def torch_trace(self, logdir: str) -> Iterator[bool]:
        """Capture a ``torch.profiler`` trace of the wrapped region into
        ``logdir`` (a Chrome/Perfetto trace file).  Yields whether capture
        actually started; degrades to a no-op — never an error — when the
        profiler cannot start or cannot write, so callers can leave the
        hook in place unconditionally.  Counts captures under
        ``<prefix>/torch_traces``."""
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=acts,
                           on_trace_ready=tensorboard_trace_handler(logdir))
            prof.start()
        except Exception:
            prof = None
        try:
            yield prof is not None
        finally:
            if prof is not None:
                with contextlib.suppress(Exception):
                    prof.stop()
            self.registry.counter(f"{self.prefix}/torch_traces").inc(
                1 if prof is not None else 0
            )

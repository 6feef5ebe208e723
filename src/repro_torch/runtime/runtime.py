"""Multi-tenant streaming runtime: K logical streams on one engine.

Counterpart of ``repro.runtime.runtime``.  Thousands of small streams,
each too slow to fill a micro-batch alone, are multiplexed onto one
engine:

  * **stream-tagged state** — every ring slot and every drained pair
    carries a stream id; the join masks cross-stream pairs on the device,
    with per-stream ``(θ, λ)`` from the
    :class:`~repro_torch.runtime.tenants.TenantTable`;
  * **request coalescing** — the :class:`~repro_torch.runtime.router
    .RequestRouter` packs sub-batch arrivals from many tenants into full
    micro-batches in strict admission order; padding waste and queue
    delay are telemetered;
  * **fixed-span dispatch** — each dispatch runs exactly ``span``
    micro-batches; a short tail rides out with inert micro-batches (no
    valid row, ``t = 3e30``, every strip dead), as in the reference,
    where one compiled scan serves every dispatch.  Here they cost a full
    micro-step of launches each (``runtime/empty_micro_batches`` counts
    them).

The reference's ``lax.scan`` over a span is a host loop of micro-steps on
one CUDA stream (:func:`make_tenant_batch_step`).  The :class:`EngineFacade`
seam keeps the runtime engine-agnostic: :class:`SingleDeviceFacade` runs
one ring on one device, :class:`ShardedFacade` spreads the ring over a
device mesh (:mod:`repro_torch.engine.sharded`), with the same emissions.
With a :class:`FusedEmbedder` (single device) submissions are token
batches, and the LM forward, pooling and normalization run inside the
step, micro-batch by micro-batch: embeddings never visit the host.

Determinism: uids are assigned at admission (global arrival order), the
router preserves that order exactly, and the engine is invariant to
micro-batch splits, so the emitted pair set is invariant to coalescing
boundaries, flush timing and span size.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, canonical_device, resolve_device
from ..configs.base import ModelConfig
from ..engine.engine import (
    EngineConfig,
    StreamEngineBase,
    init_telemetry,
    make_micro_step,
    require_whole_tiles,
    stack_outputs,
)
from ..engine.sharded import (
    init_sharded_telemetry,
    init_sharded_window,
    make_sharded_batch_step,
    shard_metrics,
    shard_view,
    window_axis,
)
from ..engine.window import init_window, push_with_overflow
from ..launch.mesh import Mesh
from ..obs import SpanTracer, merge_disjoint, publish_flat
from .router import RequestRouter, TenantBackpressure
from .tenants import TenantTable

__all__ = [
    "EngineFacade",
    "FusedEmbedder",
    "MultiTenantRuntime",
    "ShardedFacade",
    "SingleDeviceFacade",
    "TenantBackpressure",
    "make_tenant_batch_step",
]

_EMPTY_T = 3.0e30   # timestamp of inert pad rows in empty micro-batches


@dataclasses.dataclass(frozen=True)
class FusedEmbedder:
    """Embed-inside-the-join configuration for token submissions.

    ``model_cfg.d_model`` must equal ``EngineConfig.d``; ``seq_len`` fixes
    the token payload's width; ``params`` (the port's, e.g. from
    :func:`repro_torch.models.init_lm`) lie on the runtime's device.  The
    embedding is :func:`repro_torch.serving.embedder.pooled_unit_embed`,
    the function the host-side :class:`~repro_torch.serving.embedder
    .LMEmbedder` calls on its request batches.
    """

    model_cfg: ModelConfig
    params: Any
    seq_len: int


class EngineFacade:
    """Construct/step/drain/stats seam between the runtime and an engine.

    The runtime owns admission, coalescing, uid→tenant attribution and the
    host drain (inherited from :class:`~repro_torch.engine.engine
    .StreamEngineBase`); a facade supplies the engine-specific pieces:
    :meth:`init_state` / :meth:`init_telemetry` (the window with its
    ``sids`` lane and per-tenant policy lanes, and the telemetry),
    :meth:`make_step` (the stream-tagged batch step ``(state, telem, qs,
    tqs, uqs, sqs, nvs) → (bufs, masks)``, embedding token payloads first
    with a :class:`FusedEmbedder`), :meth:`global_capacity` (the
    dense-equivalent traffic accounting), :meth:`metrics_extra`
    (engine-specific counters, published flat into the registry) and
    :meth:`home_device` (where requests are uploaded and results drained).
    """

    def home_device(self, device: DeviceLike) -> torch.device:
        return resolve_device(device)

    def init_state(self, cfg: EngineConfig, table: TenantTable,
                   device: torch.device):
        raise NotImplementedError

    def init_telemetry(self, cfg: EngineConfig, device: torch.device):
        raise NotImplementedError

    def make_step(self, cfg: EngineConfig, table: TenantTable,
                  device: torch.device, fused: Optional[FusedEmbedder] = None):
        raise NotImplementedError

    def global_capacity(self, cfg: EngineConfig) -> int:
        raise NotImplementedError

    def metrics_extra(self, state, telem) -> dict:
        return {}


class SingleDeviceFacade(EngineFacade):
    """Default facade: one ring window on one device."""

    def init_state(self, cfg, table, device):
        # the per-tenant lanes are always there in the runtime: overflow is
        # charged to the victim stream under every policy
        return init_window(
            cfg.capacity, cfg.d, n_lanes=table.n_tenants,
            eviction=cfg.eviction,
            summary_block_w=cfg.block_w if cfg.gate_enabled else None,
            summary_chunk_d=cfg.chunk_d, device=device,
        )

    def init_telemetry(self, cfg, device):
        return init_telemetry(device)

    def make_step(self, cfg, table, device, fused=None):
        return make_tenant_batch_step(cfg, table, fused, device)

    def global_capacity(self, cfg: EngineConfig) -> int:
        return cfg.capacity


class ShardedFacade(EngineFacade):
    """Sharded facade: one ring shard per device along the window axis.

    ``cfg.capacity`` stays the per-shard ring size (global window =
    ``capacity × n_shards``, as for :class:`~repro_torch.engine.sharded
    .ShardedStreamEngine`) and ``cfg.max_pairs`` the global budget per
    micro-batch; ``cfg.micro_batch`` must divide by the shard count (the
    round-robin deal).  The runtime uploads to and drains from the first
    shard's device.  The fused embed→join is single-device only.
    """

    def __init__(self, mesh: Mesh) -> None:
        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a repro_torch Mesh (launch.make_mesh_for), "
                f"got {type(mesh).__name__}"
            )
        self.mesh = mesh
        self.axis = window_axis(mesh)
        self.n_shards = int(mesh.shape[self.axis])

    def home_device(self, device: DeviceLike) -> torch.device:
        home = self.mesh.devices_along(self.axis)[0]
        if device is not None and canonical_device(device) != home:
            raise ValueError(
                f"the sharded runtime runs from its mesh's first device "
                f"{home}, not {device}"
            )
        return home

    def init_state(self, cfg, table, device):
        return init_sharded_window(cfg, self.mesh, self.axis,
                                   n_lanes=table.n_tenants)

    def init_telemetry(self, cfg, device):
        return init_sharded_telemetry(self.mesh, self.axis)

    def make_step(self, cfg, table, device, fused=None):
        if fused is not None:
            raise NotImplementedError(
                "fused embed→join is single-device only; submit vectors "
                "(or embed on the host) when running on ShardedFacade"
            )
        return make_sharded_batch_step(cfg, self.mesh, self.axis, table=table)

    def global_capacity(self, cfg: EngineConfig) -> int:
        return cfg.capacity * self.n_shards

    def metrics_extra(self, state, telem) -> dict:
        return shard_metrics(state, telem, self.n_shards)


def make_tenant_batch_step(cfg: EngineConfig, table: TenantTable,
                           fused: Optional[FusedEmbedder] = None,
                           device: DeviceLike = None):
    """The multi-tenant request step (single device): ``(state, telem, qs,
    tqs, uqs, sqs, nvs) → (bufs, masks)``, :func:`repro_torch.engine
    .make_batch_step` plus the ``sqs (n_micro, mb)`` stream-id lane.  With
    ``fused``, ``qs`` is a token stack ``(n_micro, mb, seq_len)`` and each
    micro-batch is embedded before its joins.  The ring's overflow horizon
    is the table's widest; ``device`` holds the quota table, and a
    kernel-route step on CUDA needs whole tiles."""
    require_whole_tiles(cfg, device)
    tau = table.tau_max
    quo = cfg.quotas_device(device)

    def ingest(state, q, tq, uq, n_valid, t_max, sq):
        push_with_overflow(
            state, q, tq, uq, n_valid, t_max, tau, sq=sq,
            eviction=cfg.eviction, quotas=quo,
            summary_block_w=cfg.block_w, summary_chunk_d=cfg.chunk_d,
        )

    embed_fn = None
    if fused is not None:
        # imported here: serving.service imports this package for the
        # multi-tenant service, so a module-level import would cycle
        from ..serving.embedder import pooled_unit_embed

        def embed_fn(toks):
            return pooled_unit_embed(fused.params, fused.model_cfg, toks)

    micro = make_micro_step(cfg, ingest, tenant_lookup=table.lookup,
                            embed_fn=embed_fn)

    def batch_step(state, telem, qs, tqs, uqs, sqs, nvs):
        return stack_outputs([
            micro(state, telem, qs[m], tqs[m], uqs[m], int(nvs[m]), sqs[m])
            for m in range(qs.shape[0])
        ])

    return batch_step


class MultiTenantRuntime(StreamEngineBase):
    """K logical streams multiplexed onto one stream-tagged engine.

    ``submit(tenant, vecs, ts)`` admits a (possibly tiny) batch and
    returns its global uids; ``flush()`` coalesces everything queued into
    full micro-batches and dispatches them in ``span``-sized steps
    (``flush(final=True)`` also pads out a trailing partial micro-batch);
    ``drain_by_tenant()`` returns each tenant's emitted pairs.  The
    inherited :meth:`drain_arrays` / :meth:`stats` work on the global
    stream.  The engine runs on ``device`` (``None`` = CUDA), or with
    ``engine=ShardedFacade(mesh)`` on the mesh's devices, with the same
    emissions.  With ``fused`` (a :class:`FusedEmbedder`, single device)
    ``submit`` takes ``(b, seq_len)`` int tokens, embedded on the device
    inside each step.

    Timestamps should be globally non-decreasing in admission order:
    correctness never depends on it, but window eviction and the gate are
    tuned for it.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        table: TenantTable,
        *,
        span: int = 4,
        max_queue_per_tenant: int = 65536,
        fused: Optional[FusedEmbedder] = None,
        engine: Optional[EngineFacade] = None,
        device: DeviceLike = None,
    ) -> None:
        if cfg.emit_dense:
            raise ValueError("emit_dense is the single-tenant test oracle")
        if table.is_uniform:
            # uniform tenants keep the scalar join path; the table's values
            # are authoritative, so fold them into the config
            th, lm = table.spec(0)
            cfg = dataclasses.replace(cfg, theta=th, lam=lm)
        if fused is not None and fused.model_cfg.d_model != cfg.d:
            raise ValueError(
                f"fused embedder d_model ({fused.model_cfg.d_model}) must "
                f"equal EngineConfig.d ({cfg.d})"
            )
        if cfg.quotas is not None and len(cfg.quotas) != table.n_tenants:
            raise ValueError(
                f"quota table has {len(cfg.quotas)} entries but the tenant "
                f"table has {table.n_tenants} streams"
            )
        if span < 1:
            raise ValueError("span must be ≥ 1")
        engine = engine or SingleDeviceFacade()
        super().__init__(cfg, engine.home_device(device))
        self.table = table
        self.span = span
        self.fused = fused
        self.engine = engine
        self.router = RequestRouter(
            table.n_tenants, max_queue_per_tenant=max_queue_per_tenant
        )
        self.state = self.engine.init_state(cfg, table, self.device)
        self.telem = self.engine.init_telemetry(cfg, self.device)
        self._step = self.engine.make_step(cfg, table, self.device, fused)
        # the engine's registry is the one stats surface: router, tenant,
        # span and latency metrics join it
        self.tracer = SpanTracer(self.registry)
        self._lat_hist = self.registry.histogram("latency/admit_to_emit_s")
        self._lat_by_tenant = [
            self.registry.histogram(f"tenant/{t}/latency_s")
            for t in range(table.n_tenants)
        ]
        # (sids, t_admit) per dispatch, FIFO: drained records arrive in
        # dispatch order (one copy thread), so attribution zips exactly
        self._dispatch_meta: Deque[Tuple[np.ndarray, np.ndarray]] = deque()
        self.registry.register_collector(self._publish_runtime_metrics)
        # uid → tenant map: a doubling append buffer (4 B per item admitted)
        self._uid_tenant_buf = np.empty((1024,), np.int32)
        self._uid_tenant_n = 0
        self._mask_uid0 = 0          # first uid the next drain's mask covers
        self.padded_rows = 0         # inert rows in real micro-batches
        self.empty_micro_batches = 0  # span-fill micro-batches (all dead)
        self.spans_dispatched = 0
        self.submitted_by_tenant: Dict[int, int] = {
            t: 0 for t in range(table.n_tenants)
        }
        self.pairs_by_tenant: Dict[int, int] = {
            t: 0 for t in range(table.n_tenants)
        }

    # ------------------------------------------------------------------ #
    def push(self, vecs, ts):
        raise NotImplementedError(
            "MultiTenantRuntime routes arrivals through submit()/flush()"
        )

    def submit(self, tenant: int, data: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Admit one tenant's ``(b, d)`` vectors (callers normalize), or
        ``(b, seq_len)`` int tokens in fused mode; returns their global
        uids.  Nothing reaches the device until :meth:`flush`.  Raises
        :class:`~repro_torch.runtime.router.TenantBackpressure` (admitting
        nothing) when the tenant's queue cap would be exceeded."""
        tenant = self.table.validate_id(tenant)
        ts = np.asarray(ts, np.float64).reshape(-1)
        if self.fused is not None:
            data = np.asarray(data, np.int32)
            if data.ndim != 2 or data.shape[1] != self.fused.seq_len:
                raise ValueError(
                    f"fused submissions must be (b, {self.fused.seq_len}) "
                    f"tokens, got {data.shape}"
                )
        else:
            data = np.asarray(data, np.float32)
            if data.ndim != 2 or data.shape[1] != self.cfg.d:
                raise ValueError(
                    f"submissions must be (b, {self.cfg.d}) vectors, "
                    f"got {data.shape}"
                )
        b = data.shape[0]
        if b != ts.shape[0]:
            raise ValueError(f"{b} rows but {ts.shape[0]} timestamps")
        if b == 0:
            return np.empty((0,), np.int32)
        uids = np.arange(self._next_uid, self._next_uid + b, dtype=np.int32)
        with self.tracer.span("admit"):
            self.router.admit(tenant, data, ts, uids)  # all-or-nothing
        self._next_uid += b
        n = self._uid_tenant_n
        if n + b > self._uid_tenant_buf.size:
            grown = np.empty((max(2 * self._uid_tenant_buf.size, n + b),),
                             np.int32)
            grown[:n] = self._uid_tenant_buf[:n]
            self._uid_tenant_buf = grown
        self._uid_tenant_buf[n:n + b] = tenant
        self._uid_tenant_n = n + b
        self.submitted_by_tenant[tenant] += b
        return uids

    # ------------------------------------------------------------------ #
    def _dispatch(self, payload, ts, uids, sids, t_admit) -> None:
        """Pack one span of micro-batches and run the device step."""
        cfg = self.cfg
        mb, span = cfg.micro_batch, self.span
        rows = span * mb
        n = payload.shape[0]
        assert n <= rows
        n_real = -(-n // mb)                     # micro-batches with any data
        with self.tracer.span("coalesce"):
            # pad rows: zero vectors, or all-pad (token 0) documents, which
            # embed to the zero vector
            if self.fused is not None:
                pl = np.zeros((rows, self.fused.seq_len), np.int32)
            else:
                pl = np.zeros((rows, cfg.d), np.float32)
            pl[:n] = payload
            tq = np.full(rows, _EMPTY_T, np.float32)  # inert: all strips dead
            tq[:n] = ts
            if n and n_real * mb > n:
                # partial tail micro-batch: repeat its last valid timestamp
                # so the strips' time extremes stay honest (pad_request)
                tq[n:n_real * mb] = ts[-1]
            uq = np.full(rows, -1, np.int32)
            uq[:n] = uids
            sq = np.full(rows, -1, np.int32)
            sq[:n] = sids
            nvs = np.clip(n - mb * np.arange(span), 0, mb).astype(np.int32)

        dev = self.device
        with self.tracer.span("h2d"):
            args = (torch.from_numpy(pl.reshape(span, mb, -1)).to(dev),
                    *(torch.from_numpy(x.reshape(span, mb)).to(dev)
                      for x in (tq, uq, sq)))
        with self.tracer.span("scan"):
            # enqueue time only: the device's time shows in the drain span
            bufs, masks = self._step(self.state, self.telem, *args, nvs)
        self._dispatch_meta.append((sids, t_admit))
        self._enqueue_fetch(bufs, masks, nvs)
        self.n_items += n
        # padding waste = inert rows inside real micro-batches; span-fill
        # micro-batches are counted apart
        self.padded_rows += n_real * mb - n
        self.empty_micro_batches += span - n_real
        self.spans_dispatched += 1
        # dense-equivalent traffic counts real micro-batches only
        self.bytes_dense_equiv += n_real * 4 * (
            mb * self._global_capacity() + mb * mb
        )

    def flush(self, final: bool = False) -> int:
        """Coalesce queued arrivals into micro-batches and dispatch them.

        Dispatches every full micro-batch (in span-sized steps; a short
        span rides out with inert micro-batches).  Rows short of a
        micro-batch stay queued for the next flush, unless ``final=True``,
        which pads the tail out.  Returns the number of rows dispatched.
        """
        mb = self.cfg.micro_batch
        rows_span = mb * self.span
        sent = 0
        while len(self.router) >= rows_span:
            self._dispatch(*self.router.take(rows_span))
            sent += rows_span
        rem = len(self.router)
        take_n = rem if final else (rem // mb) * mb
        if take_n:
            self._dispatch(*self.router.take(take_n))
            sent += take_n
        return sent

    # ------------------------------------------------------------------ #
    def _tenant_of(self, uids: np.ndarray) -> np.ndarray:
        return self._uid_tenant_buf[:self._uid_tenant_n][uids]

    def drain_arrays(self, return_masks: bool = False):
        """As :meth:`StreamEngineBase.drain_arrays`, tracking the uid range
        each drain's masks cover so per-tenant attribution stays aligned
        however global and per-tenant drains are mixed."""
        ua, ub, sc, mask = super().drain_arrays(return_masks=True)
        self._mask_uid0 += mask.shape[0]
        if return_masks:
            return ua, ub, sc, mask
        return ua, ub, sc

    def drain_by_tenant(
        self, return_masks: bool = False
    ) -> Dict[int, Tuple[np.ndarray, ...]]:
        """Everything emitted since the last drain, grouped by stream:
        ``{tenant: (uid_a, uid_b, score)}`` with global uids.  With
        ``return_masks=True`` each tuple gains the tenant's per-row match
        masks, aligned with its dispatched uids in admission order.  A
        pair's tenant is ``uid_a``'s: the join's stream mask guarantees
        ``uid_b`` agrees."""
        with self.tracer.span("emit"):
            return self._drain_by_tenant(return_masks)

    def _drain_by_tenant(
        self, return_masks: bool = False
    ) -> Dict[int, Tuple[np.ndarray, ...]]:
        ua, ub, sc, mask = self.drain_arrays(return_masks=True)
        mask_uids = np.arange(
            self._mask_uid0 - mask.shape[0], self._mask_uid0, dtype=np.int64
        )
        k = self.table.n_tenants
        tids = np.arange(k)

        def group(keys, *values):
            # one stable sort and K boundary lookups; stable keeps the
            # emission/admission order within each tenant
            order = np.argsort(keys, kind="stable")
            ks = keys[order]
            lo = np.searchsorted(ks, tids)
            hi = np.searchsorted(ks, tids, side="right")
            return [
                tuple(v[order[a:b]] for v in values)
                for a, b in zip(lo, hi)
            ]

        pair_t = self._tenant_of(ua) if ua.size else np.empty((0,), np.int32)
        mask_t = (
            self._tenant_of(mask_uids) if mask.size else np.empty((0,), np.int32)
        )
        pair_groups = group(pair_t, ua, ub, sc)
        mask_groups = group(mask_t, mask) if return_masks else None
        out: Dict[int, Tuple[np.ndarray, ...]] = {}
        for t in range(k):
            rec: Tuple[np.ndarray, ...] = pair_groups[t]
            self.pairs_by_tenant[t] += rec[0].size
            if return_masks:
                rec = rec + mask_groups[t]
            out[t] = rec
        return out

    # ------------------------------------------------------------------ #
    def tenant_stats(self, tenant: int) -> dict:
        tenant = self.table.validate_id(tenant)
        th, lm = self.table.spec(tenant)
        by_tenant = self.overflow_by_tenant
        return {
            "theta": th,
            "lam": lm,
            "submitted": self.submitted_by_tenant[tenant],
            "queued": self.router.queued_by_tenant[tenant],
            "pairs_drained": self.pairs_by_tenant[tenant],
            # this tenant's live items lost to overwrite (victim side)
            "window_overflow": int(by_tenant[tenant]),
            "quota": (
                None if self.cfg.quotas is None
                else int(self.cfg.quotas[tenant])
                * self.engine.global_capacity(self.cfg) // self.cfg.capacity
            ),
        }

    def _global_capacity(self) -> int:
        return self.engine.global_capacity(self.cfg)

    # ------------------------------------------------------------------ #
    def _observe_emission(self, t_done: float, fetch_s: float) -> None:
        """Attribute one drained record's admission→emission latency.
        Records leave :meth:`_drain` in dispatch order and ``push()`` is
        disabled, so each pairs with one ``(sids, t_admit)`` entry queued
        by :meth:`_dispatch`."""
        self.tracer.record("drain", fetch_s)
        if not self._dispatch_meta:
            return
        sids, t_admit = self._dispatch_meta.popleft()
        lat = np.maximum(t_done - t_admit, 0.0)
        self._lat_hist.observe_many(lat)
        for t in np.unique(sids):
            self._lat_by_tenant[int(t)].observe_many(lat[sids == t])

    def _publish_runtime_metrics(self, reg) -> None:
        """Snapshot-time collector: router/runtime/per-tenant counters
        beside the engine collector of :class:`StreamEngineBase`."""
        rt = self.router.telemetry
        c, g = reg.counter, reg.gauge
        c("router/items_admitted").set(rt.items_admitted)
        c("router/items_rejected").set(rt.items_rejected)
        c("router/items_dispatched").set(rt.items_dispatched)
        c("router/queue_delay_sum_s").set(rt.queue_delay_sum_s)
        g("router/queue_delay_max_s").set(rt.queue_delay_max_s)
        g("router/items_queued").set(len(self.router))
        reg.info("runtime/eviction").set(self.cfg.eviction)
        g("runtime/n_tenants").set(self.table.n_tenants)
        c("runtime/spans_dispatched").set(self.spans_dispatched)
        c("runtime/padded_rows").set(self.padded_rows)
        c("runtime/empty_micro_batches").set(self.empty_micro_batches)
        for t in range(self.table.n_tenants):
            c(f"tenant/{t}/submitted").set(self.submitted_by_tenant[t])
            g(f"tenant/{t}/queued").set(self.router.queued_by_tenant[t])
            c(f"tenant/{t}/pairs_drained").set(self.pairs_by_tenant[t])
        publish_flat(reg, self.engine.metrics_extra(self.state, self.telem))

    def stats(self) -> dict:
        """Legacy flat stats, derived from one registry snapshot, so every
        value equals its namespaced metric."""
        snap = self.registry.snapshot()
        disp = snap["router/items_dispatched"]
        padded = snap["runtime/padded_rows"]
        runtime_view = {
            "eviction": snap["runtime/eviction"],
            "n_tenants": snap["runtime/n_tenants"],
            "items_queued": snap["router/items_queued"],
            "items_rejected": snap["router/items_rejected"],
            "spans_dispatched": snap["runtime/spans_dispatched"],
            "padded_rows": padded,
            "empty_micro_batches": snap["runtime/empty_micro_batches"],
            "padding_waste": padded / max(padded + disp, 1),
            "queue_delay_mean_s": snap["router/queue_delay_sum_s"]
            / max(disp, 1),
            "queue_delay_max_s": snap["router/queue_delay_max_s"],
        }
        shard = shard_view(snap) if "engine/n_shards" in snap else {}
        return merge_disjoint(self._legacy_engine_view(snap), shard, runtime_view)

"""Sharded fan-out: each shard owns a ring of the window, on its device.

Counterpart of ``repro.engine.sharded``.  The window is split over the
mesh axis the ``"window"`` logical axis resolves to
(:data:`repro_torch.distributed.sharding.DEFAULT_RULES` maps it to
``"data"``), so the global window grows with the shard count.  The
reference runs the shards under one ``shard_map``; here one process runs
a host loop over them, each shard's state a :class:`WindowState` on its
own device (several shards may share one device).

Per micro-batch, for each shard in turn (on its device):

  * the micro-batch is replicated: each shard joins all of it against its
    own ring only (the engine's micro step, :func:`repro_torch.engine
    .make_micro_step`);
  * within-batch pairs are computed on every shard but kept on shard 0
    only (its ``self_mask``), so each pair appears once; row masks stay
    unmasked and are OR-reduced over shards;
  * each shard merges its tiles into a ``(shard_k,)`` buffer (level 2);
  * arrivals are dealt round-robin: row ``i`` of the micro-batch lands on
    shard ``i mod p``, so every ring ages uniformly.

Then the ``(shard_k,)`` buffers and row masks are gathered onto the first
shard's device and one more merge packs them into the global
``(max_pairs,)`` buffer (level 3).  ``max_pairs`` is a global budget.

Every drop is attributed to its level: ``tile_k`` overflow in
``dropped_tile`` and ``shard_k`` overflow in ``dropped`` of the shard's
telemetry lane, and the global merge's losses in a dedicated lane ``p``
(where ``pairs`` is corrected down too), so ``pairs_emitted`` equals what
the drain delivers and lanes ``0..p-1`` stay per-shard counters
(:func:`shard_stats`).

With a :class:`~repro_torch.runtime.TenantTable` the step takes the
stream-id lane as the multi-tenant runtime's does: each shard's ring keeps
its part of the ``sids`` lane, every shard looks its query rows' ``(θ,
λ)`` up on its own device, and under quota eviction each shard has its
own sub-rings (the quota table is per shard).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import DEFAULT_RULES, AxisRules
from ..kernels.sssj_join import PairBuffer, PairCandidates, merge_candidates
from ..launch.mesh import Mesh
from ..obs import MetricsRegistry, merge_disjoint, publish_flat
from .engine import (
    EngineConfig,
    EngineTelemetry,
    StreamEngineBase,
    host_lanes,
    init_telemetry,
    make_micro_step,
    require_whole_tiles,
    stack_outputs,
)
from .window import WindowState, init_window, push_with_overflow, window_to_numpy

__all__ = [
    "ShardedStreamEngine",
    "ShardedWindow",
    "init_sharded_telemetry",
    "init_sharded_window",
    "make_sharded_batch_step",
    "merge_shard_buffers",
    "on_device",
    "shard_metrics",
    "shard_stats",
    "shard_view",
    "window_axis",
]


def window_axis(mesh: Mesh, rules: AxisRules = DEFAULT_RULES) -> str:
    """Mesh axis the logical ``"window"`` axis resolves to under ``rules``."""
    axes = rules.lookup("window")
    if isinstance(axes, str):
        axes = (axes,)
    for a in axes or ():
        if a in mesh.axis_names:
            return a
    raise ValueError(
        f"no mesh axis for logical 'window' (rules {axes!r}, mesh {mesh.axis_names})"
    )


def on_device(dev: torch.device):
    """Make ``dev`` the current card while a shard's work is enqueued (its
    kernels launch on the current card); a no-op on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class ShardedWindow(NamedTuple):
    """The window as one :class:`WindowState` per shard, each on its
    shard's device.  ``cursor``, ``overflow`` and ``lane_overflow`` read
    as tuples of per-shard tensors; :meth:`to_numpy` gives the
    reference's global layout."""

    shards: Tuple[WindowState, ...]

    @property
    def cursor(self) -> Tuple[torch.Tensor, ...]:
        return tuple(s.cursor for s in self.shards)

    @property
    def overflow(self) -> Tuple[torch.Tensor, ...]:
        return tuple(s.overflow for s in self.shards)

    @property
    def lane_overflow(self) -> Optional[Tuple[torch.Tensor, ...]]:
        if self.shards[0].lane_overflow is None:
            return None
        return tuple(s.lane_overflow for s in self.shards)

    def to_numpy(self) -> dict:
        """:func:`~repro_torch.engine.window.window_to_numpy`'s fields in
        the reference's sharded layout: ring leaves and strip rows
        concatenated shard-major (``vecs (p·C, d)``), ``cursor`` and
        ``overflow`` as ``(p,)`` and the lanes as ``(p, n_lanes)``."""
        parts = [window_to_numpy(s) for s in self.shards]
        out = {k: np.concatenate([x[k] for x in parts])
               for k in ("vecs", "ts", "uids", "sids")}
        for k in ("cursor", "overflow"):
            out[k] = np.array([x[k] for x in parts], np.int32)
        for k in ("lane_cursor", "lane_overflow"):
            out[k] = None if parts[0][k] is None else np.stack([x[k] for x in parts])
        out["summary"] = None if parts[0]["summary"] is None else {
            k: np.concatenate([x["summary"][k] for x in parts])
            for k in parts[0]["summary"]
        }
        return out


def init_sharded_window(
    cfg: EngineConfig, mesh: Mesh, axis: str, n_lanes: Optional[int] = None
) -> ShardedWindow:
    """``cfg.capacity`` slots per shard on each device along ``axis``.

    The ``sids`` lane is always there, so one state serves the
    single-stream engine and the multi-tenant runtime.  ``n_lanes``
    (default: the quota table's) adds each shard's per-stream lanes:
    quota sub-rings and their cursors are local to each shard.  Strip
    summaries are built at the per-shard geometry."""
    if n_lanes is None:
        n_lanes = cfg.n_lanes
    return ShardedWindow(tuple(
        init_window(
            cfg.capacity, cfg.d, n_lanes=n_lanes, eviction=cfg.eviction,
            summary_block_w=cfg.block_w if cfg.gate_enabled else None,
            summary_chunk_d=cfg.chunk_d, device=dev,
        )
        for dev in mesh.devices_along(axis)
    ))


def init_sharded_telemetry(mesh: Mesh, axis: str) -> EngineTelemetry:
    """Telemetry with ``p + 1`` lanes: each field a tuple of scalars, lane
    ``i < p`` on shard ``i``'s device, lane ``p`` (the global merge's
    correction) on the first shard's."""
    devices = mesh.devices_along(axis)
    lanes = [init_telemetry(dev) for dev in devices + devices[:1]]
    return EngineTelemetry(*zip(*lanes))


def _lane(telem: EngineTelemetry, i: int) -> EngineTelemetry:
    """Lane ``i`` of sharded telemetry: its scalars, updated in place."""
    return EngineTelemetry(*(f[i] for f in telem))


def merge_shard_buffers(
    bufs: Sequence[PairBuffer], *, max_pairs: int, device: torch.device
) -> PairBuffer:
    """Level 3: the shards' ``(shard_k,)`` buffers gathered onto
    ``device`` and packed into one ``(max_pairs,)`` buffer.  Survivors are
    the earliest pairs in (shard, rank) order; ``n_dropped`` counts what
    the global budget lost (losses inside a shard were counted there)."""
    def gather(xs):
        return torch.stack([x.to(device, non_blocking=True) for x in xs])

    kept = gather([b.n_pairs.reshape(()) for b in bufs])
    return merge_candidates(
        PairCandidates(
            uid_a=gather([b.uid_a for b in bufs]),
            uid_b=gather([b.uid_b for b in bufs]),
            score=gather([b.score for b in bufs]),
            kept=kept,
            emitted=kept,
        ),
        max_pairs=max_pairs,
    )


def make_sharded_batch_step(cfg: EngineConfig, mesh: Mesh, axis: str, table=None):
    """The request step over the shards, with
    :func:`repro_torch.engine.make_batch_step`'s signature ``(state, telem,
    qs, tqs, uqs, nvs) → (bufs, masks)`` on a :class:`ShardedWindow` and
    sharded telemetry: per micro-batch one global ``(max_pairs,)`` buffer
    and one OR-reduced row mask, on the first shard's device.

    With a :class:`~repro_torch.runtime.TenantTable` the signature is the
    multi-tenant runtime's ``(state, telem, qs, tqs, uqs, sqs, nvs)``.
    Inputs may lie on any device; each shard takes a copy on its own."""
    if cfg.emit_dense:
        raise ValueError(
            "emit_dense is the single-device test oracle; the sharded engine "
            "runs the hierarchical path only"
        )
    devices = mesh.devices_along(axis)
    p = len(devices)
    if cfg.micro_batch % p != 0:
        raise ValueError(f"micro_batch {cfg.micro_batch} not divisible by {p} shards")
    # each shard joins the whole micro-batch against its shard's ring
    require_whole_tiles(cfg, devices[0])
    multi = table is not None
    tau = table.tau_max if multi else cfg.tau
    bl = cfg.micro_batch // p       # arrivals per shard per micro-batch
    # level 2: each shard merges its tiles into a (shard_k,) buffer; the
    # global budget is applied after the gather
    local_cfg = dataclasses.replace(cfg, max_pairs=cfg.shard_k or cfg.max_pairs)
    home = devices[0]

    def keep_on_shard_0(c: PairCandidates) -> PairCandidates:
        # every shard computes the same self candidates; the other shards
        # zero their counts (a suppression, not an overflow)
        return c._replace(kept=torch.zeros_like(c.kept),
                          emitted=torch.zeros_like(c.emitted))

    def shard_micro(i: int, dev: torch.device):
        idx = i + p * torch.arange(bl, device=dev)
        quo = cfg.quotas_device(dev)

        def ingest(state, q, tq, uq, n_valid, t_max, sq=None):
            # round-robin deal: this shard takes rows i, i + p, i + 2p, …
            # (a prefix of them is valid, as n_valid rows are)
            push_with_overflow(
                state, q.index_select(0, idx), tq.index_select(0, idx),
                uq.index_select(0, idx), len(range(i, n_valid, p)), t_max, tau,
                sq=None if sq is None else sq.index_select(0, idx),
                eviction=cfg.eviction, quotas=quo,
                summary_block_w=cfg.block_w, summary_chunk_d=cfg.chunk_d,
            )

        return make_micro_step(
            local_cfg, ingest, self_mask=None if i == 0 else keep_on_shard_0,
            tenant_lookup=table.lookup if multi else None,
        )

    micros = [shard_micro(i, dev) for i, dev in enumerate(devices)]

    def run(state: ShardedWindow, telem: EngineTelemetry, lanes_in, nvs):
        # the request's lanes replicated onto each device, once a request
        local = {dev: tuple(None if x is None else x.to(dev, non_blocking=True)
                            for x in lanes_in)
                 for dev in dict.fromkeys(devices)}
        lanes = [_lane(telem, i) for i in range(p + 1)]
        outs = []
        for m in range(lanes_in[0].shape[0]):
            n_valid = int(nvs[m])
            bufs, masks = [], []
            for i, dev in enumerate(devices):
                q, tq, uq, sq = local[dev]
                args = (state.shards[i], lanes[i], q[m], tq[m], uq[m], n_valid)
                with on_device(dev):
                    buf, mask = micros[i](*args) if sq is None else micros[i](*args, sq[m])
                bufs.append(buf)
                masks.append(mask)
            with on_device(home):
                gbuf = merge_shard_buffers(bufs, max_pairs=cfg.max_pairs, device=home)
                # pairs the global budget dropped move from `pairs` to
                # `dropped` in lane p, not in any shard's lane
                lanes[p].pairs.sub_(gbuf.n_dropped)
                lanes[p].dropped.add_(gbuf.n_dropped)
                mask = torch.stack([x.to(home, non_blocking=True) for x in masks]).any(0)
            outs.append((gbuf, mask))
        return stack_outputs(outs)

    if multi:
        def batch_step(state, telem, qs, tqs, uqs, sqs, nvs):
            return run(state, telem, (qs, tqs, uqs, sqs), nvs)
    else:
        def batch_step(state, telem, qs, tqs, uqs, nvs):
            return run(state, telem, (qs, tqs, uqs, None), nvs)

    return batch_step


_SHARD_FIELDS = (
    "live_slots", "cursor", "window_overflow",
    "pairs_emitted", "pairs_dropped_budget", "pairs_dropped_tile",
    "tiles_skipped_time", "tiles_skipped_l2", "strips_survived",
)


def shard_metrics(state: ShardedWindow, telem: EngineTelemetry, n_shards: int) -> dict:
    """Per-shard liveness and drop counters as a flat namespaced dict
    (``engine/shard/<i>/…``); :func:`shard_stats` is a view over it.

    Lanes ``0..n_shards-1`` are the shards' own counters; lane
    ``n_shards`` holds the global merge's losses, published as
    ``pairs_dropped_global``, so a shard's ``pairs_emitted`` counts its
    survivors before the global budget."""
    n = n_shards
    t = EngineTelemetry(*(host_lanes(x).reshape(-1) for x in telem))
    lanes = {
        "live_slots": [int((s.uids >= 0).sum().item()) for s in state.shards],
        "cursor": host_lanes(state.cursor).reshape(-1),
        "window_overflow": host_lanes(state.overflow).reshape(-1),
        "pairs_emitted": t.pairs[:n],
        "pairs_dropped_budget": t.dropped[:n],
        "pairs_dropped_tile": t.dropped_tile[:n],
        # lane n never takes gate counters: [:n] loses nothing
        "tiles_skipped_time": t.tiles_skipped_time[:n],
        "tiles_skipped_l2": t.tiles_skipped_l2[:n],
        "strips_survived": t.strips_survived[:n],
    }
    out = {
        "engine/n_shards": n,
        "engine/pairs_dropped_global": int(t.dropped[n:].sum()),
    }
    for i in range(n):
        for f in _SHARD_FIELDS:
            out[f"engine/shard/{i}/{f}"] = int(lanes[f][i])
    return out


def shard_view(flat: dict) -> dict:
    """The nested per-shard stats, rebuilt from a flat metrics dict or
    registry snapshot holding ``engine/shard/<i>/…``."""
    n = int(flat["engine/n_shards"])
    return {
        "n_shards": n,
        "pairs_dropped_global": flat["engine/pairs_dropped_global"],
        "shards": {
            f: [flat[f"engine/shard/{i}/{f}"] for i in range(n)]
            for f in _SHARD_FIELDS
        },
    }


def shard_stats(state: ShardedWindow, telem: EngineTelemetry, n_shards: int) -> dict:
    """Nested per-shard stats: a view over :func:`shard_metrics`."""
    return shard_view(shard_metrics(state, telem, n_shards))


class ShardedStreamEngine(StreamEngineBase):
    """:class:`~repro_torch.engine.StreamEngine` over a device mesh.

    ``cfg.capacity`` is the per-shard ring size; the global window holds
    ``capacity × n_shards`` items.  ``cfg.max_pairs`` is the global
    emission budget per micro-batch and ``cfg.shard_k`` bounds what one
    shard may contribute (default: ``max_pairs``).  Requests are uploaded
    to, and results drained from, the first shard's device.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        mesh: Mesh,
    ) -> None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch Mesh, got {type(mesh).__name__}")
        axis = window_axis(mesh)
        devices: List[torch.device] = mesh.devices_along(axis)
        super().__init__(cfg, devices[0])
        self.mesh = mesh
        self.n_shards = len(devices)
        self.state = init_sharded_window(cfg, mesh, axis)
        self.telem = init_sharded_telemetry(mesh, axis)
        self._step = make_sharded_batch_step(cfg, mesh, axis)

    def _global_capacity(self) -> int:
        return self.cfg.capacity * self.n_shards

    def _publish_metrics(self, reg: MetricsRegistry) -> None:
        super()._publish_metrics(reg)
        publish_flat(reg, shard_metrics(self.state, self.telem, self.n_shards))

    def stats(self) -> dict:
        snap = self.registry.snapshot()
        return merge_disjoint(self._legacy_engine_view(snap), shard_view(snap))

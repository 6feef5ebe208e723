"""Device-resident streaming join engine, single stream.

Counterpart of ``repro.engine.engine``'s :class:`StreamEngine`.  Per
request, :meth:`StreamEngine.push` pads the batch to micro-batches and
runs them in a host loop on one CUDA stream (the reference's
``lax.scan``); each micro-batch

  1. joins against the window (strip gate, then the tile join with
     in-kernel candidate select) and within itself (ungated);
  2. merges both candidate sets into one ``(max_pairs,)`` buffer;
  3. writes itself into the ring under the configured eviction policy
     (oldest, dead or quota), refreshing the strip summaries it touched;
  4. adds its counts to the telemetry.

The same micro-step serves the multi-tenant runtime
(``repro_torch.runtime``), which adds the stream-id lane and per-row
thresholds (:func:`make_micro_step`'s ``tenant_lookup``), and each shard
of the sharded engine (:mod:`repro_torch.engine.sharded`), which keeps
the self join's pairs on one shard (``self_mask``).

With ``emit_dense=True`` (the reference's oracle path) steps 1–2 are
instead two dense tile joins, whose ``(mb, capacity + mb)`` score matrix
one row-major compaction packs into the buffer; no strip summary is kept.

The window and telemetry tensors are updated in place where JAX donated
the carry.  The outputs of one push go to a single-worker copy thread,
which waits on a CUDA event recorded after the push's last micro-batch,
copies into pinned host memory on its own stream and stamps ``t_done``;
``drain_*`` only joins on already-copied results.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.similarity import time_horizon
from ..kernels.sssj_join import (
    PairBuffer,
    compact_pairs,
    concat_candidates,
    merge_candidates,
    sssj_join_candidates,
    sssj_join_tiles,
)
from ..obs import MetricsRegistry
from .window import EVICTION_POLICIES, WindowState, init_window, push_with_overflow

__all__ = [
    "EngineConfig",
    "EngineTelemetry",
    "StreamEngine",
    "StreamEngineBase",
    "host_lanes",
    "init_telemetry",
    "make_batch_step",
    "make_micro_step",
    "pad_request",
    "require_whole_tiles",
    "stack_outputs",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    theta: float
    lam: float
    capacity: int
    d: int
    micro_batch: int = 128       # step size; requests are padded up
    max_pairs: int = 4096        # compacted-emission capacity per micro-batch
    tile_k: int = 256            # level-1 candidates kept per kernel tile
    shard_k: Optional[int] = None  # per-shard merge capacity (sharded
    #                                engine); None = max_pairs
    block_q: int = 128
    block_w: int = 128
    chunk_d: int = 128
    emit_dense: bool = False     # dense-matrix compaction (oracle path)
    join_impl: Optional[str] = None  # None = kernel path, "scan", "dense" = oracle
    use_ref: bool = False        # route joins through the dense reference
    eviction: str = "oldest"     # write-slot policy: oldest/dead/quota
    quotas: Optional[Tuple[int, ...]] = None  # per-stream slots (quota
    #                                           policy); sums to capacity
    l2_gate: Optional[bool] = None  # strip gate: True/False, None = auto
    #   (on for the kernel path and the scan, where it can skip strips)

    def __post_init__(self) -> None:
        """Reject configurations that would only fail later, deep inside
        a step."""
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"theta must be in (0, 1], got {self.theta}")
        if self.lam < 0.0:
            raise ValueError(f"lam must be ≥ 0, got {self.lam}")
        for name in ("capacity", "d", "micro_batch", "max_pairs", "tile_k",
                     "block_q", "block_w", "chunk_d"):
            v = getattr(self, name)
            if (isinstance(v, bool) or not isinstance(v, (int, np.integer))
                    or v < 1):
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.shard_k is not None and self.shard_k < 1:
            raise ValueError(f"shard_k must be ≥ 1, got {self.shard_k}")
        if self.micro_batch > self.capacity:
            raise ValueError(
                f"micro_batch ({self.micro_batch}) exceeds window capacity "
                f"({self.capacity}): a single micro-batch would overwrite "
                f"its own arrivals; raise capacity or lower micro_batch"
            )
        if self.use_ref and self.join_impl in ("pallas", "scan"):
            raise ValueError(
                f"use_ref routes joins through the dense reference and "
                f"contradicts join_impl={self.join_impl!r}; drop one"
            )
        if self.join_impl not in (None, "scan", "dense"):
            raise ValueError(
                f"join_impl must be None (kernel path), 'scan' or 'dense', "
                f"got {self.join_impl!r}"
            )
        if self.l2_gate is True and (
            self.emit_dense or self.use_ref or self.join_impl == "dense"
        ):
            raise ValueError(
                "l2_gate=True requires a gated join path; the dense oracle "
                "(emit_dense / use_ref / join_impl='dense') never consults "
                "the gate — drop l2_gate or leave it None"
            )
        if self.eviction not in EVICTION_POLICIES:
            raise ValueError(
                f"eviction must be one of {EVICTION_POLICIES}, "
                f"got {self.eviction!r}"
            )
        if self.quotas is not None:
            if self.eviction != "quota":
                raise ValueError(
                    f"quotas are only meaningful under eviction='quota' "
                    f"(got eviction={self.eviction!r})"
                )
            qs = tuple(self.quotas)
            for i, v in enumerate(qs):
                if (isinstance(v, bool) or not isinstance(v, (int, np.integer))
                        or v < 1):
                    raise ValueError(
                        f"quotas[{i}] must be a positive int, got {v!r}"
                    )
            if sum(int(v) for v in qs) != self.capacity:
                raise ValueError(
                    f"quotas must sum to capacity ({self.capacity}), got "
                    f"{sum(int(v) for v in qs)} over {len(qs)} streams"
                )
            object.__setattr__(self, "quotas", tuple(int(v) for v in qs))
        elif self.eviction == "quota":
            raise ValueError("eviction='quota' requires a quotas table")

    @property
    def tau(self) -> float:
        return time_horizon(self.theta, self.lam)

    @property
    def gate_enabled(self) -> bool:
        """Whether the window carries strip summaries and the window join
        runs the pre-launch gate."""
        if self.l2_gate is not None:
            return bool(self.l2_gate)
        return not (
            self.emit_dense or self.use_ref or self.join_impl == "dense"
        )

    @property
    def n_lanes(self) -> Optional[int]:
        """Stream lanes the window state carries for this configuration
        (from the quota table; the multi-tenant runtime widens it to its
        tenant count)."""
        return None if self.quotas is None else len(self.quotas)

    def quotas_device(self, device: DeviceLike = None) -> Optional[torch.Tensor]:
        """The quota table as a device tensor (``None`` off-quota): what
        the write-slot policy consumes in each step."""
        if self.quotas is None:
            return None
        return torch.tensor(self.quotas, dtype=torch.int64,
                            device=resolve_device(device))

    @property
    def join_kwargs(self) -> dict:
        """kwargs for :func:`sssj_join_tiles` (the ``emit_dense`` path)."""
        return dict(
            theta=self.theta, lam=self.lam, block_q=self.block_q,
            block_w=self.block_w, chunk_d=self.chunk_d, use_ref=self.use_ref,
        )

    @property
    def candidate_kwargs(self) -> dict:
        """kwargs for :func:`sssj_join_candidates` (the default path)."""
        impl = self.join_impl
        if impl is None and self.use_ref:
            impl = "dense"
        return dict(
            theta=self.theta, lam=self.lam, tile_k=self.tile_k,
            block_q=self.block_q, block_w=self.block_w, chunk_d=self.chunk_d,
            impl=impl,
        )


class EngineTelemetry(NamedTuple):
    """Device counters, updated in place.  ``chunks``/``tiles`` count the
    window join only; drops are split by level."""

    chunks: torch.Tensor        # d-chunks executed (pruning telemetry)
    tiles: torch.Tensor         # window-join tiles visited
    pairs: torch.Tensor         # pairs emitted (post-merge)
    dropped: torch.Tensor       # pairs lost to the max_pairs budget
    dropped_tile: torch.Tensor  # pairs lost to per-tile caps
    tiles_skipped_time: torch.Tensor  # gate kills by the time bound
    tiles_skipped_l2: torch.Tensor    # gate kills by the value bounds
    strips_survived: torch.Tensor     # strips some query tile admitted


def init_telemetry(device: DeviceLike = None) -> EngineTelemetry:
    dev = resolve_device(device)
    return EngineTelemetry(*(
        torch.zeros((), dtype=torch.int64, device=dev)
        for _ in EngineTelemetry._fields
    ))


def host_lanes(x) -> np.ndarray:
    """A device counter as a host array: a tensor as it is, or a tuple of
    per-shard tensors (each on its shard's device, as the sharded engine
    keeps them) stacked along a leading shard axis."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.stack([v.cpu().numpy() for v in x])


def pad_request(vecs, ts, next_uid: int, micro_batch: int):
    """Assign uids and pad a request to a micro-batch multiple (pad rows
    carry ``uid = -1`` so the order mask silences them; pad timestamps
    repeat the last valid one).

    Returns host arrays ``(uq (b,), qs (n_micro, mb, d), tqs, uqs
    (n_micro, mb), nvs (n_micro,))`` with ``nvs`` the valid-row counts.
    """
    vecs = np.asarray(vecs, np.float32)
    ts = np.asarray(ts, np.float32).reshape(-1)
    b = vecs.shape[0]
    uq = np.arange(next_uid, next_uid + b, dtype=np.int32)
    mb = micro_batch
    n_micro = -(-b // mb)
    pad = n_micro * mb - b
    if pad:
        vecs = np.concatenate([vecs, np.zeros((pad, vecs.shape[1]), np.float32)])
        ts = np.concatenate([ts, np.full(pad, ts[-1], np.float32)])
        uq_in = np.concatenate([uq, np.full(pad, -1, np.int32)])
    else:
        uq_in = uq
    nvs = np.full(n_micro, mb, np.int32)
    nvs[-1] = mb - pad
    return (
        uq,
        vecs.reshape(n_micro, mb, -1),
        ts.reshape(n_micro, mb),
        uq_in.reshape(n_micro, mb),
        nvs,
    )


def require_whole_tiles(cfg: EngineConfig, device: DeviceLike) -> None:
    """Refuse, on a CUDA device, a kernel-route step whose joins are
    smaller than one tile.  The join wrappers hand such a join (``Q <
    block_q``, ``W < block_w`` or ``d < chunk_d``) to the dense reference,
    which on the card would run in plain torch instead of the kernel.  A
    step joins the micro-batch against the ring and against itself; a CPU
    step runs any shape, as the reference does.  The device (``None`` =
    CUDA) is only named, never touched."""
    on_cuda = device is None or torch.device(device).type == "cuda"
    kernel_route = not cfg.use_ref and (cfg.emit_dense or cfg.join_impl is None)
    if not (on_cuda and kernel_route):
        return
    mb, cap = cfg.micro_batch, cfg.capacity
    if mb < cfg.block_q or min(mb, cap) < cfg.block_w or cfg.d < cfg.chunk_d:
        raise ValueError(
            f"micro_batch {mb} x window capacity {cap} at d {cfg.d} holds a "
            f"join smaller than one {cfg.block_q} x {cfg.block_w} x "
            f"{cfg.chunk_d} tile, which would not run the join kernel"
        )


def make_micro_step(
    cfg: EngineConfig,
    ingest: Callable,
    self_mask: Optional[Callable] = None,
    tenant_lookup: Optional[Callable] = None,
    embed_fn: Optional[Callable] = None,
):
    """The per-micro-batch step: ``(state, telem, q, tq, uq, n_valid[, sq])
    → (PairBuffer, row_mask (mb,) bool)``; ``state`` and ``telem`` are
    updated in place, ``n_valid`` is a host int.

    ``ingest(state, q, tq, uq, n_valid, t_max[, sq])`` writes the
    micro-batch (or a shard's part of it) into the ring, in place.
    ``self_mask`` maps the self join's candidates before the merge
    (``PairCandidates → PairCandidates``; the sharded engine keeps them on
    one shard only); the row mask keeps them.  With ``tenant_lookup`` (the
    multi-tenant runtime) the step takes the stream-id lane ``sq (mb,)``:
    the window join gets ``sq`` against the ring's ``sids``, the self join
    ``sq`` against itself, and ``tenant_lookup(sq) → (theta_q, lam_q) |
    None`` gives the per-row thresholds (``None`` for a uniform table).
    ``embed_fn`` maps the micro-batch's payload (token ids) to unit
    vectors before the joins: the fused embed→join.
    """
    kw = cfg.join_kwargs
    ckw = cfg.candidate_kwargs
    multi = tenant_lookup is not None
    if cfg.emit_dense and self_mask is not None:
        raise ValueError("the emit_dense oracle path is single-device only")
    if cfg.emit_dense and (multi or embed_fn is not None):
        raise ValueError(
            "the emit_dense oracle path is single-tenant and takes vectors; "
            "multi-tenant and fused-embed runs use the hierarchical path"
        )

    def joins(state: WindowState, q, tq, uq, sq):
        """``(PairBuffer, row_mask, window-join iters, gate stats)``."""
        dev = q.device
        if cfg.emit_dense:
            # dense (mb, capacity + mb) scores, one row-major compaction
            s_win, it_win, _ = sssj_join_tiles(
                q, state.vecs, tq, state.ts, uq, state.uids, device=dev, **kw
            )
            s_self, _, _ = sssj_join_tiles(q, q, tq, tq, uq, uq, device=dev, **kw)
            scores = torch.cat([s_win, s_self], 1)
            buf = compact_pairs(scores, uq, torch.cat([state.uids, uq]),
                                max_pairs=cfg.max_pairs)
            return (buf, (scores > 0.0).any(1), it_win,
                    torch.zeros(3, dtype=torch.int32, device=dev))
        win_kw = self_kw = {}
        if multi:
            per_row = tenant_lookup(sq)
            theta_q, lam_q = per_row if per_row is not None else (None, None)
            win_kw = dict(sq=sq, sw=state.sids, theta_q=theta_q, lam_q=lam_q)
            self_kw = dict(sq=sq, sw=sq, theta_q=theta_q, lam_q=lam_q)
        # the window join consults the strip summary (None = ungated); the
        # self join never does: its one strip is this micro-batch
        jw = sssj_join_candidates(
            q, state.vecs, tq, state.ts, uq, state.uids,
            summary=state.summary, device=dev, **ckw, **win_kw,
        )
        js = sssj_join_candidates(q, q, tq, tq, uq, uq, device=dev, **ckw,
                                  **self_kw)
        cs = js.cands if self_mask is None else self_mask(js.cands)
        buf = merge_candidates(
            concat_candidates(jw.cands, cs), max_pairs=cfg.max_pairs
        )
        return buf, jw.row_mask | js.row_mask, jw.iters, jw.gate_stats

    def micro_step(state: WindowState, telem: EngineTelemetry,
                   q, tq, uq, n_valid: int, sq=None):
        dev = q.device
        if embed_fn is not None:
            q = embed_fn(q)
        buf, row_mask, it_win, gs = joins(state, q, tq, uq, sq)
        # newest valid arrival: the reference point for live-slot overflow
        lanes = torch.arange(q.shape[0], device=dev)
        t_max = torch.where(lanes < n_valid, tq, -torch.inf).max()
        if multi:
            ingest(state, q, tq, uq, n_valid, t_max, sq)
        else:
            ingest(state, q, tq, uq, n_valid, t_max)
        for acc, inc in (
            (telem.chunks, it_win.sum()),
            (telem.tiles, it_win.numel()),
            (telem.pairs, buf.n_pairs),
            (telem.dropped, buf.n_dropped),
            (telem.dropped_tile, buf.n_dropped_tile),
            (telem.tiles_skipped_time, gs[0]),
            (telem.tiles_skipped_l2, gs[1]),
            (telem.strips_survived, gs[2]),
        ):
            acc.add_(inc)
        return buf, row_mask

    return micro_step


def stack_outputs(outs) -> Tuple[PairBuffer, torch.Tensor]:
    """Micro-steps' ``(PairBuffer, row_mask)`` outputs stacked over
    micro-batches: each buffer leaf and the masks gain a leading axis."""
    bufs = PairBuffer(*(torch.stack(x) for x in zip(*(b for b, _ in outs))))
    return bufs, torch.stack([m for _, m in outs])


def make_batch_step(cfg: EngineConfig, device: DeviceLike = None):
    """The request-batch step: ``(state, telem, qs, tqs, uqs, nvs) →
    (bufs, masks)``, a host loop of micro-steps over ``qs (n_micro, mb,
    d)``, ``tqs/uqs (n_micro, mb)`` device tensors and ``nvs`` host
    counts; ``bufs`` stacks each :class:`PairBuffer` leaf over
    micro-batches and ``masks`` is ``(n_micro, mb)``.  ``device`` holds
    the quota table; a kernel-route step on CUDA needs whole tiles
    (:func:`require_whole_tiles`)."""
    require_whole_tiles(cfg, device)
    tau = cfg.tau
    quo = cfg.quotas_device(device)

    def ingest(state, q, tq, uq, n_valid, t_max):
        push_with_overflow(
            state, q, tq, uq, n_valid, t_max, tau,
            eviction=cfg.eviction, quotas=quo,
            summary_block_w=cfg.block_w, summary_chunk_d=cfg.chunk_d,
        )

    micro_step = make_micro_step(cfg, ingest)

    def batch_step(state, telem, qs, tqs, uqs, nvs):
        return stack_outputs([
            micro_step(state, telem, qs[m], tqs[m], uqs[m], int(nvs[m]))
            for m in range(qs.shape[0])
        ])

    return batch_step


class StreamEngineBase:
    """Host facade: request padding, the copy thread, drains and metrics.

    Subclasses set ``state``, ``telem`` and ``_step`` in ``__init__``.
    """

    def __init__(
        self, cfg: EngineConfig, device: DeviceLike = None,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._next_uid = 0
        # futures of host-materialized (bufs, masks, nvs, nbytes, t_done,
        # fetch_s) records
        self._pending: List[concurrent.futures.Future] = []
        self._copier = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sssj-drain"
        )
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None
        )
        self.n_items = 0
        # host↔device traffic: what the dense path would have moved vs
        # what the compacted path actually moves
        self.bytes_to_host = 0
        self.bytes_dense_equiv = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        self.registry.register_collector(self._publish_metrics)

    def _global_capacity(self) -> int:
        """Window slots over all shards: what the dense path would score
        each query against."""
        return self.cfg.capacity

    # ------------------------------------------------------------------ #
    def push(self, vecs: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Feed one request batch; returns the uids assigned to it.  Does
        not wait for this request's device work (its upload from pageable
        memory does wait for the previous request's): call
        :meth:`drain_arrays` / :meth:`drain_pairs` to collect pairs."""
        b = np.asarray(vecs).shape[0]
        if b == 0:
            return np.empty((0,), np.int32)
        uq, qs, tqs, uqs, nvs = pad_request(
            vecs, ts, self._next_uid, self.cfg.micro_batch
        )
        self._next_uid += b
        self.n_items += b
        dev = self.device
        bufs, masks = self._step(
            self.state, self.telem, torch.from_numpy(qs).to(dev),
            torch.from_numpy(tqs).to(dev), torch.from_numpy(uqs).to(dev), nvs,
        )
        self._enqueue_fetch(bufs, masks, nvs)
        # the dense path would have fetched (mb, capacity) + (mb, mb) f32
        # score matrices per micro-batch
        mb = self.cfg.micro_batch
        self.bytes_dense_equiv += qs.shape[0] * 4 * (
            mb * self._global_capacity() + mb * mb
        )
        return uq

    def _enqueue_fetch(self, bufs: PairBuffer, masks: torch.Tensor,
                       nvs: np.ndarray) -> None:
        """Hand one dispatch's outputs to the copy thread, behind a CUDA
        event recorded after its last launch."""
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self._pending.append(
            self._copier.submit(self._fetch, bufs, masks, nvs, done)
        )

    def _fetch(self, bufs: PairBuffer, masks: torch.Tensor, nvs: np.ndarray,
               done: Optional[torch.cuda.Event]):
        """Copy-thread D2H of one push's outputs.  Stamps ``t_done``
        (monotonic) when the copy lands, plus the copy duration."""
        t0 = time.monotonic()
        tensors = [*bufs, masks]
        if done is None:       # CPU tensors: the step already ran
            host = [x.numpy() for x in tensors]
        else:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(done)
                pinned = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                          for x in tensors]
                for p, x in zip(pinned, tensors):
                    p.copy_(x, non_blocking=True)
            self._copy_stream.synchronize()
            host = [p.numpy() for p in pinned]
        bufs_h, masks_h = PairBuffer(*host[:-1]), host[-1]
        nbytes = sum(x.nbytes for x in host)
        t_done = time.monotonic()
        return bufs_h, masks_h, nvs, nbytes, t_done, t_done - t0

    # ------------------------------------------------------------------ #
    def _observe_emission(self, t_done: float, fetch_s: float) -> None:
        """Per-record drain hook (the multi-tenant runtime's admission→
        emission latency); records arrive in dispatch order."""

    def _drain(self):
        recs = [f.result() for f in self._pending]
        self._pending.clear()
        ua_all, ub_all, sc_all, mk_all = [], [], [], []
        for bufs, masks, nvs, nbytes, t_done, fetch_s in recs:
            self.bytes_to_host += nbytes
            self._observe_emission(t_done, fetch_s)
            n = np.asarray(bufs.n_pairs)
            n = n.reshape(n.shape[0], -1)             # (n_micro, n_segments)
            n_micro, n_seg = n.shape
            width = bufs.uid_a.reshape(n_micro, -1).shape[1] // n_seg
            sel = np.arange(width)[None, None, :] < n[:, :, None]
            # row-major (micro, segment, rank) flatten == stream order
            ua_all.append(bufs.uid_a.reshape(n_micro, n_seg, width)[sel])
            ub_all.append(bufs.uid_b.reshape(n_micro, n_seg, width)[sel])
            sc_all.append(bufs.score.reshape(n_micro, n_seg, width)[sel])
            lanes = np.arange(masks.shape[1])[None, :]
            mk_all.append(masks[lanes < nvs[:, None]])
        if not ua_all:
            z = np.empty((0,), np.int32)
            return z, z.copy(), np.empty((0,), np.float32), np.empty((0,), bool)
        return (
            np.concatenate(ua_all),
            np.concatenate(ub_all),
            np.concatenate(sc_all),
            np.concatenate(mk_all).astype(bool),
        )

    def drain_arrays(self, return_masks: bool = False) -> Tuple[np.ndarray, ...]:
        """Everything emitted since the last drain: ``(uid_a, uid_b,
        score)`` (uid_a is the newer item), plus with ``return_masks`` a
        ``(n_items,)`` bool per-row match mask aligned with the uids the
        intervening pushes handed out (exact under emission overflow)."""
        ua, ub, sc, mk = self._drain()
        if return_masks:
            return ua, ub, sc, mk
        return ua, ub, sc

    def drain_pairs(self) -> List[Tuple[int, int, float]]:
        """Compatibility drain: list of ``(uid_a, uid_b, score)`` tuples."""
        ua, ub, sc = self.drain_arrays()
        return list(zip(ua.tolist(), ub.tolist(), sc.tolist()))

    def close(self) -> None:
        """Release the copy thread; undrained copies are abandoned."""
        self._copier.shutdown(wait=False)

    def __del__(self) -> None:
        copier = getattr(self, "_copier", None)
        if copier is not None:
            copier.shutdown(wait=False)

    # ------------------------------------------------------------------ #
    @property
    def overflow(self) -> int:
        """Live ring slots overwritten (window undersized), all shards."""
        return int(host_lanes(self.state.overflow).sum())

    @property
    def pairs_dropped(self) -> int:
        """Pairs lost to emission capacity at any level."""
        t = self.telem
        return int(host_lanes(t.dropped).sum() + host_lanes(t.dropped_tile).sum())

    @property
    def overflow_by_tenant(self) -> Optional[np.ndarray]:
        """Live overwrites per victim stream ``(n_lanes,)``, summed over
        shards; ``None`` when the state carries no stream lanes."""
        lo = self.state.lane_overflow
        if lo is None:
            return None
        lo = host_lanes(lo)
        return lo.reshape(-1, lo.shape[-1]).sum(axis=0)

    def _publish_metrics(self, reg: MetricsRegistry) -> None:
        """Snapshot-time collector: engine counters under ``engine/…``,
        each summed over its lanes (shards)."""
        t = EngineTelemetry(*(int(host_lanes(x).sum()) for x in self.telem))
        c = reg.counter
        c("engine/n_items").set(self.n_items)
        c("engine/chunks_executed").set(t.chunks)
        c("engine/tiles_total").set(t.tiles)
        c("engine/pairs_emitted").set(t.pairs)
        c("engine/pairs_dropped").set(t.dropped + t.dropped_tile)
        c("engine/pairs_dropped_budget").set(t.dropped)
        c("engine/pairs_dropped_tile").set(t.dropped_tile)
        c("engine/window_overflow").set(self.overflow)
        c("engine/bytes_to_host").set(self.bytes_to_host)
        c("engine/bytes_dense_equiv").set(self.bytes_dense_equiv)
        # gate counters; tiles_total repeats the window-join tile count so
        # skip fractions are self-contained
        c("engine/prune/tiles_total").set(t.tiles)
        c("engine/prune/tiles_skipped_time").set(t.tiles_skipped_time)
        c("engine/prune/tiles_skipped_l2").set(t.tiles_skipped_l2)
        c("engine/prune/strips_survived").set(t.strips_survived)
        by_tenant = self.overflow_by_tenant
        if by_tenant is not None:
            for k, v in enumerate(by_tenant.tolist()):
                c(f"tenant/{k}/window_overflow").set(int(v))

    @staticmethod
    def _legacy_engine_view(snap: dict) -> dict:
        """The reference's ``stats()`` keys, from a registry snapshot, with
        ``window_overflow_by_tenant`` when the state carries lanes."""
        out = {
            k: snap[f"engine/{k}"]
            for k in ("n_items", "chunks_executed", "tiles_total",
                      "pairs_emitted", "pairs_dropped", "pairs_dropped_budget",
                      "pairs_dropped_tile", "window_overflow", "bytes_to_host",
                      "bytes_dense_equiv")
        }
        by_tenant = []
        while f"tenant/{len(by_tenant)}/window_overflow" in snap:
            by_tenant.append(snap[f"tenant/{len(by_tenant)}/window_overflow"])
        if by_tenant:
            out["window_overflow_by_tenant"] = by_tenant
        return out

    def metrics(self) -> dict:
        """The namespaced registry snapshot (the primary stats surface)."""
        return self.registry.snapshot()

    def stats(self) -> dict:
        return self._legacy_engine_view(self.registry.snapshot())


class StreamEngine(StreamEngineBase):
    """Single-device engine over one ring window."""

    def __init__(
        self, cfg: EngineConfig, device: DeviceLike = None,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        super().__init__(cfg, device, registry)
        self.state: WindowState = init_window(
            cfg.capacity, cfg.d, n_lanes=cfg.n_lanes, eviction=cfg.eviction,
            summary_block_w=cfg.block_w if cfg.gate_enabled else None,
            summary_chunk_d=cfg.chunk_d, device=self.device,
        )
        self.telem = init_telemetry(self.device)
        self._step = make_batch_step(cfg, self.device)

"""Policy-driven ring-buffer window: the device-resident time-filtered index.

Counterpart of ``repro.engine.window``.  Eviction is a write-slot policy:
:func:`select_write_slots` maps ``(state, micro-batch)`` to per-row
destination slots under one of three policies:

  * ``"oldest"`` — slots advance cyclically from the cursor, so an
    overwrite evicts the oldest item;
  * ``"dead"``   — empty or expired slots first, then live ones, both in
    cyclic cursor order;
  * ``"quota"``  — the ring is split into per-stream sub-rings with their
    own cursors (``WindowState.lane_cursor``), so a bursty stream only
    ever overwrites its own slots.

Live-slot overwrites are counted in ``overflow`` and, when the state
carries lanes, per victim stream in ``lane_overflow``.  When the state
carries a :class:`StripSummary`, every write refreshes the strips it
touched.

JAX returned a new state from every push and donated the old one; here
:func:`push_with_overflow` updates the state's tensors in place (the
caller keeps the same :class:`WindowState` object), which keeps a 1 GiB
window from being copied once per micro-batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.sssj_join.gate import (
    StripSummary,
    init_strip_summary,
    refresh_strip_summary,
)

__all__ = [
    "EVICTION_POLICIES",
    "WindowState",
    "init_window",
    "push_with_overflow",
    "quota_partition",
    "select_write_slots",
    "window_from_numpy",
    "window_to_numpy",
]

EMPTY_T = 3.0e30
EVICTION_POLICIES = ("oldest", "dead", "quota")


class WindowState(NamedTuple):
    """Ring buffer of recent stream items; its tensors are updated in place.

    ``lane_cursor[k]`` is stream *k*'s write cursor inside its quota
    sub-ring (``"quota"`` only) and ``lane_overflow[k]`` counts stream
    *k*'s live items that were overwritten; both are ``None`` when the
    state carries no stream lanes."""

    vecs: torch.Tensor      # (capacity, d) f32
    ts: torch.Tensor        # (capacity,) f32; empty slots hold +3e30
    uids: torch.Tensor      # (capacity,) i32; empty slots hold -1
    cursor: torch.Tensor    # () i64 — next write slot (cyclic policies)
    overflow: torch.Tensor  # () i64 — live items overwritten
    sids: torch.Tensor      # (capacity,) i32 stream ids; -1 = empty
    lane_cursor: Optional[torch.Tensor] = None    # (n_lanes,) i64 sub-ring cursors
    lane_overflow: Optional[torch.Tensor] = None  # (n_lanes,) i64 per victim stream
    summary: Optional[StripSummary] = None  # per-strip gate aggregates


def _check_policy(eviction: str) -> None:
    if eviction not in EVICTION_POLICIES:
        raise ValueError(
            f"eviction must be one of {EVICTION_POLICIES}, got {eviction!r}"
        )


def init_window(
    capacity: int,
    d: int,
    *,
    n_lanes: Optional[int] = None,
    eviction: str = "oldest",
    summary_block_w: Optional[int] = None,
    summary_chunk_d: int = 128,
    device: DeviceLike = None,
) -> WindowState:
    """Empty window.  ``n_lanes`` adds the per-stream overflow lane (and,
    under ``"quota"``, the per-stream cursor lane); ``summary_block_w``
    adds the per-strip summary at that strip width (the join's
    ``block_w``, so gate strips are kernel tiles)."""
    _check_policy(eviction)
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)

    def lanes():
        if n_lanes is None:
            return None
        return torch.zeros((n_lanes,), dtype=torch.int64, device=dev)

    return WindowState(
        vecs=torch.zeros((capacity, d), dtype=torch.float32, device=dev),
        ts=torch.full((capacity,), EMPTY_T, dtype=torch.float32, device=dev),
        uids=torch.full((capacity,), -1, **i32),
        cursor=torch.zeros((), dtype=torch.int64, device=dev),
        overflow=torch.zeros((), dtype=torch.int64, device=dev),
        sids=torch.full((capacity,), -1, **i32),
        lane_cursor=lanes() if eviction == "quota" else None,
        lane_overflow=lanes(),
        summary=None if summary_block_w is None else init_strip_summary(
            capacity, d, block_w=summary_block_w, chunk_d=summary_chunk_d,
            device=dev,
        ),
    )


def quota_partition(capacity: int, weights: Sequence[float]) -> Tuple[int, ...]:
    """Integer slot quotas from relative weights: ``quota_k ∝ weight_k``,
    every stream gets ≥ 1 slot, and the quotas sum exactly to ``capacity``
    (largest-remainder rounding)."""
    w = np.asarray(weights, np.float64).reshape(-1)
    k = w.size
    if k == 0:
        raise ValueError("quota_partition needs at least one weight")
    if np.any(w <= 0):
        raise ValueError(f"quota weights must be positive, got {w.tolist()}")
    if capacity < k:
        raise ValueError(f"capacity {capacity} < {k} streams: no slots to split")
    raw = capacity * w / w.sum()
    quotas = np.maximum(1, np.floor(raw).astype(np.int64))
    # distribute the remainder by largest fractional part; a negative
    # remainder (floors forced up to 1) shrinks the largest quotas instead
    order = np.argsort(-(raw - np.floor(raw)), kind="stable")
    rem = capacity - int(quotas.sum())
    i = 0
    while rem > 0:
        quotas[order[i % k]] += 1
        rem -= 1
        i += 1
    while rem < 0:
        j = int(np.argmax(quotas))
        if quotas[j] <= 1:
            raise ValueError(
                f"cannot partition capacity {capacity} over {k} streams"
            )
        quotas[j] -= 1
        rem += 1
    return tuple(int(q) for q in quotas)


def _sid_rows(sq: Optional[torch.Tensor], b: int, device) -> torch.Tensor:
    if sq is None:
        return torch.zeros((b,), dtype=torch.int64, device=device)
    return sq.long()


def select_write_slots(
    state: WindowState,
    b: int,
    n_valid: int,
    t_max: Optional[torch.Tensor] = None,
    tau: Optional[float] = None,
    sq: Optional[torch.Tensor] = None,
    eviction: str = "oldest",
    quotas: Optional[torch.Tensor] = None,
):
    """Write slots for one micro-batch: ``(dest (b,) i64, new_cursor,
    new_lane_cursor, self_evicted (b,) bool)``.

    ``dest`` holds ``capacity`` as the drop sentinel: for request padding
    (rows ``≥ n_valid``, a host int) and, under ``"quota"``, for a row
    whose slot a later row of the same stream in this micro-batch takes
    (the stream wrapped its sub-ring within one micro-batch); those rows
    are ``self_evicted``, lost before ever being written.  No two rows
    select the same slot.  ``"dead"`` needs ``t_max`` (the newest valid
    arrival) and ``tau``; ``"quota"`` the quota table and a state with a
    cursor lane.  Nothing here waits for the device.
    """
    _check_policy(eviction)
    cap = state.ts.shape[0]
    dev = state.ts.device
    lanes = torch.arange(b, device=dev)
    valid = lanes < n_valid
    no_evict = torch.zeros((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return lanes, state.cursor, state.lane_cursor, no_evict

    if eviction == "oldest":
        dest = torch.where(valid, (state.cursor + lanes) % cap, cap)
        return dest, (state.cursor + n_valid) % cap, state.lane_cursor, no_evict

    if eviction == "dead":
        if t_max is None or tau is None:
            raise ValueError("dead eviction needs t_max and tau")
        # dead = empty, or expired relative to the newest arrival's horizon
        dead = (state.uids < 0) | (t_max - state.ts > tau)
        # cyclic from the cursor: a gather, since the cursor stays on the
        # device (torch.roll would need it on the host)
        rolled = dead[(torch.arange(cap, device=dev) + state.cursor) % cap]
        cum_dead = torch.cumsum(rolled.long(), 0)
        cum_live = torch.cumsum((~rolled).long(), 0)
        n_dead = cum_dead[-1:]
        # row i → the (i+1)-th dead slot in cursor order; overflow rows →
        # the (i − n_dead + 1)-th live slot (cursor order ≈ oldest first)
        dead_idx = torch.searchsorted(cum_dead, lanes + 1)
        live_idx = torch.searchsorted(cum_live, lanes - n_dead + 1)
        rolled_pos = torch.where(lanes < n_dead, dead_idx, live_idx)
        dest = torch.where(valid, (rolled_pos + state.cursor) % cap, cap)
        if n_valid == 0:
            return dest, state.cursor, state.lane_cursor, no_evict
        new_cursor = (state.cursor + rolled_pos[n_valid - 1] + 1) % cap
        return dest, new_cursor, state.lane_cursor, no_evict

    if quotas is None or state.lane_cursor is None:
        raise ValueError(
            "quota eviction needs a quota table and a lane_cursor state "
            "(init_window(..., n_lanes=K, eviction='quota'))"
        )
    quotas = quotas.long()
    k_tab = quotas.shape[0]
    offs = torch.cumsum(quotas, 0) - quotas
    # clip BEFORE ranking: an out-of-range sid aliases to its clipped lane
    # everywhere (rank, cursor, destination)
    k = torch.clamp(_sid_rows(sq, b, dev), 0, k_tab - 1)
    qk = quotas[k]                                       # (b,) sub-ring sizes
    base = state.lane_cursor[k]
    # rank among this stream's valid rows: rows of one stream fill its
    # sub-ring in admission order
    same = (k[:, None] == k[None, :]) & valid[:, None] & valid[None, :]
    rank = torch.tril(same, -1).sum(1)
    count = same.sum(1)                                  # incl. the row itself
    pos = offs[k] + (base + rank) % qk
    # a stream that wraps its sub-ring within one micro-batch: the newest
    # writer of each slot wins, earlier rows are self-evicted
    survives = rank >= count - qk
    dest = torch.where(valid & survives, pos, cap)
    counts_k = torch.zeros(k_tab, dtype=torch.int64, device=dev).index_add_(
        0, k, valid.long())
    new_lane_cursor = (state.lane_cursor + counts_k) % quotas
    return dest, state.cursor, new_lane_cursor, valid & ~survives


def push_with_overflow(
    state: WindowState,
    q: torch.Tensor,
    tq: torch.Tensor,
    uq: torch.Tensor,
    n_valid: int,
    t_max: torch.Tensor,
    tau: float,
    sq: Optional[torch.Tensor] = None,
    eviction: str = "oldest",
    quotas: Optional[torch.Tensor] = None,
    summary_block_w: Optional[int] = None,
    summary_chunk_d: Optional[int] = None,
) -> WindowState:
    """Policy-driven masked push that counts live-slot overwrites, in place.

    A slot is *live* if it holds a real item (uid ≥ 0) within ``tau`` of
    the newest arrival ``t_max``; overwriting one, or self-evicting an
    arrival, counts in ``overflow`` and, with lanes, in ``lane_overflow``
    of the victim's stream (the arrival's own for a self-eviction).
    ``n_valid`` is a host int: rows ``≥ n_valid`` are padding and are not
    written (the reference's drop-mode scatter becomes an ``index_copy_``
    of the valid prefix).  A self-evicted row is pointed at the first
    surviving row's slot with that row's values, so the duplicate write
    stores the same values whatever its order, with no host sync.  With a
    strip summary the write also refreshes the strips it touched, from
    the post-write arrays.
    """
    cap = state.ts.shape[0]
    b = q.shape[0]
    dev = q.device
    dest, new_cursor, new_lane, self_evicted = select_write_slots(
        state, b, n_valid, t_max, tau, sq=sq, eviction=eviction, quotas=quotas,
    )
    read = torch.clamp(dest, max=cap - 1)
    live = (dest < cap) & (state.uids[read] >= 0) & (t_max - state.ts[read] <= tau)
    # only the quota policy self-evicts
    lost = live | self_evicted if eviction == "quota" else live
    if state.lane_overflow is not None:
        # the victim's stream, read before the write replaces it
        victim = torch.where(live, state.sids[read].long(), _sid_rows(sq, b, dev))
        victim = torch.clamp(victim, 0, state.lane_overflow.shape[0] - 1)
        state.lane_overflow.index_add_(0, victim, lost.long())
    state.overflow.add_(lost.sum())

    rows = dest[:n_valid]

    def take(x):
        return x[:n_valid]

    if eviction == "quota" and n_valid:
        # every stream keeps its newest row, so some valid row is real
        real = rows < cap
        first = torch.argmax(real.int()).reshape(1)
        src = torch.where(real, torch.arange(n_valid, device=dev), first)
        rows = rows.index_select(0, src)

        def take(x):
            return x.index_select(0, src)

    state.vecs.index_copy_(0, rows, take(q).to(state.vecs.dtype))
    state.ts.index_copy_(0, rows, take(tq).float())
    state.uids.index_copy_(0, rows, take(uq).int())
    if sq is None:
        state.sids.index_fill_(0, rows, 0)
    else:
        state.sids.index_copy_(0, rows, take(sq).int())
    state.cursor.copy_(new_cursor)
    if state.lane_cursor is not None:
        state.lane_cursor.copy_(new_lane)
    if state.summary is not None:
        if summary_block_w is None or summary_chunk_d is None:
            raise ValueError(
                "state carries a strip summary: push_with_overflow needs "
                "summary_block_w/summary_chunk_d to refresh it"
            )
        refresh_strip_summary(
            state.summary, state.vecs, state.ts, state.uids, dest,
            block_w=summary_block_w, chunk_d=summary_chunk_d,
        )
    return state


def window_from_numpy(src, *, device: DeviceLike = None) -> WindowState:
    """A port :class:`WindowState` from any object whose attributes
    ``vecs, ts, uids, cursor, overflow, sids`` (optional ``lane_cursor``,
    ``lane_overflow``, and ``summary`` with ``vmax, cnorm, tmin, tmax,
    umax``) are array-likes — for example the reference's ``WindowState``
    with its leaves as numpy arrays."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    def lane(name):
        x = getattr(src, name, None)
        return None if x is None else t(x, torch.int64).reshape(-1)

    summary = getattr(src, "summary", None)
    return WindowState(
        vecs=t(src.vecs, torch.float32),
        ts=t(src.ts, torch.float32),
        uids=t(src.uids, torch.int32),
        cursor=t(src.cursor, torch.int64).reshape(()),
        overflow=t(src.overflow, torch.int64).reshape(()),
        sids=t(src.sids, torch.int32),
        lane_cursor=lane("lane_cursor"),
        lane_overflow=lane("lane_overflow"),
        summary=None if summary is None else StripSummary(
            vmax=t(summary.vmax, torch.float32),
            cnorm=t(summary.cnorm, torch.float32),
            tmin=t(summary.tmin, torch.float32),
            tmax=t(summary.tmax, torch.float32),
            umax=t(summary.umax, torch.int32),
        ),
    )


def window_to_numpy(state: WindowState) -> dict:
    """The state's leaves as numpy arrays, under the reference's field
    names (``summary`` as a nested dict, absent lanes and summary as
    ``None``); cursor and overflow as int32 scalars and the lanes as int32
    arrays, as the reference keeps them."""
    out = {
        k: getattr(state, k).cpu().numpy()
        for k in ("vecs", "ts", "uids", "sids")
    }
    out["cursor"] = np.int32(state.cursor.item())
    out["overflow"] = np.int32(state.overflow.item())
    for lane in ("lane_cursor", "lane_overflow"):
        x = getattr(state, lane)
        out[lane] = None if x is None else x.cpu().numpy().astype(np.int32)
    out["summary"] = None if state.summary is None else {
        k: v.cpu().numpy() for k, v in state.summary._asdict().items()
    }
    return out

"""Ring-buffer window: the device-resident time-filtered index.

Counterpart of ``repro.engine.window`` for the ``"oldest"`` write-slot
policy: slots advance cyclically from the cursor, so an overwrite evicts
the oldest item.  Live-slot overwrites are counted in ``overflow``.  When
the state carries a :class:`StripSummary`, every write refreshes the
strips it touched.

JAX returned a new state from every push and donated the old one; here
:func:`push_with_overflow` updates the state's tensors in place (the
caller keeps the same :class:`WindowState` object), which keeps a 1 GiB
window from being copied once per micro-batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    "select_write_slots",
    "window_from_numpy",
    "window_to_numpy",
]

EMPTY_T = 3.0e30
EVICTION_POLICIES = ("oldest", "dead", "quota")
_NOT_PORTED = (
    "eviction={!r} is not ported yet; it comes with the multi-tenant "
    "runtime (ROADMAP queue 1, \"Multi-tenant runtime\")"
)


class WindowState(NamedTuple):
    """Ring buffer of recent stream items; its tensors are updated in place."""

    vecs: torch.Tensor      # (capacity, d) f32
    ts: torch.Tensor        # (capacity,) f32; empty slots hold +3e30
    uids: torch.Tensor      # (capacity,) i32; empty slots hold -1
    cursor: torch.Tensor    # () i64 — next write slot
    overflow: torch.Tensor  # () i64 — live items overwritten
    sids: torch.Tensor      # (capacity,) i32 stream ids; -1 = empty
    summary: Optional[StripSummary] = None  # per-strip gate aggregates


def _check_policy(eviction: str) -> None:
    if eviction not in EVICTION_POLICIES:
        raise ValueError(
            f"eviction must be one of {EVICTION_POLICIES}, got {eviction!r}"
        )
    if eviction != "oldest":
        raise NotImplementedError(_NOT_PORTED.format(eviction))


def init_window(
    capacity: int,
    d: int,
    *,
    eviction: str = "oldest",
    summary_block_w: Optional[int] = None,
    summary_chunk_d: int = 128,
    device: DeviceLike = None,
) -> WindowState:
    """Empty window; ``summary_block_w`` adds the per-strip summary at that
    strip width (the join's ``block_w``, so gate strips are kernel tiles)."""
    _check_policy(eviction)
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return WindowState(
        vecs=torch.zeros((capacity, d), dtype=torch.float32, device=dev),
        ts=torch.full((capacity,), EMPTY_T, dtype=torch.float32, device=dev),
        uids=torch.full((capacity,), -1, **i32),
        cursor=torch.zeros((), dtype=torch.int64, device=dev),
        overflow=torch.zeros((), dtype=torch.int64, device=dev),
        sids=torch.full((capacity,), -1, **i32),
        summary=None if summary_block_w is None else init_strip_summary(
            capacity, d, block_w=summary_block_w, chunk_d=summary_chunk_d,
            device=dev,
        ),
    )


def select_write_slots(
    state: WindowState, b: int, n_valid: int, eviction: str = "oldest"
):
    """Write slots for one micro-batch: ``(dest (b,) i64, new_cursor)``.

    Rows ``≥ n_valid`` (request padding) get ``capacity``, the drop
    sentinel.  No two rows select the same slot.
    """
    _check_policy(eviction)
    cap = state.ts.shape[0]
    lanes = torch.arange(b, device=state.ts.device)
    pos = (state.cursor + lanes) % cap
    dest = torch.where(lanes < n_valid, pos, cap)
    return dest, (state.cursor + n_valid) % cap


def push_with_overflow(
    state: WindowState,
    q: torch.Tensor,
    tq: torch.Tensor,
    uq: torch.Tensor,
    n_valid: int,
    t_max: torch.Tensor,
    tau: float,
    eviction: str = "oldest",
    summary_block_w: Optional[int] = None,
    summary_chunk_d: Optional[int] = None,
) -> WindowState:
    """Masked push that counts live-slot overwrites, in place.

    A slot is *live* if it holds a real item (uid ≥ 0) within ``tau`` of
    the newest arrival ``t_max``; overwriting one means the window is
    undersized.  ``n_valid`` is a host int: rows ``≥ n_valid`` are padding
    and are not written (the reference's drop-mode scatter becomes an
    ``index_copy_`` of the valid prefix).  With a strip summary the write
    also refreshes the strips it touched, from the post-write arrays.
    """
    cap = state.ts.shape[0]
    b = q.shape[0]
    dest, new_cursor = select_write_slots(state, b, n_valid, eviction)
    read = torch.clamp(dest, max=cap - 1)
    live = (dest < cap) & (state.uids[read] >= 0) & (t_max - state.ts[read] <= tau)
    state.overflow.add_(live.sum())
    rows = dest[:n_valid]
    state.vecs.index_copy_(0, rows, q[:n_valid].to(state.vecs.dtype))
    state.ts.index_copy_(0, rows, tq[:n_valid].float())
    state.uids.index_copy_(0, rows, uq[:n_valid].int())
    state.sids.index_fill_(0, rows, 0)
    state.cursor.copy_(new_cursor)
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
    ``vecs, ts, uids, cursor, overflow, sids`` (and optional ``summary``
    with ``vmax, cnorm, tmin, tmax, umax``) are array-likes — for example
    the reference's ``WindowState`` with its leaves as numpy arrays.
    Multi-tenant lanes are not ported and must be absent."""
    dev = resolve_device(device)
    for lane in ("lane_cursor", "lane_overflow"):
        if getattr(src, lane, None) is not None:
            raise NotImplementedError(
                f"{lane} belongs to the multi-tenant window, which comes with "
                f"the multi-tenant runtime (ROADMAP queue 1, \"Multi-tenant "
                f"runtime\")"
            )

    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    summary = getattr(src, "summary", None)
    return WindowState(
        vecs=t(src.vecs, torch.float32),
        ts=t(src.ts, torch.float32),
        uids=t(src.uids, torch.int32),
        cursor=t(src.cursor, torch.int64).reshape(()),
        overflow=t(src.overflow, torch.int64).reshape(()),
        sids=t(src.sids, torch.int32),
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
    names (``summary`` as a nested dict, or ``None``); cursor and
    overflow as int32 scalars, as the reference keeps them."""
    out = {
        k: getattr(state, k).cpu().numpy()
        for k in ("vecs", "ts", "uids", "sids")
    }
    out["cursor"] = np.int32(state.cursor.item())
    out["overflow"] = np.int32(state.overflow.item())
    out["summary"] = None if state.summary is None else {
        k: v.cpu().numpy() for k, v in state.summary._asdict().items()
    }
    return out

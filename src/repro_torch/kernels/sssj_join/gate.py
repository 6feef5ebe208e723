"""Strip summaries and the L2/prefix pre-launch gate.

Counterpart of ``repro.kernels.sssj_join.gate``.  Per-strip aggregates of
the window ride with the ring (:class:`StripSummary`): per-dimension max
``|w|`` (``vmax``), per-chunk max row norm (``cnorm``), the live time
extremes and the max uid.  :func:`strip_gate` bounds every pair of a
(query tile × strip) by ``min(prefix, chunk-ℓ2) · exp(-λ_min Δt_min)`` and
kills the tile's launch when that is below the batch's min θ.

The bound matrices are the work of a kernel: on a CUDA tensor
:func:`gate_ub` launches ``csrc/gate_ub.cu`` (replacing the TPU kernel
``_gate_ub_kernel``; the source's header says what bounds it and how its
design answers that) or raises; on a CPU tensor it runs
:func:`gate_ub_plain`.  The time bound, thresholds and stats stay plain
torch.  Empty strips carry ``vmax = cnorm = 0``, ``tmin = +3e30``,
``tmax = -3e30``, ``umax = -1``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..._device import DeviceLike, ieee_f32, resolve_device
from .._build import load

__all__ = [
    "StripSummary",
    "gate_ub",
    "gate_ub_plain",
    "gate_workspace",
    "init_strip_summary",
    "refresh_strip_summary",
    "strip_gate",
    "summarize_strips",
]

EMPTY_TS = 3.0e30


class StripSummary(NamedTuple):
    """Per-strip index aggregates, one row per window strip
    (``n_strips = ceil(capacity / block_w)``, ``n_chunks = ceil(d /
    chunk_d)``).  Updated in place by :func:`refresh_strip_summary`."""

    vmax: torch.Tensor   # (n_strips, d) f32 — per-dim max |w| over live slots
    cnorm: torch.Tensor  # (n_strips, n_chunks) f32 — per-chunk max row norm
    tmin: torch.Tensor   # (n_strips,) f32 — min live ts (+3e30 when empty)
    tmax: torch.Tensor   # (n_strips,) f32 — max live ts (-3e30 when empty)
    umax: torch.Tensor   # (n_strips,) i32 — max uid (-1 when empty)


def init_strip_summary(
    capacity: int, d: int, *, block_w: int, chunk_d: int, device: DeviceLike = None
) -> StripSummary:
    """Summary of an all-empty window."""
    dev = resolve_device(device)
    ns = -(-capacity // block_w)
    nc = -(-d // chunk_d)
    f32 = dict(dtype=torch.float32, device=dev)
    return StripSummary(
        vmax=torch.zeros((ns, d), **f32),
        cnorm=torch.zeros((ns, nc), **f32),
        tmin=torch.full((ns,), EMPTY_TS, **f32),
        tmax=torch.full((ns,), -EMPTY_TS, **f32),
        umax=torch.full((ns,), -1, dtype=torch.int32, device=dev),
    )


def _strip_stats(v, t, u, chunk_d: int):
    """``(g, block_w, ·)`` slot groups → per-group aggregates.  ``v`` must
    already be zero-padded to a chunk multiple."""
    g, bw, dp = v.shape
    nc = dp // chunk_d
    live = u >= 0                                        # (g, bw)
    lv = live[:, :, None].float()
    vmax = (v.abs() * lv).amax(1)                        # (g, dp)
    cn = torch.sqrt((v * v).reshape(g, bw, nc, chunk_d).sum(-1))
    cnorm = (cn * lv).amax(1)                            # (g, nc)
    tmin = torch.where(live, t, EMPTY_TS).amin(1)
    tmax = torch.where(live, t, -EMPTY_TS).amax(1)
    umax = u.amax(1)
    return vmax, cnorm, tmin, tmax, umax


def summarize_strips(
    vecs: torch.Tensor, ts: torch.Tensor, uids: torch.Tensor,
    *, block_w: int, chunk_d: int,
) -> StripSummary:
    """Full rebuild of every strip.  A ragged last strip is padded with
    empty slots and a ragged feature dim with zeros, as the join pads."""
    cap, d = vecs.shape
    ns = -(-cap // block_w)
    nc = -(-d // chunk_d)
    pad_r = ns * block_w - cap
    pad = torch.nn.functional.pad
    v = pad(vecs.float(), (0, nc * chunk_d - d, 0, pad_r))
    t = pad(ts.float(), (0, pad_r), value=EMPTY_TS)
    u = pad(uids.int(), (0, pad_r), value=-1)
    vmax, cnorm, tmin, tmax, umax = _strip_stats(
        v.reshape(ns, block_w, nc * chunk_d), t.reshape(ns, block_w),
        u.reshape(ns, block_w), chunk_d,
    )
    return StripSummary(vmax=vmax[:, :d].contiguous(), cnorm=cnorm,
                        tmin=tmin, tmax=tmax, umax=umax)


def refresh_strip_summary(
    summary: StripSummary,
    vecs: torch.Tensor, ts: torch.Tensor, uids: torch.Tensor,
    dest: torch.Tensor,
    *, block_w: int, chunk_d: int,
) -> StripSummary:
    """Recompute, in place, the strips a write touched.

    ``vecs/ts/uids`` are the **post-write** window and ``dest (b,)`` the
    slots the write-slot policy chose, with ``capacity`` as the drop
    sentinel.  Cost is ``O(b · block_w · d)``, independent of capacity.
    Rows writing into one strip recompute identical aggregates, so their
    duplicate scatter is value-deterministic.  Sentinel rows map to strip
    id ``n_strips`` and are dropped without a host sync: each is pointed
    at the first real row's strip with that row's values (or, when no row
    is real, at strip 0 with strip 0's current values).
    """
    cap, d = vecs.shape
    ns = summary.umax.shape[0]
    nc = summary.cnorm.shape[1]
    dest = dest.long()
    # NOT a bare dest // block_w: the drop sentinel (dest == cap) would
    # collide with the last real strip whenever cap % block_w != 0
    sid = torch.where(dest < cap, dest // block_w, ns)
    base = torch.clamp(sid, 0, ns - 1) * block_w
    idx = base[:, None] + torch.arange(block_w, device=dest.device)[None, :]
    ok = idx < cap                                       # ragged last strip
    idx_c = torch.clamp(idx, max=cap - 1)
    v = vecs[idx_c].float() * ok[:, :, None]
    t = torch.where(ok, ts[idx_c].float(), EMPTY_TS)
    u = torch.where(ok, uids[idx_c].int(), -1)
    v = torch.nn.functional.pad(v, (0, nc * chunk_d - d))
    vmax, cnorm, tmin, tmax, umax = _strip_stats(v, t, u, chunk_d)
    vmax = vmax[:, :d]

    real = sid < ns
    # (1,)-shaped index: indexing with a 0-dim tensor would call .item()
    # and make the host wait for the card
    first = torch.argmax(real.int()).reshape(1)          # 0 when none is real
    any_real = real.any()
    tgt = torch.where(real, sid, torch.where(any_real, sid.index_select(0, first), 0))
    for dst, new in zip(summary, (vmax, cnorm, tmin, tmax, umax)):
        fill = torch.where(any_real, new.index_select(0, first), dst[:1])
        keep = real.reshape((-1,) + (1,) * (new.dim() - 1))
        dst.index_copy_(0, tgt, torch.where(keep, new, fill).to(dst.dtype))
    return summary


# --------------------------------------------------------------------- #
# the gate's bound kernel
# --------------------------------------------------------------------- #
def gate_ub_plain(qa, qcn, vmax, cnorm, *, block_q: int) -> torch.Tensor:
    """``ub[i, s] = max over tile i's rows of min(qa·vmax_sᵀ, qcn·cnorm_sᵀ)``."""
    Qp = qa.shape[0]
    ns = vmax.shape[0]
    with ieee_f32(qa.device):
        pb = qa @ vmax.T                                  # (Qp, ns)
        lb = qcn @ cnorm.T                                # (Qp, ns)
    return torch.minimum(pb, lb).reshape(Qp // block_q, block_q, ns).amax(1)


GATE_SPLIT = 4      # the kernel's products split d into this many parts (csrc/gate_ub.cu CK)


def gate_workspace(Qp: int, ns: int, block_q: int) -> tuple[int, int, int]:
    """The shape of the f32 workspace the gate kernel's products write
    and its reduction reads: ``(GATE_SPLIT, Qp, ns)`` partial sums, one
    per part of the features.  Raises for tiles that do not divide ``Qp``."""
    if block_q < 1 or Qp % block_q:
        raise ValueError(f"Qp {Qp} must be a multiple of block_q {block_q} >= 1")
    return (GATE_SPLIT, Qp, ns)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("gate_ub")
    p = ctypes.c_void_p
    lib.gate_ub_launch.argtypes = [p] * 6 + [ctypes.c_int] * 6 + [p]
    lib.gate_ub_launch.restype = ctypes.c_int
    return lib


def gate_ub(qa, qcn, vmax, cnorm, *, block_q: int) -> torch.Tensor:
    """Per-(query tile, strip) value bound ``(nq, ns)`` f32: the CUDA
    kernel on a CUDA tensor, :func:`gate_ub_plain` on a CPU tensor."""
    if qa.device.type == "cpu":
        return gate_ub_plain(qa, qcn, vmax, cnorm, block_q=block_q)
    if qa.device.type != "cuda":
        raise ValueError(f"no gate kernel for device {qa.device}")
    Qp, d = qa.shape
    ns, nc = cnorm.shape
    ws_shape = gate_workspace(Qp, ns, block_q)
    if (vmax.shape != (ns, d) or qcn.shape != (Qp, nc)
            or any(x.dtype != torch.float32 or x.device != qa.device
                   for x in (qa, qcn, vmax, cnorm))):
        raise ValueError("gate bound needs f32 qa (Qp, d), qcn (Qp, nc), "
                         "vmax (ns, d), cnorm (ns, nc) on one device")
    ins = [x.contiguous() for x in (qa, qcn, vmax, cnorm)]
    ws = torch.empty(ws_shape, dtype=torch.float32, device=qa.device)
    ub = torch.empty((Qp // block_q, ns), dtype=torch.float32, device=qa.device)
    err = _lib().gate_ub_launch(
        *(x.data_ptr() for x in ins), ws.data_ptr(), ub.data_ptr(), Qp, ns, d, nc, block_q,
        GATE_SPLIT, torch.cuda.current_stream(qa.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gate_ub kernel launch failed: CUDA error {err}")
    gate_ub.launches += 1
    return ub


gate_ub.launches = 0


def chunk_norms(x: torch.Tensor, chunk_d: int) -> torch.Tensor:
    """``out[i, c] = ‖x_i restricted to chunk c‖`` (f32, (n, n_chunks))."""
    n, d = x.shape
    return torch.sqrt((x.float() ** 2).reshape(n, d // chunk_d, chunk_d).sum(-1))


def strip_gate(
    qp: torch.Tensor,
    summary: StripSummary,
    *,
    block_q: int,
    chunk_d: int,
    tq_lo,
    tq_hi,
    th_min,
    lam_min,
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Admissible per-(query tile × strip) launch gate.

    ``qp (Qp, d_pad)`` is the padded query block (``d_pad`` a ``chunk_d``
    multiple); ``vmax`` may be narrower and is zero-padded to ``d_pad``.
    ``tq_lo/tq_hi``, ``th_min/lam_min`` are extremes over the **unpadded**
    batch.  Inputs are moved to ``device`` (``None`` = CUDA).

    Returns ``gate (nq, n_strips) bool`` (True = launch) and ``stats (3,)
    i32 = [tiles_skipped_time, tiles_skipped_l2, strips_survived]``.
    """
    dev = resolve_device(device)
    qp = torch.as_tensor(qp, device=dev)
    summary = StripSummary(*(torch.as_tensor(x, device=dev) for x in summary))
    Qp, d_pad = qp.shape
    nq = Qp // block_q
    ns, d_s = summary.vmax.shape
    vmax = summary.vmax.float()
    if d_s < d_pad:
        vmax = torch.nn.functional.pad(vmax, (0, d_pad - d_s))
    qa = qp.float().abs()
    qcn = chunk_norms(qp, chunk_d)
    ub_tile = gate_ub(qa, qcn, vmax, summary.cnorm.float(), block_q=block_q)
    tq_lo = torch.as_tensor(tq_lo, dtype=torch.float32, device=dev)
    tq_hi = torch.as_tensor(tq_hi, dtype=torch.float32, device=dev)
    dt_lb = torch.clamp(
        torch.maximum(tq_lo - summary.tmax, summary.tmin - tq_hi), min=0.0
    )
    decay_ub = torch.exp(-lam_min * dt_lb)                # (ns,)
    time_alive = (decay_ub >= th_min) & (summary.umax >= 0)
    gate = time_alive[None, :] & (ub_tile * decay_ub[None, :] >= th_min)
    skipped_time = nq * (~time_alive).sum()
    skipped_l2 = (time_alive[None, :] & ~gate).sum()
    survived = gate.any(0).sum()
    stats = torch.stack([skipped_time, skipped_l2, survived]).int()
    return gate, stats

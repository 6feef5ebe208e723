"""Tile joins: CUDA kernels + plain versions.

Counterpart of ``repro.kernels.sssj_join.kernel``: its two TPU kernels
share the score core ``_tile_scores``.  For each ``(block_q, block_w)``
tile:

  * the decay matrix ``exp(-λ|Δt|)``, with the uid-order, empty-slot and
    stream masks folded in as zeros;
  * the tile is dead (``iters = 0``) when its max decay is below θ or its
    gate bit is 0;
  * otherwise ``q·wᵀ`` accumulates over ``chunk_d`` slabs, stopping once
    ``(acc + ‖q^{>k}‖‖w^{>k}‖)·decay < θ`` for the whole tile.

Then the two emissions:

  * :func:`sssj_join_candidates_kernel_call` (TPU kernel ``_cand_kernel``)
    selects the ≥ θ entries, in row-major order, into a ``(tile_k,)``
    buffer; on a CUDA tensor it launches ``csrc/sssj_cand.cu``;
  * :func:`sssj_join_kernel_call` (TPU kernel ``_kernel``) writes the
    whole thresholded ``(Qp, Wp)`` matrix with per-tile counts; on a CUDA
    tensor it launches ``csrc/sssj_dense.cu``.

Both CUDA kernels take any tile edges ``block_q``, ``block_w`` of 1 or
more, as the reference does: an edge up to 128 runs in the smallest
compiled edge of :data:`KERNEL_TILES` that holds it, a larger one in
sub-tiles of 128 (:func:`kernel_tile_edge`), with the tile's kill, early
exit and row-major ranking still per tile.  They share the score core
(``csrc/tile_scores.cuh``, whose header says what bounds them on an H100
and how the design answers that).
On a CPU tensor each wrapper runs its plain PyTorch version
(:func:`cand_tiles_plain`, :func:`dense_tiles_plain`), the same
arithmetic, which is also the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..._device import ieee_f32
from .._build import load
from .compact import tile_emit_counts

__all__ = [
    "NEG_UID",
    "cand_tiles_plain",
    "dense_tiles_plain",
    "kernel_tile_edge",
    "sssj_join_candidates_kernel_call",
    "sssj_join_kernel_call",
]

NEG_UID = -1  # uid marking empty / padded slots
KERNEL_TILES = (32, 64, 128)  # the compiled edges; a tile runs in the smallest that holds it


def kernel_tile_edge(edge: int) -> int:
    """The compiled edge of :data:`KERNEL_TILES` that runs a tile edge
    (as the launchers in ``csrc/`` pick it): the smallest that holds it,
    or the largest for an edge above it, which then runs in sub-tiles of
    that edge.  Raises ``ValueError`` for an edge below 1."""
    if edge < 1:
        raise ValueError(f"tile edges must be at least 1, got {edge}")
    return next((t for t in KERNEL_TILES if edge <= t), KERNEL_TILES[-1])


def _col(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.reshape(-1)


def _tile_any(x: torch.Tensor, nq: int, bq: int, nw: int, bw: int):
    """``(Qp, Wp)`` bool → ``(nq, nw)``: any entry of each tile."""
    return x.reshape(nq, bq, nw, bw).any(3).any(1)


def _tile_scores_plain(
    q, w, tq, tw, uq, uw, sqq, sqw, *, theta: float, lam: float,
    block_q: int, block_w: int, chunk_d: int,
    sq=None, sw=None, theta_q=None, lam_q=None, gate=None,
):
    """The shared score core: ``(emitted (Qp, Wp) f32, iters (nq, nw)
    i32)``, with ``emitted`` the decayed score where it reaches θ and 0
    elsewhere.  ``iters`` follows the kernels' per-tile early exit
    exactly: a tile runs chunk ``k`` only if some entry's bound after
    chunk ``k-1`` still reached θ."""
    tq, tw, uq, uw = _col(tq).float(), _col(tw).float(), _col(uq), _col(uw)
    Qp, d = q.shape
    Wp = w.shape[0]
    nq, nw = Qp // block_q, Wp // block_w
    n_chunks = d // chunk_d
    dims = (nq, block_q, nw, block_w)
    th = theta if theta_q is None else _col(theta_q).float()[:, None]
    lam_col = lam if lam_q is None else _col(lam_q).float()[:, None]

    decay = torch.exp(-lam_col * (tq[:, None] - tw[None, :]).abs())
    order = (uw[None, :] >= 0) & (uq[:, None] > uw[None, :])
    if sq is not None:
        order &= _col(sq)[:, None] == _col(sw)[None, :]
    decay = torch.where(order, decay, 0.0)

    running = _tile_any(decay >= th, *dims)
    if gate is not None:
        running &= gate.reshape(nq, nw) > 0
    iters = torch.zeros((nq, nw), dtype=torch.int32, device=q.device)
    acc = torch.zeros((Qp, Wp), dtype=torch.float32, device=q.device)
    for k in range(n_chunks):
        if not bool(running.any()):
            break
        sl = slice(k * chunk_d, (k + 1) * chunk_d)
        with ieee_f32(q.device):
            part = q[:, sl].float() @ w[:, sl].float().T
        run_e = running[:, None, :, None].expand(dims).reshape(Qp, Wp)
        acc = torch.where(run_e, acc + part, acc)
        iters += running.int()
        ub = (acc + sqq[:, k, None] * sqw[None, :, k]) * decay
        running &= _tile_any(ub >= th, *dims)

    scores = acc * decay
    return torch.where(scores >= th, scores, 0.0), iters


def cand_tiles_plain(
    q, w, tq, tw, uq, uw, sqq, sqw, *, theta: float, lam: float,
    block_q: int, block_w: int, chunk_d: int, tile_k: int,
    sq=None, sw=None, theta_q=None, lam_q=None, gate=None,
):
    """Plain PyTorch version of the tile join with candidate select (same
    signature and outputs as :func:`sssj_join_candidates_kernel_call`)."""
    emitted, iters = _tile_scores_plain(
        q, w, tq, tw, uq, uw, sqq, sqw, theta=theta, lam=lam,
        block_q=block_q, block_w=block_w, chunk_d=chunk_d,
        sq=sq, sw=sw, theta_q=theta_q, lam_q=lam_q, gate=gate,
    )
    nq, nw = iters.shape
    dims = (nq, block_q, nw, block_w)
    n = block_q * block_w
    flat = emitted.reshape(dims).permute(0, 2, 1, 3).reshape(nq, nw, n)
    hit = flat > 0.0
    cum = torch.cumsum(hit.int(), 2)
    count = cum[..., -1]
    row_hits = (hit.reshape(nq, nw, block_q, block_w).any(3)).int()
    target = torch.arange(1, tile_k + 1, dtype=cum.dtype, device=q.device)
    src = torch.searchsorted(cum.reshape(nq * nw, n),
                             target.expand(nq * nw, tile_k).contiguous())
    src = torch.clamp(src, max=n - 1).reshape(nq, nw, tile_k)
    valid = target <= torch.clamp(count, max=tile_k)[..., None]
    cand_idx = torch.where(valid, src, -1).int()
    cand_score = torch.where(valid, torch.gather(flat, 2, src), 0.0)
    return cand_idx, cand_score, count.int(), row_hits, iters


def dense_tiles_plain(
    q, w, tq, tw, uq, uw, sqq, sqw, *, theta: float, lam: float,
    block_q: int, block_w: int, chunk_d: int,
):
    """Plain PyTorch version of the dense-emission tile join (same
    signature and outputs as :func:`sssj_join_kernel_call`)."""
    emitted, iters = _tile_scores_plain(
        q, w, tq, tw, uq, uw, sqq, sqw, theta=theta, lam=lam,
        block_q=block_q, block_w=block_w, chunk_d=chunk_d,
    )
    return emitted, iters, tile_emit_counts(emitted, block_q, block_w)


_ARGTYPES = {   # pointers, ints, floats of each ``<name>_launch``, then the stream
    "sssj_cand": (19, 7, 2),
    "sssj_dense": (11, 6, 2),
}


@functools.cache
def _launcher(name: str):
    fn = getattr(load(name), f"{name}_launch")
    n_ptr, n_int, n_float = _ARGTYPES[name]
    p = ctypes.c_void_p
    fn.argtypes = [p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float + [p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _cuda_lane(x, n: int, dtype: torch.dtype, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    x = x.reshape(-1)
    if x.shape[0] != n or x.device != device:
        raise ValueError(f"lane of shape {tuple(x.shape)} on {x.device}, "
                         f"expected ({n},) on {device}")
    return x.to(dtype).contiguous()


def _cuda_inputs(q, w, tq, tw, uq, uw, sqq, sqw, block_q, block_w, chunk_d):
    """Check what both CUDA kernels take and lay it out for them:
    ``(q, w, [tq, tw, uq, uw], [sqq, sqw])`` contiguous on ``q``'s card."""
    if q.device.type != "cuda":
        raise ValueError(f"no tile-join kernel for device {q.device}")
    kernel_tile_edge(block_q)
    kernel_tile_edge(block_w)
    Qp, d = q.shape
    Wp = w.shape[0]
    if (w.shape[1] != d or Qp % block_q or Wp % block_w or d % chunk_d
            or q.dtype != torch.float32 or w.dtype != torch.float32):
        raise ValueError(
            f"tile join needs f32 q (Qp, d), w (Wp, d) padded to block and "
            f"chunk multiples; got {tuple(q.shape)} {q.dtype}, "
            f"{tuple(w.shape)} {w.dtype}, chunk_d={chunk_d}"
        )
    dev = q.device
    lanes = [
        _cuda_lane(tq, Qp, torch.float32, dev), _cuda_lane(tw, Wp, torch.float32, dev),
        _cuda_lane(uq, Qp, torch.int32, dev), _cuda_lane(uw, Wp, torch.int32, dev),
    ]
    norms = [sqq.float().contiguous(), sqw.float().contiguous()]
    n_chunks = d // chunk_d
    if norms[0].shape != (Qp, n_chunks) or norms[1].shape != (Wp, n_chunks):
        raise ValueError("suffix norms must be (rows, d // chunk_d)")
    if any(x.device != dev for x in (w, *norms)):
        raise ValueError(f"tile-join inputs must all lie on {dev}")
    return q.contiguous(), w.contiguous(), lanes, norms


def sssj_join_candidates_kernel_call(
    q: torch.Tensor,        # (Qp, d)
    w: torch.Tensor,        # (Wp, d)
    tq: torch.Tensor,       # (Qp, 1) f32
    tw: torch.Tensor,       # (Wp, 1) f32
    uq: torch.Tensor,       # (Qp, 1) i32
    uw: torch.Tensor,       # (Wp, 1) i32
    sqq: torch.Tensor,      # (Qp, n_chunks) f32 suffix norms after each chunk
    sqw: torch.Tensor,      # (Wp, n_chunks) f32
    *,
    theta: float,
    lam: float,
    block_q: int,
    block_w: int,
    chunk_d: int,
    tile_k: int,
    sq: Optional[torch.Tensor] = None,       # (Qp, 1) i32 stream ids
    sw: Optional[torch.Tensor] = None,       # (Wp, 1) i32
    theta_q: Optional[torch.Tensor] = None,  # (Qp, 1) f32 per-row θ
    lam_q: Optional[torch.Tensor] = None,    # (Qp, 1) f32 per-row λ
    gate: Optional[torch.Tensor] = None,     # (nq, nw) i32 (0 = dead)
):
    """Level-1 tile join; shapes must be padded to block multiples.

    Returns ``(cand_idx (nq, nw, tile_k) i32 in-tile row-major flat index
    or -1, cand_score (nq, nw, tile_k) f32, emitted (nq, nw) i32 true ≥ θ
    counts, row_hits (nq, nw, block_q) i32 0/1, iters (nq, nw) i32)``.
    The four multi-tenant lanes come all or none (``theta_q``/``lam_q``
    may be left out with stream lanes: the scalars then fill them).
    """
    if q.device.type == "cpu":
        return cand_tiles_plain(
            q, w, tq, tw, uq, uw, sqq, sqw, theta=theta, lam=lam,
            block_q=block_q, block_w=block_w, chunk_d=chunk_d, tile_k=tile_k,
            sq=sq, sw=sw, theta_q=theta_q, lam_q=lam_q, gate=gate,
        )
    q, w, lanes, norms = _cuda_inputs(
        q, w, tq, tw, uq, uw, sqq, sqw, block_q, block_w, chunk_d
    )
    if (sq is None) != (sw is None) or (theta_q is None) != (lam_q is None):
        raise ValueError("stream lanes and per-row (θ, λ) come in pairs")
    dev = q.device
    Qp, d = q.shape
    Wp = w.shape[0]
    if sq is not None and theta_q is None:
        theta_q = torch.full((Qp,), theta, dtype=torch.float32, device=dev)
        lam_q = torch.full((Qp,), lam, dtype=torch.float32, device=dev)
    nq, nw = Qp // block_q, Wp // block_w
    multi = [
        _cuda_lane(sq, Qp, torch.int32, dev), _cuda_lane(sw, Wp, torch.int32, dev),
        _cuda_lane(theta_q, Qp, torch.float32, dev),
        _cuda_lane(lam_q, Qp, torch.float32, dev),
    ]
    g = None if gate is None else _cuda_lane(gate, nq * nw, torch.int32, dev)
    # a tile with an edge above the largest compiled one keeps its
    # accumulators here between chunks
    ws = None
    if max(block_q, block_w) > KERNEL_TILES[-1]:
        ws = torch.empty((Qp, Wp), dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cand_idx = torch.empty((nq, nw, tile_k), **i32)
    cand_score = torch.empty((nq, nw, tile_k), dtype=torch.float32, device=dev)
    emitted = torch.empty((nq, nw), **i32)
    row_hits = torch.empty((nq, nw, block_q), **i32)
    iters = torch.empty((nq, nw), **i32)
    err = _launcher("sssj_cand")(
        q.data_ptr(), w.data_ptr(), *map(_ptr, lanes), *map(_ptr, norms),
        *map(_ptr, multi), _ptr(g), _ptr(ws), cand_idx.data_ptr(),
        cand_score.data_ptr(), emitted.data_ptr(), row_hits.data_ptr(),
        iters.data_ptr(), Qp, Wp, d, chunk_d, tile_k, block_q, block_w,
        theta, lam,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sssj_cand kernel launch failed: CUDA error {err}")
    sssj_join_candidates_kernel_call.launches += 1
    return cand_idx, cand_score, emitted, row_hits, iters


sssj_join_candidates_kernel_call.launches = 0


def sssj_join_kernel_call(
    q: torch.Tensor,        # (Qp, d)
    w: torch.Tensor,        # (Wp, d)
    tq: torch.Tensor,       # (Qp, 1) f32
    tw: torch.Tensor,       # (Wp, 1) f32
    uq: torch.Tensor,       # (Qp, 1) i32
    uw: torch.Tensor,       # (Wp, 1) i32
    sqq: torch.Tensor,      # (Qp, n_chunks) f32 suffix norms after each chunk
    sqw: torch.Tensor,      # (Wp, n_chunks) f32
    *,
    theta: float,
    lam: float,
    block_q: int,
    block_w: int,
    chunk_d: int,
):
    """Dense-emission tile join; shapes must be padded to block multiples.

    Returns ``(scores (Qp, Wp) f32 — the decayed score where it reaches θ
    and the uid order allows the pair, else 0; iters (nq, nw) i32 chunks
    run; counts (nq, nw) i32 entries > 0 per tile)``.
    """
    if q.device.type == "cpu":
        return dense_tiles_plain(
            q, w, tq, tw, uq, uw, sqq, sqw, theta=theta, lam=lam,
            block_q=block_q, block_w=block_w, chunk_d=chunk_d,
        )
    q, w, lanes, norms = _cuda_inputs(
        q, w, tq, tw, uq, uw, sqq, sqw, block_q, block_w, chunk_d
    )
    dev = q.device
    Qp, d = q.shape
    Wp = w.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    scores = torch.empty((Qp, Wp), dtype=torch.float32, device=dev)
    iters = torch.empty((Qp // block_q, Wp // block_w), **i32)
    counts = torch.empty((Qp // block_q, Wp // block_w), **i32)
    err = _launcher("sssj_dense")(
        q.data_ptr(), w.data_ptr(), *map(_ptr, lanes), *map(_ptr, norms),
        scores.data_ptr(), iters.data_ptr(), counts.data_ptr(),
        Qp, Wp, d, chunk_d, block_q, block_w, theta, lam,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sssj_dense kernel launch failed: CUDA error {err}")
    sssj_join_kernel_call.launches += 1
    return scores, iters, counts


sssj_join_kernel_call.launches = 0

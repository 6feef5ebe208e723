"""Public join surface: padding, suffix norms, gate, kernel, decode.

Counterpart of ``repro.kernels.sssj_join.ops``.  Two join surfaces:

  * :func:`sssj_join_tiles` — dense emission: the thresholded ``(Q, W)``
    score matrix plus per-tile ``iters`` and counts, from the dense tile
    join (or, with ``use_ref``, the dense reference).  It serves the
    engine's ``emit_dense`` oracle path.
  * :func:`sssj_join_candidates` — hierarchical emission.  Three
    implementations give identical candidate buffers:

      - ``impl=None`` — the kernel path (counterpart of ``"pallas"``): the
        strip gate and the tile join with in-kernel select;
      - ``"scan"`` — the strip walk: batched ``(Qp, n·block_w)`` products
        over the window strips the walk visits, each strip's candidates
        selected by :func:`~.compact.tile_candidates`; no ``(Q, W)``
        matrix;
      - ``"dense"`` — the oracle: full ``(Q, W)`` reference scores, then
        :func:`~.compact.tile_candidates`.

Kernels run as CUDA kernels on CUDA tensors and as their plain versions
on CPU tensors.  Sub-block inputs always take the reference route.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..._device import DeviceLike, resolve_device
from .compact import PairCandidates, tile_candidates, tile_emit_counts
from .gate import StripSummary, strip_gate
from .kernel import (
    NEG_UID,
    sssj_join_candidates_kernel_call,
    sssj_join_kernel_call,
)
from .ref import sssj_join_ref

__all__ = [
    "JoinCandidates",
    "NEG_UID",
    "sssj_join_candidates",
    "sssj_join_scores",
    "sssj_join_tiles",
    "suffix_chunk_norms",
]


def suffix_chunk_norms(x: torch.Tensor, chunk_d: int) -> torch.Tensor:
    """``out[i, k] = ‖x_i restricted to chunks > k‖`` (f32, (n, n_chunks)):
    after chunks 0..k the unseen remainder of a dot product is bounded by
    ``out_q[i, k] * out_w[j, k]``."""
    n, d = x.shape
    sq = (x.float() ** 2).reshape(n, d // chunk_d, chunk_d).sum(-1)
    suffix = torch.flip(torch.cumsum(torch.flip(sq, [1]), 1), [1])
    excl = torch.nn.functional.pad(suffix[:, 1:], (0, 1))
    return torch.sqrt(excl)


def _pad_rows(x: torch.Tensor, mult: int, fill=0) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _col(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A per-row lane ``(n,)`` as the ``(n, 1)`` column ``sssj_join_ref`` takes."""
    return None if x is None else x[:, None]


def _lane(x, dtype, dev) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=dev).reshape(-1).to(dtype)


def sssj_join_tiles(
    q, w, tq, tw, uq, uw,
    *,
    theta: float,
    lam: float,
    block_q: int = 128,
    block_w: int = 128,
    chunk_d: int = 128,
    use_ref: bool = False,
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked time-decayed join with dense emission and per-tile telemetry.

    ``q (Q, d)``, ``w (W, d)`` unit vectors; timestamps ``tq (Q,)``,
    ``tw (W,)``; uids ``uq``, ``uw`` (negative marks an empty slot).
    Inputs (arrays or tensors) are moved to ``device`` (``None`` = CUDA).
    ``use_ref`` routes through the dense reference instead of the kernel;
    inputs smaller than one block (``Q < block_q``, ``W < block_w`` or
    ``d < chunk_d``) take it as well.

    Returns ``scores (Q, W)`` f32 — the decayed similarity where it
    reaches θ and ``uq > uw ≥ 0``, else 0; ``iters (nq, nw)`` i32 — the
    d-chunks each tile ran (all ``n_chunks`` on the reference route);
    ``counts (nq, nw)`` i32 — entries > 0 per tile, over the padded grid.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(q, device=dev)
    w = torch.as_tensor(w, device=dev)
    tq, tw = _lane(tq, torch.float32, dev), _lane(tw, torch.float32, dev)
    uq, uw = _lane(uq, torch.int32, dev), _lane(uw, torch.int32, dev)
    Q, d = q.shape
    W = w.shape[0]
    if use_ref or Q < block_q or W < block_w or d < chunk_d:
        scores = sssj_join_ref(q, w, tq[:, None], tw[:, None], uq[:, None],
                               uw[:, None], theta=theta, lam=lam)
        iters = torch.full(
            (-(-Q // block_q), -(-W // block_w)), max(d // chunk_d, 1),
            dtype=torch.int32, device=dev,
        )
        return scores, iters, tile_emit_counts(scores, block_q, block_w)

    pad_d = (-d) % chunk_d
    if pad_d:
        q = torch.nn.functional.pad(q, (0, pad_d))
        w = torch.nn.functional.pad(w, (0, pad_d))
    qp = _pad_rows(q.float(), block_q)
    wp = _pad_rows(w.float(), block_w)
    scores, iters, counts = sssj_join_kernel_call(
        qp, wp, _pad_rows(tq, block_q)[:, None], _pad_rows(tw, block_w)[:, None],
        _pad_rows(uq, block_q, fill=NEG_UID)[:, None],
        _pad_rows(uw, block_w, fill=NEG_UID)[:, None],
        suffix_chunk_norms(qp, chunk_d), suffix_chunk_norms(wp, chunk_d),
        theta=theta, lam=lam, block_q=block_q, block_w=block_w,
        chunk_d=chunk_d,
    )
    return scores[:Q, :W], iters, counts


def sssj_join_scores(*args, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sssj_join_tiles` without the per-tile counts."""
    scores, iters, _ = sssj_join_tiles(*args, **kw)
    return scores, iters


class JoinCandidates(NamedTuple):
    """Level-1 join output: per-tile candidates plus the exact per-row hit
    mask.  ``cands`` segments are tiles in (q-tile, w-tile) row-major
    order; ``row_mask (Q,)`` derives from counts, so it is exact when
    ``tile_k`` overflows; ``iters (nq, nw)`` is the pruning telemetry;
    ``gate_stats (3,)`` is ``[skipped_time, skipped_l2, strips_survived]``
    (zeros when no gate ran)."""

    cands: PairCandidates
    row_mask: torch.Tensor
    iters: torch.Tensor
    gate_stats: Optional[torch.Tensor] = None


def _kernel_candidates(cand_idx, cand_score, emitted, uqp, uwp, block_q, block_w):
    """Decode the kernel's in-tile flat indices into uid-level candidates."""
    nq, nw, K = cand_idx.shape
    valid = cand_idx >= 0
    idx = torch.clamp(cand_idx, min=0).long()
    dev = cand_idx.device
    ti = torch.arange(nq, device=dev)[:, None, None]
    tj = torch.arange(nw, device=dev)[None, :, None]
    qi = ti * block_q + idx // block_w
    wi = tj * block_w + idx % block_w
    t = nq * nw
    return PairCandidates(
        uid_a=torch.where(valid, uqp[qi], -1).int().reshape(t, K),
        uid_b=torch.where(valid, uwp[wi], -1).int().reshape(t, K),
        score=torch.where(valid, cand_score, 0.0).reshape(t, K),
        kept=torch.clamp(emitted, max=K).int().reshape(t),
        emitted=emitted.int().reshape(t),
    )


def sssj_join_candidates(
    q, w, tq, tw, uq, uw,
    *,
    theta: float,
    lam: float,
    tile_k: int = 256,
    block_q: int = 128,
    block_w: int = 128,
    chunk_d: int = 128,
    impl: Optional[str] = None,
    sq=None,
    sw=None,
    theta_q=None,
    lam_q=None,
    summary: Optional[StripSummary] = None,
    device: DeviceLike = None,
) -> JoinCandidates:
    """Blocked join with hierarchical (level-1) emission; no dense matrix
    on the kernel path.

    Inputs (arrays or tensors) are moved to ``device`` (``None`` = CUDA).
    ``tile_k`` caps the candidates one tile keeps (overflow is counted in
    ``cands.emitted - cands.kept``).  ``impl`` is ``None`` (kernel path),
    ``"scan"`` or ``"dense"``; unlike the reference, ``None`` always means
    the kernel path.  Stream lanes ``sq/sw`` and per-row ``theta_q/lam_q``
    follow the reference.  ``summary`` (the window's strip aggregates)
    turns on the pre-launch gate for the kernel path and the scan; the
    dense oracle ignores it.  Gating never changes the emitted candidates.
    """
    if impl not in (None, "scan", "dense"):
        raise ValueError(f"unknown sssj_join_candidates impl {impl!r}")
    if (theta_q is None) != (lam_q is None):
        raise ValueError("theta_q and lam_q must be passed together")
    if (sq is None) != (sw is None):
        raise ValueError("sq and sw must be passed together")
    if theta_q is not None and sq is None:
        raise ValueError("per-row (theta_q, lam_q) requires stream lanes")
    dev = resolve_device(device)
    q = torch.as_tensor(q, device=dev)
    w = torch.as_tensor(w, device=dev)
    tq, tw = _lane(tq, torch.float32, dev), _lane(tw, torch.float32, dev)
    uq, uw = _lane(uq, torch.int32, dev), _lane(uw, torch.int32, dev)
    sq, sw = _lane(sq, torch.int32, dev), _lane(sw, torch.int32, dev)
    theta_q = _lane(theta_q, torch.float32, dev)
    lam_q = _lane(lam_q, torch.float32, dev)
    # pruning scalars come from the UNPADDED rows: the row padding below
    # uses inert fills (θ=2 never emits, λ=0 never decays) that would
    # otherwise loosen the min-based bounds
    th_min = theta if theta_q is None else theta_q.min()
    lam_min = lam if lam_q is None else lam_q.min()
    # time extremes for the gate, also unpadded: the tq pad fill 0.0 would
    # pin tq_lo to 0
    tq_lo, tq_hi = tq.min(), tq.max()
    no_gate_stats = torch.zeros(3, dtype=torch.int32, device=dev)

    Q, d = q.shape
    W = w.shape[0]
    # sub-block inputs take the dense oracle (a launch would be all
    # padding); d < chunk_d only matters to the kernel's d-chunking, the
    # scan does not chunk d
    if Q < block_q or W < block_w or (d < chunk_d and impl != "scan"):
        impl = "dense"
    n_chunks = max(d // chunk_d, 1)

    if impl == "dense":
        scores = sssj_join_ref(
            q, w, _col(tq), _col(tw), _col(uq), _col(uw),
            theta=theta, lam=lam, sq=_col(sq), sw=_col(sw),
            theta_q=_col(theta_q), lam_q=_col(lam_q),
        )
        cands, row_mask = tile_candidates(
            scores, uq, uw, block_q=block_q, block_w=block_w, tile_k=tile_k
        )
        iters = torch.full(
            (-(-Q // block_q), -(-W // block_w)), n_chunks,
            dtype=torch.int32, device=dev,
        )
        return JoinCandidates(cands, row_mask, iters, no_gate_stats)

    pad_d = (-d) % chunk_d
    if pad_d:
        q = torch.nn.functional.pad(q, (0, pad_d))
        w = torch.nn.functional.pad(w, (0, pad_d))
    qp = _pad_rows(q.float(), block_q)
    wp = _pad_rows(w.float(), block_w)
    tqp = _pad_rows(tq, block_q)
    twp = _pad_rows(tw, block_w)
    uqp = _pad_rows(uq, block_q, fill=NEG_UID)
    uwp = _pad_rows(uw, block_w, fill=NEG_UID)
    # inert fills: padded rows carry uid = -1 so they never emit, and the
    # θ/λ fills cannot loosen any bound either
    sqp = None if sq is None else _pad_rows(sq, block_q, fill=NEG_UID)
    swp = None if sw is None else _pad_rows(sw, block_w, fill=NEG_UID)
    thp = None if theta_q is None else _pad_rows(theta_q, block_q, fill=2.0)
    lmp = None if lam_q is None else _pad_rows(lam_q, block_q, fill=0.0)

    gate, gate_stats = None, no_gate_stats
    if summary is not None:
        gate, gate_stats = strip_gate(
            qp, summary, block_q=block_q, chunk_d=chunk_d, tq_lo=tq_lo,
            tq_hi=tq_hi, th_min=th_min, lam_min=lam_min, device=dev,
        )

    if impl == "scan":
        cands, row_mask, iters = _scan_candidates(
            qp, wp, tqp, twp, uqp, uwp, sqp, swp, thp, lmp, gate,
            theta=theta, lam=lam, th_min=th_min, lam_min=lam_min,
            tq_lo=tq_lo, tq_hi=tq_hi, tile_k=tile_k, block_q=block_q,
            block_w=block_w, chunk_d=chunk_d,
        )
        return JoinCandidates(cands, row_mask[:Q], iters, gate_stats)

    cand_idx, cand_score, emitted, row_hits, iters = (
        sssj_join_candidates_kernel_call(
            qp, wp, tqp[:, None], twp[:, None], uqp[:, None], uwp[:, None],
            suffix_chunk_norms(qp, chunk_d), suffix_chunk_norms(wp, chunk_d),
            theta=theta, lam=lam, block_q=block_q, block_w=block_w,
            chunk_d=chunk_d, tile_k=tile_k,
            sq=None if sqp is None else sqp[:, None],
            sw=None if swp is None else swp[:, None],
            theta_q=None if thp is None else thp[:, None],
            lam_q=None if lmp is None else lmp[:, None],
            gate=None if gate is None else gate.int(),
        )
    )
    cands = _kernel_candidates(
        cand_idx, cand_score, emitted, uqp, uwp, block_q, block_w
    )
    row_mask = (row_hits > 0).any(1).reshape(-1)[:Q]
    return JoinCandidates(cands, row_mask, iters, gate_stats)


# score entries one batched product of the scan holds at most (64 MB f32)
SCAN_SCORES = 1 << 24


def _scan_candidates(qp, wp, tqp, twp, uqp, uwp, sqp, swp, thp, lmp, gate, *,
                     theta, lam, th_min, lam_min, tq_lo, tq_hi, tile_k,
                     block_q, block_w, chunk_d):
    """The ``"scan"`` impl on padded inputs: ``(cands, row_mask (Qp,),
    iters (nq, nw))``.

    The reference walks the window one ``(Qp, block_w)`` strip at a time,
    newest first from the strip holding the max uid, over the ``n_live``
    strips that cover every strip alive by the time bound (ungated; each
    strip of the walk is scored) or by ``gate.any(0)`` (gated; only those
    are scored).  Here the walk is one or two contiguous ranges of the
    ring, scored by ``sssj_join_ref`` in batched products of up to
    ``SCAN_SCORES`` entries; a strip the reference does not score
    (gate-killed inside a range, or the only strip when ``n_live`` is 0)
    has its scores masked to 0, which gives exactly the unscored strip's
    buffers (uid -1, score 0, kept = emitted = 0).  The reference keeps
    the walk's cursor-anchored shape because a compacted visit list
    miscompiles under JAX's ``shard_map``; that concern is JAX's and does
    not bind this port.  ``iters`` is the scan's own telemetry: ``n_chunks`` for a live strip (gated: a live
    tile), 0 otherwise.  Reading ``n_live`` and the newest strip costs
    one host sync, except for a one-strip window (the self join), whose
    walk is decided on the device.
    """
    Qp, d = qp.shape
    nq, nw = Qp // block_q, wp.shape[0] // block_w
    n_chunks = d // chunk_d
    dev = qp.device
    uw_max = uwp.reshape(nw, block_w).amax(1)
    newest = torch.argmax(uw_max)
    dist = (newest - torch.arange(nw, device=dev)) % nw
    if gate is None:
        # strip time bound: unit vectors, so score ≤ exp(-λ_min Δt_lb);
        # empty slots carry t = +3e30, so an empty strip is dead
        tw_tiles = twp.reshape(nw, block_w)
        dt_lb = torch.clamp(torch.maximum(tq_lo - tw_tiles.amax(1),
                                          tw_tiles.amin(1) - tq_hi), min=0.0)
        alive_walk = (torch.exp(-lam_min * dt_lb) >= th_min) & (uw_max >= 0)
        iters = torch.where(alive_walk, n_chunks, 0).int()[None, :].repeat(nq, 1)
    else:
        alive_walk = gate.any(0)
        iters = torch.where(gate, n_chunks, 0).int()
    n_live = torch.where(alive_walk, dist + 1, 0).max()
    # the strips the reference scores: every strip of the walk (ungated),
    # or its gate survivors
    scored = (dist < n_live) if gate is None else alive_walk
    if nw == 1:
        newest, n_live = 0, 1
    else:
        newest, n_live = torch.stack([newest, n_live]).tolist()

    cands = PairCandidates(
        uid_a=torch.full((nq, nw, tile_k), -1, dtype=torch.int32, device=dev),
        uid_b=torch.full((nq, nw, tile_k), -1, dtype=torch.int32, device=dev),
        score=torch.zeros((nq, nw, tile_k), dtype=torch.float32, device=dev),
        kept=torch.zeros((nq, nw), dtype=torch.int32, device=dev),
        emitted=torch.zeros((nq, nw), dtype=torch.int32, device=dev),
    )
    row_mask = torch.zeros(Qp, dtype=torch.bool, device=dev)
    # the walk: strips newest - n_live + 1 … newest, modulo nw
    lo = newest - n_live + 1
    spans = [(max(lo, 0), newest + 1)] + ([(nw + lo, nw)] if lo < 0 else [])
    step = max(1, SCAN_SCORES // (Qp * block_w))
    for a, b in spans:
        for s0 in range(a, b, step):
            s1 = min(s0 + step, b)
            cols = slice(s0 * block_w, s1 * block_w)
            dec = sssj_join_ref(                            # (Qp, n·block_w)
                qp, wp[cols], _col(tqp), _col(twp[cols]), _col(uqp),
                _col(uwp[cols]), theta=theta, lam=lam, sq=_col(sqp),
                sw=None if swp is None else _col(swp[cols]),
                theta_q=_col(thp), lam_q=_col(lmp),
            )
            dec = torch.where(scored[s0:s1].repeat_interleave(block_w)[None, :],
                              dec, 0.0)
            got, rm = tile_candidates(dec, uqp, uwp[cols], block_q=block_q,
                                      block_w=block_w, tile_k=tile_k)
            for out, x in zip(cands, got):
                out[:, s0:s1] = x.reshape((nq, s1 - s0) + tuple(x.shape[1:]))
            row_mask |= rm
    flat = PairCandidates(*(x.reshape((nq * nw,) + tuple(x.shape[2:]))
                            for x in cands))
    return flat, row_mask, iters

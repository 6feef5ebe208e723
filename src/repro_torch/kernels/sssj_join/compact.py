"""Hierarchical pair compaction: tile candidates → packed pairs.

Level 2 of the two-level compaction (the counterpart of
``repro.kernels.sssj_join.compact``).  Level 1 lives with the join: each
``(block_q, block_w)`` tile selects its own ≥ θ entries into a fixed
``(tile_k,)`` buffer plus a true-emit count.  :func:`merge_candidates`
packs those ragged per-segment buffers into one ``(max_pairs,)``
:class:`PairBuffer` with a segmented exclusive scan over the counts plus
one gather — no sort, and the survivors are the earliest pairs in
(segment, within-segment) order, exactly as in the reference.

Drop accounting is per level and never silent: ``emitted - kept`` per
segment (``tile_k``), ``n_dropped`` (``max_pairs``) and
``n_dropped_tile`` (upstream losses carried into the buffer).

The dense-emission oracle (``emit_dense``) keeps the reference's
single-level route instead: :func:`compact_pairs` packs a whole dense
score matrix, and :func:`tile_emit_counts` gives its per-tile counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "PairBuffer",
    "PairCandidates",
    "compact_pairs",
    "concat_candidates",
    "merge_candidates",
    "tile_candidates",
    "tile_emit_counts",
]


class PairCandidates(NamedTuple):
    """Ragged per-segment candidate buffers (level-1 output).

    A segment is a kernel tile.  Each holds its first ``kept ≤ K`` emitted
    pairs in row-major order; slots past ``kept`` hold ``uid = -1``,
    ``score = 0``.
    """

    uid_a: torch.Tensor    # (S, K) i32 — query-side uid, -1 in unused slots
    uid_b: torch.Tensor    # (S, K) i32 — window-side uid
    score: torch.Tensor    # (S, K) f32 — decayed similarity, 0 in unused slots
    kept: torch.Tensor     # (S,) i32 — valid entries per segment (≤ K)
    emitted: torch.Tensor  # (S,) i32 — true ≥θ count per segment (≥ kept)


class PairBuffer(NamedTuple):
    """Fixed-capacity compacted pair emission."""

    uid_a: torch.Tensor     # (max_pairs,) i32, -1 beyond n_pairs
    uid_b: torch.Tensor     # (max_pairs,) i32, -1 beyond n_pairs
    score: torch.Tensor     # (max_pairs,) f32, 0 beyond n_pairs
    n_pairs: torch.Tensor   # () i32 — min(total kept, max_pairs)
    n_dropped: torch.Tensor       # () i32 — lost to max_pairs (this merge)
    n_dropped_tile: torch.Tensor  # () i32 — lost upstream to tile_k

    @property
    def overflowed(self) -> torch.Tensor:
        return (self.n_dropped + self.n_dropped_tile) > 0


def _segmented_take(counts: torch.Tensor, seg_cap: int, out_cap: int):
    """Destination plan for packing ragged segments into a dense prefix.

    Returns ``(src, valid, total)``: ``src[s]`` is the flat index (into the
    ``(S·seg_cap,)`` row-major segment buffer) of the s-th surviving
    entry, ``valid[s]`` marks ``s < min(total, out_cap)``, ``total`` is the
    sum of counts.  A scan, a binary search and a gather; no sort.
    """
    counts = counts.long()
    n_seg = counts.shape[0]
    cum = torch.cumsum(counts, 0)                                 # inclusive
    total = cum[-1]
    s = torch.arange(out_cap, dtype=torch.long, device=counts.device)
    # segment holding global rank s = first seg whose inclusive cum > s
    seg = torch.searchsorted(cum, s, right=True).clamp_(0, n_seg - 1)
    base = cum[seg] - counts[seg]                                 # exclusive
    valid = s < torch.clamp(total, max=out_cap)
    src = seg * seg_cap + (s - base)
    return torch.where(valid, src, 0), valid, total


def merge_candidates(cands: PairCandidates, *, max_pairs: int) -> PairBuffer:
    """Level-2 merge: ragged per-segment candidates → packed pair buffer."""
    n_seg, seg_cap = cands.uid_a.shape
    kept = torch.clamp(cands.kept.int(), max=seg_cap)
    src, valid, total = _segmented_take(kept, seg_cap, max_pairs)
    uid_a = torch.where(valid, cands.uid_a.reshape(-1)[src], -1).int()
    uid_b = torch.where(valid, cands.uid_b.reshape(-1)[src], -1).int()
    score = torch.where(valid, cands.score.reshape(-1)[src], 0.0).float()
    n_pairs = torch.clamp(total, max=max_pairs)
    return PairBuffer(
        uid_a=uid_a,
        uid_b=uid_b,
        score=score,
        n_pairs=n_pairs.int(),
        n_dropped=(total - n_pairs).int(),
        n_dropped_tile=(cands.emitted.long() - kept).sum().int(),
    )


def concat_candidates(*cands: PairCandidates) -> PairCandidates:
    """Stack candidate sets (window join + self join) along the segment
    axis; all must share the same per-segment capacity K."""
    return PairCandidates(*(torch.cat(xs, 0) for xs in zip(*cands)))


def tile_candidates(
    scores: torch.Tensor,   # (Q, W) f32 — 0 where no pair, ≥ θ where emitted
    uq: torch.Tensor,       # (Q,) i32 query uids
    uw: torch.Tensor,       # (W,) i32 window uids aligned with score columns
    *,
    block_q: int,
    block_w: int,
    tile_k: int,
) -> tuple[PairCandidates, torch.Tensor]:
    """Per-tile candidate selection from a dense matrix: the oracle of the
    kernel's level-1 stage, with the same row-major within-tile order and
    the same (q-tile, w-tile) tile order.  Returns ``(candidates,
    row_mask (Q,))``; the mask derives from counts, so it is exact when
    ``tile_k`` overflows."""
    Q, W = scores.shape
    pq, pw = (-Q) % block_q, (-W) % block_w
    s = torch.nn.functional.pad(scores, (0, pw, 0, pq))
    uqp = torch.nn.functional.pad(uq.int(), (0, pq), value=-1)
    uwp = torch.nn.functional.pad(uw.int(), (0, pw), value=-1)
    nq, nw = (Q + pq) // block_q, (W + pw) // block_w
    n = block_q * block_w
    flat = (s.reshape(nq, block_q, nw, block_w).permute(0, 2, 1, 3)
            .reshape(nq * nw, n))
    cum = torch.cumsum((flat > 0.0).int(), 1)                     # (S, n)
    emitted = cum[:, -1].int()
    kept = torch.clamp(emitted, max=tile_k)
    target = torch.arange(1, tile_k + 1, dtype=cum.dtype, device=cum.device)
    # src[s, k] = first in-tile flat position with inclusive count ≥ k+1
    src = torch.searchsorted(cum, target.expand(nq * nw, tile_k).contiguous())
    src = torch.clamp(src, max=n - 1)
    valid = target[None, :] <= kept[:, None]
    sel_score = torch.where(valid, torch.gather(flat, 1, src), 0.0)
    seg = torch.arange(nq * nw, device=s.device)[:, None]
    qi = (seg // nw) * block_q + src // block_w
    wi = (seg % nw) * block_w + src % block_w
    cands = PairCandidates(
        uid_a=torch.where(valid, uqp[qi], -1).int(),
        uid_b=torch.where(valid, uwp[wi], -1).int(),
        score=sel_score.float(),
        kept=kept,
        emitted=emitted,
    )
    row_mask = (s > 0.0).any(1)[:Q]
    return cands, row_mask


def compact_pairs(
    scores: torch.Tensor,   # (Q, W) f32 — 0 where no pair, ≥ θ where emitted
    uq: torch.Tensor,       # (Q,) i32 query uids
    uw: torch.Tensor,       # (W,) i32 window uids aligned with score columns
    *,
    max_pairs: int,
) -> PairBuffer:
    """Dense-oracle compaction: the first ``min(total, max_pairs)`` hits
    in row-major order, then ``-1``/0 fill.

    The reference takes them with a stable ``lax.top_k`` over the 0/1
    mask; ``torch.topk`` promises no order among ties, so this finds the
    s-th hit with an inclusive int32 ``cumsum`` and a ``searchsorted`` for
    targets ``1..k``, with no host sync.
    """
    Q, W = scores.shape
    flat = scores.reshape(-1)
    cum = torch.cumsum(flat > 0.0, 0, dtype=torch.int32)
    total = cum[-1]
    k = min(max_pairs, Q * W)
    target = torch.arange(1, k + 1, dtype=torch.int32, device=scores.device)
    idx = torch.clamp(torch.searchsorted(cum, target), max=Q * W - 1)
    valid = target <= total
    uid_a = torch.where(valid, uq.int()[idx // W], -1).int()
    uid_b = torch.where(valid, uw.int()[idx % W], -1).int()
    score = torch.where(valid, flat[idx], 0.0).float()
    if k < max_pairs:
        pad = (0, max_pairs - k)
        uid_a = torch.nn.functional.pad(uid_a, pad, value=-1)
        uid_b = torch.nn.functional.pad(uid_b, pad, value=-1)
        score = torch.nn.functional.pad(score, pad)
    n_pairs = torch.clamp(total, max=max_pairs)
    return PairBuffer(
        uid_a, uid_b, score, n_pairs.int(), (total - n_pairs).int(),
        torch.zeros((), dtype=torch.int32, device=scores.device),
    )


def tile_emit_counts(scores: torch.Tensor, block_q: int, block_w: int) -> torch.Tensor:
    """Per-``(block_q, block_w)``-tile counts of entries > 0 of a dense
    score matrix (the ragged edge padded with zeros): the dense-emission
    kernel's ``counts`` output, for the reference route."""
    Q, W = scores.shape
    pq, pw = (-Q) % block_q, (-W) % block_w
    s = torch.nn.functional.pad(scores, (0, pw, 0, pq))
    nq, nw = (Q + pq) // block_q, (W + pw) // block_w
    m = (s > 0.0).reshape(nq, block_q, nw, block_w)
    return m.sum((1, 3), dtype=torch.int32)

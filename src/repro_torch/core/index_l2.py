"""The AP / L2AP / L2 index family (paper §5.2–§5.4, Algorithms 2–4, 6–8).

The paper presents the three schemes as one pseudocode with a color
convention: AP = "red" lines only, L2 = "green" lines only, L2AP = both.
We mirror that with two flags:

  ==========  =========  =========
  scheme      use_ap     use_l2
  ==========  =========  =========
  AP          True       False
  L2AP        True       True
  L2          False      True
  ==========  =========  =========

AP bounds (red) are *data dependent*: they need the dataset max-vector
``m`` (index construction, bound b1), the indexed max-vector ``m̂``
(candidate generation, bound rs1), and per-item stats (size filter sz1,
verification bounds ds1/sz2).  In a stream, growth of ``m`` invalidates the
prefix-filtering invariant and forces *re-indexing* (paper §5.3).

L2 bounds (green) are Cauchy–Schwarz bounds that depend only on prefix
norms of the query and of each indexed vector: pscore b2 = ‖x'‖ (IC),
rs2 = ‖x remaining-prefix‖ and l2bound = C + ‖x'_j‖·‖y'_j‖ (CG), ps1 = C + Q[y]
(CV).  They need *no stream statistics*, which is exactly why the paper's
L2 index is the streaming method of choice: no re-indexing, posting lists
stay time-ordered, truncation is O(1).

Streaming decay placement follows §6.2 precisely:
  * IC: decay is never applied.
  * CG: remscore = min(rs1, rs2·e^{-λΔt}), l2bound gets e^{-λΔt}; for L2AP,
    rs1 is initialized with the *time-decayed* max-vector m̂^λ.
  * CV: every bound and the final test use e^{-λΔt}.
"""

from __future__ import annotations

import math
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Set

import numpy as np

from .counters import Counters
from .postings import ItemMeta, PostingList, ScoreAccumulator
from .similarity import time_horizon
from .types import Pair, SparseVector, StreamItem

__all__ = ["L2FamilyIndex", "Residual"]


class Residual:
    """Entry of the residual direct index R: the un-indexed prefix x' plus
    the stats used by the CV bounds (Alg. 4/8 lines 3–5), and Q[x]."""

    __slots__ = (
        "uid", "t", "indices", "values", "q_pscore",
        "vm", "coord_sum", "nnz", "boundary", "full",
    )

    def __init__(
        self,
        uid: int,
        t: float,
        prefix: SparseVector,
        q_pscore: float,
        boundary: int,
        full: Optional[StreamItem],
    ) -> None:
        self.uid = uid
        self.t = t
        self.indices = prefix.indices
        self.values = prefix.values
        self.q_pscore = q_pscore
        self.vm = prefix.max_value
        self.coord_sum = prefix.coord_sum
        self.nnz = prefix.nnz
        self.boundary = boundary      # first indexed coordinate position
        self.full = full              # full item, kept only when re-indexing is possible


class _DecayedMax:
    """The time-decayed indexed max-vector m̂^λ (paper §5.3).

    Exact lazy maintenance: store per-coordinate ``(value, stamp)``; the
    decayed value at time t is ``value * exp(-λ (t - stamp))``.  Updating
    with a new vector takes O(nnz); a ``dot`` with a query takes O(nnz).
    This works because max and uniform exponential decay commute.
    """

    def __init__(self, lam: float) -> None:
        self.lam = lam
        self.v: Dict[int, float] = {}
        self.stamp: Dict[int, float] = {}

    def value_at(self, j: int, t: float) -> float:
        v = self.v.get(j)
        if v is None:
            return 0.0
        return v * math.exp(-self.lam * (t - self.stamp[j]))

    def update(self, item: StreamItem) -> None:
        t = item.t
        for j, xj in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
            cur = self.value_at(j, t)
            if xj > cur:
                self.v[j] = xj
                self.stamp[j] = t
            elif cur > 0.0:
                self.v[j] = cur
                self.stamp[j] = t


class L2FamilyIndex:
    """AP / L2AP / L2 (static for MB, streaming for STR)."""

    def __init__(
        self,
        theta: float,
        lam: float = 0.0,
        *,
        use_ap: bool,
        use_l2: bool,
        streaming: bool = False,
        counters: Optional[Counters] = None,
    ) -> None:
        if not (use_ap or use_l2):
            raise ValueError("at least one bound family must be enabled")
        if streaming and use_ap and not use_l2:
            # The paper omits STR-AP: "the streaming versions of AP ... are
            # not efficient in practice" (§5.2).
            raise NotImplementedError("STR-AP is not supported (paper §5.2)")
        self.theta = theta
        self.lam = lam
        self.use_ap = use_ap
        self.use_l2 = use_l2
        self.streaming = streaming
        self.tau = time_horizon(theta, lam) if streaming else math.inf
        self.counters = counters if counters is not None else Counters()

        self.lists: Dict[int, PostingList] = {}
        self.meta = ItemMeta()
        self.R: "OrderedDict[int, Residual]" = OrderedDict()
        # AP statistics
        self.m: Dict[int, float] = {}          # dataset / stream max-vector m
        self.mhat: Dict[int, float] = {}       # indexed max-vector m̂ (static CG)
        self.mhat_dec = _DecayedMax(lam)       # m̂^λ (streaming CG)
        self.Rinv: Dict[int, Set[int]] = {}    # inverted index over residuals

        self._arrivals: deque[tuple[int, float]] = deque()
        self._floor_uid = 0
        self._next_uid_hint = 0
        self._n_entries = 0

    @property
    def name(self) -> str:
        return {(True, True): "L2AP", (True, False): "AP", (False, True): "L2"}[
            (self.use_ap, self.use_l2)
        ]

    # ------------------------------------------------------------------ #
    # index construction (Alg. 2 / 6)
    # ------------------------------------------------------------------ #
    def _index_boundary(self, vec: SparseVector) -> tuple[int, float]:
        """Scan coordinates in dimension order, returning ``(p, pscore)``:
        ``p`` = position of the first coordinate to index, ``pscore`` = the
        bound value min(b1, b2) just before that coordinate (stored in Q).

        Indexing starts at the first position where min(b1, b2) computed
        *inclusive* of the coordinate reaches θ (Alg. 2 lines 8–16)."""
        b1 = 0.0
        bt = 0.0
        idx, val = vec.indices, vec.values
        pscore = 0.0
        for k in range(idx.shape[0]):
            # bound value *before* adding coordinate k — candidate Q value
            b1_excl = b1 if self.use_ap else math.inf
            b2_excl = math.sqrt(bt) if self.use_l2 else math.inf
            pre = min(b1_excl, b2_excl)
            j, xj = int(idx[k]), float(val[k])
            if self.use_ap:
                # NOTE: the paper's pseudocode (Alg. 2 line 10, inherited from
                # Bayardo's AP) uses min{m_j, vm_x}.  The vm_x term is only
                # admissible when vectors are processed in decreasing-maxweight
                # order, which a stream processed in *arrival* order cannot
                # guarantee — a later query y with vm_y > vm_x would be missed.
                # We therefore use the order-free bound x_j * m_j (see
                # DESIGN.md "hardware-adaptation notes" / fidelity deviations).
                b1 += xj * self.m.get(j, 0.0)
            bt += xj * xj
            b1_incl = b1 if self.use_ap else math.inf
            b2_incl = math.sqrt(bt) if self.use_l2 else math.inf
            if min(b1_incl, b2_incl) >= self.theta:
                return k, pre
            pscore = pre
        # ‖x‖ = 1 ≥ θ and b1 ≥ ‖x‖² = 1, so the bound always triggers.
        return idx.shape[0], pscore

    def _add_to_index(self, item: StreamItem, keep_full: bool) -> None:
        vec = item.vec
        p, pscore = self._index_boundary(vec)
        prefix = vec.prefix(p)
        self.R[item.uid] = Residual(
            item.uid, item.t, prefix, pscore, p, item if keep_full else None
        )
        if self.use_ap:
            for j in prefix.indices.tolist():
                self.Rinv.setdefault(j, set()).add(item.uid)
        # append suffix coordinates with *exclusive* prefix norms ‖x'_j‖
        csq = float(np.sum(prefix.values * prefix.values))
        for k in range(p, vec.nnz):
            j, xj = int(vec.indices[k]), float(vec.values[k])
            self.lists.setdefault(j, PostingList()).append(
                item.uid, xj, math.sqrt(csq), item.t
            )
            csq += xj * xj
            self._n_entries += 1
        self.counters.entries_indexed += vec.nnz - p
        self.counters.peak_index_entries = max(
            self.counters.peak_index_entries, self._n_entries
        )
        self.meta.add(item.uid, item.t, vec.nnz, vec.max_value)
        self._next_uid_hint = max(self._next_uid_hint, item.uid + 1)
        if self.streaming:
            self._arrivals.append((item.uid, item.t))

    def _update_m_and_reindex(self, item: StreamItem) -> None:
        """Streaming-L2AP re-indexing (paper §5.3).

        When a coordinate of the stream max-vector m grows, the prefix
        filtering invariant no longer covers residuals indexed under the old
        m: their b1 bound was too small, so indexing may now need to start
        earlier.  We locate affected residuals through the residual inverted
        index and move the newly-required coordinates into the posting
        lists (out of time order — which is what costs L2AP its backwards-
        scan fast path, §6.2)."""
        updated: List[int] = []
        for j, xj in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
            if xj > self.m.get(j, 0.0):
                self.m[j] = xj
                updated.append(j)
        if not updated or not self.streaming:
            return
        affected: Set[int] = set()
        for j in updated:
            affected |= self.Rinv.get(j, set())
        for uid in sorted(affected):
            res = self.R.get(uid)
            if res is None or res.full is None:
                continue
            self.counters.reindex_ops += 1
            vec = res.full.vec
            p_new, pscore_new = self._index_boundary(vec)
            p_old = res.boundary
            if p_new > p_old:
                # b1 is monotone in m, so the boundary can only move left;
                # never un-index already-indexed coordinates.
                continue
            if p_new == p_old:
                # Boundary unchanged, but Q[y] was computed under the old m
                # and may now under-bound dot(x, y') — refresh it (a stale Q
                # causes CV's ps1 to prune true pairs).
                res.q_pscore = max(res.q_pscore, pscore_new)
                continue
            # index coordinates p_new .. p_old-1 (the paper's y_{p'} < y_j ≤ y_p)
            prefix_new = vec.prefix(p_new)
            csq = float(np.sum(prefix_new.values * prefix_new.values))
            for k in range(p_new, p_old):
                j, xj = int(vec.indices[k]), float(vec.values[k])
                self.lists.setdefault(j, PostingList()).append(
                    uid, xj, math.sqrt(csq), res.t
                )
                csq += xj * xj
                self._n_entries += 1
                self.counters.reindex_entries += 1
                self.Rinv.get(j, set()).discard(uid)
            new_res = Residual(uid, res.t, prefix_new, pscore_new, p_new, res.full)
            self.R[uid] = new_res

    # ------------------------------------------------------------------ #
    # candidate generation (Alg. 3 / 7)
    # ------------------------------------------------------------------ #
    def _cand_gen(self, item: StreamItem, decayed: bool) -> ScoreAccumulator:
        vec = item.vec
        span = self._next_uid_hint - self._floor_uid + 1
        acc = ScoreAccumulator(self._floor_uid, span)
        if vec.nnz == 0:
            return acc
        t_min = item.t - self.tau
        vm_x = vec.max_value
        sz1 = self.theta / vm_x if (self.use_ap and vm_x > 0) else 0.0

        # rs1 (AP): dot(x, m̂) — static — or dot(x, m̂^λ) — streaming.
        if self.use_ap:
            if decayed:
                mhat_x = np.array(
                    [self.mhat_dec.value_at(int(j), item.t) for j in vec.indices],
                    dtype=np.float64,
                )
            else:
                mhat_x = np.array(
                    [self.mhat.get(int(j), 0.0) for j in vec.indices], dtype=np.float64
                )
            rs1 = float(np.dot(vec.values, mhat_x))
        else:
            rs1 = math.inf
            mhat_x = None

        # rs2 (L2): suffix-exclusive query prefix norms, per scan position.
        rst = 1.0
        # exclusive prefix norms of the query: ‖x'_j‖ for each stored coord
        xsq = vec.values * vec.values
        x_pnorm_excl = np.sqrt(np.maximum(np.concatenate([[0.0], np.cumsum(xsq)[:-1]]), 0.0))

        for k in range(vec.nnz - 1, -1, -1):  # j = d..1, reverse order
            j, xj = int(vec.indices[k]), float(vec.values[k])
            pl = self.lists.get(j)
            if pl is not None and len(pl):
                if decayed:
                    if self.use_ap:
                        # L2AP: lists are NOT time-ordered (re-indexing);
                        # traverse everything, pruning expired entries.
                        self.counters.entries_traversed += len(pl)
                        pruned = pl.filter_expired_unordered(t_min)
                        self.counters.entries_pruned += pruned
                        self._n_entries -= pruned
                    else:
                        # L2: ordered lists ⇒ O(1) truncation, traverse live only.
                        pruned = pl.truncate_before_time(t_min)
                        self.counters.entries_pruned += pruned
                        self._n_entries -= pruned
                        self.counters.entries_traversed += len(pl)
                else:
                    self.counters.entries_traversed += len(pl)
                ids, vals, pnorms, ts = pl.active()
                if ids.size:
                    if decayed:
                        dec = np.exp(-self.lam * np.abs(item.t - ts))
                    else:
                        dec = 1.0
                    rs2 = math.sqrt(max(rst, 0.0)) if self.use_l2 else math.inf
                    remscore = np.minimum(rs1, rs2 * dec) if self.use_l2 else np.full(ids.shape, rs1)
                    pos = ids - acc.base
                    admitted = acc.score[pos] > 0.0
                    if self.use_ap:
                        _, nnz_y, vm_y = self.meta.lookup(ids)
                        size_ok = nnz_y * vm_y >= sz1
                    else:
                        size_ok = True
                    grow = (remscore >= self.theta) & ~acc.killed[pos] & size_ok
                    mask = (admitted | grow) & ~acc.killed[pos]
                    if np.any(mask):
                        upd = pos[mask]
                        acc.score[upd] += xj * vals[mask]
                        acc.touched.append(ids[mask])
                        if self.use_l2:
                            l2b = acc.score[upd] + x_pnorm_excl[k] * pnorms[mask] * (
                                dec[mask] if decayed else 1.0
                            )
                            dead = l2b < self.theta
                            if np.any(dead):
                                acc.killed[upd[dead]] = True
                                acc.score[upd[dead]] = 0.0
            # update running bounds after finishing list j (Alg. 3 lines 14–15)
            if self.use_ap:
                rs1 -= xj * float(mhat_x[k])
            rst -= xj * xj
        return acc

    # ------------------------------------------------------------------ #
    # candidate verification (Alg. 4 / 8)
    # ------------------------------------------------------------------ #
    def _cand_ver(self, item: StreamItem, acc: ScoreAccumulator, decayed: bool) -> List[Pair]:
        cands = acc.candidates()
        self.counters.candidates_generated += int(cands.size)
        if cands.size == 0:
            return []
        out: List[Pair] = []
        vec = item.vec
        vm_x, sum_x, nnz_x = vec.max_value, vec.coord_sum, vec.nnz
        for uid in cands.tolist():
            res = self.R.get(uid)
            if res is None:
                continue  # evicted residual ⇒ out of horizon
            c = float(acc.score[uid - acc.base])
            dec = math.exp(-self.lam * abs(item.t - res.t)) if decayed else 1.0
            ps1 = (c + res.q_pscore) * dec
            if ps1 < self.theta:
                continue
            if self.use_ap:
                ds1 = (c + min(vm_x * res.coord_sum, res.vm * sum_x)) * dec
                sz2 = (c + min(nnz_x, res.nnz) * vm_x * res.vm) * dec
                if ds1 < self.theta or sz2 < self.theta:
                    continue
            # full similarity: accumulated indexed part + residual dot
            self.counters.full_sims_computed += 1
            s = c + _sparse_dot_arrays(
                vec.indices, vec.values, res.indices, res.values
            )
            final = s * dec
            if final >= self.theta:
                out.append(Pair(uid_a=item.uid, uid_b=uid, sim=s, decayed=final))
        self.counters.pairs_emitted += len(out)
        return out

    # ------------------------------------------------------------------ #
    # eviction (time filtering of R / Q / meta)
    # ------------------------------------------------------------------ #
    def _evict(self, now: float) -> None:
        t_min = now - self.tau
        while self._arrivals and self._arrivals[0][1] < t_min:
            uid, _ = self._arrivals.popleft()
            res = self.R.pop(uid, None)
            if res is not None and self.use_ap:
                for j in res.indices.tolist():
                    s = self.Rinv.get(j)
                    if s is not None:
                        s.discard(uid)
            self._floor_uid = uid + 1
        self.meta.rebase(self._floor_uid)
        self.counters.peak_window_items = max(
            self.counters.peak_window_items, len(self._arrivals)
        )

    # ------------------------------------------------------------------ #
    # static (MiniBatch) API
    # ------------------------------------------------------------------ #
    def construct(
        self, items: List[StreamItem], m_global: Optional[Dict[int, float]] = None
    ) -> List[Pair]:
        """IndConstr: build over ``items`` and report raw-similar pairs.

        ``m_global`` is the combined max-vector of the previous and current
        windows (paper §6.1) so the b1 invariant also covers the queries
        that will follow."""
        if self.use_ap and m_global is not None:
            self.m = dict(m_global)
        out: List[Pair] = []
        for item in items:
            if self.use_ap and m_global is None:
                # static self-build without a provided m: grow m first so b1
                # stays admissible for items within this dataset
                for j, xj in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
                    if xj > self.m.get(j, 0.0):
                        self.m[j] = xj
            acc = self._cand_gen(item, decayed=False)
            out.extend(self._cand_ver(item, acc, decayed=False))
            self._add_to_index(item, keep_full=False)
            if self.use_ap:
                for j, xj in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
                    if xj > self.mhat.get(j, 0.0):
                        self.mhat[j] = xj
            self.counters.items_processed += 1
        return out

    def query(self, item: StreamItem) -> List[Pair]:
        acc = self._cand_gen(item, decayed=False)
        self.counters.items_processed += 1
        return self._cand_ver(item, acc, decayed=False)

    # ------------------------------------------------------------------ #
    # streaming (STR) API
    # ------------------------------------------------------------------ #
    def process(self, item: StreamItem) -> List[Pair]:
        """STR main step (Alg. 5/6): CG → CV → index-add (+m upkeep)."""
        assert self.streaming, "process() requires streaming=True"
        self._evict(item.t)
        if self.use_ap:
            # m update + re-indexing BEFORE CG so the invariant holds for x
            self._update_m_and_reindex(item)
        acc = self._cand_gen(item, decayed=True)
        pairs = self._cand_ver(item, acc, decayed=True)
        self._add_to_index(item, keep_full=self.use_ap)
        if self.use_ap:
            self.mhat_dec.update(item)
        self.counters.items_processed += 1
        return pairs


def _sparse_dot_arrays(
    ai: np.ndarray, av: np.ndarray, bi: np.ndarray, bv: np.ndarray
) -> float:
    if ai.size == 0 or bi.size == 0:
        return 0.0
    inter, ia, ib = np.intersect1d(ai, bi, assume_unique=True, return_indices=True)
    if inter.size == 0:
        return 0.0
    return float(np.dot(av[ia], bv[ib]))

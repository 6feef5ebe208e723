"""INV: plain inverted index (paper §5.1), static and streaming variants.

The inverted index stores *every* non-zero coordinate.  Candidate
generation accumulates the exact dot product, so verification is a pure
threshold test.  The streaming variant keeps posting lists time-ordered
and uses the O(1) truncate-on-first-expired fast path (paper §6.2).
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

import numpy as np

from .counters import Counters
from .postings import ItemMeta, PostingList, ScoreAccumulator
from .similarity import time_horizon
from .types import Pair, StreamItem

__all__ = ["InvIndex"]


class InvIndex:
    """Plain inverted index, no index-pruning bounds."""

    name = "INV"

    def __init__(
        self,
        theta: float,
        lam: float = 0.0,
        *,
        streaming: bool = False,
        counters: Optional[Counters] = None,
    ) -> None:
        self.theta = theta
        self.lam = lam
        self.streaming = streaming
        self.tau = time_horizon(theta, lam) if streaming else math.inf
        self.lists: dict[int, PostingList] = {}
        self.meta = ItemMeta()
        self.counters = counters if counters is not None else Counters()
        self._arrivals: deque[tuple[int, float]] = deque()
        self._floor_uid = 0  # smallest possibly-alive uid
        self._next_uid_hint = 0
        self._n_entries = 0

    # ------------------------------------------------------------------ #
    # shared internals
    # ------------------------------------------------------------------ #
    def _add_to_index(self, item: StreamItem) -> None:
        vec = item.vec
        self.meta.add(item.uid, item.t, vec.nnz, vec.max_value)
        for j, v in zip(vec.indices.tolist(), vec.values.tolist()):
            self.lists.setdefault(j, PostingList()).append(item.uid, v, 0.0, item.t)
        self._n_entries += len(vec.indices)
        self.counters.entries_indexed += vec.nnz
        self.counters.peak_index_entries = max(
            self.counters.peak_index_entries, self._n_entries
        )
        self._next_uid_hint = max(self._next_uid_hint, item.uid + 1)
        if self.streaming:
            self._arrivals.append((item.uid, item.t))

    def _evict(self, now: float) -> None:
        t_min = now - self.tau
        while self._arrivals and self._arrivals[0][1] < t_min:
            uid, _ = self._arrivals.popleft()
            self._floor_uid = uid + 1
        self.meta.rebase(self._floor_uid)

    def _cand_gen(self, item: StreamItem) -> ScoreAccumulator:
        span = self._next_uid_hint - self._floor_uid + 1
        acc = ScoreAccumulator(self._floor_uid, span)
        t_min = item.t - self.tau
        for j, xj in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
            pl = self.lists.get(j)
            if pl is None or len(pl) == 0:
                continue
            if self.streaming:
                pruned = pl.truncate_before_time(t_min)
                self.counters.entries_pruned += pruned
                self._n_entries -= pruned
            ids, vals, _, _ = pl.active()
            if ids.size == 0:
                continue
            self.counters.entries_traversed += int(ids.size)
            np.add.at(acc.score, ids - acc.base, xj * vals)
            acc.touched.append(ids)
        return acc

    def _cand_ver(self, item: StreamItem, acc: ScoreAccumulator, decayed: bool) -> List[Pair]:
        cands = acc.candidates()
        self.counters.candidates_generated += int(cands.size)
        if cands.size == 0:
            return []
        scores = acc.get(cands)
        if decayed:
            t_y, _, _ = self.meta.lookup(cands)
            dec = np.exp(-self.lam * np.abs(item.t - t_y))
            final = scores * dec
        else:
            final = scores
        keep = final >= self.theta
        out = [
            Pair(uid_a=item.uid, uid_b=int(u), sim=float(s), decayed=float(f))
            for u, s, f in zip(cands[keep], scores[keep], final[keep])
        ]
        self.counters.pairs_emitted += len(out)
        return out

    # ------------------------------------------------------------------ #
    # static (MiniBatch) API
    # ------------------------------------------------------------------ #
    def construct(
        self, items: List[StreamItem], m_global: Optional[dict] = None
    ) -> List[Pair]:
        """IndConstr-INV: build the index over ``items``, reporting all
        raw-similar pairs among them (Alg. 1 line 14)."""
        del m_global  # INV needs no dataset statistics
        out: List[Pair] = []
        for item in items:
            acc = self._cand_gen(item)
            out.extend(self._cand_ver(item, acc, decayed=False))
            self._add_to_index(item)
            self.counters.items_processed += 1
        return out

    def query(self, item: StreamItem) -> List[Pair]:
        """CandGen+CandVer against the built index (raw similarity)."""
        acc = self._cand_gen(item)
        self.counters.items_processed += 1
        return self._cand_ver(item, acc, decayed=False)

    # ------------------------------------------------------------------ #
    # streaming (STR) API
    # ------------------------------------------------------------------ #
    def process(self, item: StreamItem) -> List[Pair]:
        """STR-INV: query with time filtering, then index (Alg. 5)."""
        assert self.streaming, "process() requires streaming=True"
        self._evict(item.t)
        acc = self._cand_gen(item)
        pairs = self._cand_ver(item, acc, decayed=True)
        self._add_to_index(item)
        self.counters.items_processed += 1
        return pairs

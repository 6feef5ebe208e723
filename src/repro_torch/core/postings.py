"""Posting lists and score accumulators for the index schemes.

The paper (§6.2) implements posting lists as circular byte buffers that
double when full and halve when 3/4 empty, so that time-filter truncation
from the head is O(1).  We mirror that with growable NumPy arrays plus a
``head`` offset: truncation advances ``head``; compaction (copy-down)
happens only when the dead prefix exceeds half the capacity — amortized
O(1) per appended entry.

Each posting entry for dimension ``j`` is the paper's triple
``(ι(x), x_j, ||x'_j||)`` plus the arrival timestamp ``t(x)`` needed by the
streaming variants.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PostingList", "ScoreAccumulator", "ItemMeta"]

_INIT_CAP = 8


class PostingList:
    """A single inverted-index list ``I_j`` with O(1) head truncation."""

    __slots__ = ("ids", "vals", "pnorms", "ts", "head", "size")

    def __init__(self) -> None:
        self.ids = np.empty(_INIT_CAP, dtype=np.int64)
        self.vals = np.empty(_INIT_CAP, dtype=np.float64)
        self.pnorms = np.empty(_INIT_CAP, dtype=np.float64)
        self.ts = np.empty(_INIT_CAP, dtype=np.float64)
        self.head = 0
        self.size = 0  # logical end (exclusive); active region is [head, size)

    def __len__(self) -> int:
        return self.size - self.head

    def _grow(self) -> None:
        cap = self.ids.shape[0] * 2
        for name in ("ids", "vals", "pnorms", "ts"):
            old = getattr(self, name)
            new = np.empty(cap, dtype=old.dtype)
            new[: self.size] = old[: self.size]
            setattr(self, name, new)

    def _compact(self) -> None:
        n = len(self)
        for name in ("ids", "vals", "pnorms", "ts"):
            arr = getattr(self, name)
            arr[:n] = arr[self.head : self.size]
        self.head, self.size = 0, n

    def append(self, uid: int, val: float, pnorm: float, t: float) -> None:
        if self.size == self.ids.shape[0]:
            if self.head > self.ids.shape[0] // 2:
                self._compact()
            else:
                self._grow()
        i = self.size
        self.ids[i] = uid
        self.vals[i] = val
        self.pnorms[i] = pnorm
        self.ts[i] = t
        self.size += 1

    def active(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        s = slice(self.head, self.size)
        return self.ids[s], self.vals[s], self.pnorms[s], self.ts[s]

    def truncate_before_time(self, t_min: float) -> int:
        """Drop entries with ``t < t_min`` **assuming time-sorted entries**.

        This is the INV/L2 fast path (paper §6.2, "backwards scanning"):
        because entries are appended in arrival order, a binary search finds
        the first live entry and the whole expired prefix is dropped in O(1)
        (head advance).  Returns the number of entries pruned.
        """
        lo, hi = self.head, self.size
        cut = int(np.searchsorted(self.ts[lo:hi], t_min, side="left")) + lo
        pruned = cut - self.head
        self.head = cut
        if self.head == self.size:
            self.head = self.size = 0
        return pruned

    def filter_expired_unordered(self, t_min: float) -> int:
        """Drop entries with ``t < t_min`` when the list is NOT time-sorted.

        This is the L2AP path: re-indexing appends out-of-order entries, so
        the list must be scanned fully and compacted (paper §6.2 notes this
        as the reason L2AP loses its time-filtering fast path).
        Returns the number of entries pruned.
        """
        lo, hi = self.head, self.size
        keep = self.ts[lo:hi] >= t_min
        n_keep = int(keep.sum())
        pruned = (hi - lo) - n_keep
        if pruned:
            for name in ("ids", "vals", "pnorms", "ts"):
                arr = getattr(self, name)
                arr[lo : lo + n_keep] = arr[lo:hi][keep]
            self.size = lo + n_keep
            if self.head == self.size:
                self.head = self.size = 0
        return pruned


class ItemMeta:
    """Per-item metadata arrays keyed by ``uid - base`` (uids are monotone).

    Stores what CG/CV need about *indexed* items: arrival time, nnz and max
    value of the full vector (AP size bound, line 8 of Alg. 3).
    """

    __slots__ = ("base", "t", "nnz", "vm", "n")

    def __init__(self, cap: int = 64) -> None:
        self.base = 0
        self.n = 0
        self.t = np.zeros(cap, dtype=np.float64)
        self.nnz = np.zeros(cap, dtype=np.int64)
        self.vm = np.zeros(cap, dtype=np.float64)

    def add(self, uid: int, t: float, nnz: int, vm: float) -> None:
        if self.n == 0:
            self.base = uid
        i = uid - self.base
        cap = self.t.shape[0]
        if i >= cap:
            new_cap = max(cap * 2, i + 1)
            for name in ("t", "nnz", "vm"):
                old = getattr(self, name)
                new = np.zeros(new_cap, dtype=old.dtype)
                new[: self.n] = old[: self.n]
                setattr(self, name, new)
        self.t[i] = t
        self.nnz[i] = nnz
        self.vm[i] = vm
        self.n = max(self.n, i + 1)

    def rebase(self, new_base: int) -> None:
        """Forget everything before ``new_base`` (time-filter eviction)."""
        if new_base <= self.base:
            return
        off = new_base - self.base
        if off >= self.n:
            self.base, self.n = new_base, 0
            return
        for name in ("t", "nnz", "vm"):
            arr = getattr(self, name)
            arr[: self.n - off] = arr[off : self.n]
        self.base = new_base
        self.n -= off

    def lookup(self, uids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = uids - self.base
        return self.t[idx], self.nnz[idx], self.vm[idx]


class ScoreAccumulator:
    """The candidate score array ``C`` of Algorithms 3/7.

    Dense arrays indexed by ``uid - base`` (cheap because the time filter
    keeps the live uid range narrow).  ``touched`` tracks which uids have a
    non-zero accumulated score so CV can iterate only over candidates.
    ``killed`` marks candidates pruned by the l2bound (Alg. 3 line 13 sets
    ``C[ι(y)] ← 0``; we keep an explicit flag so a killed candidate is never
    re-admitted, which matches the semantics while avoiding wasted work —
    the paper's version remains correct because such candidates can never
    pass verification, see DESIGN.md §8).
    """

    __slots__ = ("base", "score", "killed", "touched")

    def __init__(self, base: int, span: int) -> None:
        self.base = base
        self.score = np.zeros(max(span, 1), dtype=np.float64)
        self.killed = np.zeros(max(span, 1), dtype=bool)
        self.touched: list[np.ndarray] = []

    def candidates(self) -> np.ndarray:
        """Distinct uids with positive accumulated score, ascending."""
        if not self.touched:
            return np.empty(0, dtype=np.int64)
        uids = np.unique(np.concatenate(self.touched))
        idx = uids - self.base
        live = (self.score[idx] > 0.0) & ~self.killed[idx]
        return uids[live]

    def get(self, uids: np.ndarray) -> np.ndarray:
        return self.score[uids - self.base]

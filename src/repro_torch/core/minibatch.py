"""The MiniBatch (MB) framework — paper Algorithm 1 + §6.1 refinements.

MB slices the stream into windows of length τ and uses a *static* APSS
index as a black box:

  * items are accumulated into the current window W_k;
  * when W_k closes, IndConstr runs over W_{k-1} (reporting all similar
    pairs *within* W_{k-1}) using the max-vector combined over W_{k-1} ∪ W_k
    (§6.1 — so the AP b1 invariant also covers the upcoming queries), then
    every item of W_k queries that index (reporting *cross-window* pairs);
  * W_{k-2}'s index is dropped.

Every pair with Δt ≤ τ lies within one window or across two consecutive
windows, so MB is complete; ApplyDecay (raw-pair filtering by the decayed
threshold) removes the up-to-2τ-apart false positives that MB inherently
generates (the paper's noted inefficiency — deliberately preserved here,
it is what Fig. 2 measures).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

from .counters import Counters
from .similarity import time_horizon
from .types import Pair, StreamItem

__all__ = ["MiniBatchJoiner", "apply_decay"]

IndexFactory = Callable[[], object]


def apply_decay(pairs: List[Pair], lam: float, theta: float, t_of: Dict[int, float]) -> List[Pair]:
    """ApplyDecay (Alg. 1 lines 12/15): re-threshold raw pairs by sim_Δt."""
    out: List[Pair] = []
    for p in pairs:
        dt = abs(t_of[p.uid_a] - t_of[p.uid_b])
        dec = p.sim * math.exp(-lam * dt)
        if dec >= theta:
            out.append(Pair(p.uid_a, p.uid_b, p.sim, dec))
    return out


class MiniBatchJoiner:
    """MB-IDX: any static index scheme, pipelined over two τ-windows."""

    def __init__(
        self,
        index_factory: IndexFactory,
        theta: float,
        lam: float,
        counters: Optional[Counters] = None,
    ) -> None:
        self.index_factory = index_factory
        self.theta = theta
        self.lam = lam
        self.tau = time_horizon(theta, lam)
        if not math.isfinite(self.tau):
            raise ValueError("MB requires a finite horizon (lambda > 0, theta < 1)")
        self.counters = counters if counters is not None else Counters()

        self._prev: List[StreamItem] = []
        self._cur: List[StreamItem] = []
        self._m_prev: Dict[int, float] = {}
        self._m_cur: Dict[int, float] = {}
        self._window_end: Optional[float] = None
        self._t_of: Dict[int, float] = {}

    # ------------------------------------------------------------------ #
    def push(self, item: StreamItem) -> List[Pair]:
        """Feed one stream item; returns pairs emitted by any window close."""
        out: List[Pair] = []
        if self._window_end is None:
            self._window_end = item.t + self.tau
        while item.t >= self._window_end:
            out.extend(self._rotate())
            self._window_end += self.tau
        self._cur.append(item)
        self._t_of[item.uid] = item.t
        for j, v in zip(item.vec.indices.tolist(), item.vec.values.tolist()):
            if v > self._m_cur.get(j, 0.0):
                self._m_cur[j] = v
        return out

    def finish(self) -> List[Pair]:
        """Flush: close the partial window, then once more to emit the
        within-pairs of the final window."""
        out = self._rotate()
        out.extend(self._rotate())
        return out

    # ------------------------------------------------------------------ #
    def _rotate(self) -> List[Pair]:
        out: List[Pair] = []
        if self._prev:
            m_comb = dict(self._m_prev)
            for j, v in self._m_cur.items():
                if v > m_comb.get(j, 0.0):
                    m_comb[j] = v
            index = self.index_factory()
            index.counters = self.counters
            self.counters.index_rebuilds += 1
            within = index.construct(self._prev, m_global=m_comb)
            out.extend(apply_decay(within, self.lam, self.theta, self._t_of))
            for item in self._cur:
                cross = index.query(item)
                out.extend(apply_decay(cross, self.lam, self.theta, self._t_of))
        elif self._cur:
            # very first window has no predecessor; its within-pairs are
            # reported when it becomes the "previous" window below
            pass
        # forget everything older than the previous window
        for it in self._prev:
            self._t_of.pop(it.uid, None)
        self._prev, self._cur = self._cur, []
        self._m_prev, self._m_cur = self._m_cur, {}
        return out

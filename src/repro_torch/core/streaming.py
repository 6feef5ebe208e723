"""The Streaming (STR) framework — paper Algorithm 5.

STR is a thin wrapper: every stream item is pushed through the streaming
index, which internally performs time-filtered candidate generation,
decayed verification, and index maintenance (lazy posting-list pruning,
residual eviction, and — for L2AP — max-vector upkeep with re-indexing).
"""

from __future__ import annotations

from typing import List, Optional

from .counters import Counters
from .types import Pair, StreamItem

__all__ = ["StreamingJoiner"]


class StreamingJoiner:
    """STR-IDX: incremental index with time filtering pushed inside."""

    def __init__(self, index, counters: Optional[Counters] = None) -> None:
        if not getattr(index, "streaming", False):
            raise ValueError("StreamingJoiner requires a streaming-mode index")
        self.index = index
        if counters is not None:
            index.counters = counters
        self.counters = index.counters

    def push(self, item: StreamItem) -> List[Pair]:
        return self.index.process(item)

    def finish(self) -> List[Pair]:
        return []

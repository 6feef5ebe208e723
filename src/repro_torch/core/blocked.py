"""Synchronous blocked-join facade over the torch engine.

Counterpart of ``repro.core.blocked``: :class:`BlockedJoinConfig`, the
historical configuration, mapped onto
:class:`~repro_torch.engine.EngineConfig`, and
:class:`BlockedStreamJoiner`, which pushes each batch through the engine
and drains its pairs at once.  The window helpers are re-exported from
:mod:`repro_torch.engine.window`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .._device import DeviceLike
from ..engine.engine import EngineConfig, StreamEngine
from ..engine.window import (  # noqa: F401
    WindowState,
    init_window,
    push_with_overflow,
)
from .similarity import time_horizon

__all__ = ["WindowState", "init_window", "BlockedJoinConfig", "BlockedStreamJoiner"]


@dataclasses.dataclass(frozen=True)
class BlockedJoinConfig:
    theta: float
    lam: float
    capacity: int
    d: int
    block_q: int = 128
    block_w: int = 128
    chunk_d: int = 128
    use_ref: bool = False  # route through the dense reference, not the kernels
    max_pairs: int = 4096  # compacted-emission capacity per micro-batch

    @property
    def tau(self) -> float:
        return time_horizon(self.theta, self.lam)

    def to_engine(self, micro_batch: Optional[int] = None) -> EngineConfig:
        """The engine configuration: ``tile_k = block_q·block_w`` makes the
        per-tile select lossless, so the only way to lose a pair is the
        ``max_pairs`` budget, and that raises (see :meth:`BlockedStreamJoiner
        .push`).  The kernel route (``join_impl=None``, the reference's
        ``"pallas"``) is pinned: its pruning telemetry
        (``chunks_executed``/``tiles_total``) is the kernel's."""
        return EngineConfig(
            theta=self.theta, lam=self.lam, capacity=self.capacity, d=self.d,
            micro_batch=micro_batch or self.block_q, max_pairs=self.max_pairs,
            tile_k=self.block_q * self.block_w, join_impl=None,
            block_q=self.block_q, block_w=self.block_w, chunk_d=self.chunk_d,
            use_ref=self.use_ref,
        )


class BlockedStreamJoiner:
    """Synchronous facade: feeds batches through the engine and returns the
    emitted pairs ``(uid_a, uid_b, decayed_score)`` of each push at once.

    It refuses to drop pairs silently: a push that overflows the compacted
    buffer raises instead of returning a truncated list — raise
    ``cfg.max_pairs`` or use :class:`~repro_torch.engine.StreamEngine`
    directly and handle ``pairs_dropped``.
    """

    def __init__(self, cfg: BlockedJoinConfig, device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.engine = StreamEngine(cfg.to_engine(), device=device)

    def push(self, vecs: np.ndarray, ts: np.ndarray) -> List[Tuple[int, int, float]]:
        before = self.engine.pairs_dropped
        self.engine.push(vecs, ts)
        dropped = self.engine.pairs_dropped - before
        if dropped:
            # raise before draining: the surviving pairs stay queued, so a
            # caller that catches can still recover them via engine.drain_*
            raise RuntimeError(
                f"emission overflow: {dropped} pairs dropped (max_pairs="
                f"{self.cfg.max_pairs} per micro-batch); raise "
                f"BlockedJoinConfig.max_pairs or switch to StreamEngine"
            )
        return self.engine.drain_pairs()

    @property
    def state(self) -> WindowState:
        return self.engine.state

    @property
    def overflow(self) -> int:
        return self.engine.overflow

    @property
    def chunks_executed(self) -> int:
        return self.engine.stats()["chunks_executed"]

    @property
    def tiles_total(self) -> int:
        return self.engine.stats()["tiles_total"]

"""SSSJ serving loop: batched requests → embeddings → similar-pair events.

Counterpart of ``repro.serving.service``'s single-stream service.
Timestamped documents arrive in request batches; each batch is embedded
(a caller-provided host function such as
:func:`repro_torch.data.hashing_embed`, or caller-provided vectors),
unit-normalized on the host, and fed to the torch
:class:`~repro_torch.engine.StreamEngine`; the compacted pair arrays it
drains drive near-duplicate grouping (union-find) — application #2 — or
trend detection (groups that grew within the horizon) — application #1.

This module holds :class:`SSSJService` alone.  The reference's
``MultiTenantSSSJService`` rides the multi-tenant runtime and comes with
it (ROADMAP queue 1, "Multi-tenant runtime"); its ``LMEmbedder`` comes
with the LM stack.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .._device import DeviceLike
from ..engine.engine import EngineConfig, StreamEngine

__all__ = [
    "SSSJService",
    "ServiceStats",
]


@dataclasses.dataclass
class ServiceStats:
    n_items: int = 0
    n_pairs: int = 0
    n_groups: int = 0
    window_overflow: int = 0
    pairs_dropped: int = 0
    bytes_to_host: int = 0


class _UnionFind:
    """Union-find with two-pass path compression and union by size."""

    __slots__ = ("parent", "size")

    def __init__(self) -> None:
        self.parent: Dict[int, int] = {}
        self.size: Dict[int, int] = {}

    def find(self, x: int) -> int:
        parent = self.parent
        root = parent.get(x)
        if root is None:
            parent[x] = x
            self.size[x] = 1
            return x
        # pass 1: walk to the root
        while parent[root] != root:
            root = parent[root]
        # pass 2: point every node on the path straight at the root
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


class SSSJService:
    """Streaming near-duplicate / trend service over an embedding stream."""

    def __init__(
        self,
        theta: float,
        lam: float,
        dim: int,
        capacity: int = 4096,
        embed_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        block: int = 64,
        max_pairs: int = 4096,
        strict: bool = True,
        tile_k: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        """``strict`` keeps the pre-engine lossless contract: a request
        whose emission overflows — the global ``max_pairs`` budget or a
        per-tile ``tile_k`` candidate buffer — raises instead of silently
        grouping on a truncated pair set.  Strict mode therefore defaults
        ``tile_k`` to the lossless ``block²`` so the budget is the only
        way to lose a pair; pass ``strict=False`` to accept best-effort
        grouping (smaller ``tile_k``, watch ``stats.pairs_dropped``).
        The engine runs on ``device`` (``None`` = CUDA)."""
        if tile_k is None:
            tile_k = block * block if strict else 256
        cfg = EngineConfig(
            theta=theta, lam=lam, capacity=capacity, d=dim,
            micro_batch=block, max_pairs=max_pairs, tile_k=tile_k,
            block_q=block, block_w=block, chunk_d=min(dim, 128),
        )
        self.engine = StreamEngine(cfg, device=device)
        self.embed_fn = embed_fn
        self.strict = strict
        self.groups = _UnionFind()
        self.stats = ServiceStats()

    # ------------------------------------------------------------------ #
    def submit(
        self,
        batch: np.ndarray,           # (B, dim) vectors or (B, S) tokens
        timestamps: np.ndarray,      # (B,)
    ) -> List[Tuple[int, int, float]]:
        """Process one request batch; returns the emitted similar pairs
        (uid_newer, uid_older, decayed_score)."""
        if self.embed_fn is not None and batch.ndim == 2 and batch.dtype.kind in "iu":
            vecs = self.embed_fn(batch)
        else:
            vecs = np.asarray(batch, np.float32)
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / np.maximum(norms, 1e-9)
        dropped_before = self.engine.pairs_dropped
        self.engine.push(vecs, np.asarray(timestamps, np.float64))
        dropped = self.engine.pairs_dropped - dropped_before
        if dropped and self.strict:
            # surviving pairs stay queued for recovery via engine.drain_*
            raise RuntimeError(
                f"emission overflow: {dropped} pairs dropped this request "
                f"(max_pairs={self.engine.cfg.max_pairs} per micro-batch); "
                f"raise max_pairs or construct SSSJService(strict=False)"
            )
        # one sync per request batch: the compacted arrays, not dense scores
        ua, ub, sc = self.engine.drain_arrays()
        pairs = list(zip(ua.tolist(), ub.tolist(), sc.tolist()))
        union = self.groups.union
        for a, b, _ in pairs:
            union(a, b)
        self.stats.n_items += vecs.shape[0]
        self.stats.n_pairs += len(pairs)
        self.stats.window_overflow = self.engine.overflow
        self.stats.pairs_dropped = self.engine.pairs_dropped
        self.stats.bytes_to_host = self.engine.bytes_to_host
        return pairs

    # ------------------------------------------------------------------ #
    def duplicate_groups(self) -> List[List[int]]:
        """Connected components of the similar-pair graph (app #2)."""
        comp: Dict[int, List[int]] = {}
        for x in list(self.groups.parent):
            comp.setdefault(self.groups.find(x), []).append(x)
        groups = [sorted(v) for v in comp.values() if len(v) > 1]
        self.stats.n_groups = len(groups)
        return sorted(groups)

    def trending(self, min_size: int = 3) -> List[List[int]]:
        """Groups that reached ``min_size`` — the paper's trend-detection
        application (a burst of mutually-similar items within the horizon)."""
        return [g for g in self.duplicate_groups() if len(g) >= min_size]

    # -- observability ------------------------------------------------- #
    @property
    def registry(self):
        """The engine's :class:`~repro_torch.obs.MetricsRegistry`."""
        return self.engine.registry

    def snapshot(self) -> dict:
        """One coherent namespaced metrics snapshot (``engine/…``)."""
        return self.engine.registry.snapshot()

    def prometheus_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.engine.registry.prometheus_text()

"""SSSJ serving loop: batched requests → embeddings → similar-pair events.

Counterpart of ``repro.serving.service``.  Timestamped documents arrive
in request batches; each batch is embedded (a caller-provided host
function such as :func:`repro_torch.data.hashing_embed`, or
caller-provided vectors), unit-normalized on the host, and fed to the
torch :class:`~repro_torch.engine.StreamEngine`; the compacted pair
arrays it drains drive near-duplicate grouping (union-find) —
application #2 — or trend detection (groups that grew within the
horizon) — application #1.

:class:`MultiTenantSSSJService` is the same loop over the multi-tenant
runtime: many logical streams coalesce onto one engine, each with its
own ``(θ, λ)``, and the union-find keys are namespaced ``(tenant, uid)``
tuples; with ``mesh=`` it runs on the sharded engine, with ``fused=`` it
takes token batches and embeds them inside the runtime's step.  The
host-side LM embedder is :class:`repro_torch.serving.embedder.LMEmbedder`,
an ``embed_fn`` for :class:`SSSJService`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike
from ..engine.engine import EngineConfig, StreamEngine
from ..engine.window import quota_partition
from ..runtime import FusedEmbedder, MultiTenantRuntime, ShardedFacade, TenantTable

__all__ = [
    "MultiTenantSSSJService",
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


class MultiTenantSSSJService:
    """Near-duplicate / trend service over K coalesced logical streams.

    One engine serves every tenant: ``submit`` enqueues a tenant's
    documents, ``flush`` coalesces queued arrivals across tenants into full
    micro-batches, drains the emitted pairs and unions them under
    namespaced keys ``(tenant, uid)``, so no two tenants' groups can merge.
    Per-tenant ``(θ, λ)`` comes from the :class:`~repro_torch.runtime
    .TenantTable`; vectors are unit-normalized here.  Tiles are
    ``micro_batch`` wide (``block_q = block_w = micro_batch``), with the
    lossless ``tile_k = micro_batch²`` unless given.

    ``eviction`` selects the window's write-slot policy: ``"oldest"``,
    ``"dead"`` (reuse expired slots first) or ``"quota"`` (a static
    partition of the window into per-tenant sub-rings, so a bursty tenant
    only evicts its own items); ``quotas`` gives each tenant's total slots
    (summing to ``capacity``; default: equal weights).  The engine runs on
    ``device`` (``None`` = CUDA).

    With ``mesh`` (a :class:`~repro_torch.launch.Mesh`) the service runs
    on the sharded engine: ``capacity`` stays the total window, split
    evenly over the mesh's window shards, and the emissions, so the
    groups, are the single-device run's.  Every quota must then divide
    by the shard count, as sub-rings are local to each shard.  With
    ``fused`` (a :class:`~repro_torch.runtime.FusedEmbedder`, single device
    only) ``submit`` takes ``(b, seq_len)`` token batches, embedded on the
    device inside the runtime's step.
    """

    def __init__(
        self,
        table: TenantTable,
        dim: int,
        capacity: int = 4096,
        micro_batch: int = 64,
        max_pairs: int = 4096,
        tile_k: Optional[int] = None,
        span: int = 4,
        max_queue_per_tenant: int = 65536,
        fused: Optional[FusedEmbedder] = None,
        mesh=None,
        eviction: str = "oldest",
        quotas: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
    ) -> None:
        engine = None
        n = 1
        if mesh is not None:
            engine = ShardedFacade(mesh)
            n = engine.n_shards
            if capacity % n:
                raise ValueError(
                    f"capacity {capacity} not divisible by {n} window shards"
                )
            if micro_batch > capacity // n:
                raise ValueError(
                    f"micro_batch ({micro_batch}) exceeds the per-shard "
                    f"window capacity ({capacity // n} = {capacity} total / "
                    f"{n} shards); raise capacity to ≥ {micro_batch * n} "
                    f"or lower micro_batch"
                )
        if eviction == "quota" and quotas is None:
            # partitioned per shard and scaled back up, so the default
            # split always divides by the shard count
            quotas = tuple(
                q * n
                for q in quota_partition(capacity // n, [1.0] * table.n_tenants)
            )
        if quotas is not None:
            # checked against the TOTAL capacity, before the per-shard split
            if eviction != "quota":
                raise ValueError(
                    f"quotas are only meaningful under eviction='quota' "
                    f"(got eviction={eviction!r})"
                )
            quotas = [int(q) for q in quotas]
            if len(quotas) != table.n_tenants:
                raise ValueError(
                    f"{len(quotas)} quotas for {table.n_tenants} tenants"
                )
            if min(quotas) < 1:
                raise ValueError(f"every tenant needs ≥ 1 slot, got {quotas}")
            if sum(quotas) != capacity:
                raise ValueError(
                    f"quotas sum to {sum(quotas)}, not capacity {capacity}"
                )
            bad = [q for q in quotas if q % n]
            if bad:
                raise ValueError(
                    f"quotas {bad} not divisible by {n} window shards "
                    f"(sub-rings are local to each shard)"
                )
            quotas = tuple(q // n for q in quotas)
        capacity //= n
        th0, lm0 = table.spec(0)
        cfg = EngineConfig(
            theta=th0, lam=lm0, capacity=capacity, d=dim,
            micro_batch=micro_batch, max_pairs=max_pairs,
            tile_k=tile_k or micro_batch * micro_batch,
            block_q=micro_batch, block_w=micro_batch,
            chunk_d=min(dim, 128),
            eviction=eviction, quotas=quotas,
        )
        self.runtime = MultiTenantRuntime(
            cfg, table, span=span, max_queue_per_tenant=max_queue_per_tenant,
            fused=fused, engine=engine, device=device,
        )
        self.table = table
        self.fused = fused
        self.groups = _UnionFind()
        # global uid → per-tenant local uid (dense per-tenant numbering, the
        # namespace the caller reasons in)
        self._local_of: Dict[int, int] = {}
        self._next_local = [0] * table.n_tenants

    # ------------------------------------------------------------------ #
    def submit(
        self,
        tenant: int,
        batch: np.ndarray,           # (B, dim) vectors or (B, S) tokens
        timestamps: np.ndarray,      # (B,)
    ) -> np.ndarray:
        """Enqueue one tenant's documents; returns their *local* uids.
        Nothing reaches the device until :meth:`flush`: a tenant submitting
        3 documents at a time still rides full micro-batches once enough
        tenants queue up."""
        if self.fused is None:
            vecs = np.asarray(batch, np.float32)
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            batch = vecs / np.maximum(norms, 1e-9)
        uids = self.runtime.submit(tenant, batch, np.asarray(timestamps))
        base = self._next_local[tenant]
        local = np.arange(base, base + uids.size, dtype=np.int64)
        self._next_local[tenant] = base + uids.size
        for g, l in zip(uids.tolist(), local.tolist()):
            self._local_of[g] = l
        return local

    def flush(
        self, final: bool = False
    ) -> Dict[int, List[Tuple[int, int, float]]]:
        """Dispatch queued arrivals, drain, and group the emitted pairs.

        With ``final=False`` only full micro-batches dispatch (rows short of
        one stay queued); ``final=True`` pads the tail out (end of stream,
        or a latency deadline).  Returns ``{tenant: [(local_uid_newer,
        local_uid_older, score)]}`` for tenants that emitted anything.
        """
        self.runtime.flush(final=final)
        per = self.runtime.drain_by_tenant()
        out: Dict[int, List[Tuple[int, int, float]]] = {}
        union = self.groups.union
        loc = self._local_of
        for t, (ua, ub, sc) in per.items():
            if ua.size == 0:
                continue
            pairs = [
                (loc[a], loc[b], s)
                for a, b, s in zip(ua.tolist(), ub.tolist(), sc.tolist())
            ]
            for a, b, _ in pairs:
                union((t, a), (t, b))          # namespaced: (tenant, uid)
            out[t] = pairs
        return out

    # ------------------------------------------------------------------ #
    def duplicate_groups(self, tenant: int) -> List[List[int]]:
        """Connected components of one tenant's similar-pair graph."""
        comp: Dict[Hashable, List[int]] = {}
        for key in list(self.groups.parent):
            t, u = key
            if t != tenant:
                continue
            comp.setdefault(self.groups.find(key), []).append(u)
        return sorted(sorted(v) for v in comp.values() if len(v) > 1)

    def trending(self, tenant: int, min_size: int = 3) -> List[List[int]]:
        return [
            g for g in self.duplicate_groups(tenant) if len(g) >= min_size
        ]

    def tenant_stats(self, tenant: int) -> dict:
        return self.runtime.tenant_stats(tenant)

    def stats(self) -> dict:
        return self.runtime.stats()

    # -- observability ------------------------------------------------- #
    @property
    def registry(self):
        """The shared :class:`~repro_torch.obs.MetricsRegistry`: engine,
        router, per-tenant, span and latency metrics in one instance."""
        return self.runtime.registry

    def snapshot(self) -> dict:
        """One coherent namespaced metrics snapshot (``engine/…``,
        ``router/…``, ``runtime/…``, ``span/…``, ``tenant/<k>/…``,
        ``latency/…``)."""
        return self.runtime.registry.snapshot()

    def prometheus_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.runtime.registry.prometheus_text()

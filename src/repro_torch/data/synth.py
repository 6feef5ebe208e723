"""Synthetic streams; numpy copies of ``repro.data.synth``'s generators
(same seeds give the same arrays and items).

:func:`synthetic_stream` makes the scaled analogues of the paper's Table-1
corpora (:data:`DATASET_SPECS`): sparse, unit-normalized rows whose term
ids follow a Zipfian popularity law, per-item nnz log-normal around the
target density, and poisson, sequential or bursty timestamps.  The dense
generators feed the device engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from ..core.types import StreamItem, make_sparse, unit_normalize

__all__ = [
    "StreamSpec",
    "DATASET_SPECS",
    "synthetic_stream",
    "bursty_tenant_traffic",
    "dense_embedding_stream",
    "planted_duplicates",
    "topic_drift_stream",
]


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Characteristics of a synthetic stream (a scaled Table-1 analogue)."""

    name: str
    n: int
    dims: int
    avg_nnz: float
    timestamps: str  # "poisson" | "sequential" | "bursty"
    zipf_a: float = 1.3
    rate: float = 1.0  # mean arrivals per time unit


# Scaled-down analogues of Table 1 (n reduced ~100–1000×, dims ~20×; density
# and timestamp character preserved).
DATASET_SPECS = {
    "webspam": StreamSpec("webspam", 3_500, 8_192, 360.0, "poisson"),
    "rcv1": StreamSpec("rcv1", 8_000, 4_096, 75.0, "sequential"),
    "blogs": StreamSpec("blogs", 12_000, 8_192, 40.0, "bursty"),
    "tweets": StreamSpec("tweets", 20_000, 16_384, 9.5, "bursty"),
}


def _timestamps(spec: StreamSpec, rng: np.random.Generator) -> np.ndarray:
    if spec.timestamps == "sequential":
        return np.arange(spec.n, dtype=np.float64) / spec.rate
    if spec.timestamps == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate, size=spec.n))
    if spec.timestamps == "bursty":
        # Burst process: exponential gaps whose rate itself jumps between a
        # slow and a fast regime (heavy temporal clustering, like publishing
        # dates around events).
        gaps = np.empty(spec.n)
        i = 0
        while i < spec.n:
            burst = int(rng.integers(5, 50))
            fast = bool(rng.random() < 0.5)
            rate = spec.rate * (10.0 if fast else 0.2)
            k = min(burst, spec.n - i)
            gaps[i : i + k] = rng.exponential(1.0 / rate, size=k)
            i += k
        return np.cumsum(gaps)
    raise ValueError(f"unknown timestamp process {spec.timestamps!r}")


def synthetic_stream(spec: StreamSpec, seed: int = 0) -> List[StreamItem]:
    """Generate a sparse, unit-normalized, Zipf-termed stream."""
    rng = np.random.default_rng(seed)
    ts = _timestamps(spec, rng)
    # Zipfian term popularity over the dimension space
    ranks = np.arange(1, spec.dims + 1, dtype=np.float64)
    probs = ranks ** (-spec.zipf_a)
    probs /= probs.sum()
    sigma = 0.6
    mu = math.log(max(spec.avg_nnz, 1.5)) - sigma**2 / 2
    items: List[StreamItem] = []
    for i in range(spec.n):
        nnz = int(np.clip(rng.lognormal(mu, sigma), 1, spec.dims // 2))
        idx = np.unique(rng.choice(spec.dims, size=nnz, p=probs))
        val = rng.random(idx.shape[0]) + 0.05
        items.append(
            StreamItem(i, float(ts[i]), unit_normalize(make_sparse(idx, val)))
        )
    return items


def dense_embedding_stream(
    n: int,
    d: int,
    seed: int = 0,
    rate: float = 1.0,
    dup_frac: float = 0.15,
    dup_noise: float = 0.05,
    signed: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense unit-vector stream with planted near-duplicates.

    Returns ``(vectors (n, d), timestamps (n,))``.  A ``dup_frac`` fraction
    of items are noisy copies of one of the 64 items before them — the
    ground truth for near-duplicate detection.
    """
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.exponential(1.0 / rate, size=n))
    base = rng.standard_normal((n, d))
    if not signed:
        base = np.abs(base)
    for i in range(1, n):
        if rng.random() < dup_frac:
            src = int(rng.integers(max(0, i - 64), i))
            base[i] = base[src] + dup_noise * rng.standard_normal(d)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    return base.astype(np.float32), ts.astype(np.float64)


def topic_drift_stream(
    n: int,
    d: int,
    n_topics: int = 8,
    seg: int = 512,
    seed: int = 0,
    rate: float = 1.0,
    in_spread: float = 0.25,
    leak: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """Topically clustered unit-vector stream for value-bound pruning.

    The stream dwells on one topic for ``seg`` consecutive items, then
    jumps to another.  Each topic owns a disjoint block of ``d //
    n_topics`` coordinates (in-block weights ``|N(1, in_spread²)|``,
    out-of-block ``N(0, leak²)``), so per-strip value summaries can prove
    whole window strips irrelevant to a query batch.

    Returns ``(vectors (n, d) f32, timestamps (n,) f64)``.
    """
    if d % n_topics:
        raise ValueError(f"d={d} must be divisible by n_topics={n_topics}")
    rng = np.random.default_rng(seed)
    bw = d // n_topics
    vecs = rng.normal(0.0, leak, size=(n, d))
    topic = -1
    for s0 in range(0, n, seg):
        step = int(rng.integers(1, n_topics))  # never re-draw the same topic
        topic = (topic + step) % n_topics if topic >= 0 else int(rng.integers(n_topics))
        k = min(seg, n - s0)
        vecs[s0 : s0 + k, topic * bw : (topic + 1) * bw] = np.abs(
            rng.normal(1.0, in_spread, size=(k, bw))
        )
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ts = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return vecs.astype(np.float32), ts.astype(np.float64)


def bursty_tenant_traffic(
    n_slow: int,
    rounds: int,
    burst: int,
    d: int,
    seed: int = 7,
    repost_gap: float = 1.5,
    dup_noise: float = 0.02,
):
    """Multi-tenant flood traffic: the eviction policies' stress stream.

    Tenant 0 floods ``burst`` random unit vectors per round; slow tenants
    ``1..n_slow`` each repost a noisy copy of their own base vector once
    per round, ``repost_gap`` time units apart, so consecutive reposts
    pair *iff* the previous one still lives in the window, which a bursty
    co-tenant threatens under oldest-first eviction.

    Returns ``(submits, per_tenant)``: ``submits`` is a time-ordered list
    of ``(tenant, vecs (b, d) f32, ts (b,))`` submit calls, and
    ``per_tenant[k]`` is tenant *k*'s full ``(vecs, ts)`` stream in local
    index order (the brute-force-truth input).
    """
    rng = np.random.default_rng(seed)
    bases = rng.standard_normal((n_slow + 1, d))
    submits = []
    streams: List[list] = [[] for _ in range(n_slow + 1)]
    for r in range(rounds):
        t0 = repost_gap * r
        for k in range(1, n_slow + 1):
            v = bases[k] + dup_noise * rng.standard_normal(d)
            v = (v / np.linalg.norm(v)).astype(np.float32)
            tk = np.array([t0 + 0.01 * k])
            streams[k].append((v[None], tk))
            submits.append((k, v[None], tk))
        vb = rng.standard_normal((burst, d))
        vb = (vb / np.linalg.norm(vb, axis=1, keepdims=True)).astype(np.float32)
        tb = t0 + 0.1 + 0.003 * np.arange(burst)
        streams[0].append((vb, tb))
        submits.append((0, vb, tb))
    per_tenant = [
        (np.concatenate([v for v, _ in s]), np.concatenate([t for _, t in s]))
        for s in streams
    ]
    return submits, per_tenant


def planted_duplicates(
    vectors: np.ndarray, ts: np.ndarray, theta: float, lam: float
) -> set[tuple[int, int]]:
    """Ground-truth decayed-similar pair set for a dense stream (testing)."""
    sims = vectors @ vectors.T
    dts = np.abs(ts[:, None] - ts[None, :])
    dec = sims * np.exp(-lam * dts)
    n = vectors.shape[0]
    out = set()
    for i in range(n):
        for j in range(i):
            if dec[i, j] >= theta:
                out.add((j, i))
    return out

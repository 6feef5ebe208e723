"""Synthetic streams; numpy copies of ``repro.data.synth``'s
:func:`dense_embedding_stream`, :func:`topic_drift_stream` and
:func:`bursty_tenant_traffic` (same seeds give the same arrays)."""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["bursty_tenant_traffic", "dense_embedding_stream", "topic_drift_stream"]


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

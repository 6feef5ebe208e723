"""Time-dependent similarity, the time-filtering horizon (paper §3) and the
brute-force oracles; the port's copy of ``repro.core.similarity``, kept here
so the port imports nothing of ``repro``."""

from __future__ import annotations

import math
from typing import Iterable, List

import numpy as np

from .types import Pair, SparseVector, StreamItem, sparse_dot

__all__ = [
    "decayed_similarity",
    "time_horizon",
    "decay_lambda_for",
    "brute_force_join",
    "brute_force_join_dense",
]


def decayed_similarity(sim: float, dt: float, lam: float) -> float:
    """``sim_Δt(x, y) = dot(x, y) * exp(-λ |t(x) - t(y)|)``."""
    return sim * math.exp(-lam * abs(dt))


def time_horizon(theta: float, lam: float) -> float:
    """``τ = λ⁻¹ log θ⁻¹`` — pairs further apart in time cannot be similar.

    Follows from ``dot(x, y) ≤ 1`` for unit vectors:
    ``sim_Δt ≤ exp(-λ Δt) < θ  ⟺  Δt > λ⁻¹ log θ⁻¹``.
    """
    if not 0.0 < theta <= 1.0:
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    if lam < 0.0:
        raise ValueError(f"lambda must be >= 0, got {lam}")
    if lam == 0.0:
        return math.inf
    return math.log(1.0 / theta) / lam


def decay_lambda_for(theta: float, tau: float) -> float:
    """Parameter-setting recipe from paper §3: ``λ = τ⁻¹ log θ⁻¹``."""
    return math.log(1.0 / theta) / tau


def brute_force_join(
    items: Iterable[StreamItem], theta: float, lam: float
) -> List[Pair]:
    """O(n²) ground-truth oracle for the SSSJ problem (testing only)."""
    buf = list(items)
    out: List[Pair] = []
    for i in range(len(buf)):
        for j in range(i):
            x, y = buf[i], buf[j]
            s = sparse_dot(x.vec, y.vec)
            d = decayed_similarity(s, x.t - y.t, lam)
            if d >= theta:
                out.append(Pair(uid_a=x.uid, uid_b=y.uid, sim=s, decayed=d))
    return out


def brute_force_join_dense(
    mat: np.ndarray, ts: np.ndarray, theta: float, lam: float
) -> List[Pair]:
    """Dense-matrix oracle: rows of ``mat`` are unit vectors."""
    sims = mat @ mat.T
    dts = np.abs(ts[:, None] - ts[None, :])
    dec = sims * np.exp(-lam * dts)
    out: List[Pair] = []
    n = mat.shape[0]
    for i in range(n):
        for j in range(i):
            if dec[i, j] >= theta:
                out.append(
                    Pair(uid_a=i, uid_b=j, sim=float(sims[i, j]), decayed=float(dec[i, j]))
                )
    return out

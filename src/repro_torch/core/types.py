"""Core data types for the streaming similarity self-join (SSSJ).

The paper operates on unit-normalized sparse vectors arriving on a
timestamped stream.  This module defines the faithful (CPU-side)
representations used by the host implementation of the paper's
algorithms (the port's copy of ``repro.core.types``); the device engine
(:mod:`repro_torch.core.blocked` and :mod:`repro_torch.kernels.sssj_join`)
uses dense ``(n, d)`` tiles instead.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "SparseVector",
    "StreamItem",
    "Pair",
    "make_sparse",
    "sparse_from_dense",
    "sparse_to_dense",
    "sparse_dot",
    "unit_normalize",
]


@dataclasses.dataclass(frozen=True)
class SparseVector:
    """A sparse vector with coordinates sorted by dimension index.

    Attributes:
      indices: int32 array of dimension ids, strictly increasing.
      values:  float64 array of the same length, all non-zero.
    """

    indices: np.ndarray
    values: np.ndarray

    def __post_init__(self) -> None:
        if self.indices.shape != self.values.shape:
            raise ValueError("indices/values shape mismatch")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_value(self) -> float:
        """``vm_x`` in the paper: the maximum coordinate value."""
        return float(self.values.max()) if self.nnz else 0.0

    @property
    def coord_sum(self) -> float:
        """``Σ_x`` in the paper: the sum of coordinate values."""
        return float(self.values.sum())

    @property
    def norm(self) -> float:
        return float(np.sqrt(np.sum(self.values * self.values)))

    def prefix(self, k: int) -> "SparseVector":
        """The prefix ``x'`` consisting of the first ``k`` stored coords."""
        return SparseVector(self.indices[:k], self.values[:k])

    def suffix(self, k: int) -> "SparseVector":
        return SparseVector(self.indices[k:], self.values[k:])


@dataclasses.dataclass(frozen=True)
class StreamItem:
    """A timestamped vector on the input stream."""

    uid: int
    t: float
    vec: SparseVector


@dataclasses.dataclass(frozen=True)
class Pair:
    """An emitted similar pair.

    ``sim`` is the *raw* cosine similarity ``dot(x, y)``; ``decayed`` is the
    time-dependent similarity ``sim * exp(-lambda * |t(x) - t(y)|)`` that the
    SSSJ problem thresholds on.
    """

    uid_a: int
    uid_b: int
    sim: float
    decayed: float

    def key(self) -> tuple[int, int]:
        a, b = self.uid_a, self.uid_b
        return (a, b) if a < b else (b, a)


def make_sparse(indices: Sequence[int], values: Sequence[float]) -> SparseVector:
    idx = np.asarray(indices, dtype=np.int32)
    val = np.asarray(values, dtype=np.float64)
    order = np.argsort(idx, kind="stable")
    idx, val = idx[order], val[order]
    keep = val != 0.0
    return SparseVector(idx[keep], val[keep])


def sparse_from_dense(x: np.ndarray) -> SparseVector:
    idx = np.nonzero(x)[0].astype(np.int32)
    return SparseVector(idx, x[idx].astype(np.float64))


def sparse_to_dense(x: SparseVector, dim: int) -> np.ndarray:
    out = np.zeros(dim, dtype=np.float64)
    out[x.indices] = x.values
    return out


def sparse_dot(x: SparseVector, y: SparseVector) -> float:
    """Dot product of two sorted sparse vectors (merge join)."""
    inter, ix, iy = np.intersect1d(
        x.indices, y.indices, assume_unique=True, return_indices=True
    )
    if inter.size == 0:
        return 0.0
    return float(np.dot(x.values[ix], y.values[iy]))


def unit_normalize(x: SparseVector) -> SparseVector:
    n = x.norm
    if n == 0.0:
        return x
    return SparseVector(x.indices, x.values / n)


def as_stream(
    vectors: Iterable[SparseVector], timestamps: Iterable[float]
) -> Iterator[StreamItem]:
    """Zip vectors with non-decreasing timestamps into stream items."""
    last = -np.inf
    for uid, (vec, t) in enumerate(zip(vectors, timestamps)):
        if t < last:
            raise ValueError(f"timestamps must be non-decreasing: {t} < {last}")
        last = t
        yield StreamItem(uid=uid, t=float(t), vec=unit_normalize(vec))

"""repro_torch.core — the paper's contribution: streaming similarity self-join.

Public surface:

  * :func:`make_joiner` — build any (framework × index) combination from the
    paper: frameworks ``{"MB", "STR"}`` × indexes ``{"INV", "AP", "L2AP", "L2"}``
    (STR-AP is excluded, as in the paper).
  * :func:`join_stream` — run a joiner over an iterable of stream items.
  * The faithful building blocks (:class:`InvIndex`, :class:`L2FamilyIndex`,
    :class:`MiniBatchJoiner`, :class:`StreamingJoiner`) and the oracle
    (:func:`brute_force_join`).
  * The device engine lives in :mod:`repro_torch.core.blocked` and
    :mod:`repro_torch.core.distributed`.

The joiners are host code (Python and numpy over sorted sparse vectors),
copied from ``repro.core`` with the same arithmetic in the same order, so
that their pairs, float64 scores and counters equal the reference's.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from .counters import Counters
from .index_inv import InvIndex
from .index_l2 import L2FamilyIndex
from .minibatch import MiniBatchJoiner, apply_decay
from .similarity import (
    brute_force_join,
    decay_lambda_for,
    decayed_similarity,
    time_horizon,
)
from .streaming import StreamingJoiner
from .types import (
    Pair,
    SparseVector,
    StreamItem,
    as_stream,
    make_sparse,
    sparse_dot,
    sparse_from_dense,
    unit_normalize,
)

__all__ = [
    "Counters",
    "InvIndex",
    "L2FamilyIndex",
    "MiniBatchJoiner",
    "StreamingJoiner",
    "Pair",
    "SparseVector",
    "StreamItem",
    "as_stream",
    "make_sparse",
    "sparse_dot",
    "sparse_from_dense",
    "unit_normalize",
    "apply_decay",
    "brute_force_join",
    "decayed_similarity",
    "decay_lambda_for",
    "time_horizon",
    "make_index",
    "make_joiner",
    "join_stream",
    "INDEX_NAMES",
    "FRAMEWORK_NAMES",
]

INDEX_NAMES = ("INV", "AP", "L2AP", "L2")
FRAMEWORK_NAMES = ("MB", "STR")


def make_index(
    name: str,
    theta: float,
    lam: float = 0.0,
    *,
    streaming: bool = False,
    counters: Optional[Counters] = None,
):
    name = name.upper()
    if name == "INV":
        return InvIndex(theta, lam, streaming=streaming, counters=counters)
    flags = {"AP": (True, False), "L2AP": (True, True), "L2": (False, True)}
    if name not in flags:
        raise ValueError(f"unknown index {name!r}; choose from {INDEX_NAMES}")
    use_ap, use_l2 = flags[name]
    return L2FamilyIndex(
        theta, lam, use_ap=use_ap, use_l2=use_l2, streaming=streaming, counters=counters
    )


def make_joiner(
    framework: str,
    index: str,
    theta: float,
    lam: float,
    counters: Optional[Counters] = None,
):
    """Build e.g. ``make_joiner("STR", "L2", theta=0.9, lam=0.01)``."""
    framework = framework.upper()
    if framework == "MB":
        return MiniBatchJoiner(
            lambda: make_index(index, theta, 0.0, streaming=False),
            theta,
            lam,
            counters=counters,
        )
    if framework == "STR":
        idx = make_index(index, theta, lam, streaming=True)
        return StreamingJoiner(idx, counters=counters)
    raise ValueError(f"unknown framework {framework!r}; choose from {FRAMEWORK_NAMES}")


def join_stream(joiner, items: Iterable[StreamItem]) -> List[Pair]:
    out: List[Pair] = []
    for item in items:
        out.extend(joiner.push(item))
    out.extend(joiner.finish())
    return out

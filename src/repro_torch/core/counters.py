"""Instrumentation counters matching the paper's evaluation metrics.

The paper compares algorithms on (i) wall time, (ii) posting entries
traversed during candidate generation (Fig. 2/6), (iii) candidates
generated, and (iv) full similarities computed.  Every index and framework
in :mod:`repro_torch.core` updates one of these counter sets so the benchmark
harness can reproduce the paper's figures.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Counters"]


@dataclasses.dataclass
class Counters:
    items_processed: int = 0
    entries_traversed: int = 0      # posting entries examined in CG
    candidates_generated: int = 0   # distinct candidates reaching CV
    full_sims_computed: int = 0     # residual dot products evaluated
    pairs_emitted: int = 0
    entries_indexed: int = 0        # posting entries ever appended
    entries_pruned: int = 0         # posting entries dropped by time filtering
    reindex_ops: int = 0            # vectors re-scanned due to m updates (AP/L2AP)
    reindex_entries: int = 0        # posting entries appended by re-indexing
    index_rebuilds: int = 0         # MB: number of index (re)constructions
    peak_index_entries: int = 0
    peak_window_items: int = 0

    def merge(self, other: "Counters") -> "Counters":
        out = Counters()
        for f in dataclasses.fields(Counters):
            name = f.name
            if name.startswith("peak_"):
                setattr(out, name, max(getattr(self, name), getattr(other, name)))
            else:
                setattr(out, name, getattr(self, name) + getattr(other, name))
        return out

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

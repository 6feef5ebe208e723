"""Logical-axis rules: named axes → mesh axes.

Counterpart of ``repro.distributed.sharding``'s rule table.  Code names
its axes logically (``"window"``, ``"batch"``, ``"heads"``, ...); an
:class:`AxisRules` table maps each logical name to a mesh axis or a tuple
of them.  The sharded engine resolves ``"window"`` through it
(:func:`repro_torch.engine.sharded.window_axis`).  The reference's
``constrain``, ``resolve_pspec``, ``param_shardings`` and ``use_rules``
serve its model stack and come with it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

__all__ = ["AxisRules", "DEFAULT_RULES", "MeshAxes"]

MeshAxes = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical-name → mesh axis (or tuple of axes) table."""

    table: Dict[str, MeshAxes]

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.table.get(logical)

    def override(self, **kw: MeshAxes) -> "AxisRules":
        t = dict(self.table)
        t.update(kw)
        return AxisRules(t)


# the reference's table: "batch" spans pod×data so the same rules serve a
# one-pod and a two-pod mesh (axes a mesh lacks are dropped when resolved)
DEFAULT_RULES = AxisRules(
    table={
        "batch": ("pod", "data"),
        "seq": None,
        "kv_seq": None,
        "d_model": None,
        "ff": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "vocab": ("model",),
        "experts": ("model",),
        "expert_ff": None,
        "fsdp": ("data",),
        "layers": None,
        "state": None,
        "window": ("data",),     # the ring window's shards (engine/sharded.py)
    },
)

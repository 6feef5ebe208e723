"""Device meshes for the sharded engine, in one process.

Counterpart of ``repro.launch.mesh``'s :func:`make_mesh_for`.  JAX's
``shard_map`` is single-controller: one Python process drives every
device of the mesh.  The port keeps that shape: a :class:`Mesh` is a grid
of ``torch.device`` objects with axis names, and the sharded engine runs
one host loop over the devices along its window axis.  No process group
is created.

A device may appear more than once: several shards then share one card
(or the CPU, as the tests run them), each with tensors of its own.  The
reference's ``make_production_mesh`` is a TPU-pod topology and comes with
the training stack.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, canonical_device

__all__ = ["Mesh", "make_mesh_for"]


class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    ``torch.device`` of shape ``shape``, one name per axis.  All devices
    are of one type (all CUDA or all CPU)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {devices.shape} needs {devices.ndim} axis "
                f"names, got {axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"mesh devices must be of one type, got {sorted(kinds)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        shards of a tensor sharded over ``axis`` and replicated over the
        rest (the single-process engine runs one replica)."""
        i = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, i, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh_for(shape, axes, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over the first ``prod(shape)`` devices.

    With ``devices=None`` these are the visible CUDA devices, and too few
    raise, as the reference raises.  An explicit ``devices`` list may
    repeat a device (``["cpu"] * 4``, or ``[f"cuda:{i % n}" ...]`` to lay
    more shards than cards over the cards)."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"need {n} CUDA devices for mesh {dict(zip(axes, shape))}, "
                f"have {have}; pass devices= to place several shards on one "
                f"device"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [canonical_device(d) for d in devices]
        if len(devs) < n:
            raise ValueError(
                f"need {n} devices for mesh {dict(zip(axes, shape))}, "
                f"got {len(devs)}"
            )
        devs = devs[:n]
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{d} is not a visible CUDA device")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes)

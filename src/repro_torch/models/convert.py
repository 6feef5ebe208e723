"""Parameters across the two packages: numpy trees in, numpy trees out.

The repo holds no pretrained weights, and the reference's RNG and
``torch.Generator`` never draw the same numbers, so the port is held to
the reference with the same parameters carried across: the reference's
``init_lm`` pytree, its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``), becomes the port's params on a device with
:func:`params_from_numpy`, and :func:`params_to_numpy` goes back.  Both
trees are nested dicts and lists with the same keys and leaf shapes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of numpy arrays as the port's params on ``device`` (``None``
    = CUDA); leaves keep their dtype (the reference's are float32)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(params: Any) -> Any:
    """The port's params as a tree of numpy arrays on the host."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()

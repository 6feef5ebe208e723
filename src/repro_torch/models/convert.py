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

from typing import Any, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .attention import AttnCache
from .ssm import SSMCache
from .xlstm import MLSTMCache, SLSTMCache

__all__ = ["params_from_numpy", "params_to_numpy", "caches_from_numpy",
           "caches_to_numpy"]


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """One numpy leaf as a tensor on ``dev``.  numpy has no bf16 of its
    own: a 2-byte ``bfloat16`` leaf (the reference's default cache dtype,
    an extension dtype) crosses as its bits."""
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16" and x.dtype.itemsize == 2:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(x).to(dev)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of numpy arrays as the port's params on ``device`` (``None``
    = CUDA); leaves keep their dtype (the reference's are float32)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _tensor(x, dev)

    return conv(tree)


def params_to_numpy(params: Any) -> Any:
    """The port's params as a tree of numpy arrays on the host."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


# a hybrid or xLSTM group's caches, by their key in the group's dict
_GROUP_CACHES = {"mamba": SSMCache, "attn": AttnCache, "mlstm": MLSTMCache,
                 "slstm": SLSTMCache}


def caches_from_numpy(caches: Any, device: DeviceLike = None) -> List[Any]:
    """The reference's ``init_lm_caches`` list with numpy leaves as the
    port's caches on ``device`` (``None`` = CUDA), in their dtype (bf16
    too): an attention group's ``(k, v)`` pair becomes an ``AttnCache``,
    a hybrid group's ``{"mamba": …, "attn": …}`` an ``SSMCache`` and an
    ``AttnCache``, an xLSTM group's ``{"mlstm": …, "slstm": …}`` an
    ``MLSTMCache`` and an ``SLSTMCache`` (fields in the reference's
    order)."""
    dev = resolve_device(device)

    def conv(c, kind=AttnCache):
        if isinstance(c, dict):
            return {k: conv(v, _GROUP_CACHES[k]) for k, v in c.items()}
        return kind(*(_tensor(x, dev) for x in c))

    return [conv(c) for c in caches]


def caches_to_numpy(caches: List[Any]) -> List[Any]:
    """The port's caches, each a cache of numpy arrays on the host in the
    same structure; bf16 leaves come back as float32, which holds them
    exactly."""
    def leaf(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    def conv(c):
        if isinstance(c, dict):
            return {k: conv(v) for k, v in c.items()}
        return type(c)(*(leaf(x) for x in c))

    return [conv(c) for c in caches]

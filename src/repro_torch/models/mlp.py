"""SwiGLU MLP (llama/qwen convention: gate ⊙ silu, no biases).

Counterpart of ``repro.models.mlp``.  The reference pins its hidden
activation's sharding with ``constrain``, a no-op without a device mesh;
the port serves on one card and does not call it.
"""

from __future__ import annotations

import torch

from .common import Initializer, dense_init, silu

__all__ = ["init_mlp", "mlp"]


def init_mlp(init: Initializer, d_model: int, d_ff: int):
    return {
        "w_gate": dense_init(init, (d_model, d_ff)),
        "w_up": dense_init(init, (d_model, d_ff)),
        "w_down": dense_init(init, (d_ff, d_model)),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (silu(g) * u) @ params["w_down"].to(dt)

"""Shared model components: norms, RoPE, initializers.

Counterpart of ``repro.models.common``, with its conventions:

  * ``init_<thing>(init, ...) -> params`` — a nested dict of tensors,
    mirroring the reference's pytree leaf for leaf;
  * ``<thing>(params, x, ...)`` — a plain function on tensors.

All parameters are made in float32; the forward pass casts them to the
compute dtype at each use, as the reference does.  The reference's
logical sharding specs are not ported: serving runs on one card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device

__all__ = [
    "Initializer",
    "dense_init",
    "embed_init",
    "rms_norm",
    "silu",
    "init_rms_norm",
    "rope_angles",
    "apply_rope",
]


class Initializer:
    """The source of random parameters: a ``torch.Generator`` on
    ``device``, from which every init draws in turn (the reference splits
    a key per draw).  ``generator=None`` seeds one with 0; on the
    ``"meta"`` device no generator is needed and the draws only carry
    shapes (:func:`repro_torch.models.lm.param_count`)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> None:
        if device is not None and torch.device(device).type == "meta":
            self.device, self.generator = torch.device("meta"), None
            return
        if device is None and generator is not None:
            device = generator.device
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(
                f"the generator lies on {generator.device}, the parameters "
                f"on {self.device}"
            )
        self.generator = generator

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)


def dense_init(init: Initializer, shape, in_axis: int = 0) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by fan-in (LeCun/TN init), drawn
    by the inverse CDF as the reference's ``truncated_normal`` is."""
    std = shape[in_axis] ** -0.5
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = lo + init.uniform(shape) * (hi - lo)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return std * x.clamp(-2.0, 2.0)


def embed_init(init: Initializer, shape, std: float = 0.02) -> torch.Tensor:
    return std * init.normal(shape)


def init_rms_norm(d: int, device: DeviceLike = None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x · (1 / (1 +
    exp(−x)))``, each step rounded to ``x``'s dtype.  ``F.silu`` rounds
    once, which in bf16 moves 39 % of the outputs by an ulp; in f32 the
    two agree to an ulp, and f32 runs ``F.silu``."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings.  positions: (..., S)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs           # (..., S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs ``(x[..., :d/2], x[..., d/2:])`` — the llama layout.

    x: (..., S, H, dim); cos/sin: (..., S, dim/2) broadcast over heads.
    """
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)

"""Architecture registry: the 10 assigned configs + shape cells.

A copy of ``repro.configs``: the configurations are data, shared with the
reference so that a name means the same network in both packages.

``get_config(arch_id)`` returns the full-size :class:`ModelConfig`;
``get_config(arch_id).reduced()`` the CPU-smoke variant.  ``cells()``
enumerates the (arch × shape) dry-run grid, applying the assignment's skip
rules (``long_500k`` only for sub-quadratic families).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .base import (  # noqa: F401
    HybridConfig, MLAConfig, ModelConfig, MoEConfig, SHAPES, ShapeConfig,
    SSMConfig, XLSTMConfig,
)
from .qwen3_0_6b import CONFIG as _qwen3_0_6b
from .deepseek_coder_33b import CONFIG as _deepseek_coder_33b
from .qwen2_5_3b import CONFIG as _qwen2_5_3b
from .codeqwen1_5_7b import CONFIG as _codeqwen1_5_7b
from .chameleon_34b import CONFIG as _chameleon_34b
from .zamba2_2_7b import CONFIG as _zamba2_2_7b
from .musicgen_medium import CONFIG as _musicgen_medium
from .xlstm_350m import CONFIG as _xlstm_350m
from .deepseek_v3_671b import CONFIG as _deepseek_v3_671b
from .olmoe_1b_7b import CONFIG as _olmoe_1b_7b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _qwen3_0_6b,
        _deepseek_coder_33b,
        _qwen2_5_3b,
        _codeqwen1_5_7b,
        _chameleon_34b,
        _zamba2_2_7b,
        _musicgen_medium,
        _xlstm_350m,
        _deepseek_v3_671b,
        _olmoe_1b_7b,
    )
}

__all__ = [
    "ARCHS", "SHAPES", "get_config", "cells", "cell_enabled",
    "ModelConfig", "ShapeConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "HybridConfig", "XLSTMConfig",
]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]


def cell_enabled(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Apply the assignment's skip rules.  Returns (enabled, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    return True, ""


def cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All 40 (arch × shape) cells with their enabled/skip status."""
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = cell_enabled(cfg, shape)
            yield cfg, shape, ok, why

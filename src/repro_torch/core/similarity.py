"""Time-filtering horizon (paper §3); a copy of ``repro.core.similarity``'s
:func:`time_horizon`, kept here so the port imports nothing of ``repro``."""

from __future__ import annotations

import math

__all__ = ["time_horizon"]


def time_horizon(theta: float, lam: float) -> float:
    """``τ = λ⁻¹ log θ⁻¹`` — pairs further apart in time cannot be similar.

    Follows from ``dot(x, y) ≤ 1`` for unit vectors:
    ``sim_Δt ≤ exp(-λ Δt) < θ  ⟺  Δt > λ⁻¹ log θ⁻¹``.
    """
    if not 0.0 < theta <= 1.0:
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    if lam < 0.0:
        raise ValueError(f"lambda must be >= 0, got {lam}")
    if lam == 0.0:
        return math.inf
    return math.log(1.0 / theta) / lam

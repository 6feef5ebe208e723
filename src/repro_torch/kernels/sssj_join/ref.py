"""Dense PyTorch oracle for the blocked time-decayed join."""

from __future__ import annotations

from typing import Optional

import torch

from ..._device import ieee_f32

__all__ = ["sssj_join_ref"]


def sssj_join_ref(
    q, w, tq, tw, uq, uw, *, theta: float, lam: float,
    sq: Optional[torch.Tensor] = None,
    sw: Optional[torch.Tensor] = None,
    theta_q: Optional[torch.Tensor] = None,
    lam_q: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense reference: thresholded decayed scores with uid-order masking.

    ``q (Q, d)``, ``w (W, d)``, timestamps ``(·, 1)`` float, uids ``(·, 1)``
    int (negative = empty slot).  Returns the ``(Q, W)`` f32 matrix
    ``dot·exp(-λΔt)`` where that value is ≥ θ and ``uid_q > uid_w ≥ 0``,
    else 0.  Optional lanes: stream ids ``sq/sw (·, 1)`` (cross-stream
    pairs never emit) and per-query-row ``theta_q/lam_q (Q, 1)``.
    """
    with ieee_f32(q.device):
        sims = q.float() @ w.float().T
    dt = (tq.float() - tw.float().T).abs()
    lam_eff = lam if lam_q is None else lam_q.float()
    dec = sims * torch.exp(-lam_eff * dt)
    order = (uw.T >= 0) & (uq > uw.T)
    if sq is not None:
        order &= sq.int() == sw.int().T
    dec = torch.where(order, dec, 0.0)
    thr = theta if theta_q is None else theta_q.float()
    return torch.where(dec >= thr, dec, 0.0).float()

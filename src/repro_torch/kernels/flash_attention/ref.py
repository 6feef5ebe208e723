"""Naive attention: the oracle of the flash attention path.

Counterpart of ``repro.kernels.flash_attention.ref``.
"""

from __future__ import annotations

import torch

from ..._device import ieee_f32

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, sm_scale: float, causal: bool) -> torch.Tensor:
    """Naive GQA attention in f32.  q: (B, H, Sq, Dh); k, v: (B, Hkv, Sk,
    Dh).  Query head ``h`` reads kv head ``h // (H // Hkv)``; the causal
    mask puts -1e30 where ``col > row``; the output is cast to ``q.dtype``."""
    H, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    with ieee_f32(q.device):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * sm_scale
        if causal:
            rows = torch.arange(Sq, device=q.device)[:, None]
            cols = torch.arange(Sk, device=q.device)[None, :]
            s = torch.where(rows >= cols, s, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)

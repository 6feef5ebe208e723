"""Public wrapper of flash attention (forward only, prefill).

Counterpart of ``repro.kernels.flash_attention.ops``, with its rules: GQA
needs ``H % Hkv == 0``; causal attention is self-attention (``Sq ==
Sk``); ``sm_scale`` defaults to ``Dh ** -0.5``; sequence lengths are
padded to block multiples, the blocks being ``min(block, round_up(S,
8))``; a non-causal input whose kv needs padding takes the naive
reference, as the reference's wrapper routes it; the output is sliced to
``Sq`` and keeps ``q``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..._device import DeviceLike, resolve_device
from .kernel import flash_attention_kernel_call
from .ref import attention_ref

__all__ = ["flash_attention"]


def _round_up(n: int, mult: int = 8) -> int:
    return ((n + mult - 1) // mult) * mult


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def flash_attention(
    q,
    k,
    v,
    *,
    sm_scale: Optional[float] = None,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    use_ref: bool = False,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Causal flash attention.  q: (B, H, Sq, Dh); k, v: (B, Hkv, Sk, Dh).

    Inputs (arrays or tensors) are moved to ``device`` (``None`` = CUDA,
    raising without a GPU; ``"cpu"`` runs the kernel's plain version).
    ``use_ref`` routes through :func:`~.ref.attention_ref`.
    """
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if causal and Sq != Sk:
        raise ValueError("causal path expects self-attention (Sq == Sk)")
    scale = sm_scale if sm_scale is not None else Dh ** -0.5
    if use_ref:
        return attention_ref(q, k, v, sm_scale=scale, causal=causal)

    bq = min(block_q, _round_up(Sq))
    bk = min(block_k, _round_up(Sk))
    pq, pk = (-Sq) % bq, (-Sk) % bk
    if not causal and pk:
        # zero-padded keys would take softmax weight without a causal mask
        return attention_ref(q, k, v, sm_scale=scale, causal=causal)
    out = flash_attention_kernel_call(
        _pad_seq(q, pq).contiguous(), _pad_seq(k, pk).contiguous(),
        _pad_seq(v, pk).contiguous(),
        sm_scale=scale, causal=causal, block_q=bq, block_k=bk,
    )
    return out[:, :, :Sq, :]

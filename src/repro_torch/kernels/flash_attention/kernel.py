"""Causal flash attention: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.flash_attention.kernel``, whose TPU kernel
``_kernel`` runs forward-only GQA attention over a grid ``(B, H, n_q,
n_kv)`` with the kv axis innermost, carrying the online-softmax state
(running max ``m``, normaliser ``l``, accumulator ``acc``) from one kv
block to the next:

  * ``s = (q · sm_scale) · kᵀ`` in f32; a kv block wholly in the causal
    future of the q block (``ik·bk > iq·bq + bq − 1``) is skipped, and
    ``col > row`` is masked to −1e30;
  * ``m' = max(m, rowmax s)``, ``α = exp(m − m')``, ``p = exp(s − m')``,
    ``l = l·α + Σp``, ``acc = acc·α + p·v``;
  * ``out = acc / l`` (``l == 0`` taken as 1), in ``q``'s dtype.

:func:`flash_attention_kernel_call` runs it: on a CUDA tensor it launches
``csrc/flash_attn.cu`` (whose header says what bounds it on an H100 and
how the design answers that: bf16 tensor cores with f32 accumulation for
bf16; 3xTF32 on the tensor cores for f32 at head dims up to 128, the
CUDA cores above that, as :func:`kernel_route` picks) or raises; on a
CPU tensor it runs :func:`flash_attention_plain`, the same online
softmax in PyTorch, which is also the kernel's oracle on the card.  The kernel is compiled for the
head dims :data:`KERNEL_HEAD_DIMS`; the wrapper pads any other head dim up
to the next of them with zero columns (``q·k`` does not change, and the
extra output columns are sliced off).  A head dim above 256 is padded to
a multiple of :data:`SLICE` and runs in :func:`column_slices` of that many
output columns, one launch each over the whole ``q·kᵀ``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..._device import ieee_f32
from .._build import load

__all__ = [
    "KERNEL_HEAD_DIMS",
    "ROUTES",
    "SLICE",
    "TF32_HEAD_DIMS",
    "TF32_KV_TILE",
    "column_slices",
    "flash_attention_kernel_call",
    "flash_attention_plain",
    "kernel_head_dim",
    "kernel_route",
    "tf32_workspace",
]

NEG_INF = -1e30  # the masked score and the running max's start, as the reference's
KERNEL_HEAD_DIMS = (32, 64, 128, 256)  # the head dims the CUDA kernel is compiled for
SLICE = 128   # output columns per launch above the largest of them
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the kernels of csrc/flash_attn.cu, by the code its launcher takes
ROUTES = {"f32_cuda_cores": 0, "bf16_wgmma": 1, "f32_3xtf32": 2}
TF32_HEAD_DIMS = (32, 64, 128)   # the f32 widths on the tensor cores
TF32_KV_TILE = 64   # the 3xTF32 kernel's kv tile (csrc x3::BN)


def kernel_route(dtype: torch.dtype, dqk: int, dv: int) -> str:
    """The kernel of one launch over q and k ``dqk`` wide and v ``dv``
    wide (kernel widths, after padding and slicing): bf16 on the tensor
    cores (``"bf16_wgmma"``); f32 as 3xTF32 on the tensor cores
    (``"f32_3xtf32"``) at the whole widths :data:`TF32_HEAD_DIMS`, and on
    the CUDA cores (``"f32_cuda_cores"``) at 256 and in column slices."""
    if dtype == torch.bfloat16:
        return "bf16_wgmma"
    return "f32_3xtf32" if dqk == dv and dv in TF32_HEAD_DIMS else "f32_cuda_cores"


def kernel_head_dim(dh: int) -> int:
    """The zero-padded width that runs head dim ``dh``: the smallest of
    :data:`KERNEL_HEAD_DIMS` that holds it, or above the largest the next
    multiple of :data:`SLICE` (run in column slices of that width)."""
    for width in KERNEL_HEAD_DIMS:
        if dh <= width:
            return width
    return -(-dh // SLICE) * SLICE


def tf32_workspace(B: int, Hkv: int, Sk: int, dh: int) -> int:
    """Floats of the 3xTF32 route's workspace: k and v split once into
    TF32 hi and lo parts for every query block that reads them, four parts
    of ``(B, Hkv, Sp, dh)`` (k's, and v's transposed, tile by tile), ``Sp``
    = ``Sk`` rounded up to :data:`TF32_KV_TILE`."""
    sp = -(-Sk // TF32_KV_TILE) * TF32_KV_TILE
    return 4 * B * Hkv * sp * dh


def column_slices(fn: Callable, q, k, v, width: int) -> torch.Tensor:
    """``fn(q, k, v)`` computed ``width`` output columns at a time: each
    slice ``fn(q, k, v[..., c:c + width])`` sees the whole ``q·kᵀ`` (so the
    same softmax) and gives those columns of the output."""
    outs = [fn(q, k, v[..., c:c + width]) for c in range(0, v.shape[-1], width)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool,
                          block_q: int, block_k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature and output as
    :func:`flash_attention_kernel_call`): the TPU kernel's online softmax
    over kv blocks, in f32.  For each kv block only the q blocks it does
    not skip are updated (rows from ``(ik·bk // bq)·bq`` on when causal).
    ``v`` may be narrower than ``q`` and ``k`` (a column slice): the output
    has ``v``'s width."""
    B, H, Sq, _ = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    group = H // Hkv
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    qs = q.float() * sm_scale
    m = torch.full((B, H, Sq, 1), NEG_INF, **f32)
    l = torch.zeros((B, H, Sq, 1), **f32)
    acc = torch.zeros((B, H, Sq, Dv), **f32)
    rows = torch.arange(Sq, device=dev)[:, None]
    with ieee_f32(dev):
        for c0 in range(0, Sk, block_k):
            r0 = (c0 // block_q) * block_q if causal else 0
            kb = k[:, :, c0:c0 + block_k].float().repeat_interleave(group, dim=1)
            vb = v[:, :, c0:c0 + block_k].float().repeat_interleave(group, dim=1)
            s = qs[:, :, r0:] @ kb.transpose(-1, -2)
            if causal:
                cols = c0 + torch.arange(block_k, device=dev)[None, :]
                s = torch.where(rows[r0:] >= cols, s, NEG_INF)
            m_prev = m[:, :, r0:]
            m_cur = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m_prev - m_cur)
            p = torch.exp(s - m_cur)
            l[:, :, r0:] = l[:, :, r0:] * alpha + p.sum(dim=-1, keepdim=True)
            acc[:, :, r0:] = acc[:, :, r0:] * alpha + p @ vb
            m[:, :, r0:] = m_cur
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l).to(q.dtype)


@functools.cache
def _launcher():
    fn = load("flash_attn").flash_attn_launch
    p = ctypes.c_void_p
    fn.argtypes = [p] * 5 + [ctypes.c_long] + [ctypes.c_int] * 9 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention needs q (B, H, Sq, Dh), k and v (B, Hkv, Sk, "
            f"Dh); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Sq, Dh = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != Dh or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"pair: batch and head dim must agree, H % Hkv == 0")
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"sequence lengths ({Sq}, {Sk}) must be padded to "
                         f"block multiples ({block_q}, {block_k})")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise ValueError(f"q, k, v must share one float dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_kernel_call(
    q: torch.Tensor,   # (B, H, Sq, Dh)
    k: torch.Tensor,   # (B, Hkv, Sk, Dh)
    v: torch.Tensor,   # (B, Hkv, Sk, Dh)
    *,
    sm_scale: float,
    causal: bool,
    block_q: int,
    block_k: int,
) -> torch.Tensor:
    """Flash attention over inputs padded to block multiples; returns
    ``(B, H, Sq, Dh)`` in ``q.dtype``.  ``block_q``/``block_k`` set the
    plain version's blocks; the kernel tiles by its own (64 × 64) and masks
    its ragged edge, so they change only the order of summation."""
    _check(q, k, v, block_q, block_k)
    Dh = q.shape[-1]
    width = kernel_head_dim(Dh)
    if width != Dh:   # zero columns: q·k unchanged, extra outputs sliced off
        pad = (0, width - Dh)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    per_launch = width if width in KERNEL_HEAD_DIMS else SLICE
    if q.device.type == "cpu":
        out = column_slices(
            lambda q, k, vs: flash_attention_plain(
                q, k, vs, sm_scale=sm_scale, causal=causal, block_q=block_q,
                block_k=block_k),
            q, k, v, per_launch)
        return out[..., :Dh]
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the flash-attention kernel takes f32 or bf16, got {q.dtype}")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError(f"q, k, v must all lie on {q.device}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("the flash-attention kernel takes contiguous q, k, v")
    return column_slices(
        lambda q, k, vs: _launch(q, k, vs.contiguous(), sm_scale, causal),
        q, k, v, per_launch)[..., :Dh]


def _launch(q, k, v, sm_scale: float, causal: bool) -> torch.Tensor:
    """One launch of the kernel: the output columns of ``v``'s width."""
    B, H, Sq, Dqk = q.shape
    Hkv, Sk, Dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    route = kernel_route(q.dtype, Dqk, Dv)
    n_ws = tf32_workspace(B, Hkv, Sk, Dv) if route == "f32_3xtf32" else 0
    ws = torch.empty((n_ws,), dtype=torch.float32, device=q.device)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), n_ws,
        B, H, Hkv, Sq, Sk, Dqk, Dv, int(causal), ROUTES[route],
        sm_scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    flash_attention_kernel_call.launches += 1
    return out


flash_attention_kernel_call.launches = 0

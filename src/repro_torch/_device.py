"""Device selection and f32 matmul precision for the port.

Entry points take ``device=None`` meaning ``"cuda"``: with no GPU they
raise instead of carrying on silently on the CPU.  Pass ``device="cpu"``
to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["canonical_device", "ieee_f32", "resolve_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def canonical_device(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device` with a CUDA device's index filled in (the
    current card for a bare ``"cuda"``), so that equal devices compare
    equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def ieee_f32(device: torch.device):
    """Full-f32 matmuls on the card: TF32 moves scores by ~1e-3, which
    moves pairs across θ.  Both flags are set explicitly and restored."""
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

"""LM-backed document embedder for the SSSJ service.

Counterpart of ``repro.serving.embedder``.  An architecture's final-layer
hidden states are mean-pooled over non-pad positions and ℓ2-normalized:
unit vectors, the join's input.

:func:`pooled_unit_embed` is that mapping, once: :class:`LMEmbedder`
calls it on the host's request batches, and the multi-tenant runtime's
fused embed→join (:class:`repro_torch.runtime.FusedEmbedder`) calls it on
each micro-batch inside the step.  The reference traces one function
into both programs and gets bit-identical embeddings; here the two run
the same code on batches of different sizes, whose products the card may
order differently, so the two agree to a tolerance that the callers
measure.  MoE archs run the reference's capacity dispatch (no
``moe_dropless``, as in the reference), so a document's embedding also
depends on the other documents of its batch, through the drops.  The
xLSTM arch (xlstm-350m) and the Mamba2 hybrid (zamba2-2.7b) run their
recurrent blocks from their initial states over each document's tokens,
pad positions included, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..models.common import Initializer
from ..models.lm import init_lm, lm_forward

__all__ = ["LMEmbedder", "pooled_unit_embed"]


def pooled_unit_embed(params, cfg: ModelConfig, tokens: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tokens ``(B, S)`` → unit embeddings ``(B, d_model)`` f32.

    Mean-pools the final hidden states over non-pad (``token != 0``)
    positions, then ℓ2-normalizes.  Row-wise: an all-pad row embeds to
    the zero vector, which no cosine threshold admits.
    """
    if mask is None:
        mask = tokens != 0
    _, _, _, hidden = lm_forward(params, cfg, tokens=tokens, return_hidden=True,
                                 compute_dtype=torch.float32)
    m = mask.float()[..., None]
    pooled = (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)


class LMEmbedder:
    """Host-side embedder: numpy tokens ``(B, S)`` in, numpy unit vectors
    ``(B, d_model)`` out, the LM on ``device`` (``None`` = CUDA).
    ``params=None`` draws them with :func:`repro_torch.models.init_lm`
    from ``generator`` (``None``: one seeded with 0)."""

    def __init__(self, cfg: ModelConfig, params=None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_lm(Initializer(generator, self.device), cfg)
        self.params = params

    def __call__(self, tokens: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
        toks = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        m = None if mask is None else torch.from_numpy(np.asarray(mask, bool)).to(self.device)
        return pooled_unit_embed(self.params, self.cfg, toks, m).cpu().numpy()

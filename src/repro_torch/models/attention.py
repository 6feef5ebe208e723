"""GQA attention with RoPE and optional qk-norm / qkv-bias: the prefill path.

Counterpart of ``repro.models.attention`` without its KV cache (the
decode path is not ported yet).  Layouts are the reference's:

  activations  x:      (B, S, D)
  query        q:      (B, S, H, hd)
  keys/values  k, v:   (B, S, KV, hd)

Up to ``_FULL_ATTN_MAX_SEQ`` tokens :func:`attention` is the dense masked
softmax over ``(B, S, KV, G, S)`` scores, as the reference's.  Above it
the reference runs :func:`chunked_causal_attention`, an online softmax
over chunk pairs in plain JAX; the port runs the same function through
the flash-attention kernel (:func:`repro_torch.kernels.flash_attention
.flash_attention`, ``csrc/flash_attn.cu`` on a CUDA tensor, its plain
version on a CPU one) when the positions are ``arange(S)``, the case the
kernel's causal mask assumes, and keeps :func:`chunked_causal_attention`
for explicit positions.  The reference pins activation shardings with
``constrain``, a no-op without a device mesh; the port does not call it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .common import Initializer, apply_rope, dense_init, rms_norm, rope_angles

__all__ = ["init_attention", "attention", "chunked_causal_attention"]

_NEG_INF = -1e30

# sequences longer than this leave the dense softmax
_FULL_ATTN_MAX_SEQ = 1024


def init_attention(init: Initializer, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    params = {
        "wq": dense_init(init, (d, h, hd)),
        "wk": dense_init(init, (d, kv, hd)),
        "wv": dense_init(init, (d, kv, hd)),
        "wo": dense_init(init, (h, hd, d), in_axis=0),
    }
    zeros = dict(dtype=torch.float32, device=init.device)
    if cfg.qkv_bias:
        params["bq"] = torch.zeros((h, hd), **zeros)
        params["bk"] = torch.zeros((kv, hd), **zeros)
        params["bv"] = torch.zeros((kv, hd), **zeros)
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), **zeros)
        params["k_norm"] = torch.ones((hd,), **zeros)
    return params


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    hd = cfg.resolved_head_dim
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,M,KV,hd) → logits (B,S,KV,G,M) in f32 (the
    products of the storage dtype, summed in f32)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    return torch.einsum("bskgh,bmkh->bskgm", qg.float(), k.float()) * scale


def _gqa_out(p: torch.Tensor, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """p: (B,S,KV,G,M) f32, v: (B,M,KV,hd) → (B,S,H,hd)."""
    out = torch.einsum("bskgm,bmkh->bskgh", p.to(v.dtype).float(), v.float())
    B, S, KV, G, hd = out.shape
    return out.reshape(B, S, KV * G, hd).to(dtype)


def chunked_causal_attention(
    q: torch.Tensor,             # (B, S, H, hd)
    k: torch.Tensor,             # (B, M, KV, hd)
    v: torch.Tensor,             # (B, M, KV, hd)
    q_positions: torch.Tensor,   # (B, S) — unused, as in the reference
    kv_positions: torch.Tensor,  # (M,) — unused, as in the reference
    scale: float,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax causal self-attention over the lower triangle of
    (query chunk, kv chunk) pairs, in f32: the reference's function, its
    flat scan over chunk pairs a host loop here.  The causal mask is built
    from chunk indices (only the diagonal block masks anything); the
    positions enter only through RoPE, before this call."""
    B, S, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    G = H // KV
    while S % q_chunk:
        q_chunk //= 2
    while M % kv_chunk:
        kv_chunk //= 2
    nq, nk = S // q_chunk, M // kv_chunk
    if nq != nk or S != M:
        raise ValueError("the chunked path is self-attention only")
    dev = q.device
    qg = q.reshape(B, S, KV, G, hd).float()
    iq = torch.arange(q_chunk, device=dev)[:, None]
    ik = torch.arange(kv_chunk, device=dev)[None, :]
    out = []
    for i in range(nq):
        qb = qg[:, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, q_chunk, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, q_chunk, KV, G, hd), dtype=torch.float32, device=dev)
        for j in range(i + 1):
            kk = k[:, j * kv_chunk:(j + 1) * kv_chunk].float()
            vv = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqkgh,bckh->bqkgc", qb, kk) * scale
            mask = ((j * kv_chunk + ik) <= (i * q_chunk + iq))[None, :, None, None, :]
            s = torch.where(mask, s, _NEG_INF)
            m_cur = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_cur)
            p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p.to(vv.dtype).float(), vv.float())
            m = m_cur
        out.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(out, 1).reshape(B, S, H, hd)


def attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache=None,
    cache_len=None,
    *,
    positions_are_arange: bool = False,
) -> Tuple[torch.Tensor, Optional[object]]:
    """Causal self-attention over ``x`` itself (prefill); returns ``(y,
    None)``.  ``positions_are_arange`` says, without a device read, that
    ``positions`` is ``arange(S)`` on every row (the caller built them):
    above ``_FULL_ATTN_MAX_SEQ`` tokens that sends the attention to the
    flash kernel."""
    if cache is not None:
        raise NotImplementedError(
            "the decode path (attention with a KV cache) is not ported yet "
            "(ROADMAP queue 1, item 9b)"
        )
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = _project_qkv(params, cfg, x, positions)
    B, S, H, _ = q.shape
    if S <= _FULL_ATTN_MAX_SEQ:
        s = _gqa_scores(q, k, scale)                            # (B,S,KV,G,S)
        mask = (positions[:, None, :] <= positions[:, :, None])[:, :, None, None, :]
        p = torch.softmax(torch.where(mask, s, _NEG_INF), -1)
        out = _gqa_out(p, v, x.dtype)
    elif positions_are_arange:
        # flash's (B, H, S, hd) layout, contiguous, and back
        out = flash_attention(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
            sm_scale=scale, causal=True, device=x.device,
        ).transpose(1, 2).to(x.dtype)
    else:
        kv_pos = torch.arange(S, dtype=positions.dtype, device=x.device)
        out = chunked_causal_attention(q, k, v, positions, kv_pos, scale).to(x.dtype)
    wo = params["wo"].to(x.dtype)
    return out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1), None

"""GQA attention with RoPE, optional qk-norm / qkv-bias, and a KV cache.

Counterpart of ``repro.models.attention``.  Layouts are the reference's:

  activations  x:      (B, S, D)
  query        q:      (B, S, H, hd)
  keys/values  k, v:   (B, S, KV, hd)
  kv cache     k, v:   (B, M, KV, hd)

Prefill without a cache: up to ``_FULL_ATTN_MAX_SEQ`` tokens
:func:`attention` is the dense masked softmax over ``(B, S, KV, G, S)``
scores, as the reference's.  Above it the reference runs
:func:`chunked_causal_attention`, an online softmax over chunk pairs in
plain JAX; the port runs the same function through the flash-attention
kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`,
``csrc/flash_attn.cu`` on a CUDA tensor, its plain version on a CPU one)
when the positions are ``arange(S)``, the case the kernel's causal mask
assumes, and keeps :func:`chunked_causal_attention` for explicit
positions.

With a cache (prime-for-decode and decode), :func:`attention` writes the
new k/v at ``cache_len`` and runs the dense masked softmax over the whole
cache, never flash, as the reference does; :func:`attention_decode_readonly`
reads the cache and returns the new token's k/v for the caller to append.
The reference's cache writes are functional updates, which its serving
programs donate; the port writes the cache in place.  The reference pins
activation shardings with ``constrain``, a no-op without a device mesh;
the port does not call it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from .common import Initializer, apply_rope, dense_init, rms_norm, rope_angles

__all__ = [
    "init_attention", "attention", "attention_decode_readonly",
    "AttnCache", "init_attn_cache", "chunked_causal_attention",
]

_NEG_INF = -1e30


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, M, KV, hd)
    v: torch.Tensor  # (B, M, KV, hd)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16, device=None) -> AttnCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))

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


def _offset(cache_len) -> int:
    """The cache's write offset as a host int (a tensor is read once)."""
    if cache_len is None:
        raise ValueError("a cache needs cache_len, the tokens already in it")
    return int(cache_len)


def attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[AttnCache] = None,
    cache_len=None,
    *,
    positions_are_arange: bool = False,
) -> Tuple[torch.Tensor, Optional[AttnCache]]:
    """Causal self-attention.

    Prefill: ``cache is None`` → causal over ``x`` itself; returns ``(y,
    None)``.  ``positions_are_arange`` says, without a device read, that
    ``positions`` is ``arange(S)`` on every row (the caller built them):
    above ``_FULL_ATTN_MAX_SEQ`` tokens that sends the attention to the
    flash kernel.

    With a cache of M positions, ``cache_len`` (an int, or a tensor read
    once) of them valid: the new k/v are written at ``cache_len ..
    cache_len + S - 1`` in place, and the queries attend over the whole
    cache, masked to columns at or before their positions; returns ``(y,
    cache)``.
    """
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = _project_qkv(params, cfg, x, positions)
    B, S, H, _ = q.shape
    if cache is not None:
        idx = _offset(cache_len)
        M = cache.k.shape[1]
        if not 0 <= idx <= M - S:
            raise ValueError(f"{S} tokens at offset {idx} overrun a cache of {M}")
        cache.k[:, idx:idx + S] = k.to(cache.k.dtype)
        cache.v[:, idx:idx + S] = v.to(cache.v.dtype)
        s = _gqa_scores(q, cache.k, scale)                      # (B,S,KV,G,M)
        cols = torch.arange(M, dtype=torch.int32, device=x.device)
        mask = (cols[None, None, :] <= positions[:, :, None])[:, :, None, None, :]
        p = torch.softmax(torch.where(mask, s, _NEG_INF), -1)
        out = _gqa_out(p, cache.v, x.dtype)
    elif S <= _FULL_ATTN_MAX_SEQ:
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
    return out.reshape(B, S, H * hd) @ wo.reshape(H * hd, -1), cache


def attention_decode_readonly(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,            # (B, 1, D)
    positions: torch.Tensor,    # (B, 1) == cache_len
    cache: AttnCache,           # ONE layer's slice (B, M, KV, hd), read-only
    cache_len,                  # tokens already in the cache
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step that never writes the cache.

    Attention runs over [cache ; current token] as a two-segment softmax
    (no concatenated k/v); the current token's k/v, in the cache's dtype,
    go back to the caller, which appends every layer's with one write per
    cache leaf.  Returns ``(y, k_new, v_new)``.
    """
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = _project_qkv(params, cfg, x, positions)
    M = cache.k.shape[1]
    s_cache = _gqa_scores(q, cache.k, scale)            # (B,1,KV,G,M)
    cols = torch.arange(M, device=x.device)
    s_cache = torch.where(cols < _offset(cache_len), s_cache, _NEG_INF)
    s_self = _gqa_scores(q, k, scale)                   # (B,1,KV,G,1)
    mm = torch.maximum(s_cache.amax(-1, keepdim=True), s_self)
    e_cache = torch.exp(s_cache - mm)
    e_self = torch.exp(s_self - mm)
    denom = e_cache.sum(-1, keepdim=True) + e_self
    out = torch.einsum("bskgm,bmkh->bskgh", (e_cache / denom).to(cache.v.dtype).float(),
                       cache.v.float())
    out = out + torch.einsum("bskgm,bmkh->bskgh", (e_self / denom).to(v.dtype).float(),
                             v.float())
    B, S, KV, G, _ = out.shape
    out = out.reshape(B, S, KV * G * hd).to(x.dtype)
    y = out @ params["wo"].to(x.dtype).reshape(KV * G * hd, -1)
    return y, k.to(cache.k.dtype), v.to(cache.v.dtype)

"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar).

Counterpart of ``repro.models.xlstm`` (the xLSTM paper, arXiv:2405.04517),
with its arithmetic in its order:

  * **mLSTM** — a matrix memory ``C ∈ R^{hd×hd}`` per head with the
    covariance update ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, exponential
    input gating and a max-stabilizer ``m``.  Prefill runs the chunkwise
    form (quadratic within a chunk, recurrent across chunks); decode is
    the same block at S = 1, one chunk of one token, as in the reference.
  * **sLSTM** — a scalar memory per head with exponential gating and
    block-diagonal recurrent weights, sequential in time: the reference's
    ``jax.lax.scan`` over S is a host loop of S steps on one stream, each
    step's ``h`` written into a preallocated ``(S, H, B, hd)`` tensor.

The reference's three-operand einsums are pairwise products here, in an
order that never forms a ``(B, H, q, k, hd)`` or ``(B, H, q, hd, hd)``
intermediate (``hd`` is 512 at xlstm-350m's width), and the four
recurrent products of an sLSTM step are one batched product against the
four matrices side by side (each output element the same dot product).
The mLSTM core and the sLSTM gates run in f32 whatever the compute dtype;
cached conv windows take the cache's dtype.  On a CUDA device every f32
product runs in IEEE f32 (:func:`repro_torch._device.ieee_f32`).

Caches are written in place and returned, as the attention caches are.
The reference's logical sharding specs (``mlstm_specs``, ``slstm_specs``)
and its ``constrain`` calls, no-ops without a device mesh, are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import ieee_f32
from ..configs.base import ModelConfig
from .common import Initializer, dense_init, rms_norm

__all__ = [
    "init_mlstm_block", "mlstm_block", "MLSTMCache", "init_mlstm_cache",
    "init_slstm_block", "slstm_block", "SLSTMCache", "init_slstm_cache",
]

_M_FLOOR = -1e30   # the stabilizer's start and floor (log domain)


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
class MLSTMCache(NamedTuple):
    C: torch.Tensor     # (B, H, hd, hd) matrix memory
    n: torch.Tensor     # (B, H, hd) normalizer state
    m: torch.Tensor     # (B, H) max-stabilizer (log domain)
    conv: torch.Tensor  # (B, W-1, di) rolling conv window


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    return di, nh, di // nh


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> MLSTMCache:
    di, nh, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        C=torch.zeros((batch, nh, hd, hd), **f32),
        n=torch.zeros((batch, nh, hd), **f32),
        m=torch.full((batch, nh), _M_FLOOR, **f32),
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, di), dtype=dtype, device=device),
    )


def init_mlstm_block(init: Initializer, cfg: ModelConfig):
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=init.device)
    return {
        "norm": torch.ones((d,), **f32),
        "w_up": dense_init(init, (d, 2 * di)),
        "conv_w": 0.1 * init.normal((cfg.xlstm.conv_width, di)),
        "conv_b": torch.zeros((di,), **f32),
        "w_q": dense_init(init, (di, di)),
        "w_k": dense_init(init, (di, di)),
        "w_v": dense_init(init, (di, di)),
        "w_i": dense_init(init, (di, nh)),
        "w_f": dense_init(init, (di, nh)),
        "b_i": torch.zeros((nh,), **f32),
        # forget bias: strongly open (remember) at the start, as in the paper
        "b_f": torch.linspace(3.0, 6.0, nh, **f32),
        "out_norm": torch.ones((di,), **f32),
        "w_down": dense_init(init, (di, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _mlstm_chunked(q, k, v, log_i, log_f, state: Tuple, chunk: int):
    """Chunkwise stabilized mLSTM.

    q/k/v: (B, S, H, hd) f32; log_i/log_f: (B, S, H) f32.
    state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)).
    Returns (h (B,S,H,hd), final_state).
    """
    B, S, H, hd = q.shape
    C_prev, n_prev, m_prev = state
    h = torch.empty_like(q)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qk, kk, vk = (t[:, sl].transpose(1, 2) for t in (q, k, v))   # (B,H,q,hd)
        li, lf = (t[:, sl].transpose(1, 2) for t in (log_i, log_f))  # (B,H,q)
        # inclusive within-chunk cumulative log-forget
        lf_cum = lf.cumsum(-1)
        Fc = lf_cum[..., -1]                                           # (B,H)

        # intra-chunk decay matrix D[t,s] = lf_cum_t - lf_cum_s + li_s (s ≤ t)
        D = lf_cum[..., :, None] - lf_cum[..., None, :] + li[..., None, :]
        D = D.masked_fill(~tri, float("-inf"))                         # (B,H,q,q)

        # per-position stabilizer: max over intra contributions and carry-in
        b_in = lf_cum + m_prev[..., None]                              # (B,H,q)
        m_t = torch.maximum(D.amax(-1), b_in).clamp_min(_M_FLOOR)

        # intra attention-like weights
        Sw = torch.exp(D - m_t[..., None])                             # (B,H,q,q)
        w_qk = Sw * (qk @ kk.transpose(-1, -2))
        h_intra = w_qk @ vk
        n_intra = w_qk.sum(-1)

        # inter-chunk (carry) contribution
        w_in = torch.exp(b_in - m_t)
        h_inter = (qk @ C_prev) * w_in[..., None]
        n_inter = (qk @ n_prev[..., None])[..., 0] * w_in

        h_num = h_intra + h_inter
        n_tot = n_intra + n_inter
        denom = torch.maximum(n_tot.abs(), torch.exp(-m_t))
        h[:, sl] = (h_num / denom[..., None]).transpose(1, 2)

        # chunk-end state update
        g = Fc[..., None] - lf_cum + li                                # decay to end
        m_next = torch.maximum(Fc + m_prev, g.amax(-1)).clamp_min(_M_FLOOR)
        w_st = torch.exp(g - m_next[..., None])
        carry = torch.exp(Fc + m_prev - m_next)
        wk = kk * w_st[..., None]                                      # (B,H,q,hd)
        C_prev = carry[..., None, None] * C_prev + wk.transpose(-1, -2) @ vk
        n_prev = carry[..., None] * n_prev + wk.sum(-2)
        m_prev = m_next
    return h, (C_prev, n_prev, m_prev)


def _mlstm_chunk_size(cfg: ModelConfig, S: int) -> int:
    chunk = min(cfg.xlstm.conv_width * 64, S)   # default 256, clipped to S
    while S % chunk:
        chunk //= 2
    return chunk


def _conv_window(cache_conv, x, params, W: int):
    """The causal conv's silu output for ``x`` (B, S, C), from zeros or
    after the cached window; returns ``(out, new window)``."""
    if cache_conv is None:
        return F.silu(_causal_conv(x, params["conv_w"], params["conv_b"])), None
    win = torch.cat([cache_conv.to(x.dtype), x], 1)
    out = F.silu(_causal_conv(win, params["conv_w"], params["conv_b"])[:, -x.shape[1]:, :])
    return out, win[:, -(W - 1):, :]


def _head_norm(h: torch.Tensor, nh: int, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head group norm (rms over the head dim) in f32, then ``w``."""
    B, S, D = h.shape
    hf = h.float().reshape(B, S, nh, D // nh)
    var = (hf * hf).mean(-1, keepdim=True)
    return ((hf * torch.rsqrt(var + eps)).reshape(B, S, D) * w).to(h.dtype)


def mlstm_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: Optional[MLSTMCache] = None,
) -> Tuple[torch.Tensor, Optional[MLSTMCache]]:
    """Residual mLSTM block.  x: (B, S, D).  A cache is read, then
    overwritten in place with the state after the sequence and returned."""
    di, nh, hd = _mlstm_dims(cfg)
    dt = x.dtype
    B, S, _ = x.shape
    with ieee_f32(x.device):
        h_in = rms_norm(params["norm"], x, cfg.norm_eps)
        up = h_in @ params["w_up"].to(dt)
        x_m, z = up[..., :di], up[..., di:]                          # (B,S,di) each
        x_conv, conv_tail = _conv_window(None if cache is None else cache.conv, x_m,
                                         params, cfg.xlstm.conv_width)

        q = (x_conv @ params["w_q"].to(dt)).reshape(B, S, nh, hd)
        k = ((x_conv @ params["w_k"].to(dt)) * (hd ** -0.5)).reshape(B, S, nh, hd)
        v = (x_m @ params["w_v"].to(dt)).reshape(B, S, nh, hd)
        log_i = (x_conv @ params["w_i"].to(dt)).float() + params["b_i"]
        log_f = F.logsigmoid((x_conv @ params["w_f"].to(dt)).float() + params["b_f"])

        if cache is None:
            f32 = dict(dtype=torch.float32, device=x.device)
            state = (torch.zeros((B, nh, hd, hd), **f32), torch.zeros((B, nh, hd), **f32),
                     torch.full((B, nh), _M_FLOOR, **f32))
        else:
            state = (cache.C, cache.n, cache.m)
        h, (C_f, n_f, m_f) = _mlstm_chunked(q.float(), k.float(), v.float(), log_i, log_f,
                                            state, _mlstm_chunk_size(cfg, S))
        h = _head_norm(h.reshape(B, S, di).to(dt), nh, params["out_norm"], cfg.norm_eps)
        y = (h * F.silu(z)) @ params["w_down"].to(dt)

    if cache is not None:
        for dst, src in zip(cache, (C_f, n_f, m_f, conv_tail)):
            dst.copy_(src)
    return x + y, cache


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
class SLSTMCache(NamedTuple):
    c: torch.Tensor     # (B, H, hd) cell
    n: torch.Tensor     # (B, H, hd) normalizer
    h: torch.Tensor     # (B, H, hd) hidden (recurrent input)
    m: torch.Tensor     # (B, H, hd) stabilizer
    conv: torch.Tensor  # (B, W-1, D)


def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    nh = cfg.n_heads
    return nh, cfg.d_model // nh


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> SLSTMCache:
    nh, hd = _slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMCache(
        c=torch.zeros((batch, nh, hd), **f32),
        n=torch.ones((batch, nh, hd), **f32),
        h=torch.zeros((batch, nh, hd), **f32),
        m=torch.zeros((batch, nh, hd), **f32),
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, cfg.d_model), dtype=dtype,
                         device=device),
    )


def init_slstm_block(init: Initializer, cfg: ModelConfig):
    d = cfg.d_model
    nh, hd = _slstm_dims(cfg)
    df = int(cfg.xlstm.slstm_proj_factor * d)
    f32 = dict(dtype=torch.float32, device=init.device)
    return {
        "norm": torch.ones((d,), **f32),
        "conv_w": 0.1 * init.normal((cfg.xlstm.conv_width, d)),
        "conv_b": torch.zeros((d,), **f32),
        # input weights for the four gates (z, i, f, o)
        "w_z": dense_init(init, (d, d)),
        "w_i": dense_init(init, (d, d)),
        "w_f": dense_init(init, (d, d)),
        "w_o": dense_init(init, (d, d)),
        # block-diagonal recurrent weights per head
        "r_z": 0.1 * init.normal((nh, hd, hd)),
        "r_i": 0.1 * init.normal((nh, hd, hd)),
        "r_f": 0.1 * init.normal((nh, hd, hd)),
        "r_o": 0.1 * init.normal((nh, hd, hd)),
        "b_z": torch.zeros((d,), **f32),
        "b_i": torch.zeros((d,), **f32),
        "b_f": torch.full((d,), 3.0, **f32),
        "b_o": torch.zeros((d,), **f32),
        "gn": torch.ones((d,), **f32),
        # post-up GeGLU MLP (proj factor 4/3)
        "w_up_g": dense_init(init, (d, df)),
        "w_up_v": dense_init(init, (d, df)),
        "w_down": dense_init(init, (df, d)),
    }


def _slstm_step(R, state, pre, h_out):
    """One recurrent step, heads leading: ``state`` (c, n, h, m) each
    (H, B, hd); ``pre`` the step's input contributions (H, B, 4·hd) in
    the order (z, i, f, o); ``R`` the recurrent weights side by side
    (H, hd, 4·hd).  The new ``h`` is written into ``h_out``."""
    c, n, h, m = state
    hd = c.shape[-1]
    g = torch.baddbmm(pre, h, R)                 # input + block-diag recurrent
    z_t = torch.tanh(g[..., :hd])
    i_pre = g[..., hd:2 * hd]
    log_f = F.logsigmoid(g[..., 2 * hd:3 * hd])
    o_t = torch.sigmoid(g[..., 3 * hd:])

    lf_m = log_f + m
    m_new = torch.maximum(lf_m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(lf_m - m_new)
    c_new = f_s * c + i_s * z_t
    n_new = f_s * n + i_s
    torch.div(o_t * c_new, n_new.clamp_min(1e-6), out=h_out)
    return c_new, n_new, h_out, m_new


def slstm_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: Optional[SLSTMCache] = None,
) -> Tuple[torch.Tensor, Optional[SLSTMCache]]:
    """Residual sLSTM block (a host loop over time).  x: (B, S, D).  A
    cache is read, then overwritten in place and returned."""
    nh, hd = _slstm_dims(cfg)
    dt = x.dtype
    B, S, D = x.shape
    with ieee_f32(x.device):
        h_in = rms_norm(params["norm"], x, cfg.norm_eps)
        xc_in, conv_tail = _conv_window(None if cache is None else cache.conv, h_in,
                                        params, cfg.xlstm.conv_width)

        # input contributions to the four gates, precomputed for the whole
        # sequence: (B, S, 4, D) as the reference stacks them, laid out
        # (S, H, B, 4·hd) for the steps
        gz = h_in @ params["w_z"].to(dt) + params["b_z"].to(dt)
        gi = xc_in @ params["w_i"].to(dt) + params["b_i"].to(dt)
        gf = xc_in @ params["w_f"].to(dt) + params["b_f"].to(dt)
        go = h_in @ params["w_o"].to(dt) + params["b_o"].to(dt)
        gates = (torch.stack([gz, gi, gf, go], 2).float()
                 .reshape(B, S, 4, nh, hd).permute(1, 3, 0, 2, 4).reshape(S, nh, B, 4 * hd))
        R = torch.stack([params[k] for k in ("r_z", "r_i", "r_f", "r_o")], 2).reshape(
            nh, hd, 4 * hd)

        if cache is None:
            f32 = dict(dtype=torch.float32, device=x.device)
            zeros = torch.zeros((nh, B, hd), **f32)
            state = (zeros, torch.ones((nh, B, hd), **f32), zeros, zeros)
        else:
            state = tuple(t.transpose(0, 1) for t in cache[:4])
        hs = torch.empty((S, nh, B, hd), dtype=torch.float32, device=x.device)
        for t in range(S):
            state = _slstm_step(R, state, gates[t], hs[t])
        h = hs.permute(2, 0, 1, 3).reshape(B, S, D).to(dt)

        h = _head_norm(h, nh, params["gn"], cfg.norm_eps)
        # post-up GeGLU MLP
        g = h @ params["w_up_g"].to(dt)
        u = h @ params["w_up_v"].to(dt)
        y = (F.gelu(g, approximate="tanh") * u) @ params["w_down"].to(dt)

    if cache is not None:
        for dst, src in zip(cache, state):
            dst.copy_(src.transpose(0, 1))
        cache.conv.copy_(conv_tail)
    return x + y, cache

"""Mamba2 block (state-space duality / SSD), chunked-parallel and recurrent.

Counterpart of ``repro.models.ssm``, with its arithmetic in its order.
Prefill runs the chunked SSD algorithm (quadratic within a chunk, linear
across chunks); decode runs the one-token recurrent update.  The layer is
a fused input projection → a short causal depthwise conv on ``(x, B, C)``
→ the SSD core → a gated RMSNorm → the output projection.

Head layout: ``d_inner = expand · d_model``, ``n_heads = d_inner /
head_dim``, a state of ``(head_dim, d_state)`` per head.  Head ``i``
reads group ``i // (n_heads / n_groups)`` of ``B`` and ``C`` (the
reference's ``jnp.repeat``): the heads are laid out ``(groups, heads a
group)``, so one group's products broadcast over its heads.

The reference's four-operand einsums are one batched product each, the
scalar factors folded into one operand first (``L · dt`` for the
within-chunk outputs, ``decay · dt`` for the chunk states): no ``(b, c,
h, q, k, p)`` intermediate.  Its ``lax.scan`` over chunks is a host loop
(8 steps at 2,048 tokens and chunks of 256).

The reference's quirks are kept:

  * ``_segsum`` is the difference of two cumulative sums, masked with
    ``-inf`` above the diagonal, not upstream Mamba2's stable segment sum
    (which rounds otherwise where the sums reach hundreds);
  * the sequence must be a multiple of ``min(chunk_size, S)`` (the
    reference's reshape refuses any other; here a ``ValueError``);
  * a prefill with a cache starts from a zero state and a zero-padded
    conv (the cache's window is read only when ``S < conv_width - 1``):
    only a prefill into empty caches continues to the right decode;
  * decode concatenates the cached conv window with the new column in
    their promoted dtype, so a bf16 window under f32 compute comes back
    f32.  Caches are written in place here, so :func:`mamba2_decode`
    then returns a cache with a new f32 window (the state still written
    in place), and ``lm_decode_step`` widens a hybrid group's stacked
    window once before its layers run: the new columns stay unrounded,
    as the reference's do.

On a CUDA device every f32 product runs in IEEE f32
(:func:`repro_torch._device.ieee_f32`).  The reference's logical sharding
specs (``mamba2_specs``) and its ``constrain`` call, a no-op without a
device mesh, are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._device import ieee_f32
from ..configs.base import ModelConfig
from .common import Initializer, dense_init, silu
from .xlstm import _causal_conv   # the reference's ssm and xlstm share this conv

__all__ = ["init_mamba2", "mamba2", "SSMCache", "init_ssm_cache", "mamba2_decode"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) rolling conv input window
    state: torch.Tensor  # (B, H, P, N) SSD state


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    return d_inner, n_heads, conv_dim


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> SSMCache:
    sc = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, sc.conv_width - 1, conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, n_heads, sc.head_dim, sc.d_state), dtype=torch.float32,
                          device=device),
    )


def init_mamba2(init: Initializer, cfg: ModelConfig):
    """The layer's parameters, drawn in the reference's order (``w_in``,
    ``conv_w``, ``A_log``, ``dt_bias``, ``w_out``) from the same
    distributions."""
    sc = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    proj_out = 2 * d_inner + 2 * sc.n_groups * sc.d_state + n_heads
    f32 = dict(dtype=torch.float32, device=init.device)
    w_in = dense_init(init, (d, proj_out))
    conv_w = 0.1 * init.normal((sc.conv_width, conv_dim))
    a = 1.0 + 15.0 * init.uniform((n_heads,))              # U[1, 16)
    dt0 = 1e-3 + (0.1 - 1e-3) * init.uniform((n_heads,))   # U[1e-3, 0.1)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(a),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_w": torch.ones((d_inner,), **f32),
        "w_out": dense_init(init, (d_inner, d)),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """``(z, xbc, dt)`` of the fused projection; ``xbc = [x | B | C]``
    before the conv."""
    sc = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    gn = sc.n_groups * sc.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, n_heads], -1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis, accumulated in f64 and rounded
    once: torch's CPU cumsum of f32 does so already, and on the card this
    gives the CPU's sums (an f32 scan there rounds in another order, an
    ulp of sums that reach hundreds at chunks of 256)."""
    return x.double().cumsum(-1).to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = cumsum(x)[i] - cumsum(x)[j]`` for ``j <= i``,
    ``-inf`` above the diagonal: the reference's formula (two cumulative
    sums' difference, not the stable segment sum)."""
    T = x.shape[-1]
    c = _cumsum(x)
    out = c[..., :, None] - c[..., None, :]
    upper = torch.ones((T, T), dtype=torch.bool, device=x.device).triu(1)
    return out.masked_fill_(upper, float("-inf"))


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD core (chunked scan) from a zero state.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) negative decay rates; B, C:
    (b, s, g, n).  Returns ``(y (b, s, h, p), final_state (b, h, p, n))``.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"a sequence of {s} is not a multiple of the SSD chunk {chunk} "
                         f"(min(chunk_size, S)); the reference's reshape refuses it too")
    nc, rep = s // chunk, h // g
    # chunks, and heads as (groups, heads a group): (b, c, g, r, q, ·)
    xc = x.reshape(b, nc, chunk, g, rep, p).permute(0, 1, 3, 4, 2, 5)
    dtc = dt.reshape(b, nc, chunk, g, rep).permute(0, 1, 3, 4, 2)
    Bc = B.reshape(b, nc, chunk, g, n).transpose(2, 3)[:, :, :, None]   # (b,c,g,1,q,n)
    Cc = C.reshape(b, nc, chunk, g, n).transpose(2, 3)[:, :, :, None]

    dA = dtc * A.reshape(g, rep, 1)                          # (b,c,g,r,q) negative
    dA_cs = _cumsum(dA)                                      # within-chunk cumsum

    # 1. within-chunk (diagonal blocks): L · scores · dt[k], then · x
    M = _segsum(dA).exp_()                                   # L (b,c,g,r,q,k)
    M.mul_(Cc @ Bc.transpose(-1, -2)).mul_(dtc[..., None, :])
    y = M @ xc                                               # (b,c,g,r,q,p)
    del M

    # 2. chunk states: each chunk's inputs decayed to its end
    w = torch.exp(dA_cs[..., -1:] - dA_cs) * dtc             # decay · dt (b,c,g,r,q)
    states = (xc * w[..., None]).transpose(-1, -2) @ Bc      # (b,c,g,r,p,n)

    # 3. inter-chunk recurrence: a host loop over the chunks
    chunk_decay = torch.exp(dA_cs[..., -1])[..., None, None]  # (b,c,g,r,1,1)
    prev = torch.empty_like(states)
    st = torch.zeros_like(states[:, 0])
    for c in range(nc):
        prev[:, c] = st
        st = states[:, c] + chunk_decay[:, c] * st

    # 4. the previous chunks' states' contribution to the outputs
    y += (Cc @ prev.transpose(-1, -2)) * torch.exp(dA_cs)[..., None]
    return y.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, p), st.reshape(b, h, p, n)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float):
    """Mamba2's gated RMSNorm, ``norm(y · silu(z))``: one norm over all
    ``d_inner`` columns, in f32, back in ``y``'s dtype."""
    y = y * silu(z)
    yf = y.float()
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * w).to(y.dtype)


def mamba2(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: Optional[SSMCache] = None,
) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence forward (prefill).  x: (B, S, D).  With a cache, the
    conv window after the sequence and the SSD state after it (from a
    zero start, as in the reference) overwrite it in place, and it is
    returned."""
    sc = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    gn = sc.n_groups * sc.d_state
    dt_ = x.dtype
    b, s, _ = x.shape
    with ieee_f32(x.device):
        zxbcdt = x @ params["w_in"].to(dt_)
        z, xbc, dtr = _split_proj(cfg, zxbcdt)
        xi, B, C = torch.split(silu(_causal_conv(xbc, params["conv_w"], params["conv_b"])),
                               [d_inner, gn, gn], -1)
        xi = xi.reshape(b, s, n_heads, sc.head_dim).float()
        dt = _softplus(dtr.float() + params["dt_bias"])                      # (b,s,h)
        A = -torch.exp(params["A_log"])                                      # (h,)
        y, final_state = _ssd_chunked(
            xi, dt, A, B.reshape(b, s, sc.n_groups, sc.d_state).float(),
            C.reshape(b, s, sc.n_groups, sc.d_state).float(), min(sc.chunk_size, s))
        y = (y + params["D"][:, None] * xi).reshape(b, s, d_inner).to(dt_)
        out = _gated_norm(y, z, params["norm_w"], cfg.norm_eps) @ params["w_out"].to(dt_)
    if cache is not None:
        keep = sc.conv_width - 1
        if s >= keep:
            tail = xbc[:, s - keep:]
        else:
            wide = torch.promote_types(cache.conv.dtype, dt_)
            tail = torch.cat([cache.conv[:, s:].to(wide), xbc.to(wide)], 1)
        cache.conv.copy_(tail)
        cache.state.copy_(final_state)
    return out, cache


def mamba2_decode(
    params, cfg: ModelConfig, x: torch.Tensor, cache: SSMCache
) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step.  x: (B, 1, D) → (B, 1, D).

    The state is overwritten in place.  The conv window rolls by one
    column in the dtype the reference's concatenation gives, the
    promotion of the cache's and ``x``'s: in place when that is the
    cache's own; otherwise (a bf16 window, f32 compute) the returned
    cache holds a new window in the wider dtype, as the reference's
    does."""
    sc = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    gn = sc.n_groups * sc.d_state
    dt_ = x.dtype
    b = x.shape[0]
    with ieee_f32(x.device):
        zxbcdt = x @ params["w_in"].to(dt_)
        z, xbc, dtr = _split_proj(cfg, zxbcdt)                          # (b,1,·)

        wide = torch.promote_types(cache.conv.dtype, dt_)
        win = torch.cat([cache.conv.to(wide), xbc.to(wide)], 1)         # (b,W,conv_dim)
        conv_out = (win.float() * params["conv_w"]).sum(1) + params["conv_b"]
        xi, B, C = torch.split(silu(conv_out)[:, None, :].to(dt_), [d_inner, gn, gn], -1)
        xi = xi.reshape(b, sc.n_groups, n_heads // sc.n_groups, sc.head_dim).float()
        B1 = B.reshape(b, sc.n_groups, 1, sc.d_state).float()
        C1 = C.reshape(b, sc.n_groups, 1, sc.d_state).float()
        dt1 = _softplus(dtr[:, 0, :].float() + params["dt_bias"])      # (b,h)
        A = -torch.exp(params["A_log"])

        decay = torch.exp(dt1 * A).reshape(b, n_heads, 1, 1)
        dtx = (dt1.reshape(xi.shape[:3])[..., None] * xi)[..., None]   # (b,g,r,p,1)
        upd = (dtx * B1[..., None, :]).reshape(b, n_heads, sc.head_dim, sc.d_state)
        state = cache.state * decay + upd
        y = (state.reshape(b, sc.n_groups, -1, sc.head_dim, sc.d_state)
             @ C1[..., None]).reshape(b, n_heads, sc.head_dim)
        y = y + params["D"][:, None] * xi.reshape(b, n_heads, sc.head_dim)
        y = y.reshape(b, 1, d_inner).to(dt_)
        out = _gated_norm(y, z, params["norm_w"], cfg.norm_eps) @ params["w_out"].to(dt_)
    cache.state.copy_(state)
    if cache.conv.dtype == wide:
        cache.conv.copy_(win[:, 1:])
        return out, cache
    return out, cache._replace(conv=win[:, 1:].contiguous())

"""Mixture-of-Experts layer: top-k routing, capacity dispatch.

Counterpart of ``repro.models.moe``, with its Switch-style capacity
dispatch in the reference's order:

  1. router logits → top-k (expert, gate) per token;
  2. position-in-expert via a cumulative sum over the one-hot assignment,
     within each of ``G`` dispatch groups; slots beyond the per-group
     capacity ``ceil(tg·k/E · capacity_factor)`` are dropped (sent to a
     dump slot and masked on combine);
  3. token ids are scattered into an ``(E, C)`` source map, and rows are
     gathered from it into an ``(E, C, D)`` buffer;
  4. batched expert SwiGLU; combine = gather + gate-weighted sum over k.

Routers: "softmax" (OLMoE: softmax → top-k → renormalize) and "sigmoid"
(DeepSeek-V3: sigmoid scores → top-k → normalize).  A Switch load-balance
auxiliary loss is returned beside the output.

Top-k is a stable descending sort: ``jax.lax.top_k`` takes the lower
index among equal values, and ``torch.topk`` promises no order for them
on CUDA (an all-zero hidden row gives E equal router probabilities).
The combine sums each token's k slots with ``.sum`` over a ``(T, k, D)``
view, never ``index_add_``, whose atomics on CUDA change the bits from
run to run.  The reference's logical sharding specs (``moe_specs``) and
its ``constrain`` calls, no-ops without a device mesh, are not ported.
The expert products are plain batched matmuls, outside any kernel in
the reference too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .common import Initializer, dense_init

__all__ = ["init_moe", "moe"]


def init_moe(init: Initializer, cfg: ModelConfig):
    mc = cfg.moe
    if mc is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    d, e, f = cfg.d_model, mc.n_experts, mc.d_ff_expert
    params = {
        "router": dense_init(init, (d, e)),
        "w_gate": dense_init(init, (e, d, f)),
        "w_up": dense_init(init, (e, d, f)),
        "w_down": dense_init(init, (e, f, d), in_axis=1),
    }
    if mc.n_shared_experts:
        fs = f * mc.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(init, (d, fs)),
            "w_up": dense_init(init, (d, fs)),
            "w_down": dense_init(init, (fs, d)),
        }
    return params


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, stable=True, dim=-1, descending=True)
    return vals[..., :k], idx[..., :k]


def _route(mc: MoEConfig, logits: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) → (gates (T,k), experts (T,k), probs-for-aux (T, E))."""
    if mc.router_type == "sigmoid":
        scores = torch.sigmoid(logits.float())
        gate, idx = _top_k(scores, mc.top_k)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits.float(), -1)
        gate, idx = _top_k(probs, mc.top_k)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    return gate, idx, probs


def _dispatch(mc: MoEConfig, idx: torch.Tensor, dropless: bool):
    """Queue positions of the ``(T·k,)`` slots ``idx`` assigns: returns
    ``(G, cap_g, keep, pos_c, g_of)``, the dispatch groups, the per-group
    capacity, which slots fit, each slot's position (``cap_g``, the
    group's dump column, where it does not fit) and each slot's group."""
    T, K = idx.shape
    E = mc.n_experts
    G = mc.dispatch_groups if (not dropless and T % mc.dispatch_groups == 0) else 1
    tg = T // G
    cap_g = T if dropless else max(int(math.ceil(tg * K / E * mc.capacity_factor)), 4)
    # position of each (token, k) slot within its expert's per-group queue
    gidx = idx.reshape(G, tg * K, 1)
    onehot = F.one_hot(gidx[..., 0], E)
    pos_all = onehot.cumsum(1, dtype=torch.int32) - 1              # (G, tg·K, E)
    pos = pos_all.gather(2, gidx).reshape(-1)                      # (T·K,)
    keep = pos < cap_g
    pos_c = torch.where(keep, pos, cap_g)
    g_of = torch.arange(G, dtype=torch.int32, device=idx.device).repeat_interleave(tg * K)
    return G, cap_g, keep, pos_c, g_of


def moe(params, cfg: ModelConfig, x: torch.Tensor, dropless: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y (B, S, D), aux_loss scalar f32).

    ``dropless=True`` sets the capacity to T, so no token is dropped and
    each token's output depends on its own routing alone (decode must
    match the full forward); otherwise a document's output depends on
    the batch it arrives in, through the drops.
    """
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mc.n_experts, mc.top_k
    dt = x.dtype
    xf = x.reshape(T, D)

    logits = xf @ params["router"].to(dt)
    gate, idx, probs = _route(mc, logits)            # (T,K), (T,K), (T,E)

    # load-balance auxiliary loss (Switch): E · Σ_e frac_tokens_e · frac_prob_e
    assign1 = F.one_hot(idx[:, 0], E).float()
    aux = E * (assign1.mean(0) * probs.mean(0)).mean()

    G, cap_g, keep, pos_c, g_of = _dispatch(mc, idx, dropless)
    capacity = G * cap_g                             # total per-expert slots
    e_flat = idx.reshape(-1)
    tok_rep = torch.arange(T, device=x.device).repeat_interleave(K)

    # dispatch by gather: token ids into a small (E, C) map (every dropped
    # slot writes its group's dump column, sliced away), then rows
    stride = cap_g + 1
    slot = e_flat * (G * stride) + g_of * stride + pos_c
    src_map = torch.full((E * G * stride,), T, dtype=torch.int64, device=x.device)
    src_map[slot] = tok_rep
    src_map = src_map.view(E, G, stride)[:, :, :cap_g].reshape(E, capacity)
    x_pad = torch.cat([xf, xf.new_zeros(1, D)])                  # dump row
    h = x_pad[src_map]                                           # (E, C, D)

    # batched expert SwiGLU
    g = torch.bmm(h, params["w_gate"].to(dt))
    u = torch.bmm(h, params["w_up"].to(dt))
    o = torch.bmm(F.silu(g) * u, params["w_down"].to(dt))

    # combine: gather each slot's output, weight by gate, sum over k
    o_pad = torch.cat([o, o.new_zeros(E, 1, D)], 1)
    col = torch.where(keep, g_of * cap_g + pos_c, capacity).long()  # dump col
    out_slots = o_pad[e_flat, col]                               # (T·K, D)
    w = (gate.reshape(-1) * keep.float()).to(dt)
    y = (out_slots * w[:, None]).view(T, K, D).sum(1)

    if mc.n_shared_experts:
        sp = params["shared"]
        g = xf @ sp["w_gate"].to(dt)
        u = xf @ sp["w_up"].to(dt)
        y = y + (F.silu(g) * u) @ sp["w_down"].to(dt)

    return y.reshape(B, S, D), aux

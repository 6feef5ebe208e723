"""Causal-LM assembly: the forward pass of the dense-attention archs.

Counterpart of ``repro.models.lm``.  One :class:`ModelConfig` determines
the network; layers are grouped into *scan groups* of identically shaped
blocks whose parameters are stacked along a leading ``layers`` axis.  The
reference runs ``jax.lax.scan`` over that axis; the port runs a host loop
over it, one block at a time on the stacked tensors' slices.

Ported: the ``attn_dense`` group (qwen3-0.6b, qwen2.5-3b, codeqwen1.5-7b,
deepseek-coder-33b, chameleon-34b, musicgen-medium), :func:`init_lm`,
:func:`param_count` and :func:`lm_forward` without caches.  MoE, MLA,
hybrid and xLSTM plans, the decode path (caches, ``lm_decode_step``,
``mtp_logits``) and the logical sharding specs (``lm_specs``) are not
ported yet and raise or are absent (ROADMAP queue 1, items 9b and 10).

On a CUDA device every f32 product runs in IEEE f32
(:func:`repro_torch._device.ieee_f32`): TF32 would move the embeddings,
and so the scores the join holds against θ, by about 1e-3.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .._device import ieee_f32
from ..configs.base import ModelConfig
from .attention import attention, init_attention
from .common import Initializer, embed_init, rms_norm
from .mlp import init_mlp, mlp

__all__ = ["GroupPlan", "make_plan", "init_lm", "lm_forward", "param_count"]


class GroupPlan(NamedTuple):
    kind: str    # attn_dense | attn_moe | hybrid | xlstm
    count: int   # number of stacked units


def make_plan(cfg: ModelConfig) -> List[GroupPlan]:
    if cfg.xlstm is not None:
        k = cfg.xlstm.slstm_every
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        return [GroupPlan("xlstm", cfg.n_layers // k)]
    if cfg.hybrid is not None:
        k = cfg.hybrid.shared_every
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        return [GroupPlan("hybrid", cfg.n_layers // k)]
    if cfg.moe is not None:
        nd = cfg.moe.n_dense_layers
        plan = []
        if nd:
            plan.append(GroupPlan("attn_dense", nd))
        plan.append(GroupPlan("attn_moe", cfg.n_layers - nd))
        return plan
    return [GroupPlan("attn_dense", cfg.n_layers)]


def _dense_plan(cfg: ModelConfig) -> List[GroupPlan]:
    """The plan, if the port runs every group of it."""
    plan = make_plan(cfg)
    other = sorted({g.kind for g in plan} - {"attn_dense"})
    if other or cfg.mla is not None or cfg.mtp:
        what = other or ["mla" if cfg.mla is not None else "mtp"]
        raise NotImplementedError(
            f"{cfg.name}: block kinds {what} are not ported yet (ROADMAP "
            f"queue 1, item 9b); the port runs the dense-attention archs"
        )
    return plan


def _init_attn_block(init: Initializer, cfg: ModelConfig):
    """One transformer block: norm → attn → norm → mlp."""
    ones = dict(dtype=torch.float32, device=init.device)
    return {
        "norm1": torch.ones((cfg.d_model,), **ones),
        "attn": init_attention(init, cfg),
        "norm2": torch.ones((cfg.d_model,), **ones),
        "mlp": init_mlp(init, cfg.d_model, cfg.d_ff),
    }


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i``'s parameters: every stacked leaf's ``i``-th slice."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm(init: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    """All parameters (float32), drawn in the reference's order; the tree
    mirrors the reference's ``init_lm`` leaf for leaf."""
    groups = [
        {"stacked": _stack([_init_attn_block(init, cfg) for _ in range(g.count)])}
        for g in _dense_plan(cfg)
    ]
    params: Dict[str, Any] = {
        "embed": embed_init(init, (cfg.vocab_size, cfg.d_model)),
        "groups": groups,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=init.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(init, (cfg.d_model, cfg.vocab_size)) * (
            cfg.d_model ** -0.5
        )
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_lm`, counted on the meta device (nothing
    is allocated)."""
    return sum(t.numel() for t in _leaves(init_lm(Initializer(device="meta"), cfg)))


def _attn_block_apply(params, cfg: ModelConfig, x, positions, positions_are_arange):
    h = rms_norm(params["norm1"], x, cfg.norm_eps)
    a, _ = attention(params["attn"], cfg, h, positions,
                     positions_are_arange=positions_are_arange)
    x = x + a
    h = rms_norm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h)


def lm_forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,     # (B, S) int
    embeds: Optional[torch.Tensor] = None,     # (B, S, D) — modality-stub input
    positions: Optional[torch.Tensor] = None,  # (B, S)
    caches=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_hidden: bool = False,
):
    """Full-sequence forward (prefill).

    Returns ``(logits, aux, None[, hidden])``, the reference's tuple:
    ``aux`` is the MoE load-balance loss (0 here), the caches are None,
    ``hidden`` the final-normed hidden state.  The logits are computed
    even when only the hidden state is wanted, as in the reference.
    """
    if caches is not None:
        raise NotImplementedError(
            "primed decode caches are not ported yet (ROADMAP queue 1, item 9b)"
        )
    plan = _dense_plan(cfg)
    if embeds is not None:
        x = embeds.to(compute_dtype)
        B, S = x.shape[:2]
    else:
        B, S = tokens.shape
        x = torch.nn.functional.embedding(tokens.long(), params["embed"]).to(compute_dtype)
    dev = x.device
    arange = positions is None
    if arange:
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    with ieee_f32(dev):
        for gi, g in enumerate(plan):
            stacked = params["groups"][gi]["stacked"]
            for i in range(g.count):
                x = _attn_block_apply(_layer(stacked, i), cfg, x, positions, arange)
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = x @ head.to(compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if return_hidden:
        return logits, aux, None, x
    return logits, aux, None

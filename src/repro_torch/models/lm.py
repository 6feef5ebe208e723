"""Causal-LM assembly: the forward pass and decode of the ported archs.

Counterpart of ``repro.models.lm``.  One :class:`ModelConfig` determines
the network; layers are grouped into *scan groups* of identically shaped
blocks whose parameters are stacked along a leading ``layers`` axis.  The
reference runs ``jax.lax.scan`` over that axis; the port runs a host loop
over it, one block at a time on the stacked tensors' slices.

Ported: the ``attn_dense`` group (qwen3-0.6b, qwen2.5-3b, codeqwen1.5-7b,
deepseek-coder-33b, chameleon-34b, musicgen-medium), the ``attn_moe``
group with GQA attention (olmoe-1b-7b), the ``hybrid`` group (zamba2-2.7b:
each unit ``shared_every`` Mamba2 layers, then one invocation of the
*shared* attention+MLP block, whose weights sit outside the stack and
whose every invocation has its own attention cache) and the ``xlstm``
group (xlstm-350m: each unit ``slstm_every - 1`` mLSTM blocks, then one
sLSTM block), :func:`init_lm`, :func:`param_count`, :func:`lm_forward`
(with primed caches and the MoE aux loss), :func:`init_lm_caches` and
:func:`lm_decode_step`.  MLA attention, ``mtp_logits`` and the logical
sharding specs (``lm_specs``, ``lm_cache_specs``) are not ported yet and
raise or are absent (ROADMAP queue 1, items 9b and 10).

Caches are written in place and returned: the reference's functional
cache updates are donated by its serving programs.  Every layer's cache
has memory of its own (``init_lm_caches`` repeats, never expands).  On a CUDA device
every f32 product runs in IEEE f32 (:func:`repro_torch._device.ieee_f32`):
TF32 would move the embeddings, and so the scores the join holds against
θ, by about 1e-3.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .._device import ieee_f32
from ..configs.base import ModelConfig
from .attention import (
    AttnCache, attention, attention_decode_readonly, init_attention, init_attn_cache,
)
from .common import Initializer, embed_init, rms_norm
from .mlp import init_mlp, mlp
from .moe import init_moe, moe
from .ssm import SSMCache, init_mamba2, init_ssm_cache, mamba2, mamba2_decode
from .xlstm import (
    MLSTMCache, SLSTMCache, init_mlstm_block, init_mlstm_cache, init_slstm_block,
    init_slstm_cache, mlstm_block, slstm_block,
)

__all__ = [
    "GroupPlan", "make_plan", "init_lm", "lm_forward", "lm_decode_step",
    "init_lm_caches", "param_count",
]

_ATTN_KINDS = ("attn_dense", "attn_moe")
_PORTED_KINDS = _ATTN_KINDS + ("hybrid", "xlstm")


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


def _ported_plan(cfg: ModelConfig) -> List[GroupPlan]:
    """The plan, if the port runs every group of it: attention blocks
    with GQA attention and a dense or MoE feed-forward, Mamba2 hybrid
    units and xLSTM units."""
    plan = make_plan(cfg)
    other = sorted({g.kind for g in plan} - set(_PORTED_KINDS))
    if other or cfg.mla is not None or cfg.mtp:
        what = other or (["mla"] if cfg.mla is not None else []) + (
            ["mtp"] if cfg.mtp else [])
        raise NotImplementedError(
            f"{cfg.name}: block kinds {what} are not ported yet (ROADMAP "
            f"queue 1, item 9b); the port runs GQA attention blocks with a "
            f"dense or MoE feed-forward, Mamba2 hybrid units and xLSTM blocks"
        )
    return plan


def _dense_ff(cfg: ModelConfig) -> int:
    """FFN width for *dense* blocks.  In MoE configs ``cfg.d_ff`` is the
    per-expert width; the leading dense layers use ``moe.d_ff_dense``."""
    if cfg.moe is not None and cfg.moe.d_ff_dense:
        return cfg.moe.d_ff_dense
    return cfg.d_ff


def _init_attn_block(init: Initializer, cfg: ModelConfig, use_moe: bool):
    """One transformer block: norm → attn → norm → mlp/moe."""
    ones = dict(dtype=torch.float32, device=init.device)
    params = {
        "norm1": torch.ones((cfg.d_model,), **ones),
        "attn": init_attention(init, cfg),
        "norm2": torch.ones((cfg.d_model,), **ones),
    }
    if use_moe:
        params["moe"] = init_moe(init, cfg)
    else:
        params["mlp"] = init_mlp(init, cfg.d_model, _dense_ff(cfg))
    return params


def _init_xlstm_unit(init: Initializer, cfg: ModelConfig):
    """``slstm_every - 1`` stacked mLSTM blocks, then one sLSTM block."""
    k = cfg.xlstm.slstm_every
    mls = [init_mlstm_block(init, cfg) for _ in range(k - 1)]
    return {"mlstm": _stack(mls), "slstm": init_slstm_block(init, cfg)}


def _init_mamba_layer(init: Initializer, cfg: ModelConfig):
    return {"norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=init.device),
            "mamba": init_mamba2(init, cfg)}


def _init_hybrid_unit(init: Initializer, cfg: ModelConfig):
    """``shared_every`` stacked Mamba2 layers (the shared block lives
    outside the stack)."""
    return _stack([_init_mamba_layer(init, cfg) for _ in range(cfg.hybrid.shared_every)])


def _init_unit(init: Initializer, cfg: ModelConfig, kind: str):
    if kind == "xlstm":
        return _init_xlstm_unit(init, cfg)
    if kind == "hybrid":
        return _init_hybrid_unit(init, cfg)
    return _init_attn_block(init, cfg, kind == "attn_moe")


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (parameters or a cache): a
    cache (a NamedTuple) is sliced field by field, into views that the
    layer writes in place."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(x[i] for x in tree))
    return tree[i]


def init_lm(init: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    """All parameters (float32), drawn in the reference's order (a hybrid
    group's units, then its shared block); the tree mirrors the
    reference's ``init_lm`` leaf for leaf."""
    groups = []
    for g in _ported_plan(cfg):
        groups.append({"stacked": _stack([_init_unit(init, cfg, g.kind)
                                          for _ in range(g.count)])})
        if g.kind == "hybrid":
            groups[-1]["shared"] = _init_attn_block(init, cfg, use_moe=False)
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


# --------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------- #
def _tile(x: torch.Tensor, *n: int) -> torch.Tensor:
    """``x`` repeated along new leading axes ``n``: memory of its own for
    each copy, which the layers write in place."""
    return x.repeat(*n, *(1,) * x.dim())


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> List[Any]:
    """Decode caches, parallel to ``params['groups']``, on ``device``: a
    stacked ``AttnCache`` ``(layers, B, M, KV, hd)`` of zeros for an
    attention group; for a hybrid group ``{"mamba": SSMCache (units,
    shared_every, B, …), "attn": AttnCache (units, B, M, KV, hd)}`` (one
    attention cache for each invocation of the shared block); for an
    xLSTM group ``{"mlstm": MLSTMCache (units, slstm_every - 1, B, …),
    "slstm": SLSTMCache (units, B, …)}`` in the states' initial values
    (their conv windows in ``dtype``, the rest f32; ``max_len`` does not
    apply)."""
    caches: List[Any] = []
    for g in _ported_plan(cfg):
        if g.kind == "hybrid":
            m = init_ssm_cache(cfg, batch, dtype, device)
            a = init_attn_cache(cfg, batch, max_len, dtype, device)
            caches.append({"mamba": SSMCache(*(_tile(x, g.count, cfg.hybrid.shared_every)
                                               for x in m)),
                           "attn": AttnCache(*(_tile(x, g.count) for x in a))})
        elif g.kind == "xlstm":
            k = cfg.xlstm.slstm_every
            ml = init_mlstm_cache(cfg, batch, dtype, device)
            sl = init_slstm_cache(cfg, batch, dtype, device)
            caches.append({"mlstm": MLSTMCache(*(_tile(x, g.count, k - 1) for x in ml)),
                           "slstm": SLSTMCache(*(_tile(x, g.count) for x in sl))})
        else:
            one = init_attn_cache(cfg, batch, max_len, dtype, device)
            caches.append(AttnCache(*(_tile(x, g.count) for x in one)))
    return caches


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _attn_block_apply(params, cfg: ModelConfig, x, positions, cache, cache_len,
                      use_moe: bool, moe_dropless: bool = False,
                      positions_are_arange: bool = False):
    """One transformer block.  Returns ``(x, cache, aux)``."""
    h = rms_norm(params["norm1"], x, cfg.norm_eps)
    a, cache = attention(params["attn"], cfg, h, positions, cache, cache_len,
                         positions_are_arange=positions_are_arange)
    x = x + a
    h = rms_norm(params["norm2"], x, cfg.norm_eps)
    if use_moe:
        y, aux = moe(params["moe"], cfg, h, dropless=moe_dropless)
    else:
        y, aux = mlp(params["mlp"], h), None
    return x + y, cache, aux


def _attn_block_decode(params, cfg: ModelConfig, x, positions, cache, cache_len,
                       use_moe: bool):
    """Decode-step block; the cache slice is read-only.  Returns ``(x,
    (k_new, v_new))``: the caller appends every layer's new token after
    the loop.  MoE runs dropless here (decode must match the full
    forward)."""
    h = rms_norm(params["norm1"], x, cfg.norm_eps)
    a, k_new, v_new = attention_decode_readonly(params["attn"], cfg, h, positions,
                                                cache, cache_len)
    x = x + a
    h = rms_norm(params["norm2"], x, cfg.norm_eps)
    if use_moe:
        y, _ = moe(params["moe"], cfg, h, dropless=True)
    else:
        y = mlp(params["mlp"], h)
    return x + y, (k_new, v_new)


def _xlstm_unit_apply(params, cfg: ModelConfig, x, cache):
    """One xLSTM unit (mLSTM blocks, then the sLSTM block), prefill or a
    decode step alike; the unit's caches, if given, are written in place."""
    for j in range(cfg.xlstm.slstm_every - 1):
        c = None if cache is None else _layer(cache["mlstm"], j)
        x, _ = mlstm_block(_layer(params["mlstm"], j), cfg, x, c)
    x, _ = slstm_block(params["slstm"], cfg, x, None if cache is None else cache["slstm"])
    return x


def _hybrid_unit_apply(params, shared, cfg: ModelConfig, x, positions, cache, cache_len,
                       positions_are_arange: bool):
    """One hybrid unit: ``shared_every`` residual Mamba2 layers, then the
    shared attention+MLP block with the unit's own attention cache; the
    unit's caches, if given, are written in place."""
    for j in range(cfg.hybrid.shared_every):
        p = _layer(params, j)
        y, _ = mamba2(p["mamba"], cfg, rms_norm(p["norm"], x, cfg.norm_eps),
                      None if cache is None else _layer(cache["mamba"], j))
        x = x + y
    x, _, _ = _attn_block_apply(shared, cfg, x, positions,
                                None if cache is None else cache["attn"], cache_len,
                                False, positions_are_arange=positions_are_arange)
    return x


def _hybrid_unit_decode(params, shared, cfg: ModelConfig, x, positions, cache,
                        cache_len: int):
    """One hybrid unit's decode step: each Mamba2 layer's recurrent step
    (its state and window written in place), then the shared block on the
    unit's read-only attention cache.  Returns ``(x, (k_new, v_new))``."""
    for j in range(cfg.hybrid.shared_every):
        p = _layer(params, j)
        y, _ = mamba2_decode(p["mamba"], cfg, rms_norm(p["norm"], x, cfg.norm_eps),
                             _layer(cache["mamba"], j))
        x = x + y
    return _attn_block_decode(shared, cfg, x, positions, cache["attn"], cache_len, False)


def _widen_conv(cache: Dict[str, Any], compute_dtype: torch.dtype) -> None:
    """A hybrid group's stacked conv windows in the dtype the reference's
    decode concatenation gives them (bf16 windows under f32 compute come
    back f32 from its first step), replaced in the group's dict once, so
    that every layer's step writes its window in place."""
    m = cache["mamba"]
    wide = torch.promote_types(m.conv.dtype, compute_dtype)
    if m.conv.dtype != wide:
        cache["mamba"] = m._replace(conv=m.conv.to(wide))


def _append_tokens(cache: AttnCache, news, cache_len: int) -> AttnCache:
    """One write of the stacked ``(L, B, 1, KV, hd)`` new tokens per cache
    leaf: the only cache write of a decode step."""
    cache.k[:, :, cache_len:cache_len + 1] = news[0]
    cache.v[:, :, cache_len:cache_len + 1] = news[1]
    return cache


def _embed(params, tokens, embeds, compute_dtype):
    if embeds is not None:
        return embeds.to(compute_dtype)
    return torch.nn.functional.embedding(tokens.long(), params["embed"]).to(compute_dtype)


def _logits(params, cfg: ModelConfig, x, compute_dtype):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(compute_dtype), x


def lm_forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,     # (B, S) int
    embeds: Optional[torch.Tensor] = None,     # (B, S, D) — modality-stub input
    positions: Optional[torch.Tensor] = None,  # (B, S)
    caches: Optional[List[Any]] = None,        # from init_lm_caches (prime-for-decode)
    cache_len=None,                            # int — write offset
    compute_dtype: torch.dtype = torch.bfloat16,
    return_hidden: bool = False,
    moe_dropless: bool = False,
):
    """Full-sequence forward (prefill).

    Returns ``(logits, aux, new_caches[, hidden])``, the reference's
    tuple: ``aux`` is the summed MoE load-balance loss (0 without MoE
    blocks), ``new_caches`` the caches with this sequence's k/v written
    at ``cache_len`` and the recurrent states after it (None without
    ``caches``), ``hidden`` the
    final-normed hidden state.  The logits are computed even when only
    the hidden state is wanted, as in the reference.
    """
    plan = _ported_plan(cfg)
    x = _embed(params, tokens, embeds, compute_dtype)
    B, S = x.shape[:2]
    dev = x.device
    arange = positions is None
    if arange:
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    with ieee_f32(dev):
        for gi, g in enumerate(plan):
            stacked = params["groups"][gi]["stacked"]
            use_moe = g.kind == "attn_moe"
            for i in range(g.count):
                c = None if caches is None else _layer(caches[gi], i)
                if g.kind == "xlstm":
                    x = _xlstm_unit_apply(_layer(stacked, i), cfg, x, c)
                    continue
                if g.kind == "hybrid":
                    x = _hybrid_unit_apply(_layer(stacked, i), params["groups"][gi]["shared"],
                                           cfg, x, positions, c, cache_len, arange)
                    continue
                x, _, aux = _attn_block_apply(_layer(stacked, i), cfg, x, positions, c,
                                              cache_len, use_moe, moe_dropless, arange)
                if aux is not None:
                    aux_total = aux_total + aux
        logits, x = _logits(params, cfg, x, compute_dtype)
    new_caches = None if caches is None else list(caches)
    if return_hidden:
        return logits, aux_total, new_caches, x
    return logits, aux_total, new_caches


def lm_decode_step(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor],     # (B, 1) int (or embeds (B, 1, D))
    caches: List[Any],
    cache_len,                          # int — current length (write position)
    compute_dtype: torch.dtype = torch.bfloat16,
    embeds: Optional[torch.Tensor] = None,
):
    """One decode step.  Returns ``(logits (B, 1, V), caches)``: the new
    token's k/v appended to the attention caches at ``cache_len``, the
    recurrent states overwritten, in place.  xLSTM units run their
    prefill blocks at S = 1, as the reference's decode does, and take no
    position (``cache_len`` bounds only the attention caches).  Hybrid
    units run each Mamba2 layer's recurrent step, then the shared block;
    a bf16 conv window under f32 compute is widened to f32 in the group's
    dict (the reference's decode returns it so)."""
    plan = _ported_plan(cfg)
    x = _embed(params, tokens, embeds, compute_dtype)
    B = x.shape[0]
    cache_len = int(cache_len)
    for g, cache in zip(plan, caches):
        kv = cache["attn"] if g.kind == "hybrid" else cache
        if g.kind != "xlstm" and not 0 <= cache_len < kv.k.shape[2]:
            raise ValueError(f"a token at {cache_len} overruns caches of {kv.k.shape[2]}")
    positions = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    new_caches = []
    with ieee_f32(x.device):
        for gi, g in enumerate(plan):
            stacked, cache = params["groups"][gi]["stacked"], caches[gi]
            if g.kind == "xlstm":
                for i in range(g.count):
                    x = _xlstm_unit_apply(_layer(stacked, i), cfg, x, _layer(cache, i))
                new_caches.append(cache)
                continue
            hybrid = g.kind == "hybrid"
            if hybrid:
                _widen_conv(cache, compute_dtype)
            news = []
            for i in range(g.count):
                if hybrid:
                    x, new = _hybrid_unit_decode(_layer(stacked, i),
                                                 params["groups"][gi]["shared"], cfg, x,
                                                 positions, _layer(cache, i), cache_len)
                else:
                    x, new = _attn_block_decode(_layer(stacked, i), cfg, x, positions,
                                                _layer(cache, i), cache_len,
                                                g.kind == "attn_moe")
                news.append(new)
            _append_tokens(cache["attn"] if hybrid else cache,
                           [torch.stack(n) for n in zip(*news)], cache_len)
            new_caches.append(cache)
        logits, _ = _logits(params, cfg, x, compute_dtype)
    return logits, new_caches

"""The port's decode path on the CPU against ``repro.models``.

KV caches and the one-token decode step of the GQA attention archs:
``AttnCache``/``init_attn_cache``, ``attention(cache=...)`` (the new
k/v written at ``cache_len``, the dense masked softmax over the whole
cache), ``attention_decode_readonly`` (the two-segment softmax over the
read-only cache and the current token), ``init_lm_caches``,
``lm_forward(caches=...)`` and ``lm_decode_step``.  The reference's
parameters and its primed caches are carried across as numpy arrays
(``params_from_numpy``, ``caches_from_numpy``), so both packages decode
from the same state.  f32 at ``reduced()`` sizes; ``atol=1e-5`` (f32
sums in another order).  The reference's own ``test_decode_matches_full``
is the model: decode after a primed prefill matches the cache-less full
forward, here within 1e-5 (the reference's test allows 2e-3).
xlstm-350m's recurrent caches (``MLSTMCache``, ``SLSTMCache``) go
through the same steps, every field held against the reference's (the
states that grow with the sequence relative to their largest value,
1e-6), and cross packages with a bf16 conv window.  So do zamba2-2.7b's
hybrid caches (an ``SSMCache`` for each Mamba2 layer, an ``AttnCache``
for each invocation of the shared block); from the reference's bf16
caches its decode widens the conv windows to f32, as the reference's
does, and the two packages stay together over four steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import (
    AttnCache,
    MLSTMCache,
    SLSTMCache,
    SSMCache,
    caches_from_numpy,
    caches_to_numpy,
    init_attn_cache,
    init_lm,
    init_lm_caches,
    lm_decode_step,
    lm_forward,
    params_from_numpy,
)
from repro_torch.models import attention as tattn
from repro_torch.models.common import Initializer

CPU = "cpu"
ATOL = 1e-5
ATTN_ARCHS = ("qwen3-0.6b", "qwen2.5-3b", "codeqwen1.5-7b")
DECODE_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "musicgen-medium", "xlstm-350m",
                "zamba2-2.7b")
XLSTM = "xlstm-350m"
HYBRID = "zamba2-2.7b"
# a recurrent state's error, of its largest |value|: a block's state
# carries its own f32 rounding over every step (within 1e-6 for a block
# alone, tests/test_torch_xlstm.py) and its input's, which the blocks
# before it moved (measured 2.5e-6 of the sLSTM cell's largest |c|)
RTOL_STATE = 1e-5


def _cfgs(arch):
    return jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _caches_close(got, want):
    """Every field of every cache (``caches_to_numpy`` output against the
    reference's numpy caches): k/v within ``ATOL``, recurrent states
    within ``RTOL_STATE`` of their largest |value|."""
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert set(g) == set(w)
            _caches_close([g[k] for k in sorted(g)], [w[k] for k in sorted(w)])
            continue
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            b = np.asarray(b, np.float32)
            tol = ATOL if isinstance(g, AttnCache) else RTOL_STATE * max(
                1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


def _attn_params(arch, seed=21):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = jattn.init_attention(jcommon.Initializer(jax.random.key(seed)), jcfg)
    jp = _np(jp)
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in jp:   # zeros and ones at init: make them count
            jp[k] = (jp[k] + 0.1 * rng.standard_normal(jp[k].shape)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp, CPU)


def _primed_cache(cfg, B, M, filled, seed):
    """A cache whose first ``filled`` positions hold seeded k/v, the rest
    zeros."""
    rng = np.random.default_rng(seed)
    shape = (B, M, cfg.n_kv_heads, cfg.resolved_head_dim)
    k, v = (np.zeros(shape, np.float32) for _ in range(2))
    k[:, :filled] = rng.standard_normal((B, filled) + shape[2:])
    v[:, :filled] = rng.standard_normal((B, filled) + shape[2:])
    return k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_mirror_the_reference(dtype):
    for arch in ("qwen3-0.6b", "olmoe-1b-7b"):
        jcfg, tcfg = _cfgs(arch)
        tdt = getattr(torch, dtype)
        one = init_attn_cache(tcfg, 3, 40, tdt, CPU)
        want = jattn.init_attn_cache(jcfg, 3, 40, getattr(jnp, dtype))
        assert isinstance(one, AttnCache)
        assert [tuple(x.shape) for x in one] == [tuple(x.shape) for x in want]
        assert all(x.dtype == tdt and not x.any() for x in one)
        got = init_lm_caches(tcfg, 3, 40, tdt, CPU)
        ref = jlm.init_lm_caches(jcfg, 3, 40, getattr(jnp, dtype))
        assert [[tuple(x.shape) for x in c] for c in got] == [
            [tuple(x.shape) for x in c] for c in ref]
    # the default is the reference's bf16
    assert init_lm_caches(tcfg, 1, 8, device=CPU)[0].k.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("filled,S", [(0, 7), (5, 3), (11, 1)])
def test_attention_with_cache_matches(arch, filled, S):
    """New k/v written at ``cache_len``, attention over the whole cache
    (M 16) masked at each query's position: output and cache."""
    jcfg, tcfg, jp, tp = _attn_params(arch)
    B, M = 2, 16
    k, v = _primed_cache(jcfg, B, M, filled, seed=filled + S)
    x = np.random.default_rng(22).standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(filled, filled + S, dtype=np.int32), (B, S)).copy()
    want, wc = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               jattn.AttnCache(jnp.asarray(k), jnp.asarray(v)),
                               jnp.int32(filled))
    cache = caches_from_numpy([(k, v)], CPU)[0]
    got, gc = tattn.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                              cache, filled)
    assert gc is cache                      # written in place
    _close(got, want)
    _close(gc.k, wc.k)
    _close(gc.v, wc.v)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("cache_len", [0, 1, 9, 15])
def test_attention_decode_readonly_matches(arch, cache_len):
    jcfg, tcfg, jp, tp = _attn_params(arch)
    B, M = 3, 16
    k, v = _primed_cache(jcfg, B, M, cache_len, seed=cache_len)
    x = np.random.default_rng(23).standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.full((B, 1), cache_len, np.int32)
    wy, wk, wv = jattn.attention_decode_readonly(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
        jattn.AttnCache(jnp.asarray(k), jnp.asarray(v)), jnp.int32(cache_len))
    cache = caches_from_numpy([(k, v)], CPU)[0]
    gy, gk, gv = tattn.attention_decode_readonly(tp, tcfg, torch.from_numpy(x),
                                                 torch.from_numpy(pos), cache, cache_len)
    _close(gy, wy)
    _close(gk, wk)
    _close(gv, wv)
    np.testing.assert_array_equal(cache.k.numpy(), k)     # read-only
    np.testing.assert_array_equal(cache.v.numpy(), v)


def test_attention_cache_overrun_raises():
    _, tcfg, _, tp = _attn_params("qwen3-0.6b")
    cache = init_attn_cache(tcfg, 1, 8, torch.float32, CPU)
    x = torch.zeros((1, 4, 64))
    pos = torch.arange(6, 10, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="overrun"):
        tattn.attention(tp, tcfg, x, pos, cache, 6)
    with pytest.raises(ValueError, match="cache_len"):
        tattn.attention(tp, tcfg, x, pos, cache, None)


# --------------------------------------------------------------------- #
# the LM: primed caches and decode steps
# --------------------------------------------------------------------- #
_REF = {}


def _ref_params(arch):
    if arch not in _REF:
        jcfg, _ = _cfgs(arch)
        _REF[arch] = jlm.init_lm(jax.random.key(1), jcfg)
    return _REF[arch]


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeddings":
        return "embeds", rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return "tokens", rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_lm_decode_matches_the_reference_and_the_full_forward(arch):
    """Prefill 9 tokens into caches of 24, then 3 decode steps: the
    primed caches and each step's logits against the reference's, and
    against the port's cache-less full forward (dropless MoE) at that
    position."""
    jcfg, tcfg = _cfgs(arch)
    jp = _ref_params(arch)
    tp = params_from_numpy(_np(jp), CPU)
    B, S, M, P = 2, 12, 24, 9
    key, inp = _inputs(jcfg, B, S, seed=24)
    f32 = dict(compute_dtype=jnp.float32)
    t32 = dict(compute_dtype=torch.float32)

    full, _, _ = lm_forward(tp, tcfg, **{key: torch.from_numpy(inp)}, moe_dropless=True,
                            **t32)
    wpre, _, wc = jlm.lm_forward(jp, jcfg, **{key: jnp.asarray(inp[:, :P])},
                                 caches=jlm.init_lm_caches(jcfg, B, M, jnp.float32),
                                 cache_len=jnp.int32(0), moe_dropless=True, **f32)
    caches = init_lm_caches(tcfg, B, M, torch.float32, CPU)
    gpre, _, gc = lm_forward(tp, tcfg, **{key: torch.from_numpy(inp[:, :P])},
                             caches=caches, cache_len=0, moe_dropless=True, **t32)
    assert len(gc) == len(wc) and gc[0] is caches[0]
    _close(gpre, wpre)
    _close(gpre, full[:, :P].detach().numpy())
    _caches_close(caches_to_numpy(gc), _np(wc))

    for pos in range(P, S):
        step = inp[:, pos:pos + 1]
        if key == "embeds":
            wl, wc = jlm.lm_decode_step(jp, jcfg, None, wc, jnp.int32(pos),
                                        embeds=jnp.asarray(step), **f32)
            gl, gc = lm_decode_step(tp, tcfg, None, gc, pos,
                                    embeds=torch.from_numpy(step), **t32)
        else:
            wl, wc = jlm.lm_decode_step(jp, jcfg, jnp.asarray(step), wc, jnp.int32(pos),
                                        **f32)
            gl, gc = lm_decode_step(tp, tcfg, torch.from_numpy(step), gc, pos, **t32)
        assert gl.shape == (B, 1, jcfg.vocab_size)
        _close(gl, wl)
        _close(gl[:, 0], full[:, pos].detach().numpy())
    _caches_close(caches_to_numpy(gc), _np(wc))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_lm_decode_from_the_reference_caches(arch):
    """The reference's primed caches carried across (``caches_from_numpy``):
    one decode step of each package from the same state, bf16 caches
    (the reference's default) with f32 compute."""
    jcfg, tcfg = _cfgs(arch)
    jp = _ref_params(arch)
    tp = params_from_numpy(_np(jp), CPU)
    B, M, P = 3, 16, 10
    toks = np.random.default_rng(25).integers(1, jcfg.vocab_size, (B, P + 1)).astype(np.int32)
    _, _, wc = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks[:, :P]),
                              caches=jlm.init_lm_caches(jcfg, B, M), cache_len=jnp.int32(0),
                              compute_dtype=jnp.float32, moe_dropless=True)
    ref_caches = _np(wc)
    caches = caches_from_numpy(ref_caches, CPU)
    assert caches[0].k.dtype == torch.bfloat16
    wl, wc2 = jlm.lm_decode_step(jp, jcfg, jnp.asarray(toks[:, P:]), wc, jnp.int32(P),
                                 compute_dtype=jnp.float32)
    gl, gc2 = lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, P:]), caches, P,
                             compute_dtype=torch.float32)
    _close(gl, wl)
    for got, want in zip(caches_to_numpy(gc2), _np(wc2)):
        assert got.k.dtype == np.float32       # bf16 widened, exactly
        for g, w in ((got.k, want.k.astype(np.float32)), (got.v, want.v.astype(np.float32))):
            np.testing.assert_array_equal(g[:, :, :P], w[:, :, :P])
            # the new token's k/v: f32 values a few 1e-7 apart may round to
            # neighbouring bf16 numbers (one step: 2^-7 of the value)
            np.testing.assert_allclose(g[:, :, P], w[:, :, P], rtol=2 ** -7, atol=1e-6)
            assert not g[:, :, P + 1:].any()


def test_lm_decode_runs_on_the_ports_own_params():
    """Caches primed by a bf16-compute prefill of the port's own params:
    a decode step is finite and near the f32 step."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    tp = init_lm(Initializer(torch.Generator().manual_seed(26), CPU), tcfg)
    toks = torch.from_numpy(np.random.default_rng(26).integers(1, 512, (2, 8)))
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        caches = init_lm_caches(tcfg, 2, 8, dt, CPU)
        _, _, caches = lm_forward(tp, tcfg, tokens=toks[:, :7], caches=caches, cache_len=0,
                                  compute_dtype=dt, moe_dropless=True)
        out[dt], _ = lm_decode_step(tp, tcfg, toks[:, 7:], caches, 7, compute_dtype=dt)
    lo, hi = out[torch.bfloat16].float(), out[torch.float32]
    assert out[torch.bfloat16].dtype == torch.bfloat16 and bool(torch.isfinite(lo).all())
    assert float((lo - hi).abs().max()) < 0.05 * float(hi.abs().max())
    with pytest.raises(ValueError, match="overruns"):
        lm_decode_step(tp, tcfg, toks[:, 7:], caches, 8)


# --------------------------------------------------------------------- #
# xlstm-350m: recurrent caches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_init_caches_mirror_the_reference(dtype):
    """``{"mlstm": MLSTMCache (units, k-1, B, ...), "slstm": SLSTMCache
    (units, B, ...)}``: the reference's shapes, dtypes and initial values
    (the sLSTM normalizer ones, the mLSTM stabilizer -1e30), each layer's
    state in memory of its own."""
    jcfg, tcfg = _cfgs(XLSTM)
    tdt = getattr(torch, dtype)
    got = init_lm_caches(tcfg, 3, 40, tdt, CPU)
    want = _np(jlm.init_lm_caches(jcfg, 3, 40, getattr(jnp, dtype)))
    assert len(got) == len(want) == 1
    assert isinstance(got[0]["mlstm"], MLSTMCache) and isinstance(got[0]["slstm"], SLSTMCache)
    for key in ("mlstm", "slstm"):
        for name, g, w in zip(got[0][key]._fields, got[0][key], want[0][key]):
            assert tuple(g.shape) == w.shape, name
            assert g.dtype == (tdt if name == "conv" else torch.float32), name
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
            assert g.is_contiguous() and 0 not in g.stride()   # no expanded views
    ml = got[0]["mlstm"]
    ml.C[0, 0].fill_(1.0)
    assert not ml.C[1].any() and not ml.C[0, 0, :1].eq(0).all()


def test_xlstm_decode_from_the_reference_caches():
    """The reference's primed xLSTM caches carried across, their conv
    windows in bf16 (the reference's default) as bits: one decode step of
    each package from the same state, logits and every field after it."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = _ref_params(XLSTM)
    tp = params_from_numpy(_np(jp), CPU)
    B, P = 3, 10
    toks = np.random.default_rng(27).integers(1, jcfg.vocab_size, (B, P + 1)).astype(np.int32)
    _, _, wc = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks[:, :P]),
                              caches=jlm.init_lm_caches(jcfg, B, 16), cache_len=jnp.int32(0),
                              compute_dtype=jnp.float32)
    ref_caches = _np(wc)
    caches = caches_from_numpy(ref_caches, CPU)
    assert caches[0]["mlstm"].conv.dtype == caches[0]["slstm"].conv.dtype == torch.bfloat16
    assert caches[0]["mlstm"].C.dtype == torch.float32
    back = caches_to_numpy(caches)
    for key in ("mlstm", "slstm"):
        for g, w in zip(back[0][key], ref_caches[0][key]):
            np.testing.assert_array_equal(g, w.astype(np.float32))   # exact both ways
    wl, wc2 = jlm.lm_decode_step(jp, jcfg, jnp.asarray(toks[:, P:]), wc, jnp.int32(P),
                                 compute_dtype=jnp.float32)
    gl, gc2 = lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, P:]), caches, P,
                             compute_dtype=torch.float32)
    _close(gl, wl)
    got, want = caches_to_numpy(gc2), _np(wc2)
    for key in ("mlstm", "slstm"):
        for name, g, w in zip(got[0][key]._fields, got[0][key], want[0][key]):
            w = w.astype(np.float32)
            if name == "conv":
                # the window's new row: f32 values a few 1e-7 apart may round
                # to neighbouring bf16 numbers (one step: 2^-7 of the value)
                np.testing.assert_array_equal(g[..., :-1, :], w[..., :-1, :])
                np.testing.assert_allclose(g[..., -1, :], w[..., -1, :], rtol=2 ** -7,
                                           atol=1e-6)
            else:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=RTOL_STATE * max(1.0, np.abs(w).max()))


def test_xlstm_decode_ignores_cache_len_and_runs_on_the_ports_own_params():
    """The recurrent caches have no length: decode takes any position (the
    reference's xLSTM decode ignores ``cache_len``); bf16 compute with
    bf16 windows stays near the f32 step."""
    _, tcfg = _cfgs(XLSTM)
    tp = init_lm(Initializer(torch.Generator().manual_seed(28), CPU), tcfg)
    toks = torch.from_numpy(np.random.default_rng(28).integers(1, 512, (2, 8)))
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        caches = init_lm_caches(tcfg, 2, 4, dt, CPU)
        _, _, caches = lm_forward(tp, tcfg, tokens=toks[:, :7], caches=caches, cache_len=0,
                                  compute_dtype=dt)
        out[dt], _ = lm_decode_step(tp, tcfg, toks[:, 7:], caches, 7, compute_dtype=dt)
    lo, hi = out[torch.bfloat16].float(), out[torch.float32]
    assert out[torch.bfloat16].dtype == torch.bfloat16 and bool(torch.isfinite(lo).all())
    assert float((lo - hi).abs().max()) < 0.05 * float(hi.abs().max())


# --------------------------------------------------------------------- #
# zamba2-2.7b: hybrid caches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_init_caches_mirror_the_reference(dtype):
    """``{"mamba": SSMCache (units, shared_every, B, ...), "attn":
    AttnCache (units, B, M, KV, hd)}``: the reference's shapes and dtypes
    (the SSD states f32, the conv windows and k/v in ``dtype``), zeros,
    each layer's and each invocation's in memory of its own."""
    jcfg, tcfg = _cfgs(HYBRID)
    tdt = getattr(torch, dtype)
    got = init_lm_caches(tcfg, 3, 40, tdt, CPU)
    want = _np(jlm.init_lm_caches(jcfg, 3, 40, getattr(jnp, dtype)))
    assert len(got) == len(want) == 1
    assert isinstance(got[0]["mamba"], SSMCache) and isinstance(got[0]["attn"], AttnCache)
    for key in ("mamba", "attn"):
        for name, g, w in zip(got[0][key]._fields, got[0][key], want[0][key]):
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            assert not g.any() and g.is_contiguous() and 0 not in g.stride()
    m = got[0]["mamba"]
    m.state[0, 0].fill_(1.0)
    assert not m.state[1].any() and not m.state[0, 1].any()


def test_hybrid_decode_from_the_reference_caches():
    """The reference's caches primed by a 10-token prefill, in bf16 (its
    default), carried across as bits; then four decode steps of each
    package, f32 compute: logits and every cache field after each step.
    From the first step both packages' conv windows are f32 (the
    reference's concatenation promotes them; the port widens the group's
    window once), the new columns unrounded, so the two stay together."""
    jcfg, tcfg = _cfgs(HYBRID)
    jp = _ref_params(HYBRID)
    tp = params_from_numpy(_np(jp), CPU)
    B, M, P, n = 3, 16, 10, 4
    toks = np.random.default_rng(29).integers(1, jcfg.vocab_size, (B, P + n)).astype(np.int32)
    _, _, wc = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks[:, :P]),
                              caches=jlm.init_lm_caches(jcfg, B, M), cache_len=jnp.int32(0),
                              compute_dtype=jnp.float32)
    ref_caches = _np(wc)
    caches = caches_from_numpy(ref_caches, CPU)
    assert caches[0]["mamba"].conv.dtype == caches[0]["attn"].k.dtype == torch.bfloat16
    assert caches[0]["mamba"].state.dtype == torch.float32
    back = caches_to_numpy(caches)
    for key in ("mamba", "attn"):
        for g, w in zip(back[0][key], ref_caches[0][key]):
            np.testing.assert_array_equal(g, w.astype(np.float32))   # exact both ways
    for pos in range(P, P + n):
        step = toks[:, pos:pos + 1]
        wl, wc = jlm.lm_decode_step(jp, jcfg, jnp.asarray(step), wc, jnp.int32(pos),
                                    compute_dtype=jnp.float32)
        gl, caches = lm_decode_step(tp, tcfg, torch.from_numpy(step), caches, pos,
                                    compute_dtype=torch.float32)
        _close(gl, wl)
        got, want = caches_to_numpy(caches), _np(wc)
        assert caches[0]["mamba"].conv.dtype == torch.float32
        assert want[0]["mamba"].conv.dtype == np.float32
        for name, g, w in zip(got[0]["mamba"]._fields, got[0]["mamba"], want[0]["mamba"]):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)
        for g, w in zip(got[0]["attn"], want[0]["attn"]):
            w = w.astype(np.float32)
            np.testing.assert_array_equal(g[:, :, :P], w[:, :, :P])
            # the new tokens' k/v: f32 values a few 1e-7 apart may round to
            # neighbouring bf16 numbers (one step: 2^-7 of the value)
            np.testing.assert_allclose(g[:, :, P:pos + 1], w[:, :, P:pos + 1], rtol=2 ** -7,
                                       atol=1e-6)
            assert not g[:, :, pos + 1:].any()


def test_hybrid_decode_runs_on_the_ports_own_params():
    """bf16 compute with bf16 caches (the windows stay bf16: nothing to
    widen) near the f32 run; a position past the attention caches
    raises."""
    _, tcfg = _cfgs(HYBRID)
    tp = init_lm(Initializer(torch.Generator().manual_seed(30), CPU), tcfg)
    toks = torch.from_numpy(np.random.default_rng(30).integers(1, 512, (2, 8)))
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        caches = init_lm_caches(tcfg, 2, 8, dt, CPU)
        _, _, caches = lm_forward(tp, tcfg, tokens=toks[:, :7], caches=caches, cache_len=0,
                                  compute_dtype=dt)
        out[dt], caches = lm_decode_step(tp, tcfg, toks[:, 7:], caches, 7, compute_dtype=dt)
        assert caches[0]["mamba"].conv.dtype == dt
    lo, hi = out[torch.bfloat16].float(), out[torch.float32]
    assert out[torch.bfloat16].dtype == torch.bfloat16 and bool(torch.isfinite(lo).all())
    assert float((lo - hi).abs().max()) < 0.05 * float(hi.abs().max())
    with pytest.raises(ValueError, match="overruns"):
        lm_decode_step(tp, tcfg, toks[:, 7:], caches, 8)

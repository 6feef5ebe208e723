"""The port's LM stack on the CPU against ``repro.models``.

The repo holds no pretrained weights and the two packages' RNGs never
draw the same numbers, so the reference's ``init_lm`` parameters (a
pytree made from a fixed ``jax.random.key``) are carried across as numpy
arrays (``repro_torch.models.params_from_numpy``), and the port's own
``init_lm`` parameters go the other way (``params_to_numpy``).  The same
numpy-seeded inputs then go through both packages in f32 at
``reduced()`` sizes (d_model 64, 4 layers, vocab 512).  Tolerances: f32
sums in another order, ``atol=1e-5`` (2e-5 for the flash route, flash's
f32 tolerance) on values of magnitude up to ~10.

Above 1,024 tokens the reference's attention runs
``chunked_causal_attention``; the port runs the flash kernel's plain
version there (positions ``arange(S)``) and its own
``chunked_causal_attention`` for explicit positions: both are held to
the reference's function.  xlstm-350m's tree, ``param_count`` and
forward are held here (its blocks in ``tests/test_torch_xlstm.py``,
within ``XLSTM_ATOL``), and so are zamba2-2.7b's (its Mamba2 layer in
``tests/test_torch_ssm.py``): the tree with its unstacked shared block,
``param_count``, ``lm_forward`` in f32 and bf16 with and without primed
caches, and the shared block on the flash route above 1,024 tokens; the
MLA arch raises ``NotImplementedError`` naming ROADMAP item 9b; the MoE
block kind and the decode path are held in ``tests/test_torch_moe.py``
and ``tests/test_torch_decode.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.models import (
    init_lm,
    init_lm_caches,
    lm_decode_step,
    lm_forward,
    make_plan,
    param_count,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import attention as tattn
from repro_torch.models.common import (
    Initializer,
    apply_rope,
    dense_init,
    rms_norm,
    rope_angles,
)
from repro_torch.models.mlp import mlp

CPU = "cpu"
ATOL = 1e-5
FLASH_ATOL = 2e-5
DENSE_ARCHS = ("qwen3-0.6b", "qwen2.5-3b", "codeqwen1.5-7b", "deepseek-coder-33b",
               "chameleon-34b", "musicgen-medium")
OTHER_ARCHS = ("deepseek-v3-671b",)
XLSTM = "xlstm-350m"
HYBRID = "zamba2-2.7b"
# xlstm-350m's hidden state: four recurrent blocks in a row, each within
# ~1e-6 of the reference at its output's scale, compound (measured 8.6e-6
# on |h| up to 3.5 at 2 x 40 tokens)
XLSTM_ATOL = 2e-5


def _cfgs(arch):
    return jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


# --------------------------------------------------------------------- #
# configs: a copy of the reference's data
# --------------------------------------------------------------------- #
def test_configs_copy_agrees():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for name, cfg in tconfigs.ARCHS.items():
        want = jconfigs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(want.reduced())
        assert (cfg.resolved_head_dim, cfg.block_kind, cfg.subquadratic) == (
            want.resolved_head_dim, want.block_kind, want.subquadratic)
        assert make_plan(cfg) == [tuple(g) for g in jlm.make_plan(want)]
    got = [(c.name, s.name, ok, why) for c, s, ok, why in tconfigs.cells()]
    assert got == [(c.name, s.name, ok, why) for c, s, ok, why in jconfigs.cells()]
    with pytest.raises(KeyError):
        tconfigs.get_config("nope")


# --------------------------------------------------------------------- #
# components
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm_matches(eps):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3.0
    w = rng.standard_normal(16).astype(np.float32)
    _close(rms_norm(torch.from_numpy(w), torch.from_numpy(x), eps),
           jcommon.rms_norm(jnp.asarray(w), jnp.asarray(x), eps))


@pytest.mark.parametrize("theta,dim", [(10_000.0, 16), (1_000_000.0, 128)])
def test_rope_matches(theta, dim):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, dim)).astype(np.float32)
    tc, ts = rope_angles(torch.from_numpy(pos), dim, theta)
    jc, js = jcommon.rope_angles(jnp.asarray(pos), dim, theta)
    # angles up to 5,000 rad: cos/sin of f32 arguments agree to ~1e-6
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    _close(apply_rope(torch.from_numpy(x), tc, ts),
           jcommon.apply_rope(jnp.asarray(x), jc, js), 1e-5)


def test_dense_init_is_a_truncated_normal():
    init = Initializer(torch.Generator().manual_seed(3), CPU)
    w = dense_init(init, (256, 512))
    std = 256 ** -0.5
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert float(w.abs().max()) <= 2.0 * std
    # a normal truncated at ±2σ has std 0.8796σ
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    # the same generator seed draws the same parameters
    again = dense_init(Initializer(torch.Generator().manual_seed(3), CPU), (256, 512))
    assert torch.equal(w, again)


def test_mlp_matches():
    init = jcommon.Initializer(jax.random.key(4))
    jp, _ = jmlp.init_mlp(init, 64, 128)
    x = np.random.default_rng(4).standard_normal((2, 9, 64)).astype(np.float32)
    _close(mlp(params_from_numpy(_np(jp), CPU), torch.from_numpy(x)),
           jmlp.mlp(jp, jnp.asarray(x)))


def _attn_params(arch, seed=5):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = jattn.init_attention(jcommon.Initializer(jax.random.key(seed)), jcfg)
    jp = _np(jp)
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in jp:   # zeros and ones at init: make them count
            jp[k] = (jp[k] + 0.1 * rng.standard_normal(jp[k].shape)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp, CPU)


def _x(S, B=2, d=64, seed=6):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-3b", "codeqwen1.5-7b"])
@pytest.mark.parametrize("S,offset", [(33, 0), (128, 0), (1024, 0), (40, 17)])
def test_attention_dense_path_matches(arch, S, offset):
    """S ≤ 1024: the masked softmax over (B, S, KV, G, S) scores, with
    qk_norm (qwen3), qkv bias (qwen2.5, codeqwen) and MHA (codeqwen);
    positions from 0 or from an offset."""
    jcfg, tcfg, jp, tp = _attn_params(arch)
    B = 1 if S == 1024 else 2
    x = _x(S, B)
    pos = np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32), (B, S)).copy()
    want, _ = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, cache = tattn.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                 positions_are_arange=offset == 0)
    assert cache is None
    _close(got, want)


def test_attention_above_1024_takes_flash_and_matches_chunked(monkeypatch):
    """S 1,100 with positions arange(S): the flash route (its plain
    version on the CPU, no kernel launch) against the reference's
    ``chunked_causal_attention``."""
    jcfg, tcfg, jp, tp = _attn_params("qwen3-0.6b")
    S = 1100
    x = _x(S, B=1)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tflash.flash_attention_kernel_call.launches = 0
    calls = []
    real = tflash.flash_attention_plain
    monkeypatch.setattr(tflash, "flash_attention_plain",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    got, _ = tattn.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                             positions_are_arange=True)
    # (B, H, S padded to 128-row blocks, hd 16 padded to the kernel's 32)
    assert calls == [(1, 4, 1152, 32)]
    assert tflash.flash_attention_kernel_call.launches == 0
    _close(got, want, FLASH_ATOL)


def test_attention_above_1024_explicit_positions_run_chunked(monkeypatch):
    """Explicit positions above 1,024 keep the port's chunked online
    softmax: the flash route is not taken."""
    jcfg, tcfg, jp, tp = _attn_params("qwen2.5-3b")
    S = 1152
    x = _x(S, B=1)
    pos = np.arange(S, dtype=np.int32)[None] + 3
    want, _ = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    monkeypatch.setattr(tflash, "flash_attention_plain", None)   # a call would fail
    got, _ = tattn.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("S,qc", [(2048, 512), (768, 256)])
def test_chunked_causal_attention_matches(S, qc):
    rng = np.random.default_rng(S)
    B, H, KV, hd = 1, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v, pos, pos[0])),
                                          hd ** -0.5, q_chunk=qc, kv_chunk=qc)
    got = tattn.chunked_causal_attention(*map(torch.from_numpy, (q, k, v, pos, pos[0])),
                                         hd ** -0.5, q_chunk=qc, kv_chunk=qc)
    _close(got, want)


# --------------------------------------------------------------------- #
# the whole forward pass
# --------------------------------------------------------------------- #
_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        jcfg, _ = _cfgs(arch)
        _REF_PARAMS[arch] = jlm.init_lm(jax.random.key(7), jcfg)
    return _REF_PARAMS[arch]


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(np.shape(x)), tree)


@pytest.mark.parametrize("arch", DENSE_ARCHS + (XLSTM, HYBRID))
def test_init_lm_mirrors_the_reference_tree(arch):
    jcfg, tcfg = _cfgs(arch)
    got = params_to_numpy(init_lm(Initializer(torch.Generator().manual_seed(0), CPU),
                                  tcfg))
    assert _shapes(got) == _shapes(_np(_ref_params(arch)))
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(got))
    assert param_count(tcfg) == jlm.param_count(jcfg)
    assert param_count(tconfigs.get_config(arch)) == jlm.param_count(
        jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lm_forward_matches(arch):
    """Hidden state and logits, f32, from the reference's parameters:
    tokens for every arch, and embeddings for the two whose frontend is a
    stub (chameleon, musicgen)."""
    jcfg, tcfg = _cfgs(arch)
    jp = _ref_params(arch)
    tp = params_from_numpy(_np(jp), CPU)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, jcfg.vocab_size, (2, 40)).astype(np.int32)
    wl, _, wc, wh = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                   compute_dtype=jnp.float32, return_hidden=True)
    gl, aux, gc, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                                 compute_dtype=torch.float32, return_hidden=True)
    assert gc is None and wc is None and float(aux) == 0.0
    assert gl.shape == (2, 40, jcfg.vocab_size) and gh.shape == (2, 40, 64)
    _close(gh, wh)
    _close(gl, wl)
    if jcfg.input_kind == "embeddings":
        emb = rng.standard_normal((2, 24, 64)).astype(np.float32)
        wl, _, _ = jlm.lm_forward(jp, jcfg, embeds=jnp.asarray(emb),
                                  compute_dtype=jnp.float32)
        gl, _, _ = lm_forward(tp, tcfg, embeds=torch.from_numpy(emb),
                              compute_dtype=torch.float32)
        _close(gl, wl)


def test_lm_forward_explicit_positions_and_round_trip():
    """The port's own parameters carried to the reference (the other
    direction), with explicit positions."""
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    tp = init_lm(Initializer(torch.Generator().manual_seed(9), CPU), tcfg)
    back = params_to_numpy(tp)
    again = params_to_numpy(params_from_numpy(back, CPU))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(9)
    toks = rng.integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    pos = (np.arange(16, dtype=np.int32)[None] + np.array([[0], [5]], np.int32))
    wl, _, _ = jlm.lm_forward(jax.tree.map(jnp.asarray, back), jcfg,
                              tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                              compute_dtype=jnp.float32)
    gl, _, _ = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                          positions=torch.from_numpy(pos), compute_dtype=torch.float32)
    _close(gl, wl)


def test_lm_forward_bf16_runs():
    """bf16 compute keeps the reference's casts: logits in bf16, close to
    the f32 forward's."""
    _, tcfg = _cfgs("qwen3-0.6b")
    tp = params_from_numpy(_np(_ref_params("qwen3-0.6b")), CPU)
    toks = torch.from_numpy(np.random.default_rng(10).integers(1, 512, (2, 12)))
    lo, _, _ = lm_forward(tp, tcfg, tokens=toks)
    hi, _, _ = lm_forward(tp, tcfg, tokens=toks, compute_dtype=torch.float32)
    assert lo.dtype == torch.bfloat16
    assert float((lo.float() - hi).abs().max()) < 0.05 * float(hi.abs().max())


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_block_kinds_raise(arch):
    _, tcfg = _cfgs(arch)
    with pytest.raises(NotImplementedError, match="9b"):
        init_lm(Initializer(torch.Generator(), CPU), tcfg)
    with pytest.raises(NotImplementedError, match="9b"):
        lm_forward({}, tcfg, tokens=torch.ones((1, 4), dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="9b"):
        param_count(tcfg)
    with pytest.raises(NotImplementedError, match="9b"):
        init_lm_caches(tcfg, 1, 8, device=CPU)
    with pytest.raises(NotImplementedError, match="9b"):
        lm_decode_step({}, tcfg, torch.ones((1, 1), dtype=torch.int64), [], 0)


# --------------------------------------------------------------------- #
# xlstm-350m
# --------------------------------------------------------------------- #
def test_xlstm_tree_and_param_count():
    """Each unit stacks ``slstm_every - 1`` mLSTM blocks beside one sLSTM
    block, and the group stacks the units: mLSTM leaves ``(units, k-1,
    ...)``, sLSTM leaves ``(units, ...)``; the published size's count."""
    jcfg, tcfg = _cfgs(XLSTM)
    full = tconfigs.get_config(XLSTM)
    assert param_count(full) == jlm.param_count(jconfigs.get_config(XLSTM)) == 528_351_400
    for cfg in (tcfg, full):
        tree = init_lm(Initializer(device="meta"), cfg)
        units, k = cfg.n_layers // cfg.xlstm.slstm_every, cfg.xlstm.slstm_every
        stacked = tree["groups"][0]["stacked"]
        assert set(stacked) == {"mlstm", "slstm"}
        di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
        assert tuple(stacked["mlstm"]["w_q"].shape) == (units, k - 1, di, di)
        assert tuple(stacked["slstm"]["r_z"].shape) == (
            units, cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model // cfg.n_heads)
    got = params_to_numpy(init_lm(Initializer(torch.Generator().manual_seed(1), CPU), tcfg))
    again = params_to_numpy(params_from_numpy(got, CPU))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["groups"][0]["stacked"]["mlstm"]["b_f"][0, 0],
                                  np.asarray(_ref_params(XLSTM)["groups"][0]["stacked"]
                                             ["mlstm"]["b_f"][0, 0]))


@pytest.mark.parametrize("B,S", [(2, 40), (1, 320)])
def test_xlstm_lm_forward_matches(B, S):
    """Hidden state and logits from the reference's parameters, f32: one
    mLSTM chunk of 40, and five chunks of 64 over 320 tokens."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = _ref_params(XLSTM)
    tp = params_from_numpy(_np(jp), CPU)
    toks = np.random.default_rng(30 + S).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    wl, waux, wc, wh = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                      compute_dtype=jnp.float32, return_hidden=True)
    gl, aux, gc, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                                 compute_dtype=torch.float32, return_hidden=True)
    assert gc is None and wc is None and float(aux) == float(waux) == 0.0
    assert gl.shape == (B, S, jcfg.vocab_size) and gh.shape == (B, S, 64)
    _close(gh, wh, XLSTM_ATOL)
    _close(gl, wl)


def test_xlstm_round_trip_to_the_reference():
    """The port's own xLSTM parameters carried to the reference."""
    jcfg, tcfg = _cfgs(XLSTM)
    tp = init_lm(Initializer(torch.Generator().manual_seed(31), CPU), tcfg)
    back = params_to_numpy(tp)
    toks = np.random.default_rng(31).integers(1, jcfg.vocab_size, (2, 24)).astype(np.int32)
    wl, _, _, wh = jlm.lm_forward(jax.tree.map(jnp.asarray, back), jcfg,
                                  tokens=jnp.asarray(toks), compute_dtype=jnp.float32,
                                  return_hidden=True)
    gl, _, _, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                              compute_dtype=torch.float32, return_hidden=True)
    _close(gh, wh, XLSTM_ATOL)
    _close(gl, wl)


def test_xlstm_bf16_runs():
    """bf16 compute: the blocks' cores stay f32, the logits come out bf16
    and close to the f32 forward's."""
    _, tcfg = _cfgs(XLSTM)
    tp = params_from_numpy(_np(_ref_params(XLSTM)), CPU)
    toks = torch.from_numpy(np.random.default_rng(32).integers(1, 512, (2, 12)))
    lo, _, _ = lm_forward(tp, tcfg, tokens=toks)
    hi, _, _ = lm_forward(tp, tcfg, tokens=toks, compute_dtype=torch.float32)
    assert lo.dtype == torch.bfloat16 and bool(torch.isfinite(lo.float()).all())
    assert float((lo.float() - hi).abs().max()) < 0.05 * float(hi.abs().max())


# --------------------------------------------------------------------- #
# zamba2-2.7b: the Mamba2 hybrid
# --------------------------------------------------------------------- #
def test_hybrid_tree_and_param_count():
    """Each unit stacks ``shared_every`` Mamba2 layers (leaves ``(units,
    shared_every, ...)``); the shared attention+MLP block sits beside the
    stack, unstacked; the published size's count (the shared block's
    105 M parameters counted once); the tree round trip, the shared block
    included, and its deterministic leaves the reference's."""
    jcfg, tcfg = _cfgs(HYBRID)
    full = tconfigs.get_config(HYBRID)
    assert param_count(full) == jlm.param_count(jconfigs.get_config(HYBRID)) == 2_422_670_240
    for cfg in (tcfg, full):
        group = init_lm(Initializer(device="meta"), cfg)["groups"][0]
        units, k = cfg.n_layers // cfg.hybrid.shared_every, cfg.hybrid.shared_every
        assert set(group) == {"stacked", "shared"}
        assert set(group["stacked"]) == {"norm", "mamba"}
        d_inner = cfg.ssm.expand * cfg.d_model
        assert tuple(group["stacked"]["mamba"]["w_out"].shape) == (units, k, d_inner,
                                                                   cfg.d_model)
        assert tuple(group["shared"]["attn"]["wq"].shape) == (
            cfg.d_model, cfg.n_heads, cfg.resolved_head_dim)
    got = params_to_numpy(init_lm(Initializer(torch.Generator().manual_seed(2), CPU), tcfg))
    again = params_to_numpy(params_from_numpy(got, CPU))
    assert _shapes(again) == _shapes(got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    want = _np(_ref_params(HYBRID))["groups"][0]
    for path in (("stacked", "mamba", "D"), ("stacked", "norm"), ("shared", "norm1")):
        g, w = got["groups"][0], want
        for key in path:
            g, w = g[key], w[key]
        np.testing.assert_array_equal(g, w)


# bf16 compute, of the largest |value|: the port rounds where the
# reference's ops round (a Mamba2 layer within an ulp of the reference
# run op by op, tests/test_torch_ssm.py), but the reference's lm_forward
# runs its layers inside lax.scan, compiled, where XLA fuses elementwise
# steps and skips their rounding: its own jitted and op-by-op layers
# differ in half their outputs by an ulp, and that compounds over the
# four layers and two shared blocks (measured 1.7e-2 of the largest
# |logit|, 1.6e-2 of the largest |hidden|, 1.9e-2 of the largest cached k)
HYBRID_BF16_RTOL = 2.0 ** -5


def _hybrid_forward(dtype, cached, S=64, B=2, seed=40):
    """Both packages' ``lm_forward`` on the reference's parameters, with
    caches of 80 primed by this prefill or none: ``(port's (logits,
    hidden, caches), reference's)``."""
    jcfg, tcfg = _cfgs(HYBRID)
    jp = _ref_params(HYBRID)
    tp = params_from_numpy(_np(jp), CPU)
    toks = np.random.default_rng(seed).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = dict(caches=jlm.init_lm_caches(jcfg, B, 80, jdt), cache_len=jnp.int32(0)) \
        if cached else {}
    tkw = dict(caches=init_lm_caches(tcfg, B, 80, tdt, CPU), cache_len=0) if cached else {}
    wl, waux, wc, wh = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks), compute_dtype=jdt,
                                      return_hidden=True, **jkw)
    gl, aux, gc, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks), compute_dtype=tdt,
                                 return_hidden=True, **tkw)
    assert float(aux) == float(waux) == 0.0
    assert gl.dtype == tdt and gl.shape == (B, S, jcfg.vocab_size) and gh.shape == (B, S, 64)
    return (gl, gh, gc), (wl, wh, wc)


@pytest.mark.parametrize("cached", [False, True])
def test_hybrid_lm_forward_matches(cached):
    """Hidden state and logits from the reference's parameters, f32, 2 x
    64 tokens (two SSD chunks of 32 a layer, two units of two Mamba2
    layers and the shared block): without caches, and priming empty f32
    caches, whose every field is held too (the SSD states and conv
    windows, and each invocation's k/v).  Measured within 4.3e-6."""
    (gl, gh, gc), (wl, wh, wc) = _hybrid_forward("float32", cached)
    _close(gh, wh)
    _close(gl, wl)
    if not cached:
        assert gc is None and wc is None
        return
    got, want = gc[0], _np(wc[0])
    assert set(got) == set(want) == {"mamba", "attn"}
    for key in ("mamba", "attn"):
        for name, g, w in zip(got[key]._fields, got[key], want[key]):
            assert tuple(g.shape) == w.shape, name
            _close(g, w)


def _close_bf16(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=HYBRID_BF16_RTOL * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_hybrid_lm_forward_bf16_matches(cached):
    """bf16 compute (bf16 caches when primed): logits and hidden state in
    bf16, and every cache field, within ``HYBRID_BF16_RTOL`` of the
    reference's largest |value|; the conv windows stay bf16 and the SSD
    states f32, as the reference's do."""
    (gl, gh, gc), (wl, wh, wc) = _hybrid_forward("bfloat16", cached, seed=41)
    assert gh.dtype == torch.bfloat16
    _close_bf16(gl, wl.astype(jnp.float32))
    _close_bf16(gh, wh.astype(jnp.float32))
    if not cached:
        return
    got, want = gc[0], wc[0]
    assert got["mamba"].conv.dtype == got["attn"].k.dtype == torch.bfloat16
    assert got["mamba"].state.dtype == torch.float32
    for key in ("mamba", "attn"):
        for name, g, w in zip(got[key]._fields, got[key], want[key]):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            _close_bf16(g, w.astype(jnp.float32))


def test_hybrid_shared_block_takes_flash_above_1024(monkeypatch):
    """1,056 tokens (33 SSD chunks of 32) with positions arange(S): each
    of the two invocations of the shared block takes the flash route (its
    plain version on the CPU, no kernel launch), held with the whole
    forward to the reference's ``chunked_causal_attention`` path
    (measured 4.5e-6)."""
    jcfg, tcfg = _cfgs(HYBRID)
    jp = _ref_params(HYBRID)
    tp = params_from_numpy(_np(jp), CPU)
    S = 1056
    toks = np.random.default_rng(42).integers(1, jcfg.vocab_size, (1, S)).astype(np.int32)
    wl, _, _, wh = jlm.lm_forward(jp, jcfg, tokens=jnp.asarray(toks),
                                  compute_dtype=jnp.float32, return_hidden=True)
    tflash.flash_attention_kernel_call.launches = 0
    calls = []
    real = tflash.flash_attention_plain
    monkeypatch.setattr(tflash, "flash_attention_plain",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    gl, _, _, gh = lm_forward(tp, tcfg, tokens=torch.from_numpy(toks),
                              compute_dtype=torch.float32, return_hidden=True)
    # (B, H, S padded to 128-row blocks, hd 16 padded to the kernel's 32)
    assert calls == [(1, 4, 1152, 32)] * 2
    assert tflash.flash_attention_kernel_call.launches == 0
    _close(gh, wh, FLASH_ATOL)
    _close(gl, wl, FLASH_ATOL)

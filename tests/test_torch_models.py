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
the reference's function.  The MLA, hybrid and xLSTM archs raise
``NotImplementedError`` naming ROADMAP item 9b; the MoE block kind and
the decode path are held in ``tests/test_torch_moe.py`` and
``tests/test_torch_decode.py``.
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
OTHER_ARCHS = ("deepseek-v3-671b", "zamba2-2.7b", "xlstm-350m")


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


@pytest.mark.parametrize("arch", DENSE_ARCHS)
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

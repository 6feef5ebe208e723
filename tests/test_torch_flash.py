"""The port's flash attention against the JAX package.

The same numpy-seeded q, k, v go through ``repro.kernels.flash_attention``
(the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it, and its naive ``attention_ref``) and through ``repro_torch``'s
``flash_attention(device="cpu")``, whose kernel wrapper runs the plain
PyTorch version on a CPU tensor.  Tolerances are the reference test's:
``atol=2e-5`` in f32 (f32 sums in another order) and ``3e-2`` in bf16
(the output is rounded to bf16, whose spacing is 2**-7 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro_torch.kernels import flash_attention as t_export
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

CPU = "cpu"
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, H, Hkv, Sq, Sk, Dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, Dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, Dh)).astype(np.float32))


def _both(arrays, dtype):
    """The same values in both packages (bf16 rounds the same way in both)."""
    j = [jnp.asarray(a, J_DTYPE[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(T_DTYPE[dtype]) for a in arrays]
    return j, t


def _close(got: torch.Tensor, want, dtype):
    assert got.dtype == T_DTYPE[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("B,H,Hkv,S,Dh", [
    (1, 4, 4, 128, 64), (2, 8, 2, 128, 64), (1, 4, 1, 256, 32),
    (2, 6, 3, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, H, Hkv, S, Dh, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B * 100 + S + Dh, B, H, Hkv, S, S, Dh), dtype)
    want_kernel = j_flash_attention(jq, jk, jv, block_q=64, block_k=64)
    want_ref = j_attention_ref(jq, jk, jv, sm_scale=Dh ** -0.5, causal=True)
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64, device=CPU)
    assert got.shape == (B, H, S, Dh)
    _close(got, want_kernel, dtype)
    _close(got, want_ref, dtype)
    plain = tkernel.flash_attention_plain(tq, tk, tv, sm_scale=Dh ** -0.5,
                                          causal=True, block_q=64, block_k=64)
    assert torch.equal(plain, got)   # a CPU tensor runs the plain version
    _close(attention_ref(tq, tk, tv, sm_scale=Dh ** -0.5, causal=True), want_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_unaligned_seq(dtype):
    """S = 100 at block 32: padded to 128 rows, the padded keys masked by
    the causal structure."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(100, 1, 2, 2, 100, 100, 64), dtype)
    want = j_flash_attention(jq, jk, jv, block_q=32, block_k=32)
    got = flash_attention(tq, tk, tv, block_q=32, block_k=32, device=CPU)
    _close(got, want, dtype)
    _close(got, j_attention_ref(jq, jk, jv, sm_scale=0.125, causal=True), dtype)


@pytest.mark.parametrize("S,block,routed_to_ref", [(128, 64, False), (100, 32, True)])
def test_flash_attention_non_causal(monkeypatch, S, block, routed_to_ref):
    """Aligned kv runs the kernel's path; padded kv takes the reference's
    own route to the naive attention."""
    calls = []
    real = tops.flash_attention_kernel_call
    monkeypatch.setattr(tops, "flash_attention_kernel_call",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S, 1, 4, 2, S, S, 64), "float32")
    want = j_flash_attention(jq, jk, jv, causal=False, block_q=block, block_k=block)
    got = flash_attention(tq, tk, tv, causal=False, block_q=block, block_k=block,
                          device=CPU)
    _close(got, want, "float32")
    _close(got, j_attention_ref(jq, jk, jv, sm_scale=0.125, causal=False), "float32")
    assert calls == ([] if routed_to_ref else [1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_zero_pad(monkeypatch, dtype):
    """Dh = 80 runs at the kernel's 128 with zero columns, sliced off."""
    widths = []
    real = tkernel.flash_attention_plain
    monkeypatch.setattr(tkernel, "flash_attention_plain",
                        lambda q, *a, **kw: widths.append(q.shape[-1]) or real(q, *a, **kw))
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(80, 1, 4, 2, 96, 96, 80), dtype)
    want = j_flash_attention(jq, jk, jv, block_q=64, block_k=64)
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64, device=CPU)
    assert got.shape == (1, 4, 96, 80)
    _close(got, want, dtype)
    assert widths == [128]


@pytest.mark.parametrize("dh,width", [(1, 32), (32, 32), (33, 64), (80, 128),
                                      (128, 128), (200, 256), (256, 256),
                                      (257, 384), (320, 384), (512, 512)])
def test_kernel_head_dim(dh, width):
    assert tkernel.kernel_head_dim(dh) == width


@pytest.mark.parametrize("dtype,dh,route", [
    ("bfloat16", 32, "bf16_wgmma"), ("bfloat16", 128, "bf16_wgmma"),
    ("bfloat16", 256, "bf16_wgmma"), ("bfloat16", 512, "bf16_wgmma"),
    ("float32", 1, "f32_3xtf32"), ("float32", 32, "f32_3xtf32"), ("float32", 64, "f32_3xtf32"),
    ("float32", 80, "f32_3xtf32"), ("float32", 128, "f32_3xtf32"),
    ("float32", 200, "f32_cuda_cores"), ("float32", 256, "f32_cuda_cores"),
    ("float32", 320, "f32_cuda_cores"), ("float32", 512, "f32_cuda_cores"),
])
def test_kernel_route(dtype, dh, route):
    """The kernel that runs each head dim: the launch's widths after the
    wrapper's padding and column slicing.  f32 keeps the CUDA-core kernel
    at 256 and in column slices; every bf16 width runs on the tensor cores."""
    width = tkernel.kernel_head_dim(dh)
    per_launch = width if width in tkernel.KERNEL_HEAD_DIMS else tkernel.SLICE
    assert tkernel.kernel_route(T_DTYPE[dtype], width, per_launch) == route
    assert tkernel.ROUTES[route] in (0, 1, 2)


@pytest.mark.parametrize("B,Hkv,Sk,dh,floats", [
    (1, 8, 4096, 128, 4 * 8 * 4096 * 128),    # qwen3-0.6b's kv heads: 64 MiB
    (2, 3, 100, 64, 4 * 2 * 3 * 128 * 64),    # padded to whole kv tiles of 64
    (1, 1, 1, 32, 4 * 64 * 32),
])
def test_tf32_workspace(B, Hkv, Sk, dh, floats):
    """k's and v's hi and lo parts, padded to whole kv tiles."""
    assert tkernel.tf32_workspace(B, Hkv, Sk, dh) == floats


def test_flash_f32_many_kv_tiles_matches_pallas_interpret():
    """f32 over 16 kv tiles of the reference's blocks of 64 (S 512, so
    the kernel's kv tiles of 32 run 16 in a row): the running max, its
    rescaling and the causal skip, held at the file's f32 tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(512, 1, 4, 2, 512, 512, 128), "float32")
    want = j_flash_attention(jq, jk, jv, block_q=64, block_k=64)
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64, device=CPU)
    _close(got, want, "float32")
    _close(got, j_attention_ref(jq, jk, jv, sm_scale=128 ** -0.5, causal=True), "float32")


@pytest.mark.parametrize("Dh", [320, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_wide_head_dims_match_reference(monkeypatch, Dh, dtype):
    """Head dims above 256 run padded to a multiple of 128, in column
    slices of 128 output columns, each over the whole q·kᵀ."""
    widths = []
    real = tkernel.flash_attention_plain
    monkeypatch.setattr(tkernel, "flash_attention_plain",
                        lambda q, k, v, **kw: widths.append((q.shape[-1], v.shape[-1]))
                        or real(q, k, v, **kw))
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Dh, 1, 4, 2, 96, 96, Dh), dtype)
    want = j_flash_attention(jq, jk, jv, block_q=32, block_k=32)
    got = flash_attention(tq, tk, tv, block_q=32, block_k=32, device=CPU)
    assert got.shape == (1, 4, 96, Dh)
    _close(got, want, dtype)
    _close(got, j_attention_ref(jq, jk, jv, sm_scale=Dh ** -0.5, causal=True), dtype)
    width = tkernel.kernel_head_dim(Dh)
    assert widths == [(width, tkernel.SLICE)] * (width // tkernel.SLICE)


@pytest.mark.parametrize("width", [32, 128])
def test_column_slices_equal_unsliced_plain(width):
    """The slicing helper with the plain version gives the unsliced plain
    output: every slice sees the same scores and softmax statistics."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(21, 1, 4, 2, 64, 64, 256))
    kw = dict(sm_scale=256 ** -0.5, causal=True, block_q=32, block_k=32)
    whole = tkernel.flash_attention_plain(q, k, v, **kw)
    sliced = tkernel.column_slices(
        lambda q, k, vs: tkernel.flash_attention_plain(q, k, vs, **kw), q, k, v, width)
    assert sliced.shape == whole.shape
    assert torch.equal(sliced, whole)


def test_validation_errors():
    q, k, v = _qkv(1, 1, 3, 2, 16, 16, 32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, v, device=CPU)
    q, k, v = _qkv(2, 1, 4, 2, 16, 24, 32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, v, device=CPU)
    flash_attention(q, k, v, causal=False, device=CPU)    # cross attention is fine
    # a head dim above the kernel's largest compiled one runs, as the
    # reference's kernel runs it: padded to 384, in three column slices
    q, k, v = _qkv(3, 1, 2, 2, 16, 16, 257)
    got = flash_attention(q, k, v, device=CPU)
    assert got.shape == (1, 2, 16, 257)
    _close(got, j_flash_attention(*map(jnp.asarray, (q, k, v))), "float32")
    # the reference's naive route takes any head dim
    out = flash_attention(q, k, v, use_ref=True, device=CPU)
    assert out.shape == (1, 2, 16, 257)


def test_use_ref():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 2, 4, 2, 48, 48, 64), "float32")
    got = flash_attention(tq, tk, tv, use_ref=True, device=CPU)
    assert torch.equal(got, attention_ref(tq, tk, tv, sm_scale=0.125, causal=True))
    _close(got, j_flash_attention(jq, jk, jv, use_ref=True), "float32")


def test_default_sm_scale():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(9, 1, 2, 1, 64, 64, 32), "float32")
    got = flash_attention(tq, tk, tv, block_q=32, block_k=32, device=CPU)
    explicit = flash_attention(tq, tk, tv, sm_scale=32 ** -0.5, block_q=32,
                               block_k=32, device=CPU)
    assert torch.equal(got, explicit)
    _close(got, j_flash_attention(jq, jk, jv, block_q=32, block_k=32), "float32")
    halved = flash_attention(tq, tk, tv, sm_scale=0.5 * 32 ** -0.5, block_q=32,
                             block_k=32, device=CPU)
    _close(halved, j_flash_attention(jq, jk, jv, sm_scale=0.5 * 32 ** -0.5,
                                     block_q=32, block_k=32), "float32")
    assert not torch.allclose(halved, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_dtype_and_shape(dtype):
    _, (tq, tk, tv) = _both(_qkv(11, 1, 2, 1, 40, 40, 64), dtype)
    for use_ref in (False, True):
        out = flash_attention(tq, tk, tv, use_ref=use_ref, device=CPU)
        assert out.dtype == T_DTYPE[dtype] and out.shape == (1, 2, 40, 64)
        assert torch.isfinite(out.float()).all()


def test_numpy_inputs_and_export():
    q, k, v = _qkv(13, 1, 2, 2, 32, 32, 32)
    assert t_export is flash_attention
    got = flash_attention(q, k, v, block_q=16, block_k=16, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(j_flash_attention(*map(jnp.asarray, (q, k, v)), block_q=16,
                                     block_k=16)),
        atol=2e-5,
    )


def test_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, k, v = _qkv(15, 1, 2, 2, 16, 16, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flash_attention(q, k, v)


def test_kernel_call_checks_its_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(17, 1, 2, 1, 32, 32, 32))
    kw = dict(sm_scale=0.2, causal=True, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="block multiples"):
        tkernel.flash_attention_kernel_call(q, k, v, **dict(kw, block_q=24))
    with pytest.raises(ValueError, match="one float dtype"):
        tkernel.flash_attention_kernel_call(q, k.double(), v, **kw)
    with pytest.raises(ValueError, match="do not pair"):
        tkernel.flash_attention_kernel_call(q, k[..., :16], v[..., :16], **kw)
    assert tkernel.flash_attention_kernel_call.launches == 0

"""The port's Mamba2 layer on the CPU against ``repro.models.ssm``.

The reference's layer parameters (``init_mamba2`` from a fixed
``jax.random.key``, its zero and one leaves moved so that they count) are
carried across as numpy arrays, and the same numpy-seeded inputs and
cache states go through both packages in f32 at zamba2-2.7b's
``reduced()`` size (d_model 64: ``d_inner`` 128, 8 heads of 16, d_state
16, one group, conv width 4, chunks of 32).  Held: ``_causal_conv``,
``_segsum`` (the reference's difference of cumulative sums, ``-inf``
above the diagonal), ``_ssd_chunked`` at one chunk and at three or more,
with one and two groups, ``mamba2`` without a cache and with one at S ≥
W − 1 and at S < W − 1, ``mamba2_decode`` over 4 steps after a prefill
with f32 and with bf16 caches, and one prefill then decode steps against
the port's own full forward.  The reference's two quirks have tests of
their own: a sequence that is not a multiple of the chunk raises, and a
prefill with a cache starts from a zero state.  ``ATOL`` 1e-5 (f32 sums
in another order; the largest error measured is named in each test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import ssm as js
from repro_torch import configs as tconfigs
from repro_torch.models import params_from_numpy
from repro_torch.models import ssm as ts
from repro_torch.models.common import Initializer

CPU = "cpu"
ATOL = 1e-5
ARCH = "zamba2-2.7b"

# the reference's functions under jit: one compile a shape, not one an op
_j_mamba2 = jax.jit(js.mamba2, static_argnums=1)
_j_decode = jax.jit(js.mamba2_decode, static_argnums=1)
_j_ssd = jax.jit(js._ssd_chunked, static_argnums=5)


def _cfgs():
    return jconfigs.get_config(ARCH).reduced(), tconfigs.get_config(ARCH).reduced()


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _params(seed):
    """A layer's reference parameters; the zero bias and the unit skip and
    norm weights moved, so that each counts."""
    jcfg, _ = _cfgs()
    p, _ = js.init_mamba2(jcommon.Initializer(jax.random.key(seed)), jcfg)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "D", "norm_w"):
        p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def _x(S, B=2, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _ref_cache(B, seed, dtype=np.float32):
    """A carried cache: a nonzero conv window and SSD state."""
    jcfg, _ = _cfgs()
    _, h, conv_dim = js._dims(jcfg)
    sc = jcfg.ssm
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, sc.conv_width - 1, conv_dim)).astype(np.float32)
    if dtype != np.float32:
        conv = np.asarray(jnp.asarray(conv, jnp.bfloat16))
    state = (0.3 * rng.standard_normal((B, h, sc.head_dim, sc.d_state))).astype(np.float32)
    return js.SSMCache(conv=conv, state=state)


def _pair(cache):
    """The same cache for each package: the reference's of jax arrays,
    the port's of tensors of its own (written in place)."""
    return (js.SSMCache(*map(jnp.asarray, cache)),
            ts.SSMCache(*(torch.from_numpy(np.array(f, np.float32)).to(
                torch.bfloat16 if f.dtype.name == "bfloat16" else torch.float32)
                for f in cache)))


# --------------------------------------------------------------------- #
# the core
# --------------------------------------------------------------------- #
def test_causal_conv_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 160)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 160))).astype(np.float32)
    b = rng.standard_normal(160).astype(np.float32)
    want = js._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(ts._causal_conv(*map(torch.from_numpy, (x, w, b))), want)


@pytest.mark.parametrize("T,scale", [(32, 0.5), (256, 1.6)])
def test_segsum_matches(T, scale):
    """Negative steps as ``dt · A`` gives them.  The reference's cumulative
    sum adds in f32 from the left, the port's in f64, rounded once; at T
    256 the sums reach -213 and differ by a few ulps of that (measured
    4.6e-5, 2.2e-7 of the largest |value|; at T 32, 9.5e-7 of 9.4):
    held relative to the largest |value|."""
    x = -scale * np.random.default_rng(T).random((2, 3, T)).astype(np.float32)
    want = np.asarray(js._segsum(jnp.asarray(x)))
    got = ts._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * T * (T - 1) // 2
    fin = np.isfinite(want)
    scale_w = float(np.abs(want[fin]).max())
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6 * scale_w, rtol=0)


def _ssd_inputs(b, s, h, p, n, g, seed):
    """x, B and C as the layer gives them (the conv's silu outputs), dt
    a softplus, A as ``-exp(A_log)`` at init."""
    rng = np.random.default_rng(seed)
    silu = lambda v: v / (1.0 + np.exp(-v))   # noqa: E731
    x = silu(rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)) - 2.0).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)
    B = silu(rng.standard_normal((b, s, g, n))).astype(np.float32)
    C = silu(rng.standard_normal((b, s, g, n))).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (2, 32, 8, 16, 16, 1, 32),     # one chunk
    (2, 96, 8, 16, 16, 1, 32),     # three chunks
    (1, 160, 8, 16, 16, 2, 32),    # five chunks, two groups of four heads
    (2, 20, 4, 8, 16, 1, 20),      # a short sequence: one chunk of S
])
def test_ssd_chunked_matches(b, s, h, p, n, g, chunk):
    """The outputs (|y| up to 13) and the final state: measured within
    6.2e-6 and 3.2e-6 of the reference's, which is itself 7.0e-6 from an
    f64 run of the port's formula."""
    ins = _ssd_inputs(b, s, h, p, n, g, seed=s + g)
    wy, wst = _j_ssd(*map(jnp.asarray, ins), chunk)
    gy, gst = ts._ssd_chunked(*map(torch.from_numpy, ins), chunk)
    assert gy.shape == (b, s, h, p) and gst.shape == (b, h, p, n)
    _close(gy, wy)
    _close(gst, wst)


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S,cached", [(64, None), (20, None), (64, "long"), (3, "long"),
                                      (2, "short"), (1, "short")])
def test_mamba2_matches(S, cached):
    """Without a cache (two chunks of 32; one of 20), and with one: at S
    ≥ W − 1 the new window is the sequence's last three columns, at S <
    W − 1 the cache's window shifted by S, then the sequence.  Output and
    both cache fields, written in place (measured within 2e-6)."""
    jcfg, tcfg = _cfgs()
    p = _params(seed=2)
    x = _x(S, seed=S)
    jc = tc = None
    if cached:
        jc, tc = _pair(_ref_cache(2, seed=S + 1))
    wy, wc = _j_mamba2(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), jc)
    gy, gc = ts.mamba2(params_from_numpy(p, CPU), tcfg, torch.from_numpy(x), tc)
    assert gy.shape == (2, S, 64) and bool(torch.isfinite(gy).all())
    _close(gy, wy)
    if not cached:
        assert gc is None and wc is None
        return
    assert gc is tc
    _close(gc.conv, wc.conv)
    _close(gc.state, wc.state)


@pytest.mark.parametrize("seed", [8, 9])
def test_mamba2_bf16_rounds_where_the_reference_does(seed):
    """bf16 compute: the port rounds to bf16 where the reference's ops do
    (its explicit casts to the compute dtype, and every primitive of
    ``jax.nn.silu``: ``repro_torch.models.common.silu``), the SSD core in
    f32.  Held against the reference run op by op (eagerly, each op
    rounding its output; under ``jit`` XLA fuses some of them and skips
    their rounding, which moves 51-53 % of this output by an ulp): at
    most one element in 200 apart (an f32 sum in another order rounding
    to the neighbouring bf16 number), by at most 2^-8 of the largest |y|
    (measured over seeds 8-15: up to 16 of 8,192 elements, 2.5e-3 of the
    largest |y|)."""
    jcfg, tcfg = _cfgs()
    p = _params(seed)
    xb = jnp.asarray(_x(64, seed=seed), jnp.bfloat16)
    want, _ = js.mamba2(jax.tree.map(jnp.asarray, p), jcfg, xb)
    got, _ = ts.mamba2(params_from_numpy(p, CPU), tcfg,
                       torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert (got != want).mean() <= 5e-3
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 * np.abs(want).max(), rtol=0)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    """S 48 at chunks of 32: the reference's reshape raises a TypeError;
    the port raises a ValueError naming the chunk.  S 32 and S 20 (one
    chunk of S) run."""
    jcfg, tcfg = _cfgs()
    p = _params(seed=3)
    x = _x(48, seed=3)
    with pytest.raises(TypeError):
        js.mamba2(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    tp = params_from_numpy(p, CPU)
    with pytest.raises(ValueError, match="chunk 32"):
        ts.mamba2(tp, tcfg, torch.from_numpy(x))
    for S in (32, 20):
        ts.mamba2(tp, tcfg, torch.from_numpy(x[:, :S]))


def test_prefill_with_a_cache_restarts_the_state():
    """Two prefills of 32 in a row are not one of 64: the second starts
    from a zero state and zero-padded conv, whatever the cache holds, as
    the reference's does.  Both packages' second prefill equal a
    cache-less prefill of its 32 tokens, and differ from the second half
    of the 64-token prefill."""
    jcfg, tcfg = _cfgs()
    p = _params(seed=4)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, CPU)
    x = _x(64, seed=4)
    first, second = x[:, :32], x[:, 32:]
    jc, tc = _pair(_ref_cache(2, seed=5))
    _, jc = _j_mamba2(jp, jcfg, jnp.asarray(first), jc)
    wy, _ = _j_mamba2(jp, jcfg, jnp.asarray(second), jc)
    ts.mamba2(tp, tcfg, torch.from_numpy(first), tc)
    gy, _ = ts.mamba2(tp, tcfg, torch.from_numpy(second), tc)
    _close(gy, wy)
    alone, _ = _j_mamba2(jp, jcfg, jnp.asarray(second))
    np.testing.assert_array_equal(np.asarray(wy), np.asarray(alone))
    _close(gy, alone)
    whole, _ = ts.mamba2(tp, tcfg, torch.from_numpy(x))
    assert float((gy - whole[:, 32:]).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches(dtype):
    """A prefill of 24 tokens into a cache (conv window in ``dtype``),
    then 4 decode steps, each package from its own cache: outputs, state
    and window after each step.  Under f32 compute a bf16 window comes
    back f32 from the first step, in both packages (the reference's
    concatenation promotes it), the new columns unrounded (measured
    within 2e-6)."""
    jcfg, tcfg = _cfgs()
    p = _params(seed=6)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, CPU)
    x = _x(28, seed=6)
    np_dt = np.float32 if dtype == "float32" else jnp.bfloat16
    jc, tc = _pair(js.SSMCache(*(np.asarray(f) for f in js.init_ssm_cache(jcfg, 2, np_dt))))
    assert tc.conv.dtype == getattr(torch, dtype)
    _, jc = _j_mamba2(jp, jcfg, jnp.asarray(x[:, :24]), jc)
    ts.mamba2(tp, tcfg, torch.from_numpy(x[:, :24]), tc)
    _close(tc.conv, jc.conv)          # rounded to the window's dtype in both
    for t in range(24, 28):
        wy, jc = _j_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        state = tc.state
        gy, tc = ts.mamba2_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tc)
        assert gy.shape == (2, 1, 64) and tc.state is state
        assert tc.conv.dtype == torch.float32 and str(jc.conv.dtype) == "float32"
        _close(gy, wy)
        _close(tc.state, jc.state)
        _close(tc.conv, jc.conv)


def test_prefill_then_decode_matches_the_full_forward():
    """A prefill of 24 tokens (one chunk of 24) into empty f32 caches,
    then 8 one-token steps, against one cache-less forward over all 32
    (one chunk of 32): outputs and the final state (measured 1.2e-6)."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(_params(seed=7), CPU)
    x = torch.from_numpy(_x(32, seed=7))
    whole_cache = ts.init_ssm_cache(tcfg, 2, torch.float32, CPU)
    whole, _ = ts.mamba2(tp, tcfg, x, whole_cache)
    cache = ts.init_ssm_cache(tcfg, 2, torch.float32, CPU)
    pre, _ = ts.mamba2(tp, tcfg, x[:, :24], cache)
    steps = [ts.mamba2_decode(tp, tcfg, x[:, t:t + 1], cache)[0] for t in range(24, 32)]
    _close(torch.cat([pre] + steps, 1), whole.numpy())
    _close(cache.state, whole_cache.state.numpy())
    _close(cache.conv, whole_cache.conv.numpy())


# --------------------------------------------------------------------- #
# parameters and caches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache_mirrors_the_reference(dtype):
    jcfg, tcfg = _cfgs()
    got = ts.init_ssm_cache(tcfg, 3, getattr(torch, dtype), CPU)
    want = js.init_ssm_cache(jcfg, 3, getattr(jnp, dtype))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


def test_init_mamba2_mirrors_the_reference():
    """The tree leaf for leaf; the deterministic leaves the reference's
    values; the drawn ones from the same distributions: ``A = exp(A_log)``
    in [1, 16), ``softplus(dt_bias)`` in [1e-3, 0.1), ``conv_w`` of std
    0.1."""
    jcfg, tcfg = _cfgs()
    got = ts.init_mamba2(Initializer(torch.Generator().manual_seed(0), CPU), tcfg)
    want, _ = js.init_mamba2(jcommon.Initializer(jax.random.key(0)), jcfg)
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32
    for k in ("conv_b", "D", "norm_w"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    full = ts.init_mamba2(Initializer(torch.Generator().manual_seed(1), CPU),
                          tconfigs.get_config(ARCH))
    a = full["A_log"].exp()
    assert float(a.min()) >= 1.0 and float(a.max()) < 16.0
    dt = torch.nn.functional.softplus(full["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) < 0.1 * (1 + 1e-5)
    assert abs(float(full["conv_w"].std()) - 0.1) < 0.005

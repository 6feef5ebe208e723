"""The port's xLSTM blocks on the CPU against ``repro.models.xlstm``.

The reference's block parameters (``init_mlstm_block``,
``init_slstm_block`` from a fixed ``jax.random.key``) are carried across
as numpy arrays, and the same numpy-seeded inputs and cache states go
through both packages in f32 at ``reduced()`` sizes (d_model 64, 4
heads: the mLSTM's inner width 128, head dim 32; the sLSTM's head dim
16).  Held: ``_causal_conv``; ``_mlstm_chunked`` at explicit chunks of 1,
16 and the whole sequence, from a zero and from a carried state;
``mlstm_block`` and ``slstm_block`` at S = 1, 40 and 320 (five chunks of
64), without and with a cache (output and every cache field), also with
gate biases of ``b_i`` +60 and ``b_f`` −60, where an ``exp`` without the
stabilizer leaves f32's range; the chunk size the reference picks; a
chunk of one token at a time through the cache against the chunk form.
``atol=1e-5`` (f32 sums in another order) on outputs of magnitude up to
~5; the states that grow with the sequence are held relative to their
largest value (``_close_rel``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import xlstm as jx
from repro_torch import configs as tconfigs
from repro_torch.models import params_from_numpy
from repro_torch.models import xlstm as tx

CPU = "cpu"
ATOL = 1e-5
RTOL_STATE = 1e-6   # a cache field's error, of its largest |value|
# the core's h, of its largest |h|: a readout divided by max(|n|, exp(-m)),
# so where the normalizer's sum nearly cancels, the sums' f32 error is
# magnified by 1/|n| (measured up to 2.3e-6 of the element's own value)
RTOL_CORE_H = 1e-5
ARCH = "xlstm-350m"


# the reference's functions under jit: one compile a shape, not one an op
_j_mlstm = jax.jit(jx.mlstm_block, static_argnums=1)
_j_slstm = jax.jit(jx.slstm_block, static_argnums=1)
_j_chunked = jax.jit(jx._mlstm_chunked, static_argnums=6)


def _cfgs():
    return jconfigs.get_config(ARCH).reduced(), tconfigs.get_config(ARCH).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _close_rel(got: torch.Tensor, want, rtol=RTOL_STATE):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rtol * scale, rtol=0)


def _params(kind, seed, extreme=False):
    """A block's reference parameters; ``extreme`` sets the gate biases
    to ``b_i`` +60 and ``b_f`` −60."""
    jcfg, _ = _cfgs()
    init = jcommon.Initializer(jax.random.key(seed))
    p, _ = (jx.init_mlstm_block if kind == "mlstm" else jx.init_slstm_block)(init, jcfg)
    p = _np(p)
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "b_z", "b_o"):   # zeros at init: make them count
        if k in p:
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    if extreme:
        p["b_i"] = np.full_like(p["b_i"], 60.0)
        p["b_f"] = np.full_like(p["b_f"], -60.0)
    return p


def _x(S, B=2, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


# --------------------------------------------------------------------- #
# the mLSTM core
# --------------------------------------------------------------------- #
def test_causal_conv_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 128)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 128))).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = jx._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tx._causal_conv(*map(torch.from_numpy, (x, w, b))), want)


def _core_inputs(S, carried, seed, B=2, H=4, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, hd)) * hd ** -0.5).astype(np.float32)
    v = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    log_i = rng.standard_normal((B, S, H)).astype(np.float32)
    pre_f = rng.standard_normal((B, S, H)) + 3.0
    log_f = (-np.logaddexp(0.0, -pre_f)).astype(np.float32)
    if carried:
        state = ((0.3 * rng.standard_normal((B, H, hd, hd))).astype(np.float32),
                 np.abs(rng.standard_normal((B, H, hd))).astype(np.float32),
                 rng.uniform(-2.0, 2.0, (B, H)).astype(np.float32))
    else:
        state = (np.zeros((B, H, hd, hd), np.float32), np.zeros((B, H, hd), np.float32),
                 np.full((B, H), -1e30, np.float32))
    return (q, k, v, log_i, log_f), state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [1, 16, 48])
def test_mlstm_chunked_matches(chunk, carried):
    """S 48 at chunks of 1, 16 and 48 (the whole sequence), from the
    initial state and from a carried nonzero one: h and the final (C, n,
    m).  The core's h is not yet normalized (a readout over ``|n|``, some
    tens where ``n`` is small), so it is held relative to its largest
    value (``RTOL_CORE_H``)."""
    ins, state = _core_inputs(48, carried, seed=chunk)
    wh, wst = _j_chunked(*map(jnp.asarray, ins), tuple(map(jnp.asarray, state)), chunk)
    gh, gst = tx._mlstm_chunked(*map(torch.from_numpy, ins),
                                tuple(map(torch.from_numpy, state)), chunk)
    _close_rel(gh, wh, RTOL_CORE_H)
    for g, w in zip(gst, wst):
        _close_rel(g, w)


@pytest.mark.parametrize("S,chunk", [(1, 1), (40, 40), (64, 64), (320, 64), (448, 64),
                                     (512, 256), (2048, 256), (384, 128)])
def test_chunk_size_is_the_references(S, chunk):
    _, tcfg = _cfgs()
    full = tconfigs.get_config(ARCH)
    assert tx._mlstm_chunk_size(full, S) == tx._mlstm_chunk_size(tcfg, S) == chunk


# --------------------------------------------------------------------- #
# the blocks
# --------------------------------------------------------------------- #
def _mlstm_cache(B, seed, dtype=np.float32):
    """A carried mLSTM state: nonzero memory, normalizer, stabilizer and
    conv window."""
    jcfg, _ = _cfgs()
    di, nh, hd = jx._mlstm_dims(jcfg)
    rng = np.random.default_rng(seed)
    return jx.MLSTMCache(
        C=(0.3 * rng.standard_normal((B, nh, hd, hd))).astype(np.float32),
        n=np.abs(rng.standard_normal((B, nh, hd))).astype(np.float32),
        m=rng.uniform(-2.0, 2.0, (B, nh)).astype(np.float32),
        conv=rng.standard_normal((B, jcfg.xlstm.conv_width - 1, di)).astype(dtype))


def _slstm_cache(B, seed):
    jcfg, _ = _cfgs()
    nh, hd = jx._slstm_dims(jcfg)
    rng = np.random.default_rng(seed)
    shape = (B, nh, hd)
    return jx.SLSTMCache(
        c=rng.standard_normal(shape).astype(np.float32),
        n=(1.0 + np.abs(rng.standard_normal(shape))).astype(np.float32),
        h=(0.5 * rng.standard_normal(shape)).astype(np.float32),
        m=rng.uniform(-1.0, 1.0, shape).astype(np.float32),
        conv=rng.standard_normal((B, jcfg.xlstm.conv_width - 1, jcfg.d_model))
        .astype(np.float32))


def _block_case(kind, S, cached, extreme):
    jcfg, tcfg = _cfgs()
    p = _params(kind, seed=2 if kind == "mlstm" else 3, extreme=extreme)
    x = _x(S, seed=S)
    make = _mlstm_cache if kind == "mlstm" else _slstm_cache
    ref_cache = make(2, seed=S + 1) if cached else None
    j_fn = _j_mlstm if kind == "mlstm" else _j_slstm
    t_fn = tx.mlstm_block if kind == "mlstm" else tx.slstm_block
    wy, wc = j_fn(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                  None if ref_cache is None else type(ref_cache)(*map(jnp.asarray, ref_cache)))
    cache = None
    if cached:
        cache = (tx.MLSTMCache if kind == "mlstm" else tx.SLSTMCache)(
            *(torch.from_numpy(np.array(f)) for f in ref_cache))
    gy, gc = t_fn(params_from_numpy(p, CPU), tcfg, torch.from_numpy(x), cache)
    return gy, gc, cache, wy, wc


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("S", [1, 40, 320])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches(kind, S, cached, extreme):
    """``mlstm_block`` (S 320: five chunks of 64) and ``slstm_block`` (a
    host loop of S steps): the output, and with a cache every field of
    the state after the sequence, written in place into the cache given."""
    gy, gc, cache, wy, wc = _block_case(kind, S, cached, extreme)
    assert gy.shape == (2, S, 64) and bool(torch.isfinite(gy).all())
    _close(gy, wy)
    if not cached:
        assert gc is None and wc is None
        return
    assert gc is cache
    for f in gc._fields:
        _close_rel(getattr(gc, f), getattr(wc, f))


def test_extreme_biases_need_the_stabilizer(monkeypatch):
    """The bias case is one that only the stabilized form survives.  The
    mLSTM's log-forget gates, as the block computes them, sum over a
    chunk of 64 to far below -88: their ``exp`` underflows f32 and its
    reciprocal overflows, so only differences of log-gates less the
    running max ``m`` are finite.  The sLSTM's stabilizer follows the
    input gate to about 60, where ``exp(i_pre)`` alone is ~1e26.  Both
    blocks' outputs stay finite (and match: ``test_block_matches``)."""
    seen = {}
    real = tx._mlstm_chunked

    def spy(q, k, v, log_i, log_f, state, chunk):
        seen.update(log_f=log_f.numpy(), chunk=chunk)
        return real(q, k, v, log_i, log_f, state, chunk)

    monkeypatch.setattr(tx, "_mlstm_chunked", spy)
    gy, _, _, _, _ = _block_case("mlstm", 320, True, True)
    assert seen["chunk"] == 64 and bool(torch.isfinite(gy).all())
    lf_cum = seen["log_f"][:, :64].cumsum(1, dtype=np.float32)
    with np.errstate(over="ignore", under="ignore"):
        assert (np.exp(lf_cum[:, -1]) == 0).all()
        assert np.isinf(np.exp(-lf_cum[:, -1])).all()
    gy, gc, _, _, wc = _block_case("slstm", 40, True, True)
    assert bool(torch.isfinite(gy).all()) and float(gc.m.min()) > 50.0
    _close_rel(gc.m, wc.m)


def test_mlstm_one_token_at_a_time_matches_the_chunk_form():
    """48 tokens through the cache one at a time (chunk 1, the decode
    form) against one call over all 48 (chunk 16), from the same carried
    state: outputs and final states."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(_params("mlstm", seed=4), CPU)
    x = torch.from_numpy(_x(48, seed=5))
    start = _mlstm_cache(2, seed=6)
    whole_cache = tx.MLSTMCache(*(torch.from_numpy(np.array(f)) for f in start))
    step_cache = tx.MLSTMCache(*(torch.from_numpy(np.array(f)) for f in start))
    whole, _ = tx.mlstm_block(tp, tcfg, x, whole_cache)
    steps = [tx.mlstm_block(tp, tcfg, x[:, t:t + 1], step_cache)[0] for t in range(48)]
    _close(torch.cat(steps, 1), whole.detach().numpy())
    for a, b in zip(step_cache, whole_cache):
        _close_rel(a, b.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_mirror_the_reference(dtype):
    jcfg, tcfg = _cfgs()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for t_init, j_init in ((tx.init_mlstm_cache, jx.init_mlstm_cache),
                           (tx.init_slstm_cache, jx.init_slstm_cache)):
        got, want = t_init(tcfg, 3, tdt, CPU), j_init(jcfg, 3, jdt)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_block_trees_mirror_the_reference():
    jcfg, tcfg = _cfgs()
    from repro_torch.models.common import Initializer

    init = Initializer(torch.Generator().manual_seed(0), CPU)
    for t_init, j_init in ((tx.init_mlstm_block, jx.init_mlstm_block),
                           (tx.init_slstm_block, jx.init_slstm_block)):
        got = t_init(init, tcfg)
        want, _ = j_init(jcommon.Initializer(jax.random.key(0)), jcfg)
        assert list(got) == list(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert got[k].dtype == torch.float32
        for k in ("norm", "conv_b", "b_i", "b_f", "out_norm", "b_z", "b_o", "gn"):
            if k in got:   # the deterministic leaves are the reference's values
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert abs(float(got["conv_w"].std()) - 0.1) < 0.02

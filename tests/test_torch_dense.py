"""The port's dense-emission path against the JAX package.

The dense tile join (``dense_tiles_plain``, the plain version of
``csrc/sssj_dense.cu``), the join surface ``sssj_join_tiles`` and the
oracle compaction ``compact_pairs`` / ``tile_emit_counts`` get the same
numpy-seeded inputs as ``repro`` (Pallas kernel in interpret mode, or its
dense reference).  Tolerances: integer outputs (``iters``, counts, uids,
pair counts) exact; scores ``atol=1e-5`` (f32 dot products summed in
another order); the set of nonzero scores identical outside an ε-band of
1e-5 around θ, and on these inputs no score lies in the band.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.sssj_join import compact as jc
from repro.kernels.sssj_join import kernel as jkernel
from repro.kernels.sssj_join import ops as jops
from repro_torch.kernels import sssj_join_scores as t_join_scores
from repro_torch.kernels.sssj_join import compact as tc
from repro_torch.kernels.sssj_join import kernel as tkernel
from repro_torch.kernels.sssj_join import ops as tops

from test_torch_join import _kernel_inputs, _stream

SCORE_ATOL = 1e-5
BAND = 1e-5
CPU = "cpu"


def _age_window(args, bw, n_old_tiles):
    """Push the first ``n_old_tiles`` window tiles far into the past, so
    their tiles are time-dead."""
    tw = args[3].copy()
    tw[: n_old_tiles * bw] -= 100.0
    args[3] = tw
    return args


def _assert_dense_outputs(got, want, theta):
    scores, iters, counts = (x.numpy() for x in got)
    w_scores, w_iters, w_counts = (np.asarray(x) for x in want)
    assert scores.shape == w_scores.shape
    np.testing.assert_array_equal(iters, w_iters, err_msg="iters")
    np.testing.assert_array_equal(counts, w_counts, err_msg="counts")
    # the entries that emit are the same, outside the ε-band around θ
    differ = (scores > 0) != (w_scores > 0)
    near = np.abs(np.maximum(scores, w_scores) - theta) <= BAND
    assert not (differ & ~near).any()
    assert not differ.any()          # and none of these inputs is in the band
    np.testing.assert_allclose(scores, w_scores, atol=SCORE_ATOL)


@pytest.mark.parametrize(
    "Q,W,d,bq,bw,chunk,theta,lam,n_dup,n_old",
    [
        (40, 100, 64, 32, 32, 32, 0.8, 0.05, 12, 0),    # ragged Q/W, all live
        (40, 160, 64, 32, 32, 32, 0.8, 0.05, 12, 2),    # time-dead tiles
        (32, 96, 200, 32, 32, 32, 0.6, 0.1, 16, 1),     # ragged d, padded
        (16, 64, 256, 16, 32, 64, 0.05, 0.01, 16, 0),   # low θ: dense tiles
    ],
)
def test_dense_tiles_plain_matches_pallas_interpret(
    Q, W, d, bq, bw, chunk, theta, lam, n_dup, n_old
):
    rng = np.random.default_rng(Q * 1000 + W + d)
    args = _age_window(_kernel_inputs(rng, Q, W, d, bq, bw, chunk, n_dup),
                       bw, n_old)
    kw = dict(theta=theta, lam=lam, block_q=bq, block_w=bw, chunk_d=chunk)
    want = jkernel.sssj_join_kernel_call(*map(jnp.asarray, args),
                                         interpret=True, **kw)
    t_args = [torch.from_numpy(a) for a in args]
    got = tkernel.dense_tiles_plain(*t_args, **kw)
    _assert_dense_outputs(got, want, theta)
    iters = np.asarray(want[1])
    assert np.asarray(want[2]).sum() > 0
    if n_old:
        assert (iters[:, :n_old] == 0).all() and (iters[:, n_old:] > 0).any()
    # on CPU tensors the wrapper is the plain version, and launches nothing
    wrapped = tkernel.sssj_join_kernel_call(*t_args, **kw)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    assert tkernel.sssj_join_kernel_call.launches == 0


@pytest.mark.parametrize("bq,bw", [(64, 64), (32, 128), (128, 48), (256, 256),
                                   (192, 320)])
def test_dense_tiles_plain_matches_pallas_interpret_at_tile_edges(bq, bw):
    rng = np.random.default_rng(bq * 1000 + bw)
    Q, W = bq + bq // 2 + 3, 4 * bw + bw // 3
    args = _age_window(_kernel_inputs(rng, Q, W, 64, bq, bw, 32, Q // 3), bw, 1)
    kw = dict(theta=0.6, lam=0.05, block_q=bq, block_w=bw, chunk_d=32)
    want = jkernel.sssj_join_kernel_call(*map(jnp.asarray, args),
                                         interpret=True, **kw)
    got = tkernel.dense_tiles_plain(*[torch.from_numpy(a) for a in args], **kw)
    _assert_dense_outputs(got, want, 0.6)
    iters = np.asarray(want[1])
    assert np.asarray(want[2]).sum() > 0
    assert (iters[:, :1] == 0).all() and (iters[:, 1:] > 0).any()


def test_dense_and_candidate_plain_versions_share_scores():
    """The two emissions of one score core: the candidate buffers hold
    exactly the dense matrix's nonzero entries, in row-major order."""
    rng = np.random.default_rng(3)
    bq = bw = chunk = 32
    args = [torch.from_numpy(a)
            for a in _kernel_inputs(rng, 40, 96, 64, bq, bw, chunk, 16)]
    kw = dict(theta=0.7, lam=0.05, block_q=bq, block_w=bw, chunk_d=chunk)
    scores, iters, counts = tkernel.dense_tiles_plain(*args, **kw)
    idx, sc, emitted, _, c_iters = tkernel.cand_tiles_plain(*args, tile_k=bq * bw, **kw)
    assert torch.equal(iters, c_iters) and torch.equal(counts, emitted)
    nq, nw = iters.shape
    tiles = scores.reshape(nq, bq, nw, bw).permute(0, 2, 1, 3).reshape(nq, nw, -1)
    for i in range(nq):
        for j in range(nw):
            hits = torch.nonzero(tiles[i, j] > 0).reshape(-1)
            n = hits.numel()
            assert torch.equal(idx[i, j, :n].long(), hits)
            assert torch.equal(sc[i, j, :n], tiles[i, j, hits])
    assert counts.sum() > 0


@pytest.mark.parametrize(
    "Q,W,d,use_ref",
    [
        (40, 100, 64, False),    # kernel route, ragged Q/W
        (40, 100, 64, True),     # the reference route
        (32, 96, 200, False),    # d % chunk_d != 0: padded to whole chunks
        (20, 100, 64, False),    # Q < block_q: routed to the reference
        (40, 20, 64, False),     # W < block_w: routed to the reference
        (40, 100, 16, False),    # d < chunk_d: routed to the reference
    ],
)
def test_join_tiles_matches_reference(Q, W, d, use_ref):
    rng = np.random.default_rng(Q + W + d)
    q, w, tq, tw, uq, uw = _stream(rng, Q, W, d, 12)
    tw = tw - np.where(np.arange(W) < W // 3, 50.0, 0.0).astype(np.float32)
    uw[-3:] = -1                       # empty ring slots
    kw = dict(theta=0.7, lam=0.05, block_q=32, block_w=32, chunk_d=32,
              use_ref=use_ref)
    want = jops.sssj_join_tiles(*map(jnp.asarray, (q, w, tq, tw, uq, uw)),
                                interpret=True, **kw)
    got = tops.sssj_join_tiles(q, w, tq, tw, uq, uw, device=CPU, **kw)
    _assert_dense_outputs(got, want, kw["theta"])
    assert np.asarray(want[2]).sum() > 0
    scores, iters = t_join_scores(q, w, tq, tw, uq, uw, device=CPU, **kw)
    assert torch.equal(scores, got[0]) and torch.equal(iters, got[1])


@pytest.mark.parametrize(
    "Q,W,density,max_pairs",
    [
        (16, 40, 0.05, 256),     # lossless
        (16, 40, 0.3, 64),       # max_pairs overflow: the first 64 survive
        (4, 6, 0.5, 64),         # Q·W < max_pairs: padded to max_pairs
        (8, 8, 0.0, 16),         # nothing emits
    ],
)
def test_compact_pairs_matches_reference(Q, W, density, max_pairs):
    rng = np.random.default_rng(Q * W + max_pairs)
    s = rng.uniform(0.5, 1.0, (Q, W)).astype(np.float32)
    s = np.where(rng.random((Q, W)) < density, s, 0.0).astype(np.float32)
    uq = np.arange(1000, 1000 + Q, dtype=np.int32)
    uw = rng.permutation(W).astype(np.int32)
    want = jc.compact_pairs(jnp.asarray(s), jnp.asarray(uq), jnp.asarray(uw),
                            max_pairs=max_pairs)
    got = tc.compact_pairs(torch.from_numpy(s), torch.from_numpy(uq),
                           torch.from_numpy(uw), max_pairs=max_pairs)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    total = int((s > 0).sum())
    assert int(got.n_dropped) == max(0, total - max_pairs)
    if density == 0.3:
        assert total > max_pairs                  # overflow exercised


@pytest.mark.parametrize(
    "Q,W,bq,bw", [(32, 64, 16, 16), (37, 90, 16, 32), (8, 8, 16, 16)]
)
def test_tile_emit_counts_matches_reference(Q, W, bq, bw):
    rng = np.random.default_rng(Q + W)
    s = np.where(rng.random((Q, W)) < 0.2, 0.9, 0.0).astype(np.float32)
    want = jc.tile_emit_counts(jnp.asarray(s), bq, bw)
    got = tc.tile_emit_counts(torch.from_numpy(s), bq, bw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_wrapper_refuses_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA gets no fallback."""
    m = dict(device="meta")
    q = torch.empty((128, 128), **m)
    lane = torch.empty((128, 1), **m)
    with pytest.raises(ValueError, match="no tile-join kernel"):
        tkernel.sssj_join_kernel_call(
            q, q, lane, lane, lane, lane, lane, lane, theta=0.9, lam=0.1,
            block_q=128, block_w=128, chunk_d=128,
        )
    assert tkernel.sssj_join_kernel_call.launches == 0


def test_join_tiles_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 8), np.float32)
    t = np.zeros(4, np.float32)
    u = np.arange(4, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.sssj_join_tiles(x, x, t, t, u, u, theta=0.9, lam=0.1)

"""The port's pair compaction against the JAX package.

Everything here is integer bookkeeping or a copy of selected floats, so
every output is held exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.sssj_join import compact as jc
from repro_torch.kernels.sssj_join import compact as tc


def _scores(rng, Q, W, density):
    """A sparse thresholded score matrix: zeros, or values in [θ, 1)."""
    s = rng.uniform(0.5, 1.0, (Q, W)).astype(np.float32)
    return np.where(rng.random((Q, W)) < density, s, 0.0).astype(np.float32)


def _assert_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize(
    "Q,W,bq,bw,tile_k,density",
    [
        (32, 64, 16, 16, 64, 0.05),
        (37, 90, 16, 32, 16, 0.05),   # ragged Q and W
        (32, 64, 16, 16, 4, 0.3),     # tile_k overflow
        (8, 8, 16, 16, 8, 0.5),       # one padded tile
    ],
)
def test_tile_candidates_matches_reference(Q, W, bq, bw, tile_k, density):
    rng = np.random.default_rng(Q * W + tile_k)
    s = _scores(rng, Q, W, density)
    uq = np.arange(1000, 1000 + Q, dtype=np.int32)
    uw = np.arange(W, dtype=np.int32)
    want, want_mask = jc.tile_candidates(
        jnp.asarray(s), jnp.asarray(uq), jnp.asarray(uw),
        block_q=bq, block_w=bw, tile_k=tile_k,
    )
    got, got_mask = tc.tile_candidates(
        torch.from_numpy(s), torch.from_numpy(uq), torch.from_numpy(uw),
        block_q=bq, block_w=bw, tile_k=tile_k,
    )
    _assert_equal(got, want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def _candidates(rng, n_seg, K, fill):
    """Random ragged segments: ``kept`` valid pairs up front, inert after;
    ``emitted`` ≥ ``kept`` (segments that overflowed their capacity)."""
    kept = rng.integers(0, K + 1, n_seg).astype(np.int32)
    kept[rng.random(n_seg) > fill] = 0
    emitted = (kept + np.where(kept == K, rng.integers(0, 5, n_seg), 0)).astype(np.int32)
    valid = np.arange(K)[None, :] < kept[:, None]
    ua = np.where(valid, rng.integers(100, 200, (n_seg, K)), -1).astype(np.int32)
    ub = np.where(valid, rng.integers(0, 100, (n_seg, K)), -1).astype(np.int32)
    sc = np.where(valid, rng.uniform(0.5, 1.0, (n_seg, K)), 0.0).astype(np.float32)
    return [ua, ub, sc, kept, emitted]


@pytest.mark.parametrize(
    "n_seg,K,max_pairs,fill",
    [(12, 8, 64, 0.5), (12, 8, 10, 0.9), (30, 4, 7, 1.0), (5, 16, 256, 0.0)],
)
def test_merge_candidates_matches_reference(n_seg, K, max_pairs, fill):
    rng = np.random.default_rng(n_seg * K + max_pairs)
    leaves = _candidates(rng, n_seg, K, fill)
    want = jc.merge_candidates(
        jc.PairCandidates(*map(jnp.asarray, leaves)), max_pairs=max_pairs
    )
    got = tc.merge_candidates(
        tc.PairCandidates(*map(torch.from_numpy, leaves)), max_pairs=max_pairs
    )
    _assert_equal(got, want)
    assert bool(got.overflowed) == bool(want.overflowed)


def test_segmented_take_matches_reference():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 6, 20).astype(np.int32)
    for out_cap in (5, 40, 200):
        want = jc._segmented_take(jnp.asarray(counts), 6, out_cap)
        got = tc._segmented_take(torch.from_numpy(counts), 6, out_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_concat_then_merge_keeps_segment_order():
    """Window candidates come before self candidates, as in the engine."""
    rng = np.random.default_rng(2)
    a, b = _candidates(rng, 6, 4, 0.8), _candidates(rng, 3, 4, 0.8)
    want = jc.merge_candidates(
        jc.concat_candidates(jc.PairCandidates(*map(jnp.asarray, a)),
                             jc.PairCandidates(*map(jnp.asarray, b))),
        max_pairs=16,
    )
    got = tc.merge_candidates(
        tc.concat_candidates(tc.PairCandidates(*map(torch.from_numpy, a)),
                             tc.PairCandidates(*map(torch.from_numpy, b))),
        max_pairs=16,
    )
    _assert_equal(got, want)

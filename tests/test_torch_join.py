"""The port's tile join and join surface against the JAX package.

Same numpy-seeded inputs go through ``repro`` (Pallas kernel in interpret
mode, or its dense oracle) and ``repro_torch`` on the CPU, where the tile
join runs its plain PyTorch version.  Tolerances: integer outputs
(candidate indices and uids, counts, row hits, ``iters``, gate stats)
exact; scores ``atol=1e-5`` (f32 dot products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.sssj_join import kernel as jkernel
from repro.kernels.sssj_join import ops as jops
from repro.kernels.sssj_join.gate import summarize_strips as j_summarize
from repro_torch.kernels.sssj_join import kernel as tkernel
from repro_torch.kernels.sssj_join import ops as tops
from repro_torch.kernels.sssj_join.gate import StripSummary

SCORE_ATOL = 1e-5
CPU = "cpu"


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _stream(rng, Q, W, d, n_dup, noise=0.02):
    """A window of W items and Q newer queries, ``n_dup`` of them
    near-copies of window rows (so tiles emit)."""
    w = _unit(rng, W, d)
    q = _unit(rng, Q, d)
    src = rng.integers(0, W, size=n_dup)
    q[:n_dup] = w[src] + noise * rng.standard_normal((n_dup, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tw = np.sort(rng.random(W) * 4.0).astype(np.float32)
    tq = (4.0 + np.sort(rng.random(Q))).astype(np.float32)
    uw = np.arange(W, dtype=np.int32)
    uq = np.arange(W, W + Q, dtype=np.int32)
    return q, w, tq, tw, uq, uw


def _pad(x, mult, fill=0, axis=0):
    pad = (-x.shape[axis]) % mult
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def _suffix(x, chunk):
    n, d = x.shape
    sq = (x.astype(np.float64) ** 2).reshape(n, d // chunk, chunk).sum(-1)
    suf = np.cumsum(sq[:, ::-1], axis=1)[:, ::-1]
    return np.sqrt(np.concatenate([suf[:, 1:], np.zeros((n, 1))], 1)).astype(np.float32)


def _kernel_inputs(rng, Q, W, d, bq, bw, chunk, n_dup):
    """Inputs padded the way ops pads them, as numpy arrays."""
    q, w, tq, tw, uq, uw = _stream(rng, Q, W, d, n_dup)
    q, w = _pad(q, chunk, axis=1), _pad(w, chunk, axis=1)
    qp, wp = _pad(q, bq), _pad(w, bw)
    args = [qp, wp, _pad(tq, bq)[:, None], _pad(tw, bw)[:, None],
            _pad(uq, bq, -1)[:, None], _pad(uw, bw, -1)[:, None],
            _suffix(qp, chunk), _suffix(wp, chunk)]
    return args


def _assert_cand_outputs(got, want):
    names = ("cand_idx", "cand_score", "emitted", "row_hits", "iters")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "cand_score":
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize(
    "Q,W,d,bq,bw,chunk,tile_k,theta,lam,n_dup,gated",
    [
        (40, 100, 64, 32, 32, 32, 64, 0.8, 0.05, 12, False),   # ragged Q/W
        (40, 100, 64, 32, 32, 32, 64, 0.8, 0.05, 12, True),
        (32, 96, 200, 32, 32, 32, 64, 0.6, 0.1, 16, False),    # ragged d
        (32, 96, 200, 32, 32, 32, 64, 0.6, 0.1, 16, True),
        (16, 64, 256, 16, 32, 64, 8, 0.05, 0.01, 16, False),   # tile_k overflow
        (16, 64, 256, 16, 32, 64, 8, 0.05, 0.01, 16, True),
    ],
)
def test_tile_join_matches_pallas_interpret(
    Q, W, d, bq, bw, chunk, tile_k, theta, lam, n_dup, gated
):
    rng = np.random.default_rng(Q * 1000 + d + gated)
    args = _kernel_inputs(rng, Q, W, d, bq, bw, chunk, n_dup)
    nq, nw = args[0].shape[0] // bq, args[1].shape[0] // bw
    kw = dict(theta=theta, lam=lam, block_q=bq, block_w=bw, chunk_d=chunk,
              tile_k=tile_k)
    gate = None
    if gated:
        gate = (rng.random((nq, nw)) < 0.6).astype(np.int32)
    want = jkernel.sssj_join_candidates_kernel_call(
        *map(jnp.asarray, args), interpret=True,
        gate=None if gate is None else jnp.asarray(gate), **kw,
    )
    got = tkernel.sssj_join_candidates_kernel_call(
        *map(torch.from_numpy, args),
        gate=None if gate is None else torch.from_numpy(gate), **kw,
    )
    _assert_cand_outputs(got, want)
    if tile_k == 8:
        assert (np.asarray(want[2]) > tile_k).any()   # overflow exercised
    assert np.asarray(want[2]).sum() > 0


# the tile edges the consumers run on the card (64 x 64), unequal edges,
# one of them no compiled size (48 runs in the 64-wide tile), and edges
# above 128, which run in 128-wide sub-tiles (MultiTenantSSSJService's
# block = micro_batch = 256; 192 x 320 ragged in both)
TILE_EDGES = [(64, 64), (32, 128), (128, 48), (256, 256), (192, 320)]


@pytest.mark.parametrize("bq,bw", TILE_EDGES)
@pytest.mark.parametrize("gated", [False, True])
def test_tile_join_matches_pallas_interpret_at_tile_edges(bq, bw, gated):
    rng = np.random.default_rng(bq * 1000 + bw + gated)
    Q, W = bq + bq // 2 + 3, 3 * bw + bw // 3
    args = _kernel_inputs(rng, Q, W, 64, bq, bw, 32, Q // 3)
    args[3][:bw] -= 100.0             # the first window tile is time-dead
    nq, nw = args[0].shape[0] // bq, args[1].shape[0] // bw
    kw = dict(theta=0.6, lam=0.05, block_q=bq, block_w=bw, chunk_d=32,
              tile_k=16)
    gate = (rng.random((nq, nw)) < 0.7).astype(np.int32) if gated else None
    want = jkernel.sssj_join_candidates_kernel_call(
        *map(jnp.asarray, args), interpret=True,
        gate=None if gate is None else jnp.asarray(gate), **kw,
    )
    got = tkernel.cand_tiles_plain(
        *map(torch.from_numpy, args),
        gate=None if gate is None else torch.from_numpy(gate), **kw,
    )
    _assert_cand_outputs(got, want)
    assert np.asarray(want[2]).sum() > 0
    iters = np.asarray(want[4])
    assert (iters[:, 0] == 0).all() and (iters > 0).any()


def test_kernel_tile_edge_range():
    """The CUDA kernels take any tile edge of 1 or more: up to 128 in the
    smallest compiled edge that holds it, above that in sub-tiles of the
    largest (128); 0 raises."""
    for e in range(1, 129):
        t = tkernel.kernel_tile_edge(e)
        assert t in tkernel.KERNEL_TILES and t >= e
        assert all(s < e for s in tkernel.KERNEL_TILES if s < t)
    assert [tkernel.kernel_tile_edge(e) for e in (1, 32, 33, 48, 64, 65, 128)] == [
        32, 32, 64, 64, 64, 128, 128]
    assert [tkernel.kernel_tile_edge(e) for e in (129, 192, 256, 320, 4096)] == [
        128] * 5
    for e in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            tkernel.kernel_tile_edge(e)


# The CUDA tile joins form each f32 dot product on the tensor cores as
# 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
# lo.hi + hi.lo + hi.hi, each 128-feature block summed from zero and added
# to an f32 accumulator.  The kernels run only on the card; these tests
# emulate that arithmetic on the CPU and hold the accuracy it rests on.
TF32_MASK = -0x2000  # an int32 with the low 13 bits clear


def _tf32_rna(x):
    """f32 ``x`` as TF32, rounded to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` rounds it: on the int32 view, add half a unit of
    the 10th mantissa bit and clear the 13 bits below it."""
    bits = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).view(torch.int32)
    return ((bits + 0x1000) & TF32_MASK).view(torch.float32).numpy()


def _split_dot(a, b, block=128):
    """``a @ b.T`` as the kernels form it: the three TF32 products of each
    ``block`` features summed exactly and rounded once to f32, the blocks
    added into an f32 accumulator."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for c0 in range(0, a.shape[1], block):
        cols = slice(c0, c0 + block)
        x = [m[:, cols].astype(np.float64) for m in (ah, al, bh, bl)]
        part = x[1] @ x[2].T + x[0] @ x[3].T + x[0] @ x[2].T
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def test_tf32_rounding_matches_cvt_rna():
    """Ties go away from zero, a subnormal with 10 bits or fewer stays,
    the 13 low bits end clear, and hi + lo holds x to 2^-21 of its size."""
    x = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23,
                  1 + 3 * 2.0**-12, 0.0, 2.0**-130], np.float32)
    hi = _tf32_rna(x)
    np.testing.assert_array_equal(
        hi, np.array([1 + 2.0**-10, -(1 + 2.0**-10), 1.0, 1 + 2.0**-10, 0.0, 2.0**-130],
                     np.float32))
    rng = np.random.default_rng(19)
    v = rng.standard_normal(4096).astype(np.float32)
    hi = _tf32_rna(v)
    lo = _tf32_rna(v - hi)
    for part in (hi, lo):
        assert not (part.view(np.int32) & 0x1FFF).any()
    assert (np.abs(hi.astype(np.float64) + lo - v) <= 2.0**-21 * np.abs(v)).all()


def test_3xtf32_dot_keeps_f32_accuracy():
    """Seeded unit vectors at d = 1024, a quarter of the pairs near-
    duplicates: the split dot stays within 2e-6 of the f64 dot."""
    rng = np.random.default_rng(1024)
    a = _unit(rng, 64, 1024)
    b = _unit(rng, 256, 1024)
    b[:16] = a[:16] + 0.002 * rng.standard_normal((16, 1024)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    err = np.abs(_split_dot(a, b) - exact).max()
    assert err <= 2e-6
    assert exact.max() > 0.99   # the near-duplicates reach scores near 1


def test_3xtf32_scores_give_the_plain_hits():
    """A seeded 128 x 512 join at d = 1024 with near-duplicates: the
    emulated scores, decayed as the plain version decays them, hit at
    θ 0.9 exactly where ``cand_tiles_plain`` emits."""
    rng = np.random.default_rng(1919)
    q, w, tq, tw, uq, uw = _stream(rng, 128, 512, 1024, 40, noise=0.002)
    theta, lam, blk = 0.9, 0.01, 128
    args = [q, w, tq[:, None], tw[:, None], uq[:, None], uw[:, None],
            _suffix(q, blk), _suffix(w, blk)]
    cand_idx, _, emitted, _, _ = tkernel.cand_tiles_plain(
        *map(torch.from_numpy, args), theta=theta, lam=lam, block_q=blk,
        block_w=blk, chunk_d=blk, tile_k=blk * blk)
    plain = set()
    for tj in range(512 // blk):
        for f in cand_idx[0, tj][: int(emitted[0, tj])].tolist():
            plain.add((f // blk, tj * blk + f % blk))
    tq_t, tw_t = torch.from_numpy(tq), torch.from_numpy(tw)
    decay = torch.exp(-lam * (tq_t[:, None] - tw_t[None, :]).abs())
    order = torch.from_numpy(uq)[:, None] > torch.from_numpy(uw)[None, :]
    score = torch.from_numpy(_split_dot(q, w)) * torch.where(order, decay, 0.0)
    hits = torch.nonzero((score >= theta) & (score > 0)).tolist()
    assert len(plain) >= 20
    assert {tuple(h) for h in hits} == plain


def test_tile_join_multi_tenant_lanes():
    """Stream ids and per-row (θ, λ), the lanes the kernel signature
    carries for the multi-tenant runtime."""
    rng = np.random.default_rng(5)
    bq = bw = chunk = 32
    args = _kernel_inputs(rng, 40, 96, 64, bq, bw, chunk, 16)
    Qp, Wp = args[0].shape[0], args[1].shape[0]
    lanes = dict(
        sq=rng.integers(0, 3, (Qp, 1)).astype(np.int32),
        sw=rng.integers(0, 3, (Wp, 1)).astype(np.int32),
        theta_q=rng.uniform(0.5, 0.9, (Qp, 1)).astype(np.float32),
        lam_q=rng.uniform(0.01, 0.1, (Qp, 1)).astype(np.float32),
    )
    kw = dict(theta=0.5, lam=0.01, block_q=bq, block_w=bw, chunk_d=chunk,
              tile_k=64)
    want = jkernel.sssj_join_candidates_kernel_call(
        *map(jnp.asarray, args), interpret=True,
        **{k: jnp.asarray(v) for k, v in lanes.items()}, **kw,
    )
    got = tkernel.sssj_join_candidates_kernel_call(
        *map(torch.from_numpy, args),
        **{k: torch.from_numpy(v) for k, v in lanes.items()}, **kw,
    )
    _assert_cand_outputs(got, want)
    assert np.asarray(want[2]).sum() > 0


def _assert_join_candidates(got, want):
    for name in ("uid_a", "uid_b", "kept", "emitted"):
        np.testing.assert_array_equal(
            getattr(got.cands, name).numpy(), np.asarray(getattr(want.cands, name)),
            err_msg=name,
        )
    np.testing.assert_allclose(
        got.cands.score.numpy(), np.asarray(want.cands.score), atol=SCORE_ATOL
    )
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(
        got.gate_stats.numpy(), np.asarray(want.gate_stats)
    )


def _summary_pair(w, tw, uw, bw, chunk):
    js = j_summarize(jnp.asarray(w), jnp.asarray(tw), jnp.asarray(uw),
                     block_w=bw, chunk_d=chunk)
    ts = StripSummary(*(torch.from_numpy(np.array(x)) for x in js))
    return js, ts


@pytest.mark.parametrize(
    "Q,W,d,impl,gated,tile_k,theta",
    [
        (40, 100, 64, "pallas", False, 64, 0.7),
        (40, 100, 64, "pallas", True, 64, 0.7),
        (32, 160, 200, "pallas", True, 64, 0.7),   # ragged d through the ops pad
        (32, 64, 64, "pallas", True, 4, 0.1),      # tile_k overflow
        (40, 100, 64, "dense", False, 64, 0.7),
        (32, 64, 64, "dense", False, 4, 0.1),
        (20, 100, 64, "pallas", True, 64, 0.7),    # Q < block_q: routed to dense
    ],
)
def test_join_candidates_matches_reference(Q, W, d, impl, gated, tile_k, theta):
    rng = np.random.default_rng(Q + W + d + tile_k)
    q, w, tq, tw, uq, uw = _stream(rng, Q, W, d, 12)
    # half the window is older than the horizon, so the gate has work
    tw = tw - np.where(np.arange(W) < W // 2, 50.0, 0.0).astype(np.float32)
    bq = bw = chunk = 32
    kw = dict(theta=theta, lam=0.05, tile_k=tile_k, block_q=bq, block_w=bw,
              chunk_d=chunk)
    js = ts = None
    if gated:
        js, ts = _summary_pair(w, tw, uw, bw, chunk)
    want = jops.sssj_join_candidates(
        *map(jnp.asarray, (q, w, tq, tw, uq, uw)), impl=impl, interpret=True,
        summary=js, **kw,
    )
    got = tops.sssj_join_candidates(
        q, w, tq, tw, uq, uw, impl=None if impl == "pallas" else impl,
        summary=ts, device=CPU, **kw,
    )
    _assert_join_candidates(got, want)
    emitted = np.asarray(want.cands.emitted)
    assert emitted.sum() > 0
    if tile_k == 4:
        assert (emitted > tile_k).any()           # overflow exercised


def test_join_candidates_multi_tenant_matches_reference():
    rng = np.random.default_rng(17)
    q, w, tq, tw, uq, uw = _stream(rng, 40, 100, 64, 16)
    lanes = dict(
        sq=rng.integers(0, 2, 40).astype(np.int32),
        sw=rng.integers(0, 2, 100).astype(np.int32),
        theta_q=rng.uniform(0.6, 0.8, 40).astype(np.float32),
        lam_q=rng.uniform(0.01, 0.05, 40).astype(np.float32),
    )
    kw = dict(theta=0.6, lam=0.01, tile_k=64, block_q=32, block_w=32, chunk_d=32)
    want = jops.sssj_join_candidates(
        *map(jnp.asarray, (q, w, tq, tw, uq, uw)), impl="pallas",
        interpret=True, **{k: jnp.asarray(v) for k, v in lanes.items()}, **kw,
    )
    got = tops.sssj_join_candidates(q, w, tq, tw, uq, uw, device=CPU,
                                    **lanes, **kw)
    _assert_join_candidates(got, want)


@pytest.mark.parametrize("d,chunk", [(64, 32), (200, 32), (256, 128)])
def test_suffix_chunk_norms_matches_reference(d, chunk):
    rng = np.random.default_rng(d)
    x = _pad(_unit(rng, 50, d), chunk, axis=1)
    np.testing.assert_allclose(
        tops.suffix_chunk_norms(torch.from_numpy(x), chunk).numpy(),
        np.asarray(jops.suffix_chunk_norms(jnp.asarray(x), chunk)),
        atol=1e-6,
    )


def test_join_rejects_unported_impl():
    """``"pallas"`` names no route of the port; ``"scan"`` runs, and on
    sub-block inputs it takes the dense path, as in the reference."""
    rng = np.random.default_rng(4)
    x = _unit(rng, 4, 8)
    x[3] = x[0]                              # one pair to emit
    t = np.zeros(4, np.float32)
    u = np.arange(4, dtype=np.int32)
    kw = dict(theta=0.9, lam=0.1, device=CPU)
    scan = tops.sssj_join_candidates(x, x, t, t, u, u, impl="scan", **kw)
    dense = tops.sssj_join_candidates(x, x, t, t, u, u, impl="dense", **kw)
    for a, b in zip((*scan.cands, scan.row_mask, scan.iters, scan.gate_stats),
                    (*dense.cands, dense.row_mask, dense.iters, dense.gate_stats)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(scan.cands.emitted.sum()) == 1
    with pytest.raises(ValueError):
        tops.sssj_join_candidates(x, x, t, t, u, u, theta=0.9, lam=0.1,
                                  impl="pallas", device=CPU)

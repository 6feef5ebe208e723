"""The port's strip summaries and pre-launch gate against the JAX package.

Tolerances: ``tmin/tmax/umax``, gate bits and gate stats exact;
``vmax/cnorm`` ``atol=1e-6`` (sums of squares in another order); the
bound matrix ``atol=1e-5``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine.window import init_window as j_init_window
from repro.engine.window import push_with_overflow as j_push
from repro.kernels.sssj_join import gate as jgate
from repro_torch.engine.window import init_window, push_with_overflow
from repro_torch.kernels.sssj_join import gate as tgate

CPU = "cpu"


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _window(rng, cap, d, n_live):
    """A ring with ``n_live`` filled slots (the rest empty)."""
    vecs = np.zeros((cap, d), np.float32)
    ts = np.full(cap, 3.0e30, np.float32)
    uids = np.full(cap, -1, np.int32)
    vecs[:n_live] = _unit(rng, n_live, d)
    ts[:n_live] = np.sort(rng.random(n_live) * 10).astype(np.float32)
    uids[:n_live] = np.arange(n_live, dtype=np.int32)
    return vecs, ts, uids


def _assert_summary(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)   # vmax
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)   # cnorm
    for g, w in zip(got[2:], want[2:]):                      # tmin tmax umax
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "cap,d,bw,chunk,n_live",
    [(64, 32, 16, 16, 64), (40, 32, 16, 16, 30), (100, 200, 32, 64, 77)],
)
def test_summarize_strips_matches_reference(cap, d, bw, chunk, n_live):
    rng = np.random.default_rng(cap + d)
    vecs, ts, uids = _window(rng, cap, d, n_live)
    want = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                                  jnp.asarray(uids), block_w=bw, chunk_d=chunk)
    got = tgate.summarize_strips(torch.from_numpy(vecs), torch.from_numpy(ts),
                                 torch.from_numpy(uids), block_w=bw, chunk_d=chunk)
    _assert_summary(got, want)


def test_init_strip_summary_matches_reference():
    want = jgate.init_strip_summary(40, 200, block_w=16, chunk_d=64)
    got = tgate.init_strip_summary(40, 200, block_w=16, chunk_d=64, device=CPU)
    _assert_summary(got, want)


@pytest.mark.parametrize(
    "cap,dest",
    [
        (40, [0, 1, 2, 17]),
        (40, [33, 39, 40, 40]),     # ragged last strip + drop sentinel
        (40, [40, 40, 40, 40]),     # every row dropped
        (64, [63, 0, 1, 2]),        # wrap
    ],
)
def test_refresh_matches_reference(cap, dest):
    rng = np.random.default_rng(cap + sum(dest))
    d, bw, chunk = 32, 16, 16
    vecs, ts, uids = _window(rng, cap, d, cap - 5)
    base = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                                  jnp.asarray(uids), block_w=bw, chunk_d=chunk)
    # post-write arrays: the destination slots now hold new items
    dest = np.asarray(dest, np.int32)
    real = dest[dest < cap]
    vecs[real] = _unit(rng, real.size, d)
    ts[real] = 20.0 + np.arange(real.size, dtype=np.float32)
    uids[real] = 1000 + np.arange(real.size, dtype=np.int32)
    want = jgate.refresh_strip_summary(
        base, jnp.asarray(vecs), jnp.asarray(ts), jnp.asarray(uids),
        jnp.asarray(dest), block_w=bw, chunk_d=chunk,
    )
    got = tgate.StripSummary(*(torch.from_numpy(np.array(x)) for x in base))
    tgate.refresh_strip_summary(
        got, torch.from_numpy(vecs), torch.from_numpy(ts),
        torch.from_numpy(uids), torch.from_numpy(dest), block_w=bw, chunk_d=chunk,
    )
    _assert_summary(got, want)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize(
    "theta,lam,t_shift",
    [(0.8, 0.05, 0.0), (0.5, 0.5, 3.0), (0.3, 0.01, 0.0)],
)
def test_strip_gate_matches_reference(impl, theta, lam, t_shift):
    rng = np.random.default_rng(int(theta * 100) + int(t_shift))
    cap, d, bq, bw, chunk = 128, 64, 32, 16, 32
    vecs, ts, uids = _window(rng, cap, d, 100)
    q = _unit(rng, 64, d)
    q[:8] = vecs[90:98]                               # near-duplicates: alive
    tq = (10.0 + t_shift + rng.random(64)).astype(np.float32)
    jsum = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                                  jnp.asarray(uids), block_w=bw, chunk_d=chunk)
    want_gate, want_stats = jgate.strip_gate(
        jnp.asarray(q), jsum, block_q=bq, chunk_d=chunk,
        tq_lo=jnp.min(tq), tq_hi=jnp.max(tq), th_min=theta, lam_min=lam,
        impl=impl, interpret=True,
    )
    tsum = tgate.StripSummary(*(torch.from_numpy(np.array(x)) for x in jsum))
    got_gate, got_stats = tgate.strip_gate(
        torch.from_numpy(q), tsum, block_q=bq, chunk_d=chunk,
        tq_lo=float(tq.min()), tq_hi=float(tq.max()), th_min=theta,
        lam_min=lam, device=CPU,
    )
    np.testing.assert_array_equal(got_gate.numpy(), np.asarray(want_gate))
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))


def test_gate_bound_matches_pallas_interpret():
    """The bound matrix itself, plain version vs the TPU kernel's body."""
    rng = np.random.default_rng(3)
    qp = _unit(rng, 64, 128)
    vecs, ts, uids = _window(rng, 256, 128, 200)
    s = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                               jnp.asarray(uids), block_w=32, chunk_d=32)
    qa = np.abs(qp)
    qcn = np.asarray(jgate._chunk_norms(jnp.asarray(qp), 32))
    want = jgate._tile_ub_pallas(jnp.asarray(qa), jnp.asarray(qcn), s.vmax,
                                 s.cnorm, block_q=32, interpret=True)
    got = tgate.gate_ub(torch.from_numpy(qa), torch.from_numpy(np.array(qcn)),
                        torch.from_numpy(np.array(s.vmax)),
                        torch.from_numpy(np.array(s.cnorm)), block_q=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert tgate.gate_ub.launches == 0   # a CPU tensor runs the plain version


@pytest.mark.parametrize("bq,bw", [(64, 64), (32, 128), (128, 48), (256, 256),
                                   (192, 320)])
def test_gate_bound_matches_pallas_interpret_at_tile_edges(bq, bw):
    """The bound matrix at the query-tile edges the CUDA kernel now takes,
    over strips of ``bw`` window rows."""
    rng = np.random.default_rng(bq + bw)
    qp = _unit(rng, 2 * bq, 128)
    vecs, ts, uids = _window(rng, 5 * bw, 128, 4 * bw + 7)
    s = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                               jnp.asarray(uids), block_w=bw, chunk_d=32)
    qa = np.abs(qp)
    qcn = np.asarray(jgate._chunk_norms(jnp.asarray(qp), 32))
    want = jgate._tile_ub_pallas(jnp.asarray(qa), jnp.asarray(qcn), s.vmax,
                                 s.cnorm, block_q=bq, interpret=True)
    got = tgate.gate_ub_plain(torch.from_numpy(qa), torch.from_numpy(np.array(qcn)),
                              torch.from_numpy(np.array(s.vmax)),
                              torch.from_numpy(np.array(s.cnorm)), block_q=bq)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the kernel's order of summation gives the same bounds
    blocked = _gate_ub_blocked(qa, np.asarray(qcn), np.asarray(s.vmax),
                               np.asarray(s.cnorm), bq)
    np.testing.assert_allclose(blocked, np.asarray(want), atol=1e-5)


GATE_SUB = 32   # features per sub-slab of csrc/gate_ub.cu's products (KS)


def _gate_ub_blocked(qa, qcn, vmax, cnorm, bq):
    """``csrc/gate_ub.cu``'s order of summation in numpy: the features cut
    into ``GATE_SPLIT`` parts of whole sub-slabs of ``GATE_SUB``, each
    sub-slab's products summed on their own and added to its part's sum,
    the parts added in order; then, per query tile, the max over its rows
    of the min with the chunk-ℓ2 bound."""
    Qp, d = qa.shape
    nsub = -(-d // GATE_SUB)
    per = -(-nsub // tgate.GATE_SPLIT)
    pb = np.zeros((Qp, vmax.shape[0]), np.float32)
    for part in range(tgate.GATE_SPLIT):
        acc = np.zeros_like(pb)
        for sb in range(part * per, min(nsub, part * per + per)):
            f = slice(GATE_SUB * sb, min(GATE_SUB * (sb + 1), d))
            acc += qa[:, f] @ vmax[:, f].T
        pb += acc
    v = np.minimum(pb, qcn @ cnorm.T)
    return v.reshape(Qp // bq, bq, -1).max(1)


@pytest.mark.parametrize("Qp,ns,bq", [
    (128, 2048, 128),   # the main path's shapes
    (256, 40, 64), (96, 5, 48), (7, 3, 1), (300, 100, 100), (512, 40, 256),
])
def test_gate_workspace(Qp, ns, bq):
    """The partial sums the kernel's products write: one (Qp, ns) slice per
    part of the features."""
    assert tgate.gate_workspace(Qp, ns, bq) == (tgate.GATE_SPLIT, Qp, ns)


@pytest.mark.parametrize("Qp,ns,bq", [(0, 1, 0), (100, 4, 48)])
def test_gate_workspace_refuses_bad_tiles(Qp, ns, bq):
    with pytest.raises(ValueError, match="multiple of block_q"):
        tgate.gate_workspace(Qp, ns, bq)


@pytest.mark.parametrize("Qp,d,bq,ns", [(96, 100, 48, 70), (7, 40, 1, 3), (300, 256, 100, 130)])
def test_gate_bound_blocking_matches_pallas_interpret(Qp, d, bq, ns):
    """The kernel's order of summation against the TPU kernel's body where
    it has ragged parts: a ragged last sub-slab (d 100, 40), parts of d
    with no sub-slab (d 40: two sub-slabs in eight parts), one-row tiles,
    tiles that are not a power of two."""
    rng = np.random.default_rng(Qp + d + bq)
    qa = np.abs(_unit(rng, Qp, d))
    vmax = np.abs(rng.standard_normal((ns, d)).astype(np.float32)) / 8
    qcn = np.abs(rng.standard_normal((Qp, 4)).astype(np.float32))
    cnorm = np.abs(rng.standard_normal((ns, 4)).astype(np.float32))
    want = jgate._tile_ub_pallas(*map(jnp.asarray, (qa, qcn, vmax, cnorm)), block_q=bq,
                                 interpret=True)
    np.testing.assert_allclose(_gate_ub_blocked(qa, qcn, vmax, cnorm, bq), np.asarray(want),
                               atol=1e-5)
    got = tgate.gate_ub(*map(torch.from_numpy, (qa, qcn, vmax, cnorm)), block_q=bq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("d", [100, 128])
def test_strip_gate_narrow_vmax_matches_reference(impl, d):
    """Window rows of ``d`` features against queries padded to the next
    ``chunk_d`` multiple: at d 100 the summary's vmax is narrower than the
    queries and is zero-padded, at d 128 it is taken as it is."""
    rng = np.random.default_rng(d)
    cap, bq, bw, chunk, d_pad = 128, 32, 16, 32, 128
    vecs, ts, uids = _window(rng, cap, d, 100)
    q = np.zeros((64, d_pad), np.float32)
    q[:, :d] = _unit(rng, 64, d)
    q[:8, :d] = vecs[90:98]                           # near-duplicates: alive
    tq = (10.0 + rng.random(64)).astype(np.float32)
    jsum = jgate.summarize_strips(jnp.asarray(vecs), jnp.asarray(ts),
                                  jnp.asarray(uids), block_w=bw, chunk_d=chunk)
    assert jsum.vmax.shape == (cap // bw, d)
    want_gate, want_stats = jgate.strip_gate(
        jnp.asarray(q), jsum, block_q=bq, chunk_d=chunk, tq_lo=jnp.min(tq),
        tq_hi=jnp.max(tq), th_min=0.5, lam_min=0.05, impl=impl, interpret=True,
    )
    tsum = tgate.StripSummary(*(torch.from_numpy(np.array(x)) for x in jsum))
    got_gate, got_stats = tgate.strip_gate(
        torch.from_numpy(q), tsum, block_q=bq, chunk_d=chunk, tq_lo=float(tq.min()),
        tq_hi=float(tq.max()), th_min=0.5, lam_min=0.05, device=CPU,
    )
    np.testing.assert_array_equal(got_gate.numpy(), np.asarray(want_gate))
    np.testing.assert_array_equal(got_stats.numpy(), np.asarray(want_stats))
    assert np.asarray(want_gate).any() and not np.asarray(want_gate).all()


@pytest.mark.parametrize("cap", [40, 64])
def test_refresh_equals_rebuild_through_wrap(cap):
    """The summary refreshed on every push equals a full rebuild of the
    ring after each push, through several wraps of a ragged ring; and the
    reference's pushes keep the same summary."""
    rng = np.random.default_rng(cap)
    d, bw, chunk, b = 32, 16, 16, 16
    state = init_window(cap, d, summary_block_w=bw, summary_chunk_d=chunk,
                        device=CPU)
    jstate = j_init_window(cap, d, summary_block_w=bw, summary_chunk_d=chunk)
    uid, t = 0, 0.0
    for step in range(12):
        n_valid = b if step % 3 else b - 5           # padded micro-batches
        v = _unit(rng, b, d)
        tq = (t + np.arange(b) * 0.1).astype(np.float32)
        uq = np.where(np.arange(b) < n_valid, uid + np.arange(b), -1).astype(np.int32)
        t_max = float(tq[n_valid - 1])
        push_with_overflow(
            state, torch.from_numpy(v), torch.from_numpy(tq),
            torch.from_numpy(uq), n_valid, torch.tensor(t_max), 5.0,
            summary_block_w=bw, summary_chunk_d=chunk,
        )
        jstate = j_push(
            jstate, jnp.asarray(v), jnp.asarray(tq), jnp.asarray(uq),
            n_valid, jnp.float32(t_max), 5.0,
            summary_block_w=bw, summary_chunk_d=chunk,
        )
        uid += n_valid
        t += 2.0
        rebuilt = tgate.summarize_strips(state.vecs, state.ts, state.uids,
                                         block_w=bw, chunk_d=chunk)
        _assert_summary(state.summary, rebuilt)
        _assert_summary(state.summary, jstate.summary)

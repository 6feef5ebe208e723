"""The port's ``"scan"`` join impl on the CPU against the reference's.

The same numpy-seeded inputs go through ``repro``'s
``sssj_join_candidates(impl="scan")`` and ``repro_torch``'s with
``device="cpu"``: gated and ungated, over a ring that has wrapped and one
that has not, ragged Q, ``d < chunk_d`` and ``d % chunk_d != 0``, the
stream lanes with per-row θ/λ, and a ``tile_k`` overflow.  Tolerances:
every candidate leaf but the scores, ``row_mask``, ``iters`` and
``gate_stats`` exact; scores ``atol=1e-6``.  Then ``StreamEngine(
join_impl="scan")`` against the reference's over several pushes: drained
pairs, ``stats()``, the prune counters and the final window equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import EngineConfig as JConfig
from repro.engine import StreamEngine as JEngine
from repro.kernels.sssj_join import ops as jops
from repro.kernels.sssj_join.gate import summarize_strips as j_summarize
from repro_torch.data import dense_embedding_stream, topic_drift_stream
from repro_torch.engine import EngineConfig, StreamEngine
from repro_torch.engine.window import window_to_numpy
from repro_torch.kernels.sssj_join import ops as tops
from repro_torch.kernels.sssj_join.gate import StripSummary

SCORE_ATOL = 1e-6
CPU = "cpu"
EMPTY_T = 3.0e30


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ring(rng, W, n_written, d, Q, n_dup, rate=8.0):
    """A ring of ``W`` slots after ``n_written`` oldest-first writes (uid
    ``u`` at slot ``u % W``, so ``n_written > W`` has wrapped and
    ``n_written < W`` leaves empty slots), and ``Q`` newer queries,
    ``n_dup`` of them near-copies of the newest live items."""
    items = _unit(rng, n_written, d)
    t_items = (np.arange(n_written) / rate).astype(np.float32)
    w = np.zeros((W, d), np.float32)
    tw = np.full(W, EMPTY_T, np.float32)
    uw = np.full(W, -1, np.int32)
    for u in range(max(0, n_written - W), n_written):
        w[u % W], tw[u % W], uw[u % W] = items[u], t_items[u], u
    q = _unit(rng, Q, d)
    live = np.nonzero(uw >= 0)[0]
    src = rng.choice(live[np.argsort(uw[live])][-48:], size=n_dup)
    noise = rng.standard_normal((n_dup, d)).astype(np.float32)
    q[:n_dup] = w[src] + (0.3 / np.sqrt(d)) * noise
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tq = (t_items[-1] + (1 + np.arange(Q)) / rate).astype(np.float32)
    uq = np.arange(n_written, n_written + Q, dtype=np.int32)
    return q, w, tq, tw, uq, uw


def _assert_same(got, want):
    for name in ("uid_a", "uid_b", "kept", "emitted"):
        np.testing.assert_array_equal(
            getattr(got.cands, name).numpy(), np.asarray(getattr(want.cands, name)),
            err_msg=name,
        )
    np.testing.assert_allclose(got.cands.score.numpy(), np.asarray(want.cands.score),
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.gate_stats.numpy(), np.asarray(want.gate_stats))


def _join_pair(q, w, tq, tw, uq, uw, *, gated, lanes=None, **kw):
    """``(port, reference)`` results of ``impl="scan"`` on the same inputs."""
    lanes = lanes or {}
    js = ts = None
    if gated:
        js = j_summarize(jnp.asarray(w), jnp.asarray(tw), jnp.asarray(uw),
                         block_w=kw["block_w"], chunk_d=kw["chunk_d"])
        ts = StripSummary(*(torch.from_numpy(np.array(x)) for x in js))
    want = jops.sssj_join_candidates(
        *map(jnp.asarray, (q, w, tq, tw, uq, uw)), impl="scan", summary=js,
        **{k: jnp.asarray(v) for k, v in lanes.items()}, **kw,
    )
    got = tops.sssj_join_candidates(q, w, tq, tw, uq, uw, impl="scan",
                                    summary=ts, device=CPU, **lanes, **kw)
    return got, want


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize(
    "case,Q,W,n_written,d,chunk,tile_k,theta,lam",
    [
        ("unwrapped", 32, 256, 200, 64, 32, 64, 0.8, 0.05),
        ("wrapped", 32, 256, 520, 64, 32, 64, 0.8, 0.05),
        ("ragged_q", 40, 256, 700, 64, 32, 64, 0.8, 0.05),
        ("d_below_chunk", 32, 256, 700, 24, 32, 64, 0.8, 0.05),
        ("d_ragged", 32, 192, 500, 200, 64, 64, 0.8, 0.05),
        ("tile_k_overflow", 32, 256, 700, 64, 32, 4, 0.1, 0.1),
        ("all_dead", 32, 256, 700, 64, 32, 64, 0.8, 50.0),
        ("one_strip", 32, 32, 40, 64, 32, 64, 0.8, 0.05),      # the self join's shape
        ("one_strip_dead", 32, 32, 40, 64, 32, 64, 0.8, 0.05),
    ],
)
def test_scan_matches_reference_scan(case, Q, W, n_written, d, chunk, tile_k,
                                     theta, lam, gated):
    rng = np.random.default_rng(Q + W + n_written + d + tile_k)
    q, w, tq, tw, uq, uw = _ring(rng, W, n_written, d, Q, 12)
    if case.endswith("dead"):        # the queries lie far past the horizon
        tq = tq + 100.0
    kw = dict(theta=theta, lam=lam, tile_k=tile_k, block_q=32, block_w=32,
              chunk_d=chunk)
    got, want = _join_pair(q, w, tq, tw, uq, uw, gated=gated, **kw)
    _assert_same(got, want)
    emitted = np.asarray(want.cands.emitted)
    iters = np.asarray(want.iters)
    if case.endswith("dead"):
        assert emitted.sum() == 0 and iters.sum() == 0
    elif case == "one_strip":
        assert emitted.sum() > 0 and (iters > 0).all()
    else:
        assert emitted.sum() > 0
        assert (iters == 0).any() and (iters > 0).any()   # the walk is partial
    if case == "tile_k_overflow":
        assert (emitted > tile_k).any()
    if case == "wrapped":       # the walk crosses the ring's end
        live = iters.max(0) > 0
        assert live[0] and live[-1]


@pytest.mark.parametrize("gated", [False, True])
def test_scan_multi_tenant_lanes_match_reference(gated):
    rng = np.random.default_rng(23)
    Q, W = 40, 256
    q, w, tq, tw, uq, uw = _ring(rng, W, 600, 64, Q, 16)
    lanes = dict(
        sq=rng.integers(0, 3, Q).astype(np.int32),
        sw=rng.integers(0, 3, W).astype(np.int32),
        theta_q=rng.uniform(0.6, 0.8, Q).astype(np.float32),
        lam_q=rng.uniform(0.01, 0.05, Q).astype(np.float32),
    )
    kw = dict(theta=0.6, lam=0.01, tile_k=64, block_q=32, block_w=32, chunk_d=32)
    got, want = _join_pair(q, w, tq, tw, uq, uw, gated=gated, lanes=lanes, **kw)
    _assert_same(got, want)
    assert np.asarray(want.cands.emitted).sum() > 0


def test_scan_chunks_the_walk(monkeypatch):
    """Products split into many chunks give the one-chunk result."""
    rng = np.random.default_rng(5)
    q, w, tq, tw, uq, uw = _ring(rng, 256, 700, 64, 32, 12)
    kw = dict(theta=0.8, lam=0.05, tile_k=64, block_q=32, block_w=32, chunk_d=32)
    whole = tops.sssj_join_candidates(q, w, tq, tw, uq, uw, impl="scan",
                                      device=CPU, **kw)
    monkeypatch.setattr(tops, "SCAN_SCORES", 32 * 32)     # one strip a product
    split = tops.sssj_join_candidates(q, w, tq, tw, uq, uw, impl="scan",
                                      device=CPU, **kw)
    for a, b in zip(whole.cands, split.cands):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(whole.row_mask.numpy(), split.row_mask.numpy())
    assert whole.cands.emitted.sum() > 0


# --------------------------------------------------------------------- #
# the engine with join_impl="scan"
# --------------------------------------------------------------------- #
def _cfg_kw(**kw):
    base = dict(theta=0.8, lam=0.05, capacity=512, d=64, micro_batch=32,
                max_pairs=1024, block_q=32, block_w=32, chunk_d=32,
                join_impl="scan")
    base.update(kw)
    return base


def _run(eng, vecs, ts, step):
    for i in range(0, len(vecs), step):
        eng.push(vecs[i:i + step], ts[i:i + step])
    return eng.drain_arrays(return_masks=True)


@pytest.mark.parametrize(
    "kw,stream",
    [
        (dict(), "dup"),                                  # gate on
        (dict(l2_gate=False), "dup"),                     # ungated walk
        (dict(capacity=64, lam=0.005), "dup"),            # wrap over live slots
        (dict(d=200, chunk_d=64), "dup"),                 # ragged d
        (dict(d=24), "dup"),                              # d < chunk_d
        (dict(tile_k=4), "burst"),                        # tile_k overflow
        (dict(d=64, theta=0.7, lam=0.01, capacity=256), "topic"),  # l2 kills
    ],
)
def test_scan_engine_matches_reference_scan_engine(kw, stream):
    cfg = _cfg_kw(**kw)
    d = cfg["d"]
    if stream == "dup":
        vecs, ts = dense_embedding_stream(320, d, seed=7, rate=2.0)
    elif stream == "burst":
        vecs, ts = dense_embedding_stream(320, d, seed=7, rate=20.0, dup_frac=0.9)
    else:
        vecs, ts = topic_drift_stream(384, d, n_topics=8, seg=64, seed=3, rate=4.0)
    want_eng = JEngine(JConfig(**cfg))
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    ua, ub, sc, mk = _run(got_eng, vecs, ts, 80)
    ja, jb, js, jm = _run(want_eng, vecs, ts, 80)
    np.testing.assert_array_equal(ua, ja)
    np.testing.assert_array_equal(ub, jb)
    np.testing.assert_allclose(sc, js, atol=SCORE_ATOL)
    np.testing.assert_array_equal(mk, jm)
    assert len(ua) > 0
    assert got_eng.stats() == want_eng.stats()
    prune = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k.startswith("engine/prune/")}
    assert prune(got_eng.metrics()) == prune(want_eng.metrics())
    final = window_to_numpy(got_eng.state)
    for name in ("uids", "ts", "vecs", "sids"):
        np.testing.assert_array_equal(final[name],
                                      np.asarray(getattr(want_eng.state, name)))
    assert final["cursor"] == int(want_eng.state.cursor)
    assert final["overflow"] == int(want_eng.state.overflow)
    if kw.get("capacity") == 64:
        assert got_eng.stats()["window_overflow"] > 0
    if "tile_k" in kw:
        assert got_eng.stats()["pairs_dropped_tile"] > 0
    if stream == "topic":
        assert got_eng.metrics()["engine/prune/tiles_skipped_l2"] > 0
    got_eng.close()
    want_eng.close()


def test_scan_engine_matches_kernel_route():
    """On the CPU the scan and the kernel route drain the same pairs."""
    vecs, ts = dense_embedding_stream(320, 64, seed=2, rate=2.0)
    runs = []
    for impl in ("scan", None):
        eng = StreamEngine(EngineConfig(**_cfg_kw(join_impl=impl)), device=CPU)
        runs.append(_run(eng, vecs, ts, 64))
        eng.close()
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_allclose(a, b, atol=SCORE_ATOL)

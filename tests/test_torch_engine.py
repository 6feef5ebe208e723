"""The port's StreamEngine on the CPU against ``repro.engine.StreamEngine``.

The same numpy-seeded stream goes through the reference engine (Pallas
kernel in interpret mode, or the dense oracle) and the port's engine with
``device="cpu"`` (the kernels' plain versions).  Tolerances: drained uids,
row masks, ``stats()`` and ``engine/prune/*`` exact; scores ``atol=1e-5``.
Pair sets are held identical outside an ε-band of 1e-5 around θ; on
these streams no pair lies in the band, which the tests check.  On a
named CUDA device (never touched) the kernel route's step refuses joins
smaller than one tile.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JConfig
from repro.engine import StreamEngine as JEngine
from repro_torch.data import dense_embedding_stream, topic_drift_stream
from repro_torch.engine import (
    EngineConfig,
    StreamEngine,
    init_telemetry,
    make_batch_step,
    make_micro_step,
)
from repro_torch.engine.window import init_window, window_from_numpy, window_to_numpy

SCORE_ATOL = 1e-5
BAND = 1e-5
CPU = "cpu"
_SCHEMA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "metrics_schema.json")


def _cfg_kw(**kw):
    base = dict(theta=0.8, lam=0.05, capacity=512, d=64, micro_batch=32,
                max_pairs=1024, block_q=32, block_w=32, chunk_d=32)
    base.update(kw)
    return base


def _run(eng, vecs, ts, step):
    for i in range(0, len(vecs), step):
        eng.push(vecs[i:i + step], ts[i:i + step])
    return eng.drain_arrays(return_masks=True)


def _assert_same_emission(got, want, theta):
    ua, ub, sc, mk = got
    ja, jb, js, jm = want
    gp = dict(zip(zip(ua.tolist(), ub.tolist()), sc.tolist()))
    jp = dict(zip(zip(ja.tolist(), jb.tolist()), js.tolist()))
    differ = gp.keys() ^ jp.keys()
    assert all(abs({**gp, **jp}[k] - theta) <= BAND for k in differ), differ
    assert not differ            # and none of these streams has band pairs
    # same pairs in the same drain order (micro-batch, segment, rank)
    np.testing.assert_array_equal(ua, ja)
    np.testing.assert_array_equal(ub, jb)
    np.testing.assert_allclose(sc, js, atol=SCORE_ATOL)
    np.testing.assert_array_equal(mk, jm)


def _prune(m):
    return {k: v for k, v in m.items() if k.startswith("engine/prune/")}


@pytest.mark.parametrize(
    "kw,stream",
    [
        (dict(), "dup"),                                   # gate on, no wrap
        (dict(capacity=64, lam=0.005), "dup"),             # wrap over live slots
        (dict(l2_gate=False), "dup"),                      # ungated kernel path
        (dict(d=200, chunk_d=64), "dup"),                  # ragged d
        (dict(tile_k=4), "burst"),                         # tile_k overflow
        (dict(max_pairs=8), "burst"),                      # max_pairs overflow
        (dict(d=64, theta=0.7, lam=0.01, capacity=256), "topic"),  # l2 kills
    ],
)
def test_engine_matches_reference_pallas(kw, stream):
    cfg = _cfg_kw(**kw)
    d = cfg["d"]
    if stream == "dup":
        vecs, ts = dense_embedding_stream(320, d, seed=7, rate=2.0)
    elif stream == "burst":     # dense near-duplicate chains
        vecs, ts = dense_embedding_stream(320, d, seed=7, rate=20.0, dup_frac=0.9)
    else:
        vecs, ts = topic_drift_stream(384, d, n_topics=8, seg=64, seed=3, rate=4.0)
    want_eng = JEngine(JConfig(join_impl="pallas", **cfg))
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    want = _run(want_eng, vecs, ts, 80)      # 80 = 2.5 micro-batches: padding
    got = _run(got_eng, vecs, ts, 80)
    _assert_same_emission(got, want, cfg["theta"])
    assert got_eng.stats() == want_eng.stats()
    assert _prune(got_eng.metrics()) == _prune(want_eng.metrics())
    if kw.get("capacity") == 64:
        assert got_eng.stats()["window_overflow"] > 0
    if "tile_k" in kw or "max_pairs" in kw:
        assert got_eng.pairs_dropped > 0
    if stream == "topic":
        assert got_eng.metrics()["engine/prune/tiles_skipped_l2"] > 0
    got_eng.close()
    want_eng.close()


@pytest.mark.parametrize("kw", [dict(), dict(capacity=96, tile_k=4)])
def test_dense_impl_matches_reference_dense(kw):
    cfg = _cfg_kw(join_impl="dense", **kw)
    vecs, ts = dense_embedding_stream(256, 64, seed=5, rate=2.0)
    want_eng = JEngine(JConfig(**cfg))
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    _assert_same_emission(_run(got_eng, vecs, ts, 64),
                          _run(want_eng, vecs, ts, 64), cfg["theta"])
    assert got_eng.stats() == want_eng.stats()
    assert _prune(got_eng.metrics()) == _prune(want_eng.metrics())


@pytest.mark.parametrize("kw", [
    dict(eviction="dead"),
    dict(eviction="quota", quotas=(64,)),                # one lane: the whole ring
    dict(eviction="quota", quotas=(40, 24)),             # stream 0 owns 40 slots
    dict(eviction="dead", join_impl="scan"),
    dict(eviction="quota", quotas=(40, 24), join_impl="dense"),
])
def test_engine_eviction_policies_match_reference(kw):
    """``StreamEngine`` under the dead and quota policies on a 64-slot ring
    that wraps over live items: pairs, masks, ``stats()`` (with the
    per-tenant overflow) and the final window and lanes equal the
    reference's.  A single stream writes only lane 0, so ``(40, 24)``
    confines it to 40 slots."""
    cfg = _cfg_kw(capacity=64, lam=0.005, **kw)
    vecs, ts = dense_embedding_stream(320, 64, seed=7, rate=2.0)
    jkw = dict(cfg, join_impl=cfg.get("join_impl") or "pallas")
    want_eng = JEngine(JConfig(**jkw))
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    _assert_same_emission(_run(got_eng, vecs, ts, 80), _run(want_eng, vecs, ts, 80),
                          cfg["theta"])
    st = got_eng.stats()
    assert st == want_eng.stats()
    assert st["window_overflow"] > 0
    if "quotas" in kw:
        assert st["window_overflow_by_tenant"][0] == st["window_overflow"]
    final = window_to_numpy(got_eng.state)
    for name in ("uids", "ts", "sids", "lane_cursor", "lane_overflow"):
        want = getattr(want_eng.state, name)
        if want is None:
            assert final[name] is None, name
        else:
            np.testing.assert_array_equal(final[name], np.asarray(want), err_msg=name)
    assert final["cursor"] == int(want_eng.state.cursor)
    got_eng.close()
    want_eng.close()


def test_kernel_path_matches_dense_path():
    """Gated kernel path and dense oracle drain the same pairs."""
    vecs, ts = dense_embedding_stream(320, 64, seed=2, rate=2.0)
    runs = []
    for impl in (None, "dense"):
        eng = StreamEngine(EngineConfig(**_cfg_kw(join_impl=impl)), device=CPU)
        runs.append(_run(eng, vecs, ts, 64))
    _assert_same_emission(runs[0], runs[1], 0.8)


@pytest.mark.parametrize(
    "kw,stream",
    [
        (dict(capacity=64, lam=0.005), "dup"),   # wrap over live slots
        (dict(d=200, chunk_d=64), "dup"),        # ragged d
        (dict(max_pairs=8), "burst"),            # max_pairs overflow
        (dict(use_ref=True), "dup"),             # the dense reference route
    ],
)
def test_emit_dense_matches_reference_emit_dense(kw, stream):
    cfg = _cfg_kw(emit_dense=True, **kw)
    d = cfg["d"]
    rate, dup = (20.0, 0.9) if stream == "burst" else (2.0, 0.15)
    vecs, ts = dense_embedding_stream(320, d, seed=7, rate=rate, dup_frac=dup)
    want_eng = JEngine(JConfig(**cfg))
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    assert got_eng.state.summary is None          # no gate on this path
    _assert_same_emission(_run(got_eng, vecs, ts, 80),
                          _run(want_eng, vecs, ts, 80), cfg["theta"])
    assert got_eng.stats() == want_eng.stats()
    assert _prune(got_eng.metrics()) == _prune(want_eng.metrics())
    if "capacity" in kw:
        assert got_eng.stats()["window_overflow"] > 0
    if "max_pairs" in kw:
        assert got_eng.stats()["pairs_dropped_budget"] > 0
    got_eng.close()
    want_eng.close()


def test_emission_paths_agree():
    """``emit_dense``, the default kernel path and ``use_ref`` drain the
    same pairs, scores and row masks (the reference's
    ``test_engine_emission_paths_agree``)."""
    vecs, ts = dense_embedding_stream(192, 64, seed=11, rate=2.0)
    runs = {}
    for name, kw in (("dense", dict(emit_dense=True)), ("kernel", dict()),
                     ("ref", dict(use_ref=True))):
        eng = StreamEngine(EngineConfig(**_cfg_kw(**kw)), device=CPU)
        runs[name] = _run(eng, vecs, ts, 80)
        assert eng.pairs_dropped == 0
        eng.close()
    assert len(runs["dense"][0]) > 0
    for name in ("kernel", "ref"):
        got, want = runs[name], runs["dense"]
        gp = dict(zip(zip(got[0].tolist(), got[1].tolist()), got[2].tolist()))
        wp = dict(zip(zip(want[0].tolist(), want[1].tolist()), want[2].tolist()))
        assert gp.keys() == wp.keys(), name
        np.testing.assert_allclose([gp[k] for k in wp], list(wp.values()),
                                   atol=SCORE_ATOL)
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("split", [1, 37, 96, 320])
def test_split_invariance(split):
    """Emission does not depend on how the stream is cut into requests."""
    vecs, ts = dense_embedding_stream(320, 64, seed=4, rate=2.0)
    ref = _run(StreamEngine(EngineConfig(**_cfg_kw()), device=CPU), vecs, ts, 64)
    got = _run(StreamEngine(EngineConfig(**_cfg_kw()), device=CPU), vecs, ts, split)
    _assert_same_emission(got, ref, 0.8)


@pytest.mark.parametrize("gate", [True, False])
def test_engine_continues_from_reference_window(gate):
    """A mid-stream reference window, carried across, continues to the
    same pairs and the same final window as the reference engine."""
    cfg = _cfg_kw(capacity=128, l2_gate=gate)
    vecs, ts = dense_embedding_stream(320, 64, seed=8, rate=2.0)
    want_eng = JEngine(JConfig(join_impl="pallas", **cfg))
    for i in range(0, 160, 80):
        want_eng.push(vecs[i:i + 80], ts[i:i + 80])
    want_eng.drain_arrays()
    got_eng = StreamEngine(EngineConfig(**cfg), device=CPU)
    got_eng.state = window_from_numpy(want_eng.state, device=CPU)
    got_eng._next_uid = want_eng._next_uid
    want = _run(want_eng, vecs[160:], ts[160:], 80)
    got = _run(got_eng, vecs[160:], ts[160:], 80)
    _assert_same_emission(got, want, cfg["theta"])
    final = window_to_numpy(got_eng.state)
    for name in ("uids", "ts", "vecs", "sids"):
        np.testing.assert_array_equal(final[name], np.asarray(getattr(want_eng.state, name)))
    assert final["cursor"] == int(want_eng.state.cursor)
    assert final["overflow"] == int(want_eng.state.overflow)


def test_metric_names_follow_pinned_schema():
    with open(_SCHEMA) as f:
        schema = json.load(f)
    pinned = {k: v for k, v in schema.items() if k.startswith("engine/")}
    eng = StreamEngine(EngineConfig(**_cfg_kw()), device=CPU)
    assert eng.registry.schema() == pinned


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(theta=0.0), ValueError),
        (dict(lam=-1.0), ValueError),
        (dict(micro_batch=1024), ValueError),
        (dict(block_w=0), ValueError),
        (dict(join_impl="bogus"), ValueError),
        (dict(join_impl="dense", l2_gate=True), ValueError),
        (dict(join_impl="pallas"), ValueError),
        (dict(emit_dense=True, l2_gate=True), ValueError),
        (dict(use_ref=True, l2_gate=True), ValueError),
        (dict(eviction="quota"), ValueError),            # no quota table
        (dict(eviction="lru"), ValueError),
        (dict(quotas=(256, 256)), ValueError),           # quotas off-quota
        (dict(eviction="quota", quotas=(256, 255)), ValueError),  # sum != capacity
    ],
)
def test_config_validation(kw, exc):
    with pytest.raises(exc):
        EngineConfig(**_cfg_kw(**kw))


def test_reference_rejects_the_same_invalid_configs():
    """The validation the port copied: what the port raises ValueError
    for, the reference rejects as well."""
    for kw in (dict(theta=0.0), dict(micro_batch=1024),
               dict(join_impl="dense", l2_gate=True), dict(eviction="lru"),
               dict(emit_dense=True, l2_gate=True),
               dict(use_ref=True, l2_gate=True)):
        with pytest.raises(ValueError):
            JConfig(**_cfg_kw(**kw))


CUDA0 = torch.device("cuda", 0)   # named, never touched: no card is needed


@pytest.mark.parametrize("kw", [
    dict(capacity=32, block_w=64),          # window (and self join) under one tile
    dict(micro_batch=16, block_q=32),       # queries under one tile
    dict(micro_batch=16, block_w=32),       # the self join under one tile
    dict(d=16, chunk_d=32),                 # d under one chunk
    dict(micro_batch=16, block_q=32, emit_dense=True),   # the dense tile join
], ids=["capacity", "block_q", "self", "chunk_d", "emit_dense"])
def test_batch_step_refuses_sub_tile_joins_on_cuda(kw):
    """``StreamEngine``'s step on a CUDA device refuses a join smaller than
    one tile (the join wrappers would run it as the dense reference, in
    plain torch on the card); the CPU step runs it, as the reference does,
    and so do the card's oracles (``join_impl="dense"``, ``use_ref``)."""
    cfg = EngineConfig(**_cfg_kw(**kw))
    with pytest.raises(ValueError, match="smaller than one"):
        make_batch_step(cfg, CUDA0)
    make_batch_step(cfg, CPU)
    if not cfg.emit_dense:
        make_batch_step(dataclasses.replace(cfg, join_impl="dense"), CUDA0)
    make_batch_step(dataclasses.replace(cfg, use_ref=True, l2_gate=None), CUDA0)
    vecs, ts = dense_embedding_stream(40, cfg.d, seed=1)
    eng = StreamEngine(cfg, device=CPU)
    eng.push(vecs, ts)
    eng.drain_arrays()


def test_micro_step_takes_an_embed_fn():
    """The fused embed→join hook maps the payload before the joins, and the
    ``emit_dense`` oracle refuses it."""
    cfg = EngineConfig(**_cfg_kw())
    with pytest.raises(ValueError, match="takes vectors"):
        make_micro_step(dataclasses.replace(cfg, emit_dense=True), lambda *a: None,
                        embed_fn=lambda x: x)
    seen = []
    step = make_micro_step(cfg, lambda *a: None,
                           embed_fn=lambda x: seen.append(x.shape) or x[:, :cfg.d])
    vecs, ts = dense_embedding_stream(32, cfg.d, seed=2)
    payload = torch.cat([torch.from_numpy(vecs), torch.zeros((32, 5))], 1)
    state = init_window(cfg.capacity, cfg.d, summary_block_w=cfg.block_w,
                        summary_chunk_d=cfg.chunk_d, device=CPU)
    buf, mask = step(state, init_telemetry(CPU), payload, torch.from_numpy(ts).float(),
                     torch.arange(32, dtype=torch.int32), 32)
    assert seen == [(32, cfg.d + 5)] and mask.shape == (32,)

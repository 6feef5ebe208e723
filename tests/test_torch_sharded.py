"""The port's sharded engine on the CPU, in one process.

A mesh of ``["cpu"] * p`` devices runs ``p`` window shards in one
process (no process group).  The reference's own sharded engine cannot be
the oracle here (its sharded cells fail on this JAX), so the port is held
to what the reference says a mesh must give:

* the level-3 merge equals the reference's ``merge_candidates`` over the
  same gathered buffers, in every leaf;
* the engine drains exactly the planted pairs, with exact drop accounting
  under a tight global budget, ``shard_k`` and ``tile_k`` (the assertions
  of the reference's ``test_sharded_engine_matches_oracle``);
* its pairs and row masks equal the reference single-device
  ``StreamEngine`` at capacity ``p·C`` on the same pushes (shard-count
  invariance); its per-shard leaves equal a numpy model of the
  round-robin deal; ``shard_metrics`` equals the reference's applied to
  the port's numpy state;
* ``MultiTenantRuntime`` on ``ShardedFacade`` (oldest, dead, quota) and
  ``MultiTenantSSSJService(mesh=)`` equal the single-device runs, the
  port's and the reference's, with no live slot overwritten; quota
  isolation holds with sub-rings local to each shard.

Scores ``atol=1e-5``; these streams have no pair within 1e-5 of θ.
"""

import types

import numpy as np
import pytest
import torch

from repro.data.synth import bursty_tenant_traffic, planted_duplicates
from repro.distributed.sharding import DEFAULT_RULES as J_RULES
from repro.engine import EngineConfig as JConfig
from repro.engine import StreamEngine as JEngine
from repro.engine.sharded import shard_metrics as j_shard_metrics
from repro.kernels.sssj_join import PairCandidates as JCands
from repro.kernels.sssj_join import merge_candidates as j_merge_candidates
from repro.kernels.sssj_join.gate import summarize_strips as j_summarize_strips
from repro.runtime import MultiTenantRuntime as JRuntime
from repro.runtime import TenantTable as JTable
from repro.serving import MultiTenantSSSJService as JService
from repro_torch.data import dense_embedding_stream
from repro_torch.distributed import DEFAULT_RULES, AxisRules
from repro_torch.engine import (
    EngineConfig,
    EngineTelemetry,
    ShardedStreamEngine,
    host_lanes,
    shard_stats,
    window_axis,
)
from repro_torch.engine.sharded import make_sharded_batch_step, merge_shard_buffers
from repro_torch.kernels.sssj_join import PairBuffer
from repro_torch.launch import Mesh, make_mesh_for
from repro_torch.runtime import (
    MultiTenantRuntime,
    ShardedFacade,
    SingleDeviceFacade,
    TenantTable,
)
from repro_torch.serving import MultiTenantSSSJService

CPU = "cpu"
SCORE_ATOL = 1e-5
THETA, LAM, D = 0.8, 0.05, 64


def _mesh(p: int) -> Mesh:
    return make_mesh_for((p,), ("data",), devices=[CPU] * p)


def _cfg(**kw):
    base = dict(theta=THETA, lam=LAM, capacity=64, d=D, micro_batch=32,
                max_pairs=512, block_q=32, block_w=32, chunk_d=32)
    base.update(kw)
    return base


def _pairs(ua, ub, sc=None):
    keys = [(min(a, b), max(a, b)) for a, b in zip(ua.tolist(), ub.tolist())]
    return set(keys) if sc is None else dict(zip(keys, sc.tolist()))


def _push_all(eng, vecs, ts, step=80):
    for i in range(0, len(vecs), step):     # 80 = 2.5 micro-batches: padding
        eng.push(vecs[i:i + step], ts[i:i + step])
    return eng.drain_arrays(return_masks=True)


# --------------------------------------------------------------------- #
# the mesh and the axis rules
# --------------------------------------------------------------------- #
def test_mesh_for_raises_without_enough_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 CUDA devices"):
        make_mesh_for((4,), ("data",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 1 CUDA devices"):
        make_mesh_for((1,), ("data",))


def test_mesh_accepts_repeated_devices():
    mesh = make_mesh_for((2, 3), ("data", "model"), devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "model": 3} and mesh.devices.shape == (2, 3)
    assert mesh.devices_along("data") == [torch.device(CPU)] * 2
    assert mesh.devices_along("model") == [torch.device(CPU)] * 3
    assert window_axis(mesh) == "data"
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh_for((4,), ("data",), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh_for((2,), ("data", "model"), devices=[CPU] * 2)


def test_window_axis_follows_the_rules():
    mesh = make_mesh_for((2, 2), ("pod", "data"), devices=[CPU] * 4)
    assert window_axis(mesh) == "data"
    assert window_axis(mesh, DEFAULT_RULES.override(window="pod")) == "pod"
    with pytest.raises(ValueError, match="no mesh axis for logical 'window'"):
        window_axis(make_mesh_for((2,), ("model",), devices=[CPU] * 2))
    with pytest.raises(TypeError):
        ShardedStreamEngine(EngineConfig(**_cfg()), object())


def test_axis_rules_copy_agrees():
    assert DEFAULT_RULES.table == J_RULES.table
    rules = DEFAULT_RULES.override(window=("pod", "data"), seq="model")
    want = J_RULES.override(window=("pod", "data"), seq="model")
    assert isinstance(rules, AxisRules) and rules.table == want.table
    for name in list(J_RULES.table) + [None, "absent"]:
        assert DEFAULT_RULES.lookup(name) == J_RULES.lookup(name)


# --------------------------------------------------------------------- #
# level 3: the gathered per-shard buffers into one global budget
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("p,shard_k,max_pairs,seed", [
    (2, 8, 32, 0),       # everything fits
    (4, 8, 5, 1),        # a tight global budget
    (8, 4, 1, 2),        # one pair survives
    (3, 16, 16, 3),      # exactly full shards
])
def test_level3_merge_matches_reference(p, shard_k, max_pairs, seed):
    rng = np.random.default_rng(seed)
    n_pairs = rng.integers(0, shard_k + 1, p).astype(np.int32)
    if seed == 3:
        n_pairs[:] = shard_k
    slot = np.arange(shard_k)[None, :] < n_pairs[:, None]
    ua = np.where(slot, rng.integers(100, 200, (p, shard_k)), -1).astype(np.int32)
    ub = np.where(slot, rng.integers(0, 100, (p, shard_k)), -1).astype(np.int32)
    sc = np.where(slot, rng.uniform(0.8, 1.0, (p, shard_k)), 0.0).astype(np.float32)
    want = j_merge_candidates(JCands(ua, ub, sc, n_pairs, n_pairs), max_pairs=max_pairs)
    bufs = [PairBuffer(*(torch.from_numpy(x[i]) for x in (ua, ub, sc)),
                       n_pairs=torch.tensor(n_pairs[i]),
                       n_dropped=torch.tensor(0, dtype=torch.int32),
                       n_dropped_tile=torch.tensor(0, dtype=torch.int32))
            for i in range(p)]
    got = merge_shard_buffers(bufs, max_pairs=max_pairs, device=torch.device(CPU))
    for field in PairBuffer._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.n_dropped) == max(int(n_pairs.sum()) - max_pairs, 0)


# --------------------------------------------------------------------- #
# the engine: planted pairs, budgets, shard-count invariance
# --------------------------------------------------------------------- #
def test_sharded_engine_matches_oracle():
    """The reference's ``test_sharded_engine_matches_oracle`` on the
    port's engine with 8 CPU shards."""
    vecs, ts = dense_embedding_stream(256, D, seed=3, rate=2.0)
    truth = planted_duplicates(vecs, ts, THETA, LAM)
    eng = ShardedStreamEngine(EngineConfig(**_cfg()), _mesh(8))
    ua, ub, sc, mask = _push_all(eng, vecs, ts)
    assert _pairs(ua, ub) == truth and truth
    assert (sc >= THETA).all()
    assert eng.pairs_dropped == 0
    s = eng.stats()
    assert s["n_shards"] == 8 and s["n_items"] == 256
    # the OR-reduced match mask marks exactly the newer sides
    want = np.zeros(256, bool)
    want[ua] = True
    np.testing.assert_array_equal(mask, want)
    eng.close()

    # max_pairs is a global budget with exact per-level drop attribution
    for kw in (dict(max_pairs=2), dict(shard_k=1), dict(tile_k=1)):
        e2 = ShardedStreamEngine(EngineConfig(**_cfg(**kw)), _mesh(8))
        ua2, ub2, _, mask2 = _push_all(e2, vecs, ts)
        s2 = e2.stats()
        assert s2["pairs_emitted"] == ua2.size
        assert ua2.size + s2["pairs_dropped"] == len(truth), kw
        assert s2["pairs_dropped"] > 0, kw
        assert _pairs(ua2, ub2) <= truth
        np.testing.assert_array_equal(mask2, want)     # masks exact under drops
        assert sum(s2["shards"]["pairs_emitted"]) == (
            s2["pairs_emitted"] + s2["pairs_dropped_global"])
        e2.close()


def test_global_budget_drops_counted_in_their_own_lane():
    """Dense near-duplicate chains overflow the global budget after the
    shards' own merges: survivors + drops = truth, and the losses sit in
    ``pairs_dropped_global``, not in any shard's lane."""
    vecs, ts = dense_embedding_stream(256, D, seed=7, rate=20.0, dup_frac=0.9)
    truth = planted_duplicates(vecs, ts, THETA, LAM)
    cfg = _cfg(max_pairs=16, shard_k=1024, tile_k=1024)    # lossless below level 3
    eng = ShardedStreamEngine(EngineConfig(**cfg), _mesh(4))
    ua, ub, _, mask = _push_all(eng, vecs, ts)
    s = eng.stats()
    assert s["pairs_dropped_global"] > 0
    assert s["pairs_dropped"] == s["pairs_dropped_global"]
    assert ua.size == s["pairs_emitted"] and ua.size + s["pairs_dropped"] == len(truth)
    assert sum(s["shards"]["pairs_emitted"]) == ua.size + s["pairs_dropped_global"]
    assert _pairs(ua, ub) <= truth
    want = np.zeros(256, bool)
    want[[b for _, b in truth]] = True
    np.testing.assert_array_equal(mask, want)
    eng.close()


def _deal_model(vecs, ts, p, cap, step, mb):
    """Numpy model of the round-robin deal under oldest eviction: the
    per-shard rings after pushing ``step``-row requests in micro-batches
    of ``mb``; row r of a micro-batch lands on shard r mod p."""
    d = vecs.shape[1]
    ring = [dict(vecs=np.zeros((cap, d), np.float32),
                 ts=np.full(cap, 3.0e30, np.float32),
                 uids=np.full(cap, -1, np.int32),
                 sids=np.full(cap, -1, np.int32), cursor=0) for _ in range(p)]
    for lo in range(0, len(vecs), step):
        for mlo in range(lo, min(lo + step, len(vecs)), mb):
            rows = np.arange(mlo, min(mlo + mb, lo + step, len(vecs)))
            for r in rows:
                s = ring[(r - mlo) % p]
                c = s["cursor"]
                s["vecs"][c], s["ts"][c], s["uids"][c], s["sids"][c] = vecs[r], ts[r], r, 0
                s["cursor"] = (c + 1) % cap
    return ring


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("impl", [None, "scan", "dense"])
def test_shard_count_invariance(p, impl):
    """``p`` shards of capacity C, on each join impl, drain the reference
    single-device engine's pairs and masks at capacity ``p·C``; the
    shards' leaves are the round-robin deal; ``shard_metrics`` is the
    reference's."""
    cap, n = 32, 192           # every global ring wraps
    vecs, ts = dense_embedding_stream(n, D, seed=11, rate=2.0)
    kw = _cfg(capacity=cap, join_impl=impl)
    eng = ShardedStreamEngine(EngineConfig(**kw), _mesh(p))
    # the reference's dense oracle: every impl there drains the same pairs
    ref = JEngine(JConfig(**{**kw, "capacity": p * cap, "join_impl": "dense"}))
    ua, ub, sc, mask = _push_all(eng, vecs, ts)
    ja, jb, js, jm = _push_all(ref, vecs, ts)
    got, want = _pairs(ua, ub, sc), _pairs(ja, jb, js)
    assert got.keys() == want.keys() and want
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(mask, jm)
    st, js_ = eng.stats(), ref.stats()
    for key in ("n_items", "pairs_emitted", "pairs_dropped", "window_overflow"):
        assert st[key] == js_[key], key
    assert st["window_overflow"] == 0

    # the per-shard leaves: the reference's concatenated layout
    state = eng.state.to_numpy()
    model = _deal_model(vecs, ts, p, cap, 80, kw["micro_batch"])
    for k in ("vecs", "ts", "uids", "sids"):
        np.testing.assert_array_equal(state[k], np.concatenate([m[k] for m in model]),
                                      err_msg=k)
    np.testing.assert_array_equal(state["cursor"], [m["cursor"] for m in model])
    np.testing.assert_array_equal(state["overflow"], np.zeros(p, np.int32))
    if impl != "dense":        # strip summaries: per shard, rows shard-major
        for i, m in enumerate(model):
            s = j_summarize_strips(m["vecs"], m["ts"], m["uids"],
                                   block_w=kw["block_w"], chunk_d=kw["chunk_d"])
            ns = cap // kw["block_w"]
            for k, v in state["summary"].items():
                np.testing.assert_allclose(v[i * ns:(i + 1) * ns],
                                           np.asarray(getattr(s, k)), rtol=1e-6,
                                           err_msg=k)

    # shard_metrics: the reference's function on the port's numpy state
    telem = types.SimpleNamespace(**{f: host_lanes(x)
                                     for f, x in zip(EngineTelemetry._fields, eng.telem)})
    want_m = j_shard_metrics(types.SimpleNamespace(**state), telem, p)
    got_m = {k: v for k, v in eng.metrics().items() if k in want_m}
    assert got_m == want_m
    assert shard_stats(eng.state, eng.telem, p)["shards"]["live_slots"] == [cap] * p
    eng.close()
    ref.close()


def test_sharded_engine_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        ShardedStreamEngine(EngineConfig(**_cfg()), _mesh(3))
    with pytest.raises(ValueError, match="emit_dense"):
        ShardedStreamEngine(EngineConfig(**_cfg(emit_dense=True)), _mesh(2))
    with pytest.raises(ValueError, match="shard_k"):
        EngineConfig(**_cfg(shard_k=0))


def _cuda_mesh(p: int) -> Mesh:
    """A mesh that names a card without touching it (none is needed to
    build one from ``torch.device`` objects)."""
    return Mesh(np.array([torch.device("cuda", 0)] * p, dtype=object), ("data",))


@pytest.mark.parametrize("kw", [
    dict(capacity=64, block_w=128),        # shard window under one tile
    dict(micro_batch=32, block_q=64),      # queries under one tile
    dict(micro_batch=32, block_w=64),      # the self join under one tile
    dict(d=16, chunk_d=32),                # d under one chunk
], ids=["capacity", "block_q", "self", "chunk_d"])
def test_sharded_step_refuses_sub_tile_joins_on_cuda(kw):
    """On a CUDA mesh a shard's join smaller than one tile is refused: the
    candidate wrapper would run it as the dense reference, not the kernel."""
    cfg = EngineConfig(**_cfg(**kw))
    with pytest.raises(ValueError, match="smaller than one"):
        make_sharded_batch_step(cfg, _cuda_mesh(2), "data")


# --------------------------------------------------------------------- #
# the multi-tenant runtime on a mesh
# --------------------------------------------------------------------- #
K = 8
TH = [0.8, 0.7, 0.9, 0.8, 0.75, 0.85, 0.8, 0.7]
LM = [0.3, 0.5, 1.0, 0.4, 0.3, 0.6, 0.8, 0.5]
MT_D, MT_MB = 32, 16


def _dup_stream(n, seed, dup_frac=0.35):
    """Near-duplicates planted at small Δt (chains included)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, n)
    dup = rng.random(n) < dup_frac
    dup[0] = False
    gaps[dup] = 0.02 + 0.03 * rng.random(int(dup.sum()))
    v = rng.standard_normal((n, MT_D))
    for i in range(1, n):
        if dup[i]:
            v[i] = v[i - 1] + 0.03 * rng.standard_normal(MT_D)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), np.cumsum(gaps)


def _tenant_events(n_per=24):
    streams = [_dup_stream(n_per, 500 + k) for k in range(K)]
    events = sorted((float(streams[k][1][i]), k, i)
                    for k in range(K) for i in range(n_per))
    return streams, events


def _drive(rt, streams, events):
    for _, k, i in events:
        v, t = streams[k]
        rt.submit(k, v[i:i + 1], t[i:i + 1])
    rt.flush(final=True)
    return rt.drain_by_tenant(return_masks=True), rt.stats()


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("eviction,cap_total", [
    ("oldest", 64), ("dead", 64), ("quota", 64), ("oldest", 256), ("quota", 256),
])
def test_runtime_on_mesh_matches_single_device(p, eviction, cap_total):
    """Each tenant's pairs and masks on ``ShardedFacade`` equal the
    single-device runtime's (the port's and the reference's); nothing live
    is overwritten, on the 64-slot ring that wraps three times too."""
    streams, events = _tenant_events()

    def cfg_kw(shards):
        quotas = ((cap_total // shards // K,) * K if eviction == "quota" else None)
        return dict(theta=0.8, lam=0.05, capacity=cap_total // shards, d=MT_D,
                    micro_batch=MT_MB, max_pairs=4096, tile_k=MT_MB * MT_MB,
                    block_q=MT_MB, block_w=MT_MB, chunk_d=32, eviction=eviction,
                    quotas=quotas)

    sharded = MultiTenantRuntime(EngineConfig(**cfg_kw(p)), TenantTable(TH, LM), span=2,
                                 engine=ShardedFacade(_mesh(p)), device=CPU)
    single = MultiTenantRuntime(EngineConfig(**cfg_kw(1)), TenantTable(TH, LM), span=2,
                                engine=SingleDeviceFacade(), device=CPU)
    ref = JRuntime(JConfig(**cfg_kw(1)), JTable(TH, LM), span=2)
    (got, st), (one, st1), (want, stw) = (_drive(r, streams, events)
                                          for r in (sharded, single, ref))
    n_pairs = 0
    for k in range(K):
        gp, op_, wp = (_pairs(*r[k][:3]) for r in (got, one, want))
        assert gp.keys() == op_.keys() == wp.keys(), k
        np.testing.assert_allclose([gp[x] for x in wp], list(wp.values()), atol=SCORE_ATOL)
        assert all(s >= TH[k] - 1e-6 for s in gp.values())
        np.testing.assert_array_equal(got[k][3], want[k][3])
        np.testing.assert_array_equal(one[k][3], want[k][3])
        n_pairs += len(wp)
    assert n_pairs
    assert st["window_overflow"] == st1["window_overflow"] == stw["window_overflow"] == 0
    assert st["window_overflow_by_tenant"] == [0] * K
    assert st["n_shards"] == p and st["pairs_dropped"] == 0
    assert sum(st["shards"]["pairs_emitted"]) == st["pairs_emitted"] == n_pairs
    assert st["n_items"] == stw["n_items"]
    for r in (sharded, single, ref):
        r.close()


def _run_bursty(shards, eviction):
    """The reference conformance suite's bursty traffic: 7 slow tenants
    reposting every 1.5 time units beside a flood of 45 items a round."""
    bk, cap, mb = 8, 32, 16
    th, lm = [0.9] + [0.8] * 7, [2.0] + [0.1] * 7
    quotas = (cap // shards // bk,) * bk if eviction == "quota" else None
    cfg = EngineConfig(theta=0.8, lam=0.1, capacity=cap // shards, d=MT_D,
                       micro_batch=mb, max_pairs=4096, tile_k=mb * mb, block_q=mb,
                       block_w=mb, chunk_d=32, eviction=eviction, quotas=quotas)
    engine = SingleDeviceFacade() if shards == 1 else ShardedFacade(_mesh(shards))
    rt = MultiTenantRuntime(cfg, TenantTable(th, lm), span=2, engine=engine, device=CPU)
    submits, per_tenant = bursty_tenant_traffic(bk - 1, 10, 45, MT_D)
    local = [dict() for _ in range(bk)]
    for k, v, t in submits:
        for u in rt.submit(k, v, t).tolist():
            local[k][u] = len(local[k])
    rt.flush(final=True)
    per = rt.drain_by_tenant()
    got = [{tuple(sorted((local[k][a], local[k][b])))
            for a, b in zip(per[k][0].tolist(), per[k][1].tolist())}
           for k in range(bk)]
    truth = [planted_duplicates(*per_tenant[k], th[k], lm[k]) for k in range(bk)]
    st = rt.stats()
    rt.close()
    return got, truth, st


@pytest.mark.parametrize("shards", [1, 2])
def test_quota_isolation_on_mesh(shards):
    """Quota sub-rings local to each shard keep the isolation invariant:
    slow tenants emit their exact truth and lose no item, while oldest
    eviction loses their pairs on the same traffic."""
    got_q, truth, sq = _run_bursty(shards, "quota")
    got_o, _, so = _run_bursty(shards, "oldest")
    for k in range(1, 8):
        assert truth[k] and got_q[k] == truth[k], k
    by_q, by_o = sq["window_overflow_by_tenant"], so["window_overflow_by_tenant"]
    assert sum(by_q) == sq["window_overflow"] and sum(by_o) == so["window_overflow"]
    assert sum(by_q[1:]) == 0 and by_q[0] > 0
    assert sum(by_o[1:]) > 0
    assert any(truth[k] - got_o[k] for k in range(1, 8))
    if shards > 1:
        assert sq["n_shards"] == shards
        assert sum(sq["shards"]["window_overflow"]) == sq["window_overflow"]


# --------------------------------------------------------------------- #
# the multi-tenant service on a mesh
# --------------------------------------------------------------------- #
def _service_traffic(svcs):
    rng = np.random.default_rng(11)
    base = rng.standard_normal(32).astype(np.float32)
    t = 0.0
    for _ in range(6):
        for k in range(3):
            b = rng.standard_normal((4, 32)).astype(np.float32)
            b[0] = base + 0.01 * rng.standard_normal(32)
            for svc in svcs:
                svc.submit(k, b, t + np.arange(4) * 0.01)
        t += 0.2
    return [svc.flush(final=True) for svc in svcs]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("eviction", ["oldest", "quota"])
def test_mt_service_on_mesh_groups_equal_single_device(p, eviction):
    th, lm = [0.9, 0.9, 0.95], [0.05, 0.05, 0.02]
    kw = dict(dim=32, capacity=256, micro_batch=16, eviction=eviction)
    svc = MultiTenantSSSJService(TenantTable(th, lm), mesh=_mesh(p), device=CPU, **kw)
    one = MultiTenantSSSJService(TenantTable(th, lm), device=CPU, **kw)
    ref = JService(JTable(th, lm), **kw)
    got, single, want = _service_traffic([svc, one, ref])
    assert got.keys() == single.keys() == want.keys()
    for k in got:
        assert {x[:2] for x in got[k]} == {x[:2] for x in want[k]}
        assert [x[:2] for x in single[k]] == [x[:2] for x in want[k]]
    for k in range(3):
        groups = [[0, 4, 8, 12, 16, 20]]
        assert svc.duplicate_groups(k) == one.duplicate_groups(k) == ref.duplicate_groups(k)
        assert svc.duplicate_groups(k) == groups
        assert svc.tenant_stats(k)["submitted"] == 24
    st = svc.stats()
    assert st["n_shards"] == p and st["window_overflow"] == 0
    assert svc.runtime.cfg.capacity == 256 // p
    if eviction == "quota":
        assert sum(svc.runtime.cfg.quotas) * p == 256
        assert [svc.tenant_stats(k)["quota"] for k in range(3)] == [
            q * p for q in svc.runtime.cfg.quotas]
    for s in (svc, one):
        s.runtime.close()


def test_mt_service_on_mesh_refuses_uneven_splits():
    table = TenantTable.uniform(2, 0.9, 0.1)
    mesh = _mesh(4)
    for kw in (dict(capacity=66),                     # capacity over 4 shards
               dict(capacity=64, micro_batch=32),     # micro-batch over 16 slots
               dict(capacity=64, eviction="quota", quotas=(30, 34))):  # quotas
        with pytest.raises(ValueError):
            MultiTenantSSSJService(table, dim=32, mesh=mesh, device=CPU, **kw)
    facade = ShardedFacade(mesh)
    assert facade.home_device(None) == facade.home_device(CPU) == torch.device(CPU)
    with pytest.raises(TypeError):
        ShardedFacade(object())

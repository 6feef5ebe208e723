"""The port's multi-tenant runtime on the CPU against ``repro.runtime``.

The same numpy-seeded submits go through the reference's
``MultiTenantRuntime`` (its Pallas kernels in interpret mode, its scan,
or its dense oracle) and the port's with ``device="cpu"`` (the kernels'
plain versions).  Held exact: the uids ``submit`` hands out, each
tenant's drained pairs in drain order, its match masks, ``stats()``
(queue delays aside: they are wall-clock times) and the snapshot's names
and kinds; scores ``atol=1e-5``.  Pair sets are held identical outside an
ε-band of 1e-5 around each tenant's θ; these streams have no pair in the
band, which the tests check.  Also: the tenant table, the config's quota
validation, the router (a copy of the reference's), quota isolation under
a bursty tenant, identical streams that never cross, the
multi-tenant service's namespaced groups, and the fused embed→join
(token submissions embedded inside the step by the reduced qwen3-0.6b
on the reference's parameters, carried across) against the host round
trip and the reference's fused runtime and service.  On a named CUDA
device (never touched) the kernel route's tenant step refuses joins
smaller than one tile.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JConfig
from repro.runtime import MultiTenantRuntime as JRuntime
from repro.runtime import RequestRouter as JRouter
from repro.runtime import TenantTable as JTable
from repro.serving import MultiTenantSSSJService as JService
from repro_torch.configs import ARCHS
from repro_torch.data import bursty_tenant_traffic, dense_embedding_stream
from repro_torch.engine import EngineConfig
from repro_torch.launch import make_mesh_for
from repro_torch.models import params_from_numpy
from repro_torch.runtime import (
    FusedEmbedder,
    MultiTenantRuntime,
    RequestRouter,
    TenantBackpressure,
    TenantTable,
    make_tenant_batch_step,
)
from repro_torch.serving import LMEmbedder, MultiTenantSSSJService

CPU = "cpu"
SCORE_ATOL = 1e-5
BAND = 1e-5
K = 6
D = 64
THETAS = [0.8, 0.7, 0.9, 0.8, 0.75, 0.85]
LAMS = [0.05, 0.1, 0.02, 0.2, 0.05, 0.08]
_SCHEMA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "metrics_schema.json")


def _cfg_kw(**kw):
    base = dict(theta=0.8, lam=0.05, capacity=64, d=D, micro_batch=16,
                max_pairs=1024, block_q=16, block_w=16, chunk_d=32)
    base.update(kw)
    return base


def _events(n_per=40, seed0=100, rate=1.0):
    """K independent planted-duplicate streams, interleaved in time."""
    streams = [dense_embedding_stream(n_per, D, seed=seed0 + k, rate=rate,
                                      dup_frac=0.3)
               for k in range(K)]
    events = sorted((float(streams[k][1][i]), k, i)
                    for k in range(K) for i in range(n_per))
    return streams, events


def _drive(rts, streams, events, plan, flush_every=None):
    """The same submits (consecutive same-tenant events of each chunk of
    ``plan`` together) and flushes into every runtime of ``rts``; returns
    each runtime's ``drain_by_tenant(return_masks=True)``."""
    i, p, n_flush = 0, 0, 0
    while i < len(events):
        chunk = events[i:i + plan[p % len(plan)]]
        i += len(chunk)
        p += 1
        j = 0
        while j < len(chunk):
            k = chunk[j][1]
            idx = [chunk[j][2]]
            while j + 1 < len(chunk) and chunk[j + 1][1] == k:
                j += 1
                idx.append(chunk[j][2])
            v, t = streams[k]
            uids = [rt.submit(k, v[idx], t[idx]) for rt in rts]
            for u in uids[1:]:
                np.testing.assert_array_equal(u, uids[0])
            j += 1
        n_flush += 1
        if flush_every and n_flush % flush_every == 0:
            for rt in rts:
                rt.flush()
    for rt in rts:
        rt.flush(final=True)
    return [rt.drain_by_tenant(return_masks=True) for rt in rts]


def _assert_same_per_tenant(got, want, thetas):
    for k, theta in enumerate(thetas):
        ga, gb, gs, gm = got[k]
        wa, wb, ws, wm = want[k]
        gp = dict(zip(zip(ga.tolist(), gb.tolist()), gs.tolist()))
        wp = dict(zip(zip(wa.tolist(), wb.tolist()), ws.tolist()))
        differ = gp.keys() ^ wp.keys()
        assert all(abs({**gp, **wp}[x] - theta) <= BAND for x in differ), differ
        assert not differ, (k, differ)      # and no pair lies in the band
        np.testing.assert_array_equal(ga, wa, err_msg=f"tenant {k}")
        np.testing.assert_array_equal(gb, wb, err_msg=f"tenant {k}")
        np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL, err_msg=f"tenant {k}")
        np.testing.assert_array_equal(gm, wm, err_msg=f"tenant {k}")
        assert all(abs(s - theta) > BAND for s in gs.tolist())


def _stats_without_delays(rt):
    return {k: v for k, v in rt.stats().items() if not k.startswith("queue_delay")}


def _pair(cfg_kw, thetas=THETAS, lams=LAMS, span=2, join_impl=None):
    rt = MultiTenantRuntime(EngineConfig(**cfg_kw, join_impl=join_impl),
                            TenantTable(thetas, lams), span=span, device=CPU)
    jrt = JRuntime(JConfig(**cfg_kw, join_impl=join_impl or "pallas"),
                   JTable(thetas, lams), span=span)
    return rt, jrt


# --------------------------------------------------------------------- #
# the runtime against the reference's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("eviction", ["oldest", "dead", "quota"])
@pytest.mark.parametrize("join_impl", [None, "scan", "dense"])
def test_runtime_matches_reference(join_impl, eviction):
    """A ring of 32 slots, fewer than the widest horizon holds, for 240
    items, so live items are overwritten under every policy; submits of up
    to 5 events, a flush every third, span 2 (span-fill micro-batches
    occur)."""
    quotas = (8, 4, 4, 4, 4, 8) if eviction == "quota" else None
    kw = _cfg_kw(capacity=32, eviction=eviction, quotas=quotas)
    streams, events = _events()
    rt, jrt = _pair(kw, join_impl=join_impl)
    got, want = _drive([rt, jrt], streams, events, plan=[3, 1, 5, 2], flush_every=3)
    _assert_same_per_tenant(got, want, THETAS)
    assert sum(got[k][0].size for k in range(K)) > 0
    assert _stats_without_delays(rt) == _stats_without_delays(jrt)
    for k in range(K):
        assert rt.tenant_stats(k) == jrt.tenant_stats(k)
    st = rt.stats()
    assert st["window_overflow"] > 0 and st["empty_micro_batches"] > 0
    assert sum(st["window_overflow_by_tenant"]) == st["window_overflow"]


def test_runtime_uniform_table_matches_reference():
    """A uniform table folds its (θ, λ) into the config and sends no lanes
    but the stream ids through the join."""
    streams, events = _events(n_per=32, seed0=300)
    rt, jrt = _pair(_cfg_kw(), thetas=[0.8] * K, lams=[0.05] * K, span=3)
    assert rt.table.lookup(np.zeros(4)) is None
    got, want = _drive([rt, jrt], streams, events, plan=[4])
    _assert_same_per_tenant(got, want, [0.8] * K)
    assert _stats_without_delays(rt) == _stats_without_delays(jrt)


def test_snapshot_names_follow_pinned_schema():
    with open(_SCHEMA) as f:
        pinned = json.load(f)
    streams, events = _events(n_per=16)
    rt, jrt = _pair(_cfg_kw())
    _drive([rt, jrt], streams, events, plan=[7])

    def normalize(schema):
        return {re.sub(r"tenant/\d+/", "tenant/<k>/", k): v for k, v in schema.items()}

    assert normalize(rt.registry.schema()) == pinned
    assert rt.registry.schema() == jrt.registry.schema()
    snap = rt.registry.snapshot()
    lat = snap["latency/admit_to_emit_s"]
    assert lat["count"] == K * 16 and lat["sum"] >= 0.0
    assert sum(snap[f"tenant/{k}/latency_s"]["count"] for k in range(K)) == K * 16
    assert snap["span/drain/calls"] == snap["runtime/spans_dispatched"]


def test_coalescing_invariance():
    """Other submit plans, spans and flush cadences give the same uids
    and per-tenant pairs as one-event submits."""
    streams, events = _events(n_per=24, seed0=200)
    kw = _cfg_kw(capacity=256)
    base = MultiTenantRuntime(EngineConfig(**kw), TenantTable(THETAS, LAMS), span=2,
                              device=CPU)
    (want,) = _drive([base], streams, events, plan=[1])
    for plan, flush_every, span in (([7], 3, 1), ([40], None, 4), ([13, 2], 1, 3)):
        rt = MultiTenantRuntime(EngineConfig(**kw), TenantTable(THETAS, LAMS),
                                span=span, device=CPU)
        (got,) = _drive([rt], streams, events, plan=plan, flush_every=flush_every)
        _assert_same_per_tenant(got, want, THETAS)


def test_no_cross_stream_pairs_on_identical_streams():
    """Every tenant gets the same vectors at the same times: any leak
    across streams would pair them at once."""
    table = TenantTable.uniform(4, 0.9, 0.05)
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw(capacity=256)), table, span=2,
                            device=CPU)
    vecs, ts = dense_embedding_stream(48, D, seed=5, rate=2.0, dup_frac=0.3)
    tenant_of = {}
    for i in range(48):
        for k in range(4):
            tenant_of[int(rt.submit(k, vecs[i:i + 1], ts[i:i + 1])[0])] = k
    rt.flush(final=True)
    per = rt.drain_by_tenant()
    local = []
    for k in range(4):
        ua, ub, _ = per[k]
        assert ua.size > 0
        assert all(tenant_of[a] == tenant_of[b] == k
                   for a, b in zip(ua.tolist(), ub.tolist()))
        # the same pairs in each tenant's own numbering
        local.append(sorted(((a - k) // 4, (b - k) // 4)
                            for a, b in zip(ua.tolist(), ub.tolist())))
    assert all(pairs == local[0] for pairs in local)


def test_window_overflow_attributed_per_tenant():
    """Overwrites are charged to the victim stream (the reference's case)."""
    table = TenantTable.uniform(3, 0.9, 0.01)   # τ ≈ 10.5: everything lives
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw(capacity=32, micro_batch=32,
                                                   block_q=32, block_w=32)),
                            table, span=1, device=CPU)
    rng = np.random.default_rng(9)

    def vecs(n):
        v = rng.standard_normal((n, D)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    rt.submit(1, vecs(16), np.linspace(0.0, 0.15, 16))
    rt.submit(2, vecs(16), np.linspace(0.2, 0.35, 16))
    rt.flush()
    assert rt.stats()["window_overflow"] == 0
    rt.submit(0, vecs(32), np.linspace(0.4, 0.7, 32))
    rt.flush()
    s = rt.stats()
    assert s["window_overflow"] == 32
    assert s["window_overflow_by_tenant"] == [0, 16, 16]
    assert [rt.tenant_stats(t)["window_overflow"] for t in range(3)] == [0, 16, 16]
    rt.submit(0, vecs(32), np.linspace(0.8, 1.1, 32))
    rt.flush()
    assert rt.stats()["window_overflow_by_tenant"] == [32, 16, 16]


# --------------------------------------------------------------------- #
# quota isolation (the reference's conformance invariant)
# --------------------------------------------------------------------- #
B_THETAS = [0.9, 0.8, 0.8, 0.8]
B_LAMS = [2.0, 0.1, 0.1, 0.1]     # slow τ ≈ 2.23; bursty τ ≈ 0.05


def _truth(vecs, ts, theta, lam):
    """Exact (f64) pair set of one tenant's stream in local indices."""
    v = vecs.astype(np.float64)
    dec = (v @ v.T) * np.exp(-lam * np.abs(ts[:, None] - ts[None, :]))
    i, j = np.nonzero(np.tril(dec >= theta, -1))
    return set(zip(j.tolist(), i.tolist()))


def _run_bursty(join_impl, eviction, make_runtime):
    cap, bk = 32, 4
    quotas = (cap // bk,) * bk if eviction == "quota" else None
    cfg = dict(theta=0.8, lam=0.1, capacity=cap, d=D, micro_batch=16,
               max_pairs=4096, tile_k=256, block_q=16, block_w=16, chunk_d=32,
               eviction=eviction, quotas=quotas)
    rt = make_runtime(cfg, join_impl)
    submits, per_tenant = bursty_tenant_traffic(bk - 1, 10, 45, D)
    local_of = [dict() for _ in range(bk)]
    counts = [0] * bk
    for k, v, t in submits:
        for u in rt.submit(k, v, t).tolist():
            local_of[k][u] = counts[k]
            counts[k] += 1
    rt.flush(final=True)
    per = rt.drain_by_tenant()
    got = [{tuple(sorted((local_of[k][a], local_of[k][b])))
            for a, b in zip(per[k][0].tolist(), per[k][1].tolist())}
           for k in range(bk)]
    truth = [_truth(*per_tenant[k], B_THETAS[k], B_LAMS[k]) for k in range(bk)]
    return got, truth, rt.stats()


def _port_runtime(cfg, join_impl):
    return MultiTenantRuntime(EngineConfig(**cfg, join_impl=join_impl),
                              TenantTable(B_THETAS, B_LAMS), span=2, device=CPU)


def _ref_runtime(cfg, join_impl):
    return JRuntime(JConfig(**cfg, join_impl=join_impl or "pallas"),
                    JTable(B_THETAS, B_LAMS), span=2)


@pytest.mark.parametrize("join_impl", [None, "scan", "dense"])
def test_quota_isolation(join_impl):
    """A bursty tenant at 15× the rate cannot change a within-quota
    tenant's pair set under ``quota`` (its 8 slots are fewer than a
    micro-batch, so it evicts itself), while ``oldest`` loses the same
    pairs on the same traffic; both runs equal the reference's."""
    got_q, truth, sq = _run_bursty(join_impl, "quota", _port_runtime)
    got_o, _, so = _run_bursty(join_impl, "oldest", _port_runtime)
    for k in range(1, 4):
        assert truth[k] and got_q[k] == truth[k], k
    assert sum(sq["window_overflow_by_tenant"]) == sq["window_overflow"]
    assert sum(sq["window_overflow_by_tenant"][1:]) == 0
    assert sq["window_overflow_by_tenant"][0] > 0       # self-eviction ran
    assert sum(so["window_overflow_by_tenant"][1:]) > 0
    assert any(truth[k] - got_o[k] for k in range(1, 4))
    for eviction, got, st in (("quota", got_q, sq), ("oldest", got_o, so)):
        want, _, wst = _run_bursty(join_impl, eviction, _ref_runtime)
        assert got == want, eviction
        assert st["window_overflow_by_tenant"] == wst["window_overflow_by_tenant"]


# --------------------------------------------------------------------- #
# tenant table, config validation, router
# --------------------------------------------------------------------- #
def test_tenant_table_validation():
    for th, lm in (([], []), ([0.5, 1.5], [0.1, 0.1]), ([0.5], [-0.1]),
                   ([0.5, 0.6], [0.1])):
        with pytest.raises(ValueError):
            TenantTable(th, lm)
        with pytest.raises(ValueError):
            JTable(th, lm)
    t = TenantTable([0.5, 0.6], [0.1, 0.2])
    assert not t.is_uniform and t.n_tenants == 2
    assert TenantTable.uniform(3, 0.9, 0.1).is_uniform
    assert t.tau_max == JTable([0.5, 0.6], [0.1, 0.2]).tau_max
    with pytest.raises(ValueError):
        t.validate_id(2)
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw()), TenantTable.uniform(2, 0.9, 0.1),
                            device=CPU)
    with pytest.raises(ValueError):
        rt.submit(0, np.zeros((2, D + 1), np.float32), np.zeros(2))
    with pytest.raises(NotImplementedError):
        rt.push(np.zeros((1, D), np.float32), np.zeros(1))


def test_tenant_lookup_matches_reference():
    """Per-row lanes from the device table, pad rows (-1) clipped to tenant
    0; the table is uploaded once per device."""
    import jax.numpy as jnp
    import torch

    th = [0.9, 0.95, 0.8, 0.85]
    lm = [1e-3, 2e-3, 4e-3, 1e-3]
    sq = np.array([3, -1, 0, 2, 1, 1, -1, 3], np.int32)
    got = TenantTable(th, lm)
    want = JTable(th, lm).lookup(jnp.asarray(sq))
    rows = got.lookup(torch.from_numpy(sq))
    for g, w in zip(rows, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.device_tables(CPU)[0] is got.device_tables(CPU)[0]


def test_engine_config_quota_validation():
    table = TenantTable.uniform(2, 0.9, 0.1)
    with pytest.raises(ValueError):                 # 3 quotas, 2 tenants
        MultiTenantRuntime(EngineConfig(**_cfg_kw(capacity=1024, eviction="quota",
                                                  quotas=(256, 256, 512))),
                           table, device=CPU)
    for kw in (dict(eviction="quota", quotas=(30, 30)),     # sum != capacity
               dict(quotas=(32, 32)),                        # quotas off-quota
               dict(eviction="quota"),                       # no table
               dict(eviction="quota", quotas=(64, 0))):      # an empty quota
        with pytest.raises(ValueError):
            EngineConfig(**_cfg_kw(**kw))
        with pytest.raises(ValueError):
            JConfig(**_cfg_kw(**kw))
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw(eviction="quota", quotas=(16, 48))),
                            table, device=CPU)
    assert [rt.tenant_stats(t)["quota"] for t in range(2)] == [16, 48]
    assert rt.stats()["eviction"] == "quota"


@pytest.mark.parametrize("seed,n_tenants,cap", [(0, 3, 16), (1, 3, 8), (2, 5, 31),
                                                (3, 1, 1), (4, 4, 64)])
def test_router_schedule_matches_reference(seed, n_tenants, cap):
    """A random admit/take schedule through both routers: the same rows in
    the same order, the same backpressure and the same counters."""
    rng = np.random.default_rng(seed)
    got, want = RequestRouter(n_tenants, cap), JRouter(n_tenants, cap)
    uid = 0
    for _ in range(80):
        if len(want) and rng.random() < 0.4:
            n = int(rng.integers(1, len(want) + 1))
            for g, w in zip(got.take(n)[:4], want.take(n)[:4]):
                np.testing.assert_array_equal(g, w)
        else:
            t, b = int(rng.integers(0, n_tenants)), int(rng.integers(1, 12))
            args = (t, rng.standard_normal((b, 4)).astype(np.float32),
                    rng.random(b), np.arange(uid, uid + b, dtype=np.int32))
            outcome = []
            for r in (got, want):
                try:
                    r.admit(*args)
                    outcome.append(True)
                except RuntimeError:        # TenantBackpressure, either side's
                    outcome.append(False)
            assert outcome[0] == outcome[1]
            uid += b if outcome[0] else 0
        assert len(got) == len(want)
        assert got.queued_by_tenant == want.queued_by_tenant
        for f in ("items_admitted", "items_rejected", "items_dispatched"):
            assert getattr(got.telemetry, f) == getattr(want.telemetry, f)


def test_backpressure_is_all_or_nothing():
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw()), TenantTable.uniform(2, 0.9, 0.1),
                            max_queue_per_tenant=10, device=CPU)
    vecs, ts = dense_embedding_stream(16, D, seed=1)
    rt.submit(0, vecs[:8], ts[:8])
    with pytest.raises(TenantBackpressure):
        rt.submit(0, vecs[8:12], ts[8:12])          # 8 + 4 > 10
    assert rt.stats()["items_queued"] == 8
    assert rt.stats()["items_rejected"] == 4
    rt.submit(1, vecs[8:], ts[8:])
    rt.submit(0, vecs[8:10], ts[8:10])              # exactly at the cap
    rt.flush(final=True)
    assert rt.n_items == 18


def test_padding_telemetry_counts_waste():
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw(micro_batch=32, block_q=32,
                                                   block_w=32)),
                            TenantTable.uniform(2, 0.9, 0.1), span=3, device=CPU)
    vecs, ts = dense_embedding_stream(40, D, seed=2)
    rt.submit(0, vecs, ts)
    rt.flush(final=True)      # 40 rows → 2 real micro-batches and 1 span-fill
    s = rt.stats()
    assert s["n_items"] == 40 and s["padded_rows"] == 2 * 32 - 40
    assert s["empty_micro_batches"] == 1 and s["spans_dispatched"] == 1
    assert 0.0 < s["padding_waste"] < 1.0 and s["queue_delay_max_s"] >= 0.0


# --------------------------------------------------------------------- #
# the multi-tenant service
# --------------------------------------------------------------------- #
def _service_traffic(svcs):
    rng = np.random.default_rng(11)
    base = rng.standard_normal(32).astype(np.float32)
    t = 0.0
    for _ in range(4):
        for k in range(3):
            b = rng.standard_normal((4, 32)).astype(np.float32)
            b[0] = base + 0.01 * rng.standard_normal(32)
            locs = [svc.submit(k, b, t + np.arange(4) * 0.01) for svc in svcs]
            for loc in locs:
                assert loc.tolist() == list(range(loc[0], loc[0] + 4))
        t += 0.2
    return [svc.flush(final=True) for svc in svcs]


@pytest.mark.parametrize("eviction", ["oldest", "quota"])
def test_multi_tenant_service_namespaced_groups(eviction):
    """Each tenant groups its own planted copies under local uids, and the
    flushed pairs equal the reference service's."""
    th, lm = [0.9, 0.9, 0.95], [0.05, 0.05, 0.02]
    svc = MultiTenantSSSJService(TenantTable(th, lm), dim=32, capacity=256,
                                 micro_batch=16, eviction=eviction, device=CPU)
    ref = JService(JTable(th, lm), dim=32, capacity=256, micro_batch=16,
                   eviction=eviction)
    got, want = _service_traffic([svc, ref])
    assert got.keys() == want.keys()
    for k in got:
        assert [p[:2] for p in got[k]] == [p[:2] for p in want[k]]
        np.testing.assert_allclose([p[2] for p in got[k]], [p[2] for p in want[k]],
                                   atol=SCORE_ATOL)
    for k in range(3):
        assert svc.duplicate_groups(k) == ref.duplicate_groups(k) == [[0, 4, 8, 12]]
        assert svc.trending(k, min_size=4) == [[0, 4, 8, 12]]
        assert svc.tenant_stats(k)["submitted"] == 16
    assert svc.registry.schema() == ref.registry.schema()
    if eviction == "quota":
        assert svc.runtime.cfg.quotas == ref.runtime.cfg.quotas


def test_multi_tenant_service_refuses_unported_variants(embedders):
    table = TenantTable.uniform(2, 0.9, 0.1)
    with pytest.raises(TypeError, match="Mesh"):     # mesh= takes a port Mesh
        MultiTenantSSSJService(table, dim=32, mesh=object(), device=CPU)
    # fused= is ported: the reference's validation, d_model 64 against d 32
    emb = embedders[1]
    with pytest.raises(ValueError, match="d_model"):
        MultiTenantSSSJService(table, dim=32, device=CPU,
                               fused=FusedEmbedder(emb.cfg, emb.params, 16))
    for quotas in ((32, 31), (64,), (64, 0)):     # sum, count, an empty quota
        with pytest.raises(ValueError):
            MultiTenantSSSJService(table, dim=32, capacity=64, eviction="quota",
                                   quotas=quotas, device=CPU)
    with pytest.raises(ValueError):                 # quotas off-quota
        MultiTenantSSSJService(table, dim=32, capacity=64, quotas=(32, 32), device=CPU)


# --------------------------------------------------------------------- #
# fused embed→join
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def embedders():
    """The reference's reduced qwen3-0.6b embedder and the port's on its
    parameters, carried across."""
    import jax
    from repro.configs import ARCHS as JARCHS
    from repro.serving.embedder import LMEmbedder as JEmbedder

    jemb = JEmbedder(JARCHS["qwen3-0.6b"].reduced(), key=jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jemb.params), CPU)
    return jemb, LMEmbedder(ARCHS["qwen3-0.6b"].reduced(), params, device=CPU)


FUSED_S, FUSED_N = 32, 56
FUSED_THETAS, FUSED_LAMS = [0.9, 0.85, 0.9], [0.1, 0.05, 0.1]


def _fused_traffic():
    """The reference test's traffic: 56 one-document submits over three
    tenants, four copies of one document planted in tenant 1."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 500, (FUSED_N, FUSED_S)).astype(np.int32)
    tenants = rng.integers(0, 3, FUSED_N)
    plant = np.where(tenants == 1)[0][:4]
    for i in plant[1:]:
        toks[i] = toks[plant[0]]
    return toks, tenants, np.cumsum(rng.exponential(0.05, FUSED_N))


def _fused_cfg_kw():
    return _cfg_kw(capacity=256, micro_batch=16, block_q=16, block_w=16, chunk_d=64)


def _run_fused(rts, data):
    """One-document submits into every runtime (``data[i]`` its payloads),
    the same uids in all; then a final flush and a drain with masks."""
    toks, tenants, ts = _fused_traffic()
    for i in range(FUSED_N):
        k = int(tenants[i])
        uids = [rt.submit(k, d[i:i + 1], ts[i:i + 1]) for rt, d in zip(rts, data)]
        for u in uids[1:]:
            assert u.tolist() == uids[0].tolist()
    for rt in rts:
        rt.flush(final=True)
    return [rt.drain_arrays(return_masks=True) for rt in rts]


def test_fused_embed_join_matches_host_roundtrip(embedders):
    """In the port, embedding inside the step (micro-batches of 16) emits
    the pairs, scores and masks of embedding on the host (one document a
    call) and submitting vectors.  Measured on the CPU: bit-identical, as
    in the reference; the H100 run states its own tolerance."""
    _, emb = embedders
    toks = _fused_traffic()[0]
    table = TenantTable(FUSED_THETAS, FUSED_LAMS)
    cfg = EngineConfig(**_fused_cfg_kw())
    rt_f = MultiTenantRuntime(cfg, table, span=2, device=CPU,
                              fused=FusedEmbedder(emb.cfg, emb.params, FUSED_S))
    rt_h = MultiTenantRuntime(cfg, table, span=2, device=CPU)
    host = np.concatenate([emb(toks[i:i + 1]) for i in range(FUSED_N)])
    (fa, fb, fs, fm), (ha, hb, hs, hm) = _run_fused([rt_f, rt_h], [toks, host])
    assert fa.size > 0                       # the planted copies emitted
    np.testing.assert_array_equal(fa, ha)
    np.testing.assert_array_equal(fb, hb)
    np.testing.assert_array_equal(fs, hs)
    np.testing.assert_array_equal(fm, hm)


def test_fused_runtime_matches_reference(embedders):
    """The port's fused runtime against the reference's on the same
    parameters and traffic: pairs and masks equal, none in the band,
    scores within 1e-5."""
    from repro.runtime import FusedEmbedder as JFused

    jemb, emb = embedders
    toks = _fused_traffic()[0]
    kw = _fused_cfg_kw()
    rt = MultiTenantRuntime(EngineConfig(**kw), TenantTable(FUSED_THETAS, FUSED_LAMS),
                            span=2, device=CPU,
                            fused=FusedEmbedder(emb.cfg, emb.params, FUSED_S))
    jrt = JRuntime(JConfig(**kw, join_impl="pallas"), JTable(FUSED_THETAS, FUSED_LAMS),
                   span=2, fused=JFused(jemb.cfg, jemb.params, FUSED_S))
    (ga, gb, gs, gm), (wa, wb, ws, wm) = _run_fused([rt, jrt], [toks, toks])
    assert ga.size > 0
    theta = np.asarray(FUSED_THETAS)[_fused_traffic()[1][ga]]
    assert np.all(np.abs(gs - theta) > BAND)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL)
    np.testing.assert_array_equal(gm, wm)
    assert _stats_without_delays(rt) == _stats_without_delays(jrt)


def test_fused_embedder_validation(embedders):
    """The reference's ``test_fused_embedder_validation``: d_model against
    the engine's d, and the token width of a submission."""
    _, emb = embedders
    table = TenantTable.uniform(2, 0.9, 0.1)
    with pytest.raises(ValueError, match="d_model"):     # 64 != 32
        MultiTenantRuntime(EngineConfig(**_cfg_kw(d=32)), table, device=CPU,
                           fused=FusedEmbedder(emb.cfg, emb.params, 16))
    rt = MultiTenantRuntime(EngineConfig(**_cfg_kw(capacity=256)), table, device=CPU,
                            fused=FusedEmbedder(emb.cfg, emb.params, 16))
    with pytest.raises(ValueError, match="tokens"):      # wrong token width
        rt.submit(0, np.zeros((2, 8), np.int32), np.zeros(2))
    with pytest.raises(NotImplementedError, match="single-device"):
        MultiTenantSSSJService(table, dim=64, capacity=256, micro_batch=16,
                               mesh=make_mesh_for((2,), ("data",), devices=[CPU] * 2),
                               fused=FusedEmbedder(emb.cfg, emb.params, 16))


def test_fused_service_matches_reference(embedders):
    """``MultiTenantSSSJService(fused=...)`` takes token batches: its
    flushed pairs and groups equal the reference service's."""
    from repro.runtime import FusedEmbedder as JFused

    jemb, emb = embedders
    toks, tenants, ts = _fused_traffic()
    table = (FUSED_THETAS, FUSED_LAMS)
    svc = MultiTenantSSSJService(TenantTable(*table), dim=64, capacity=256,
                                 micro_batch=16, device=CPU,
                                 fused=FusedEmbedder(emb.cfg, emb.params, FUSED_S))
    ref = JService(JTable(*table), dim=64, capacity=256, micro_batch=16,
                   fused=JFused(jemb.cfg, jemb.params, FUSED_S))
    for k in range(3):
        rows = np.where(tenants == k)[0]
        for s in (svc, ref):
            s.submit(k, toks[rows], ts[rows])
    got, want = svc.flush(final=True), ref.flush(final=True)
    assert got.keys() == want.keys() and 1 in got
    for k in got:
        assert [p[:2] for p in got[k]] == [p[:2] for p in want[k]]
        np.testing.assert_allclose([p[2] for p in got[k]], [p[2] for p in want[k]],
                                   atol=SCORE_ATOL)
    for k in range(3):
        assert svc.duplicate_groups(k) == ref.duplicate_groups(k)
    assert [0, 1, 2, 3] in svc.duplicate_groups(1)


# --------------------------------------------------------------------- #
# a join smaller than one tile on the card
# --------------------------------------------------------------------- #
CUDA0 = torch.device("cuda", 0)   # named, never touched: no card is needed


@pytest.mark.parametrize("kw", [
    dict(capacity=64, block_w=128, block_q=16),   # window under one tile
    dict(micro_batch=16, block_q=32),             # queries under one tile
    dict(micro_batch=16, block_w=32),             # the self join under one tile
    dict(d=16, chunk_d=32),                       # d under one chunk
], ids=["capacity", "block_q", "self", "chunk_d"])
def test_tenant_step_refuses_sub_tile_joins_on_cuda(kw, embedders):
    """On a CUDA device the kernel route's tenant step (fused too) refuses
    a join smaller than one tile, which the join wrapper would run as the
    dense reference; the CPU step and the card's dense oracle run it."""
    cfg = EngineConfig(**_cfg_kw(**kw))
    table = TenantTable.uniform(2, 0.9, 0.1)
    with pytest.raises(ValueError, match="smaller than one"):
        make_tenant_batch_step(cfg, table, device=CUDA0)
    emb = embedders[1]
    with pytest.raises(ValueError, match="smaller than one"):
        make_tenant_batch_step(cfg, table, FusedEmbedder(emb.cfg, emb.params, 8),
                               device=CUDA0)
    make_tenant_batch_step(cfg, table, device=CPU)
    make_tenant_batch_step(dataclasses.replace(cfg, join_impl="dense"), table,
                           device=CUDA0)

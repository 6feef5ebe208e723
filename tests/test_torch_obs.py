"""The port's observability layer against ``repro.obs``.

Each scenario of ``tests/test_obs.py`` that needs neither the runtime nor
sharding runs the same calls through ``repro_torch.obs`` and
``repro.obs`` and compares what comes out: bucket bounds, counts, sums,
percentiles, snapshots, JSON, and the Prometheus text, which must be
string-equal.  Then the engine's registry: its ``engine/…`` schema is the
pinned one, and after the same stream its Prometheus text is the
reference engine's.
"""

import json
import math
import os
import re

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import Counters
from repro.engine import EngineConfig as JConfig
from repro.engine import StreamEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.data import dense_embedding_stream
from repro_torch.engine import EngineConfig, StreamEngine

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "metrics_schema.json")


@pytest.mark.parametrize("lo,hi,growth", [(1e-5, 64.0, 2.0), (0.5, 100.0, 1.5),
                                          (1e-3, 1.0, 10.0), (3.0, 3.5, 1.01)])
def test_log_buckets_match_reference(lo, hi, growth):
    got = tobs.log_buckets(lo, hi, growth)
    assert got == jobs.log_buckets(lo, hi, growth)
    assert got[0] == lo and got[-2] < hi <= got[-1]
    assert all(b == a * growth for a, b in zip(got, got[1:]))


def test_latency_bounds_match_reference():
    assert tobs.LATENCY_BOUNDS_S == jobs.LATENCY_BOUNDS_S
    assert tobs.LATENCY_BOUNDS_S == tobs.log_buckets(1e-5, 64.0, 2.0)


@pytest.mark.parametrize("lo,hi,g", [(0.0, 1.0, 2.0), (1.0, 1.0, 2.0), (1e-3, 1.0, 1.0)])
def test_log_buckets_reject_degenerate(lo, hi, g):
    for mod in (tobs, jobs):
        with pytest.raises(ValueError):
            mod.log_buckets(lo, hi, g)


def test_histogram_le_semantics_match_reference():
    hs = [mod.Histogram("t", bounds=(1.0, 2.0, 4.0)) for mod in (tobs, jobs)]
    for v, bucket in [(0.5, 0), (1.0, 0), (1.0000001, 1), (2.0, 1),
                      (4.0, 2), (4.0001, 3)]:
        for h in hs:
            before = list(h.counts)
            h.observe(v)
            delta = [b - a for a, b in zip(before, h.counts)]
            assert delta == [int(i == bucket) for i in range(4)], v
    assert hs[0].read() == hs[1].read()
    with pytest.raises(ValueError):
        tobs.Histogram("bad", bounds=(2.0, 1.0))


def test_observe_many_matches_observe_and_reference():
    rng = np.random.default_rng(3)
    vals = np.concatenate([np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 9.0, 1.0]),
                           rng.exponential(2.0, 200)])
    one, many = (tobs.Histogram(n, bounds=(1.0, 2.0, 4.0)) for n in "ab")
    ref = jobs.Histogram("c", bounds=(1.0, 2.0, 4.0))
    for v in vals:
        one.observe(float(v))
    many.observe_many(vals)
    ref.observe_many(vals)
    many.observe_many(np.array([]))                 # empty input: no change
    assert one.counts == many.counts == ref.counts
    assert one.count == many.count == ref.count == vals.size
    assert math.isclose(one.sum, many.sum) and many.sum == ref.sum


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.9, 0.99, 1.0])
def test_percentiles_match_reference(q):
    rng = np.random.default_rng(11)
    vals = rng.lognormal(-6.0, 2.0, 500)
    hs = [mod.Histogram("lat") for mod in (tobs, jobs)]
    for h in hs:
        h.observe_many(vals)
    got, want = hs[0].percentile(q), hs[1].percentile(q)
    assert got == want
    snap = hs[0].read()
    assert json.loads(json.dumps(snap)) == snap
    assert tobs.histogram_percentile(snap, q) == jobs.histogram_percentile(snap, q)


def test_percentile_edges_match_reference():
    for mod in (tobs, jobs):
        h = mod.Histogram("t", bounds=(1.0, 2.0, 4.0))
        assert h.percentile(0.5) == 0.0                 # empty
        h.observe_many(np.full(100, 1.5))
        assert 1.0 < h.percentile(0.5) <= 2.0
        assert h.percentile(1.0) == 2.0
        h2 = mod.Histogram("o", bounds=(1.0,))
        h2.observe(50.0)                                # overflow bucket
        assert h2.percentile(0.99) == 1.0
        with pytest.raises(ValueError):
            h2.percentile(1.5)


def test_registry_get_or_create_and_kind_guard():
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        c = reg.counter("x/total")
        c.inc(3)
        assert reg.counter("x/total") is c
        with pytest.raises(TypeError):
            reg.gauge("x/total")
        with pytest.raises(TypeError):
            reg.info("x/total")
        h = reg.histogram("x/lat")
        assert reg.histogram("x/lat", bounds=jobs.LATENCY_BOUNDS_S) is h
        with pytest.raises(ValueError):
            reg.histogram("x/lat", bounds=(1.0, 2.0))


def test_merge_disjoint_matches_reference():
    parts = ({"a": 1}, {"b": 2.5}, {"c/d": 3})
    assert tobs.merge_disjoint(*parts) == jobs.merge_disjoint(*parts)
    assert tobs.merge_disjoint() == {}
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match="pairs_emitted"):
            mod.merge_disjoint({"pairs_emitted": 1}, {"x": 0, "pairs_emitted": 2})


def test_collector_republishes_at_snapshot_time():
    state = {"v": 1}
    regs = [mod.MetricsRegistry() for mod in (tobs, jobs)]
    for reg in regs:
        reg.register_collector(lambda r: r.counter("s/v").set(state["v"]))
        reg.register_collector(lambda r: r.gauge("s/g").set(state["v"] / 2))
    assert regs[0].snapshot() == regs[1].snapshot() == {"s/g": 0.5, "s/v": 1}
    state["v"] = 7
    assert regs[0].snapshot() == regs[1].snapshot() == {"s/g": 3.5, "s/v": 7}


def _fill(reg, rng):
    """The same mixed contents into either package's registry."""
    reg.counter("engine/pairs_emitted").inc(5)
    reg.counter("span/scan/time_s").inc(0.125)
    reg.counter("span/scan/time_s").inc(1e-7)
    reg.gauge("router/items_queued").set(3)
    reg.gauge("router/queue_delay_max_s").set(float("inf"))
    reg.gauge("x/neg").set(float("-inf"))
    reg.gauge("x/ratio").set(1 / 3)
    reg.info("runtime/eviction").set("quota")
    reg.counter("tenant/0/submitted").inc(12)
    reg.counter("9lives/odd-name.metric").inc(1)
    reg.histogram("latency/admit_to_emit_s").observe_many(rng.lognormal(-5, 2, 300))
    reg.histogram("x/small", bounds=(0.5, 1.0, 2.0)).observe(1.0)


def test_snapshot_json_and_prometheus_text_equal_reference():
    regs = [mod.MetricsRegistry() for mod in (tobs, jobs)]
    for reg in regs:
        _fill(reg, np.random.default_rng(1))
    got, want = regs
    assert got.snapshot() == want.snapshot()
    assert got.schema() == want.schema()
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=2, sort_keys=True) == want.to_json(indent=2, sort_keys=True)
    assert json.loads(got.to_json()) == got.snapshot()
    text = got.prometheus_text()
    assert text == want.prometheus_text()
    assert "# TYPE engine_pairs_emitted counter" in text
    assert "engine_pairs_emitted 5" in text.splitlines()
    assert 'runtime_eviction{value="quota"} 1' in text
    assert "_9lives_odd_name_metric 1" in text.splitlines()
    assert "router_queue_delay_max_s +Inf" in text.splitlines()
    buckets = re.findall(r'latency_admit_to_emit_s_bucket\{le="([^"]+)"\} (\d+)', text)
    counts = [int(c) for _, c in buckets]
    assert counts == sorted(counts) and buckets[-1][0] == "+Inf"
    assert counts[-1] == 300
    assert "latency_admit_to_emit_s_count 300" in text


def test_publish_counters_bridges_paper_vocabulary():
    """The reference's ``Counters`` dataclass, published into both."""
    c = Counters()
    regs = [mod.MetricsRegistry() for mod in (tobs, jobs)]
    tobs.publish_counters(regs[0], c)
    jobs.publish_counters(regs[1], c)
    c.entries_traversed += 11
    c.full_sims_computed += 4
    c.peak_index_entries = 9
    snap = regs[0].snapshot()
    assert snap == regs[1].snapshot()
    assert snap["paper/entries_traversed"] == 11
    assert snap["paper/peak_index_entries"] == 9
    sch = regs[0].schema()
    assert sch == regs[1].schema()
    assert sch["paper/entries_traversed"] == "counter"
    assert sch["paper/peak_index_entries"] == "gauge"
    assert regs[0].prometheus_text() == regs[1].prometheus_text()


def test_publish_flat_matches_reference():
    flat = {"shard/0/live_slots": 5, "shard/0/cursor": 17, "mesh/n_shards": 4,
            "shard/0/pairs": 99, "shard/1/overflow": 0}
    regs = [mod.MetricsRegistry() for mod in (tobs, jobs)]
    tobs.publish_flat(regs[0], flat)
    jobs.publish_flat(regs[1], flat)
    assert regs[0].schema() == regs[1].schema()
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].schema()["shard/0/cursor"] == "gauge"
    assert tobs.bridge._GAUGE_LEAVES == jobs.bridge._GAUGE_LEAVES


def test_span_tracer_matches_reference():
    regs = [mod.MetricsRegistry() for mod in (tobs, jobs)]
    tracers = [tobs.SpanTracer(regs[0]), jobs.SpanTracer(regs[1])]
    for tr in tracers:
        tr.record("drain", 0.25)
        tr.record("drain", 0.5)
        tr.record("h2d", 1e-3)
    assert regs[0].snapshot() == regs[1].snapshot()
    with tracers[0].span("scan"):
        pass
    snap = regs[0].snapshot()
    assert snap["span/scan/calls"] == 1 and snap["span/scan/time_s"] >= 0.0
    assert math.isclose(snap["span/drain/time_s"], 0.75)
    assert tobs.PIPELINE_STAGES == jobs.PIPELINE_STAGES
    reg = tobs.MetricsRegistry()
    with pytest.raises(KeyError):                   # the body's error passes
        with tobs.SpanTracer(reg, prefix="p").span("emit"):
            raise KeyError("x")
    assert reg.snapshot()["p/emit/calls"] == 1       # and the span is kept


def test_torch_trace_hook_never_raises(tmp_path):
    reg = tobs.MetricsRegistry()
    tr = tobs.SpanTracer(reg)
    with tr.torch_trace(str(tmp_path / "trace")) as started:
        assert started in (True, False)
        sum(range(10))
    assert reg.snapshot()["span/torch_traces"] == int(started)
    # a logdir that cannot be made (a file is in the way) does not raise
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with tr.torch_trace(str(blocker / "sub")) as started2:
        assert started2 is False
    assert reg.snapshot()["span/torch_traces"] == int(started)


def test_engine_schema_is_pinned():
    with open(SCHEMA_PATH) as f:
        pinned = {k: v for k, v in json.load(f).items() if k.startswith("engine/")}
    eng = StreamEngine(EngineConfig(theta=0.8, lam=0.05, capacity=128, d=32,
                                    micro_batch=16, block_q=16, block_w=16,
                                    chunk_d=32), device="cpu")
    assert eng.registry.schema() == pinned
    eng.close()


def test_engine_prometheus_text_equals_reference():
    """After the same stream, the engines' registries render the same text."""
    kw = dict(theta=0.8, lam=0.05, capacity=256, d=32, micro_batch=16,
              max_pairs=1024, block_q=16, block_w=16, chunk_d=32)
    vecs, ts = dense_embedding_stream(96, 32, seed=1, rate=2.0)
    got = StreamEngine(EngineConfig(**kw), device="cpu")
    want = JEngine(JConfig(join_impl="pallas", **kw))
    for eng in (got, want):
        for i in range(0, 96, 16):
            eng.push(vecs[i:i + 16], ts[i:i + 16])
        eng.drain_arrays()
    assert got.registry.prometheus_text() == want.registry.prometheus_text()
    assert got.registry.to_json() == want.registry.to_json()
    assert got.metrics()["engine/pairs_emitted"] > 0
    got.close()
    want.close()

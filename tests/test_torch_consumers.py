"""The port's single-engine consumers on the CPU against the reference's.

``BlockedStreamJoiner`` (reference: ``"pallas"`` in interpret mode),
``hashing_embed``, ``DedupFilter``/``TokenPipeline`` and ``SSSJService``
(reference: its CPU default, ``"scan"``) get the same numpy-seeded
inputs on both sides.  Tolerances: uids, masks, token batches, groups and
counters exact; scores ``atol=1e-5``; embeddings bit-equal.  The streams
hold no pair within 1e-5 of θ, which the pair comparisons check.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core.blocked import BlockedJoinConfig as JBlockedConfig
from repro.core.blocked import BlockedStreamJoiner as JBlocked
from repro.data.pipeline import DedupFilter as JDedup
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.data.pipeline import hashing_embed as j_hashing_embed
from repro.serving.service import ServiceStats as JServiceStats
from repro.serving.service import SSSJService as JService
from repro_torch.core.blocked import BlockedJoinConfig, BlockedStreamJoiner
from repro_torch.data import DedupFilter, TokenPipeline, dense_embedding_stream, hashing_embed
from repro_torch.serving import ServiceStats, SSSJService

SCORE_ATOL = 1e-5
BAND = 1e-5
CPU = "cpu"


def _assert_same_pairs(got, want, theta):
    """Same ``(uid_a, uid_b)`` in the same order, scores within tolerance,
    and no pair of either side in the ε-band around θ."""
    assert [p[:2] for p in got] == [p[:2] for p in want]
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in want],
                               atol=SCORE_ATOL)
    assert all(abs(p[2] - theta) > BAND for p in got + want)


# --------------------------------------------------------------------- #
# BlockedStreamJoiner
# --------------------------------------------------------------------- #
def _blocked_pair(**kw):
    base = dict(capacity=512, d=64, block_q=32, block_w=32, chunk_d=32)
    base.update(kw)
    return (BlockedStreamJoiner(BlockedJoinConfig(**base), device=CPU),
            JBlocked(JBlockedConfig(**base)))


@pytest.mark.parametrize("theta,lam", [(0.8, 0.05), (0.6, 0.2), (0.95, 0.02)])
def test_blocked_joiner_matches_reference(theta, lam):
    vecs, ts = dense_embedding_stream(320, 64, seed=7, rate=2.0)
    got_bj, want_bj = _blocked_pair(theta=theta, lam=lam)
    n = 0
    for i in range(0, 320, 64):
        got = got_bj.push(vecs[i:i + 64], ts[i:i + 64])
        want = want_bj.push(vecs[i:i + 64], ts[i:i + 64])
        _assert_same_pairs(got, want, theta)
        n += len(got)
    assert n > 0
    assert got_bj.overflow == want_bj.overflow == 0
    assert got_bj.chunks_executed == want_bj.chunks_executed
    assert got_bj.tiles_total == want_bj.tiles_total
    assert got_bj.chunks_executed < got_bj.tiles_total * 2   # the early exit ran


def test_blocked_config_pins_lossless_kernel_route():
    for use_ref in (False, True):
        cfg = BlockedJoinConfig(theta=0.8, lam=0.05, capacity=256, d=32,
                                block_q=16, block_w=32, use_ref=use_ref).to_engine()
        ref = JBlockedConfig(theta=0.8, lam=0.05, capacity=256, d=32,
                             block_q=16, block_w=32, use_ref=use_ref).to_engine()
        assert cfg.tile_k == ref.tile_k == 16 * 32
        assert cfg.join_impl is None               # the kernel route, always
        same = ("theta", "lam", "capacity", "d", "micro_batch", "max_pairs",
                "tile_k", "block_q", "block_w", "chunk_d", "use_ref")
        assert all(getattr(cfg, k) == getattr(ref, k) for k in same)
    assert BlockedJoinConfig(theta=0.9, lam=0.1, capacity=64, d=8).tau == \
        JBlockedConfig(theta=0.9, lam=0.1, capacity=64, d=8).tau


def test_blocked_emission_overflow_raises_like_reference():
    d = 32
    rng = np.random.default_rng(2)
    base = rng.standard_normal(d).astype(np.float32)
    vecs = base + 0.01 * rng.standard_normal((64, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ts = np.linspace(0.0, 0.01, 64)
    kw = dict(theta=0.9, lam=0.01, capacity=128, d=d, block_q=32, block_w=32,
              chunk_d=32, max_pairs=8)
    got_bj, want_bj = _blocked_pair(**kw)
    for bj in (got_bj, want_bj):
        with pytest.raises(RuntimeError, match="max_pairs"):
            bj.push(vecs[:32], ts[:32])
    # the surviving pairs stayed queued, the same on both sides
    got, want = got_bj.engine.drain_pairs(), want_bj.engine.drain_pairs()
    assert len(got) == 8
    _assert_same_pairs(got, want, 0.9)
    assert got_bj.engine.pairs_dropped == want_bj.engine.pairs_dropped > 0


def test_blocked_ring_overflow_counter_matches_reference():
    d = 32
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((128, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ts = np.linspace(0.0, 0.1, 128)
    got_bj, want_bj = _blocked_pair(theta=0.9, lam=0.001, capacity=64, d=d)
    for i in range(0, 128, 32):
        _assert_same_pairs(got_bj.push(vecs[i:i + 32], ts[i:i + 32]),
                           want_bj.push(vecs[i:i + 32], ts[i:i + 32]), 0.9)
    assert got_bj.overflow == want_bj.overflow > 0
    assert int(got_bj.state.cursor) == int(want_bj.state.cursor)


# --------------------------------------------------------------------- #
# hashing_embed, DedupFilter, TokenPipeline
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,seq,dim,vocab,seed", [(8, 64, 256, 50_000, 17),
                                                  (5, 33, 100, 151_936, 3),
                                                  (3, 128, 1024, 2**31 - 1, 17)])
def test_hashing_embed_bit_equal(n, seq, dim, vocab, seed):
    toks = np.random.default_rng(n + seq).integers(1, vocab, (n, seq))
    got, want = hashing_embed(toks, dim, seed=seed), j_hashing_embed(toks, dim, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hashing_embed(toks.astype(np.int32), dim),
                                  j_hashing_embed(toks.astype(np.int32), dim))


def test_dedup_filter_keep_masks_match_reference():
    got_f = DedupFilter(theta=0.85, lam=0.05, dim=256, capacity=512, device=CPU)
    want_f = JDedup(theta=0.85, lam=0.05, dim=256, capacity=512)
    rng = np.random.default_rng(0)
    doc = rng.integers(1, 50_000, (1, 128))
    near = doc.copy()
    near[0, :4] = rng.integers(1, 50_000, 4)
    batches = [
        (np.concatenate([doc, doc.copy(), rng.integers(1, 50_000, (6, 128))]),
         np.linspace(0.0, 0.1, 8)),
        (np.concatenate([near, rng.integers(1, 50_000, (90, 128))]),
         np.linspace(0.2, 0.3, 91)),
        (doc, np.array([1e6])),          # far outside the horizon: kept
    ]
    for toks, ts in batches:
        got, want = got_f.filter(toks, ts), want_f.filter(toks, ts)
        np.testing.assert_array_equal(got, want)
    assert got_f.n_dropped == want_f.n_dropped == 2
    assert got_f.n_seen == want_f.n_seen == 100
    assert got_f.cfg.tile_k == got_f.cfg.max_pairs == 8


def _pipelines(dedup_kw, **kw):
    """Port and reference pipelines with their dedup filters."""
    got = TokenPipeline(**kw, dedup=DedupFilter(**dedup_kw, device=CPU))
    want = JPipeline(**kw, dedup=JDedup(**dedup_kw))
    return got, want


PIPE = dict(vocab_size=50_000, batch=32, seq_len=64, seed=2, dup_frac=0.4)
DEDUP = dict(theta=0.8, lam=0.1, dim=256, capacity=512, block=16)


def test_token_pipeline_with_dedup_matches_reference():
    got_p, want_p = _pipelines(DEDUP, **PIPE)
    for _ in range(6):
        got, want = got_p.next_batch(), want_p.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
    assert got_p.dedup.n_dropped == want_p.dedup.n_dropped > 0
    assert got_p.dedup.n_seen == want_p.dedup.n_seen == 6 * 32


def test_token_pipeline_resume_with_dedup_matches_reference():
    """Checkpoint after 3 steps, restore into a fresh pipeline and filter."""
    got_p, want_p = _pipelines(DEDUP, **PIPE)
    for _ in range(3):
        got_p.next_batch()
        want_p.next_batch()
    state = got_p.checkpoint_state()
    assert state == want_p.checkpoint_state()
    got_r, want_r = _pipelines(DEDUP, **dict(PIPE, seed=0))
    got_r.restore_state(state)
    want_r.restore_state(want_p.checkpoint_state())
    for _ in range(3):
        got, want = got_r.next_batch(), want_r.next_batch()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got_r.dedup.n_dropped == want_r.dedup.n_dropped


def test_token_pipeline_shards_match_reference_and_are_disjoint():
    kw = dict(vocab_size=50_000, batch=4, seq_len=32, seed=1, num_hosts=4)
    got = [TokenPipeline(host_id=h, **kw).next_batch()["tokens"] for h in range(4)]
    want = [JPipeline(host_id=h, **kw).next_batch()["tokens"] for h in range(4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(got[i], got[j])


# --------------------------------------------------------------------- #
# SSSJService
# --------------------------------------------------------------------- #
def _service_stream(rng, n_groups=6, per=5, d=32, noise=0.02):
    """Groups of near-copies interleaved with unrelated vectors, in
    request batches of 16 (not unit norm: the service normalizes)."""
    base = rng.standard_normal((n_groups, d)).astype(np.float32)
    rows = []
    for g in range(n_groups):
        for _ in range(per):
            rows.append(base[g] + noise * rng.standard_normal(d).astype(np.float32))
    rows += list(rng.standard_normal((40, d)).astype(np.float32))
    order = rng.permutation(len(rows))
    vecs = 3.0 * np.stack(rows)[order]
    ts = np.sort(rng.random(len(rows))) * 2.0
    return [(vecs[i:i + 16], ts[i:i + 16]) for i in range(0, len(vecs), 16)]


def _assert_services_agree(got_s, want_s, batches, theta):
    n = 0
    for b, t in batches:
        got, want = got_s.submit(b, t), want_s.submit(b, t)
        _assert_same_pairs(got, want, theta)
        n += len(got)
    assert n > 0
    groups = got_s.duplicate_groups()
    assert groups == want_s.duplicate_groups() and groups
    assert got_s.trending(3) == want_s.trending(3)
    assert got_s.trending(5) == want_s.trending(5)
    assert dataclasses.asdict(got_s.stats) == dataclasses.asdict(want_s.stats)
    assert [f.name for f in dataclasses.fields(ServiceStats)] == \
        [f.name for f in dataclasses.fields(JServiceStats)]


def test_service_matches_reference_on_vectors():
    kw = dict(theta=0.9, lam=0.1, dim=32, capacity=128, block=16)
    got_s, want_s = SSSJService(**kw, device=CPU), JService(**kw)
    assert got_s.engine.cfg.tile_k == 16 * 16                # strict: lossless tiles
    batches = _service_stream(np.random.default_rng(5))
    _assert_services_agree(got_s, want_s, batches, 0.9)
    assert got_s.stats.pairs_dropped == 0
    snap = got_s.snapshot()
    assert snap == got_s.registry.snapshot()
    stats = got_s.engine.stats()
    assert {k: snap[f"engine/{k}"] for k in stats} == stats
    text = got_s.prometheus_text()
    for line in text.splitlines():
        assert line.startswith("# TYPE ") or len(line.split(" ")) == 2, line


def test_service_matches_reference_with_hashing_embed():
    rng = np.random.default_rng(8)
    docs = rng.integers(1, 50_000, (12, 96))
    toks = [docs]
    for _ in range(3):                     # three rounds of 5 % token noise
        near = docs.copy()
        near[:, :5] = rng.integers(1, 50_000, (12, 5))
        toks.append(near)
    toks = np.concatenate(toks)[rng.permutation(48)]
    ts = np.linspace(0.0, 0.5, 48)
    kw = dict(theta=0.85, lam=0.1, dim=256, capacity=256, block=16)
    got_s = SSSJService(**kw, embed_fn=functools.partial(hashing_embed, dim=256),
                        device=CPU)
    want_s = JService(**kw, embed_fn=functools.partial(j_hashing_embed, dim=256))
    batches = [(toks[i:i + 12], ts[i:i + 12]) for i in range(0, 48, 12)]
    _assert_services_agree(got_s, want_s, batches, 0.85)
    assert max(len(g) for g in got_s.duplicate_groups()) >= 3


def test_service_strict_mode_raises_like_reference():
    rng = np.random.default_rng(1)
    base = rng.standard_normal(32).astype(np.float32)
    vecs = base + 0.01 * rng.standard_normal((32, 32)).astype(np.float32)
    ts = np.linspace(0.0, 0.01, 32)
    kw = dict(theta=0.9, lam=0.01, dim=32, capacity=64, block=16, max_pairs=8)
    for svc in (SSSJService(**kw, device=CPU), JService(**kw)):
        with pytest.raises(RuntimeError, match="max_pairs"):
            svc.submit(vecs, ts)
    loose = [SSSJService(**kw, strict=False, device=CPU), JService(**kw, strict=False)]
    got, want = (s.submit(vecs, ts) for s in loose)
    _assert_same_pairs(got, want, 0.9)
    assert loose[0].engine.cfg.tile_k == loose[1].engine.cfg.tile_k == 256
    assert loose[0].stats.pairs_dropped == loose[1].stats.pairs_dropped > 0

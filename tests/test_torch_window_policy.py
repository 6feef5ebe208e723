"""The port's write-slot policies against ``repro.engine.window``.

The same numpy-seeded ring (a mix of empty, expired and live slots, a
random cursor and random lane cursors) and the same micro-batches go
through the reference's and the port's ``select_write_slots`` and
``push_with_overflow`` under ``oldest``, ``dead`` and ``quota``.  Held
exact: destination slots, self-evictions, cursors, every state leaf
(``vecs``, ``ts``, ``uids``, ``sids``, ``lane_cursor``, ``lane_overflow``,
``overflow``) and the strip summary's integer and time leaves; its
``vmax``/``cnorm`` within ``atol=1e-6`` (sums of squares in another
order).  The cases follow ``tests/test_window_policy.py``: unique slots,
split invariance, quota conservation, dead-first preference and quota
self-eviction, here with fixed seeds only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import window as jwin
from repro_torch.engine import window as twin

CPU = "cpu"
D = 8
K = 3
TAU = 2.0


def _random_states(rng, cap, eviction="oldest", n_lanes=K, t_now=10.0,
                   summary_block_w=None):
    """The reference's and the port's copy of one random reachable ring
    (the shape ``tests/test_window_policy.py`` draws)."""
    kind = rng.integers(0, 3, cap)              # 0 empty, 1 expired, 2 live
    ts = np.full(cap, 3.0e30, np.float32)
    uids = np.full(cap, -1, np.int32)
    sids = np.full(cap, -1, np.int32)
    filled = kind > 0
    n_fill = int(filled.sum())
    uids[filled] = rng.permutation(n_fill).astype(np.int32)
    sids[filled] = rng.integers(0, n_lanes, n_fill).astype(np.int32)
    ts[kind == 1] = t_now - TAU - 1.0 - rng.random((kind == 1).sum())
    ts[kind == 2] = t_now - TAU * rng.random((kind == 2).sum())
    vecs = rng.standard_normal((cap, D)).astype(np.float32)
    vecs[~filled] = 0.0
    jstate = jwin.init_window(cap, D, n_lanes=n_lanes, eviction=eviction)
    jstate = jstate._replace(
        vecs=jnp.asarray(vecs), ts=jnp.asarray(ts), uids=jnp.asarray(uids),
        sids=jnp.asarray(sids),
        cursor=jnp.asarray(rng.integers(0, cap), jnp.int32),
    )
    if jstate.lane_cursor is not None:
        jstate = jstate._replace(lane_cursor=jnp.asarray(
            rng.integers(0, 1 << 20, n_lanes), jnp.int32))
    if summary_block_w is not None:
        from repro.kernels.sssj_join.gate import summarize_strips

        jstate = jstate._replace(summary=summarize_strips(
            jstate.vecs, jstate.ts, jstate.uids, block_w=summary_block_w,
            chunk_d=4))
    return jstate, twin.window_from_numpy(jstate, device=CPU), kind, t_now


def _batch(rng, b, n_valid, t_now, uid0=1000):
    q = rng.standard_normal((b, D)).astype(np.float32)
    tq = (t_now + 0.01 * np.arange(b)).astype(np.float32)
    uq = np.arange(uid0, uid0 + b, dtype=np.int32)
    uq[n_valid:] = -1
    sq = rng.integers(0, K, b).astype(np.int32)
    return q, tq, uq, sq


def _quotas(rng, cap):
    return jwin.quota_partition(cap, rng.random(K) + 0.25)


def _t_max(tq, n_valid):
    return float(np.max(tq[:n_valid])) if n_valid else -np.inf


def _push_both(jstate, tstate, batch, n_valid, eviction, quotas, skw=None):
    """One push through each side; the port's state is updated in place."""
    q, tq, uq, sq = batch
    skw = skw or {}
    t_max = _t_max(tq, n_valid)
    jq = None if quotas is None else jnp.asarray(quotas, jnp.int32)
    tqu = None if quotas is None else torch.tensor(quotas)
    jstate = jwin.push_with_overflow(
        jstate, jnp.asarray(q), jnp.asarray(tq), jnp.asarray(uq),
        jnp.int32(n_valid), jnp.float32(t_max), TAU, sq=jnp.asarray(sq),
        eviction=eviction, quotas=jq, **skw,
    )
    twin.push_with_overflow(
        tstate, torch.from_numpy(q), torch.from_numpy(tq), torch.from_numpy(uq),
        n_valid, torch.tensor(t_max, dtype=torch.float32), TAU,
        sq=torch.from_numpy(sq), eviction=eviction, quotas=tqu, **skw,
    )
    return jstate


def _assert_states_equal(tstate, jstate):
    got = twin.window_to_numpy(tstate)
    for name in ("vecs", "ts", "uids", "sids", "lane_cursor", "lane_overflow"):
        want = getattr(jstate, name)
        if want is None:
            assert got[name] is None, name
        else:
            np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)
    assert got["cursor"] == int(jstate.cursor)
    assert got["overflow"] == int(jstate.overflow)
    if jstate.summary is None:
        assert got["summary"] is None
        return
    for name, w in jstate.summary._asdict().items():
        g = got["summary"][name]
        if name in ("vmax", "cnorm"):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


# --------------------------------------------------------------------- #
# slot selection: unique slots, equal to the reference's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("eviction", ["oldest", "dead", "quota"])
@pytest.mark.parametrize("seed,cap,b", [(0, 16, 8), (1, 32, 32), (2, 7, 5),
                                        (3, 40, 16), (4, 9, 9)])
def test_select_write_slots_matches_reference(seed, cap, b, eviction):
    rng = np.random.default_rng(seed)
    ev = "quota" if eviction == "quota" else "oldest"
    jstate, tstate, _, t_now = _random_states(rng, cap, eviction=ev)
    n_valid = int(rng.integers(0, min(b, cap) + 1))
    _, _, _, sq = _batch(rng, b, n_valid, t_now)
    quotas = _quotas(rng, cap) if eviction == "quota" else None
    t_max = t_now + 0.01 * b
    want = jwin.select_write_slots(
        jstate, b, jnp.int32(n_valid), jnp.float32(t_max), TAU, sq=jnp.asarray(sq),
        eviction=eviction,
        quotas=None if quotas is None else jnp.asarray(quotas, jnp.int32),
    )
    got = twin.select_write_slots(
        tstate, b, n_valid, torch.tensor(t_max, dtype=torch.float32), TAU,
        sq=torch.from_numpy(sq), eviction=eviction,
        quotas=None if quotas is None else torch.tensor(quotas),
    )
    dest, cursor, lane_cursor, self_evicted = got
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want[0]))
    assert int(cursor) == int(want[1])
    if want[2] is None:
        assert lane_cursor is None
    else:
        np.testing.assert_array_equal(lane_cursor.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(self_evicted.numpy(), np.asarray(want[3]))
    # no two rows share a slot; each valid row writes or is self-evicted
    d = dest.numpy()
    written = d[d < cap]
    assert written.size == np.unique(written).size
    se = self_evicted.numpy()
    assert ((d < cap) | se)[:n_valid].all()
    assert (d[n_valid:] == cap).all() and not se[n_valid:].any()


# --------------------------------------------------------------------- #
# pushes: every leaf bit-equal through several micro-batches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("eviction", ["oldest", "dead", "quota"])
@pytest.mark.parametrize("seed,cap,b,summary", [
    (0, 16, 8, False), (1, 24, 16, True), (2, 12, 12, True), (3, 40, 8, True),
])
def test_push_matches_reference(seed, cap, b, summary, eviction):
    """Pushes with padding, random streams and time jumps past the
    horizon, so live, dead and self-evicted rows all occur."""
    rng = np.random.default_rng(100 + seed)
    ev = "quota" if eviction == "quota" else "oldest"
    bw = 4 if summary else None
    jstate, tstate, _, t_now = _random_states(rng, cap, eviction=ev,
                                              summary_block_w=bw)
    skw = dict(summary_block_w=bw, summary_chunk_d=4) if summary else {}
    quotas = _quotas(rng, cap) if eviction == "quota" else None
    _assert_states_equal(tstate, jstate)
    uid0 = 1000
    for step in range(6):
        n_valid = int(rng.integers(0, b + 1)) if step % 2 else b
        batch = _batch(rng, b, n_valid, t_now, uid0=uid0)
        jstate = _push_both(jstate, tstate, batch, n_valid, eviction, quotas, skw)
        _assert_states_equal(tstate, jstate)
        uid0 += b
        t_now += 3.0 * TAU if step == 2 else 0.3
    if eviction != "dead":        # dead slots spare the live ones on the widest ring
        assert int(jstate.overflow) > 0       # live overwrites were counted


# --------------------------------------------------------------------- #
# split invariance: one push against the same rows split in two
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("eviction", ["oldest", "dead", "quota"])
@pytest.mark.parametrize("seed,cap,b", [(0, 16, 8), (1, 32, 20), (2, 9, 9),
                                        (3, 24, 1)])
def test_split_invariance(seed, cap, b, eviction):
    rng = np.random.default_rng(seed)
    ev = "quota" if eviction == "quota" else "oldest"
    jstate, tstate, kind, t_now = _random_states(rng, cap, eviction=ev)
    if eviction == "dead":
        # the guaranteed regime: enough dead slots for the whole batch
        b = min(b, int((kind != 2).sum()))
    q, tq, uq, sq = _batch(rng, b, b, t_now)
    quotas = _quotas(rng, cap) if eviction == "quota" else None
    whole = _push_both(jstate, tstate, (q, tq, uq, sq), b, eviction, quotas)
    _assert_states_equal(tstate, whole)
    cut = int(rng.integers(0, b + 1))
    _, split, _, _ = _random_states(np.random.default_rng(seed), cap, eviction=ev)
    for lo, hi in ((0, cut), (cut, b)):
        twin.push_with_overflow(
            split, *(torch.from_numpy(x[lo:hi]) for x in (q, tq, uq)), hi - lo,
            torch.tensor(_t_max(tq[lo:hi], hi - lo), dtype=torch.float32), TAU,
            sq=torch.from_numpy(sq[lo:hi]), eviction=eviction,
            quotas=None if quotas is None else torch.tensor(quotas),
        )
    # t_max differs between the halves, which moves nothing here: every
    # slot the halves overwrite is dead or was live for both
    for name in ("vecs", "ts", "uids", "sids", "cursor", "lane_cursor"):
        a, c = getattr(split, name), getattr(tstate, name)
        assert (a is None and c is None) or torch.equal(a, c), name


# --------------------------------------------------------------------- #
# quota: sub-rings hold only their own stream, under arbitrary wrap
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,cap,rounds", [(0, 16, 6), (1, 31, 8), (2, 8, 12)])
def test_quota_conservation(seed, cap, rounds):
    rng = np.random.default_rng(seed)
    jstate = jwin.init_window(cap, D, n_lanes=K, eviction="quota")
    tstate = twin.init_window(cap, D, n_lanes=K, eviction="quota", device=CPU)
    quotas = _quotas(rng, cap)
    offs = np.concatenate([[0], np.cumsum(quotas)[:-1]])
    uid0, t = 0, 1.0
    for _ in range(rounds):
        b = int(rng.integers(1, cap + 1))
        batch = _batch(rng, b, b, t, uid0=uid0)
        jstate = _push_both(jstate, tstate, batch, b, "quota", quotas)
        _assert_states_equal(tstate, jstate)
        uid0 += b
        t += 0.5
        sids = tstate.sids.numpy()
        for k in range(K):
            lo, hi = int(offs[k]), int(offs[k]) + quotas[k]
            assert set(np.unique(sids[lo:hi])) <= {-1, k}, k
            assert not (np.concatenate([sids[:lo], sids[hi:]]) == k).any(), k
        lc = tstate.lane_cursor.numpy()
        assert (0 <= lc).all() and (lc < np.asarray(quotas)).all()


# --------------------------------------------------------------------- #
# dead-first: live overwrites only once every dead slot is used
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,cap,b", [(0, 16, 16), (1, 12, 7), (2, 6, 6),
                                        (3, 30, 30), (4, 20, 11)])
def test_dead_first_preference(seed, cap, b):
    rng = np.random.default_rng(seed)
    jstate, tstate, _, t_now = _random_states(rng, cap)
    b = min(b, cap)
    n_valid = int(rng.integers(0, b + 1))
    batch = _batch(rng, b, n_valid, t_now)
    # the push's own reference time, the newest valid arrival: a dead set
    # taken at another time can disagree with it on a slot at the horizon
    t_max = _t_max(batch[1], n_valid)
    dead = ((tstate.uids < 0) | (t_max - tstate.ts > TAU)).numpy()
    dest, _, _, _ = twin.select_write_slots(
        tstate, b, n_valid, torch.tensor(t_max, dtype=torch.float32), TAU,
        eviction="dead")
    d = dest.numpy()
    live_hits = int((~dead[d[d < cap]]).sum())
    assert live_hits == max(0, n_valid - int(dead.sum()))
    jstate = _push_both(jstate, tstate, batch, n_valid, "dead", None)
    _assert_states_equal(tstate, jstate)
    assert int(tstate.overflow) == live_hits


# --------------------------------------------------------------------- #
# quota self-eviction: a quota smaller than the micro-batch
# --------------------------------------------------------------------- #
def test_quota_self_eviction_accounted():
    """Three rows into a 2-slot sub-ring: the newest two survive, the
    first is counted as its own stream's overflow (the reference's case)."""
    jstate = jwin.init_window(6, D, n_lanes=2, eviction="quota")
    tstate = twin.init_window(6, D, n_lanes=2, eviction="quota", device=CPU)
    rng = np.random.default_rng(5)
    b = 5
    q = rng.standard_normal((b, D)).astype(np.float32)
    tq = (1.0 + 0.01 * np.arange(b)).astype(np.float32)
    uq = np.arange(b, dtype=np.int32)
    sq = np.array([0, 0, 0, 1, 1], np.int32)
    jstate = _push_both(jstate, tstate, (q, tq, uq, sq), b, "quota", (2, 4))
    _assert_states_equal(tstate, jstate)
    uids = tstate.uids.numpy()
    assert sorted(uids[:2].tolist()) == [1, 2]
    assert uids[2:4].tolist() == [3, 4] and (uids[4:] == -1).all()
    assert int(tstate.overflow) == 1
    assert tstate.lane_overflow.tolist() == [1, 0]


@pytest.mark.parametrize("seed,quotas", [(0, (3, 13, 16)), (1, (1, 2, 29)),
                                         (2, (5, 5, 22))])
def test_quota_self_eviction_wide_micro_batch(seed, quotas):
    """A 16-row micro-batch mostly of one stream whose quota is smaller
    than the micro-batch, with a strip summary, through several pushes:
    the writes that drop self-evicted rows leave every leaf equal to the
    reference's, and the losses are charged to the writer's own lane."""
    rng = np.random.default_rng(seed)
    cap, b, bw = 32, 16, 8
    skw = dict(summary_block_w=bw, summary_chunk_d=4)
    jstate = jwin.init_window(cap, D, n_lanes=K, eviction="quota",
                              summary_block_w=bw, summary_chunk_d=4)
    tstate = twin.init_window(cap, D, n_lanes=K, eviction="quota",
                              summary_block_w=bw, summary_chunk_d=4, device=CPU)
    t, uid0 = 0.0, 0
    for step in range(5):
        n_valid = b if step != 3 else 11
        q, tq, uq, _ = _batch(rng, b, n_valid, t, uid0=uid0)
        sq = np.where(rng.random(b) < 0.75, 0, rng.integers(1, K, b)).astype(np.int32)
        jstate = _push_both(jstate, tstate, (q, tq, uq, sq), n_valid, "quota",
                            quotas, skw)
        _assert_states_equal(tstate, jstate)
        t += 0.1
        uid0 += b
    lo = tstate.lane_overflow.numpy()
    assert lo[0] > 0 and lo.sum() == int(tstate.overflow)


# --------------------------------------------------------------------- #
# quota_partition
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,cap,k", [(0, 64, 3), (1, 7, 7), (2, 262144, 64),
                                        (3, 100, 9), (4, 16384, 8)])
def test_quota_partition_matches_reference(seed, cap, k):
    w = np.random.default_rng(seed).random(k) + 0.01
    got = twin.quota_partition(cap, w)
    assert got == jwin.quota_partition(cap, w)
    assert sum(got) == cap and min(got) >= 1


@pytest.mark.parametrize("cap,weights", [(2, [1.0, 1.0, 1.0]), (8, []),
                                         (8, [1.0, -1.0]), (3, [1000.0, 1.0, 1.0, 1.0])])
def test_quota_partition_rejects_what_the_reference_rejects(cap, weights):
    with pytest.raises(ValueError):
        twin.quota_partition(cap, weights)
    with pytest.raises(ValueError):
        jwin.quota_partition(cap, weights)

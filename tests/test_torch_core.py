"""The port's host joiners (``repro_torch.core``) against ``repro.core``.

The paper's MiniBatch and Streaming frameworks over the INV, AP, L2AP and
L2 indexes are host code, Python and numpy over sorted sparse vectors.
The port keeps the reference's arithmetic in the same order, so on the
same items every joiner gives the same pairs (uids, raw and decayed
scores, order) and the same ``Counters``, exactly.  Items are made with
the reference's ``synthetic_stream`` and carried across into the port's
``StreamItem``s; the port's own generator is checked to give the same
items.
"""

import math

import numpy as np
import pytest

from repro import core as jcore
from repro import obs as jobs
from repro.core import minibatch as jmb
from repro.core import postings as jpost
from repro.core import types as jtypes
from repro.data import synth as jsynth
from repro_torch import core as tcore
from repro_torch import obs as tobs
from repro_torch.core import minibatch as tmb
from repro_torch.core import postings as tpost
from repro_torch.core import similarity as tsim
from repro_torch.core import types as ttypes
from repro_torch.core.blocked import BlockedJoinConfig, BlockedStreamJoiner
from repro_torch.data import synth as tsynth

COMBOS = [
    ("MB", "INV"), ("MB", "AP"), ("MB", "L2AP"), ("MB", "L2"),
    ("STR", "INV"), ("STR", "L2AP"), ("STR", "L2"),
]
THETA_LAM = [(0.7, 0.05), (0.5, 0.2), (0.9, 0.01)]
MINI = dict(name="mini", n=250, dims=192, avg_nnz=10.0, timestamps="poisson")


def _carry(items):
    """The reference's stream items as the port's, with copied arrays."""
    return [
        ttypes.StreamItem(it.uid, it.t, ttypes.SparseVector(
            it.vec.indices.copy(), it.vec.values.copy()))
        for it in items
    ]


def _rows(pairs):
    return [(p.uid_a, p.uid_b, p.sim, p.decayed) for p in pairs]


def _run(mod, items, fw, idx, theta, lam):
    c = mod.Counters()
    pairs = mod.join_stream(mod.make_joiner(fw, idx, theta, lam, counters=c), items)
    return _rows(pairs), c.as_dict()


def _assert_same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.uid, g.t) == (w.uid, w.t)
        np.testing.assert_array_equal(g.vec.indices, w.vec.indices)
        np.testing.assert_array_equal(g.vec.values, w.vec.values)
        assert g.vec.indices.dtype == w.vec.indices.dtype
        assert g.vec.values.dtype == w.vec.values.dtype


_MINI_CACHE = {}


def _mini():
    if not _MINI_CACHE:
        ref = jsynth.synthetic_stream(jsynth.StreamSpec(**MINI), seed=3)
        _MINI_CACHE["ref"], _MINI_CACHE["port"] = ref, _carry(ref)
    return _MINI_CACHE["ref"], _MINI_CACHE["port"]


_TRUTH = {}


def _truth(theta, lam):
    if (theta, lam) not in _TRUTH:
        ref, port = _mini()
        want = _rows(jcore.brute_force_join(ref, theta, lam))
        assert _rows(tcore.brute_force_join(port, theta, lam)) == want
        _TRUTH[theta, lam] = {(min(a, b), max(a, b)) for a, b, _, _ in want}
    return _TRUTH[theta, lam]


# ---------------------------------------------------------------- types


def _sparse_inputs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    idx = rng.choice(40, size=n, replace=False)
    val = rng.standard_normal(n)
    val[rng.random(n) < 0.2] = 0.0      # make_sparse drops explicit zeros
    return idx, val


def _assert_same_vec(g, w):
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_array_equal(g.values, w.values)
    assert (g.indices.dtype, g.values.dtype) == (w.indices.dtype, w.values.dtype)


@pytest.mark.parametrize("seed", range(6))
def test_sparse_types_match_reference(seed):
    idx, val = _sparse_inputs(seed)
    g, w = ttypes.make_sparse(idx, val), jtypes.make_sparse(idx, val)
    _assert_same_vec(g, w)
    assert (g.nnz, g.max_value, g.coord_sum, g.norm) == (
        w.nnz, w.max_value, w.coord_sum, w.norm)
    _assert_same_vec(g.prefix(2), w.prefix(2))
    _assert_same_vec(g.suffix(2), w.suffix(2))
    _assert_same_vec(ttypes.unit_normalize(g), jtypes.unit_normalize(w))
    dense = ttypes.sparse_to_dense(g, 40)
    np.testing.assert_array_equal(dense, jtypes.sparse_to_dense(w, 40))
    _assert_same_vec(ttypes.sparse_from_dense(dense), jtypes.sparse_from_dense(dense))
    idx2, val2 = _sparse_inputs(seed + 100)
    g2, w2 = ttypes.make_sparse(idx2, val2), jtypes.make_sparse(idx2, val2)
    assert ttypes.sparse_dot(g, g2) == jtypes.sparse_dot(w, w2)
    assert ttypes.Pair(5, 2, 0.5, 0.4).key() == jtypes.Pair(5, 2, 0.5, 0.4).key()


def test_empty_and_mismatched_vectors_match_reference():
    for mod in (ttypes, jtypes):
        z = mod.make_sparse([], [])
        assert (z.nnz, z.max_value) == (0, 0.0)
        assert mod.unit_normalize(z) is z
        assert mod.sparse_dot(z, mod.make_sparse([1], [1.0])) == 0.0
        with pytest.raises(ValueError, match="mismatch"):
            mod.SparseVector(np.zeros(2, np.int32), np.zeros(3))


def test_as_stream_matches_reference():
    rng = np.random.default_rng(4)
    vecs = [(rng.choice(30, 4, replace=False), rng.random(4) + 0.1) for _ in range(9)]
    ts = np.cumsum(rng.exponential(1.0, 9))
    got = list(ttypes.as_stream([ttypes.make_sparse(*v) for v in vecs], ts))
    want = list(jtypes.as_stream([jtypes.make_sparse(*v) for v in vecs], ts))
    _assert_same_items(got, want)
    for mod in (ttypes, jtypes):
        vs = [mod.make_sparse([0], [1.0])] * 2
        with pytest.raises(ValueError, match="non-decreasing"):
            list(mod.as_stream(vs, [1.0, 0.5]))


def test_counters_merge_and_as_dict_match_reference():
    vals = np.random.default_rng(5).integers(0, 100, size=(2, 12))
    got, want = [], []
    for out, mod in ((got, tcore), (want, jcore)):
        a, b = mod.Counters(*vals[0].tolist()), mod.Counters(*vals[1].tolist())
        out.append(a.merge(b).as_dict())
    assert got == want
    assert list(got[0]) == list(jcore.Counters().as_dict())


# ------------------------------------------------------------- postings


def _postings_scenarios(mod):
    """The scenarios of ``tests/test_postings.py``, returning what they read."""
    out = []
    pl = mod.PostingList()
    for i in range(100):
        pl.append(i, i * 0.1, i * 0.01, float(i))
    out += [len(pl), *pl.active()]

    pl = mod.PostingList()
    for i in range(50):
        pl.append(i, 1.0, 0.0, float(i))
    out.append(pl.truncate_before_time(20.0))
    out += [*pl.active()]
    out += [pl.truncate_before_time(1e9), len(pl)]
    pl.append(99, 1.0, 0.0, 99.0)
    out += [len(pl), *pl.active(), pl.head, pl.size, pl.ids.shape[0]]

    pl = mod.PostingList()
    lens, t = [], 0.0
    for _ in range(2000):
        t += 1.0
        pl.append(int(t), 1.0, 0.0, t)
        lens.append(pl.truncate_before_time(t - 10.0))
        lens.append(len(pl))
    out += [np.array(lens), pl.head, pl.size, pl.ids.shape[0], *pl.active()]

    pl = mod.PostingList()
    for i, t in enumerate([5.0, 1.0, 9.0, 3.0, 7.0]):
        pl.append(i, float(i), 0.0, t)
    out += [pl.filter_expired_unordered(4.0), *pl.active()]

    m = mod.ItemMeta()
    for uid in range(10):
        m.add(uid, float(uid), uid + 1, 0.5)
    m.rebase(6)
    out += [*m.lookup(np.array([6, 9])), m.n]
    m.rebase(100)
    out.append(m.n)

    acc = mod.ScoreAccumulator(base=0, span=8)
    acc.score[2] = 0.5
    acc.score[3] = 0.4
    acc.killed[3] = True
    acc.touched.append(np.array([2, 3]))
    out.append(acc.candidates())
    return out


def test_postings_scenarios_match_reference():
    got, want = _postings_scenarios(tpost), _postings_scenarios(jpost)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))


# -------------------------------------------------------------- joiners


def test_synthetic_stream_copy_agrees():
    spec = MINI
    _assert_same_items(tsynth.synthetic_stream(tsynth.StreamSpec(**spec), seed=3),
                       jsynth.synthetic_stream(jsynth.StreamSpec(**spec), seed=3))
    assert {k: tuple(vars(v).values()) for k, v in tsynth.DATASET_SPECS.items()} == {
        k: tuple(vars(v).values()) for k, v in jsynth.DATASET_SPECS.items()}


@pytest.mark.parametrize("name", sorted(jsynth.DATASET_SPECS))
def test_dataset_streams_copy_agree(name):
    """Each timestamp process (poisson, sequential, bursty), cut to 300 items."""
    base = jsynth.DATASET_SPECS[name]
    kw = dict(name=base.name, n=300, dims=base.dims, avg_nnz=base.avg_nnz,
              timestamps=base.timestamps)
    got = tsynth.synthetic_stream(tsynth.StreamSpec(**kw), seed=7)
    _assert_same_items(got, jsynth.synthetic_stream(jsynth.StreamSpec(**kw), seed=7))
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(tsynth._timestamps(tsynth.StreamSpec(**kw), rng_t),
                                  jsynth._timestamps(jsynth.StreamSpec(**kw), rng_j))


@pytest.mark.parametrize("theta,lam", THETA_LAM)
@pytest.mark.parametrize("fw,idx", COMBOS)
def test_joiner_matches_reference(fw, idx, theta, lam):
    ref, port = _mini()
    got = _run(tcore, port, fw, idx, theta, lam)
    want = _run(jcore, ref, fw, idx, theta, lam)
    assert got[0] == want[0]             # uids, sim, decayed, order: exact
    assert got[1] == want[1]             # every counter
    assert {(min(a, b), max(a, b)) for a, b, _, _ in got[0]} == _truth(theta, lam)


@pytest.mark.parametrize("name", sorted(jsynth.DATASET_SPECS))
def test_dataset_characters_match_reference(name):
    base = jsynth.DATASET_SPECS[name]
    ref = jsynth.synthetic_stream(
        jsynth.StreamSpec(base.name, 200, 256, min(base.avg_nnz, 24.0), base.timestamps),
        seed=11)
    port = _carry(ref)
    theta, lam = 0.6, 0.1
    truth = {p.key() for p in jcore.brute_force_join(ref, theta, lam)}
    for fw, idx in (("STR", "L2"), ("MB", "L2AP"), ("STR", "INV")):
        got = _run(tcore, port, fw, idx, theta, lam)
        assert got == _run(jcore, ref, fw, idx, theta, lam), (fw, idx)
        assert {(min(a, b), max(a, b)) for a, b, _, _ in got[0]} == truth, (fw, idx)


@pytest.mark.parametrize("name", tcore.INDEX_NAMES)
@pytest.mark.parametrize("streaming", [False, True])
def test_make_index_matches_reference(name, streaming):
    if name == "AP" and streaming:
        for mod in (tcore, jcore):
            with pytest.raises(NotImplementedError):
                mod.make_index(name, 0.8, 0.1, streaming=True)
        return
    got = tcore.make_index(name, 0.8, 0.1, streaming=streaming)
    want = jcore.make_index(name, 0.8, 0.1, streaming=streaming)
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name
    for attr in ("use_ap", "use_l2", "streaming", "theta", "lam"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr


# ----------------------------------------------------------- MB specifics


def _mb_item(mod, uid, t, dims=8):
    rng = np.random.default_rng(uid)
    idx = rng.choice(dims, size=3, replace=False)
    return mod.StreamItem(uid, t, mod.unit_normalize(mod.make_sparse(idx, rng.random(3) + 0.1)))


def test_mb_requires_finite_horizon_like_reference():
    for mod in (tcore, jcore):
        with pytest.raises(ValueError):
            mod.make_joiner("MB", "L2", theta=0.9, lam=0.0)


@pytest.mark.parametrize("frac", [1.5, 0.5, 1.0, 2.5])
def test_apply_decay_2tau_band_matches_reference(frac):
    theta, lam = 0.8, 0.5
    tau = math.log(1 / theta) / lam
    t_of = {0: 0.0, 1: frac * tau}
    got = tmb.apply_decay([ttypes.Pair(0, 1, 1.0, 1.0)], lam, theta, t_of)
    want = jmb.apply_decay([jtypes.Pair(0, 1, 1.0, 1.0)], lam, theta, t_of)
    assert _rows(got) == _rows(want)
    assert len(got) == (frac * tau <= tau)


def test_mb_rebuild_count_matches_reference():
    theta, lam = 0.9, 1.0
    tau = math.log(1 / theta) / lam
    out = []
    for mod in (tcore, jcore):
        c = mod.Counters()
        pairs = mod.join_stream(mod.make_joiner("MB", "L2", theta, lam, counters=c),
                                [_mb_item(mod, i, i * tau * 0.9) for i in range(30)])
        out.append((_rows(pairs), c.as_dict()))
    assert out[0] == out[1]
    assert out[0][1]["index_rebuilds"] >= 10


def test_mb_cross_window_pairs_match_reference():
    theta, lam = 0.8, 0.1
    tau = math.log(1 / theta) / lam
    out = []
    for mod in (tcore, jcore):
        v = mod.unit_normalize(mod.make_sparse([0, 1, 2], [0.5, 0.5, 0.5]))
        items = [mod.StreamItem(0, 0.1, v), mod.StreamItem(1, 0.1 + tau * 0.95, v),
                 mod.StreamItem(2, 0.1 + 2.5 * tau, v)]
        out.append(_rows(mod.join_stream(mod.make_joiner("MB", "L2", theta, lam), items)))
    assert out[0] == out[1]
    keys = {(a, b) if a < b else (b, a) for a, b, _, _ in out[0]}
    assert (0, 1) in keys and (0, 2) not in keys


# --------------------------------------------------------------- errors


@pytest.mark.parametrize("args,exc", [
    (("XX", "L2"), ValueError),
    (("MB", "NOPE"), ValueError),
    (("STR", "NOPE"), ValueError),
    (("STR", "AP"), NotImplementedError),
], ids=["framework", "mb-index", "str-index", "str-ap"])
def test_errors_match_reference(args, exc):
    msgs = []
    for mod in (tcore, jcore):
        with pytest.raises(exc) as info:
            j = mod.make_joiner(*args, theta=0.8, lam=0.1)
            mod.join_stream(j, [mod.StreamItem(0, 0.0, mod.make_sparse([0], [1.0]))])
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------- tie


def _tie_items(mod):
    """Item 0 is e0 and item 2 is (e0+e1+e2+e3)/2, all at t = 0: their
    decayed similarity is 0.5 exactly.  Item 1, (2·e1+e4)/√5, moves the
    AP max-vector so that the AP-family bound has no slack at the tie."""
    v = [mod.unit_normalize(mod.make_sparse(i, x))
         for i, x in (([0], [1.0]), ([1, 4], [2.0, 1.0]), ([0, 1, 2, 3], [1.0] * 4))]
    return [mod.StreamItem(u, 0.0, v[u]) for u in range(3)]


@pytest.mark.parametrize("fw,idx", COMBOS)
def test_theta_tie_pair_is_the_references(fw, idx):
    """The θ-tie: at θ = 0.5, λ = 0.02 the pair (0, 2) has decayed
    similarity equal to θ.  The AP-family joiners (STR-L2AP, MB-L2AP,
    MB-AP) drop it in the reference, a bound with no slack at equality;
    the port keeps that defect so that it stays equal to the reference
    everywhere.  The missing pair is this θ-tie, not a port fault."""
    theta, lam = 0.5, 0.02
    got = _run(tcore, _tie_items(ttypes), fw, idx, theta, lam)
    assert got == _run(jcore, _tie_items(jtypes), fw, idx, theta, lam)
    truth = _rows(tcore.brute_force_join(_tie_items(ttypes), theta, lam))
    assert truth == [(2, 0, 0.5, 0.5)]
    keys = {(min(a, b), max(a, b)) for a, b, _, _ in got[0]}
    tie_dropped = idx in ("AP", "L2AP")
    assert keys == (set() if tie_dropped else {(0, 2)}), "θ-tie pair (0, 2)"


# ------------------------------------------------------ oracles, dense


@pytest.mark.parametrize("theta,lam", [(0.8, 0.05), (0.6, 0.2)])
def test_dense_oracles_match_reference(theta, lam):
    vecs, ts = tsynth.dense_embedding_stream(180, 32, seed=5, rate=2.0)
    got = _rows(tsim.brute_force_join_dense(vecs.astype(np.float64), ts, theta, lam))
    want = _rows(jcore.similarity.brute_force_join_dense(
        vecs.astype(np.float64), ts, theta, lam))
    assert got == want and got
    planted = tsynth.planted_duplicates(vecs, ts, theta, lam)
    assert planted == jsynth.planted_duplicates(vecs, ts, theta, lam)
    assert planted == {(b, a) for a, b, _, _ in got}


def test_blocked_matches_port_core():
    """The port's dense engine and its sparse STR-L2 agree on the same
    stream (densified); the reference's ``test_blocked_matches_faithful_core``."""
    d = 48
    vecs, ts = tsynth.dense_embedding_stream(200, d, seed=3, rate=1.0, signed=False)
    theta, lam = 0.85, 0.1
    items = [ttypes.StreamItem(i, float(ts[i]), ttypes.sparse_from_dense(vecs[i]))
             for i in range(200)]
    truth = {p.key() for p in tcore.join_stream(tcore.make_joiner("STR", "L2", theta, lam),
                                                items)}
    cfg = BlockedJoinConfig(theta=theta, lam=lam, capacity=512, d=d,
                            block_q=32, block_w=32, chunk_d=16)
    bj = BlockedStreamJoiner(cfg, device="cpu")
    got = set()
    for i in range(0, 200, 50):
        for a, b, _ in bj.push(vecs[i:i + 50], ts[i:i + 50]):
            got.add((min(a, b), max(a, b)))
    assert got == truth and truth


# ------------------------------------------------------- counters bridge


def test_publish_counters_with_port_counters_matches_reference():
    ref, port = _mini()
    regs = []
    for mod, o, items in ((tcore, tobs, port), (jcore, jobs, ref)):
        c = mod.Counters()
        reg = o.MetricsRegistry()
        o.publish_counters(reg, c)
        mod.join_stream(mod.make_joiner("STR", "L2", 0.7, 0.05, counters=c), items)
        regs.append(reg)
    got, want = regs[0].snapshot(), regs[1].snapshot()
    assert got == want
    assert got["paper/pairs_emitted"] == len(_truth(0.7, 0.05))
    assert regs[0].schema() == regs[1].schema()

"""The port's oldest-first ring window against the JAX package.

Destination slots, cursor, overflow counter and the ring's contents are
held exact (integers and copied floats) through several wraps; the strip
summary ``atol=1e-6`` (sums of squares in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import window as jwin
from repro_torch.engine import EngineConfig
from repro_torch.engine import window as twin

CPU = "cpu"


def _micro_batches(rng, n_steps, b, d, tau):
    """Micro-batches with padding rows; the eighth arrives after a gap
    longer than the horizon, so wraps overwrite both live and dead
    slots."""
    uid, t = 0, 0.0
    for step in range(n_steps):
        n_valid = b if step % 4 else b - 3
        v = rng.standard_normal((b, d)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        tq = (t + 0.01 * np.arange(b)).astype(np.float32)
        uq = np.where(np.arange(b) < n_valid, uid + np.arange(b), -1).astype(np.int32)
        yield v, tq, uq, n_valid, float(tq[n_valid - 1])
        uid += n_valid
        t += 2.0 * tau if step == 7 else 0.2


def _assert_state(got: twin.WindowState, want):
    host = twin.window_to_numpy(got)
    for name in ("vecs", "ts", "uids", "sids"):
        np.testing.assert_array_equal(host[name], np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert host["cursor"] == int(want.cursor)
    assert host["overflow"] == int(want.overflow)
    if want.summary is None:
        assert host["summary"] is None
        return
    for name, w in want.summary._asdict().items():
        g = host["summary"][name]
        if name in ("vmax", "cnorm"):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize(
    "cap,b,summary",
    [(48, 16, False), (40, 16, True), (64, 32, True), (100, 32, True)],
)
def test_oldest_push_matches_reference_through_wrap(cap, b, summary):
    rng = np.random.default_rng(cap + b)
    d, bw, chunk, tau = 24, 16, 16, 1.0
    skw = dict(summary_block_w=bw if summary else None, summary_chunk_d=chunk)
    state = twin.init_window(cap, d, device=CPU, **skw)
    jstate = jwin.init_window(cap, d, **skw)
    pkw = dict(summary_block_w=bw, summary_chunk_d=chunk) if summary else {}
    for v, tq, uq, n_valid, t_max in _micro_batches(rng, 14, b, d, tau):
        jdest, jcur, _, _ = jwin.select_write_slots(
            jstate, b, n_valid, jnp.float32(t_max), tau)
        dest, cur, _, _ = twin.select_write_slots(state, b, n_valid)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
        assert int(cur) == int(jcur)
        twin.push_with_overflow(
            state, torch.from_numpy(v), torch.from_numpy(tq),
            torch.from_numpy(uq), n_valid, torch.tensor(t_max), tau, **pkw,
        )
        jstate = jwin.push_with_overflow(
            jstate, jnp.asarray(v), jnp.asarray(tq), jnp.asarray(uq),
            n_valid, jnp.float32(t_max), tau, **pkw,
        )
        _assert_state(state, jstate)
    assert int(jstate.overflow) > 0          # live overwrites were counted


@pytest.mark.parametrize("eviction", ["dead", "quota"])
def test_unported_policies_raise(eviction):
    """Both policies are ported; each raises on the inputs it lacks (the
    dead policy's horizon, the quota policy's table and cursor lane)."""
    state = twin.init_window(16, 8, eviction=eviction, device=CPU)
    with pytest.raises(ValueError):
        twin.select_write_slots(state, 8, 8, eviction=eviction)
    if eviction == "quota":
        with pytest.raises(ValueError, match="quotas table"):
            EngineConfig(theta=0.9, lam=0.1, capacity=16, d=8, micro_batch=8,
                         eviction=eviction)
    else:
        with pytest.raises(ValueError, match="quotas are only meaningful"):
            EngineConfig(theta=0.9, lam=0.1, capacity=16, d=8, micro_batch=8,
                         eviction=eviction, quotas=(16,))


def test_unknown_policy_rejected():
    with pytest.raises(ValueError):
        twin.init_window(16, 8, eviction="newest", device=CPU)


@pytest.mark.parametrize("summary", [False, True])
def test_state_round_trips_from_reference(summary):
    """A reference window (leaves as numpy arrays) becomes the port's
    window and comes back unchanged."""
    rng = np.random.default_rng(9)
    cap, d, tau = 40, 24, 1.0
    skw = dict(summary_block_w=16 if summary else None, summary_chunk_d=16)
    pkw = dict(summary_block_w=16, summary_chunk_d=16) if summary else {}
    jstate = jwin.init_window(cap, d, **skw)
    for v, tq, uq, n_valid, t_max in _micro_batches(rng, 5, 16, d, tau):
        jstate = jwin.push_with_overflow(
            jstate, jnp.asarray(v), jnp.asarray(tq), jnp.asarray(uq),
            n_valid, jnp.float32(t_max), tau, **pkw,
        )
    state = twin.window_from_numpy(jstate, device=CPU)
    _assert_state(state, jstate)
    back = twin.window_to_numpy(state)
    assert back["cursor"].dtype == np.int32 and back["vecs"].dtype == np.float32


def test_state_with_tenant_lanes_is_refused():
    """Tenant lanes are ported: a reference state with them comes back
    with its lanes as int32, and one without them without."""
    jstate = jwin.init_window(16, 8, n_lanes=2, eviction="quota")
    jstate = jstate._replace(lane_cursor=jnp.asarray([3, 1], jnp.int32),
                             lane_overflow=jnp.asarray([0, 5], jnp.int32))
    back = twin.window_to_numpy(twin.window_from_numpy(jstate, device=CPU))
    for lane in ("lane_cursor", "lane_overflow"):
        np.testing.assert_array_equal(back[lane], np.asarray(getattr(jstate, lane)))
        assert back[lane].dtype == np.int32
    plain = twin.window_to_numpy(twin.window_from_numpy(jwin.init_window(16, 8),
                                                        device=CPU))
    assert plain["lane_cursor"] is None and plain["lane_overflow"] is None

"""The port's ring-scheduled dense join (``repro_torch.core.distributed``)
on the CPU, in one process, against ``repro.core.distributed``.

The reference needs a mesh of several JAX devices, so it runs once, in a
subprocess with forced host devices (as ``tests/test_distributed.py``
runs it; this process keeps its one device), and hands its outputs back
through an ``.npz``.  The port runs ``p`` shards on ``["cpu"] * p``.
Held: each step's window and self scores within 1e-5 (no entry lies
within 1e-5 of θ, which the test checks), and the window leaves after
each step exactly.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.data.synth import planted_duplicates
from repro_torch.core.blocked import BlockedJoinConfig
from repro_torch.core.distributed import (
    DistributedJoinConfig,
    init_sharded_window,
    make_distributed_join_step,
)
from repro_torch.data import dense_embedding_stream
from repro_torch.kernels.sssj_join import sssj_join_tiles
from repro_torch.launch import Mesh, make_mesh_for

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
THETA, LAM, D, CAP, BL = 0.8, 0.05, 64, 64, 32    # BL rows per shard per step
SHARDS = (2, 4)
STEPS = 5                       # each shard's 64-slot ring wraps after 2
LEAVES = ("vecs", "ts", "uids", "cursor", "overflow")

_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.blocked import BlockedJoinConfig
    from repro.core.distributed import (
        DistributedJoinConfig, init_sharded_window, make_distributed_join_step)
    src = np.load(sys.argv[1])
    out = {}
    for p in (2, 4):
        mesh = jax.make_mesh((p,), ("data",))
        cfg = DistributedJoinConfig(base=BlockedJoinConfig(
            theta=float(src["theta"]), lam=float(src["lam"]),
            capacity=int(src["cap"]), d=int(src["d"]),
            block_q=32, block_w=32, chunk_d=32))
        step = make_distributed_join_step(cfg, mesh)
        state = init_sharded_window(cfg, mesh)
        b = p * int(src["bl"])
        for s in range(int(src["steps"])):
            lo = s * b
            state, (s_win, s_self) = step(
                state, jnp.asarray(src["vecs"][lo:lo + b]),
                jnp.asarray(src["ts"][lo:lo + b], jnp.float32),
                jnp.arange(lo, lo + b, dtype=jnp.int32))
            out[f"{p}/{s}/win"] = np.asarray(s_win)
            out[f"{p}/{s}/self"] = np.asarray(s_self)
            for k in ("vecs", "ts", "uids", "cursor", "overflow"):
                out[f"{p}/{s}/{k}"] = np.asarray(getattr(state, k))
    np.savez(sys.argv[2], **out)
""")


def _stream():
    return dense_embedding_stream(max(SHARDS) * BL * STEPS, D, seed=5, rate=2.0,
                                  dup_frac=0.3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-step outputs for every shard count."""
    tmp = tmp_path_factory.mktemp("ring")
    vecs, ts = _stream()
    np.savez(tmp / "in.npz", vecs=vecs, ts=ts, theta=THETA, lam=LAM, cap=CAP, d=D,
             bl=BL, steps=STEPS)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(tmp / "out.npz") as f:
        return dict(f)


def _config(use_ref=False, cap=CAP):
    return DistributedJoinConfig(base=BlockedJoinConfig(
        theta=THETA, lam=LAM, capacity=cap, d=D, block_q=32, block_w=32,
        chunk_d=32, use_ref=use_ref))


def _mesh(p):
    return make_mesh_for((p,), ("data",), devices=[CPU] * p)


@pytest.mark.parametrize("use_ref", [False, True], ids=["kernel", "use_ref"])
@pytest.mark.parametrize("p", SHARDS)
def test_ring_join_matches_reference(reference, p, use_ref):
    vecs, ts = _stream()
    cfg = _config(use_ref)
    step = make_distributed_join_step(cfg, _mesh(p))
    state = init_sharded_window(cfg, _mesh(p))
    b = p * BL
    n_pairs = 0
    for s in range(STEPS):
        lo = s * b
        state, (s_win, s_self) = step(state, vecs[lo:lo + b], ts[lo:lo + b],
                                      np.arange(lo, lo + b, dtype=np.int32))
        for name, got in (("win", s_win), ("self", s_self)):
            want = reference[f"{p}/{s}/{name}"]
            assert got.shape == want.shape
            # no entry within 1e-5 of θ: the thresholded zeros agree
            assert not (np.abs(want - THETA) <= 1e-5).any()
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                       err_msg=f"step {s} {name}")
            n_pairs += int((want > 0).sum())
        leaves = state.to_numpy()
        for k in LEAVES:
            np.testing.assert_array_equal(leaves[k], reference[f"{p}/{s}/{k}"],
                                          err_msg=f"step {s} {k}")
    assert n_pairs


@pytest.mark.parametrize("p", [1, 4, 8])
def test_ring_join_finds_planted_pairs(p):
    """The reference's ``test_distributed_ring_join_exact`` on the port:
    window and self scores together give the planted pair set."""
    vecs, ts = dense_embedding_stream(256, D, seed=3, rate=2.0)
    truth = planted_duplicates(vecs, ts, THETA, LAM)
    cfg = _config(cap=128 // p)
    step = make_distributed_join_step(cfg, _mesh(p))
    state = init_sharded_window(cfg, _mesh(p))
    got = set()
    for lo in range(0, 256, 64):
        w_uids = state.to_numpy()["uids"]
        state, (s_win, s_self) = step(state, vecs[lo:lo + 64], ts[lo:lo + 64],
                                      np.arange(lo, lo + 64, dtype=np.int32))
        for a, b in zip(*np.nonzero(s_win.numpy())):
            got.add((int(w_uids[b]), lo + int(a)))
        for a, b in zip(*np.nonzero(s_self.numpy())):
            got.add((lo + int(b), lo + int(a)))
    assert got == truth and truth


def test_ring_join_equals_one_dense_join_over_the_window():
    """Each step's ring scores are the single-device dense join of the
    batch against the concatenated window (column block c = shard c)."""
    p = 4
    vecs, ts = _stream()
    cfg = _config()
    step = make_distributed_join_step(cfg, _mesh(p))
    state = init_sharded_window(cfg, _mesh(p))
    kw = dict(theta=THETA, lam=LAM, block_q=32, block_w=32, chunk_d=32, device=CPU)
    b = p * BL
    for s in range(STEPS):
        lo = s * b
        q, tq = vecs[lo:lo + b], ts[lo:lo + b]
        uq = np.arange(lo, lo + b, dtype=np.int32)
        w = state.to_numpy()
        want_win, _, _ = sssj_join_tiles(q, w["vecs"], tq, w["ts"], uq, w["uids"], **kw)
        want_self, _, _ = sssj_join_tiles(q, q, tq, tq, uq, uq, **kw)
        state, (s_win, s_self) = step(state, q, tq, uq)
        torch.testing.assert_close(s_win, want_win, rtol=0, atol=1e-5)
        torch.testing.assert_close(s_self, want_self, rtol=0, atol=1e-5)


def test_ring_join_refuses_an_uneven_batch():
    step = make_distributed_join_step(_config(), _mesh(4))
    state = init_sharded_window(_config(), _mesh(4))
    x = np.zeros((6, D), np.float32)
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        step(state, x, np.zeros(6, np.float32), np.arange(6, dtype=np.int32))


def test_ring_join_refuses_sub_tile_joins_on_cuda():
    """On a CUDA mesh (named, not touched) a join smaller than one tile is
    refused, at build or at the step, before any tensor moves: the dense
    kernel's wrapper would run it as the dense reference.  A CPU mesh runs
    such shapes through the plain version, as the other tests do."""
    mesh = Mesh(np.array([torch.device("cuda", 0)] * 4, dtype=object), ("data",))
    with pytest.raises(ValueError, match="smaller than one"):
        make_distributed_join_step(_config(cap=16), mesh)      # capacity < block_w
    with pytest.raises(ValueError, match="smaller than one"):
        make_distributed_join_step(DistributedJoinConfig(base=BlockedJoinConfig(
            theta=THETA, lam=LAM, capacity=CAP, d=16, block_q=32, block_w=32,
            chunk_d=32)), mesh)                                   # d < chunk_d
    step = make_distributed_join_step(_config(), mesh)
    x = np.zeros((64, D), np.float32)                            # 16 rows a shard
    with pytest.raises(ValueError, match="smaller than one"):
        step(None, x, np.zeros(64, np.float32), np.arange(64, dtype=np.int32))
    make_distributed_join_step(_config(cap=16, use_ref=True), mesh)

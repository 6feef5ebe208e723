"""Boundaries of the PyTorch port.

* The port (``src/repro_torch``), ``chip_smoke.py`` and ``chip_turns.py``
  import neither ``jax`` nor anything of ``repro``: checked in a fresh
  interpreter and by a static scan.
* Entry points default to CUDA and raise without a GPU instead of
  carrying on on the CPU; a kernel wrapper refuses a device it has no
  kernel for; ``chip_smoke.py`` fails without a GPU and alone.
* The modules the port copied from ``repro`` still agree with their
  originals on the same inputs (exact: the same numpy code).
"""

import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.similarity import time_horizon as j_time_horizon
from repro.data import synth as jsynth
from repro.engine.window import quota_partition as j_quota_partition
from repro.obs import MetricsRegistry as JRegistry
from repro.runtime import RequestRouter as JRouter
from repro_torch.core.blocked import BlockedJoinConfig, BlockedStreamJoiner
from repro_torch.configs import ARCHS
from repro_torch.core.similarity import time_horizon
from repro_torch.data import DedupFilter
from repro_torch.data import synth as tsynth
from repro_torch.engine import EngineConfig, StreamEngine
from repro_torch.engine.window import quota_partition
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as tflash
from repro_torch.kernels.sssj_join import gate as tgate
from repro_torch.kernels.sssj_join import kernel as tkernel
from repro_torch.kernels.sssj_join import ops as tops
from repro_torch.obs import MetricsRegistry
from repro_torch.launch.serve import run_service
from repro_torch.runtime import MultiTenantRuntime, RequestRouter, TenantTable
from repro_torch.serving import LMEmbedder, MultiTenantSSSJService, SSSJService

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_ROOT, "src", "repro_torch")
_SMOKE = os.path.join(_ROOT, "chip_smoke.py")
_TURNS = os.path.join(_ROOT, "chip_turns.py")
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro\b(?!_torch))",
    re.MULTILINE,
)


def _port_sources():
    out = [_SMOKE, _TURNS]
    for dirpath, _, files in os.walk(_PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.obs, repro_torch.data\n"
        "import repro_torch.kernels.sssj_join, repro_torch.kernels._build\n"
        "import repro_torch.kernels, repro_torch.kernels.flash_attention\n"
        "import repro_torch.engine, repro_torch.serving, repro_torch.core.blocked\n"
        "import repro_torch.data.pipeline, repro_torch.obs.spans, repro_torch.obs.bridge\n"
        "import repro_torch.runtime, repro_torch.runtime.runtime\n"
        "import repro_torch.runtime.router, repro_torch.runtime.tenants\n"
        "import repro_torch.engine.sharded, repro_torch.core.distributed\n"
        "import repro_torch.launch, repro_torch.launch.mesh\n"
        "import repro_torch.distributed, repro_torch.distributed.sharding\n"
        "import repro_torch.configs, repro_torch.configs.base, repro_torch.models\n"
        "import repro_torch.models.common, repro_torch.models.mlp\n"
        "import repro_torch.models.attention, repro_torch.models.lm\n"
        "import repro_torch.models.convert, repro_torch.serving.embedder\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, _ROOT)
)
def test_no_jax_or_repro_import_statement(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), path


def test_port_sources_found():
    names = {os.path.basename(p) for p in _port_sources()}
    assert {"engine.py", "window.py", "kernel.py", "gate.py", "ops.py",
            "chip_smoke.py", "chip_turns.py", "service.py", "blocked.py",
            "pipeline.py", "spans.py", "bridge.py", "registry.py", "runtime.py",
            "tenants.py", "router.py", "synth.py", "sharded.py", "distributed.py",
            "mesh.py", "sharding.py", "base.py", "qwen3_0_6b.py", "common.py",
            "mlp.py", "attention.py", "lm.py", "convert.py", "embedder.py",
            "serve.py"} <= names


_HOST_CORE = ("types", "counters", "similarity", "postings", "index_inv",
              "index_l2", "minibatch", "streaming")


def test_host_joiners_import_neither_jax_nor_repro():
    """The paper's host joiners and the Table-1 stream generator, alone in
    a fresh interpreter."""
    mods = ", ".join(f"repro_torch.core.{m}" for m in _HOST_CORE)
    code = (
        "import sys\n"
        f"import {mods}\n"
        "import repro_torch.data.synth\n"
        "from repro_torch.core import make_index, make_joiner, join_stream\n"
        "from repro_torch.data import (StreamSpec, DATASET_SPECS,\n"
        "    synthetic_stream, planted_duplicates)\n"
        "items = synthetic_stream(StreamSpec('s', 40, 64, 6.0, 'bursty'), seed=1)\n"
        "join_stream(make_joiner('STR', 'L2', 0.7, 0.1), items)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name", _HOST_CORE)
def test_host_joiner_module_exists(name):
    path = os.path.join(_PORT, "core", f"{name}.py")
    assert os.path.isfile(path), path
    assert path in _port_sources()


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    cfg = EngineConfig(theta=0.9, lam=0.1, capacity=64, d=8, micro_batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(cfg)
    StreamEngine(cfg, device="cpu").close()    # the explicit CPU path works


@pytest.mark.parametrize("make", [
    lambda: SSSJService(theta=0.9, lam=0.1, dim=8, capacity=64, block=8),
    lambda: BlockedStreamJoiner(BlockedJoinConfig(theta=0.9, lam=0.1, capacity=64,
                                                  d=8, block_q=8, block_w=8)),
    lambda: DedupFilter(dim=8, capacity=64, block=8),
    lambda: MultiTenantRuntime(EngineConfig(theta=0.9, lam=0.1, capacity=64, d=8,
                                            micro_batch=8),
                               TenantTable.uniform(2, 0.9, 0.1)),
    lambda: MultiTenantSSSJService(TenantTable.uniform(2, 0.9, 0.1), dim=8,
                                   capacity=64, micro_batch=8),
    lambda: LMEmbedder(ARCHS["qwen3-0.6b"].reduced()),
    lambda: run_service("qwen3-0.6b", requests=1, verbose=False),
], ids=["SSSJService", "BlockedStreamJoiner", "DedupFilter", "MultiTenantRuntime",
        "MultiTenantSSSJService", "LMEmbedder", "run_service"])
def test_consumers_default_to_cuda_and_raise_without_gpu(monkeypatch, make):
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_join_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    x = np.zeros((4, 8), np.float32)
    t = np.zeros(4, np.float32)
    u = np.arange(4, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.sssj_join_candidates(x, x, t, t, u, u, theta=0.9, lam=0.1)


def test_gate_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    s = tgate.init_strip_summary(64, 8, block_w=16, chunk_d=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgate.strip_gate(np.zeros((16, 8), np.float32), s, block_q=16,
                         chunk_d=8, tq_lo=0.0, tq_hi=1.0, th_min=0.9,
                         lam_min=0.1)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA gets no fallback."""
    m = dict(device="meta")
    q = torch.empty((128, 128), **m)
    lane = torch.empty((128, 1), **m)
    with pytest.raises(ValueError, match="no tile-join kernel"):
        tkernel.sssj_join_candidates_kernel_call(
            q, q, lane, lane, lane, lane, torch.empty((128, 1), **m),
            torch.empty((128, 1), **m), theta=0.9, lam=0.1, block_q=128,
            block_w=128, chunk_d=128, tile_k=8,
        )
    with pytest.raises(ValueError, match="no gate kernel"):
        tgate.gate_ub(q, lane, q, lane, block_q=128)
    assert tkernel.sssj_join_candidates_kernel_call.launches == 0
    assert tgate.gate_ub.launches == 0


def test_flash_wrapper_refuses_devices_without_a_kernel():
    """Beside the join wrappers: a meta tensor gets no plain fallback."""
    m = dict(device="meta")
    q = torch.empty((1, 4, 64, 64), **m)
    kv = torch.empty((1, 2, 64, 64), **m)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        tflash.flash_attention_kernel_call(q, kv, kv, sm_scale=0.125, causal=True,
                                           block_q=64, block_k=64)
    assert tflash.flash_attention_kernel_call.launches == 0


def test_every_kernel_source_is_built():
    """Each ``csrc/*.cu`` is one library of ``_build.SOURCES``."""
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert "flash_attn" in _build.SOURCES


def _run_smoke(cwd, script):
    # no card visible to the child, whatever machine runs the test
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                          text=True, env=env, timeout=120)


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(_ROOT, _SMOKE)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Alone in a directory it fails even before looking for a card."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(_SMOKE, alone)
    res = _run_smoke(str(tmp_path), str(alone))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_turns_needs_two_checkouts():
    """Without its two checkout roots it prints its usage and times nothing."""
    res = subprocess.run([sys.executable, _TURNS], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 2
    assert "A_ROOT B_ROOT" in res.stderr and res.stdout == ""


@pytest.mark.parametrize("theta,lam", [(0.9, 1e-3), (0.5, 0.2), (1.0, 0.5), (0.8, 0.0)])
def test_time_horizon_copy_agrees(theta, lam):
    got, want = time_horizon(theta, lam), j_time_horizon(theta, lam)
    assert got == want or (math.isinf(got) and math.isinf(want))


@pytest.mark.parametrize("kw", [dict(), dict(signed=False, dup_frac=0.5)])
def test_dense_embedding_stream_copy_agrees(kw):
    for got, want in zip(tsynth.dense_embedding_stream(200, 24, seed=3, **kw),
                         jsynth.dense_embedding_stream(200, 24, seed=3, **kw)):
        np.testing.assert_array_equal(got, want)


def test_topic_drift_stream_copy_agrees():
    for got, want in zip(tsynth.topic_drift_stream(300, 32, seg=50, seed=2),
                         jsynth.topic_drift_stream(300, 32, seg=50, seed=2)):
        np.testing.assert_array_equal(got, want)


def test_registry_copy_agrees():
    def publish(reg):
        reg.counter("engine/n_items").set(7)
        reg.counter("engine/pairs_emitted").inc(3)
        reg.gauge("engine/ratio").set(0.25)

    got, want = MetricsRegistry(), JRegistry()
    for reg in (got, want):
        reg.register_collector(publish)
    assert got.snapshot() == want.snapshot()
    assert got.schema() == want.schema()
    with pytest.raises(TypeError):
        got.gauge("engine/n_items")


@pytest.mark.parametrize("kw", [dict(), dict(seed=3, repost_gap=60.0, dup_noise=0.05)])
def test_bursty_tenant_traffic_copy_agrees(kw):
    got, want = (mod.bursty_tenant_traffic(3, 4, 9, 16, **kw) for mod in (tsynth, jsynth))
    assert len(got[0]) == len(want[0])
    for (gk, gv, gt), (wk, wv, wt) in zip(got[0], want[0]):
        assert gk == wk
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gt, wt)
    for (gv, gt), (wv, wt) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gt, wt)


@pytest.mark.parametrize("cap,seed,k", [(64, 0, 3), (262144, 1, 64), (16384, 2, 8)])
def test_quota_partition_copy_agrees(cap, seed, k):
    w = np.random.default_rng(seed).random(k) + 0.1
    assert quota_partition(cap, w) == j_quota_partition(cap, w)


def test_router_copy_agrees():
    """The same admits and takes through both routers give the same rows,
    stream ids, queue depths and counters, and the same backpressure."""
    rng = np.random.default_rng(0)
    got, want = RequestRouter(3, 20), JRouter(3, 20)
    uid = 0
    for _ in range(60):
        if len(want) and rng.random() < 0.4:
            n = int(rng.integers(1, len(want) + 1))
            g, w = got.take(n), want.take(n)
            for a, b in zip(g[:4], w[:4]):
                np.testing.assert_array_equal(a, b)
            assert g[4].shape == w[4].shape and g[4].dtype == w[4].dtype
        else:
            b = int(rng.integers(1, 9))
            args = (int(rng.integers(0, 3)), np.zeros((b, 2), np.float32),
                    np.zeros(b), np.arange(uid, uid + b, dtype=np.int32))
            raised = []
            for r in (got, want):
                try:
                    r.admit(*args)
                    raised.append(None)
                except RuntimeError as exc:
                    raised.append(str(exc))
            assert raised[0] == raised[1]
            uid += b
        assert got.queued_by_tenant == want.queued_by_tenant
        assert (got.telemetry.items_admitted, got.telemetry.items_rejected,
                got.telemetry.items_dispatched) == (
            want.telemetry.items_admitted, want.telemetry.items_rejected,
            want.telemetry.items_dispatched)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line (the engine runs of phases 2-4 come before phase 2's
kernel timings, see ``main``):

1. device: the card's name and power limit (``nvidia-smi``), then the
   kernels built from ``src/repro_torch/kernels/csrc`` by ``nvcc``;
2. every kernel against its plain PyTorch version, on the card, at the
   shapes its path gives it (integers exact, floats within ``FLOAT_TOL``
   outside a ``BAND`` around θ, which is reported), each timed twice:
   through its wrapper with CUDA events (``ms``, what a caller pays) and
   on the device alone (``device_ms``, see :func:`device_ms`), its plain
   version too (``plain_ms``, ``plain_device_ms``); the gate bound also
   with the chunk norms scaled up so that its prefix product decides;
   the tile joins also with every tile dead and with every tile live;
   the join and gate kernels again at the tile edges (64, 64), (32, 128),
   (128, 48), (256, 256) and (192, 320), and the engine at the consumers'
   64 x 64 and 256 x 256 tiles against its dense oracle;
3. the main path: ``StreamEngine`` at ``capacity=262144, d=1024`` over a
   near-duplicate stream long enough to wrap the ring, with the kernels'
   launch counters read around the run, held against the same stream
   through ``join_impl="dense"`` on the card;
4. the dense-emission path: the same engine and stream with
   ``emit_dense=True`` (the dense tile-join kernel and the row-major
   compaction), held against both runs of phase 3; then, on phase 3's
   stream, each held against a ``join_impl="dense"`` engine on the card
   with its launches read around its own run:
   a. the scan route, ``join_impl="scan"`` (the gate kernel, then batched
      products over the strips its walk visits), also against the kernel
      route's gate counters, timed beside both routes;
   b. ``SSSJService(block=64)`` in strict mode (``tile_k`` 4,096) on the
      first 66 requests of 4,096 (the ring wraps): pairs, duplicate
      groups, snapshot and
      Prometheus text; its candidate buffers' bytes and merge time;
   c. ``BlockedStreamJoiner`` at 128 x 128 tiles (``tile_k`` 16,384);
   d. ``TokenPipeline`` with ``DedupFilter(dim=1024, capacity=65536,
      block=64)`` for ``PIPELINE_STEPS`` steps, until its ring wraps, its
      keep-masks against the same pipeline's whose filter runs
      ``join_impl="dense"`` (equal outside documents whose exact best
      score lies within ``BAND`` of θ);
   e. ``MultiTenantRuntime`` at ``capacity=131072, d=1024`` with 64
      tenants (a non-uniform (θ, λ) table, quota eviction, tenants 0 and 6
      identical streams), each tenant's pairs, masks and overflow against
      a ``join_impl="dense"`` runtime, then the kernel route under
      ``dead`` and ``oldest`` eviction against the quota run;
      admission→emission latency;
   f. quota isolation at d 1024: a bursty tenant beside 7 slow ones,
      slow tenants' pairs equal to the exact truth under ``quota`` and
      lost under ``oldest``;
   g. ``MultiTenantSSSJService(micro_batch=256)`` (256 x 256 tiles, so
      ``cand_big_kernel``), its groups against a dense-oracle runtime's
      and its snapshot's names against ``tests/metrics_schema.json``;
   h. ``ShardedStreamEngine``: four shards of 65,536 slots (phase 3's
      window) on a single-process mesh over the visible cards, on the
      first ``SHARD_REQUESTS`` (20 of 80) requests of phase 3's stream,
      its pairs and masks against the same prefix of phase 3's kernel
      route, and its rings' counts summed against the prefix's (81,920
      items: no ring wraps);
   i. the ring dense join (``make_distributed_join_step``) over the same
      four shards with a global batch of 512: 512 steps fill the rings,
      then 4 steps' window and self scores against ``use_ref`` and the
      one-device dense join over the concatenated window;
   j. ``MultiTenantSSSJService(mesh=...)`` with the four shards under
      ``oldest`` eviction on a prefix of 4e's stream, its groups against
      a dense-oracle runtime on the mesh and the single-device service;
   k. the system end to end at qwen3-0.6b's full width (28 layers, d
      1,024, random f32 weights drawn on the card): ``launch.serve``'s
      token stream (72 requests of 128 documents x 64 tokens) through the
      port's ``LMEmbedder`` into ``SSSJService(theta=0.85, lam=0.05,
      dim=1024, capacity=8192, block=128)``, its pairs, groups and trends
      against the same service on ``join_impl="dense"`` fed the same
      embeddings, 4 documents re-embedded on the CPU;
   l. 8 documents of 2,048 tokens through the LM, so that every layer's
      attention runs ``flash_attn.cu``; layer 0's flash route against
      ``chunked_causal_attention`` on the card;
   m. ``MultiTenantSSSJService(fused=FusedEmbedder(...))`` over 8
      tenants and 1,024 documents against the same service fed host
      embeddings;
   n. the gate's bits held exactly: ``topic_drift_stream`` (32,768
      items, d 1,024) into ``StreamEngine(theta=0.9, lam=1e-3,
      capacity=16384)``, one micro-batch a request; before each push
      ``strip_gate`` on the card (``gate_ub``) and on CPU copies
      (``gate_ub_plain``), bits and prune stats equal but for counted
      bits within ``FLOAT_TOL`` of θ; value bounds must skip tiles, and
      the pairs must be a ``join_impl="dense"`` engine's;
   o. the paper's joiners: the four Table-1 streams (``DATASET_SPECS``
      at their synthetic sizes, θ 0.5, λ 0.01) through the port's STR-L2
      on the host, in a spawned pool, and densified through the engine
      on the kernel route (timed once the pool has finished) with a
      ring that holds each whole stream: pair
      sets equal outside the ε-band, scores within ``FLOAT_TOL``,
      nothing dropped or overwritten, the host's ``Counters`` under
      ``paper/*`` in the engine's snapshot;
   p. olmoe-1b-7b at full width (16 layers, d 2,048, 64 experts top-8,
      random f32 weights drawn on the card after qwen3-0.6b's are freed):
      ``launch.serve``'s token stream (16 requests of 128 x 64 tokens,
      capacity dispatch) into ``SSSJService(theta=0.85, lam=0.05,
      dim=2048, capacity=8192, block=128)``, its pairs, groups and trends
      against the same service on ``join_impl="dense"`` fed the same
      embeddings; layer 0's MoE on the card against a CPU run of the
      port's ``moe`` on the same hidden states (expert indices and keep
      masks equal outside counted near-ties, outputs within
      ``MOE_RTOL``); planted copies found;
   q. 8 olmoe documents of 2,048 tokens, so that all 16 layers run
      ``flash_attn.cu`` at the MHA shape (H 16, Hkv 16); layer 0's flash
      route against ``chunked_causal_attention`` on the card;
   r. olmoe decode: caches of 4 x 512 primed by a dropless prefill of
      448 tokens, then 64 ``lm_decode_step``s, each step's logits
      against the cache-less dropless forward over the 512 tokens within
      ``DECODE_RTOL`` of its largest logit, argmax equal where decided;
   s. xlstm-350m at full width (24 layers: 3 units of 7 mLSTM blocks and
      an sLSTM block, d 1,024, 4 heads, random f32 weights drawn on the
      card after olmoe's are freed): 4k's serve path and checks on 16
      requests of 128 x 64 tokens, planted copies found, device launches
      a forward and an sLSTM step;
   t. 8 xlstm documents of 2,048 tokens (mLSTM chunks of 256, 2,048 sLSTM
      host steps a block); layer 0's mLSTM block and unit 0's sLSTM block
      on the card against the CPU, and the mLSTM block fed 256 tokens one
      at a time through its cache against its chunk form, within
      ``XLSTM_RTOL`` of the largest |value|;
   u. xlstm decode: 4r's protocol on the recurrent caches (prefill chunks
      of 64, the full forward's of 256, a step one token);
   v. zamba2-2.7b at full width (54 Mamba2 layers in 9 units of 6, each
      unit followed by the one shared attention+MLP block; d 2,560,
      random f32 weights drawn on the card after xlstm's are freed): 4k's
      serve path and checks on 16 requests of 128 x 64 tokens into
      ``SSSJService(dim=2560)``, planted copies found, device launches a
      forward, the one-ulp probe beside the CPU check;
   w. 8 zamba documents of 2,048 tokens (SSD chunks of 256), the shared
      block's 9 invocations on ``flash_attn.cu`` (Dh 80 padded to 128);
      unit 0's first Mamba2 layer on the card against the CPU, and the
      shared block's flash route against ``chunked_causal_attention``;
   x. zamba decode: caches of 4 x 256 primed by one prefill of 192
      tokens, 64 steps against the cache-less forward over 256;
5. flash attention through ``repro_torch.kernels.flash_attention`` at
   the head geometry of qwen3-0.6b (H 16, Hkv 8, Dh 128, S 4096) and
   qwen2.5-3b (H 16, Hkv 2, S 2048) in f32 and bf16, with a ragged S, a
   padded head dim, head dims above 256 (run in column slices) and a
   non-causal case, each output held against
   ``flash_attention_plain`` on the card, timed beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   with the kernel route each head dim takes.
   Phases 2 and 5 run last, in a child process (``--kernel-phases``)
   whose ``torch.profiler`` no engine phase has used;
6. the ``kernels`` line: launches, error, times (``ms`` and
   ``device_ms``, the plain version's and the library call's beside) and
   bound of each kernel, the launches counted over the run of its own
   path (flash attention's: phase 4l's), and over each path of phases
   3-4x (``launches_by_path``), after a line with the script's total
   seconds;
7. ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of the JAX package, and exits non-zero without a result
when there is no GPU or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
FLOAT_TOL = 1e-5       # scores and bounds: f32 sums in another order
BAND = 1e-5            # pairs this close to θ may differ between runs
# H100 SXM peaks at its 700 W limit: HBM bytes/s, f32 FLOP/s outside the
# tensor cores, and dense TF32 on them (the tile joins form their f32 dot
# products as three TF32 products, 3xTF32)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor cores: the least time of bf16 work

# the main path's configuration: the near-duplicate service's traffic
THETA, LAM = 0.9, 1e-3
CAPACITY, D, MICRO = 262144, 1024, 128
REQUEST, RATE = 4096, 1000.0
N_ITEMS = CAPACITY + 65536
# the tile edges the kernels take besides 128 x 128: the consumers' 64 x 64
# (SSSJService, DedupFilter), unequal edges, an edge no compiled tile has
# (48 runs in the 64-wide one), and edges above 128, run in 128-wide
# sub-tiles (MultiTenantSSSJService(micro_batch=256)'s 256 x 256; 192 x 320
# ragged in both)
TILE_EDGES = ((64, 64), (32, 128), (128, 48), (256, 256), (192, 320))
# the engine at the consumers' geometries: SSSJService(block=64)'s
# micro-batch, tile_k and chunk_d, and MultiTenantSSSJService(micro_batch=
# 256)'s block = micro_batch = 256 with tile_k 256², at a window the card
# holds many times over; λ keeps the ring at about 2.5 horizons, as on
# the main path
EDGE_CFGS = tuple(
    dict(theta=THETA, lam=4e-3, capacity=65536, d=256, micro_batch=edge,
         block_q=edge, block_w=edge, chunk_d=128, tile_k=edge * edge)
    for edge in (64, 256))
EDGE_ITEMS = 65536 + 16384


T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the seconds since
    this process started, the script's timeline."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.monotonic() - T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """What a caller pays for one call of ``fn``: CUDA events around
    ``reps`` back-to-back calls.  When the device work of a call is
    shorter than the host time its wrapper takes, this is the host's
    launch pace, not the device's time (see :func:`device_ms`)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


TRIES = 5   # device_ms's traces before it reads CUDA events instead


def device_ms(fn, reps: int, kernel: str | None = None, warmup: int = 2,
              parts: dict | None = None) -> float:
    """The device's own time for one call of ``fn``, host excluded: the
    durations of the device work that ``reps`` calls launch (kernels,
    copies, fills), summed from ``torch.profiler``'s CUDA trace, over
    ``reps``.  With ``kernel``, the kernels whose names hold that text,
    each launched once a call: the sum of their mean durations (each one's
    mean also into ``parts``, by name, when given).

    Method: the profiler's CUPTI trace stamps each kernel's start and end
    on the device, so neither the wrapper's host time nor the gaps it
    leaves between launches count.  Occupying the stream first
    (``torch.cuda._sleep``) so that the host enqueues every rep before the
    device starts would also exclude the host, but not for a function
    that waits on the device: the plain tile joins read a flag back each
    chunk (``bool(running.any())``).  The warmup calls run in the
    profiler's warmup step, and the recorded step starts and ends with a
    pause.  The trace can still miss launches (on an H100, 4 to 6 of 20
    back-to-back flash launches in every try, and once all 20 of a
    0.03 ms kernel), so a named kernel's time is the mean over the
    launches the trace holds, and a kernel recorded fewer than ``reps /
    2`` times is measured again, up to ``TRIES`` times, and then read by
    CUDA events (:func:`_queued_ms`), which the run reports."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(max(1, warmup)):
                fn()
            torch.cuda.synchronize()
            prof.step()   # the warmup step ends: the recorded one starts
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        # the device's own work: not the step's annotation, which spans it
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("ProfilerStep")
                  and (kernel is None or kernel in e.key)]
        if events and kernel is None:
            return sum(_dev_us(e) for e in events) / 1e3 / reps
        if events and all(2 * e.count >= reps for e in events):
            means = {e.key: _dev_us(e) / e.count / 1e3 for e in events}
            if parts is not None:
                parts.update(means)
            return sum(means.values())
    # the trace kept too little of the work, ``TRIES`` times over (on an
    # H100 once every event of 10 SDPA calls, 5 tries in a row): CUDA
    # events instead, the calls enqueued behind a sleep kernel, so that the
    # host's launch pace counts only where ``fn`` waits on the device; the
    # whole call, not a named kernel alone, and ``parts`` stays unset
    ms = _queued_ms(fn, reps, warmup)
    print(f"device_ms: the trace held {[(e.key[:60], e.count) for e in events]} "
          f"for {reps} calls, {TRIES} times; CUDA events read {ms} ms",
          file=sys.stderr, flush=True)
    emit({"phase": "device_ms_fallback", "kernel": kernel, "reps": reps,
          "traced": [(e.key[:60], e.count) for e in events], "ms": ms})
    DEVICE_MS_FALLBACKS.append(ms)
    return ms


DEVICE_MS_FALLBACKS: list = []   # device_ms's readings by CUDA events
SLEEP_CYCLES = 100_000_000       # about 50 ms of an H100's clock


def _queued_ms(fn, reps: int, warmup: int) -> float:
    """CUDA events around ``reps`` calls of ``fn`` that the host enqueues
    while a sleep kernel holds the stream, over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a kernel's times in the ``kernels`` line: through its wrapper (``ms``,
# what a caller pays) and on the device alone (``device_ms``), and its
# plain version's
TIMES = ("ms", "device_ms", "plain_ms", "plain_device_ms")


def _by_kernel(parts: dict) -> dict:
    """``device_ms``'s parts by bare kernel name (``"void (anonymous
    namespace)::x3::flash_tf32_kernel<128>(float const*, ..."`` →
    ``"flash_tf32_kernel"``)."""
    return {re.search(r"::(\w+)[<(]", k).group(1): v for k, v in parts.items()}


def _dev_us(e) -> float:
    """A profiler event's own device time in µs (0 for a host event)."""
    return getattr(e, "self_device_time_total", 0) or 0


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------- #
# phase 1
# --------------------------------------------------------------------- #
def _ptxas(lines, entry: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``entry``, from ``-Xptxas -v``'s report of its build."""
    out, seen = {}, False
    for ln in lines:
        if "entry function" in ln:
            seen = entry in ln
        elif seen and "spill" in ln:
            out["spill_stores"], out["spill_loads"] = map(
                int, re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))
        elif seen and "registers" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def phase_device() -> dict:
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.monotonic()
    built = _build.build()
    ptxas = {
        name: [ln.split("ptxas info    : ")[-1].strip()
               for ln in rec["log"].splitlines()
               if "entry function" in ln or "registers" in ln or "spill" in ln]
        for name, rec in built.items()
    }
    # the bf16 flash kernel at head dim 128 (the models' own), whole q . k^T,
    # and the tile joins' FULL 128 x 128 instances (the main path's)
    flash_bf16 = _ptxas(ptxas.get("flash_attn", []), "flash_bf16_kernelILi128ELb0E")
    flash_tf32 = {dh: _ptxas(ptxas.get("flash_attn", []), f"flash_tf32_kernelILi{dh}E")
                  for dh in (32, 64, 128)}
    gate = _ptxas(ptxas.get("gate_ub", []), "gate_ub_products")
    full128 = "_kernelIN4sssj4TileILi128ELi128ELb1EEE"
    joins = {name: _ptxas(ptxas.get(name, []), entry + full128)
             for name, entry in (("sssj_cand", "cand"), ("sssj_dense", "dense"))}
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.monotonic() - t0, "ptxas": ptxas})
    return {"smi": smi, "ptxas_flash_bf16": flash_bf16, "ptxas_flash_tf32": flash_tf32,
            "ptxas_joins": joins, "ptxas_gate": gate}


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def _window(gen, n, d, t_end, dev):
    """A live-looking window: unit rows at RATE items per time unit, the
    newest at ``t_end``, uids in arrival order."""
    import torch

    w = torch.randn((n, d), generator=gen, device=dev)
    w /= w.norm(dim=1, keepdim=True)
    tw = t_end - torch.arange(n - 1, -1, -1, device=dev, dtype=torch.float32) / RATE
    uw = torch.arange(n, device=dev, dtype=torch.int32)
    return w, tw, uw


def _queries(gen, w, tw, uw, n, n_dup, dev):
    """``n`` fresh queries just after the window, ``n_dup`` of them noisy
    copies (cosine ≈ 0.995) of window rows from the newest 50k, whose
    decay keeps them above θ, so the join has pairs to emit."""
    import torch

    W, d = w.shape
    q = torch.randn((n, d), generator=gen, device=dev)
    src = torch.randint(max(0, W - 50_000), W, (n_dup,), generator=gen, device=dev)
    noise = torch.randn((n_dup, d), generator=gen, device=dev)
    q[:n_dup] = w[src] + (0.1 / d**0.5) * noise
    q /= q.norm(dim=1, keepdim=True)
    tq = tw.max() + (1 + torch.arange(n, device=dev, dtype=torch.float32)) / RATE
    uq = int(uw.max()) + 1 + torch.arange(n, device=dev, dtype=torch.int32)
    return q, tq, uq


def _compare_cand(name, kernel_out, plain_out) -> float:
    labels = ("cand_idx", "cand_score", "emitted", "row_hits", "iters")
    for lab, k, p in zip(labels, kernel_out, plain_out):
        if lab == "cand_score":
            continue
        if not bool((k == p).all()):
            bad = int((k != p).sum())
            raise AssertionError(f"{name}: {lab} differs in {bad} entries")
    err = float((kernel_out[1] - plain_out[1]).abs().max())
    if err > FLOAT_TOL:
        raise AssertionError(f"{name}: cand_score max error {err} > {FLOAT_TOL}")
    return err


def _compare_dense(name, kernel_out, plain_out, theta) -> dict:
    """``iters`` and ``counts`` exact; scores within ``FLOAT_TOL`` outside
    the ε-band around θ, whose entries are counted and reported."""
    import torch

    (ks, ki, kc), (ps, pi, pc) = kernel_out, plain_out
    for lab, k, p in (("iters", ki, pi), ("counts", kc, pc)):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: {lab} differs in {int((k != p).sum())} tiles")
    band = ((ks - theta).abs() <= BAND) | ((ps - theta).abs() <= BAND)
    err = float(torch.where(band, 0.0, (ks - ps).abs()).max())
    if err > FLOAT_TOL:
        raise AssertionError(f"{name}: score max error {err} > {FLOAT_TOL}")
    return {"max_abs_err": err, "band_entries": int(band.sum()),
            "band_differ": int((band & (ks != ps)).sum()),
            "pairs": int(kc.sum()), "chunks_run": int(ki.sum()), "tiles": ki.numel(),
            "live_tiles": int((ki > 0).sum())}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.sssj_join import gate as gate_mod
    from repro_torch.kernels.sssj_join.gate import strip_gate, summarize_strips
    from repro_torch.kernels.sssj_join.kernel import (
        cand_tiles_plain,
        dense_tiles_plain,
        sssj_join_candidates_kernel_call as cand,
        sssj_join_kernel_call as dense,
    )
    from repro_torch.kernels.sssj_join.ops import suffix_chunk_norms

    gen = torch.Generator(device=dev).manual_seed(SEED)
    blk, chunk, tile_k = 128, 128, 256
    kw = dict(block_q=blk, block_w=blk, chunk_d=chunk, tile_k=tile_k)
    w, tw, uw = _window(gen, CAPACITY, D, 400.0, dev)
    q, tq, uq = _queries(gen, w, tw, uw, MICRO, 24, dev)
    sqq, sqw = suffix_chunk_norms(q, chunk), suffix_chunk_norms(w, chunk)
    summary = summarize_strips(w, tw, uw, block_w=blk, chunk_d=chunk)
    gate, gate_stats = strip_gate(
        q, summary, block_q=blk, chunk_d=chunk, tq_lo=tq.min(), tq_hi=tq.max(),
        th_min=THETA, lam_min=LAM, device=dev,
    )
    gate = gate.int()
    cases = {}

    def run_case(label, args, ckw, reps):
        k_out = cand(*args, **ckw)
        p_out = cand_tiles_plain(*args, **ckw)
        sync(dev)
        err = _compare_cand(label, k_out, p_out)
        rec = {"max_abs_err": err, "pairs": int(k_out[2].sum()),
               "chunks_run": int(k_out[4].sum()), "tiles": k_out[4].numel(),
               "live_tiles": int((k_out[4] > 0).sum())}
        if reps:
            rec["ms"] = cuda_ms(lambda: cand(*args, **ckw), reps)
            rec["device_ms"] = device_ms(lambda: cand(*args, **ckw), reps, "::cand_")
            rec["plain_ms"] = cuda_ms(lambda: cand_tiles_plain(*args, **ckw), 3, 1)
            rec["plain_device_ms"] = device_ms(lambda: cand_tiles_plain(*args, **ckw), 3,
                                               warmup=1)
        cases[label] = rec
        return rec

    col = lambda x: x[:, None]  # noqa: E731
    main_args = (q, w, col(tq), col(tw), col(uq), col(uw), sqq, sqw)
    base = dict(theta=THETA, lam=LAM, **kw)
    gated = run_case("window_gated", main_args, dict(base, gate=gate), reps=20)
    run_case("window_ungated", main_args, base, reps=5)
    # the self join: one 128 x 128 tile of the micro-batch against itself
    run_case("self", (q, q, col(tq), col(tq), col(uq), col(uq), sqq, sqq),
             base, reps=20)
    # tile_k overflow: a tight cluster fills every tile past tile_k
    cl = torch.randn((1, D), generator=gen, device=dev)
    cw = cl + 0.01 * torch.randn((1024, D), generator=gen, device=dev)
    cw /= cw.norm(dim=1, keepdim=True)
    ct = torch.linspace(0.0, 0.01, 1024, device=dev)
    cu = torch.arange(1024, device=dev, dtype=torch.int32)
    cq, ctq, cuq = cw[-128:], ct[-128:], cu[-128:]
    ovf = run_case(
        "tile_k_overflow",
        (cq, cw, col(ctq), col(ct), col(cuq), col(cu),
         suffix_chunk_norms(cq, chunk), suffix_chunk_norms(cw, chunk)),
        base, reps=0,
    )
    if not ovf["pairs"] > tile_k:
        raise AssertionError("overflow case did not overflow tile_k")
    # ragged d: 200 features zero-padded to two chunks, as the join pads;
    # two query tiles, so the grid's second dimension is exercised
    q2 = torch.cat([q, torch.randn((MICRO, D), generator=gen, device=dev)])
    rq = torch.nn.functional.pad(q2[:, :200], (0, 56))
    rw = torch.nn.functional.pad(w[-8192:, :200], (0, 56))
    rq /= rq.norm(dim=1, keepdim=True)
    rw /= rw.norm(dim=1, keepdim=True)
    rq[:8] = rw[-8:]
    rq[MICRO:MICRO + 8] = rw[-16:-8]
    tq2, uq2 = torch.cat([tq, tq + 1.0]), torch.cat([uq, uq + MICRO])
    ragged_args = (rq, rw, col(tq2), col(tw[-8192:]), col(uq2), col(uw[-8192:]),
                   suffix_chunk_norms(rq, chunk), suffix_chunk_norms(rw, chunk))
    run_case("ragged_d_two_q_tiles", ragged_args, dict(base, theta=0.5), reps=0)
    # the multi-tenant lanes: stream ids and per-row (θ, λ)
    sid_q = torch.randint(0, 3, (MICRO,), generator=gen, device=dev, dtype=torch.int32)
    sid_w = torch.randint(0, 3, (CAPACITY,), generator=gen, device=dev, dtype=torch.int32)
    th_q = 0.85 + 0.1 * torch.rand((MICRO,), generator=gen, device=dev)
    lam_q = LAM * (0.5 + torch.rand((MICRO,), generator=gen, device=dev))
    # gated as the runtime gates it: by the rows' smallest θ and λ
    gate_mt, _ = strip_gate(q, summary, block_q=blk, chunk_d=chunk, tq_lo=tq.min(),
                            tq_hi=tq.max(), th_min=th_q.min(), lam_min=lam_q.min(),
                            device=dev)
    mt = run_case("multi_tenant", main_args,
                  dict(base, gate=gate_mt.int(), sq=col(sid_q), sw=col(sid_w), theta_q=col(th_q),
                       lam_q=col(lam_q)), reps=20)
    # the two ends of the tile population at the main path's shapes: every
    # tile gated off (the grid and the dead tiles alone), and every tile
    # live (gate all ones over the window squeezed into 2.6 time units, so
    # each tile runs until its early exit)
    nw_tiles = CAPACITY // blk
    dead = run_case("window_all_dead", main_args,
                    dict(base, gate=torch.zeros_like(gate)), reps=20)
    live_args = (q, w, col(tq), col(400.0 - (400.0 - tw) / 100.0), col(uq), col(uw),
                 sqq, sqw)
    live = run_case("window_all_live", live_args,
                    dict(base, gate=torch.ones_like(gate)), reps=20)
    if dead["live_tiles"] or live["live_tiles"] != nw_tiles or not live["pairs"]:
        raise AssertionError(f"all-dead / all-live cases: {dead}, {live}")

    # the gate bound at the main path's shapes
    vmax, cnorm = summary.vmax, summary.cnorm
    qa, qcn = q.abs(), gate_mod.chunk_norms(q, chunk)
    ub_k = gate_mod.gate_ub(qa, qcn, vmax, cnorm, block_q=blk)
    ub_p = gate_mod.gate_ub_plain(qa, qcn, vmax, cnorm, block_q=blk)
    sync(dev)
    ub_err = float((ub_k - ub_p).abs().max())
    qa2 = q2.abs()                           # two query tiles
    qcn2 = gate_mod.chunk_norms(q2, chunk)
    ub_err = max(ub_err, float((gate_mod.gate_ub(qa2, qcn2, vmax, cnorm, block_q=blk)
                                - gate_mod.gate_ub_plain(qa2, qcn2, vmax, cnorm, block_q=blk)
                                ).abs().max()))
    # on this isotropic window the chunk-l2 bound is the smaller one, so the
    # prefix product decides no entry: the same with cnorm scaled up
    # until the prefix bound decides every one
    ub_prefix = _gate_prefix_err(gate_mod, qa, qcn, vmax, cnorm, blk)
    ub_err = max(ub_err, ub_prefix)
    if not ub_err <= FLOAT_TOL:
        raise AssertionError(f"gate bound max error {ub_err} > {FLOAT_TOL}")
    g_call = lambda: gate_mod.gate_ub(qa, qcn, vmax, cnorm, block_q=blk)  # noqa: E731
    g_plain_call = lambda: gate_mod.gate_ub_plain(qa, qcn, vmax, cnorm, block_q=blk)  # noqa: E731
    g_parts: dict = {}
    g_times = {"ms": cuda_ms(g_call, 50),
               "device_ms": device_ms(g_call, 50, "::gate_ub", parts=g_parts),
               "plain_ms": cuda_ms(g_plain_call, 20),
               "plain_device_ms": device_ms(g_plain_call, 20)}
    g_times["device_ms_by_kernel"] = _by_kernel(g_parts)

    # the dense-emission tile join: the window and self joins of the
    # emit_dense path, and ragged d with two query tiles
    dense_cases = {}
    dkw = dict(theta=THETA, lam=LAM, block_q=blk, block_w=blk, chunk_d=chunk)

    def run_dense(label, args, ckw, reps):
        k_out = dense(*args, **ckw)
        p_out = dense_tiles_plain(*args, **ckw)
        sync(dev)
        rec = _compare_dense(label, k_out, p_out, ckw["theta"])
        if reps:
            rec["ms"] = cuda_ms(lambda: dense(*args, **ckw), reps)
            rec["device_ms"] = device_ms(lambda: dense(*args, **ckw), reps, "::dense_")
            rec["plain_ms"] = cuda_ms(lambda: dense_tiles_plain(*args, **ckw), 3, 1)
            rec["plain_device_ms"] = device_ms(lambda: dense_tiles_plain(*args, **ckw), 3,
                                               warmup=1)
        dense_cases[label] = rec
        return rec

    d_win = run_dense("window", main_args, dkw, reps=20)
    run_dense("self", (q, q, col(tq), col(tq), col(uq), col(uq), sqq, sqq),
              dkw, reps=20)
    run_dense("ragged_d_two_q_tiles", ragged_args, dict(dkw, theta=0.5), reps=0)
    # the dense join has no gate: its all-dead window lies 1,000 time units
    # back (every decay below θ), its all-live one is the squeezed window
    d_dead = run_dense("window_all_dead", (q, w, col(tq), col(tw - 1000.0), col(uq),
                                           col(uw), sqq, sqw), dkw, reps=20)
    d_live = run_dense("window_all_live", live_args, dkw, reps=20)
    if d_dead["live_tiles"] or d_live["live_tiles"] != nw_tiles:
        raise AssertionError(f"dense all-dead / all-live cases: {d_dead}, {d_live}")
    edges = _tile_edge_checks(dev, gen)

    # bounds from this run's inputs: each input read once, each output
    # written once; the tile join's work is the chunks its tiles ran.  The
    # f32 bound takes the CUDA cores' rate; the 3xTF32 one, three TF32
    # tensor-core products per multiply-add (the kernels' own arithmetic)
    nq, nw = 1, nw_tiles

    def join_bounds(chunks_run, dense_out):
        nbytes = (q.numel() * 4 + chunks_run * blk * chunk * 4   # q, w slabs run
                  + CAPACITY * 4 * (2 + sqw.shape[1]) + MICRO * 4 * (2 + sqq.shape[1])
                  + (MICRO * CAPACITY * 4 + nq * nw * 8 if dense_out   # scores, counts
                     else nq * nw * 4 + nq * nw * (tile_k * 8 + blk * 4 + 8)))
        flops = chunks_run * 2 * blk * blk * chunk
        f32, by = bound_ms(nbytes, flops)
        return {"bound_ms": f32, "bound_by": by,
                "bound_3xtf32_ms": bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)[0],
                "chunks_run": chunks_run}

    j_bounds = join_bounds(gated["chunks_run"], False)
    d_bounds = join_bounds(d_win["chunks_run"], True)
    ns, nc = cnorm.shape
    g_bytes = 4 * (qa.numel() + qcn.numel() + vmax.numel() + cnorm.numel() + nq * ns)
    g_flops = 2 * MICRO * ns * (D + nc)
    g_bound, g_by = bound_ms(g_bytes, g_flops)
    emit({"phase": "kernels", "gate_stats": gate_stats.tolist(), "cases": cases,
          "gate_ub": {"max_abs_err": ub_err, "prefix_decides_max_abs_err": ub_prefix,
                      **g_times},
          "dense_cases": dense_cases, "tile_edges": edges})
    return {
        "sssj_cand": {"max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                      **{k: gated[k] for k in TIMES}, **j_bounds,
                      "ms_all_dead": dead["ms"], "ms_all_live": live["ms"],
                      "device_ms_all_dead": dead["device_ms"],
                      "device_ms_all_live": live["device_ms"],
                      "all_live": join_bounds(live["chunks_run"], False),
                      # all four lanes (stream ids, per-row θ and λ), gated
                      "multi_tenant": {k: mt[k] for k in TIMES + ("chunks_run",)},
                      "multi_tenant_bound": join_bounds(mt["chunks_run"], False)},
        "gate_ub": {"max_abs_err": ub_err, **g_times, "bound_ms": g_bound, "bound_by": g_by,
                    "bound_3xtf32_ms": bound_ms(g_bytes, 3 * g_flops, PEAK_TF32_FLOPS)[0]},
        "sssj_dense": {"max_abs_err": max(c["max_abs_err"] for c in dense_cases.values()),
                       **{k: d_win[k] for k in TIMES}, **d_bounds,
                       "ms_all_dead": d_dead["ms"], "ms_all_live": d_live["ms"],
                       "device_ms_all_dead": d_dead["device_ms"],
                       "device_ms_all_live": d_live["device_ms"],
                       "all_live": join_bounds(d_live["chunks_run"], True)},
    }


def _gate_prefix_err(gate_mod, qa, qcn, vmax, cnorm, block_q) -> float:
    """The gate kernel's max error against its plain version with the
    chunk norms scaled up by 1e3, so that the prefix product |q| . vmax is
    the smaller bound, and so the result, everywhere."""
    big = cnorm * 1e3
    ub_k = gate_mod.gate_ub(qa, qcn, vmax, big, block_q=block_q)
    ub_p = gate_mod.gate_ub_plain(qa, qcn, vmax, big, block_q=block_q)
    lb = (qcn @ big.T).reshape(-1, block_q, big.shape[0]).amin(1)
    if not bool(((ub_p < lb) | (lb == 0)).all()):   # (an empty strip bounds 0 both ways)
        raise AssertionError("gate check: the scaled chunk bound still decides an entry")
    return float((ub_k - ub_p).abs().max())


def _tile_edge_checks(dev, gen) -> dict:
    """The two tile joins and the gate bound against their plain versions
    at each of ``TILE_EDGES``: a gated window of 40 strips with planted
    near-duplicates, and a tight cluster that overflows ``tile_k``."""
    import torch
    from repro_torch.kernels.sssj_join import gate as gate_mod
    from repro_torch.kernels.sssj_join.gate import strip_gate, summarize_strips
    from repro_torch.kernels.sssj_join.kernel import (
        cand_tiles_plain,
        dense_tiles_plain,
        kernel_tile_edge,
        sssj_join_candidates_kernel_call as cand,
        sssj_join_kernel_call as dense,
    )
    from repro_torch.kernels.sssj_join.ops import suffix_chunk_norms

    col = lambda x: x[:, None]  # noqa: E731
    chunk, out = 128, {}
    for bq, bw in TILE_EDGES:
        label = f"{bq}x{bw}"
        w, tw, uw = _window(gen, 40 * bw, D, 50.0, dev)
        q, tq, uq = _queries(gen, w, tw, uw, 2 * bq, bq // 2, dev)
        tw[: 20 * bw] -= 1000.0          # the older half is past the horizon
        sqq, sqw = suffix_chunk_norms(q, chunk), suffix_chunk_norms(w, chunk)
        summary = summarize_strips(w, tw, uw, block_w=bw, chunk_d=chunk)
        qa, qcn = q.abs(), gate_mod.chunk_norms(q, chunk)
        ub_k = gate_mod.gate_ub(qa, qcn, summary.vmax, summary.cnorm, block_q=bq)
        ub_p = gate_mod.gate_ub_plain(qa, qcn, summary.vmax, summary.cnorm, block_q=bq)
        gate, _ = strip_gate(q, summary, block_q=bq, chunk_d=chunk, tq_lo=tq.min(),
                             tq_hi=tq.max(), th_min=THETA, lam_min=LAM, device=dev)
        args = (q, w, col(tq), col(tw), col(uq), col(uw), sqq, sqw)
        kw = dict(theta=THETA, lam=LAM, block_q=bq, block_w=bw, chunk_d=chunk)
        ckw = dict(kw, tile_k=64, gate=gate.int())
        c_k, c_p = cand(*args, **ckw), cand_tiles_plain(*args, **ckw)
        d_k, d_p = dense(*args, **kw), dense_tiles_plain(*args, **kw)
        # a tight cluster: every tile past tile_k
        cl = torch.randn((1, D), generator=gen, device=dev)
        cw = cl + 0.01 * torch.randn((4 * bw, D), generator=gen, device=dev)
        cw /= cw.norm(dim=1, keepdim=True)
        ct = torch.linspace(0.0, 0.01, 4 * bw, device=dev)
        cu = torch.arange(4 * bw, device=dev, dtype=torch.int32)
        o_args = (cw[-bq:], cw, col(ct[-bq:]), col(ct), col(cu[-bq:]), col(cu),
                  suffix_chunk_norms(cw[-bq:], chunk), suffix_chunk_norms(cw, chunk))
        o_kw = dict(kw, tile_k=64)
        o_k, o_p = cand(*o_args, **o_kw), cand_tiles_plain(*o_args, **o_kw)
        sync(dev)
        ub_err = max(float((ub_k - ub_p).abs().max()),
                     _gate_prefix_err(gate_mod, qa, qcn, summary.vmax, summary.cnorm, bq))
        if not ub_err <= FLOAT_TOL:
            raise AssertionError(f"gate bound at {label}: max error {ub_err}")
        rec = {"compiled_tile": [kernel_tile_edge(bq), kernel_tile_edge(bw)],
               "gate_ub_max_abs_err": ub_err,
               "cand_max_abs_err": _compare_cand(f"sssj_cand {label}", c_k, c_p),
               "cand_pairs": int(c_k[2].sum()), "gated_tiles": int((gate == 0).sum()),
               "chunks_run": int(c_k[4].sum()),
               "dense": _compare_dense(f"sssj_dense {label}", d_k, d_p, THETA),
               "overflow_max_abs_err": _compare_cand(f"sssj_cand {label} overflow",
                                                     o_k, o_p),
               "overflow_pairs": int(o_k[2].sum())}
        if not (rec["cand_pairs"] > 0 and bool((o_k[2] > 64).any())
                and rec["gated_tiles"] > 0):
            raise AssertionError(f"tile edges {label}: the cases did not exercise "
                                 f"pairs, gating and overflow: {rec}")
        out[label] = rec
    return out


def phase_tile_edge_engine(dev) -> list:
    """The engine at each of the consumers' tile geometries (``EDGE_CFGS``)
    over a stream that wraps the ring, held against ``join_impl="dense"``
    on the card as phase 3 holds the main path."""
    from repro_torch.kernels.sssj_join.gate import gate_ub
    from repro_torch.kernels.sssj_join.kernel import sssj_join_candidates_kernel_call

    out = []
    for cfg in EDGE_CFGS:
        label = f"{cfg['block_q']} x {cfg['block_w']}"
        requests = _requests(EDGE_ITEMS, cfg["d"])
        sssj_join_candidates_kernel_call.launches = 0
        gate_ub.launches = 0
        kern = _run_engine(dev, requests, n_profiled=0, **cfg)
        launches = {"sssj_cand": sssj_join_candidates_kernel_call.launches,
                    "gate_ub": gate_ub.launches}
        n_micro = sum(-(-len(v) // cfg["micro_batch"]) for v, _ in requests)
        if launches != {"sssj_cand": 2 * n_micro, "gate_ub": n_micro}:
            raise AssertionError(f"{label} engine launches {launches}, expected "
                                 f"2 x and 1 x {n_micro}")
        dense = _run_engine(dev, requests, n_profiled=0, join_impl="dense", **cfg)
        band, score_err = _check_same_emission(kern, dense,
                                               f"{label} kernel route vs dense")
        for key in ("pairs_dropped_budget", "pairs_dropped_tile", "window_overflow"):
            if kern["stats"][key] != dense["stats"][key]:
                raise AssertionError(f"{label} {key}: kernel {kern['stats'][key]} vs "
                                     f"dense {dense['stats'][key]}")
        st = kern["stats"]
        if st["n_items"] != EDGE_ITEMS or not len(kern["pairs"][0]) or st["window_overflow"]:
            raise AssertionError(f"{label} engine emitted nothing or overflowed: {st}")
        rec = {"phase": "tile_edge_engine", "config": cfg, "n_items": EDGE_ITEMS,
               "pairs": len(kern["pairs"][0]), "dense_pairs": len(dense["pairs"][0]),
               "band_pairs": len(band), "max_score_err": score_err,
               "launches": launches,
               "items_per_s": kern["timed_items"] / kern["seconds"],
               "dense_items_per_s": dense["timed_items"] / dense["seconds"], "stats": st}
        emit(rec)
        out.append(rec)
    return out


# --------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------- #
def _requests(n_items: int, d: int = D):
    """The near-duplicate service's stream, made request by request: each
    request is ``dense_embedding_stream(REQUEST, d, rate=RATE)`` (15 %
    planted near-duplicates of the 64 items before them) from its own
    seed, its timestamps following on from the previous request's."""
    from repro_torch.data import dense_embedding_stream

    out, t_off = [], 0.0
    for r in range(-(-n_items // REQUEST)):
        n = min(REQUEST, n_items - r * REQUEST)
        v, t = dense_embedding_stream(n, d, seed=SEED * 100_003 + r, rate=RATE)
        out.append((v, t + t_off))
        t_off = float(t[-1] + t_off)
    return out


PORT_KERNELS = ("cand_kernel", "cand_big_kernel", "gate_ub_products", "gate_ub_reduce",
                "dense_kernel", "dense_big_kernel")


def _profile(push_all, dev):
    """Device time by kernel and the device's busy share over one window
    of pushes, from ``torch.profiler`` (its own overhead makes the host
    slower, so the busy share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        out = push_all()
        sync(dev)
        wall_ms = 1e3 * (time.monotonic() - t0)

    # device-side events only: an aten op's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0]
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:10]
    # the port's own kernels by bare name: mean device ms a launch
    named = {}
    for e in kernels:
        m = re.search(r"::(\w+)[<(]", e.key)
        if m and m.group(1) in PORT_KERNELS:
            rec = named.setdefault(m.group(1), {"device_ms_total": 0.0, "calls": 0})
            rec["device_ms_total"] += _dev_us(e) / 1e3
            rec["calls"] += e.count
    for rec in named.values():
        rec["device_ms_per_call"] = rec["device_ms_total"] / rec["calls"]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "port_kernels": named,
        "top": [{"name": e.key[:90], "ms": _dev_us(e) / 1e3, "calls": e.count}
                for e in top],
    }


def _run_engine(dev, requests, n_profiled=2, **kw):
    """Stream ``requests`` through a fresh engine (the main path's
    configuration, updated by ``kw``): see :func:`_drive_engine`."""
    from repro_torch.engine import EngineConfig, StreamEngine

    cfg = dict(theta=THETA, lam=LAM, capacity=CAPACITY, d=D, micro_batch=MICRO)
    return _drive_engine(StreamEngine(EngineConfig(**{**cfg, **kw}), device=dev),
                         dev, requests, n_profiled)


def _ring_counts(state) -> dict:
    """Each ring's cursor, live slots and overflow (one ring, or one per
    shard of a sharded window)."""
    rings = getattr(state, "shards", (state,))
    return {"cursor": [int(r.cursor.item()) for r in rings],
            "live_slots": [int((r.uids >= 0).sum().item()) for r in rings],
            "window_overflow": [int(r.overflow.item()) for r in rings]}


def _drive_engine(eng, dev, requests, n_profiled=2, before_push=None, drain_every=0):
    """Stream ``requests`` through ``eng``: all but the last ``n_profiled``
    timed (pushes and drains, host clock, ending in a device sync), the
    last ones under the profiler.  The engine drains after every
    ``drain_every`` pushes (0: at the end alone).  With ``before_push``,
    ``before_push(m, eng, v, t, dev)`` runs before push ``m`` off the
    clock, and each push with its drain is timed alone and counted with
    :func:`_count_launches` (``launches``: their sum; without the hook
    the caller counts).  Returns the drained pairs and row masks of the
    whole stream, and closes the engine."""

    def push(m, v, t, parts, last):
        eng.push(v, t)
        if m + 1 == last or (drain_every and (m + 1) % drain_every == 0):
            parts.append(eng.drain_arrays(return_masks=True))

    def push_all(reqs, m0=0):
        parts = []
        for m, (v, t) in enumerate(reqs, m0):
            push(m, v, t, parts, m0 + len(reqs))
        return parts

    def push_one(m, v, t, parts):
        sync(dev)
        t0 = time.monotonic()
        push(m, v, t, parts, n_timed)
        sync(dev)
        return time.monotonic() - t0

    n_timed = len(requests) - n_profiled
    timed, profiled = requests[:n_timed], requests[n_timed:]
    try:
        launches = None
        if before_push is None:
            sync(dev)
            t0 = time.monotonic()
            parts = push_all(timed)
            sync(dev)
            seconds = time.monotonic() - t0
        else:
            parts, seconds, launches = [], 0.0, dict.fromkeys(_launch_counters(), 0)
            for m, (v, t) in enumerate(timed):
                before_push(m, eng, v, t, dev)
                s, got = _count_launches(lambda: push_one(m, v, t, parts))
                seconds += s
                launches = {k: n + got[k] for k, n in launches.items()}
        prof = None
        if profiled:
            last, prof = _profile(lambda: push_all(profiled, n_timed), dev)
            parts += last
        ua, ub, sc, mask = (np.concatenate(x) for x in zip(*parts))
        return {"pairs": (ua, ub, sc), "mask": mask, "seconds": seconds,
                "timed_items": sum(len(v) for v, _ in timed), "profile": prof,
                "stats": eng.stats(), "metrics": eng.metrics(),
                "rings": _ring_counts(eng.state), "launches": launches}
    finally:
        eng.close()


def _check_same_emission(a, b, label, theta=THETA):
    """Two engine runs over one stream drained the same pairs: every
    pair finite, ≥ θ, newer-first and emitted once; the pair sets equal outside the
    ε-band around θ; common scores within ``FLOAT_TOL``; row masks (where
    both runs drained them) equal outside the rows of band pairs.  Keys
    are matched by sorting in numpy (phase 4n holds ~55 M pairs).
    Returns ``(band pairs {(uid_a, uid_b): score}, max score error)``."""
    keys, scores = [], []
    for ua, ub, sc in (a["pairs"], b["pairs"]):
        ua, ub, sc = np.asarray(ua), np.asarray(ub), np.asarray(sc)
        if not (np.isfinite(sc).all() and (sc >= np.float32(theta)).all()
                and (ua > ub).all() and (ub >= 0).all()):
            raise AssertionError(f"{label}: emitted pairs are not finite, ≥ θ, newer-first")
        k = (ua.astype(np.int64) << 32) | ub.astype(np.int64)
        order = np.argsort(k, kind="stable")
        if (np.diff(k[order]) == 0).any():
            raise AssertionError(f"{label}: a pair was emitted twice")
        keys.append(k[order])
        scores.append(sc[order])
    ka, kb = keys
    pos = np.minimum(np.searchsorted(ka, kb), max(len(ka) - 1, 0))
    in_a = ka[pos] == kb if len(ka) else np.zeros(len(kb), bool)
    only_a = np.ones(len(ka), bool)
    only_a[pos[in_a]] = False
    band_keys = np.concatenate([ka[only_a], kb[~in_a]])
    band_scores = np.concatenate([scores[0][only_a], scores[1][~in_a]]).astype(np.float64)
    band = {(int(k >> 32), int(k & 0xFFFFFFFF)): float(v)
            for k, v in zip(band_keys, band_scores)}
    outside = {k: v for k, v in band.items() if abs(v - theta) > BAND}
    if outside:
        raise AssertionError(f"{label}: pair sets differ outside the ε-band: "
                             f"{list(outside.items())[:5]}")
    diff = np.abs(scores[0][pos[in_a]].astype(np.float64) - scores[1][in_a])
    score_err = float(diff.max(initial=0.0))
    if score_err > FLOAT_TOL:
        raise AssertionError(f"{label}: pair scores differ by {score_err}")
    if a.get("mask") is not None and b.get("mask") is not None:
        mask_diff = np.nonzero(a["mask"] != b["mask"])[0]
        if not np.isin(mask_diff, band_keys >> 32).all():
            raise AssertionError(f"{label}: row masks differ at rows {mask_diff[:10].tolist()}")
    return band, score_err


def phase_main_path(dev) -> dict:
    import torch
    from repro_torch.kernels.sssj_join.gate import gate_ub
    from repro_torch.kernels.sssj_join.kernel import sssj_join_candidates_kernel_call

    t0 = time.monotonic()
    requests = _requests(N_ITEMS)
    gen_s = time.monotonic() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sssj_join_candidates_kernel_call.launches = 0
    gate_ub.launches = 0
    kern = _run_engine(dev, requests)
    launches = {"sssj_cand": sssj_join_candidates_kernel_call.launches,
                "gate_ub": gate_ub.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    dense = _run_engine(dev, requests, join_impl="dense")

    band, score_err = _check_same_emission(kern, dense, "kernel route vs dense oracle")
    for key in ("pairs_dropped_budget", "pairs_dropped_tile", "window_overflow"):
        if kern["stats"][key] != dense["stats"][key]:
            raise AssertionError(f"{key}: kernel {kern['stats'][key]} vs "
                                 f"dense {dense['stats'][key]}")
    n_pairs = len(kern["pairs"][0])
    if kern["stats"]["n_items"] != N_ITEMS or n_pairs == 0:
        raise AssertionError("the main path emitted nothing")
    prune = {k: v for k, v in kern["metrics"].items() if k.startswith("engine/prune/")}
    emit({
        "phase": "main_path", "n_items": N_ITEMS, "capacity": CAPACITY, "d": D,
        "requests": len(requests), "request_size": REQUEST, "gen_s": gen_s,
        "timed_items": kern["timed_items"],
        "items_per_s": kern["timed_items"] / kern["seconds"],
        "seconds": kern["seconds"],
        "dense_items_per_s": dense["timed_items"] / dense["seconds"],
        "dense_seconds": dense["seconds"], "peak_gib": peak_gib,
        "pairs": n_pairs, "dense_pairs": len(dense["pairs"][0]),
        "band_pairs": len(band),
        "band": [[x, y, sc] for (x, y), sc in sorted(band.items())][:20],
        "max_score_err": score_err, "launches": launches,
        "prune": prune, "stats": kern["stats"],
        "profile": {"kernel_path": kern["profile"], "dense_path": dense["profile"]},
    })
    return launches, requests, {"kernel": kern, "dense": dense}


# --------------------------------------------------------------------- #
# phase 4: the dense-emission path
# --------------------------------------------------------------------- #
def phase_dense_path(dev, requests, main_runs, smi) -> dict:
    """``emit_dense=True`` over phase 3's stream: the dense tile join for
    the window and self joins, then one compaction of the (mb, capacity +
    mb) scores.  Its drained pairs must be phase 3's."""
    from repro_torch.kernels.sssj_join.gate import gate_ub
    from repro_torch.kernels.sssj_join.kernel import (
        sssj_join_candidates_kernel_call,
        sssj_join_kernel_call,
    )

    counters = {"sssj_dense": sssj_join_kernel_call,
                "sssj_cand": sssj_join_candidates_kernel_call, "gate_ub": gate_ub}
    for fn in counters.values():
        fn.launches = 0
    run = _run_engine(dev, requests, emit_dense=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    n_micro = sum(-(-len(v) // MICRO) for v, _ in requests)
    if launches != {"sssj_dense": 2 * n_micro, "sssj_cand": 0, "gate_ub": 0}:
        raise AssertionError(f"the dense path's launches: {launches}, "
                             f"expected 2 x {n_micro} dense tile joins only")
    checks = {}
    for name, other in main_runs.items():
        band, err = _check_same_emission(run, other, f"emit_dense vs {name}")
        checks[name] = {"band_pairs": len(band), "max_score_err": err}
    st = run["stats"]
    if st["pairs_dropped"] or st["window_overflow"] or st["n_items"] != N_ITEMS:
        raise AssertionError(f"dense path dropped or overflowed: {st}")
    emit({
        "phase": "dense_path", "nvidia_smi": smi, "n_items": N_ITEMS,
        "timed_items": run["timed_items"],
        "items_per_s": run["timed_items"] / run["seconds"],
        "seconds": run["seconds"], "pairs": len(run["pairs"][0]),
        "versus": checks, "launches": launches, "stats": st,
        "profile": run["profile"],
    })
    return launches


# --------------------------------------------------------------------- #
# phases 4a-4d: the scan route and the single-engine consumers
# --------------------------------------------------------------------- #
PRUNE_KEYS = ("tiles_skipped_time", "tiles_skipped_l2", "strips_survived")
# the consumers' tile edge: SSSJService(block=64) and DedupFilter(block=64)
CONSUMER_BLOCK = 64
# 4b's requests: the first 66 of phase 3's 80 (270,336 items; 64 fill the
# 262,144 slots, so the ring still wraps; not 80: the script's time)
SERVICE_REQUESTS = 66
# TokenPipeline at qwen3's vocabulary, a batch of 256 documents of 2,048
# tokens, 15 % planted near-duplicates of the step before
PIPELINE = dict(vocab_size=151936, batch=256, seq_len=2048, dup_frac=0.15)
# the filter's window: 65,536 slots (the main path's 262,144 cut by four for
# the script's time; the ring wraps all the same)
PIPELINE_CAPACITY = 65536
# enough steps that the filter's ring wraps: 256 batches of 256 fill its
# 65,536 slots, 6 more overwrite the oldest 1,536
PIPELINE_STEPS = PIPELINE_CAPACITY // PIPELINE["batch"] + 6


def _launch_counters() -> dict:
    from repro_torch.kernels.sssj_join.gate import gate_ub
    from repro_torch.kernels.sssj_join.kernel import (
        sssj_join_candidates_kernel_call,
        sssj_join_kernel_call,
    )

    return {"sssj_cand": sssj_join_candidates_kernel_call, "gate_ub": gate_ub,
            "sssj_dense": sssj_join_kernel_call}


def _count_launches(fn):
    """``fn()``'s result and each kernel's launches during it: every
    counter is set to 0 just before and read just after."""
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {name: c.launches for name, c in counters.items()}


def _expect_launches(label, launches, n_micro, window_joins=True, shards=1):
    """The kernel route's launches: two tile joins (window and self) and
    one gate a micro-batch on each shard; the scan launches the gate
    alone."""
    n = n_micro * shards
    want = ({"sssj_cand": 2 * n, "gate_ub": n, "sssj_dense": 0}
            if window_joins else {"sssj_cand": 0, "gate_ub": n, "sssj_dense": 0})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def _n_micro(requests, mb: int) -> int:
    return sum(-(-len(v) // mb) for v, _ in requests)


def _pairs_run(pairs) -> dict:
    """A consumer's ``(uid_a, uid_b, score)`` list as ``_check_same_emission``
    takes an engine run (no row masks)."""
    ua, ub, sc = (np.array(x) for x in zip(*pairs)) if pairs else ([], [], [])
    return {"pairs": (np.asarray(ua, np.int32), np.asarray(ub, np.int32),
                      np.asarray(sc, np.float32)), "mask": None}


def _route_times(run, n_profiled_micro: int) -> dict:
    """Items/s of a timed run, and per micro-batch from its profiled tail:
    device launches, device and wall ms, the device's busy share."""
    p = run["profile"]
    return {"items_per_s": run["timed_items"] / run["seconds"],
            "launches_per_micro_batch": p["device_launches"] / n_profiled_micro,
            "device_ms_per_micro_batch": p["device_busy_ms"] / n_profiled_micro,
            "wall_ms_per_micro_batch": p["wall_ms"] / n_profiled_micro,
            "device_busy_share": p["device_busy_share"]}


def phase_scan_route(dev, requests, main_runs, smi) -> dict:
    """``join_impl="scan"`` over phase 3's stream: the strip gate's kernel,
    then batched products over the strips the walk visits.  Held against
    the dense oracle (pairs, scores, row masks, drop and overflow
    counters) and the kernel route (the gate's counters), and timed beside
    both from the same kind of profiled tail."""
    run, launches = _count_launches(lambda: _run_engine(dev, requests, join_impl="scan"))
    _expect_launches("scan route", launches, _n_micro(requests, MICRO), window_joins=False)
    band, score_err = _check_same_emission(run, main_runs["dense"], "scan route vs dense")
    for key in ("pairs_dropped_budget", "pairs_dropped_tile", "window_overflow"):
        if run["stats"][key] != main_runs["dense"]["stats"][key]:
            raise AssertionError(f"scan {key}: {run['stats'][key]} vs dense "
                                 f"{main_runs['dense']['stats'][key]}")
    kern_m = main_runs["kernel"]["metrics"]
    prune = {k: run["metrics"][f"engine/prune/{k}"] for k in PRUNE_KEYS}
    if prune != {k: kern_m[f"engine/prune/{k}"] for k in PRUNE_KEYS}:
        raise AssertionError(f"scan prune counters {prune} differ from the kernel "
                             f"route's")
    n_prof = _n_micro(requests[-2:], MICRO)
    rec = {"phase": "scan_route", "nvidia_smi": smi, "n_items": N_ITEMS,
           "pairs": len(run["pairs"][0]), "band_pairs": len(band),
           "max_score_err": score_err, "launches": launches, "prune": prune,
           "profiled_micro_batches": n_prof,
           **{name: _route_times(r, n_prof)
              for name, r in (("scan", run), ("kernel", main_runs["kernel"]),
                              ("dense", main_runs["dense"]))},
           "stats": run["stats"], "profile": run["profile"]}
    emit(rec)
    return launches


def _groups(pairs) -> list:
    """Connected components (size > 1) of a pair list, sorted, by a plain
    union-find independent of the service's."""
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comp: dict = {}
    for x in list(parent):
        comp.setdefault(find(x), []).append(x)
    return sorted(sorted(v) for v in comp.values() if len(v) > 1)


_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\S+)$")


def _check_prometheus(text: str) -> int:
    """Every line of a Prometheus exposition is a ``# TYPE`` line or a
    sample with a numeric value; returns the number of samples."""
    n = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise AssertionError(f"prometheus_text: unparsable line {line!r}")
        float(m.group(2).replace("Inf", "inf"))
        n += 1
    if not n:
        raise AssertionError("prometheus_text: no samples")
    return n


def _unit_rows(v):
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)


def phase_service(dev, requests, smi) -> dict:
    """``SSSJService(block=64)`` in strict mode (``tile_k`` 64², a raise on
    any drop) on the first ``SERVICE_REQUESTS`` of phase 3's requests of
    4,096, which wrap the ring: its pairs against an engine of the same
    configuration on ``join_impl="dense"``, its groups against those of
    the oracle's pairs,
    its snapshot against ``stats()``; one more window join and the
    concatenation and merge of its candidate buffers with the self join's
    timed on the card (CUDA events around back-to-back calls, and the
    device's own time)."""
    import dataclasses

    import torch
    from repro_torch.kernels.sssj_join import (
        concat_candidates,
        merge_candidates,
        sssj_join_candidates,
    )
    from repro_torch.serving import SSSJService

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    requests = requests[:SERVICE_REQUESTS]
    n_items = sum(len(v) for v, _ in requests)
    svc = SSSJService(theta=THETA, lam=LAM, dim=D, capacity=CAPACITY,
                      block=CONSUMER_BLOCK, device=dev)
    cfg = svc.engine.cfg
    if cfg.tile_k != CONSUMER_BLOCK ** 2 or not svc.strict:
        raise AssertionError(f"service not in strict mode: {cfg}")
    timed, profiled = requests[:-2], requests[-2:]

    def submit_all(reqs):
        return [p for v, t in reqs for p in svc.submit(v, t)]

    def run():
        sync(dev)
        t0 = time.monotonic()
        pairs = submit_all(timed)
        sync(dev)
        seconds = time.monotonic() - t0
        last, prof = _profile(lambda: submit_all(profiled), dev)
        return pairs + last, seconds, prof

    (pairs, seconds, prof), launches = _count_launches(run)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
    _expect_launches("service", launches, _n_micro(requests, CONSUMER_BLOCK))
    # the oracle sees what the service pushed: the rows unit-normalized on
    # the host
    oracle = _run_engine(dev, [(_unit_rows(np.asarray(v, np.float32)), t)
                               for v, t in requests],
                         n_profiled=0, **{**dataclasses.asdict(cfg), "join_impl": "dense"})
    got = _pairs_run(pairs)
    band, score_err = _check_same_emission(got, oracle, "service vs dense")
    st = svc.engine.stats()
    for key in ("pairs_dropped", "window_overflow"):
        if st[key] != oracle["stats"][key]:
            raise AssertionError(f"service {key}: {st[key]} vs dense {oracle['stats'][key]}")
    if svc.stats.n_items != n_items or n_items <= CAPACITY or not pairs:
        raise AssertionError(f"service: the ring did not wrap or nothing emitted: {svc.stats}")
    # groups: the oracle's pairs, with the band pairs as the service drained them
    got_keys = set(zip(*(x.tolist() for x in got["pairs"][:2])))
    svc_band = {k for k in band if k in got_keys}
    want_pairs = [(a, b) for a, b in zip(*(x.tolist() for x in oracle["pairs"][:2]))
                  if (a, b) not in band] + sorted(svc_band)
    groups = svc.duplicate_groups()
    if groups != _groups(want_pairs):
        raise AssertionError("service: duplicate_groups differ from the oracle's")
    snap = svc.snapshot()
    wrong = {k: (snap.get(f"engine/{k}"), v) for k, v in st.items()
             if snap.get(f"engine/{k}") != v}
    if wrong:
        raise AssertionError(f"service snapshot differs from stats(): {wrong}")
    n_samples = _check_prometheus(svc.prometheus_text())

    # one more micro-batch of the window join on the service's window, and
    # the merge of its candidates with the self join's, on the device
    v, t = requests[-1]
    q = torch.from_numpy(_unit_rows(np.asarray(v[-CONSUMER_BLOCK:], np.float32))).to(dev)
    tq = torch.from_numpy(np.asarray(t[-CONSUMER_BLOCK:], np.float32) + 1e-3).to(dev)
    uq = (svc.engine._next_uid
          + torch.arange(CONSUMER_BLOCK, dtype=torch.int32, device=dev))
    state, ckw = svc.engine.state, cfg.candidate_kwargs

    def window_join():
        return sssj_join_candidates(q, state.vecs, tq, state.ts, uq, state.uids,
                                    summary=state.summary, device=dev, **ckw)

    jw = window_join()
    js = sssj_join_candidates(q, q, tq, tq, uq, uq, device=dev, **ckw)

    def merge():   # the step's level-2 merge of both joins' candidates
        return merge_candidates(concat_candidates(jw.cands, js.cands),
                                max_pairs=cfg.max_pairs)

    cand_bytes = sum(x.numel() * x.element_size() for x in jw.cands)
    rec = {"phase": "service", "nvidia_smi": smi, "n_items": n_items,
           "config": dataclasses.asdict(cfg), "strict": svc.strict,
           "timed_items": sum(len(v) for v, _ in timed), "seconds": seconds,
           "items_per_s": sum(len(v) for v, _ in timed) / seconds,
           "dense_items_per_s": oracle["timed_items"] / oracle["seconds"],
           "pairs": len(pairs), "dense_pairs": len(oracle["pairs"][0]),
           "band_pairs": len(band), "max_score_err": score_err,
           "groups": len(groups), "largest_group": max(map(len, groups)),
           "trending_3": len(svc.trending(3)),
           "launches": launches,
           "launches_per_micro_batch": {k: n / _n_micro(requests, CONSUMER_BLOCK)
                                        for k, n in launches.items()},
           "peak_gib": peak_gib, "candidate_buffer_bytes": cand_bytes,
           "candidate_slots": jw.cands.uid_a.numel(),
           "window_join_ms": cuda_ms(window_join, 10),
           "window_join_device_ms": device_ms(window_join, 10),
           "concat_merge_ms": cuda_ms(merge, 20),
           "concat_merge_device_ms": device_ms(merge, 20),
           "prometheus_samples": n_samples, "stats": st,
           "service_stats": dataclasses.asdict(svc.stats),
           "profile": prof,
           "profiled_micro_batches": _n_micro(profiled, CONSUMER_BLOCK)}
    svc.engine.close()
    emit(rec)
    return launches


def phase_blocked(dev, requests, main_runs, smi) -> dict:
    """``BlockedStreamJoiner`` at the main path's 128 x 128 tiles, so
    ``tile_k`` 128², pushing phase 3's requests and draining each at once:
    its pairs against phase 3's dense oracle."""
    from repro_torch.core.blocked import BlockedJoinConfig, BlockedStreamJoiner

    bj = BlockedStreamJoiner(BlockedJoinConfig(theta=THETA, lam=LAM, capacity=CAPACITY,
                                               d=D), device=dev)
    if bj.engine.cfg.tile_k != 128 * 128 or bj.engine.cfg.join_impl is not None:
        raise AssertionError(f"blocked joiner config: {bj.engine.cfg}")

    def run():
        sync(dev)
        t0 = time.monotonic()
        pairs = [p for v, t in requests for p in bj.push(v, t)]
        sync(dev)
        return pairs, time.monotonic() - t0

    (pairs, seconds), launches = _count_launches(run)
    _expect_launches("blocked", launches, _n_micro(requests, MICRO))
    band, score_err = _check_same_emission(_pairs_run(pairs), main_runs["dense"],
                                           "blocked vs dense")
    st = bj.engine.stats()
    if st["pairs_dropped"] or st["window_overflow"] != main_runs["dense"]["stats"][
            "window_overflow"] or st["n_items"] != N_ITEMS:
        raise AssertionError(f"blocked joiner dropped or overflowed: {st}")
    kst = main_runs["kernel"]["stats"]
    rec = {"phase": "blocked", "nvidia_smi": smi, "n_items": N_ITEMS,
           "tile_k": bj.engine.cfg.tile_k, "seconds": seconds,
           "items_per_s": N_ITEMS / seconds, "pairs": len(pairs),
           "band_pairs": len(band), "max_score_err": score_err, "launches": launches,
           "chunks_executed": bj.chunks_executed, "tiles_total": bj.tiles_total,
           "kernel_route_chunks_executed": kst["chunks_executed"],
           "kernel_route_tiles_total": kst["tiles_total"], "stats": st}
    bj.engine.close()
    emit(rec)
    return launches


def _near_theta_rows(engine, tokens, rows, uid0: int, t: float) -> dict:
    """For the documents ``rows`` of a batch the filter ``engine`` has just
    taken (first uid ``uid0``, time ``t``): each one's best exact (f64)
    decayed score against the older items of the window, where that score
    lies within ``BAND`` of θ.  A keep decision may differ between two f32
    joins only on such a row."""
    import torch

    from repro_torch.data import hashing_embed

    cfg, st = engine.cfg, engine.state
    # the window rows the decay leaves a chance: exp(-λ Δt) ≥ θ - BAND
    reach = -math.log(cfg.theta - BAND) / cfg.lam
    near = torch.nonzero((st.uids >= 0) & ((st.ts.double() - t).abs() <= reach))[:, 0]
    w = st.vecs[near].double()
    q = torch.from_numpy(hashing_embed(tokens[rows], cfg.d)).to(w.device, torch.float64)
    dec = (q @ w.T) * torch.exp(-cfg.lam * (st.ts[near].double() - t).abs())[None, :]
    older = st.uids[near][None, :] < torch.as_tensor(uid0 + rows, device=w.device)[:, None]
    best = torch.where(older, dec, -math.inf).amax(1).tolist()
    return {int(r): b for r, b in zip(rows, best) if abs(b - cfg.theta) <= BAND}


def phase_dedup(dev, smi) -> dict:
    """``TokenPipeline`` with ``DedupFilter(dim=1024, capacity=65536,
    block=64)`` for ``PIPELINE_STEPS`` steps, so that the filter's ring
    wraps, in lockstep with the same pipeline whose filter's engine runs
    ``join_impl="dense"``.  Each step's keep-masks must be equal outside
    the documents whose best exact score lies within ``BAND`` of θ; on
    those the oracle's pipeline takes the kernel route's decision, so
    that both go on with the same documents.  The batches must be equal,
    and planted duplicates must be dropped.  The batches are compared
    step by step and not kept (2 GB of tokens each)."""
    import dataclasses

    from repro_torch.data import DedupFilter, TokenPipeline
    from repro_torch.engine import StreamEngine

    band = []   # (step, document, best exact score) where the masks differ

    def pipeline(dense: bool, kern_rec=None):
        filt = DedupFilter(dim=D, capacity=PIPELINE_CAPACITY, block=CONSUMER_BLOCK,
                           device=dev)
        if dense:
            filt.engine.close()
            filt.engine = StreamEngine(dataclasses.replace(filt.cfg, join_impl="dense"),
                                       device=dev)
        rec = {"masks": [], "filter_s": 0.0, "seconds": 0.0}
        inner = filt.filter

        def recording(tokens, ts):
            uid0 = filt.engine._next_uid
            t0 = time.monotonic()
            keep = inner(tokens, ts)
            rec["filter_s"] += time.monotonic() - t0
            rec["masks"].append(keep.copy())
            if kern_rec is not None:
                theirs = kern_rec["masks"][len(rec["masks"]) - 1]
                rows = np.nonzero(keep != theirs)[0]
                if rows.size:
                    near = _near_theta_rows(filt.engine, tokens, rows, uid0, float(ts[0]))
                    if len(near) < rows.size:
                        raise AssertionError(
                            f"dedup step {len(rec['masks']) - 1}: keep-masks differ "
                            f"outside the ε-band at "
                            f"{sorted(set(rows.tolist()) - set(near))[:10]}")
                    band.extend((len(rec["masks"]) - 1, r, b) for r, b in near.items())
                    keep = theirs.copy()
            return keep

        filt.filter = recording
        return TokenPipeline(dedup=filt, seed=SEED, **PIPELINE), rec

    def step(pipe, rec):
        t0 = time.monotonic()
        tokens = pipe.next_batch()["tokens"]
        rec["seconds"] += time.monotonic() - t0
        return tokens

    kern_pipe, kern = pipeline(False)
    dense_pipe, dense = pipeline(True, kern)
    launches = dict.fromkeys(_launch_counters(), 0)
    for i in range(PIPELINE_STEPS):
        # the counters are read around the filtered pipeline's step alone
        tokens, got = _count_launches(lambda: step(kern_pipe, kern))
        for name, n in got.items():
            launches[name] += n
        if not np.array_equal(tokens, step(dense_pipe, dense)):
            raise AssertionError(f"dedup step {i}: the pipelines' batches differ")
    n_micro = PIPELINE_STEPS * -(-PIPELINE["batch"] // CONSUMER_BLOCK)
    _expect_launches("dedup", launches, n_micro)
    filt = kern_pipe.dedup
    if not filt.n_seen > PIPELINE_CAPACITY:
        raise AssertionError(f"dedup: {filt.n_seen} documents never wrap the ring")
    if not filt.n_dropped > 0:
        raise AssertionError("dedup: no planted duplicate was dropped")
    filt.engine.close()
    dense_pipe.dedup.engine.close()
    docs = PIPELINE_STEPS * PIPELINE["batch"]
    rec = {"phase": "dedup", "nvidia_smi": smi, "pipeline": PIPELINE,
           "steps": PIPELINE_STEPS, "documents": docs, "capacity": PIPELINE_CAPACITY,
           "ring_wrapped": True, "dropped": filt.n_dropped,
           "oracle_dropped": dense_pipe.dedup.n_dropped,
           "band_documents": [{"step": a, "document": r, "score": b} for a, r, b in band],
           "dropped_per_step_first": [int((~m).sum()) for m in kern["masks"][:12]],
           "seconds": kern["seconds"], "docs_per_s": docs / kern["seconds"],
           "filter_s": kern["filter_s"], "filter_docs_per_s": docs / kern["filter_s"],
           "dense_docs_per_s": docs / dense["seconds"], "launches": launches}
    emit(rec)
    return launches


# --------------------------------------------------------------------- #
# phases 4e-4g: the multi-tenant runtime and service
# --------------------------------------------------------------------- #
# 64 tenants: θ cycles over (0.9, 0.95), λ over (1e-3, 2e-3, 4e-3), so the
# table is not uniform and tenant 6 repeats tenant 0's (θ, λ); each tenant
# streams at 1/64 of the main path's rate, so together they make its rate;
# half the main path's window, and half the items a tenant, keep the four
# host-paced runs of 4e in the script's time while each tenant's 2,048
# slots still hold its ~1,650 items of horizon and its 2,560 items wrap them
MT_TENANTS = 64
MT_THETAS = tuple((0.9, 0.95)[k % 2] for k in range(MT_TENANTS))
MT_LAMS = tuple((1e-3, 2e-3, 4e-3)[k % 3] for k in range(MT_TENANTS))
MT_PER_TENANT = 2560
MT_CAPACITY = CAPACITY // 2
MT_TWIN = (0, 6)           # tenant 6 streams tenant 0's seed: identical items
MT_SPAN = 4
MT_FLUSH_ROWS = 512        # flush() every 512 admitted items
MT_DRAIN_FLUSHES = 8       # drain_by_tenant() every 8 flushes
MT_PROFILED_FLUSHES = 16   # the profiled tail
# quota isolation: one bursty tenant (θ 0.9, λ 2, 64 slots, fewer than a
# micro-batch) beside 7 slow ones (θ 0.8, λ 0.002, τ ≈ 112) that repost
# once every 60 time units: consecutive reposts pair at ≈ 0.886, the
# next-but-one at ≈ 0.786
ISO_THETAS = (0.9,) + (0.8,) * 7
ISO_LAMS = (2.0,) + (0.002,) * 7
ISO_QUOTAS = (64,) + (2330,) * 6 + (2340,)
ISO_CAPACITY = 16384
ISO_TRAFFIC = dict(n_slow=7, rounds=6, burst=17000, d=D, repost_gap=60.0)
# the multi-tenant service at 256-wide tiles: the first items of 4e's stream
# (a quarter of it keeps the script's time in bounds; each tenant's 1,024
# items still fill 4 strips of its sub-ring)
SVC_MT_MICRO = 256
SVC_MT_ITEMS = 65536
# the sharded engine (4h-4j): the main path's window as four shards of
# 65,536 slots on one card; the ring join's global batch of 512 (128 rows a
# shard), RING_WARM steps to fill every ring, then RING_STEPS held against
# their oracles; the sharded service at micro-batch 128 on a prefix of 4e's
# stream short enough to keep the phase near 40 s
SHARDS = 4
RING_BATCH = 512
RING_WARM = CAPACITY // RING_BATCH
RING_STEPS = 4
SHARD_SVC_MICRO = 128
SHARD_SVC_ITEMS = 32768
# 4h runs the first 20 of phase 3's 80 requests (81,920 items): the
# script's time (the LM phases of 4p-4r came in) cut its host-paced run
SHARD_REQUESTS = 20


def _mt_stream():
    """Phase 4e's traffic: tenant k's ``dense_embedding_stream(2560, 1024,
    seed=k, rate=1000/64)`` (tenant 6 with tenant 0's seed), merged by
    timestamp (ties by tenant).  Returns ``(vecs (n, d), ts (n,), tenant
    (n,))`` in merged order."""
    from repro_torch.data import dense_embedding_stream

    vs, ts, ks = [], [], []
    for k in range(MT_TENANTS):
        seed = MT_TWIN[0] if k == MT_TWIN[1] else k
        v, t = dense_embedding_stream(MT_PER_TENANT, D, seed=seed,
                                      rate=RATE / MT_TENANTS)
        vs.append(v)
        ts.append(t)
        ks.append(np.full(MT_PER_TENANT, k, np.int32))
    t_all, k_all = np.concatenate(ts), np.concatenate(ks)
    order = np.lexsort((k_all, t_all))
    return np.concatenate(vs)[order], t_all[order], k_all[order]


def _submits(vecs, ts, tenant):
    """One ``submit`` per run of one tenant's consecutive items."""
    cut = np.flatnonzero(np.diff(tenant)) + 1
    bounds = zip(np.concatenate([[0], cut]), np.concatenate([cut, [len(tenant)]]))
    return [(int(tenant[a]), vecs[a:b], ts[a:b]) for a, b in bounds]


def _flush_groups(submits, flush_rows: int) -> list:
    """The submits between two flushes: a flush follows the submit that
    brings the items admitted since the last flush to ``flush_rows``."""
    groups, start, rows = [], 0, 0
    for i, (_, v, _) in enumerate(submits):
        rows += len(v)
        if rows >= flush_rows:
            groups.append(submits[start:i + 1])
            start, rows = i + 1, 0
    if start < len(submits):
        groups.append(submits[start:])
    return groups


def _run_runtime(dev, rt, submits, n_profiled=MT_PROFILED_FLUSHES,
                 flush_rows=MT_FLUSH_ROWS, drain_flushes=MT_DRAIN_FLUSHES):
    """Drive ``rt``: ``flush()`` whenever ``flush_rows`` more items were
    admitted, ``drain_by_tenant(return_masks=True)`` every ``drain_flushes``
    flushes, ``flush(final=True)`` and a drain at the end.  All but the
    last ``n_profiled`` flushes are timed (host clock, ending in a device
    sync), those under the profiler.  Returns each tenant's drained
    ``(uid_a, uid_b, score, mask)``, the times and ``stats()``."""
    import torch

    n_t = rt.table.n_tenants
    got = {k: [] for k in range(n_t)}
    groups = _flush_groups(submits, flush_rows)

    def drain():
        for k, rec in rt.drain_by_tenant(return_masks=True).items():
            got[k].append(rec)

    def run(lo, hi, final):
        for i in range(lo, hi):
            for k, v, t in groups[i]:
                rt.submit(k, v, t)
            rt.flush()
            if (i + 1) % drain_flushes == 0:
                drain()
        if final:
            rt.flush(final=True)
        drain()

    _reset_peak(dev)
    n_timed = len(groups) - n_profiled
    t0 = time.monotonic()
    run(0, n_timed, final=not n_profiled)
    sync(dev)
    seconds = time.monotonic() - t0
    # latency and queue delay of the timed part alone: rows left queued
    # when it ends wait through the profiler's start
    latency_timed = _latency(rt.registry.snapshot())
    timed_items = sum(len(v) for g in groups[:n_timed] for _, v, _ in g)
    prof, n_prof_micro = None, 0
    if n_profiled:
        spans0 = rt.spans_dispatched
        _, prof = _profile(lambda: run(n_timed, len(groups), final=True), dev)
        n_prof_micro = (rt.spans_dispatched - spans0) * rt.span
    peak_gib = _peak_gib(dev)
    per = {k: tuple(np.concatenate(x) for x in zip(*recs)) for k, recs in got.items()}
    snap = rt.registry.snapshot()
    out = {"per": per, "seconds": seconds, "timed_items": timed_items,
           "latency_timed": latency_timed,
           "items_per_s": timed_items / seconds, "profile": prof,
           "profiled_micro_batches": n_prof_micro, "peak_gib": peak_gib,
           "stats": rt.stats(), "snapshot": snap,
           "micro_batches": rt.spans_dispatched * rt.span}
    if prof is not None:
        out["per_micro_batch"] = {
            "launches": prof["device_launches"] / n_prof_micro,
            "device_ms": prof["device_busy_ms"] / n_prof_micro,
            "wall_ms": prof["wall_ms"] / n_prof_micro,
            "device_busy_share": prof["device_busy_share"]}
    rt.close()
    return out


def _check_tenants(a, b, thetas, label) -> dict:
    """Two runtime runs over one stream: each tenant's pairs, scores and
    masks as ``_check_same_emission`` holds an engine run, at that
    tenant's θ.  Returns the band pairs by tenant and the largest score
    error."""
    band, err = {}, 0.0
    for k, theta in enumerate(thetas):
        runs = [{"pairs": r["per"][k][:3], "mask": r["per"][k][3]} for r in (a, b)]
        bk, ek = _check_same_emission(*runs, f"{label} tenant {k}", theta=theta)
        if bk:
            band[k] = bk
        err = max(err, ek)
    return {"band": band, "max_score_err": err}


def _check_runtime_stats(a, b, label) -> None:
    """Drop and overflow counters, per tenant too, equal between runs."""
    for key in ("pairs_dropped_budget", "pairs_dropped_tile", "window_overflow",
                "window_overflow_by_tenant", "n_items"):
        if a["stats"][key] != b["stats"][key]:
            raise AssertionError(f"{label} {key}: {a['stats'][key]} vs {b['stats'][key]}")


def _runtime(dev, cfg_kw, thetas, lams, **over):
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import MultiTenantRuntime, TenantTable

    return MultiTenantRuntime(EngineConfig(**{**cfg_kw, **over}),
                              TenantTable(thetas, lams), span=MT_SPAN, device=dev)


def _latency(snap) -> dict:
    from repro_torch.obs import histogram_percentile

    h = snap["latency/admit_to_emit_s"]
    return {"admit_to_emit_p50_s": histogram_percentile(h, 0.5),
            "admit_to_emit_p99_s": histogram_percentile(h, 0.99),
            "admit_to_emit_mean_s": h["sum"] / max(h["count"], 1),
            "observed": h["count"],
            "queue_delay_max_s": snap["router/queue_delay_max_s"]}


def _span_fill_cost(dev, rt) -> dict:
    """What one span-fill micro-batch (no valid row, every strip dead)
    costs on ``rt``'s configuration: spans of fill micro-batches only,
    dispatched on a fresh runtime after one warm-up span; host clock over
    4 spans ending in a device sync, and one more span under the
    profiler."""
    empty = (np.zeros((0, rt.cfg.d), np.float32), np.zeros(0), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0))
    n = rt.span
    rt._dispatch(*empty)
    rt.drain_arrays()
    sync(dev)
    t0 = time.monotonic()
    for _ in range(4):
        rt._dispatch(*empty)
    rt.drain_arrays()
    sync(dev)
    wall = (time.monotonic() - t0) / (4 * n)
    _, prof = _profile(lambda: (rt._dispatch(*empty), rt.drain_arrays()), dev)
    rt.close()
    return {"wall_ms_per_micro_batch": 1e3 * wall,
            "device_ms_per_micro_batch": prof["device_busy_ms"] / n,
            "launches_per_micro_batch": prof["device_launches"] / n}


def _runtime_rec(run) -> dict:
    """A run's numbers for the phase line."""
    st = run["stats"]
    return {"items_per_s": run["items_per_s"], "seconds": run["seconds"],
            "timed_items": run["timed_items"], "peak_gib": run["peak_gib"],
            "micro_batches": run["micro_batches"],
            "span_fill_micro_batches": st["empty_micro_batches"],
            "padded_rows": st["padded_rows"],
            "per_micro_batch": run.get("per_micro_batch"),
            "port_kernels": (run["profile"] or {}).get("port_kernels"),
            "pairs": sum(len(x[0]) for x in run["per"].values()),
            "latency": _latency(run["snapshot"]), "latency_timed": run["latency_timed"]}


def phase_runtime(dev, smi, stream, gen_s: float) -> dict:
    """4e: ``MultiTenantRuntime`` at half the main path's window, its width,
    with 64 tenants under quota eviction (each tenant's 2,048 slots hold
    its ~1,650 items of horizon, and its own 2,560 items wrap its sub-ring),
    held against the same runtime on ``join_impl="dense"``; then the
    kernel route again under ``dead`` and ``oldest`` eviction, whose pairs
    must be the quota run's (nothing is overwritten)."""
    from repro_torch.engine.window import quota_partition

    vecs, ts, tenant = stream
    submits = _submits(vecs, ts, tenant)
    cfg = dict(theta=THETA, lam=LAM, capacity=MT_CAPACITY, d=D, micro_batch=MICRO,
               eviction="quota", quotas=quota_partition(MT_CAPACITY, [1.0] * MT_TENANTS))
    kern, launches = _count_launches(
        lambda: _run_runtime(dev, _runtime(dev, cfg, MT_THETAS, MT_LAMS), submits))
    _expect_launches("runtime", launches, kern["micro_batches"])
    dense = _run_runtime(dev, _runtime(dev, cfg, MT_THETAS, MT_LAMS, join_impl="dense"),
                         submits, n_profiled=0)
    chk = _check_tenants(kern, dense, MT_THETAS, "runtime vs dense")
    _check_runtime_stats(kern, dense, "runtime vs dense")
    st = kern["stats"]
    if st["n_items"] != len(vecs) or any(st["window_overflow_by_tenant"]):
        raise AssertionError(f"runtime: items or overflow {st}")
    # every pair within one tenant; tenant 6's pairs are tenant 0's
    local = np.zeros(len(tenant), np.int64)
    for k in range(MT_TENANTS):
        sel = tenant == k
        local[sel] = np.arange(int(sel.sum()))
    for k, (ua, ub, _, _) in kern["per"].items():
        if not ((tenant[ua] == k).all() and (tenant[ub] == k).all()):
            raise AssertionError(f"runtime: tenant {k} drained another tenant's pair")
    twin = [{"pairs": (local[r[0]], local[r[1]], r[2]), "mask": r[3]}
            for r in (kern["per"][MT_TWIN[0]], kern["per"][MT_TWIN[1]])]
    _check_same_emission(*twin, "runtime: tenants 0 and 6 in local uids",
                         theta=MT_THETAS[0])
    if not len(twin[0]["pairs"][0]):
        raise AssertionError("runtime: tenant 0 emitted nothing")
    # the other policies on the same traffic: no overwrite, so the same pairs
    others = {}
    for eviction in ("dead", "oldest"):
        run, n = _count_launches(lambda: _run_runtime(
            dev, _runtime(dev, cfg, MT_THETAS, MT_LAMS, eviction=eviction, quotas=None),
            submits, n_profiled=0))
        _expect_launches(f"runtime {eviction}", n, run["micro_batches"])
        c = _check_tenants(run, kern, MT_THETAS, f"runtime {eviction} vs quota")
        _check_runtime_stats(run, kern, f"runtime {eviction} vs quota")
        others[eviction] = {"items_per_s": run["items_per_s"], "launches": n,
                            "band_pairs": sum(map(len, c["band"].values()))}
    fill = _span_fill_cost(dev, _runtime(dev, cfg, MT_THETAS, MT_LAMS))
    rec = {"phase": "runtime", "nvidia_smi": smi, "n_items": len(vecs), "gen_s": gen_s,
           "span_fill_cost": fill,
           "tenants": MT_TENANTS, "submits": len(submits), "capacity": MT_CAPACITY, "d": D,
           "quota": cfg["quotas"][0], "launches": launches, **_runtime_rec(kern),
           "dense_items_per_s": dense["items_per_s"],
           "band_pairs": sum(map(len, chk["band"].values())),
           "max_score_err": chk["max_score_err"], "twin_pairs": len(twin[0]["pairs"][0]),
           "other_policies": others, "stats": st, "profile": kern["profile"]}
    emit(rec)
    return launches


def phase_isolation(dev, smi) -> dict:
    """4f: the quota isolation invariant at full width.  A bursty tenant
    floods 17,000 items a round into a 16,384-slot ring beside 7 slow
    tenants reposting once a round: under ``quota`` every slow tenant's
    pairs equal the exact (f64) truth, 5 each, none of its items is
    overwritten, and the bursty tenant's 64 slots (fewer than a
    micro-batch) evict its own; the lanes equal the dense oracle's.  Under
    ``oldest`` on the same traffic the slow tenants lose pairs and
    items."""
    from repro_torch.data import bursty_tenant_traffic

    submits, per_tenant = bursty_tenant_traffic(**ISO_TRAFFIC)
    truth = []
    for k, (v, t) in enumerate(per_tenant):
        if k == 0:
            truth.append(None)      # the flood's own pairs are not held to a truth
            continue
        v = v.astype(np.float64)
        dec = (v @ v.T) * np.exp(-ISO_LAMS[k] * np.abs(t[:, None] - t[None, :]))
        i, j = np.nonzero(np.tril(dec >= ISO_THETAS[k], -1))
        truth.append(set(zip(j.tolist(), i.tolist())))
    tenant = np.concatenate([np.full(len(v), k, np.int32) for k, v, _ in submits])
    local = np.zeros(len(tenant), np.int64)
    for k in range(len(ISO_THETAS)):
        local[tenant == k] = np.arange(int((tenant == k).sum()))
    cfg = dict(theta=0.8, lam=0.002, capacity=ISO_CAPACITY, d=D, micro_batch=MICRO,
               eviction="quota", quotas=ISO_QUOTAS)
    # flush after every submit (rows short of a micro-batch wait), drain
    # every round; the kernel route's last round under the profiler
    n_round = ISO_TRAFFIC["n_slow"] + 1
    kw = dict(n_profiled=0, flush_rows=1, drain_flushes=n_round)
    quota, launches = _count_launches(lambda: _run_runtime(
        dev, _runtime(dev, cfg, ISO_THETAS, ISO_LAMS), submits,
        **dict(kw, n_profiled=n_round)))
    _expect_launches("isolation", launches, quota["micro_batches"])
    dense = _run_runtime(dev, _runtime(dev, cfg, ISO_THETAS, ISO_LAMS, join_impl="dense"),
                         submits, **kw)
    chk = _check_tenants(quota, dense, ISO_THETAS, "isolation vs dense")
    _check_runtime_stats(quota, dense, "isolation vs dense")
    oldest, n_old = _count_launches(lambda: _run_runtime(
        dev, _runtime(dev, cfg, ISO_THETAS, ISO_LAMS, eviction="oldest", quotas=None),
        submits, **kw))

    def local_pairs(run, k):
        ua, ub = run["per"][k][:2]
        return set(zip(local[ub].tolist(), local[ua].tolist()))

    sq, so = quota["stats"], oldest["stats"]
    slow = range(1, len(ISO_THETAS))
    for k in slow:
        if len(truth[k]) != ISO_TRAFFIC["rounds"] - 1 or local_pairs(quota, k) != truth[k]:
            raise AssertionError(f"isolation: slow tenant {k} under quota drained "
                                 f"{sorted(local_pairs(quota, k))}, truth {sorted(truth[k])}")
    by_q, by_o = sq["window_overflow_by_tenant"], so["window_overflow_by_tenant"]
    if (any(by_q[1:]) or not by_q[0] or sum(by_q) != sq["window_overflow"]
            or sum(by_o) != so["window_overflow"]):
        raise AssertionError(f"isolation: quota overflow by tenant {by_q}, oldest {by_o}")
    lost = {k: len(truth[k] - local_pairs(oldest, k)) for k in slow}
    if not (all(by_o[1:]) and any(lost.values())):
        raise AssertionError(f"isolation: oldest eviction spared the slow tenants: "
                             f"overflow {by_o}, lost pairs {lost}")
    fill = _span_fill_cost(dev, _runtime(dev, cfg, ISO_THETAS, ISO_LAMS))
    rec = {"phase": "isolation", "nvidia_smi": smi, "n_items": len(tenant),
           "span_fill_cost": fill,
           "traffic": ISO_TRAFFIC, "quotas": ISO_QUOTAS, "launches": launches,
           "quota": _runtime_rec(quota), "dense_items_per_s": dense["items_per_s"],
           "oldest": {"items_per_s": oldest["items_per_s"], "launches": n_old,
                      "window_overflow_by_tenant": by_o, "slow_pairs_lost": lost},
           "window_overflow_by_tenant": by_q,
           "slow_pairs": {k: len(truth[k]) for k in slow},
           "band_pairs": sum(map(len, chk["band"].values())),
           "max_score_err": chk["max_score_err"], "stats": sq}
    emit(rec)
    return launches


def _local_pairs(run, tenant) -> dict:
    """A runtime run's pairs per tenant as ``{(a, b): score}`` in the
    tenant's local uids (its items numbered in admission order)."""
    local = np.zeros(len(tenant), np.int64)
    for k in np.unique(tenant).tolist():
        local[tenant == k] = np.arange(int((tenant == k).sum()))
    return {k: {(int(local[a]), int(local[b])): float(s)
                for a, b, s in zip(*(x.tolist() for x in rec[:3]))}
            for k, rec in run["per"].items()}


def _check_service_groups(label, svc, pairs, want, thetas) -> tuple:
    """A multi-tenant service's flushed pairs (``{tenant: [(a, b, score)]}``
    in local uids) against another run's (``{tenant: {(a, b): score}}``):
    equal outside the ε-band of each tenant's θ, common scores within
    ``FLOAT_TOL``, and the service's groups those of the other run's
    pairs with the band pairs as the service drained them.  Returns the
    band documents by tenant, the band pairs, the largest score error and
    the groups."""
    band_docs, n_band, err, n_groups = {}, 0, 0.0, 0
    for k, theta in enumerate(thetas):
        got = {(a, b): s for a, b, s in pairs.get(k, [])}
        w = want.get(k, {})
        differ = got.keys() ^ w.keys()
        outside = [p for p in differ if abs({**got, **w}[p] - theta) > BAND]
        if outside:
            raise AssertionError(f"{label} tenant {k}: pairs differ outside the "
                                 f"ε-band: {outside[:5]}")
        err = max([err] + [abs(got[p] - w[p]) for p in got.keys() & w.keys()])
        n_band += len(differ)
        want_groups = _groups([p for p in w if p not in differ]
                              + [p for p in got if p in differ])
        if svc.duplicate_groups(k) != want_groups:
            raise AssertionError(f"{label} tenant {k}: groups differ from the other run's")
        if differ:
            band_docs[k] = sorted({x for p in differ for x in p})
        n_groups += len(want_groups)
    if err > FLOAT_TOL:
        raise AssertionError(f"{label}: scores differ by {err}")
    return band_docs, n_band, err, n_groups


def phase_mt_service(dev, smi, stream) -> dict:
    """4g: ``MultiTenantSSSJService(micro_batch=256)`` (256 x 256 tiles:
    ``cand_big_kernel``), strict ``tile_k`` 65,536, quota eviction, on the
    first ``SVC_MT_ITEMS`` items of 4e's stream, flushed whenever a span's
    rows (1,024) were admitted, the last ``MT_PROFILED_FLUSHES // 2``
    flushes under the profiler: its groups per tenant against those of a
    ``join_impl="dense"`` runtime of the same configuration (outside
    documents with band pairs), its snapshot's names and kinds against
    ``tests/metrics_schema.json``; then one more window join on its
    window, timed on the device (``cand_big_kernel`` alone)."""
    import dataclasses

    import torch
    from repro_torch.kernels.sssj_join import sssj_join_candidates
    from repro_torch.runtime import MultiTenantRuntime, TenantTable
    from repro_torch.serving import MultiTenantSSSJService

    vecs, ts, tenant = (x[:SVC_MT_ITEMS] for x in stream)
    submits = _submits(vecs, ts, tenant)
    table = TenantTable(MT_THETAS, MT_LAMS)
    _reset_peak(dev)
    svc = MultiTenantSSSJService(table, dim=D, capacity=CAPACITY, span=MT_SPAN,
                                 micro_batch=SVC_MT_MICRO, eviction="quota", device=dev)
    cfg = svc.runtime.cfg
    if cfg.tile_k != SVC_MT_MICRO ** 2 or cfg.block_q != SVC_MT_MICRO:
        raise AssertionError(f"service config: {cfg}")
    groups = _flush_groups(submits, SVC_MT_MICRO * MT_SPAN)
    n_prof = MT_PROFILED_FLUSHES // 2
    pairs = {k: [] for k in range(MT_TENANTS)}

    def run(lo, hi, final):
        for g in groups[lo:hi]:
            for k, v, t in g:
                svc.submit(k, v, t)
            for k, ps in svc.flush(final=final).items():
                pairs[k].extend(ps)

    def go():
        sync(dev)
        t0 = time.monotonic()
        run(0, len(groups) - n_prof, False)
        sync(dev)
        seconds = time.monotonic() - t0
        spans0 = svc.runtime.spans_dispatched
        _, prof = _profile(lambda: run(len(groups) - n_prof, len(groups), True), dev)
        return seconds, prof, (svc.runtime.spans_dispatched - spans0) * MT_SPAN

    (seconds, prof, n_prof_micro), launches = _count_launches(go)
    peak_gib = _peak_gib(dev)
    st = svc.stats()
    _expect_launches("mt_service", launches, st["spans_dispatched"] * MT_SPAN)
    timed_items = sum(len(v) for g in groups[:-n_prof] for _, v, _ in g)
    # the oracle sees what the service pushed: the rows unit-normalized on
    # the host
    oracle = _run_runtime(
        dev, MultiTenantRuntime(dataclasses.replace(cfg, join_impl="dense"), table,
                                span=MT_SPAN, device=dev),
        [(k, _unit_rows(np.asarray(v, np.float32)), t) for k, v, t in submits],
        n_profiled=0, flush_rows=SVC_MT_MICRO * MT_SPAN)
    band_docs, n_band, err, n_groups = _check_service_groups(
        "mt_service", svc, pairs, _local_pairs(oracle, tenant), MT_THETAS)
    with open(ROOT / "tests" / "metrics_schema.json") as f:
        pinned = json.load(f)
    schema = {re.sub(r"tenant/\d+/", "tenant/<k>/", k): v
              for k, v in svc.registry.schema().items()}
    if schema != pinned:
        raise AssertionError(f"mt_service snapshot names: {sorted(schema.keys() ^ pinned.keys())}")
    n_samples = _check_prometheus(svc.prometheus_text())
    if st["pairs_dropped"] or st["window_overflow"] or not n_groups:
        raise AssertionError(f"mt_service dropped, overflowed or grouped nothing: {st}")

    # one more micro-batch's window join on the service's window, with the
    # runtime's lanes: cand_big_kernel on the device alone
    state, ckw = svc.runtime.state, cfg.candidate_kwargs
    q = torch.from_numpy(_unit_rows(np.asarray(vecs[-SVC_MT_MICRO:], np.float32))).to(dev)
    tq = torch.from_numpy(np.asarray(ts[-SVC_MT_MICRO:], np.float32) + 1e-3).to(dev)
    uq = svc.runtime._next_uid + torch.arange(SVC_MT_MICRO, dtype=torch.int32, device=dev)
    sq = torch.from_numpy(tenant[-SVC_MT_MICRO:]).to(dev)
    th_q, lam_q = table.lookup(sq)

    def window_join():
        return sssj_join_candidates(q, state.vecs, tq, state.ts, uq, state.uids,
                                    summary=state.summary, sq=sq, sw=state.sids,
                                    theta_q=th_q, lam_q=lam_q, device=dev, **ckw)

    jw = window_join()
    sync(dev)
    fill = _span_fill_cost(dev, MultiTenantRuntime(cfg, table, span=MT_SPAN, device=dev))
    rec = {"phase": "mt_service", "nvidia_smi": smi, "n_items": len(vecs),
           "span_fill_cost": fill,
           "micro_batch": SVC_MT_MICRO, "tile_k": cfg.tile_k, "seconds": seconds,
           "timed_items": timed_items, "items_per_s": timed_items / seconds,
           "peak_gib": peak_gib, "dense_items_per_s": oracle["items_per_s"],
           "launches": launches, "micro_batches": st["spans_dispatched"] * MT_SPAN,
           "span_fill_micro_batches": st["empty_micro_batches"],
           "per_micro_batch": {
               "launches": prof["device_launches"] / n_prof_micro,
               "device_ms": prof["device_busy_ms"] / n_prof_micro,
               "wall_ms": prof["wall_ms"] / n_prof_micro,
               "device_busy_share": prof["device_busy_share"]},
           "profiled_micro_batches": n_prof_micro, "port_kernels": prof["port_kernels"],
           "window_join_live_tiles": int((jw.iters > 0).sum()),
           "window_join_ms": cuda_ms(window_join, 5),
           "cand_big_kernel_window_device_ms": device_ms(window_join, 5, "::cand_big"),
           "pairs": sum(map(len, pairs.values())), "groups": n_groups,
           "band_pairs": n_band, "band_documents": band_docs, "max_score_err": err,
           "prometheus_samples": n_samples, "latency": _latency(svc.snapshot()),
           "stats": st, "profile": prof}
    svc.runtime.close()
    emit(rec)
    return launches


# --------------------------------------------------------------------- #
# phases 4h-4j: the sharded engine on a single-process mesh
# --------------------------------------------------------------------- #
def _shard_mesh(dev):
    """``SHARDS`` window shards over the visible cards (``cuda:i % n``;
    with one card all four share it), or over the CPU in a rehearsal."""
    import torch
    from repro_torch.launch import make_mesh_for

    if dev.type == "cuda":
        n = torch.cuda.device_count()
        devices = [f"cuda:{i % n}" for i in range(SHARDS)]
    else:
        devices = [dev] * SHARDS
    mesh = make_mesh_for((SHARDS,), ("data",), devices=devices)
    return mesh, [str(d) for d in mesh.devices_along("data")]


def _reset_peak(dev) -> None:
    """Reset the peak-memory reading.  An engine is freed by the cycle
    collector (its registry holds its collector): earlier runs' windows
    are collected first."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None


def _run_prefix(run, n_items: int) -> dict:
    """An engine run's pairs and row masks over its first ``n_items``
    items: the pairs whose newer item is one of them."""
    ua, ub, sc = run["pairs"]
    first = ua < n_items
    return {"pairs": (ua[first], ub[first], sc[first]), "mask": run["mask"][:n_items]}


def phase_sharded_engine(dev, smi, requests, kern_run) -> dict:
    """4h: ``ShardedStreamEngine`` with four shards of 65,536 slots (phase
    3's global window) on the first ``SHARD_REQUESTS`` requests of phase
    3's stream: its drained pairs, scores and row masks must be those of
    phase 3's kernel route over the same items (outside the ε-band),
    with nothing dropped or overwritten, and the shards' cursors, live
    slots and overflow must sum to those of one ring that took the
    prefix (no ring wraps: each of them the prefix's items, overflow 0)."""
    from repro_torch.engine import EngineConfig, ShardedStreamEngine

    t0 = time.monotonic()
    requests = requests[:SHARD_REQUESTS]
    n_items = sum(len(v) for v, _ in requests)
    if n_items > CAPACITY:
        raise ValueError("4h's prefix must not wrap phase 3's ring")
    mesh, placement = _shard_mesh(dev)
    cfg = EngineConfig(theta=THETA, lam=LAM, capacity=CAPACITY // SHARDS, d=D,
                       micro_batch=MICRO)
    _reset_peak(dev)
    # one request under the profiler: a trace of four shards' launches
    # takes the profiler far longer to digest than phase 3's
    run, launches = _count_launches(
        lambda: _drive_engine(ShardedStreamEngine(cfg, mesh), dev, requests, n_profiled=1))
    peak_gib = _peak_gib(dev)
    n_micro = _n_micro(requests, MICRO)
    _expect_launches("sharded engine", launches, n_micro, shards=SHARDS)
    band, score_err = _check_same_emission(run, _run_prefix(kern_run, n_items),
                                           "sharded engine vs main path")
    st = run["stats"]
    if st["pairs_dropped"] or st["window_overflow"] or st["n_items"] != n_items:
        raise AssertionError(f"sharded engine dropped or overflowed: {st}")
    sums = {k: sum(v) for k, v in run["rings"].items()}
    if sums != {"cursor": n_items, "live_slots": n_items, "window_overflow": 0}:
        raise AssertionError(f"sharded rings {run['rings']} do not sum to one ring's "
                             f"after {n_items} items")
    n_prof = _n_micro(requests[-1:], MICRO)
    emit({"phase": "sharded_engine", "nvidia_smi": smi, "shards": SHARDS,
          "placement": placement, "shard_capacity": cfg.capacity, "d": D,
          "requests": len(requests), "n_items": n_items,
          "pairs": len(run["pairs"][0]), "band_pairs": len(band),
          "max_score_err": score_err, "launches": launches,
          "launches_per_micro_batch_kernels": {k: v / n_micro for k, v in launches.items()},
          "profiled_micro_batches": n_prof, "peak_gib": peak_gib,
          "rings": run["rings"], "phase_3_ring_whole_stream": kern_run["rings"],
          "sharded": _route_times(run, n_prof),
          "main_path": _route_times(kern_run, _n_micro(requests[-2:], MICRO)),
          "shard_stats": {k: st[k] for k in ("n_shards", "pairs_dropped_global", "shards")},
          "port_kernels": run["profile"]["port_kernels"],
          "phase_s": time.monotonic() - t0, "profile": run["profile"]})
    return launches


def _score_check(got, want, label) -> dict:
    """Two thresholded score matrices on the card: entries above 0 in
    both within ``FLOAT_TOL``; an entry above 0 in one only must lie
    within ``BAND`` of θ."""
    both = (got > 0) & (want > 0)
    err = float((got - want).abs()[both].max()) if bool(both.any()) else 0.0
    differ = (got > 0) != (want > 0)
    outside = differ & ((got + want - THETA).abs() > BAND)
    if bool(outside.any()) or err > FLOAT_TOL:
        raise AssertionError(f"{label}: {int(outside.sum())} entries differ outside "
                             f"the ε-band, score error {err}")
    return {"pairs": int((want > 0).sum()), "band": int(differ.sum()), "max_err": err}


def phase_ring_join(dev, smi, requests) -> dict:
    """4i: ``make_distributed_join_step`` over four shards of 65,536 slots
    with a global batch of 512 on phase 3's stream: ``RING_WARM`` steps
    fill every ring (items/s, a profiled tail), then ``RING_STEPS`` steps
    are each held against the same step with ``use_ref`` on a copy of the
    state, and against the dense join of the batch over the concatenated
    window on one device; the window scores ``(512, 262144)`` and the self
    scores ``(512, 512)``.  Only the steps' own launches count."""
    import torch
    from repro_torch.core.blocked import BlockedJoinConfig
    from repro_torch.core.distributed import (
        DistributedJoinConfig,
        init_sharded_window,
        make_distributed_join_step,
    )
    from repro_torch.engine import ShardedWindow, WindowState
    from repro_torch.kernels.sssj_join import sssj_join_tiles

    t0 = time.monotonic()
    mesh, placement = _shard_mesh(dev)
    base = dict(theta=THETA, lam=LAM, capacity=CAPACITY // SHARDS, d=D)
    step = make_distributed_join_step(DistributedJoinConfig(BlockedJoinConfig(**base)), mesh)
    ref_step = make_distributed_join_step(
        DistributedJoinConfig(BlockedJoinConfig(**base, use_ref=True)), mesh)
    vecs = np.concatenate([v for v, _ in requests])
    ts = np.concatenate([t for _, t in requests]).astype(np.float32)
    n_steps = RING_WARM + RING_STEPS
    if n_steps * RING_BATCH > len(vecs):
        raise AssertionError("phase 3's stream is too short for the ring join")

    def batch(s):
        lo = s * RING_BATCH
        return (torch.from_numpy(vecs[lo:lo + RING_BATCH]).to(dev),
                torch.from_numpy(ts[lo:lo + RING_BATCH]).to(dev),
                torch.arange(lo, lo + RING_BATCH, dtype=torch.int32, device=dev))

    _reset_peak(dev)
    state = init_sharded_window(DistributedJoinConfig(BlockedJoinConfig(**base)), mesh)
    launches = {k: 0 for k in _launch_counters()}

    def counted(fn):
        out, n = _count_launches(fn)
        for k, v in n.items():
            launches[k] += v
        return out

    def run_steps(batches):
        for x in batches:
            step(state, *x)       # the scores are dropped: the checks come later

    n_prof = 2
    inputs = [batch(s) for s in range(RING_WARM - n_prof)]
    sync(dev)
    t1 = time.monotonic()
    counted(lambda: run_steps(inputs))
    sync(dev)
    seconds = time.monotonic() - t1
    del inputs
    _, prof = _profile(lambda: counted(lambda: run_steps(
        batch(s) for s in range(RING_WARM - n_prof, RING_WARM))), dev)

    checks = []
    for s in range(RING_WARM, n_steps):
        q, tq, uq = batch(s)
        rings = state.shards
        whole = [torch.cat([getattr(r, f) for r in rings]) for f in ("vecs", "ts", "uids")]
        one_win, _, _ = sssj_join_tiles(q, whole[0], tq, whole[1], uq, whole[2],
                                        theta=THETA, lam=LAM, device=dev)
        one_self, _, _ = sssj_join_tiles(q, q, tq, tq, uq, uq, theta=THETA, lam=LAM,
                                         device=dev)
        del whole
        ref_state = ShardedWindow(tuple(
            WindowState(*(None if x is None else x.clone() for x in r)) for r in rings))
        _, (ref_win, ref_self) = ref_step(ref_state, q, tq, uq)
        _, (win, self_s) = counted(lambda: step(state, q, tq, uq))
        checks.append({
            "win_vs_use_ref": _score_check(win, ref_win, f"ring step {s} vs use_ref"),
            "win_vs_one_device": _score_check(win, one_win, f"ring step {s} vs one device"),
            "self_vs_use_ref": _score_check(self_s, ref_self, f"ring self {s} vs use_ref"),
            "self_vs_one_device": _score_check(self_s, one_self, f"ring self {s} vs one device")})
        for a, b in zip(state.shards, ref_state.shards):
            if not (torch.equal(a.uids, b.uids) and torch.equal(a.cursor, b.cursor)
                    and torch.equal(a.overflow, b.overflow)):
                raise AssertionError(f"ring step {s}: the window differs from use_ref's")
        del ref_state, ref_win, ref_self, one_win, one_self, win, self_s
    want = {"sssj_dense": n_steps * (SHARDS * SHARDS + SHARDS), "sssj_cand": 0, "gate_ub": 0}
    if launches != want:
        raise AssertionError(f"ring join: launches {launches}, expected {want}")
    if not any(c["win_vs_one_device"]["pairs"] for c in checks):
        raise AssertionError("ring join: the checked steps scored no pair")
    timed_items = (RING_WARM - n_prof) * RING_BATCH
    emit({"phase": "ring_join", "nvidia_smi": smi, "shards": SHARDS, "placement": placement,
          "shard_capacity": base["capacity"], "d": D, "batch": RING_BATCH,
          "warm_steps": RING_WARM, "checked_steps": RING_STEPS, "checks": checks,
          "launches": launches, "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "timed_items": timed_items, "seconds": seconds,
          "items_per_s": timed_items / seconds, "peak_gib": _peak_gib(dev),
          "per_step": {"launches": prof["device_launches"] / n_prof,
                       "device_ms": prof["device_busy_ms"] / n_prof,
                       "wall_ms": prof["wall_ms"] / n_prof,
                       "device_busy_share": prof["device_busy_share"]},
          "port_kernels": prof["port_kernels"],
          "phase_s": time.monotonic() - t0, "profile": prof})
    return launches


def phase_sharded_service(dev, smi, stream) -> dict:
    """4j: ``MultiTenantSSSJService(mesh=4 shards)`` at a total capacity
    of 262,144 and micro-batch 128 under ``oldest`` eviction, on the first
    ``SHARD_SVC_ITEMS`` items of 4e's stream, flushed whenever a span's
    rows were admitted, the last flushes under the profiler: its groups
    per tenant against a ``join_impl="dense"`` runtime on the same mesh,
    and against the single-device service's on the same submits."""
    import dataclasses

    from repro_torch.runtime import MultiTenantRuntime, ShardedFacade, TenantTable
    from repro_torch.serving import MultiTenantSSSJService

    t0 = time.monotonic()
    mesh, placement = _shard_mesh(dev)
    vecs, ts, tenant = (x[:SHARD_SVC_ITEMS] for x in stream)
    submits = _submits(vecs, ts, tenant)
    table = TenantTable(MT_THETAS, MT_LAMS)
    groups = _flush_groups(submits, SHARD_SVC_MICRO * MT_SPAN)
    n_prof = 2       # 8 micro-batches: the profiler digests four shards' launches slowly
    kw = dict(dim=D, capacity=CAPACITY, span=MT_SPAN, micro_batch=SHARD_SVC_MICRO,
              eviction="oldest", device=dev)

    def serve(svc, profiled):
        pairs = {k: [] for k in range(MT_TENANTS)}

        def run(lo, hi, final):
            for g in groups[lo:hi]:
                for k, v, t in g:
                    svc.submit(k, v, t)
                for k, ps in svc.flush(final=final).items():
                    pairs[k].extend(ps)

        n_timed = len(groups) - (n_prof if profiled else 0)
        sync(dev)
        t1 = time.monotonic()
        run(0, n_timed, not profiled)
        sync(dev)
        seconds = time.monotonic() - t1
        prof, n_prof_micro = None, 0
        if profiled:
            spans0 = svc.runtime.spans_dispatched
            _, prof = _profile(lambda: run(n_timed, len(groups), True), dev)
            n_prof_micro = (svc.runtime.spans_dispatched - spans0) * MT_SPAN
        timed_items = sum(len(v) for g in groups[:n_timed] for _, v, _ in g)
        return {"pairs": pairs, "seconds": seconds, "items_per_s": timed_items / seconds,
                "timed_items": timed_items, "profile": prof, "n_prof_micro": n_prof_micro}

    _reset_peak(dev)
    svc = MultiTenantSSSJService(table, mesh=mesh, **kw)
    run, launches = _count_launches(lambda: serve(svc, True))
    peak_gib = _peak_gib(dev)
    st = svc.stats()
    _expect_launches("sharded service", launches, st["spans_dispatched"] * MT_SPAN,
                     shards=SHARDS)
    cfg = svc.runtime.cfg
    oracle = _run_runtime(
        dev, MultiTenantRuntime(dataclasses.replace(cfg, join_impl="dense"), table,
                                span=MT_SPAN, engine=ShardedFacade(mesh), device=dev),
        [(k, _unit_rows(np.asarray(v, np.float32)), t) for k, v, t in submits],
        n_profiled=0, flush_rows=SHARD_SVC_MICRO * MT_SPAN)
    band_docs, n_band, err, n_groups = _check_service_groups(
        "sharded service vs dense oracle", svc, run["pairs"], _local_pairs(oracle, tenant),
        MT_THETAS)
    one = MultiTenantSSSJService(table, **kw)
    single = serve(one, False)
    one_pairs = {k: {(a, b): s for a, b, s in ps} for k, ps in single["pairs"].items()}
    one_band, n_one_band, one_err, _ = _check_service_groups(
        "sharded service vs one device", svc, run["pairs"], one_pairs, MT_THETAS)
    if st["pairs_dropped"] or st["window_overflow"] or not n_groups:
        raise AssertionError(f"sharded service dropped, overflowed or grouped nothing: {st}")
    prof, n_micro = run["profile"], run["n_prof_micro"]
    emit({"phase": "sharded_service", "nvidia_smi": smi, "shards": SHARDS,
          "placement": placement, "n_items": len(vecs), "capacity": CAPACITY,
          "shard_capacity": cfg.capacity, "micro_batch": SHARD_SVC_MICRO,
          "tile_k": cfg.tile_k, "launches": launches,
          "micro_batches": st["spans_dispatched"] * MT_SPAN,
          "span_fill_micro_batches": st["empty_micro_batches"],
          "seconds": run["seconds"], "timed_items": run["timed_items"],
          "items_per_s": run["items_per_s"], "peak_gib": peak_gib,
          "dense_oracle_items_per_s": oracle["items_per_s"],
          "one_device_items_per_s": single["items_per_s"],
          "per_micro_batch": {"launches": prof["device_launches"] / n_micro,
                              "device_ms": prof["device_busy_ms"] / n_micro,
                              "wall_ms": prof["wall_ms"] / n_micro,
                              "device_busy_share": prof["device_busy_share"]},
          "profiled_micro_batches": n_micro, "port_kernels": prof["port_kernels"],
          "pairs": sum(map(len, run["pairs"].values())), "groups": n_groups,
          "band_pairs": n_band, "band_documents": band_docs, "max_score_err": err,
          "one_device_band_pairs": n_one_band, "one_device_max_score_err": one_err,
          "latency": _latency(svc.snapshot()),
          "shard_stats": {k: st[k] for k in ("n_shards", "pairs_dropped_global", "shards")},
          "stats": st, "phase_s": time.monotonic() - t0, "profile": prof})
    for s in (svc, one):
        s.runtime.close()
    return launches


# --------------------------------------------------------------------- #
# phases 4n-4o: the gate's bits held exactly; the paper's joiners
# --------------------------------------------------------------------- #
# 4n: topically clustered traffic, so that the value bounds decide strips:
# at rate 1000 the horizon (≈105 time units, ≈105,000 items) outlasts the
# 16,384-slot ring, which the 32,768 items wrap twice, so the time bound
# kills nothing.  Items of one topic score 0.91-0.96 against each other,
# so about 55 M pairs come out (up to ~516,000 a micro-batch): tile_k holds
# a whole tile and max_pairs twice the largest micro-batch, so that nothing
# is dropped and every pair is held
DRIFT = dict(n=32768, d=1024, seg=512, rate=1000.0)
DRIFT_CFG = dict(theta=0.9, lam=1e-3, capacity=16384, d=1024, micro_batch=128,
                 tile_k=128 * 128, max_pairs=1 << 20)
DRIFT_DRAIN = 16     # pushes between drains: bounds the pinned copies held
# 4o: the four Table-1 streams at their synthetic sizes (DATASET_SPECS),
# STR-L2 on the host against the engine with a ring that holds the whole
# stream (capacity ≥ n: nothing is overwritten, so the pair set is the
# paper's)
TABLE1 = ("webspam", "rcv1", "blogs", "tweets")
TABLE1_THETA, TABLE1_LAM = 0.5, 0.01
TABLE1_REQUEST = 1024
# tile_k holds a whole 128 x 128 tile, so no tile can drop a pair;
# max_pairs holds a micro-batch's pairs on tweets' bursts
TABLE1_TILE_K = 128 * 128
TABLE1_MAX_PAIRS = 65536


class _GateBits:
    """Before each push: ``strip_gate`` on the card (``gate_ub``) and on
    CPU copies (``gate_ub_plain``) over the window's strip summary and the
    micro-batch as the engine takes it; bits and prune stats must be
    equal, but for bits whose plain bound lies within ``FLOAT_TOL`` of θ."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.card, self.plain = np.zeros(3, np.int64), np.zeros(3, np.int64)
        self.bits = self.near = 0
        self.differ = []   # (micro-batch, query tile, strip, plain bound)

    def __call__(self, m, eng, v, t, dev):
        import torch
        from repro_torch.engine.engine import pad_request
        from repro_torch.kernels.sssj_join import gate as g

        cfg = self.cfg
        _, qs, tqs, _, _ = pad_request(v, t, 0, cfg.micro_batch)
        q = torch.from_numpy(qs[0])
        kw = dict(block_q=cfg.block_q, chunk_d=cfg.chunk_d,
                  tq_lo=float(tqs[0].min()), tq_hi=float(tqs[0].max()))
        summary = eng.state.summary
        gate_c, st_c = g.strip_gate(q.to(dev), summary, th_min=cfg.theta,
                                    lam_min=cfg.lam, device=dev, **kw)
        cpu = g.StripSummary(*(x.cpu() for x in summary))
        gate_p, st_p = g.strip_gate(q, cpu, th_min=cfg.theta, lam_min=cfg.lam,
                                    device="cpu", **kw)
        bound, _ = g.strip_bound(q, cpu, lam_min=cfg.lam, **kw)
        near = (bound - cfg.theta).abs() <= FLOAT_TOL
        diff = gate_c.cpu() != gate_p
        if bool((diff & ~near).any()):
            at = torch.nonzero(diff & ~near)[:5].tolist()
            raise AssertionError(f"gate bits: card and plain differ at micro-batch {m}, "
                                 f"(tile, strip) {at}, away from θ")
        st_c, st_p = st_c.cpu().numpy(), st_p.numpy()
        if not diff.any() and not np.array_equal(st_c, st_p):
            raise AssertionError(f"gate stats at micro-batch {m}: card {st_c.tolist()} "
                                 f"vs plain {st_p.tolist()}")
        self.differ += [(m, i, s, float(bound[i, s])) for i, s in torch.nonzero(diff).tolist()]
        self.card += st_c
        self.plain += st_p
        self.bits += gate_p.numel()
        self.near += int(near.sum())


def phase_gate_bits(dev, smi) -> dict:
    """4n: ``topic_drift_stream`` into ``StreamEngine`` on the kernel route
    with the gate on, one micro-batch a request, the gate's bits held
    before each push (:class:`_GateBits`).  The value bounds must skip
    tiles (``engine/prune/tiles_skipped_l2 > 0``), the engine's prune
    stats must be the card's gate's, and the drained pairs must be those
    of the same stream through ``join_impl="dense"`` on the card."""
    from repro_torch.data import topic_drift_stream
    from repro_torch.engine import EngineConfig, StreamEngine

    t0 = time.monotonic()
    vecs, ts = topic_drift_stream(DRIFT["n"], DRIFT["d"], seg=DRIFT["seg"],
                                  rate=DRIFT["rate"], seed=SEED)
    cfg = EngineConfig(**DRIFT_CFG)
    mb = cfg.micro_batch
    requests = [(vecs[i:i + mb], ts[i:i + mb]) for i in range(0, len(vecs), mb)]
    check = _GateBits(cfg)
    kern = _drive_engine(StreamEngine(cfg, device=dev), dev, requests, n_profiled=0,
                         before_push=check, drain_every=DRIFT_DRAIN)
    launches = kern["launches"]
    _expect_launches("gate bits", launches, len(requests))
    prune = {k: v for k, v in kern["metrics"].items() if k.startswith("engine/prune/")}
    if not prune["engine/prune/tiles_skipped_l2"] > 0:
        raise AssertionError(f"gate bits: the value bounds skipped no tile: {prune}")
    engine_stats = [prune[f"engine/prune/{k}"] for k in PRUNE_KEYS]
    if engine_stats != check.card.tolist():
        raise AssertionError(f"gate bits: the engine's prune stats {engine_stats} are not "
                             f"the card's gate's {check.card.tolist()}")
    dense = _drive_engine(StreamEngine(EngineConfig(**DRIFT_CFG, join_impl="dense"),
                                       device=dev), dev, requests, n_profiled=0,
                          drain_every=DRIFT_DRAIN)
    band, score_err = _check_same_emission(kern, dense, "gate bits: kernel vs dense",
                                           theta=cfg.theta)
    st = kern["stats"]
    for key in ("pairs_dropped", "window_overflow", "n_items"):
        if st[key] != dense["stats"][key]:
            raise AssertionError(f"gate bits: {key} {st[key]} vs dense {dense['stats'][key]}")
    if st["pairs_dropped"] or not st["window_overflow"] or not len(kern["pairs"][0]):
        raise AssertionError(f"gate bits: dropped pairs, an unwrapped ring or no pair: {st}")
    rec = {"phase": "gate_bits", "nvidia_smi": smi, "stream": DRIFT, "config": DRIFT_CFG,
           "micro_batches": len(requests), "gate_bits": check.bits,
           "near_theta_bits": check.near, "bits_differ": len(check.differ),
           "differ": check.differ[:20],
           "card_stats": dict(zip(PRUNE_KEYS, check.card.tolist())),
           "plain_stats": dict(zip(PRUNE_KEYS, check.plain.tolist())),
           "tiles_total": st["tiles_total"], "chunks_executed": st["chunks_executed"],
           "window_overflow": st["window_overflow"], "pairs": len(kern["pairs"][0]),
           "dense_pairs": len(dense["pairs"][0]), "band_pairs": len(band),
           "band": [[x, y, sc] for (x, y), sc in sorted(band.items())][:20],
           "max_score_err": score_err, "launches": launches,
           "items_per_s": DRIFT["n"] / kern["seconds"],
           "dense_items_per_s": DRIFT["n"] / dense["seconds"],
           "phase_s": time.monotonic() - t0}
    emit(rec)
    return launches


def _table1_stream(name: str, n=None, dims=None):
    """``synthetic_stream(DATASET_SPECS[name], seed=SEED)`` with each
    timestamp rounded to f32, as the engine's ``pad_request`` takes it
    (bursty streams reach t ≈ 5·10⁴, where one f32 ulp moves the decay by
    more than ``BAND``).  ``n``/``dims`` cut the stream (CPU rehearsals)."""
    import dataclasses

    from repro_torch.core import StreamItem
    from repro_torch.data import DATASET_SPECS, synthetic_stream

    spec = DATASET_SPECS[name]
    if n is not None:
        spec = dataclasses.replace(spec, n=n, dims=dims)
    items = synthetic_stream(spec, seed=SEED)
    return spec, [StreamItem(it.uid, float(np.float32(it.t)), it.vec) for it in items]


def _table1_host_join(name: str, cut: dict) -> dict:
    """One stream through the port's STR-L2 on the host (a spawned pool
    worker): its pairs as arrays, its ``Counters`` and seconds."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Counters, join_stream, make_joiner

    t0 = time.monotonic()
    _, items = _table1_stream(name, **cut)
    gen_s = time.monotonic() - t0
    c = Counters()
    t0 = time.monotonic()
    pairs = join_stream(make_joiner("STR", "L2", TABLE1_THETA, TABLE1_LAM, counters=c),
                        items)
    seconds = time.monotonic() - t0
    return {"newer": np.array([max(p.uid_a, p.uid_b) for p in pairs], np.int64),
            "older": np.array([min(p.uid_a, p.uid_b) for p in pairs], np.int64),
            "decayed": np.array([p.decayed for p in pairs], np.float64),
            "counters": c.as_dict(), "seconds": seconds, "gen_s": gen_s}


def _densify(items, dims: int) -> tuple:
    """Sparse stream items as f32 rows and their (f32-exact) timestamps."""
    nnz = [it.vec.nnz for it in items]
    rows = np.repeat(np.arange(len(items)), nnz)
    vecs = np.zeros((len(items), dims), np.float32)
    vecs[rows, np.concatenate([it.vec.indices for it in items])] = np.concatenate(
        [it.vec.values for it in items])
    return vecs, np.array([it.t for it in items], np.float64)


def phase_table1(dev, smi, names=TABLE1, cut=None) -> dict:
    """4o: the four Table-1 streams through the port's STR-L2 on the host
    (a spawned pool, one worker a stream: the parent has initialised CUDA,
    so it is not forked) and, densified, through ``StreamEngine`` on the
    kernel route in requests of 1,024, with a ring that holds the whole
    stream.  The engine is timed once the pool has finished, so that the
    host joins do not share its cores.  Held: pair sets equal outside the
    ε-band, scores within ``FLOAT_TOL``, nothing dropped or overwritten,
    and the host's ``Counters`` published into the engine's registry
    beside ``engine/*``."""
    import multiprocessing

    from repro_torch.core import Counters
    from repro_torch.engine import EngineConfig, StreamEngine
    from repro_torch.obs import publish_counters

    t0 = time.monotonic()
    cut = cut or {}
    launches = dict.fromkeys(_launch_counters(), 0)
    out, streams = [], {}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(names)) as pool:
        jobs = {name: pool.apply_async(_table1_host_join, (name, cut)) for name in names}
        for name in names:      # the same streams, densified while the pool joins
            spec, items = _table1_stream(name, **cut)
            streams[name] = (spec, *_densify(items, spec.dims))
            del items
        hosts = {name: job.get(timeout=900) for name, job in jobs.items()}
    host_wall_s = time.monotonic() - t0
    for name in names:
        spec, vecs, ts = streams.pop(name)
        host = hosts.pop(name)
        n = len(vecs)
        cfg = EngineConfig(theta=TABLE1_THETA, lam=TABLE1_LAM,
                           capacity=-(-n // MICRO) * MICRO, d=spec.dims,
                           micro_batch=MICRO, tile_k=TABLE1_TILE_K,
                           max_pairs=TABLE1_MAX_PAIRS)
        requests = [(vecs[i:i + TABLE1_REQUEST], ts[i:i + TABLE1_REQUEST])
                    for i in range(0, n, TABLE1_REQUEST)]
        del vecs
        eng = StreamEngine(cfg, device=dev)
        try:
            def run():
                sync(dev)
                t1 = time.monotonic()
                for v, t in requests:
                    eng.push(v, t)
                pairs = eng.drain_arrays()
                sync(dev)
                return pairs, time.monotonic() - t1

            (pairs, seconds), got = _count_launches(run)
            _expect_launches(f"table1 {name}", got, _n_micro(requests, MICRO))
            del requests
            for k, v in got.items():
                launches[k] += v
            band, err = _check_same_emission(
                {"pairs": pairs},
                {"pairs": (host["newer"], host["older"], host["decayed"])},
                f"table1 {name}: engine vs host STR-L2", theta=TABLE1_THETA)
            st = eng.stats()
            if st["pairs_dropped"] or st["window_overflow"] or st["n_items"] != n:
                raise AssertionError(f"table1 {name}: dropped or overwritten: {st}")
            # the bridge: the host's counters in the engine's snapshot
            publish_counters(eng.registry, Counters(**host["counters"]))
            snap = eng.metrics()
            if (snap.get("paper/pairs_emitted") != len(host["newer"])
                    or snap.get("engine/n_items") != n):
                raise AssertionError(f"table1 {name}: the snapshot's paper/* and "
                                     f"engine/* disagree with the runs")
        finally:
            eng.close()
        c = host["counters"]
        rec = {"stream": name, "n": n, "dims": spec.dims, "avg_nnz": spec.avg_nnz,
               "timestamps": spec.timestamps, "t_end": float(ts[-1]),
               "pairs": len(host["newer"]), "engine_pairs": len(pairs[0]),
               "band_pairs": len(band),
               "band": [[a, b, s] for (a, b), s in sorted(band.items())][:10],
               "max_score_err": err, "host_s": host["seconds"],
               "host_gen_s": host["gen_s"], "engine_s": seconds,
               "engine_items_per_s": n / seconds,
               "launches": {"cand_kernel": got["sssj_cand"], "gate_ub": got["gate_ub"]},
               **{k: c[k] for k in ("entries_traversed", "candidates_generated",
                                    "full_sims_computed", "pairs_emitted")},
               "paper_snapshot": {k: v for k, v in snap.items()
                                  if k.startswith("paper/")},
               "engine_prune": {k: v for k, v in snap.items()
                                if k.startswith("engine/prune/")},
               "tiles_total": st["tiles_total"], "chunks_executed": st["chunks_executed"]}
        out.append(rec)
        emit({"phase": "table1_stream", **rec})
    emit({"phase": "table1", "nvidia_smi": smi, "theta": TABLE1_THETA, "lam": TABLE1_LAM,
          "request": TABLE1_REQUEST, "tile_k": TABLE1_TILE_K,
          "max_pairs": TABLE1_MAX_PAIRS, "seed": SEED, "launches": launches,
          "streams": [{k: r[k] for k in ("stream", "n", "dims", "pairs", "band_pairs",
                                         "host_s", "engine_items_per_s")} for r in out],
          "host_wall_s": host_wall_s, "phase_s": time.monotonic() - t0})
    return launches


# --------------------------------------------------------------------- #
# phases 4k-4m: the LM embedder and the system's serve path
# --------------------------------------------------------------------- #
# qwen3-0.6b at its full width (src/repro_torch/configs/qwen3_0_6b.py: 28
# layers, d_model 1024, 16 heads, 8 kv heads, head_dim 128, d_ff 3072,
# vocabulary 151,936, tied embeddings, qk_norm), random f32 weights drawn
# on the card from SEED
LM_ARCH = "qwen3-0.6b"
# 4k: launch.serve's token stream into SSSJService(block=128): 72 requests
# of 128 documents x 64 tokens, 25 % planted near-duplicates; 9,216
# documents wrap the 8,192-slot window (72, not 96: the script's time)
SERVE = dict(requests=72, batch=128, seq=64, dup_frac=0.25, seed=SEED)
SERVE_SVC = dict(theta=0.85, lam=0.05, dim=1024, capacity=8192, block=128)
SERVE_CPU_DOCS = 4      # re-embedded on the CPU with the same parameters
EMBED_TOL = 1e-5        # unit embeddings, card against CPU: f32 in another order
# 4l: documents long enough that every layer's attention runs flash_attn.cu
LONG_DOCS, LONG_SEQ = 8, 2048
# 4m: the fused embed→join for 8 tenants, 1,024 documents of 64 tokens (8
# requests, not 16: the script's time)
FUSED_TENANTS = 8
FUSED = dict(requests=8, batch=128, seq=64, dup_frac=0.25, seed=SEED + 1)
FUSED_THETAS = tuple((0.85, 0.9)[k % 2] for k in range(FUSED_TENANTS))
FUSED_LAMS = (0.05,) * FUSED_TENANTS
FUSED_SVC = dict(dim=1024, capacity=8192, micro_batch=64, span=2)


def _count_lm_launches(fn):
    """:func:`_count_launches` with flash attention's launches beside."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel_call as flash,
    )

    flash.launches = 0
    out, launches = _count_launches(fn)
    return out, {**launches, "flash_attn": flash.launches}


def _expect_lm_launches(label, launches, n_micro, flash):
    _expect_launches(label, {k: v for k, v in launches.items() if k != "flash_attn"},
                     n_micro)
    if launches["flash_attn"] != flash:
        raise AssertionError(f"{label}: flash attention launched "
                             f"{launches['flash_attn']} times, expected {flash}")


def lm_params(dev, arch=LM_ARCH):
    """``arch``'s parameters at full width, drawn on ``dev`` from a seeded
    generator; returns ``(cfg, params, record)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, param_count
    from repro_torch.models.common import Initializer

    cfg = get_config(arch)
    t0 = time.monotonic()
    params = init_lm(Initializer(torch.Generator(dev).manual_seed(SEED), dev), cfg)
    sync(dev)
    n = param_count(cfg)
    return cfg, params, {"arch": arch, "params": n, "param_gib": 4 * n / 2**30,
                         "init_s": time.monotonic() - t0}


def _lm_serve(dev, smi, cfg, params, rec0, serve, svc_cfg, label, phase,
              fwd=(3, 1)) -> tuple:
    """``launch.serve``'s token stream (``serve``) through the port's
    ``LMEmbedder`` into ``SSSJService(**svc_cfg)``, strict: each request's
    pairs against the same service on ``join_impl="dense"`` fed the same
    embeddings (equal outside the ε-band, scores within ``FLOAT_TOL``),
    its groups and trends against those of the oracle's pairs, the
    embeddings finite unit vectors.  The last two requests run under the
    profiler (busy share); one forward of a request's documents is timed
    on the device (``fwd``: repetitions, warm-up calls).  Returns
    ``(record, launches, stream, embeddings by request, emitted
    pairs)``."""
    import dataclasses

    import torch
    from repro_torch.engine import StreamEngine
    from repro_torch.launch.serve import token_requests
    from repro_torch.serving import LMEmbedder, SSSJService, pooled_unit_embed

    t_phase = time.monotonic()
    stream, planted = token_requests(cfg.vocab_size, **serve)
    emb = LMEmbedder(cfg, params, device=dev)
    recorded = []

    def embed_fn(toks):
        out = emb(toks)
        recorded.append(out)
        return out

    _reset_peak(dev)
    svc = SSSJService(**svc_cfg, embed_fn=embed_fn, device=dev)
    timed, profiled = stream[:-2], stream[-2:]

    def run():
        sync(dev)
        t0 = time.monotonic()
        pairs = [svc.submit(t, ts) for t, ts in timed]
        sync(dev)
        seconds = time.monotonic() - t0
        last, prof = _profile(lambda: [svc.submit(t, ts) for t, ts in profiled], dev)
        return pairs + last, seconds, prof

    (pairs, seconds, prof), launches = _count_lm_launches(run)
    peak_gib = _peak_gib(dev)
    n_micro = len(stream) * -(-serve["batch"] // svc_cfg["block"])
    _expect_lm_launches(label, launches, n_micro, flash=0)

    # the oracle: the same service on the dense join, fed the same vectors
    replay = iter(recorded)
    oracle = SSSJService(**svc_cfg, embed_fn=lambda toks: next(replay), device=dev)
    oracle.engine.close()
    oracle.engine = StreamEngine(dataclasses.replace(oracle.engine.cfg, join_impl="dense"),
                                 device=dev)
    want = [oracle.submit(t, ts) for t, ts in stream]
    flat, flat_want = ([p for req in x for p in req] for x in (pairs, want))
    got_run, want_run = _pairs_run(flat), _pairs_run(flat_want)
    band, score_err = _check_same_emission(got_run, want_run, f"{label} vs dense",
                                           theta=svc_cfg["theta"])
    got_keys = set(zip(*(x.tolist() for x in got_run["pairs"][:2])))
    want_pairs = [(a, b) for a, b in zip(*(x.tolist() for x in want_run["pairs"][:2]))
                  if (a, b) not in band] + sorted(k for k in band if k in got_keys)
    groups, want_groups = svc.duplicate_groups(), _groups(want_pairs)
    if groups != want_groups:
        raise AssertionError(f"{label}: duplicate_groups differ from the oracle's")
    trends = svc.trending(3)
    if trends != [g for g in want_groups if len(g) >= 3]:
        raise AssertionError(f"{label}: trends differ from the oracle's")
    n_docs = sum(len(t) for t, _ in stream)
    st = svc.engine.stats()
    if svc.stats.n_items != n_docs or not flat or st["pairs_dropped"]:
        raise AssertionError(f"{label}: nothing emitted or pairs dropped: {svc.stats}")
    embs = np.concatenate(recorded)
    norms = np.linalg.norm(embs, axis=1)
    if not (np.isfinite(embs).all() and np.abs(norms - 1.0).max() <= EMBED_TOL):
        raise AssertionError(f"{label}: embeddings not finite unit vectors "
                             f"(norms {norms.min()}..{norms.max()})")

    toks = torch.from_numpy(stream[0][0]).to(dev)
    forward = lambda: pooled_unit_embed(params, cfg, toks)   # noqa: E731
    fwd_ms = cuda_ms(forward, fwd[0], warmup=fwd[1])
    fwd_device_ms = device_ms(forward, fwd[0], warmup=fwd[1])
    n_timed = sum(len(t) for t, _ in timed)
    rec = {"phase": phase, "nvidia_smi": smi, **rec0, "config": svc_cfg,
           "stream": serve, "documents": n_docs, "planted": planted,
           "timed_documents": n_timed, "seconds": seconds,
           "documents_per_s": n_timed / seconds,
           "tokens_per_s": n_timed * serve["seq"] / seconds,
           "forward_ms": fwd_ms, "forward_device_ms": fwd_device_ms,
           "forward_documents": len(stream[0][0]),
           "device_busy_share": prof["device_busy_share"],
           "profiled_requests": len(profiled), "launches": launches,
           "pairs": len(flat), "dense_pairs": len(flat_want), "band_pairs": len(band),
           "max_score_err": score_err, "groups": len(groups),
           "largest_group": max(map(len, groups)) if groups else 0,
           "trending_3": len(trends),
           "norm_err": float(np.abs(norms - 1.0).max()), "peak_gib": peak_gib,
           "stats": st, "service_stats": dataclasses.asdict(svc.stats),
           "profile": prof, "t_phase": t_phase}
    for x in (svc, oracle):
        x.engine.close()
    return rec, launches, stream, recorded, flat


def _emit_phase(rec: dict) -> None:
    rec["phase_s"] = time.monotonic() - rec.pop("t_phase")
    emit(rec)


def _cpu_embed_check(cfg, params, stream, recorded, label, tol=EMBED_TOL) -> float:
    """``SERVE_CPU_DOCS`` documents of the first request re-embedded on the
    CPU with the same parameters (IEEE f32 there, so TF32 on the card
    shows), within ``tol`` of the card's; returns the error."""
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.serving import LMEmbedder

    params_cpu = params_from_numpy(params_to_numpy(params), "cpu")
    cpu = LMEmbedder(cfg, params_cpu, device="cpu")(stream[0][0][:SERVE_CPU_DOCS])
    del params_cpu
    cpu_err = float(np.abs(cpu - recorded[0][:SERVE_CPU_DOCS]).max())
    if not cpu_err <= tol:
        raise AssertionError(f"{label}: card and CPU embeddings differ by {cpu_err}")
    return cpu_err


def phase_lm_serve(dev, smi, cfg, params, rec0) -> dict:
    """4k: the system end to end (:func:`_lm_serve`), qwen3-0.6b at full
    width into ``SSSJService(theta=0.85, lam=0.05, dim=1024,
    capacity=8192, block=128)``; the 9,216 documents wrap the window; 4
    documents re-embedded on the CPU within ``EMBED_TOL``
    (:func:`_cpu_embed_check`)."""
    rec, launches, stream, recorded, _ = _lm_serve(dev, smi, cfg, params, rec0, SERVE,
                                                   SERVE_SVC, "lm serve", "lm_serve")
    if rec["documents"] <= SERVE_SVC["capacity"]:
        raise AssertionError("lm serve: the window did not wrap")
    rec["cpu_embed_max_abs_err"] = _cpu_embed_check(cfg, params, stream, recorded,
                                                    "lm serve")
    _emit_phase(rec)
    return launches


def phase_lm_long(dev, smi, cfg, params, phase="lm_long", attn_input=None,
                  flash_launches=None, extra=None, fwd=(2, 1)) -> tuple:
    """4l (qwen3-0.6b), 4q (olmoe-1b-7b) and 4w (zamba2-2.7b): 8 documents
    of 2,048 tokens through ``pooled_unit_embed``, so that every attention
    block runs ``flash_attn.cu`` (positions ``arange(S)``, S above
    1,024): one flash launch an attention block (28; 16; 9 invocations of
    zamba's shared block, or ``flash_launches``), finite unit embeddings;
    on the first attention block's real q, k and v (its input and its
    parameters from ``attn_input(embeddings)``; by default the embeddings
    and layer 0) the flash route against the port's
    ``chunked_causal_attention`` on the card within ``FLASH_F32_TOL``;
    flash timed at this shape (B 8, H 16, S 2,048, Dh 128; Hkv 8, or 16
    for olmoe's MHA; zamba's H 32 = Hkv, Dh 80 padded to 128) beside its
    plain version and SDPA, and the whole forward on the device (``fwd``:
    repetitions, warm-up calls); the record gains ``extra()``'s items.
    Returns ``(launches, flash record)``."""
    import torch
    from repro_torch._device import ieee_f32
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention.kernel import kernel_head_dim
    from repro_torch.models.attention import _project_qkv, chunked_causal_attention
    from repro_torch.models.common import rms_norm
    from repro_torch.models.lm import _layer
    from repro_torch.serving import pooled_unit_embed

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (LONG_DOCS, LONG_SEQ))
                            .astype(np.int32)).to(dev)
    _reset_peak(dev)

    def run():
        sync(dev)
        t0 = time.monotonic()
        out = pooled_unit_embed(params, cfg, toks)
        sync(dev)
        return out, time.monotonic() - t0

    (out, seconds), launches = _count_lm_launches(run)
    peak_gib = _peak_gib(dev)
    _expect_lm_launches(phase, launches, 0, flash=flash_launches or cfg.n_layers)
    norms = torch.linalg.vector_norm(out, dim=1)
    if not (bool(torch.isfinite(out).all())
            and float((norms - 1.0).abs().max()) <= EMBED_TOL):
        raise AssertionError(f"{phase}: embeddings not finite unit vectors")

    # the first attention block's q, k, v: the flash route against the
    # chunked online softmax
    hd = cfg.resolved_head_dim
    with ieee_f32(dev):
        x = torch.nn.functional.embedding(toks.long(), params["embed"])
        if attn_input is None:
            p0 = _layer(params["groups"][0]["stacked"], 0)
        else:
            x, p0 = attn_input(x)
        pos = torch.arange(LONG_SEQ, dtype=torch.int32, device=dev)[None].expand(
            LONG_DOCS, LONG_SEQ)
        q, k, v = _project_qkv(p0["attn"], cfg, rms_norm(p0["norm1"], x, cfg.norm_eps), pos)
        qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kw = dict(sm_scale=hd ** -0.5, causal=True)
        flash_out = flash_attention(qf, kf, vf, device=dev, **kw).transpose(1, 2)
        chunked = chunked_causal_attention(q, k, v, pos, pos[0], hd ** -0.5)
    err = float((flash_out - chunked).abs().max())
    if not err <= FLASH_F32_TOL:
        raise AssertionError(f"{phase}: flash vs chunked attention {err}")

    flash_call = lambda: flash_attention(qf, kf, vf, device=dev, **kw)   # noqa: E731
    plain_call = lambda: flash_attention_plain(qf, kf, vf, block_q=128,  # noqa: E731
                                               block_k=128, **kw)
    lib_call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qf, kf, vf, is_causal=True, scale=hd ** -0.5, enable_gqa=True)
    parts: dict = {}
    B, H, S, Dh = qf.shape
    flops = 2 * B * H * S * S * Dh      # causal: half of q·kᵀ and p·v
    nbytes = (2 * qf.numel() + kf.numel() + vf.numel()) * 4
    flash_rec = {"shape": {"B": B, "H": H, "Hkv": kf.shape[1], "S": S, "Dh": Dh},
                 "max_abs_err_vs_chunked": err,
                 "ms": cuda_ms(flash_call, 10),
                 "device_ms": device_ms(flash_call, 10, "::flash_", parts=parts),
                 "plain_ms": cuda_ms(plain_call, 3, 1),
                 "plain_device_ms": device_ms(plain_call, 3, warmup=1),
                 "library_ms": cuda_ms(lib_call, 10),
                 "library_device_ms": device_ms(lib_call, 10),
                 "device_ms_by_kernel": _by_kernel(parts)}
    flash_rec["bound_ms"], flash_rec["bound_by"] = bound_ms(nbytes, flops)
    flash_rec["bound_3xtf32_ms"] = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)[0]
    Dk = kernel_head_dim(Dh)
    if Dk != Dh:   # the work the kernel does at its zero-padded width
        flash_rec["kernel_head_dim"] = Dk
        flash_rec["bound_padded_ms"] = bound_ms(nbytes * Dk / Dh, flops * Dk / Dh)[0]
        flash_rec["bound_padded_3xtf32_ms"] = bound_ms(nbytes * Dk / Dh, 3 * flops * Dk / Dh,
                                                       PEAK_TF32_FLOPS)[0]
    forward = lambda: pooled_unit_embed(params, cfg, toks)   # noqa: E731
    rec = {"phase": phase, "arch": cfg.name, "nvidia_smi": smi, "documents": LONG_DOCS,
           "tokens": LONG_SEQ, "launches": launches, "seconds": seconds,
           "tokens_per_s": LONG_DOCS * LONG_SEQ / seconds,
           "forward_ms": cuda_ms(forward, fwd[0], warmup=fwd[1]),
           "forward_device_ms": device_ms(forward, fwd[0], warmup=fwd[1]),
           "norm_err": float((norms - 1.0).abs().max()), "peak_gib": peak_gib,
           "flash": flash_rec, **(extra() if extra else {}),
           "phase_s": time.monotonic() - t_phase}
    emit(rec)
    return launches, flash_rec


def phase_lm_fused(dev, smi, cfg, params) -> dict:
    """4m: ``MultiTenantSSSJService`` over 8 tenants with ``fused=
    FusedEmbedder(qwen3-0.6b, params, seq_len=64)``: 1,024 documents of
    ``token_requests`` (each request's documents dealt to tenants by a
    seeded draw, one submit a tenant a request, a flush a request), its
    launches read around its own run; beside it the same service fed
    ``LMEmbedder`` vectors embedded on the host a submit at a time.  Each
    tenant's flushed pairs equal outside the ε-band of its θ (scores
    within ``FLOAT_TOL``), its groups those of the other run's pairs, its
    counters equal.  The host embeds each request's 128 documents in one
    call; the embeddings' difference between the two batchings
    (micro-batches of 64 in admission order against a request's rows) is
    measured and reported."""
    import torch
    from repro_torch.launch.serve import token_requests
    from repro_torch.runtime import FusedEmbedder, TenantTable
    from repro_torch.serving import LMEmbedder, MultiTenantSSSJService, pooled_unit_embed

    t_phase = time.monotonic()
    stream, planted = token_requests(cfg.vocab_size, **FUSED)
    deal = np.random.default_rng(SEED + 4).integers(0, FUSED_TENANTS,
                                                    (len(stream), FUSED["batch"]))
    emb = LMEmbedder(cfg, params, device=dev)

    def service(fused):
        return MultiTenantSSSJService(TenantTable(FUSED_THETAS, FUSED_LAMS),
                                      fused=fused, device=dev, **FUSED_SVC)

    def drive(svc, payload):
        """One submit a tenant a request (``payload`` maps a request's
        tokens to what the service takes), a flush a request."""
        out: dict = {}
        sync(dev)
        t0 = time.monotonic()
        for (toks, ts), tenants in zip(stream, deal):
            data = payload(toks)
            for k in range(FUSED_TENANTS):
                if (tenants == k).any():
                    svc.submit(k, data[tenants == k], ts[tenants == k])
            for k, p in svc.flush().items():
                out.setdefault(k, []).extend(p)
        for k, p in svc.flush(final=True).items():
            out.setdefault(k, []).extend(p)
        sync(dev)
        return out, time.monotonic() - t0

    svc_f = service(FusedEmbedder(cfg, params, FUSED["seq"]))
    (pairs_f, sec_f), launches = _count_lm_launches(lambda: drive(svc_f, lambda t: t))
    n_micro = svc_f.runtime.spans_dispatched * FUSED_SVC["span"]
    _expect_lm_launches("lm fused", launches, n_micro, flash=0)
    host_vecs = []

    def host_embed(toks):
        host_vecs.append(emb(toks))
        return host_vecs[-1]

    svc_h = service(None)
    pairs_h, sec_h = drive(svc_h, host_embed)
    host_vecs = np.concatenate(host_vecs)
    want = {k: {(a, b): s for a, b, s in p} for k, p in pairs_h.items()}
    band_docs, n_band, err, n_groups = _check_service_groups(
        "lm fused vs host", svc_f, pairs_f, want, FUSED_THETAS)
    counters = ("submitted", "queued", "window_overflow")
    for k in range(FUSED_TENANTS):
        a, b = svc_f.tenant_stats(k), svc_h.tenant_stats(k)
        if {c: a[c] for c in counters} != {c: b[c] for c in counters} or (
                k not in band_docs and a["pairs_drained"] != b["pairs_drained"]):
            raise AssertionError(f"lm fused tenant {k}: counters {a} vs host {b}")
    n_pairs = sum(map(len, pairs_f.values()))
    if not n_pairs or svc_f.stats()["pairs_dropped"]:
        raise AssertionError("lm fused: nothing emitted or pairs dropped")

    # the embeddings of both batchings, in admission order (tenant by
    # tenant within a request)
    order = np.concatenate([np.argsort(tenants, kind="stable") + r * len(tenants)
                            for r, tenants in enumerate(deal)])
    toks_all = np.concatenate([toks for toks, _ in stream])[order]
    mb = FUSED_SVC["micro_batch"]
    fused_like = torch.cat([
        pooled_unit_embed(params, cfg, torch.from_numpy(toks_all[i:i + mb]).to(dev))
        for i in range(0, len(order), mb)]).cpu().numpy()
    embed_diff = float(np.abs(fused_like - host_vecs[order]).max())
    n_docs = len(order)
    rec = {"phase": "lm_fused", "nvidia_smi": smi, "tenants": FUSED_TENANTS,
           "thetas": FUSED_THETAS, "lams": FUSED_LAMS, "config": FUSED_SVC,
           "stream": FUSED, "documents": n_docs, "planted": planted,
           "launches": launches, "micro_batches": n_micro,
           "fused_seconds": sec_f, "fused_documents_per_s": n_docs / sec_f,
           "host_seconds": sec_h, "host_documents_per_s": n_docs / sec_h,
           "pairs": n_pairs, "band_pairs": n_band, "band_documents": band_docs,
           "max_score_err": err, "groups": n_groups,
           "embed_max_abs_diff_fused_vs_host": embed_diff,
           "stats": svc_f.stats(), "phase_s": time.monotonic() - t_phase}
    for s in (svc_f, svc_h):
        s.runtime.close()
    emit(rec)
    return launches


# --------------------------------------------------------------------- #
# phases 4p-4r: the MoE block kind and decode
# --------------------------------------------------------------------- #
# olmoe-1b-7b at its full width (src/repro_torch/configs/olmoe_1b_7b.py: 16
# layers, d_model 2048, 16 heads = 16 kv heads, head_dim 128, 64 experts
# top-8 of width 1,024, softmax router, vocabulary 50,304, qk_norm), random
# f32 weights drawn on the card from SEED: 6,919,100,416 parameters, 25.8 GiB
MOE_ARCH = "olmoe-1b-7b"
# 4p: 16 requests of 128 documents x 64 tokens (not 32 or 24: the script's time): 8,192
# tokens a forward in 16 dispatch groups of 512 tokens, 80 slots an expert a
# group (1,280 an expert), 25 % planted near-duplicates
MOE_SERVE = dict(requests=16, batch=128, seq=64, dup_frac=0.25, seed=SEED)
MOE_SVC = dict(theta=0.85, lam=0.05, dim=2048, capacity=8192, block=128)
NEAR_TIE = 1e-6     # router probabilities this close may rank differently
MOE_RTOL = 1e-5     # layer 0's MoE output, card against CPU, of its largest |y|
                    # (f32 against f64 at this width: ~1e-6 of it)
# 4r: caches of 4 x 512 primed by a 448-token prefill, then 64 decode steps;
# logits against the full dropless forward within DECODE_RTOL of its
# largest logit (f32 sums in another order through 16 layers)
DECODE = dict(batch=4, max_len=512, prefill=448, steps=64)
DECODE_RTOL = 1e-4


def _planted_sources(stream, recent: int = 256) -> list:
    """The planted copies of a ``token_requests`` stream and their
    sources as document indices (the service's uids): for each document,
    the one among the ``recent`` before its request that shares most of
    its tokens, where that share is above half (a copy keeps ~95 %; two
    drawn documents share next to none)."""
    docs = np.concatenate([t for t, _ in stream])
    B = len(stream[0][0])
    out = []
    for r in range(1, len(stream)):
        lo = max(0, r * B - recent)
        same = (docs[r * B:(r + 1) * B, None] == docs[None, lo:r * B]).mean(-1)
        for i in np.nonzero(same.max(1) > 0.5)[0]:
            out.append((r * B + int(i), lo + int(same[i].argmax())))
    return out


def _moe_layer_check(dev, cfg, params, toks) -> dict:
    """Layer 0's MoE on the card against a CPU run of the port's ``moe``
    (IEEE f32 on both) on the same hidden states: those of one request's
    documents, the whole capacity dispatch.  Expert indices must be equal
    but for tokens whose router probabilities tie within ``NEAR_TIE``
    (the K-th against the (K+1)-th, or two within the top K: counted and
    reported); a token whose expert *set* differs moves the queue
    positions of its dispatch group, so such groups are counted and left
    out of the keep-mask and output comparisons.  Keep masks equal;
    outputs within ``MOE_RTOL`` of the largest |y|."""
    import torch
    from repro_torch._device import ieee_f32
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm
    from repro_torch.models.lm import _layer
    from repro_torch.models.moe import _dispatch, _route, moe

    mc, D = cfg.moe, cfg.d_model
    p0 = _layer(params["groups"][0]["stacked"], 0)
    tt = torch.from_numpy(toks).to(dev)
    B, S = tt.shape
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)

    def run(p, h):
        _, idx, probs = _route(mc, h.reshape(-1, D) @ p["router"])
        G, _, keep, _, _ = _dispatch(mc, idx, False)
        y, aux = moe(p, cfg, h)
        return y.reshape(-1, D), aux, idx, keep.view(idx.shape), probs, G

    with ieee_f32(dev):
        x = torch.nn.functional.embedding(tt.long(), params["embed"])
        a, _ = attention(p0["attn"], cfg, rms_norm(p0["norm1"], x, cfg.norm_eps), pos,
                         positions_are_arange=True)
        h = rms_norm(p0["norm2"], x + a, cfg.norm_eps)
        card = run(p0["moe"], h)
    y, aux, idx, keep, probs = (t.cpu() for t in card[:5])
    G = card[5]
    t0 = time.monotonic()
    y_c, aux_c, idx_c, keep_c, _, _ = run(params_from_numpy(params_to_numpy(p0["moe"]), "cpu"),
                                          h.cpu())
    cpu_s = time.monotonic() - t0

    K = mc.top_k
    top = probs.sort(-1, descending=True).values[:, :K + 1]
    near_k = (top[:, K - 1] - top[:, K]) <= NEAR_TIE
    near_order = ((top[:, :K - 1] - top[:, 1:K]) <= NEAR_TIE).any(1)
    differ = (idx != idx_c).any(1)
    if bool((differ & ~(near_k | near_order)).any()):
        raise AssertionError("moe layer 0: expert indices differ on the card and the CPU "
                             "away from any near-tie")
    set_flip = (idx.sort(1).values != idx_c.sort(1).values).any(1)
    T = idx.shape[0]
    excluded = set_flip.view(G, T // G).any(1)
    ok = ~excluded.repeat_interleave(T // G)
    if bool((keep != keep_c)[ok].any()):
        raise AssertionError("moe layer 0: keep masks differ on the card and the CPU")
    scale = float(y_c.abs().max())
    err = float((y - y_c)[ok].abs().max())
    if not err <= MOE_RTOL * scale:
        raise AssertionError(f"moe layer 0: outputs differ by {err} (largest |y| {scale})")
    return {"tokens": T, "dispatch_groups": G, "near_ties_kth": int(near_k.sum()),
            "near_ties_within_top_k": int(near_order.sum()),
            "indices_differ": int(differ.sum()), "expert_sets_differ": int(set_flip.sum()),
            "groups_excluded": int(excluded.sum()), "slots": keep.numel(),
            "slots_dropped": int((~keep).sum()),
            "tokens_all_dropped": int((~keep.any(1)).sum()),
            "max_abs_err": err, "max_abs_y": scale, "rtol": MOE_RTOL,
            "aux_card": float(aux), "aux_cpu": float(aux_c), "cpu_s": cpu_s}


def phase_moe_serve(dev, smi, cfg, params, rec0) -> dict:
    """4p: the system end to end (:func:`_lm_serve`) at olmoe-1b-7b's full
    width, capacity dispatch, into ``SSSJService(theta=0.85, lam=0.05,
    dim=2048, capacity=8192, block=128)``; layer 0's MoE on the card
    against the CPU (:func:`_moe_layer_check`); planted copies found: a
    copy and its source emitted as a pair (capacity drops can move a
    copy's embedding away from its source's)."""
    rec, launches, stream, _, flat = _lm_serve(dev, smi, cfg, params, rec0, MOE_SERVE,
                                               MOE_SVC, "moe serve", "moe_serve")
    rec["moe_layer0"] = _moe_layer_check(dev, cfg, params, stream[0][0])
    copies = _planted_sources(stream)
    emitted = {(a, b) for a, b, _ in flat}
    rec.update(planted_detected=len(copies),
               planted_found=sum(pair in emitted for pair in copies))
    _emit_phase(rec)
    return launches


def _cache_bytes(caches) -> int:
    """The bytes of every leaf of ``init_lm_caches``' list (attention
    caches, and the recurrent states of an xLSTM group's dict)."""
    if isinstance(caches, dict):
        return sum(_cache_bytes(c) for c in caches.values())
    if isinstance(caches, (list, tuple)):
        return sum(_cache_bytes(c) for c in caches)
    return caches.numel() * caches.element_size()


def phase_decode(dev, smi, cfg, params, phase="moe_decode", protocol=DECODE) -> dict:
    """4r (olmoe-1b-7b), 4u (xlstm-350m) and 4x (zamba2-2.7b, on
    ``ZAMBA_DECODE``): ``init_lm_caches(cfg, 4, 512, f32)`` primed by
    ``lm_forward(caches=)`` over 448 tokens (``protocol``), then 64
    ``lm_decode_step``s, teacher-forced: the prefill's and each step's
    logits against the cache-less ``lm_forward`` over all 512 tokens at
    the same positions, within ``DECODE_RTOL`` of its largest |logit|; the
    argmax token equal wherever the full forward's top two logits differ
    by more than that.  Both forwards run MoE blocks dropless (what decode
    computes; no effect on xLSTM blocks).  xLSTM's mLSTM blocks run the
    prefill in chunks of 64, the full forward in chunks of 256 and each
    step as one chunk of one token; its sLSTM blocks run one host step a
    token.  zamba's Mamba2 layers run the prefill as one SSD chunk of
    192, the full forward as one of 256 and each step as the recurrent
    update; its shared block runs the dense softmax over the cache.  Each
    decode step but the last two is timed alone (host clock ending in a
    sync), the last two run under the profiler (busy share, device
    launches a step, device time by kernel); no kernel of the port runs
    on this path."""
    import torch
    from repro_torch.models import init_lm_caches, lm_decode_step, lm_forward

    label = phase.replace("_", " ")
    t_phase = time.monotonic()
    B, M, P, n = (protocol[k] for k in ("batch", "max_len", "prefill", "steps"))
    rng = np.random.default_rng(SEED + 6)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P + n))
                            .astype(np.int32)).to(dev)
    f32 = dict(compute_dtype=torch.float32)
    _reset_peak(dev)

    def run():
        sync(dev)
        t0 = time.monotonic()
        caches = init_lm_caches(cfg, B, M, torch.float32, device=dev)
        cache_bytes = _cache_bytes(caches)
        pre, _, caches = lm_forward(params, cfg, tokens=toks[:, :P], caches=caches,
                                    cache_len=0, moe_dropless=True, **f32)
        sync(dev)
        prefill_s = time.monotonic() - t0
        steps, step_s = [], []

        def step(pos):
            nonlocal caches
            logits, caches = lm_decode_step(params, cfg, toks[:, pos:pos + 1], caches, pos,
                                            **f32)
            steps.append(logits[:, 0])

        for pos in range(P, P + n - 2):
            t0 = time.monotonic()
            step(pos)
            sync(dev)
            step_s.append(time.monotonic() - t0)
        _, prof = _profile(lambda: [step(pos) for pos in range(P + n - 2, P + n)], dev)
        return pre, torch.stack(steps, 1), prefill_s, step_s, prof, cache_bytes

    (pre, dec, prefill_s, step_s, prof, cache_bytes), launches = _count_lm_launches(run)
    peak_gib = _peak_gib(dev)
    _expect_lm_launches(label, launches, 0, flash=0)
    sync(dev)
    t0 = time.monotonic()
    full, _, _ = lm_forward(params, cfg, tokens=toks, moe_dropless=True, **f32)
    sync(dev)
    full_s = time.monotonic() - t0
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(pre).all())):
        raise AssertionError(f"{label}: logits not finite")
    tol = DECODE_RTOL * float(full.abs().max())
    want = full[:, P:]
    err = float((dec - want).abs().max())
    err_prefill = float((pre - full[:, :P]).abs().max())
    if not (err <= tol and err_prefill <= tol):
        raise AssertionError(f"{label}: logits differ from the full forward by {err} "
                             f"(prefill {err_prefill}), tolerance {tol}")
    top2 = want.topk(2, -1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol
    same = dec.argmax(-1) == want.argmax(-1)
    if not bool(same[decided].all()):
        raise AssertionError(f"{label}: the argmax token differs where the top two "
                             "logits are apart")
    emit({"phase": phase, "nvidia_smi": smi, "arch": cfg.name, **protocol,
          "cache_gib": cache_bytes / 2**30, "cache_bytes": cache_bytes,
          "launches": launches, "prefill_s": prefill_s,
          "decode_ms_median": 1e3 * float(np.median(step_s)),
          "decode_ms_first": 1e3 * step_s[0], "decode_ms_max": 1e3 * max(step_s),
          "tokens_per_s": B * len(step_s) / sum(step_s), "full_forward_s": full_s,
          "profiled_steps": 2, "device_busy_share": prof["device_busy_share"],
          "device_launches_per_step": prof["device_launches"] / 2,
          "device_ms_per_step": prof["device_busy_ms"] / 2,
          "max_abs_err": err, "max_abs_err_prefill": err_prefill, "tol": tol,
          "rtol": DECODE_RTOL, "max_abs_logit": float(full.abs().max()),
          "argmax_decided": int(decided.sum()), "argmax_positions": decided.numel(),
          "peak_gib": peak_gib, "phase_s": time.monotonic() - t_phase, "profile": prof})
    return launches


# --------------------------------------------------------------------- #
# phases 4s-4u: the xLSTM block kinds and their decode
# --------------------------------------------------------------------- #
# xlstm-350m at its full width (src/repro_torch/configs/xlstm_350m.py: 24
# layers in 3 units of 7 mLSTM blocks and an sLSTM block, d_model 1024, 4
# heads: the mLSTM's inner width 2,048, head dim 512; the sLSTM's head dim
# 256; conv width 4; vocabulary 50,304, untied head), random f32 weights
# drawn on the card from SEED: 528,351,400 parameters, 1.97 GiB
XLSTM_ARCH = "xlstm-350m"
# 4s: 16 requests of 128 documents x 64 tokens (not 32: the script's time;
# one mLSTM chunk of 64 a document, 64 sLSTM host steps a block), 25 %
# planted near-duplicates, into 4k's service (2,048 documents: no wrap)
XLSTM_SERVE = dict(requests=16, batch=128, seq=64, dup_frac=0.25, seed=SEED)
# 4s: unit embeddings, card against CPU.  The random-weight xLSTM stack
# magnifies f32 rounding layer by layer (at reduced() size on the CPU, an
# input perturbed by one ulp moves its hidden state by 25 ulps after 4
# blocks, a GQA stack's by 5); 24 blocks at this width put the card 2.9e-5
# from the CPU.  The phase reports the same ulp probe on the card
# (``embed_ulp_sensitivity``); TF32 would move them by ~1e-3
XLSTM_EMBED_TOL = 1e-4
# 4t: one block's residual branch on the card against the CPU, and the
# mLSTM's one-token steps against its chunk form, within XLSTM_RTOL of the
# largest |value| (f32 sums in another order: 1.6e-6 of it, the port
# against the reference on the CPU at this width over 512 tokens)
XLSTM_RTOL = 2e-5
XLSTM_STEP_TOKENS = 256     # one chunk of 256 against 256 steps of one


def _device_trace(fn, dev) -> tuple:
    """One call of ``fn`` under ``torch.profiler``'s CUDA trace, read from
    its raw events (no Python object an event: a forward of 2,048 sLSTM
    steps launches 100,000 and more): ``(out, {device_busy_ms,
    device_launches, wall_ms, device_busy_share})`` over the device's
    kernels, copies and fills (on the CPU: zeros)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        out = fn()
        sync(dev)
        wall_ms = 1e3 * (time.monotonic() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns = n = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda and e.duration_ns() > 0
                and not getattr(e, "is_user_annotation", lambda: False)()):
            busy_ns += e.duration_ns()
            n += 1
    return out, {"device_busy_ms": busy_ns / 1e6, "device_launches": n, "wall_ms": wall_ms,
                 "device_busy_share": busy_ns / 1e6 / wall_ms}


def _rel_err(got, want) -> dict:
    """The largest |got - want| (both on the host) against the largest
    |want|."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs": float(want.abs().max())}


def _ulp_probe(dev, cfg, params, docs) -> float:
    """How far f32 rounding alone moves this stack's output: ``docs``'
    unit embeddings with every embedding-table entry moved by one ulp (a
    seeded sign) against the same embeddings unmoved."""
    import torch
    from repro_torch.serving import pooled_unit_embed

    docs = torch.from_numpy(docs).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    sign = torch.randint(0, 2, params["embed"].shape, generator=gen, device=dev) * 2 - 1
    nudged = dict(params, embed=params["embed"] * (1 + 2.0 ** -23 * sign))
    del sign
    return float((pooled_unit_embed(nudged, cfg, docs)
                  - pooled_unit_embed(params, cfg, docs)).abs().max())


def phase_xlstm_serve(dev, smi, cfg, params, rec0) -> dict:
    """4s: the system end to end (:func:`_lm_serve`) at xlstm-350m's full
    width into ``SSSJService(theta=0.85, lam=0.05, dim=1024,
    capacity=8192, block=128)``: 21 mLSTM blocks (one chunk of 64 a
    document) and 3 sLSTM blocks (64 host steps each) a forward;
    ``SERVE_CPU_DOCS`` documents re-embedded on the CPU within
    ``EMBED_TOL`` (:func:`_cpu_embed_check`); planted copies found.  The
    device launches of one forward of a request, and of one sLSTM block
    at S 64 and S 32 (their difference over 32: the host loop's launches
    a step), from the profiler."""
    import torch
    from repro_torch.models.lm import _layer
    from repro_torch.models.xlstm import slstm_block
    from repro_torch.serving import pooled_unit_embed

    rec, launches, stream, recorded, flat = _lm_serve(dev, smi, cfg, params, rec0,
                                                      XLSTM_SERVE, SERVE_SVC, "xlstm serve",
                                                      "xlstm_serve")
    rec["cpu_embed_max_abs_err"] = _cpu_embed_check(cfg, params, stream, recorded,
                                                    "xlstm serve", XLSTM_EMBED_TOL)
    rec["embed_ulp_sensitivity"] = _ulp_probe(dev, cfg, params, stream[0][0][:SERVE_CPU_DOCS])
    gen = torch.Generator(dev).manual_seed(SEED)
    copies = _planted_sources(stream)
    emitted = {(a, b) for a, b, _ in flat}
    rec.update(planted_detected=len(copies),
               planted_found=sum(pair in emitted for pair in copies))

    toks = torch.from_numpy(stream[0][0]).to(dev)
    _, prof = _device_trace(lambda: pooled_unit_embed(params, cfg, toks), dev)
    p_s = _layer(params["groups"][0]["stacked"], 0)["slstm"]
    B, S = toks.shape
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    block = {}
    for n in (S, S // 2):
        _, p = _device_trace(lambda: slstm_block(p_s, cfg, x[:, :n]), dev)
        block[n] = p["device_launches"]
    rec.update(forward_launches=prof["device_launches"],
               forward_profiled_device_ms=prof["device_busy_ms"],
               forward_profiled_wall_ms=prof["wall_ms"],
               forward_profiled_busy_share=prof["device_busy_share"],
               slstm_block_launches=block[S],
               slstm_launches_per_step=(block[S] - block[S // 2]) / (S - S // 2))
    _emit_phase(rec)
    return launches


def phase_xlstm_long(dev, smi, cfg, params) -> dict:
    """4t: 8 documents of 2,048 tokens through ``pooled_unit_embed``: each
    mLSTM block runs 8 chunks of 256, each sLSTM block 2,048 host steps;
    finite unit embeddings, no kernel of the port launched.  The forward
    unprofiled (wall), then under the profiler (device ms, launches, busy
    share).  On the first document: layer 0's ``mlstm_block`` on the card
    against the same block on the CPU; unit 0's ``slstm_block`` (its input
    the card's output of the unit's 7 mLSTM blocks) on the card against
    the CPU; and on the card layer 0's ``mlstm_block`` fed the first 256
    tokens one at a time through a cache (chunks of 1) against one call
    over them (a chunk of 256), outputs and final states: each within
    ``XLSTM_RTOL`` of its largest |value| (the blocks' residual branches,
    ``out - x``)."""
    import torch
    from repro_torch._device import ieee_f32
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.models.lm import _layer
    from repro_torch.models.xlstm import (
        _mlstm_chunk_size,
        init_mlstm_cache,
        mlstm_block,
        slstm_block,
    )
    from repro_torch.serving import pooled_unit_embed

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (LONG_DOCS, LONG_SEQ))
                            .astype(np.int32)).to(dev)
    forward = lambda: pooled_unit_embed(params, cfg, toks)   # noqa: E731
    _reset_peak(dev)

    def run():
        sync(dev)
        t0 = time.monotonic()
        out = forward()
        sync(dev)
        return out, time.monotonic() - t0

    (out, seconds), launches = _count_lm_launches(run)
    peak_gib = _peak_gib(dev)
    _expect_lm_launches("xlstm long", launches, 0, flash=0)
    norms = torch.linalg.vector_norm(out, dim=1)
    if not (bool(torch.isfinite(out).all())
            and float((norms - 1.0).abs().max()) <= EMBED_TOL):
        raise AssertionError("xlstm long: embeddings not finite unit vectors")
    _, prof = _device_trace(forward, dev)

    unit0 = _layer(params["groups"][0]["stacked"], 0)
    p_m = _layer(unit0["mlstm"], 0)
    n = XLSTM_STEP_TOKENS
    with ieee_f32(dev):
        x = torch.nn.functional.embedding(toks[:1].long(), params["embed"])
        y_card, _ = mlstm_block(p_m, cfg, x)
        h = y_card
        for j in range(1, cfg.xlstm.slstm_every - 1):
            h, _ = mlstm_block(_layer(unit0["mlstm"], j), cfg, h)
        s_card, _ = slstm_block(unit0["slstm"], cfg, h)
        whole_c, step_c = (init_mlstm_cache(cfg, 1, torch.float32, dev) for _ in range(2))
        whole, _ = mlstm_block(p_m, cfg, x[:, :n], whole_c)
        steps = torch.empty_like(whole)
        sync(dev)
        t0 = time.monotonic()
        for t in range(n):
            steps[:, t:t + 1] = mlstm_block(p_m, cfg, x[:, t:t + 1], step_c)[0]
        sync(dev)
        step_ms = 1e3 * (time.monotonic() - t0) / n
    t0 = time.monotonic()
    on_cpu = lambda tree: params_from_numpy(params_to_numpy(tree), "cpu")   # noqa: E731
    y_cpu, _ = mlstm_block(on_cpu(p_m), cfg, x.cpu())
    s_cpu, _ = slstm_block(on_cpu(unit0["slstm"]), cfg, h.cpu())
    cpu_s = time.monotonic() - t0
    checks = {
        "mlstm_card_vs_cpu": _rel_err(y_card - x, y_cpu - x.cpu()),
        "slstm_card_vs_cpu": _rel_err(s_card - h, s_cpu - h.cpu()),
        "mlstm_steps_vs_chunk": _rel_err(steps - x[:, :n], whole - x[:, :n]),
        **{f"mlstm_state_{f}_steps_vs_chunk": _rel_err(a, b)
           for f, a, b in zip(step_c._fields, step_c, whole_c)},
    }
    for name, c in checks.items():
        if not c["max_abs_err"] <= XLSTM_RTOL * c["max_abs"]:
            raise AssertionError(f"xlstm long: {name} differs by {c['max_abs_err']} "
                                 f"(largest |value| {c['max_abs']})")
    emit({"phase": "xlstm_long", "arch": cfg.name, "nvidia_smi": smi,
          "documents": LONG_DOCS, "tokens": LONG_SEQ,
          "mlstm_chunk": _mlstm_chunk_size(cfg, LONG_SEQ), "launches": launches,
          "seconds": seconds, "forward_wall_ms": 1e3 * seconds,
          "tokens_per_s": LONG_DOCS * LONG_SEQ / seconds,
          "forward_device_ms": prof["device_busy_ms"],
          "forward_profiled_wall_ms": prof["wall_ms"],
          "device_busy_share": prof["device_busy_share"],
          "device_launches": prof["device_launches"],
          "norm_err": float((norms - 1.0).abs().max()), "peak_gib": peak_gib,
          "checks": checks, "rtol": XLSTM_RTOL, "step_tokens": n,
          "mlstm_step_ms": step_ms, "cpu_checks_s": cpu_s,
          "phase_s": time.monotonic() - t_phase})
    return launches


# --------------------------------------------------------------------- #
# phases 4v-4x: the Mamba2 hybrid and its decode
# --------------------------------------------------------------------- #
# zamba2-2.7b at its full width (src/repro_torch/configs/zamba2_2_7b.py: 54
# Mamba2 layers in 9 units of 6, each unit followed by one invocation of
# the one shared attention+MLP block (32 heads = 32 kv heads of 80, d_ff
# 10,240); d_model 2,560, d_inner 5,120 in 80 SSD heads of 64, d_state 64,
# conv width 4, SSD chunks of 256; vocabulary 32,000, untied head), random
# f32 weights drawn on the card from SEED: 2,422,670,240 parameters, 9.02 GiB
ZAMBA_ARCH = "zamba2-2.7b"
# 4v: 16 requests of 128 documents x 64 tokens (one SSD chunk of 64 a
# layer), 25 % planted near-duplicates, into 4k's service at d 2,560
# (2,048 documents: no wrap)
ZAMBA_SERVE = dict(requests=16, batch=128, seq=64, dup_frac=0.25, seed=SEED)
ZAMBA_SVC = dict(SERVE_SVC, dim=2560)
ZAMBA_EMBED_TOL = EMBED_TOL
# 4w: unit 0's first Mamba2 layer (its residual branch), card against CPU,
# within MAMBA_RTOL of its largest |value| (f32 sums in another order)
MAMBA_RTOL = 2e-5
MAMBA_CHECK_DOCS = 2
# 4x: 4r's protocol cut to what the reference's SSD takes: caches of 4 x
# 256, one prefill of 192 tokens (one chunk), 64 steps against the
# cache-less forward over 256 tokens (one chunk of 256); 4r's prefill of
# 448 is no multiple of a chunk of 256, which the reference's reshape
# refuses, and a prefill with a cache restarts the SSD state, so decode
# continues only from a prefill into empty caches
ZAMBA_DECODE = dict(batch=4, max_len=256, prefill=192, steps=64)
# 4v and 4w time one forward once, with no warm-up call (the phase's own
# run warmed it): 1.4 and 3.1 s a forward, where 4k's take 0.26 s
ZAMBA_FWD = (1, 0)


def phase_zamba_serve(dev, smi, cfg, params, rec0) -> dict:
    """4v: the system end to end (:func:`_lm_serve`) at zamba2-2.7b's full
    width into ``SSSJService(theta=0.85, lam=0.05, dim=2560,
    capacity=8192, block=128)``: 54 Mamba2 layers (one SSD chunk of 64 a
    document) and 9 invocations of the shared block a forward;
    ``SERVE_CPU_DOCS`` documents re-embedded on the CPU within
    ``ZAMBA_EMBED_TOL`` (:func:`_cpu_embed_check`, timed) beside the
    one-ulp probe (:func:`_ulp_probe`); planted copies found; the device
    launches of one forward of a request, from the profiler."""
    import torch
    from repro_torch.serving import pooled_unit_embed

    rec, launches, stream, recorded, flat = _lm_serve(dev, smi, cfg, params, rec0,
                                                      ZAMBA_SERVE, ZAMBA_SVC, "zamba serve",
                                                      "zamba_serve", ZAMBA_FWD)
    t0 = time.monotonic()
    rec["cpu_embed_max_abs_err"] = _cpu_embed_check(cfg, params, stream, recorded,
                                                    "zamba serve", ZAMBA_EMBED_TOL)
    rec["cpu_embed_s"] = time.monotonic() - t0
    rec["cpu_embed_documents"] = SERVE_CPU_DOCS
    rec["embed_ulp_sensitivity"] = _ulp_probe(dev, cfg, params, stream[0][0][:SERVE_CPU_DOCS])
    copies = _planted_sources(stream)
    emitted = {(a, b) for a, b, _ in flat}
    rec.update(planted_detected=len(copies),
               planted_found=sum(pair in emitted for pair in copies))
    toks = torch.from_numpy(stream[0][0]).to(dev)
    _, prof = _device_trace(lambda: pooled_unit_embed(params, cfg, toks), dev)
    rec.update(forward_launches=prof["device_launches"],
               forward_profiled_device_ms=prof["device_busy_ms"],
               forward_profiled_wall_ms=prof["wall_ms"],
               forward_profiled_busy_share=prof["device_busy_share"])
    _emit_phase(rec)
    return launches


def phase_zamba_long(dev, smi, cfg, params) -> tuple:
    """4w: :func:`phase_lm_long` at zamba2-2.7b's full width: 8 documents
    of 2,048 tokens (8 SSD chunks of 256 a layer), each of the 9
    invocations of the shared block on ``flash_attn.cu`` (H 32 = Hkv, Dh
    80 padded to 128); the flash check on the shared block's first
    invocation, its input unit 0's six Mamba2 layers run on the card; the
    first of them (its residual branch, on ``MAMBA_CHECK_DOCS`` documents)
    against the same layer on the CPU within ``MAMBA_RTOL`` of its largest
    |value|.  Returns ``(launches, flash record)``."""
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.models.common import rms_norm
    from repro_torch.models.lm import _layer
    from repro_torch.models.ssm import mamba2

    unit0 = _layer(params["groups"][0]["stacked"], 0)
    checks: dict = {}

    def attn_input(x):
        for j in range(cfg.hybrid.shared_every):
            p = _layer(unit0, j)
            y, _ = mamba2(p["mamba"], cfg, rms_norm(p["norm"], x, cfg.norm_eps))
            if j == 0:
                n = MAMBA_CHECK_DOCS
                t0 = time.monotonic()
                on_cpu = params_from_numpy(params_to_numpy(p), "cpu")
                y_cpu, _ = mamba2(on_cpu["mamba"], cfg,
                                  rms_norm(on_cpu["norm"], x[:n].cpu(), cfg.norm_eps))
                c = _rel_err(y[:n], y_cpu)
                if not c["max_abs_err"] <= MAMBA_RTOL * c["max_abs"]:
                    raise AssertionError(f"zamba long: Mamba2 layer 0 differs on the card and "
                                         f"the CPU by {c['max_abs_err']} (largest |value| "
                                         f"{c['max_abs']})")
                checks.update(mamba_layer0_card_vs_cpu=c, mamba_rtol=MAMBA_RTOL,
                              mamba_check_documents=n, mamba_cpu_s=time.monotonic() - t0)
            x = x + y
        return x, params["groups"][0]["shared"]

    return phase_lm_long(dev, smi, cfg, params, "zamba_long", attn_input=attn_input,
                         flash_launches=cfg.n_layers // cfg.hybrid.shared_every,
                         extra=lambda: checks, fwd=ZAMBA_FWD)


# --------------------------------------------------------------------- #
# phase 5: flash attention
# --------------------------------------------------------------------- #
# (label, B, H, Hkv, S, Dh, causal, dtype): the head geometry of qwen3-0.6b
# (src/repro/configs/qwen3_0_6b.py: 16 heads, 8 kv heads, head_dim 128) at
# a 4096-token prefill and of qwen2.5-3b (qwen2_5_3b.py: 16 heads, 2 kv
# heads, 2048 / 16 = 128) at 2048; a ragged S, head dims the kernel pads
# (80 -> 128, 200 -> 256) and every compiled width in f32 and in bf16,
# head dims above 256 (320 -> 384 in three column slices of 128, 512 in
# four), and a non-causal aligned case
FLASH_CASES = (
    ("qwen3-0.6b f32", 1, 16, 8, 4096, 128, True, "float32"),
    ("qwen3-0.6b bf16", 1, 16, 8, 4096, 128, True, "bfloat16"),
    ("qwen2.5-3b f32", 1, 16, 2, 2048, 128, True, "float32"),
    ("qwen2.5-3b bf16", 1, 16, 2, 2048, 128, True, "bfloat16"),
    ("ragged S 1000 f32", 1, 16, 8, 1000, 128, True, "float32"),
    ("ragged S 1000 bf16", 1, 16, 8, 1000, 128, True, "bfloat16"),
    ("head dim 80 f32", 1, 16, 8, 1024, 80, True, "float32"),
    ("head dim 32 f32", 1, 16, 8, 1024, 32, True, "float32"),
    ("head dim 64 f32", 1, 16, 8, 1024, 64, True, "float32"),
    ("head dim 200 f32", 1, 16, 8, 1024, 200, True, "float32"),
    ("head dim 32 bf16", 1, 16, 8, 1024, 32, True, "bfloat16"),
    ("head dim 64 bf16", 1, 16, 8, 1024, 64, True, "bfloat16"),
    ("head dim 200 bf16", 1, 16, 8, 1024, 200, True, "bfloat16"),
    ("head dim 320 f32", 1, 16, 8, 1024, 320, True, "float32"),
    ("head dim 512 bf16", 1, 16, 8, 1024, 512, True, "bfloat16"),
    ("non-causal S 2048 f32", 1, 16, 8, 2048, 128, False, "float32"),
    ("non-causal S 2048 bf16", 1, 16, 8, 2048, 128, False, "bfloat16"),
)
FLASH_TIMED = ("qwen3-0.6b f32", "qwen3-0.6b bf16", "qwen2.5-3b f32", "qwen2.5-3b bf16")
FLASH_F32_TOL = 2e-5   # f32 sums in another order, at S 4096
FLASH_TIMES = TIMES + ("bound_ms", "bound_by", "library_ms", "library_device_ms")


def _bf16_ulp(x):
    """The spacing of bf16 numbers at ``|x|`` (8 significant bits)."""
    import torch

    mag = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _flash_plain(q, k, v, causal):
    """``flash_attention_plain`` over the inputs as the entry point pads
    them (blocks of min(128, round_up(S, 8)))."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain

    S = q.shape[2]
    blk = min(128, -(-S // 8) * 8)
    pad = (0, 0, 0, (-S) % blk)
    q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    return flash_attention_plain(q, k, v, sm_scale=q.shape[-1] ** -0.5,
                                 causal=causal, block_q=blk, block_k=blk)[:, :, :S]


def phase_flash(dev, smi) -> dict:
    """Every case of ``FLASH_CASES`` through ``flash_attention`` (the launch
    counter read around that run only), each output held against the plain
    version on the card: f32 within ``FLASH_F32_TOL``, bf16 within one bf16
    ulp at the plain output's largest magnitude (the kernel's and the plain
    version's f32 values, a few 1e-7 apart, may round to neighbouring bf16
    numbers; near zero one such step is many ulps of the small value).  The
    full-width cases are timed beside their plain version and one
    ``scaled_dot_product_attention`` call on the same inputs."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_kernel_call,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        KERNEL_HEAD_DIMS,
        SLICE,
        kernel_head_dim,
        kernel_route,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    inputs = {}
    for label, B, H, Hkv, S, Dh, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        inputs[label] = tuple(
            torch.randn(shape, generator=gen, device=dev).to(dt)
            for shape in ((B, H, S, Dh), (B, Hkv, S, Dh), (B, Hkv, S, Dh)))

    flash_attention_kernel_call.launches = 0
    outs = {case[0]: flash_attention(*inputs[case[0]], causal=case[6], device=dev)
            for case in FLASH_CASES}
    sync(dev)
    launches = flash_attention_kernel_call.launches
    # one launch a case, one a column slice above the compiled head dims
    expected = sum(1 if case[5] <= KERNEL_HEAD_DIMS[-1] else kernel_head_dim(case[5]) // SLICE
                   for case in FLASH_CASES)
    if launches != expected:
        raise AssertionError(f"flash attention launched {launches} times for "
                             f"{len(FLASH_CASES)} cases, expected {expected}")

    cases = {}
    for label, B, H, Hkv, S, Dh, causal, dtype in FLASH_CASES:
        q, k, v = inputs[label]
        out, plain = outs[label], _flash_plain(q, k, v, causal)
        if out.shape != q.shape or out.dtype != q.dtype or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash {label}: output {tuple(out.shape)} {out.dtype}")
        err = (out.float() - plain.float()).abs()
        width = kernel_head_dim(Dh)
        rec = {"max_abs_err": float(err.max()),
               "route": kernel_route(q.dtype, width,
                                     width if width in KERNEL_HEAD_DIMS else SLICE)}
        if dtype == "float32":
            if not rec["max_abs_err"] <= FLASH_F32_TOL:
                raise AssertionError(f"flash {label}: max error {rec['max_abs_err']}")
        else:
            tol = float(_bf16_ulp(plain.float().abs().max()))
            rec.update(tol=tol, max_err_in_ulps=rec["max_abs_err"] / tol,
                       differ=int((err > 0).sum()), outputs=err.numel())
            if not rec["max_abs_err"] <= tol:
                raise AssertionError(f"flash {label}: max error {rec['max_abs_err']} "
                                     f"> one bf16 ulp {tol}")
        cases[label] = rec

    for label, B, H, Hkv, S, Dh, causal, dtype in FLASH_CASES:
        if label not in FLASH_TIMED:
            continue
        q, k, v = inputs[label]
        kw = dict(sm_scale=Dh ** -0.5, causal=causal, block_q=128, block_k=128)
        rec = cases[label]
        kern_call = lambda: flash_attention_kernel_call(q, k, v, **kw)  # noqa: E731
        plain_call = lambda: flash_attention_plain(q, k, v, **kw)  # noqa: E731
        lib_call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, scale=Dh ** -0.5, enable_gqa=True)
        parts: dict = {}
        rec.update(ms=cuda_ms(kern_call, 20),
                   device_ms=device_ms(kern_call, 20, "::flash_", parts=parts),
                   plain_ms=cuda_ms(plain_call, 5, 1),
                   plain_device_ms=device_ms(plain_call, 5, warmup=1),
                   library_ms=cuda_ms(lib_call, 20), library_device_ms=device_ms(lib_call, 20))
        flops = (2 if causal else 4) * B * H * S * S * Dh
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
        rec["device_ms_by_kernel"] = _by_kernel(parts)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, peak)
        if rec["route"] == "f32_3xtf32":   # the same work as three TF32 products
            rec["bound_3xtf32_ms"] = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)[0]
        rec["gflop"] = flops / 1e9
    emit({"phase": "flash", "nvidia_smi": smi, "launches": launches, "cases": cases})
    qwen = cases["qwen3-0.6b f32"]
    qwen_bf16 = cases["qwen3-0.6b bf16"]
    return {
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for label, c in cases.items()
                           if label.endswith("f32")),
        # the kernel it took, under its own key: "route" is the language
        "kernel_route": qwen["route"],
        **{key: qwen[key] for key in FLASH_TIMES + ("bound_3xtf32_ms",
                                                    "device_ms_by_kernel")},
        **{f"{key}_bf16": qwen_bf16[key] for key in FLASH_TIMES},
        "max_err_in_ulps_bf16": max(c.get("max_err_in_ulps", 0.0) for c in cases.values()),
        "f32_route_by_head_dim": {str(case[5]): cases[case[0]]["route"]
                                  for case in FLASH_CASES if case[7] == "float32"},
    }


KERNEL_PHASES = "--kernel-phases"   # the child's flag: phases 2 and 5 only


def kernel_phases_child(smi: str) -> int:
    """Phases 2 and 5 in a process of their own: their phase lines, then
    one line ``{"kernel_phases": {"kern": …, "flash": …}}`` for the parent."""
    import torch

    dev = torch.device("cuda")
    try:
        kern = phase_kernels(dev)
        flash = phase_flash(dev, smi)
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": "failed", "error": f"{type(exc).__name__}: {exc}"})
        raise
    emit({"kernel_phases": {"kern": kern, "flash": flash}})
    return 0


def run_kernel_phases(smi: str) -> tuple:
    """Phases 2 and 5 (every kernel against its plain version, timed) in a
    child process, on the kernels phase 1 built.  A process of their own
    gives their ``torch.profiler`` traces a profiler no engine phase has
    used: after the engine and consumer phases' traces, the trace held 6
    of 20 ``cand_kernel`` launches in each of five tries.  Returns
    ``(kern, flash)``."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), KERNEL_PHASES,
                           smi], stdout=subprocess.PIPE, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the kernel phases' process exited with {proc.returncode}")
    out = json.loads(lines[-1])["kernel_phases"]
    return out["kern"], out["flash"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    t_start = time.monotonic()
    sys.path.insert(0, str(ROOT / "src"))
    # plain versions and the dense oracle run in IEEE f32: TF32 moves
    # scores by ~1e-3, which moves pairs across θ
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] == KERNEL_PHASES:
        return kernel_phases_child(sys.argv[2])
    try:
        device = phase_device()
        smi = device["smi"]
        dev = torch.device("cuda")
        # the engine runs before the kernels' device timings: once
        # torch.profiler has traced, every later launch costs the host
        # more, and the engine's items/s is paced by its host loop
        phase_tile_edge_engine(dev)
        launches, requests, main_runs = phase_main_path(dev)
        by_path = {"main_path": dict(launches)}
        by_path["dense_path"] = phase_dense_path(dev, requests, main_runs, smi)
        launches["sssj_dense"] = by_path["dense_path"]["sssj_dense"]
        by_path["scan_route"] = phase_scan_route(dev, requests, main_runs, smi)
        by_path["service"] = phase_service(dev, requests, smi)
        by_path["blocked"] = phase_blocked(dev, requests, main_runs, smi)
        kern_run = main_runs["kernel"]
        del main_runs
        by_path["dedup"] = phase_dedup(dev, smi)
        t0 = time.monotonic()
        stream = _mt_stream()
        by_path["runtime"] = phase_runtime(dev, smi, stream, time.monotonic() - t0)
        by_path["isolation"] = phase_isolation(dev, smi)
        by_path["mt_service"] = phase_mt_service(dev, smi, stream)
        by_path["sharded_engine"] = phase_sharded_engine(dev, smi, requests, kern_run)
        by_path["ring_join"] = phase_ring_join(dev, smi, requests)
        by_path["sharded_service"] = phase_sharded_service(dev, smi, stream)
        del stream, kern_run
        by_path["gate_bits"] = phase_gate_bits(dev, smi)
        by_path["table1"] = phase_table1(dev, smi)
        t_lm = time.monotonic()
        cfg, params, lm_rec = lm_params(dev)
        by_path["lm_serve"] = phase_lm_serve(dev, smi, cfg, params, lm_rec)
        by_path["lm_long"], lm_flash = phase_lm_long(dev, smi, cfg, params)
        by_path["lm_fused"] = phase_lm_fused(dev, smi, cfg, params)
        del params                   # olmoe-1b-7b's 25.8 GiB come next
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params, moe_rec = lm_params(dev, MOE_ARCH)
        by_path["moe_serve"] = phase_moe_serve(dev, smi, cfg, params, moe_rec)
        by_path["moe_long"], moe_flash = phase_lm_long(dev, smi, cfg, params, "moe_long")
        by_path["moe_decode"] = phase_decode(dev, smi, cfg, params)
        del params                   # xlstm-350m's 1.97 GiB come next
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params, xlstm_rec = lm_params(dev, XLSTM_ARCH)
        by_path["xlstm_serve"] = phase_xlstm_serve(dev, smi, cfg, params, xlstm_rec)
        by_path["xlstm_long"] = phase_xlstm_long(dev, smi, cfg, params)
        by_path["xlstm_decode"] = phase_decode(dev, smi, cfg, params, "xlstm_decode")
        del params                   # zamba2-2.7b's 9.02 GiB come next
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params, zamba_rec = lm_params(dev, ZAMBA_ARCH)
        by_path["zamba_serve"] = phase_zamba_serve(dev, smi, cfg, params, zamba_rec)
        by_path["zamba_long"], zamba_flash = phase_zamba_long(dev, smi, cfg, params)
        by_path["zamba_decode"] = phase_decode(dev, smi, cfg, params, "zamba_decode",
                                               ZAMBA_DECODE)
        lm_s = time.monotonic() - t_lm
        del params
        gc.collect()
        torch.cuda.empty_cache()     # the child's phases need the card's memory
        kern, flash = run_kernel_phases(smi)
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": "failed", "error": f"{type(exc).__name__}: {exc}"})
        raise
    rows = [
        {"name": "sssj_cand", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sssj_cand.cu",
         "replaces": "src/repro/kernels/sssj_join/kernel.py:157"},
        {"name": "gate_ub", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gate_ub.cu",
         "replaces": "src/repro/kernels/sssj_join/gate.py:198"},
        {"name": "sssj_dense", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sssj_dense.cu",
         "replaces": "src/repro/kernels/sssj_join/kernel.py:140"},
    ]
    for row in rows:
        row.update(launches=launches[row["name"]], library_ms=None,
                   **kern[row["name"]])
        # the same kernel's launches on each path, each read around its run
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in by_path.items()}
        if row["name"] in device["ptxas_joins"]:
            row["ptxas_full_128"] = device["ptxas_joins"][row["name"]]
    rows[1]["ptxas"] = device["ptxas_gate"]
    # flash attention: its launches on the LM's long-document path (one a
    # layer), the f32 qwen3-0.6b case's numbers from phase 5, the bf16 ones
    # beside, and its times at the LM's shape
    rows.append({"name": "flash_attn", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:35",
                 **flash, "launches": by_path["lm_long"]["flash_attn"],
                 "launches_by_path": {
                     **{path: counts.get("flash_attn", 0) for path, counts in by_path.items()},
                     "flash_phase": flash["launches"]},
                 "lm_long_documents": lm_flash, "moe_long_documents": moe_flash,
                 "zamba_long_documents": zamba_flash,
                 "ptxas_bf16": device["ptxas_flash_bf16"],
                 "ptxas_f32_3xtf32": device["ptxas_flash_tf32"]})
    emit({"phase": "total", "seconds": time.monotonic() - t_start,
          "lm_phases_seconds": lm_s, "device_ms_fallbacks": len(DEVICE_MS_FALLBACKS)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

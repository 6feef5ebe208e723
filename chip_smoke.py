#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

1. device: the card's name and power limit (``nvidia-smi``), then the
   kernels built from ``src/repro_torch/kernels/csrc`` by ``nvcc``;
2. every kernel of the main path against its plain PyTorch version, on
   the card, at the shapes the main path gives it (integers exact, floats
   within ``FLOAT_TOL``), with CUDA-event times;
3. the main path: ``StreamEngine`` at ``capacity=262144, d=1024`` over a
   near-duplicate stream long enough to wrap the ring, with both kernels'
   launch counters read around the run, held against the same stream
   through ``join_impl="dense"`` on the card;
4. the ``kernels`` line: launches, error, times and bound of each kernel;
5. ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of the JAX package, and exits non-zero without a result
when there is no GPU or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
FLOAT_TOL = 1e-5       # scores and bounds: f32 sums in another order
BAND = 1e-5            # pairs this close to θ may differ between runs
# H100 SXM peaks at its 700 W limit: HBM bytes/s, and f32 FLOP/s outside
# the tensor cores (both kernels keep IEEE f32 dot products)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# the main path's configuration: the near-duplicate service's traffic
THETA, LAM = 0.9, 1e-3
CAPACITY, D, MICRO = 262144, 1024, 128
REQUEST, RATE = 4096, 1000.0
N_ITEMS = CAPACITY + 65536


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------- #
# phase 1
# --------------------------------------------------------------------- #
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
        name: [ln.strip() for ln in rec["log"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name, rec in built.items()
    }
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.monotonic() - t0, "ptxas": ptxas})
    return {"smi": smi}


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
        sssj_join_candidates_kernel_call as cand,
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
               "chunks_run": int(k_out[4].sum()), "tiles": k_out[4].numel()}
        if reps:
            rec["ms"] = cuda_ms(lambda: cand(*args, **ckw), reps)
            rec["plain_ms"] = cuda_ms(lambda: cand_tiles_plain(*args, **ckw), 3, 1)
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
    run_case(
        "ragged_d_two_q_tiles",
        (rq, rw, col(tq2), col(tw[-8192:]), col(uq2), col(uw[-8192:]),
         suffix_chunk_norms(rq, chunk), suffix_chunk_norms(rw, chunk)),
        dict(base, theta=0.5), reps=0,
    )
    # the multi-tenant lanes: stream ids and per-row (θ, λ)
    sid_q = torch.randint(0, 3, (MICRO,), generator=gen, device=dev, dtype=torch.int32)
    sid_w = torch.randint(0, 3, (CAPACITY,), generator=gen, device=dev, dtype=torch.int32)
    th_q = 0.85 + 0.1 * torch.rand((MICRO,), generator=gen, device=dev)
    lam_q = LAM * (0.5 + torch.rand((MICRO,), generator=gen, device=dev))
    run_case("multi_tenant", main_args,
             dict(base, sq=col(sid_q), sw=col(sid_w), theta_q=col(th_q),
                  lam_q=col(lam_q)), reps=0)

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
    if not ub_err <= FLOAT_TOL:
        raise AssertionError(f"gate bound max error {ub_err} > {FLOAT_TOL}")
    g_ms = cuda_ms(lambda: gate_mod.gate_ub(qa, qcn, vmax, cnorm, block_q=blk), 50)
    g_plain = cuda_ms(lambda: gate_mod.gate_ub_plain(qa, qcn, vmax, cnorm, block_q=blk), 20)

    # bounds from this run's inputs: each input read once, each output
    # written once; the tile join's work is the chunks its tiles ran
    nq, nw = 1, CAPACITY // blk
    chunks_run = gated["chunks_run"]
    j_bytes = (q.numel() * 4 + chunks_run * blk * chunk * 4  # q, w slabs run
               + CAPACITY * 4 * (2 + sqw.shape[1]) + MICRO * 4 * (2 + sqq.shape[1])
               + nq * nw * 4                                    # gate
               + nq * nw * (tile_k * 8 + blk * 4 + 8))          # outputs
    j_flops = chunks_run * 2 * blk * blk * chunk
    j_bound, j_by = bound_ms(j_bytes, j_flops)
    ns, nc = cnorm.shape
    g_bytes = 4 * (qa.numel() + qcn.numel() + vmax.numel() + cnorm.numel() + nq * ns)
    g_flops = 2 * MICRO * ns * (D + nc)
    g_bound, g_by = bound_ms(g_bytes, g_flops)
    emit({"phase": "kernels", "gate_stats": gate_stats.tolist(), "cases": cases,
          "gate_ub": {"max_abs_err": ub_err, "ms": g_ms, "plain_ms": g_plain}})
    return {
        "sssj_cand": {"max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                      "ms": gated["ms"], "plain_ms": gated["plain_ms"],
                      "bound_ms": j_bound, "bound_by": j_by},
        "gate_ub": {"max_abs_err": ub_err, "ms": g_ms, "plain_ms": g_plain,
                    "bound_ms": g_bound, "bound_by": g_by},
    }


# --------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------- #
def _requests(n_items: int):
    """The near-duplicate service's stream, made request by request: each
    request is ``dense_embedding_stream(REQUEST, D, rate=RATE)`` (15 %
    planted near-duplicates of the 64 items before them) from its own
    seed, its timestamps following on from the previous request's."""
    from repro_torch.data import dense_embedding_stream

    out, t_off = [], 0.0
    for r in range(-(-n_items // REQUEST)):
        n = min(REQUEST, n_items - r * REQUEST)
        v, t = dense_embedding_stream(n, D, seed=SEED * 100_003 + r, rate=RATE)
        out.append((v, t + t_off))
        t_off = float(t[-1] + t_off)
    return out


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

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    # device-side events only: an aten op's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "calls": e.count}
                for e in top],
    }


def _run_engine(dev, requests, n_profiled=2, **kw):
    """Stream ``requests`` through a fresh engine: all but the last
    ``n_profiled`` timed (pushes and drain, host clock, ending in a device
    sync), the last ones under the profiler.  Returns the drained pairs and
    row masks of the whole stream."""
    from repro_torch.engine import EngineConfig, StreamEngine

    eng = StreamEngine(
        EngineConfig(theta=THETA, lam=LAM, capacity=CAPACITY, d=D,
                     micro_batch=MICRO, **kw),
        device=dev,
    )

    def push_all(reqs):
        for v, t in reqs:
            eng.push(v, t)
        return eng.drain_arrays(return_masks=True)

    timed, profiled = requests[:-n_profiled], requests[-n_profiled:]
    try:
        sync(dev)
        t0 = time.monotonic()
        first = push_all(timed)
        sync(dev)
        seconds = time.monotonic() - t0
        last, prof = _profile(lambda: push_all(profiled), dev)
        ua, ub, sc, mask = (np.concatenate(x) for x in zip(first, last))
        return {"pairs": (ua, ub, sc), "mask": mask, "seconds": seconds,
                "timed_items": sum(len(v) for v, _ in timed), "profile": prof,
                "stats": eng.stats(), "metrics": eng.metrics()}
    finally:
        eng.close()


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

    ka, kb, ks = kern["pairs"]
    da, db, ds = dense["pairs"]
    for ua, ub, sc in (kern["pairs"], dense["pairs"]):
        if not (np.isfinite(sc).all() and (sc >= np.float32(THETA)).all()
                and (ua > ub).all() and (ub >= 0).all()):
            raise AssertionError("emitted pairs are not finite, ≥ θ, newer-first")
    kp = dict(zip(zip(ka.tolist(), kb.tolist()), ks.tolist()))
    dp = dict(zip(zip(da.tolist(), db.tolist()), ds.tolist()))
    differ = kp.keys() ^ dp.keys()
    band = {k: {**kp, **dp}[k] for k in differ}
    outside = {k: s for k, s in band.items() if abs(s - THETA) > BAND}
    if outside:
        raise AssertionError(f"pair sets differ outside the ε-band: {list(outside.items())[:5]}")
    common = kp.keys() & dp.keys()
    score_err = max((abs(kp[k] - dp[k]) for k in common), default=0.0)
    if score_err > FLOAT_TOL:
        raise AssertionError(f"pair scores differ by {score_err}")
    band_rows = {a for a, _ in differ}
    mask_diff = set(np.nonzero(kern["mask"] != dense["mask"])[0].tolist())
    if not mask_diff <= band_rows:
        raise AssertionError(f"row masks differ at rows {sorted(mask_diff)[:10]}")
    for key in ("pairs_dropped_budget", "pairs_dropped_tile", "window_overflow"):
        if kern["stats"][key] != dense["stats"][key]:
            raise AssertionError(f"{key}: kernel {kern['stats'][key]} vs "
                                 f"dense {dense['stats'][key]}")
    if kern["stats"]["n_items"] != N_ITEMS or len(kp) == 0:
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
        "pairs": len(kp), "dense_pairs": len(dp), "band_pairs": len(band),
        "band": [[a, b, s] for (a, b), s in sorted(band.items())][:20],
        "max_score_err": score_err, "launches": launches,
        "prune": prune, "stats": kern["stats"],
        "profile": {"kernel_path": kern["profile"], "dense_path": dense["profile"]},
    })
    return launches


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
    sys.path.insert(0, str(ROOT / "src"))
    # plain versions and the dense oracle run in IEEE f32: TF32 moves
    # scores by ~1e-3, which moves pairs across θ
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_device()
        dev = torch.device("cuda")
        kern = phase_kernels(dev)
        launches = phase_main_path(dev)
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
    ]
    for row in rows:
        row.update(launches=launches[row["name"]], library_ms=None,
                   **kern[row["name"]])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

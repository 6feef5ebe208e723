#!/usr/bin/env python3
"""Time the port's kernels in two checkouts in turns, on one GPU.

    python3 chip_turns.py A_ROOT B_ROOT [--out FILE] [--edge-engine]

Runs A, B, B, A, each in a process of its own (``--worker ROOT``) that
imports ``ROOT/src/repro_torch`` (whose kernels build into ``ROOT/build``),
makes the same seeded inputs with ``chip_smoke.py``'s generators, and
times each call twice: through its wrapper with CUDA events
(``chip_smoke.cuda_ms``, what a caller pays, key ``NAME``) and on the
device alone from the profiler's trace (``chip_smoke.device_ms``, the
kernel's own time, key ``NAME device``), so that a kernel shorter than
its wrapper's host time is still judged on the device:

* the tile joins and the gate bound at the main path's shapes (one query
  tile of 128 rows against a window of 262,144 x 1024, 128 x 128 tiles,
  chunk 128): ``sssj_cand`` on the gated window, on the self join and
  with every tile live (``chip_smoke.py``'s all-live case), ``sssj_dense``
  on the window and all live, ``gate_ub`` and ``gate_ub_plain``; then the
  same at 256 x 256 tiles (256 queries, ``tile_k`` 65,536), recorded as
  the error's text in a checkout whose wrappers refuse that edge;
* flash attention in f32 and bf16 at qwen3-0.6b's heads (B 1, H 16,
  Hkv 8, S 4096, Dh 128), qwen2.5-3b's (H 16, Hkv 2, S 2048) and
  qwen3-0.6b's at Dh 64 and 32, causal.

With ``--edge-engine`` each run instead drives the engine at the
consumers' 64 x 64 tiles (``chip_smoke.py``'s ``tile_edge_engine`` phase
configuration: capacity 65,536, d 256, 81,920 items): items/s of the
kernel route (key ``engine_64``) and of its ``join_impl="dense"`` oracle
(``engine_64 dense``), the kernel route's profiled tail per micro-batch
(``engine_64 launches``, ``engine_64 device_ms``, ``engine_64 wall_ms``),
and the gate bound alone at the engine's shapes (64 query rows, 1,024
strips of 64 x 256), through its wrapper and on the device
(``gate_ub_64``), with the gate step whole (``strip_gate_64 device``:
every device op of ``strip_gate``).

Prints the card's name and power limit, one JSON line per run, and a
summary line with each time's mean in A and in B and their ratio B / A;
``--out`` also writes them to a file.  Two versions are compared only
within one such call, in turns: times on one card move between calls.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (label, B, H, Hkv, S, Dh): the models' heads, and qwen3-0.6b's at the
# other head dims f32 runs on the tensor cores
FLASH = (("qwen3-0.6b", 1, 16, 8, 4096, 128), ("qwen2.5-3b", 1, 16, 2, 2048, 128),
         ("qwen3-0.6b Dh 64", 1, 16, 8, 4096, 64), ("qwen3-0.6b Dh 32", 1, 16, 8, 4096, 32))
# the kernel whose own device time stands for each timed call (the plain
# version's is all the device work it launches)
KERNEL_OF = {"cand_gated": "::cand_", "cand_all_live": "::cand_", "cand_self": "::cand_",
             "dense": "::dense_", "dense_all_live": "::dense_", "gate_ub": "::gate_ub"}


def _join_times(dev, edge: int, reps: int) -> dict:
    """The join and gate wrappers at ``edge x edge`` tiles over the main
    path's window, each timed over ``reps`` launches."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.sssj_join import gate as gate_mod
    from repro_torch.kernels.sssj_join.kernel import (
        sssj_join_candidates_kernel_call as cand,
        sssj_join_kernel_call as dense,
    )
    from repro_torch.kernels.sssj_join.ops import suffix_chunk_norms

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    chunk, n_q = 128, max(cs.MICRO, edge)
    w, tw, uw = cs._window(gen, cs.CAPACITY, cs.D, 400.0, dev)
    q, tq, uq = cs._queries(gen, w, tw, uw, n_q, 24 * n_q // cs.MICRO, dev)
    sqq, sqw = suffix_chunk_norms(q, chunk), suffix_chunk_norms(w, chunk)
    summary = gate_mod.summarize_strips(w, tw, uw, block_w=edge, chunk_d=chunk)
    gate, _ = gate_mod.strip_gate(q, summary, block_q=edge, chunk_d=chunk,
                                  tq_lo=tq.min(), tq_hi=tq.max(), th_min=cs.THETA,
                                  lam_min=cs.LAM, device=dev)
    col = lambda x: x[:, None]  # noqa: E731
    args = (q, w, col(tq), col(tw), col(uq), col(uw), sqq, sqw)
    kw = dict(theta=cs.THETA, lam=cs.LAM, block_q=edge, block_w=edge, chunk_d=chunk)
    ckw = dict(kw, tile_k=2 * cs.MICRO if edge == 128 else edge * edge)
    qa, qcn = q.abs(), gate_mod.chunk_norms(q, chunk)
    # every tile live: the window squeezed into 2.6 time units, gate all ones
    live = (q, w, col(tq), col(400.0 - (400.0 - tw) / 100.0), col(uq), col(uw), sqq, sqw)
    calls = {
        "cand_gated": lambda: cand(*args, **ckw, gate=gate.int()),
        "cand_all_live": lambda: cand(*live, **ckw, gate=torch.ones_like(gate).int()),
        "cand_self": lambda: cand(q, q, col(tq), col(tq), col(uq), col(uq), sqq, sqq,
                                  **ckw),
        "dense": lambda: dense(*args, **kw),
        "dense_all_live": lambda: dense(*live, **kw),
        "gate_ub": lambda: gate_mod.gate_ub(qa, qcn, summary.vmax, summary.cnorm,
                                            block_q=edge),
        "gate_ub_plain": lambda: gate_mod.gate_ub_plain(qa, qcn, summary.vmax,
                                                        summary.cnorm, block_q=edge),
    }
    out = {}
    for name, fn in calls.items():
        out[f"{name}_{edge}"] = cs.cuda_ms(fn, reps)
        out[f"{name}_{edge} device"] = cs.device_ms(fn, reps, KERNEL_OF.get(name))
    return out


def _flash_times(dev, reps: int) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel_call

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    out = {}
    for label, B, H, Hkv, S, Dh in FLASH:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
                       for shape in ((B, H, S, Dh), (B, Hkv, S, Dh), (B, Hkv, S, Dh)))
            kw = dict(sm_scale=Dh ** -0.5, causal=True, block_q=128, block_k=128)
            call = lambda: flash_attention_kernel_call(q, k, v, **kw)  # noqa: E731
            out[f"flash {label} {dtype}"] = cs.cuda_ms(call, reps)
            out[f"flash {label} {dtype} device"] = cs.device_ms(call, reps, "::flash_")
    return out


def _edge_engine_times(dev, reps: int) -> dict:
    """The engine at 64 x 64 tiles and its gate bound (``--edge-engine``)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.sssj_join import gate as gate_mod

    cfg = cs.EDGE_CFGS[0]
    edge, d, chunk = cfg["block_q"], cfg["d"], cfg["chunk_d"]
    requests = cs._requests(cs.EDGE_ITEMS, d)
    dense = cs._run_engine(dev, requests, n_profiled=0, join_impl="dense", **cfg)
    kern = cs._run_engine(dev, requests, n_profiled=2, **cfg)
    n_micro = sum(-(-len(v) // cfg["micro_batch"]) for v, _ in requests[-2:])
    prof = kern["profile"]
    out = {"engine_64": kern["timed_items"] / kern["seconds"],
           "engine_64 dense": dense["timed_items"] / dense["seconds"],
           "engine_64 launches": prof["device_launches"] / n_micro,
           "engine_64 device_ms": prof["device_busy_ms"] / n_micro,
           "engine_64 wall_ms": prof["wall_ms"] / n_micro}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    w, tw, uw = cs._window(gen, cfg["capacity"], d, 400.0, dev)
    q, tq, uq = cs._queries(gen, w, tw, uw, edge, edge // 8, dev)
    summary = gate_mod.summarize_strips(w, tw, uw, block_w=edge, chunk_d=chunk)
    qa, qcn = q.abs(), gate_mod.chunk_norms(q, chunk)
    call = lambda: gate_mod.gate_ub(qa, qcn, summary.vmax, summary.cnorm,  # noqa: E731
                                    block_q=edge)
    step = lambda: gate_mod.strip_gate(  # noqa: E731
        q, summary, block_q=edge, chunk_d=chunk, tq_lo=tq.min(), tq_hi=tq.max(),
        th_min=cs.THETA, lam_min=cfg["lam"], device=dev)
    out["gate_ub_64"] = cs.cuda_ms(call, reps)
    out["gate_ub_64 device"] = cs.device_ms(call, reps, "::gate_ub")
    out["strip_gate_64 device"] = cs.device_ms(step, reps)
    return out


def worker(root: str, edge_engine: bool = False) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    built = _build.build()
    build_s = time.monotonic() - t0
    dev = torch.device("cuda")
    if edge_engine:
        return {"root": root, "build_s": build_s, "times": _edge_engine_times(dev, 50),
                "ptxas": {}}
    times = _join_times(dev, 128, 20)
    try:
        times.update(_join_times(dev, 256, 5))
    except ValueError as exc:   # a checkout whose wrappers refuse the edge
        times["edge_256"] = f"ValueError: {exc}"
    times.update(_flash_times(dev, 20))
    ptxas = {name: [ln.split("ptxas info    : ")[-1].strip()
                    for ln in rec["log"].splitlines()
                    if "entry function" in ln or "registers" in ln or "spill" in ln]
             for name, rec in built.items()}
    return {"root": root, "build_s": build_s, "times": times, "ptxas": ptxas}


def main(argv) -> int:
    edge_engine = "--edge-engine" in argv
    argv = [a for a in argv if a != "--edge-engine"]
    if len(argv) >= 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1], edge_engine)), flush=True)
        return 0
    if len(argv) not in (2, 4) or (len(argv) == 4 and argv[2] != "--out"):
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv[0], argv[1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", root]
                              + ["--edge-engine"] * edge_engine,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({k: rec[k] for k in ("root", "build_s", "times")}), flush=True)
        runs.append(rec)
    summary = {}
    for key in dict.fromkeys(k for r in runs for k in r["times"]):
        pair = [[r["times"].get(key) for r in runs if r["root"] == x] for x in (a, b)]
        if all(isinstance(t, float) for t in pair[0] + pair[1]) and sum(pair[0]):
            ma, mb = (sum(t) / len(t) for t in pair)
            summary[key] = {"a": pair[0], "b": pair[1], "b_over_a": mb / ma}
        else:
            summary[key] = {"a": pair[0], "b": pair[1]}
    # each checkout's build report, from its first run (the second finds it built)
    result = {"nvidia_smi": smi, "a": a, "b": b, "summary": summary,
              "ptxas": {r["root"]: r["ptxas"] for r in runs[:2]}}
    if len(argv) == 4:
        Path(argv[3]).parent.mkdir(parents=True, exist_ok=True)
        Path(argv[3]).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("nvidia_smi", "a", "b", "summary")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

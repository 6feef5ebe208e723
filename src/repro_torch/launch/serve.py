"""The serving entry point: the system end to end.

Counterpart of ``repro.launch.serve``.  Batched requests (token
sequences) → LM embedding (a dense-attention or MoE ``--arch``, at its
``reduced()`` size, random weights drawn from ``seed``; MoE blocks run
the reference's capacity dispatch, so a document's embedding depends on
its batch) → streaming similarity self-join → near-duplicate groups and
trend events, printed as they are detected.  Runs on CUDA unless given
``--device cpu``.

Example (CPU, seconds):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen3-0.6b --requests 32 --batch 16 --theta 0.85 --lam 0.05
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch olmoe-1b-7b
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs import ARCHS, get_config
from ..serving.embedder import LMEmbedder
from ..serving.service import SSSJService

__all__ = ["run_service", "token_requests"]


def token_requests(
    vocab_size: int,
    *,
    requests: int = 32,
    batch: int = 16,
    seq: int = 64,
    dup_frac: float = 0.25,
    seed: int = 0,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """The served request stream: ``requests`` batches of ``(batch,
    seq)`` int32 tokens in ``[1, vocab_size)`` with their timestamps
    (one second a request, 10 ms apart within it), a ``dup_frac`` share
    of documents planted as copies of one of the last 256 with 5 % of
    their tokens redrawn.  Returns ``([(tokens, ts)], n_planted)``, the
    reference's stream draw for draw."""
    rng = np.random.default_rng(seed)
    t = 0.0
    recent: List[np.ndarray] = []
    planted = 0
    out = []
    for _ in range(requests):
        toks = rng.integers(1, vocab_size, (batch, seq))
        for i in range(batch):
            if recent and rng.random() < dup_frac:
                src = recent[int(rng.integers(0, len(recent)))]
                noise = rng.random(seq) < 0.05
                toks[i] = np.where(noise, toks[i], src)
                planted += 1
        for i in range(batch):
            recent.append(toks[i].copy())
        recent = recent[-256:]
        out.append((toks.astype(np.int32), t + np.arange(batch) * 0.01))
        t += 1.0
    return out, planted


def run_service(
    arch: str,
    *,
    requests: int = 32,
    batch: int = 16,
    seq: int = 64,
    theta: float = 0.85,
    lam: float = 0.05,
    dup_frac: float = 0.25,
    seed: int = 0,
    verbose: bool = True,
    device: DeviceLike = None,
):
    """Drive :class:`SSSJService` with an :class:`LMEmbedder` over
    :func:`token_requests`; returns ``(service, groups, trends)``."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    embedder = LMEmbedder(cfg, generator=torch.Generator(dev).manual_seed(seed),
                          device=dev)
    service = SSSJService(theta=theta, lam=lam, dim=cfg.d_model, capacity=4096,
                          embed_fn=embedder, device=dev)
    stream, planted = token_requests(cfg.vocab_size, requests=requests, batch=batch,
                                     seq=seq, dup_frac=dup_frac, seed=seed)
    for r, (toks, ts) in enumerate(stream):
        pairs = service.submit(toks, ts)
        if verbose and pairs:
            print(f"request batch {r}: {len(pairs)} similar pairs")
    groups = service.duplicate_groups()
    trends = service.trending(min_size=3)
    if verbose:
        es = service.engine.stats()
        print(f"\nitems={service.stats.n_items} planted_dups={planted} "
              f"pairs={service.stats.n_pairs} "
              f"dropped={service.stats.pairs_dropped}")
        print(f"host↔device: {es['bytes_to_host']} B compacted vs "
              f"{es['bytes_dense_equiv']} B dense-equivalent")
        print(f"duplicate groups: {len(groups)}; trending (≥3): {len(trends)}")
        for g in trends[:5]:
            print("  trend:", g)
    return service, groups, trends


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--theta", type=float, default=0.85)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--dup-frac", type=float, default=0.25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    run_service(
        args.arch, requests=args.requests, batch=args.batch, seq=args.seq,
        theta=args.theta, lam=args.lam, dup_frac=args.dup_frac, device=args.device,
    )


if __name__ == "__main__":
    main()

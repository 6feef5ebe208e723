"""Sharded, resumable token pipeline with a streaming-dedup stage.

Counterpart of ``repro.data.pipeline`` (numpy on the host; the port
imports nothing of ``repro``).  ``TokenPipeline`` produces deterministic
synthetic LM batches:

  * **sharded** — each host generates only its shard (``host_id/num_hosts``)
    from a per-(step, shard) seed: no host ever materializes the global
    batch;
  * **resumable** — state is just ``(seed, step)``; checkpointing it gives
    exact resume (no sample loss or duplication);
  * **dedup-filtered** — documents are embedded (hashing projection — cheap,
    model-free), unit-normalized, timestamped, and pushed through the
    streaming similarity self-join; near-duplicates within the time horizon
    are dropped *before batching* and replaced by fresh samples.

The dedup stage runs the torch engine (:mod:`repro_torch.engine`), on the
card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from .._device import DeviceLike
from ..engine.engine import EngineConfig, StreamEngine

__all__ = ["TokenPipeline", "DedupFilter", "hashing_embed"]


def hashing_embed(tokens: np.ndarray, dim: int, seed: int = 17) -> np.ndarray:
    """Model-free document embedding: hashed bag-of-tokens projection.

    Each vocabulary id deterministically hashes to a ±1 position in ``dim``
    buckets (feature hashing); document vectors are unit-normalized.  Near-
    duplicate documents (high token overlap) get high cosine similarity —
    exactly the regime the paper's join targets.
    """
    tokens = np.asarray(tokens)
    rng_a = 1103515245
    h = (tokens.astype(np.int64) * rng_a + seed) % (2 ** 31)
    bucket = (h % dim).astype(np.int64)
    sign = np.where((h // dim) % 2 == 0, 1.0, -1.0).astype(np.float32)
    n = tokens.shape[0]
    out = np.zeros((n, dim), np.float32)
    rows = np.repeat(np.arange(n), tokens.shape[1])
    np.add.at(out, (rows, bucket.ravel()), sign.ravel())
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norm, 1e-9)


class DedupFilter:
    """Streaming near-duplicate filter over document embeddings (paper §1,
    application #2), backed by the torch SSSJ engine on ``device``.

    A keep-mask only needs "does row i have a ≥ θ match" — not the matches
    themselves — so this consumer rides the engine's per-row match mask:
    a ``(micro_batch,)`` boolean derived from level-1 emit counts, exact
    regardless of candidate-buffer capacity.  Pair emission is vestigial
    here, its buffers are held at the minimum (``tile_k = max_pairs = 8``),
    and any pair-drop counters that fire are irrelevant to correctness —
    host traffic is O(block) per push.
    """

    def __init__(
        self,
        theta: float = 0.9,
        lam: float = 0.05,
        dim: int = 256,
        capacity: int = 2048,
        block: int = 64,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = EngineConfig(
            theta=theta, lam=lam, capacity=capacity, d=dim,
            micro_batch=block, max_pairs=8, tile_k=8,
            block_q=block, block_w=block, chunk_d=min(dim, 128),
        )
        self.engine = StreamEngine(self.cfg, device=device)
        self.dim = dim
        self.n_seen = 0
        self.n_dropped = 0

    def filter(self, tokens: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Returns a boolean keep-mask for the batch of documents."""
        emb = hashing_embed(tokens, self.dim)
        self.engine.push(emb, ts)
        # the mask marks the *newer* item of each similar pair (the join's
        # uid-order mask makes the query side strictly newer)
        _, _, _, matched = self.engine.drain_arrays(return_masks=True)
        keep = ~matched
        self.n_seen += tokens.shape[0]
        self.n_dropped += int((~keep).sum())
        return keep


@dataclasses.dataclass
class _PipelineState:
    seed: int
    step: int


class TokenPipeline:
    """Deterministic sharded LM batches with optional streaming dedup."""

    def __init__(
        self,
        vocab_size: int,
        batch: int,                # per-host batch
        seq_len: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        dup_frac: float = 0.0,     # planted near-duplicate rate (for dedup)
        dedup: Optional[DedupFilter] = None,
    ) -> None:
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.dup_frac = dup_frac
        self.dedup = dedup
        self.state = _PipelineState(seed=seed, step=0)
        self._last: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ #
    def checkpoint_state(self) -> Dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore_state(self, d: Dict) -> None:
        self.state = _PipelineState(seed=int(d["seed"]), step=int(d["step"]))
        self._last = None

    # ------------------------------------------------------------------ #
    def _rng(self, step: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 4096
            + self.host_id * 7 + salt
        )

    def _sample(self, step: int, salt: int = 0) -> np.ndarray:
        rng = self._rng(step, salt)
        toks = rng.integers(
            1, self.vocab_size, (self.batch, self.seq_len), dtype=np.int64
        )
        if self.dup_frac > 0.0 and self._last is not None:
            # plant near-duplicates of recent documents (5% token noise)
            for i in range(self.batch):
                if rng.random() < self.dup_frac:
                    src = self._last[int(rng.integers(0, self._last.shape[0]))]
                    noise = rng.random(self.seq_len) < 0.05
                    dup = np.where(
                        noise,
                        rng.integers(1, self.vocab_size, self.seq_len),
                        src,
                    )
                    toks[i] = dup
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        toks = self._sample(step)
        if self.dedup is not None:
            ts = np.full((self.batch,), float(step), np.float64)
            keep = self.dedup.filter(toks, ts)
            salt = 1
            # replace dropped documents with fresh (non-planted) samples
            while not keep.all():
                fresh = self._sample(step, salt)
                toks[~keep] = fresh[~keep]
                keep[:] = True
                salt += 1
        self._last = toks
        self.state.step += 1
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {
            "tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

"""Distributed SSSJ: the ring-scheduled dense join over a sharded window.

Counterpart of ``repro.core.distributed``.  The window is sharded over
the mesh axis the logical ``"window"`` axis resolves to
(:func:`repro_torch.engine.sharded.window_axis`: ``data``) and so is
each incoming query batch (shard ``i``
takes the batch's ``i``-th block of rows).  Every query shard must meet
every window shard, which the reference schedules as a collective-permute
ring under ``shard_map``; here one process runs the same schedule over
the shards' devices:

  step s:  each shard passes the window it holds to its ring neighbour
           (a copy onto the neighbour's device; none on a shared one) and
           joins its queries against the window it holds, shard
           ``(i - s) mod p``, with the dense tile join

After ``p`` steps every (query, window) pair was scored once.  Pairs
within the batch come from one gather of the (small) batch onto every
shard: each shard joins its block against all of it.  Then each shard
writes its block into its own ring.
"""

from __future__ import annotations

import dataclasses

import torch

from ..engine.sharded import ShardedWindow, on_device, window_axis
from ..kernels.sssj_join import sssj_join_scores
from ..launch.mesh import Mesh
from .blocked import BlockedJoinConfig, init_window, push_with_overflow

__all__ = ["DistributedJoinConfig", "init_sharded_window", "make_distributed_join_step"]


@dataclasses.dataclass(frozen=True)
class DistributedJoinConfig:
    base: BlockedJoinConfig


def init_sharded_window(cfg: DistributedJoinConfig, mesh: Mesh) -> ShardedWindow:
    """``base.capacity`` slots per shard on each device along the window axis."""
    return ShardedWindow(tuple(
        init_window(cfg.base.capacity, cfg.base.d, device=dev)
        for dev in mesh.devices_along(window_axis(mesh))
    ))


def make_distributed_join_step(cfg: DistributedJoinConfig, mesh: Mesh):
    """The ring step ``(state, q, tq, uq) → (state, (scores_win,
    scores_self))``; the state is updated in place.

    ``q (B, d)`` is the global batch (``B`` divisible by the shard count),
    on any device or as an array.  ``scores_win (B, p·capacity)`` has
    window shard ``c`` in column block ``c`` and ``scores_self (B, B)``
    the batch against itself, both on the first shard's device.  On CUDA
    devices every join launches the dense tile-join kernel, or, with
    ``use_ref``, runs the dense reference; a join smaller than one tile
    there (a shard's block of ``B / p`` rows under ``block_q``, ``B`` or
    ``capacity`` under ``block_w``, ``d`` under ``chunk_d``), which the
    kernel's wrapper would hand to the reference, is refused instead."""
    b = cfg.base
    kw = dict(theta=b.theta, lam=b.lam, block_q=b.block_q, block_w=b.block_w,
              chunk_d=b.chunk_d, use_ref=b.use_ref)
    devices = mesh.devices_along(window_axis(mesh))
    p = len(devices)
    home = devices[0]
    on_kernel = home.type == "cuda" and not b.use_ref

    def check_tile(rows_q: int, rows_w: int, what: str) -> None:
        if on_kernel and (rows_q < b.block_q or rows_w < b.block_w or b.d < b.chunk_d):
            raise ValueError(
                f"the ring join's {what} join of {rows_q} x {rows_w} rows at "
                f"d {b.d} is smaller than one {b.block_q} x {b.block_w} x "
                f"{b.chunk_d} tile and would not run the dense kernel"
            )

    check_tile(b.block_q, b.capacity, "window")

    def step(state: ShardedWindow, q, tq, uq):
        n = len(q)
        if n % p:
            raise ValueError(f"batch of {n} rows not divisible by {p} shards")
        bl = n // p
        check_tile(bl, b.capacity, "window")
        check_tile(bl, n, "self")
        q = torch.as_tensor(q, device=home).float()
        tq = torch.as_tensor(tq, device=home).reshape(-1).float()
        uq = torch.as_tensor(uq, device=home).reshape(-1).int()
        # each shard's block of the batch, on its device
        blocks = [tuple(x[i * bl:(i + 1) * bl].to(dev, non_blocking=True)
                        for x in (q, tq, uq))
                  for i, dev in enumerate(devices)]
        wl = state.shards[0].vecs.shape[0]
        held = [(s.vecs, s.ts, s.uids) for s in state.shards]
        out = [torch.zeros((bl, wl * p), dtype=torch.float32, device=dev)
               for dev in devices]
        for s in range(p):
            # the neighbour's window for the next step, passed around the
            # ring (i → i + 1) ahead of this step's joins
            nxt = [tuple(x.to(dev, non_blocking=True) for x in held[(i - 1) % p])
                   for i, dev in enumerate(devices)]
            for i, dev in enumerate(devices):
                src = (i - s) % p            # the window shard shard i holds
                qi, ti, ui = blocks[i]
                wv, wt, wu = held[i]
                with on_device(dev):
                    scores, _ = sssj_join_scores(qi, wv, ti, wt, ui, wu,
                                                 device=dev, **kw)
                    out[i][:, src * wl:(src + 1) * wl] = scores
            held = nxt

        self_out = []
        for i, dev in enumerate(devices):
            with on_device(dev):
                # within-batch pairs: the whole batch gathered onto this shard
                qg, tg, ug = (torch.cat([blk[k].to(dev, non_blocking=True)
                                         for blk in blocks])
                              for k in range(3))
                qi, ti, ui = blocks[i]
                scores, _ = sssj_join_scores(qi, qg, ti, tg, ui, ug, device=dev, **kw)
                self_out.append(scores)
                # this shard's block into its own ring, through the policy
                # layer's overflow accounting
                push_with_overflow(state.shards[i], qi, ti, ui, bl, ti.max(), b.tau)

        with on_device(home):
            scores_win = torch.cat([x.to(home, non_blocking=True) for x in out])
            scores_self = torch.cat([x.to(home, non_blocking=True) for x in self_out])
        return state, (scores_win, scores_self)

    return step

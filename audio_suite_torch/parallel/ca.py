"""Spatially-sharded Forest Fire CA: the grid's rows split over a mesh
axis with halo exchange — port of audio_suite_tpu/parallel/ca.py.

Everything spatially coupled crosses a shard boundary at one of three
points of ``models/forestfire.step_device``, each an ordered collective
of ``parallel/batch.py``:

- **stencil halo**: the 8-neighbour fire mask needs one row from each
  vertical neighbour; ``ppermute`` ships the edge rows (toroidal, as
  ``torch.roll``'s wrap on the dense grid);
- **ember candidates**: each shard keeps its min(EMBER_CAP, Hl*W) largest
  emitter indices (``topk``) with their landing cells, ``all_gather``
  shares the lists, and every shard takes the same top set of the
  gathered candidates again: the dense engine's selection, so embers land
  on their owning shard however far the wind blew them;
- **stats**: per-shard int32 counts ``psum`` into the global row.

The per-cell physics is THE SAME CODE as the dense engine: ``step_device``
(through the step loop ``forestfire._sim``) with a ``ShardSpatial``
adapter in place of ``DenseSpatial``.  Every cross-shard quantity is an
integer or a mask, so the sharded trajectory equals the dense one bit for
bit.

The JAX package runs the shards as one SPMD program.  Here each mesh
position runs the step loop in a thread of its own, on its own device,
and the threads take turns: shard 0 runs to its next collective, then
shard 1, ..., and the last computes the collective over every shard's
contribution, in shard order, and hands back to shard 0.  So a step
loops over the shards between its exchange points while ``step_device``
stays one piece of code, and with one thread runnable at a time the
shards never contend for the interpreter lock.  On one card every shard
enqueues on the same stream, in a fixed order; a collective's result is
enqueued after every block it reads.

Requires params.h divisible by the mesh axis size.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..models import forestfire as ff
from .batch import Mesh, all_gather, ppermute, psum

_MASK32 = 0xFFFFFFFF
_TIMEOUT_S = 600.0     # a turn that does not come in this long is stuck


class _Aborted(Exception):
    """Another shard failed: this one stops at its next turn."""


class _ShardGroup:
    """D shard threads that take turns, in shard order, from one
    collective to the next.  ``exchange(i, x, fn)`` posts shard i's
    contribution and hands the turn to shard i + 1; the last shard
    computes ``fn(contributions in shard order)`` and hands the turn back
    to shard 0, and each shard resumes on its turn with its part of the
    result.  So a step runs its shards one after another between its
    exchange points, as a loop over the shards would, and one thread is
    runnable at a time: the threads never contend for the interpreter
    lock."""

    def __init__(self, D: int):
        self.D = D
        self.turns = [threading.Semaphore(0) for _ in range(D)]
        self.slots = [None] * D
        self.results = None
        self.failed = False

    def wait_turn(self, i: int):
        if not self.turns[i].acquire(timeout=_TIMEOUT_S):
            raise TimeoutError(f"shard {i} waited {_TIMEOUT_S} s for its "
                               "turn")
        if self.failed:
            raise _Aborted

    def hand_over(self, i: int):
        if i + 1 < self.D:
            self.turns[i + 1].release()

    def exchange(self, i: int, x, fn):
        self.slots[i] = x
        if i == self.D - 1:
            self.results = fn(self.slots)
            self.turns[0].release()
        else:
            self.hand_over(i)
        self.wait_turn(i)
        return self.results[i]

    def abort(self):
        self.failed = True
        for t in self.turns:
            t.release()


def _run_shards(D: int, body):
    """body(i, group) in D threads taking turns; returns their results in
    shard order.  A shard that raises wakes the others, which stop at
    their turn; its error is raised here."""
    group = _ShardGroup(D)
    results, errors = [None] * D, [None] * D

    def run(i):
        try:
            group.wait_turn(i)
            results[i] = body(i, group)
            group.hand_over(i)
        except BaseException as e:          # re-raised below, in the caller
            errors[i] = e
            group.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(D)]
    for t in threads:
        t.start()
    group.turns[0].release()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None and not isinstance(e, _Aborted)), None)
    if first is not None:
        raise first
    return results


class ShardSpatial(ff.DenseSpatial):
    """Row-sharded spatial coupling of shard ``index`` of D: local blocks
    are [H/D, W]."""

    def __init__(self, group: _ShardGroup, index: int, H: int, W: int,
                 D: int):
        self.group, self.index = group, index
        self.H, self.W, self.D = H, W, D
        self.Hl = H // D
        self.row0 = index * self.Hl

    def cells(self, H: int, W: int, device) -> torch.Tensor:
        # uint32 as the JAX package's (an int32 intermediate would fork the
        # per-cell streams once H*W >= 2^31): int64 masked to 32 bits
        local = torch.arange(self.Hl * W, dtype=torch.int64, device=device)
        return ((local + self.row0 * W) & _MASK32).reshape(self.Hl, W)

    def rows(self, H: int, device) -> torch.Tensor:
        return (self.row0 + torch.arange(self.Hl, dtype=torch.int32,
                                         device=device))[:, None]

    def roll_or8(self, m: torch.Tensor) -> torch.Tensor:
        """8-neighbour OR with a one-row toroidal halo from each vertical
        neighbour; column rolls stay shard-local."""
        D = self.D

        def halo(edges):
            # every shard receives the previous shard's last row (the row
            # above it, toroidally) and the next shard's first row
            top = ppermute([e[1] for e in edges],
                           [(j, (j + 1) % D) for j in range(D)])
            bot = ppermute([e[0] for e in edges],
                           [(j, (j - 1) % D) for j in range(D)])
            return list(zip(top, bot))

        top, bot = self.group.exchange(self.index, (m[:1], m[-1:]), halo)
        ext = torch.cat([top, m, bot])           # [Hl + 2, W]
        dn, up = ext[:-2], ext[2:]               # roll(m, +-1, 0) blocks
        ns = dn | up
        col = ns | m
        return ns | torch.roll(col, 1, 1) | torch.roll(col, -1, 1)

    def ember_arrivals(self, emit: torch.Tensor, lin: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
        """The dense engine's ember selection across shards: each shard's
        largest min(EMBER_CAP, Hl*W) emitter indices cover the global top
        set, and the gathered candidates are cut to it identically on
        every shard, even when the cap binds."""
        Hl, D = self.Hl, self.D
        n_loc = Hl * W
        capl = min(ff.EMBER_CAP, n_loc)
        gcap = min(ff.EMBER_CAP, H * W)
        gidx = self.row0 * W + torch.arange(n_loc, dtype=torch.int32,
                                            device=emit.device)
        key = torch.where(emit.reshape(-1), gidx, -1)
        vals, pos = torch.topk(key, capl, sorted=False)
        land = torch.where(vals >= 0, lin.reshape(-1)[pos], -1)
        cand_v, cand_l = self.group.exchange(
            self.index, (vals, land),
            lambda c: list(zip(all_gather([v for v, _ in c]),
                               all_gather([l for _, l in c]))))
        gv, gpos = torch.topk(cand_v, min(gcap, D * capl), sorted=False)
        rel = cand_l[gpos] - self.row0 * W                 # local landing
        in_rng = (gv >= 0) & (rel >= 0) & (rel < n_loc)
        arrivals = torch.zeros(n_loc, dtype=torch.int32, device=emit.device)
        arrivals.index_add_(0, rel.clamp(0, n_loc - 1),
                            in_rng.to(torch.int32))
        return (arrivals > 0).reshape(Hl, W)

    def rsum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.exchange(self.index, x.sum(dtype=torch.int32),
                                   psum)


def _check_rows(params: ff.ModelParams, D: int, axis: str):
    if int(params.h) % D:
        raise ValueError(f"grid h={params.h} must divide over the {D}-device "
                         f"'{axis}' mesh axis")


def sharded_sim_fn(params: ff.ModelParams, seed: int, n_steps: int,
                   mesh: Mesh, axis: str = "sp"):
    """``(carry_blocks, terrain_blocks) -> (carry_blocks', stats)`` with
    the grid's rows split over ``mesh[axis]``: one carry and terrain dict
    a shard, its planes' row blocks on its device (``t`` a host int);
    stats int32 [n_steps, 8] on the axis's first device."""
    D = len(mesh.axis_devices(axis))
    _check_rows(params, D, axis)
    H, W = int(params.h), int(params.w)

    def run(carry_blocks: list, terrain_blocks: list):
        def body(i, group):
            sp = ShardSpatial(group, i, H, W, D)
            return ff._sim(carry_blocks[i], n_steps, params, seed,
                           spatial=sp, terrain=terrain_blocks[i])

        out = _run_shards(D, body)
        return [c for c, _ in out], out[0][1]

    return run


def simulate_sharded(params: ff.ModelParams, carry: dict, n_steps: int,
                     mesh: Mesh, seed: int, axis: str = "sp"):
    """Run ``n_steps`` of the CA with rows split over ``mesh[axis]``.

    ``carry``: the state dict from ``forestfire.init_state`` or a model's
    host state (NumPy arrays or tensors).  Returns (carry', stats): carry'
    with each plane's blocks joined on the axis's first device and ``t`` a
    host int, stats int32 [n_steps, 8] NumPy.  Bit-identical to
    ``ForestFireModel.simulate`` from the same carry and seed."""
    devs = mesh.axis_devices(axis)
    D = len(devs)
    _check_rows(params, D, axis)
    Hl = int(params.h) // D
    full = ff.carry_from_state(carry, devs[0])
    terrain = ff.terrain_static(params, full["elev"])
    carry_blocks = [dict({k: v[i * Hl:(i + 1) * Hl].to(d)
                          for k, v in full.items() if k != "t"},
                         t=full["t"]) for i, d in enumerate(devs)]
    terrain_blocks = [{k: v[i * Hl:(i + 1) * Hl].to(d)
                       for k, v in terrain.items()}
                      for i, d in enumerate(devs)]
    blocks, stats = sharded_sim_fn(params, int(seed), int(n_steps), mesh,
                                   axis)(carry_blocks, terrain_blocks)
    out = {k: torch.cat([b[k].to(devs[0]) for b in blocks])
           for k in blocks[0] if k != "t"}
    out["t"] = int(blocks[0]["t"])
    return out, np.asarray(stats.cpu().numpy(), np.int32)

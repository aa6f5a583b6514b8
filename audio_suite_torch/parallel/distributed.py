"""Multi-process batch dispatch on ``torch.distributed`` — port of
audio_suite_tpu/parallel/distributed.py.

The JAX package joins processes with ``jax.distributed`` into one global
mesh and lets a jit's out-sharding gather the results.  Here:

- every participating process calls :func:`init_distributed`
  (``init_process_group`` over a TCP rendezvous at the coordinator's
  address).  The backend is gloo for tensors on the host and NCCL where
  each rank has a card of its own (NCCL refuses two ranks on one card);
- :func:`make_global_mesh` builds a ``(world_size, local)`` mesh whose
  first axis is the process boundary and whose second holds this
  process's devices (every process is taken to hold as many);
- :func:`put_global_batch` gives this rank the slice of a batch's
  leading axis that falls on its devices, one block a device;
- :func:`distributed_batch_render` computes this rank's share of the jobs
  on its local devices, then ``all_gather``s the shares, so every rank
  returns the same host NumPy batch.

Tested without a cluster by two local CPU processes speaking gloo
(tests/test_torch_distributed.py).  Run one process of the self-test
with::

    python -m audio_suite_torch.parallel.distributed \\
        <coordinator host:port> <num_processes> <process_id> <out.json> \\
        [device]

``device`` (default ``cuda``) is where each rank computes its two local
shards; the gather runs over gloo on the host.
"""
from __future__ import annotations

import datetime
import json

import numpy as np
import torch
import torch.distributed as dist

from .batch import (Mesh, _device_grid, _to_numpy, first_leaf, shard_batch,
                    tree_map)

_TIMEOUT = datetime.timedelta(seconds=120)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str = "gloo") -> None:
    """Join the process group (idempotent).  ``coordinator_address`` is
    ``host:port`` of rank 0's rendezvous; a failed rendezvous raises."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=_TIMEOUT)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_global_mesh(axis_names=("dp_host", "dp_chip"), *,
                     devices=None) -> Mesh:
    """Global mesh ``(world_size, local)``: row r holds rank r's devices.
    ``devices`` lists this process's (default: every card it sees); a
    process reaches only its own row.  With no process group this
    degenerates to ``(1, n_local)``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: pass devices= to place the "
                               "local shards")
        devices = [torch.device("cuda", i) for i in range(count)]
    local = [torch.device(d) for d in devices]
    world, _ = _world()
    return Mesh(_device_grid(local * world, (world, len(local))),
                axis_names)


def put_global_batch(mesh: Mesh, tree, axes=("dp_host", "dp_chip")) -> list:
    """This rank's part of a tree (the same host NumPy on every process)
    whose leading axis is split over the mesh's ``axes``: the slice that
    falls on this rank's row, split over its devices, as a list with one
    tree a device, each block on its device (the port's form of JAX's
    ``make_array_from_callback`` over a ``NamedSharding``).  The leading
    dim must divide by the mesh's size (pad with no-op jobs)."""
    world, rank = _world()
    n_host, n_local = mesh.devices.shape
    if n_host != world:
        raise ValueError(f"a mesh of {n_host} hosts in a world of {world}")
    B = int(np.shape(first_leaf(tree))[0])
    if B % (world * n_local):
        raise ValueError(f"{B} jobs do not divide over {world} x {n_local} "
                         "devices")
    share = B // world
    mine = tree_map(lambda x: x[rank * share:(rank + 1) * share], tree)
    return shard_batch(Mesh(mesh.devices[rank], (axes[1],)), mine, axes[1])


def _gather(x: torch.Tensor, world: int) -> torch.Tensor:
    """Every rank's ``x`` in rank order: through NCCL on the card, or gloo
    on the host."""
    if world == 1:
        return x
    if dist.get_backend() != "nccl":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def distributed_batch_render(kernel, batched_args, mesh: Mesh | None = None,
                             axes=("dp_host", "dp_chip")):
    """``torch.func.vmap(kernel)`` over the leading batch axis, split over
    the global mesh: this rank renders its share on its local devices,
    then the shares are gathered, so every rank returns the whole batch
    as host NumPy.  The leading dim must divide by the mesh's size (pad
    with no-op jobs).  ``kernel`` is as for
    :func:`audio_suite_torch.parallel.batch.batch_render`, its
    multi-process twin."""
    if mesh is None:
        mesh = make_global_mesh(axes)
    world, rank = _world()
    f = torch.func.vmap(kernel)
    outs = [f(*a) if isinstance(a, tuple) else f(a)
            for a in put_global_batch(mesh, batched_args, axes)]
    dev0 = mesh.devices[rank, 0]
    out = tree_map(lambda *xs: torch.cat([x.to(dev0) for x in xs]), *outs)
    return tree_map(lambda x: _to_numpy(_gather(x, world)), out)


# ---------------------------------------------------------------------------
# Self-test worker (the 2-process CPU test drives this; also usable to
# validate a multi-host setup before launching a long batch)
# ---------------------------------------------------------------------------

def _selftest(coordinator: str, num_processes: int, process_id: int,
              out_path: str, local_devices: int = 2,
              device="cuda") -> dict:
    init_distributed(coordinator, num_processes, process_id)
    try:
        mesh = make_global_mesh(devices=[device] * int(local_devices))
        n_dev = mesh.devices.size

        # one render job = a decaying partial stack (a small stand-in for an
        # engine job; the dispatch path is the same for any kernel)
        sr, n = 8000, 1024
        B = 2 * n_dev
        freqs = (110.0 * (1 + np.arange(B))).astype(np.float32)

        def job(f0):
            t = torch.arange(n, dtype=torch.float32, device=f0.device) / sr
            env = torch.exp(-t * 30.0)
            return (torch.sin(2 * torch.pi * f0 * t)
                    + 0.5 * torch.sin(2 * torch.pi * 2.0 * f0 * t)) * env

        got = distributed_batch_render(job, (freqs,), mesh)

        # NumPy oracle (f64): every process must hold the full batch
        t = np.arange(n) / sr
        want = (np.sin(2 * np.pi * freqs[:, None] * t)
                + 0.5 * np.sin(2 * np.pi * 2.0 * freqs[:, None] * t)) \
            * np.exp(-t * 30.0)
        err = float(np.max(np.abs(got.astype(np.float64) - want)))

        # cross-process mixdown: each rank sums its share, then an
        # all_reduce over the group (the psum over both axes)
        world, rank = _world()
        share = B // world
        part = torch.as_tensor(got[rank * share:(rank + 1) * share]) \
            .sum(dim=0)
        if world > 1:
            dist.all_reduce(part)
        mix_err = float(np.max(np.abs(part.numpy() - want.sum(axis=0))))

        res = {
            "ok": bool(err < 1e-4 and mix_err < 1e-3),
            "process_id": int(rank),
            "process_count": int(world),
            "global_devices": int(n_dev),
            "mesh_shape": list(mesh.devices.shape),
            "batch": int(B),
            "max_err": err,
            "mix_err": mix_err,
            "device": str(torch.device(device)),
        }
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    import sys

    r = _selftest(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4], device=sys.argv[5] if len(sys.argv) > 5
                  else "cuda")
    print(json.dumps(r))
    sys.exit(0 if r["ok"] else 1)

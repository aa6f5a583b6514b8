"""Device meshes, sharded batch renders, ordered collectives and resumable
batch manifests — port of audio_suite_tpu/parallel/batch.py.

The JAX package runs a ``jax.sharding.Mesh`` through ``shard_map``: one
program over every device of the mesh, its collectives inside.  PyTorch
runs eagerly, so the port keeps the same two pieces in its own idiom:

- ``Mesh``: a NumPy object array of ``torch.device``s with named axes.
  ``make_mesh`` takes the first cards of the host, or an explicit list in
  which one device may repeat (``["cpu"] * 8`` in the CPU tests,
  ``[cuda:0] * 4`` on one card): the port's counterpart of XLA's
  ``--xla_force_host_platform_device_count``, which the JAX tests run on;
- a shard's body is a plain function of its own block, called once a mesh
  position on that position's device;
- the collectives are plain functions of the list of per-shard tensors,
  in shard order, so every result is deterministic: ``ppermute`` moves a
  neighbour's block to the receiver's device, ``all_gather`` concatenates
  every block onto each device, ``psum`` adds the partials in shard order
  on the first device and copies the sum back out.

Across processes, ``parallel/distributed.py`` runs the same batches over
``torch.distributed``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch


class Mesh:
    """Devices on a grid with named axes (the JAX ``Mesh``'s ``devices``,
    ``axis_names`` and ``shape``)."""

    def __init__(self, devices: np.ndarray, axis_names):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at position 0 of every other axis:
        one device a shard of a batch split over ``axis``."""
        ax = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out


def _device_grid(devs: list, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):     # element-wise: numpy must not iterate
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(n_devices: int | None = None, axis_names=("dp",),
              shape: tuple | None = None, *, devices=None) -> Mesh:
    """Build a device mesh.  1-axis ("dp") by default; pass axis_names and
    shape for 2-D (dp, ev) layouts, or let n factor into them as the JAX
    package does (largest first, by 2 then 3).  Uses the first n_devices
    cards of ``torch.cuda.device_count()``, or of ``devices``: an explicit
    list (torch devices or their names), in which one device may repeat."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise ValueError(f"a mesh of {n} cards asked for, {count} "
                             "present (pass devices= to place shards on "
                             "given devices)")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if int(n_devices) > len(devs):
                raise ValueError(f"a mesh of {n_devices} devices asked for, "
                                 f"{len(devs)} given")
            devs = devs[: int(n_devices)]
    n = len(devs)
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        k = len(axis_names)
        dims = [n] + [1] * (k - 1)
        for i in range(1, k):
            for f in (2, 3):
                if dims[0] % f == 0 and dims[0] > f:
                    dims[0] //= f
                    dims[i] *= f
                    break
        shape = tuple(dims)
    return Mesh(_device_grid(devs, shape), axis_names)


# ---------------------------------------------------------------------------
# Pytrees (tuples, lists, dicts of arrays) and the ordered collectives
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """fn over the leaves of one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def first_leaf(tree):
    """The first leaf of a tree (its batch size is the tree's)."""
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def ppermute(blocks: list, perm) -> list:
    """``jax.lax.ppermute`` over per-shard tensors: for each (src, dst) in
    ``perm``, dst receives src's block on dst's device; a shard no pair
    sends to receives zeros."""
    out = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = blocks[src].to(blocks[dst].device)
    return [torch.zeros_like(b) if o is None else o
            for o, b in zip(out, blocks)]


def all_gather(blocks: list) -> list:
    """``jax.lax.all_gather(..., tiled=True)``: every block, in shard
    order, concatenated on each shard's device."""
    return [torch.cat([b.to(d.device) for b in blocks]) for d in blocks]


def psum(blocks: list) -> list:
    """``jax.lax.psum``: the partials added in shard order on the first
    shard's device, the sum copied to each shard's device."""
    dev0 = blocks[0].device
    total = blocks[0]
    for b in blocks[1:]:
        total = total + b.to(dev0)
    return [total.to(b.device) for b in blocks]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_batch(mesh: Mesh, tree, axis: str = "dp") -> list:
    """Split a tree's leading axis over ``mesh[axis]``: a list with one
    tree a shard, each block on its shard's device (leading dims must
    divide the axis size)."""
    devs = mesh.axis_devices(axis)
    D = len(devs)

    def block(x, i, d):
        n = int(np.shape(x)[0])
        if n % D:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"the {D} shards of '{axis}'")
        b = n // D
        return _as_tensor(x[i * b:(i + 1) * b], d)

    return [tree_map(lambda x, i=i, d=d: block(x, i, d), tree)
            for i, d in enumerate(devs)]


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def batch_render(kernel, batched_args, mesh: Mesh | None = None,
                 axis: str = "dp", *, device="cuda"):
    """Run ``torch.func.vmap(kernel)`` over the leading batch axis, each
    shard's block on its device of ``mesh[axis]``, or all of it on
    ``device`` with no mesh.  ``kernel`` maps one job's tensors -> one
    result tree and must be pure torch ops (vmap cannot enter a hand
    kernel's launch); an engine job that runs a hand kernel goes through
    the engine's own batch loop, as Microsound's ``batch_render`` does.
    Every shard is dispatched before any is pulled.  Returns host NumPy
    results in job order."""
    f = torch.func.vmap(kernel)

    def call(args):
        return f(*args) if isinstance(args, tuple) else f(args)

    if mesh is None:
        outs = [call(tree_map(lambda x: _as_tensor(x, device),
                              batched_args))]
    else:
        outs = [call(a) for a in shard_batch(mesh, batched_args, axis)]
    outs = [tree_map(_to_numpy, o) for o in outs]
    return tree_map(lambda *xs: np.concatenate(xs), *outs)


def sharded_sum(parts, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Collective mixdown: parts [S, T] with S split over ``mesh[axis]`` ->
    each shard sums its rows in order, then the ordered ``psum``.  Returns
    the sum on the axis's first device."""
    local = [blk.sum(dim=0) for blk in shard_batch(mesh, parts, axis)]
    return psum(local)[0]


# ---------------------------------------------------------------------------
# Batch manifests (checkpoint/resume for batch renders, SURVEY.md §5)
# ---------------------------------------------------------------------------

@dataclass
class BatchManifest:
    """Resumable record of a batch render: one entry per job with status,
    so a failed shard is re-renderable without redoing the rest."""
    path: str
    jobs: dict

    @staticmethod
    def create(path: str, job_ids: list[str]) -> "BatchManifest":
        m = BatchManifest(path=path,
                          jobs={j: {"status": "pending"} for j in job_ids})
        m.save()
        return m

    @staticmethod
    def load(path: str) -> "BatchManifest":
        with open(path) as f:
            return BatchManifest(path=path, jobs=json.load(f))

    @staticmethod
    def open_or_create(path: str, job_ids: list[str]) -> "BatchManifest":
        if os.path.exists(path):
            m = BatchManifest.load(path)
            for j in job_ids:
                m.jobs.setdefault(j, {"status": "pending"})
            return m
        return BatchManifest.create(path, job_ids)

    def pending(self) -> list[str]:
        return [j for j, v in self.jobs.items() if v["status"] != "done"]

    def mark(self, job_id: str, status: str, **info):
        self.jobs[job_id] = {"status": status, **info}
        self.save()

    def save(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.jobs, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

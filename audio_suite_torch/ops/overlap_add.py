"""Ordered overlap-add of event windows into a long buffer — port of the
contract of audio_suite_tpu/ops/pallas_oa.py.

The contract is ``overlap_add_dus`` (pallas_oa.py:71-87): for e = 0..E-1
in event order, ``out[s_e : s_e + Lw] += vals[e]`` with
``s_e = clip(starts[e], 0, len(out) - Lw)``.  Because each output sample
receives its additions in event order, every implementation of the
contract is bit-identical to every other.  The TPU's ring kernel with its
host plan (``plan_ring``) is machinery for the TPU and is not ported.

``overlap_add`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernel (``kernels/overlap_add.cu``), CPU tensors to the plain
PyTorch loop ``overlap_add_plain``.  Both update ``out`` in place (each
output sample is read and written once, so the kernel needs no second
buffer) and return it.
"""
from __future__ import annotations

import torch

from .. import kernels

CHUNK = 64 * 128                 # flush granularity of the JAX ring layout


def ring_out_len(out_n: int, L: int) -> int:
    """Padded OA buffer length for a render of out_n samples with grain
    windows of L (pallas_oa.py:102): left margin L absorbs negative starts
    down to -L, right slack the overhanging tails; a multiple of CHUNK."""
    raw = L + out_n + L + 2 * CHUNK
    return -(-raw // CHUNK) * CHUNK


def _check(out: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor):
    if out.dim() != 1 or vals.dim() != 2 or starts.dim() != 1:
        raise ValueError("overlap_add wants out [N], vals [E, Lw], "
                         "starts [E]")
    if out.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("overlap_add works on float32 out and vals")
    if starts.shape[0] != vals.shape[0]:
        raise ValueError(f"{vals.shape[0]} windows but "
                         f"{starts.shape[0]} starts")
    if vals.shape[1] > out.shape[0]:
        raise ValueError(f"window length {vals.shape[1]} exceeds the "
                         f"buffer length {out.shape[0]}")
    if not (out.device == vals.device == starts.device):
        raise ValueError("out, vals and starts must share one device")


def overlap_add_plain(out: torch.Tensor, vals: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one window add per event, in event
    order.  The CPU path, and the reference the CUDA kernel is held
    against."""
    _check(out, vals, starts)
    Lw = vals.shape[1]
    hi = out.shape[0] - Lw
    for e, s in enumerate(starts.tolist()):
        s = min(max(int(s), 0), hi)
        out[s:s + Lw] += vals[e]
    return out


def overlap_add(out: torch.Tensor, vals: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """out[clip(starts[e]) + j] += vals[e, j] in event order, in place.
    CUDA tensors run the CUDA kernel (a failed build or launch raises);
    CPU tensors run ``overlap_add_plain``."""
    if out.device.type == "cpu":
        return overlap_add_plain(out, vals, starts)
    _check(out, vals, starts)
    return kernels.overlap_add(out, vals, starts)

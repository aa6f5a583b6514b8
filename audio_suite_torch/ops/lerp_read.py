"""Linear fractional read of a tape at per-sample positions — port of the
contract of audio_suite_tpu/ops/pallas_read.py (``pallas_read_lerp``) in
the tape's coordinates (ops/varispeed.py:1037-1043 of the JAX package):

    i0 = clamp(idx0, 0, n - 1);  i1 = min(i0 + 1, n - 1)
    out = (1 - fr) * audio[i0] + fr * audio[i1]

``fr`` may be negative (the reverse read's edge case, _read_index); the
formula takes it as is.  The clamp matches JAX's clamping gather and keeps
a bad position from reading out of bounds.  The TPU kernel's per-block
``ok`` flag and VMEM slab are TPU machinery and are not ported: a direct
gather has no slab, so every sample is computed by the read.

``lerp_read`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernel (``kernels/lerp_read.cu``), CPU tensors to the plain
PyTorch version ``lerp_read_plain``.  Both evaluate the formula in the
order written above with one IEEE rounding per operation (no fused
multiply-add), so the two are bit-identical.
"""
from __future__ import annotations

import torch

from .. import kernels


def _check(audio: torch.Tensor, idx0: torch.Tensor, fr: torch.Tensor):
    if audio.dim() != 1 or idx0.dim() != 1 or fr.dim() != 1:
        raise ValueError("lerp_read wants audio [n], idx0 [T], fr [T]")
    if audio.dtype != torch.float32 or fr.dtype != torch.float32:
        raise TypeError("lerp_read works on float32 audio and fractions")
    if idx0.dtype != torch.int32:
        raise TypeError("lerp_read wants int32 positions")
    if idx0.shape != fr.shape:
        raise ValueError(f"{idx0.shape[0]} positions but {fr.shape[0]} "
                         "fractions")
    if audio.shape[0] < 1:
        raise ValueError("lerp_read needs at least one audio sample")
    if not (audio.device == idx0.device == fr.device):
        raise ValueError("audio, idx0 and fr must share one device")


def lerp_read_plain(audio: torch.Tensor, idx0: torch.Tensor,
                    fr: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the CPU path, and the reference the CUDA
    kernel is held against."""
    _check(audio, idx0, fr)
    n = audio.shape[0]
    i0 = idx0.clamp(0, n - 1)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    return (1.0 - fr) * audio[i0] + fr * audio[i1]


def lerp_read(audio: torch.Tensor, idx0: torch.Tensor,
              fr: torch.Tensor) -> torch.Tensor:
    """(1 - fr) * audio[i0] + fr * audio[i1] as a new f32 [T] tensor.
    CUDA tensors run the CUDA kernel (a failed build or launch raises);
    CPU tensors run ``lerp_read_plain``."""
    if audio.device.type == "cpu":
        return lerp_read_plain(audio, idx0, fr)
    _check(audio, idx0, fr)
    return kernels.lerp_read(audio, idx0, fr)

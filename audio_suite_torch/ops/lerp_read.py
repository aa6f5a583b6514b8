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

``heads_read`` is the same read in the scrub engine's form: positions
wrap around the tape, one to three heads at fixed offsets, and the head
gain.  It keeps the JAX package's two arithmetics (models/scrub.py), which
round differently and are kept apart:

- ``summed`` (form A, ``_read_blockwise_heads``, integer head offsets):
  the heads' samples are summed first, then one lerp,
  ``x0 * (1 - f) + x1 * f`` with ``x0 = sum_h audio[(whole + ow_h) mod n]``
  and ``x1`` the same one sample on;
- per head (form B, ``fixq.gather_linear_wrap``): each head folds its
  fractional offset into ``frac`` with the carry, lerps, and the lerps are
  summed.

Both sums start from 0 and run in head order; the result is scaled by
``gain``.  ``heads_read`` dispatches like ``lerp_read``: the CUDA kernel
for CUDA tensors, ``heads_read_plain`` for CPU tensors, bit-identical.
"""
from __future__ import annotations

import torch

from .. import kernels
from .fixq import POS_FRAC_BITS, POS_INV_F, gather_linear_wrap


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


def _check_heads(audio, whole, frac, off_whole, off_frac, summed):
    if audio.dim() != 1 or whole.dim() != 1 or frac.dim() != 1:
        raise ValueError("heads_read wants audio [n], whole [T], frac [T]")
    if audio.dtype != torch.float32:
        raise TypeError("heads_read works on float32 audio")
    if whole.dtype != torch.int32 or frac.dtype != torch.int32:
        raise TypeError("heads_read wants int32 positions")
    if whole.shape != frac.shape:
        raise ValueError(f"{whole.shape[0]} positions but {frac.shape[0]} "
                         "fractions")
    if audio.shape[0] < 1:
        raise ValueError("heads_read needs at least one audio sample")
    if not (audio.device == whole.device == frac.device):
        raise ValueError("audio, whole and frac must share one device")
    if not 1 <= len(off_whole) == len(off_frac):
        raise ValueError("heads_read needs one (whole, frac) offset pair "
                         "per head")
    if summed and any(int(v) for v in off_frac):
        raise ValueError("the summed form takes integer head offsets only")


def heads_read_plain(audio: torch.Tensor, whole: torch.Tensor,
                     frac: torch.Tensor, off_whole, off_frac, gain: float,
                     summed: bool) -> torch.Tensor:
    """The plain PyTorch version of the multi-head read: the CPU path, and
    the reference the CUDA kernel is held against.  ``off_whole`` and
    ``off_frac`` are host ints, one per head; ``gain`` an f32 value."""
    _check_heads(audio, whole, frac, off_whole, off_frac, summed)
    n = audio.shape[0]
    if summed:
        x0 = torch.zeros(whole.shape, dtype=torch.float32,
                         device=audio.device)
        x1 = torch.zeros_like(x0)
        w = whole.to(torch.int64)
        for ow in off_whole:
            p = torch.remainder(w + int(ow), n)
            x0 = x0 + audio[p]
            x1 = x1 + audio[torch.remainder(p + 1, n)]
        f = frac.to(torch.float32) * float(POS_INV_F)
        y = x0 * (1.0 - f) + x1 * f
    else:
        y = torch.zeros(whole.shape, dtype=torch.float32,
                        device=audio.device)
        for ow, of in zip(off_whole, off_frac):
            f2 = frac + int(of)
            c2 = f2 >> POS_FRAC_BITS
            w2 = whole + int(ow) + c2
            f2 = f2 - (c2 << POS_FRAC_BITS)
            y = y + gather_linear_wrap(audio, w2, f2)
    return y * float(gain)


def heads_read(audio: torch.Tensor, whole: torch.Tensor, frac: torch.Tensor,
               off_whole, off_frac, gain: float,
               summed: bool) -> torch.Tensor:
    """The scrub's multi-head read as a new f32 [T] tensor.  CUDA tensors
    run the CUDA kernel (a failed build or launch raises); CPU tensors run
    ``heads_read_plain``."""
    if audio.device.type == "cpu":
        return heads_read_plain(audio, whole, frac, off_whole, off_frac,
                                gain, summed)
    _check_heads(audio, whole, frac, off_whole, off_frac, summed)
    return kernels.heads_read(audio, whole, frac, off_whole, off_frac, gain,
                              summed)

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

``heads_read_plain`` is the same read in the scrub engine's form:
positions wrap around the tape, one to three heads at fixed offsets, and
the head gain.  It keeps the JAX package's two arithmetics
(models/scrub.py), which round differently and are kept apart:

- ``summed`` (form A, ``_read_blockwise_heads``, integer head offsets):
  the heads' samples are summed first, then one lerp,
  ``x0 * (1 - f) + x1 * f`` with ``x0 = sum_h audio[(whole + ow_h) mod n]``
  and ``x1`` the same one sample on;
- per head (form B, ``fixq.gather_linear_wrap``): each head folds its
  fractional offset into ``frac`` with the carry, lerps, and the lerps are
  summed.

Both sums start from 0 and run in head order; the result is scaled by
``gain``.  ``scrub_read`` is the scrub render's whole tail over samples
``t0 .. t1`` of a render: that read, then the block envelope
``env_blocks[g // block_size]`` of sample g and, into an int16 output,
PCM16, each op rounded once in the JAX package's order.  It dispatches like
``lerp_read``: the fused CUDA kernel for CUDA tensors,
``scrub_read_plain`` (``heads_read_plain`` followed by the envelope and
PCM16 step) for CPU tensors, bit-identical.
"""
from __future__ import annotations

from typing import Optional

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
    """The plain PyTorch version of the multi-head read, scaled by the
    gain: the first step of ``scrub_read_plain``.  ``off_whole`` and
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


def _check_scrub(audio, whole, frac, off_whole, off_frac, summed,
                 env_blocks, block_size, out, t0, t1):
    _check_heads(audio, whole, frac, off_whole, off_frac, summed)
    if out.dim() != 1 or out.shape != whole.shape:
        raise ValueError(f"scrub_read writes an output of the positions' "
                         f"shape {tuple(whole.shape)}, not {tuple(out.shape)}")
    if out.dtype not in (torch.float32, torch.int16):
        raise TypeError("scrub_read writes float32 or int16 (PCM16)")
    if env_blocks.dim() != 1 or env_blocks.dtype != torch.float32:
        raise TypeError("scrub_read wants a float32 envelope [blocks]")
    if not (audio.device == out.device == env_blocks.device):
        raise ValueError("audio, env_blocks and out must share one device")
    if not (0 <= t0 <= t1 <= out.shape[0] and block_size >= 1):
        raise ValueError(f"samples [{t0}, {t1}) of {out.shape[0]}, block "
                         f"size {block_size}")
    if t1 > t0 and (t1 - 1) // block_size >= env_blocks.shape[0]:
        raise ValueError(f"{env_blocks.shape[0]} envelope blocks of "
                         f"{block_size} do not cover {t1} samples")


def scrub_read_plain(audio: torch.Tensor, whole: torch.Tensor,
                     frac: torch.Tensor, off_whole, off_frac, gain: float,
                     summed: bool, env_blocks: torch.Tensor, block_size: int,
                     out: torch.Tensor, t0: int = 0,
                     t1: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the fused scrub read: the CPU path, and
    the reference the CUDA kernel is held against.  Writes samples
    ``t0 .. t1`` (default: to the end) of ``out`` and returns ``out``."""
    t1 = out.shape[0] if t1 is None else t1
    _check_scrub(audio, whole, frac, off_whole, off_frac, summed,
                 env_blocks, block_size, out, t0, t1)
    y = heads_read_plain(audio, whole[t0:t1], frac[t0:t1], off_whole,
                         off_frac, gain, summed)
    g = torch.arange(t0, t1, device=out.device)
    y = y * env_blocks[torch.div(g, block_size, rounding_mode="floor")]
    if out.dtype == torch.int16:
        y = torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0)
    out[t0:t1] = y.to(out.dtype)
    return out


def scrub_read(audio: torch.Tensor, whole: torch.Tensor, frac: torch.Tensor,
               off_whole, off_frac, gain: float, summed: bool,
               env_blocks: torch.Tensor, block_size: int, out: torch.Tensor,
               t0: int = 0, t1: Optional[int] = None) -> torch.Tensor:
    """The scrub's read, envelope and PCM16 of samples ``t0 .. t1`` into
    ``out`` (f32, or int16 for PCM16), returned.  CUDA tensors run the
    fused CUDA kernel (a failed build or launch raises; the kernel's
    wrapper checks its inputs); CPU tensors run ``scrub_read_plain``."""
    if audio.device.type == "cpu":
        return scrub_read_plain(audio, whole, frac, off_whole, off_frac,
                                gain, summed, env_blocks, block_size, out,
                                t0, t1)
    t1 = out.shape[0] if t1 is None else t1
    return kernels.scrub_read(audio, whole, frac, off_whole, off_frac, gain,
                              summed, env_blocks, block_size, out, t0, t1)

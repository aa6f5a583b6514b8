"""Exact fixed-point tape-position arithmetic, the 12-bit significand
splits and the fractional reads — port of audio_suite_tpu/ops/fixq.py
(all of it but the TPU's one-hot block gather).

A position is ``whole + frac * 2**-POS_FRAC_BITS`` with int32 ``whole`` and
``frac`` in ``[0, POS_ONE)``; increments are quantized through single-
rounding f32 ops, so every discrete decision is integer math and bit-
identical to the JAX package and its NumPy twins (``*_np``, kept beside
them).

The reads: ``gather_linear_wrap`` (the scrub's two-tap wrap-around read,
bit-equal to its NumPy twin; the scrub render itself reads through
``ops/lerp_read.py:heads_read``) and the 16-tap Lanczos-sinc quality reads
``gather_sinc_wrap`` / ``gather_sinc_clip``.  The sinc reads stay plain
PyTorch on every device, as the JAX package computes them outside any
Pallas kernel; they gather each tap directly instead of building the JAX
package's packed [n, taps] row table (a TPU gather trick), which gives the
same values, and keep its tap order.  Their twins agree to ~1e-5 (sin
ulps), like the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

POS_FRAC_BITS = 22
POS_ONE = 1 << POS_FRAC_BITS          # 4194304
POS_MASK = POS_ONE - 1
POS_ONE_F = float(POS_ONE)
POS_INV_F = np.float32(1.0 / POS_ONE)

_SIG_ROUND = 0x0800
_SIG_MASK = ~0x0FFF


def quantize_f32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the 2**-POS_FRAC_BITS grid, staying in f32
    (exact scale, round-half-even, exact downscale)."""
    x = x.to(torch.float32)
    return torch.round(x * POS_ONE_F) * float(POS_INV_F)


def quantize_f32_np(x):
    x = np.asarray(x, np.float32)
    return (np.rint(x * np.float32(POS_ONE)) * POS_INV_F).astype(np.float32)


def _f32(x, device) -> torch.Tensor:
    """``x`` as f32 on ``device``; a tensor stays on its own device when
    ``device`` is None, a host value needs one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device,
                    dtype=torch.float32)
    if device is None:
        raise TypeError("a host value needs an explicit device")
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def to_fix(x, *, device=None) -> torch.Tensor:
    """f32 value -> int32 fixed point (2**-POS_FRAC_BITS units): exact
    scale, round-half-even.  |x| must stay below 2**(31 - POS_FRAC_BITS)
    (512 samples); use ``split_pos_np`` for positions."""
    return torch.round(_f32(x, device) * POS_ONE_F).to(torch.int32)


def to_fix_np(x):
    x = np.asarray(x, np.float32)
    return np.rint(x * np.float32(POS_ONE)).astype(np.int32)


def inc_fix(speed_q, mod_q, *, device=None) -> torch.Tensor:
    """Fixed-point per-sample increment from quantized f32 speed and mod:
    one f32 rounding (the product); the scale and the rounding to an
    integer are exact."""
    r = _f32(speed_q, device) * _f32(mod_q, device)
    return torch.round(r * POS_ONE_F).to(torch.int32)


def inc_fix_np(speed_q, mod_q):
    r = np.float32(speed_q) * np.asarray(mod_q, np.float32)
    return np.rint(r * np.float32(POS_ONE)).astype(np.int32)


def fix_to_f32(whole, frac, *, device=None) -> torch.Tensor:
    """Approximate f32 view of a fixed-point position, for continuous
    math only, never for decisions."""
    return _f32(whole, device) + _f32(frac, device) * float(POS_INV_F)


def split_pos_np(v) -> tuple[int, int]:
    """Split an absolute position (float, up to 2**31 samples) into an
    exact (whole, frac) pair of Python ints."""
    v = float(v)
    w = int(np.floor(v))
    f = int(np.rint((v - w) * POS_ONE))
    if f >= POS_ONE:
        w += 1
        f -= POS_ONE
    return w, f


def round_sig12(x: torch.Tensor) -> torch.Tensor:
    """Round the f32 significand to 12 bits (round-half-up in mantissa
    space, carrying into the exponent) with integer bit ops."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + _SIG_ROUND) & _SIG_MASK).view(torch.float32)


def round_sig12_np(x):
    x = np.asarray(x, np.float32)
    b = x.view(np.int32)
    b = ((b + np.int32(_SIG_ROUND)) & np.int32(_SIG_MASK)).astype(np.int32)
    return b.view(np.float32)


def sig12_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split f32 x into (hi, lo) 12-bit-significand pieces with
    hi + lo ≈ x to ~24 bits: hi = round_sig12(x), lo = round_sig12(x - hi)
    (the residual is exact).  A product of two pieces is exact in f32, so
    sums of piece products round alike fused or unfused."""
    x = x.to(torch.float32)
    hi = round_sig12(x)
    lo = round_sig12(x - hi)
    return hi, lo


def sig12_pair_np(x):
    x = np.asarray(x, np.float32)
    hi = round_sig12_np(x)
    lo = round_sig12_np((x - hi).astype(np.float32))
    return hi, lo


def gather_linear_wrap(audio: torch.Tensor, whole: torch.Tensor,
                       frac: torch.Tensor) -> torch.Tensor:
    """Wrap-around two-tap linear read: positions wrap mod n (Python's
    sign rule: ``torch.remainder``, never ``fmod``), then
    ``(1 - fr) * audio[pw] + fr * audio[(pw + 1) mod n]``."""
    n = audio.shape[0]
    pw = torch.remainder(whole, n)
    i1 = torch.remainder(pw + 1, n)
    fr = frac.to(torch.float32) * float(POS_INV_F)
    return (1.0 - fr) * audio[pw] + fr * audio[i1]


def gather_linear_wrap_np(audio, whole, frac):
    n = audio.shape[0]
    pw = np.mod(whole, n)
    i1 = np.mod(pw + 1, n)
    fr = frac.astype(np.float32) * POS_INV_F
    s0 = audio[pw]
    s1 = audio[i1]
    return (np.float32(1.0) - fr) * s0 + fr * s1


def _lanczos_w(x: torch.Tensor, half: int) -> torch.Tensor:
    # sinc(x) * sinc(x / half) on |x| < half, 0 outside; torch.sinc, like
    # jnp.sinc, is the normalized sinc
    return torch.where(torch.abs(x) < half,
                       torch.sinc(x) * torch.sinc(x / half), 0.0)


def _sinc_weight_dot(vals, fr: torch.Tensor, half: int) -> torch.Tensor:
    """Weight-normalized tap dot: ``vals[t]`` is tap t's [T] column (the
    JAX package's ``vals[..., t]``), accumulated in tap order with one
    rounding per op."""
    acc = torch.zeros_like(fr)
    wsum = torch.zeros_like(fr)
    for t, j in enumerate(range(-half + 1, half + 1)):
        w = _lanczos_w(float(j) - fr, half)
        acc = acc + w * vals[t]
        wsum = wsum + w
    return acc / wsum


def gather_sinc_wrap(audio: torch.Tensor, whole: torch.Tensor,
                     frac: torch.Tensor, taps: int = 16) -> torch.Tensor:
    """Wrap-around Lanczos-windowed-sinc read (quality mode): taps at
    offsets j in [-taps/2 + 1, taps/2] around ``whole mod n``, weights
    sinc(j - fr) * sinc((j - fr) / half) normalized to unit sum."""
    n = audio.shape[0]
    half = taps // 2
    fr = frac.to(torch.float32) * float(POS_INV_F)
    pw = torch.remainder(whole.to(torch.int64), n)
    vals = [audio[torch.remainder(pw + j, n)]
            for j in range(-half + 1, half + 1)]
    return _sinc_weight_dot(vals, fr, half)


def gather_sinc_clip(audio: torch.Tensor, whole: torch.Tensor,
                     frac: torch.Tensor, taps: int = 16) -> torch.Tensor:
    """Edge-clamped variant (the tape's reads clamp at the buffer ends):
    tap j reads ``audio[clip(clip(whole, 0, n-1) + j, 0, n-1)]``, the
    values of the JAX package's edge-padded shifted rows."""
    n = audio.shape[0]
    half = taps // 2
    fr = frac.to(torch.float32) * float(POS_INV_F)
    i0 = whole.to(torch.int64).clamp(0, n - 1)
    vals = [audio[(i0 + j).clamp(0, n - 1)]
            for j in range(-half + 1, half + 1)]
    return _sinc_weight_dot(vals, fr, half)


def _lanczos_w_np(x, half):
    return np.where(np.abs(x) < half,
                    np.sinc(x) * np.sinc(x / half), 0.0).astype(np.float32)


def gather_sinc_wrap_np(audio, whole, frac, taps: int = 16):
    n = audio.shape[0]
    half = taps // 2
    fr = frac.astype(np.float32) * POS_INV_F
    acc = np.zeros(np.shape(whole), np.float32)
    wsum = np.zeros(np.shape(whole), np.float32)
    for j in range(-half + 1, half + 1):
        w = _lanczos_w_np(np.float32(j) - fr, half)
        acc = np.float32(acc + w * audio[np.mod(whole + j, n)])
        wsum = np.float32(wsum + w)
    return acc / wsum


def pos_add(whole, frac, inc, frac_bits: int = POS_FRAC_BITS):
    """(whole, frac) += inc with carry normalization; inc may be negative
    (the arithmetic right shift floors, as in the JAX package)."""
    f = frac + inc
    carry = f >> frac_bits
    return whole + carry, f - (carry << frac_bits)


def pos_add_np(whole, frac, inc, frac_bits: int = POS_FRAC_BITS):
    f = frac + inc
    carry = f >> frac_bits
    return whole + carry, f - (carry << frac_bits)


def segmented_pos_cumsum(inc: torch.Tensor, reset: torch.Tensor,
                         init_whole=0, init_frac=0):
    """Inclusive segmented prefix sum of fixed-point increments:
    ``pos[i] = init + sum(inc[j] for j in (last reset <= i) .. i)``, where
    ``reset[i]`` restarts the sum at element i and the init applies only
    before the first reset.  Returns (whole int32, frac int32).  The init
    is a pair of Python ints or of integer scalar tensors on ``inc``'s
    device (a seed computed on the device needs no host sync).

    The JAX package runs this as a blocked Hillis-Steele scan to keep XLA's
    compile times down; here it is one int64 ``cumsum`` that restarts at
    each reset.  Integer sums are exact, so the two are bit-identical.

    Each element subtracts the exclusive sum at its segment's start, found
    by segment number (a ``cumsum`` of the resets) in a table that a
    scatter fills: no host sync, and no ``cummax``, whose CUDA scan is
    slow at millions of elements."""
    inc = inc.to(torch.int64)
    incl = torch.cumsum(inc, 0)
    seg = torch.cumsum(reset, 0)          # 0 before the first reset
    base = torch.zeros(inc.shape[0] + 1, dtype=torch.int64,
                       device=inc.device)
    # every reset writes its own slot; the rest write 0 into slot 0,
    # which then takes the initial position
    base.scatter_(0, torch.where(reset, seg, 0),
                  torch.where(reset, incl - inc, 0))
    w, f = (v.to(torch.int64) if isinstance(v, torch.Tensor) else int(v)
            for v in (init_whole, init_frac))
    init = -(w * POS_ONE + f)
    # fill_ and copy_ stay on the device; `base[0] = number` would copy a
    # host scalar in, and that copy synchronizes the host with the card
    if isinstance(init, torch.Tensor):
        base[0].copy_(init)
    else:
        base[0].fill_(init)
    val = incl - base[seg]
    return ((val >> POS_FRAC_BITS).to(torch.int32),
            (val & POS_MASK).to(torch.int32))


def segmented_pos_cumsum_np(inc, reset, init_whole=0, init_frac=0):
    """Sequential NumPy mirror of ``segmented_pos_cumsum`` (the oracle),
    bit-identical to it."""
    inc = np.asarray(inc, np.int64)  # headroom; results fit int32 by contract
    n = inc.shape[0]
    whole = np.zeros(n, np.int64)
    frac = np.zeros(n, np.int64)
    w = int(init_whole)
    f = int(init_frac)
    for i in range(n):
        if reset[i]:
            w = 0
            f = 0
        f += int(inc[i])
        carry = f >> POS_FRAC_BITS
        w += carry
        f -= carry << POS_FRAC_BITS
        whole[i] = w
        frac[i] = f
    return whole.astype(np.int32), frac.astype(np.int32)

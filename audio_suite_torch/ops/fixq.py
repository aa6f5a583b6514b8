"""Exact fixed-point tape-position arithmetic and the 12-bit significand
splits — port of audio_suite_tpu/ops/fixq.py (the parts the tape render
and the Pattern Lab voices use).

A position is ``whole + frac * 2**-POS_FRAC_BITS`` with int32 ``whole`` and
``frac`` in ``[0, POS_ONE)``; increments are quantized through single-
rounding f32 ops, so every discrete decision is integer math and bit-
identical to the JAX package and its NumPy twins (``*_np``, kept beside
them).
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


def segmented_pos_cumsum(inc: torch.Tensor, reset: torch.Tensor,
                         init_whole: int = 0, init_frac: int = 0):
    """Inclusive segmented prefix sum of fixed-point increments:
    ``pos[i] = init + sum(inc[j] for j in (last reset <= i) .. i)``, where
    ``reset[i]`` restarts the sum at element i and the init applies only
    before the first reset.  Returns (whole int32, frac int32).

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
    base[0] = -(int(init_whole) * POS_ONE + int(init_frac))
    val = incl - base[seg]
    return ((val >> POS_FRAC_BITS).to(torch.int32),
            (val & POS_MASK).to(torch.int32))

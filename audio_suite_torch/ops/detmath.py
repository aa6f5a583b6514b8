"""Deterministic elementwise transcendentals — port of
audio_suite_tpu/ops/detmath.py: the sine and long-range LFO phase twins
the tape's wow/flutter curve is built from, and the precise sine / exp2
twins, ``exp2`` and ``frac_signed`` of the Pattern Lab FM voice.

Arguments are in cycles and reduced with ``x - round(x)``, an exact f32
operation; the polynomial keeps the JAX package's Horner order, and every
op here is one eager PyTorch kernel with one IEEE rounding, so the results
are bit-identical to the NumPy twins (``*_np``, kept beside them as in the
JAX package) and to the JAX functions on the CPU.

Torch's ``uint32`` support is thin, so the phase reduction runs in int64:
``phase_ratio`` guarantees ``num * (m - 1) < 2**32``, which int64 holds
exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .fixq import sig12_pair, sig12_pair_np

# sin(2*pi*v), cos(2*pi*v) Taylor coefficients in v (|v| <= 1/8)
_TWO_PI = 2.0 * np.pi
_S = [(_TWO_PI ** (2 * k + 1)) / math.factorial(2 * k + 1) * (-1) ** k
      for k in range(5)]
_C = [(_TWO_PI ** (2 * k)) / math.factorial(2 * k) * (-1) ** k
      for k in range(5)]
_S32 = [np.float32(c) for c in _S]
_C32 = [np.float32(c) for c in _C]
# the same f32 values as Python floats: a Python scalar meets an f32
# tensor as an f32 operand, exactly
_SF = [float(c) for c in _S32]
_CF = [float(c) for c in _C32]

# exp2 polynomial: 2**r on |r| <= 0.5 as a degree-7 Taylor series
_LN2 = float(np.log(2.0))
_E2C = [np.float32(_LN2 ** k / math.factorial(k)) for k in range(1, 8)]
_E2F = [float(c) for c in _E2C]


def _poly_sin(v: torch.Tensor) -> torch.Tensor:
    z = v * v
    return v * (_SF[0] + z * (_SF[1] + z * (_SF[2] + z * (_SF[3]
                                                          + z * _SF[4]))))


def _poly_cos(v: torch.Tensor) -> torch.Tensor:
    z = v * v
    return _CF[0] + z * (_CF[1] + z * (_CF[2] + z * (_CF[3] + z * _CF[4])))


def sin_cycles(x: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*x) for f32 x in cycles (|x| below ~2**22)."""
    x = x.to(torch.float32)
    x4 = x * 4.0                                # exact
    q = torch.round(x4)                         # round-half-even, as rint
    v = (x4 - q) * 0.25                         # exact; |v| <= 1/8
    m = q.to(torch.int32) & 3
    sp = _poly_sin(v)
    cp = _poly_cos(v)
    return torch.where(m == 0, sp,
                       torch.where(m == 1, cp,
                                   torch.where(m == 2, -sp, -cp)))


def sin_cycles_np(x):
    x = np.asarray(x, np.float32)
    x4 = x * np.float32(4.0)
    q = np.rint(x4)
    v = ((x4 - q) * np.float32(0.25)).astype(np.float32)
    m = q.astype(np.int64).astype(np.int32) & 3
    z = v * v
    sp = v * (_S32[0] + z * (_S32[1] + z * (_S32[2] + z * (_S32[3]
                                                           + z * _S32[4]))))
    cp = _C32[0] + z * (_C32[1] + z * (_C32[2] + z * (_C32[3] + z * _C32[4])))
    return np.where(m == 0, sp,
                    np.where(m == 1, cp,
                             np.where(m == 2, -sp, -cp))).astype(np.float32)


def _const_pair(c) -> tuple[float, float]:
    """sig12_pair of an f32 constant, on the host: the first Horner step
    of a precise twin splits a constant, which needs no launch."""
    hi, lo = sig12_pair_np(np.float32(c))
    return float(hi), float(lo)


def sin_cycles_precise(x: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*x) deterministic to the full f32 result: every multiply of
    the Horner recurrence takes two <=12-bit-significand operands
    (``fixq.sig12_pair``), so each product is exact and no FMA
    contraction can change a rounding (audio_suite_tpu/ops/detmath.py:84)."""
    x = x.to(torch.float32)
    x4 = x * 4.0                                # exact
    q = torch.round(x4)
    v = (x4 - q) * 0.25                         # exact; |v| <= 1/8
    m = q.to(torch.int32) & 3
    zh, zl = sig12_pair(v * v)
    th, tl = _const_pair(_S32[4])
    sp = _SF[3] + (zh * th + zh * tl + zl * th)
    for c in (_SF[2], _SF[1], _SF[0]):
        th, tl = sig12_pair(sp)
        sp = c + (zh * th + zh * tl + zl * th)
    vh, vl = sig12_pair(v)
    ph, pl = sig12_pair(sp)
    sp = vh * ph + vh * pl + vl * ph
    th, tl = _const_pair(_C32[4])
    cp = _CF[3] + (zh * th + zh * tl + zl * th)
    for c in (_CF[2], _CF[1], _CF[0]):
        th, tl = sig12_pair(cp)
        cp = c + (zh * th + zh * tl + zl * th)
    return torch.where(m == 0, sp,
                       torch.where(m == 1, cp,
                                   torch.where(m == 2, -sp, -cp)))


def sin_cycles_precise_np(x):
    x = np.asarray(x, np.float32)
    x4 = x * np.float32(4.0)
    q = np.rint(x4)
    v = ((x4 - q) * np.float32(0.25)).astype(np.float32)
    m = q.astype(np.int64).astype(np.int32) & 3
    zh, zl = sig12_pair_np((v * v).astype(np.float32))
    sp = np.full_like(v, _S32[4])
    for c in (_S32[3], _S32[2], _S32[1], _S32[0]):
        th, tl = sig12_pair_np(sp)
        sp = (c + (zh * th + zh * tl + zl * th)).astype(np.float32)
    vh, vl = sig12_pair_np(v)
    ph, pl = sig12_pair_np(sp)
    sp = (vh * ph + vh * pl + vl * ph).astype(np.float32)
    cp = np.full_like(v, _C32[4])
    for c in (_C32[3], _C32[2], _C32[1], _C32[0]):
        th, tl = sig12_pair_np(cp)
        cp = (c + (zh * th + zh * tl + zl * th)).astype(np.float32)
    return np.where(m == 0, sp,
                    np.where(m == 1, cp,
                             np.where(m == 2, -sp, -cp))).astype(np.float32)


def _exp2_scale(val: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """val * 2**k for integral f32 k, the power of two built in the
    exponent field ((k + 127) << 23 viewed as f32): an exact multiply."""
    ki = k.to(torch.int32).clamp(-126, 126)
    return val * ((ki + 127) << 23).view(torch.float32)


def exp2_precise(y: torch.Tensor) -> torch.Tensor:
    """2**y deterministic to the full f32 result: like
    ``sin_cycles_precise``, every Horner product takes two sig12 pieces
    (audio_suite_tpu/ops/detmath.py:141)."""
    y = y.to(torch.float32)
    k = torch.round(y)
    r = y - k                                    # exact, |r| <= 0.5
    rh, rl = sig12_pair(r)
    th, tl = _const_pair(_E2C[6])
    c = _E2F[5] + (rh * th + rh * tl + rl * th)
    for coef in (_E2F[4], _E2F[3], _E2F[2], _E2F[1], _E2F[0]):
        th, tl = sig12_pair(c)
        c = coef + (rh * th + rh * tl + rl * th)
    ch, cl = sig12_pair(c)
    c = rh * ch + rh * cl + rl * ch
    return _exp2_scale(1.0 + c, k)


def exp2_precise_np(y):
    y = np.asarray(y, np.float32)
    k = np.rint(y)
    r = (y - k).astype(np.float32)
    rh, rl = sig12_pair_np(r)
    c = np.full_like(r, _E2C[6])
    for coef in (_E2C[5], _E2C[4], _E2C[3], _E2C[2], _E2C[1], _E2C[0]):
        th, tl = sig12_pair_np(c)
        c = (coef + (rh * th + rh * tl + rl * th)).astype(np.float32)
    ch, cl = sig12_pair_np(c)
    c = (rh * ch + rh * cl + rl * ch).astype(np.float32)
    val = (np.float32(1.0) + c).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -126, 126)
    scale = np.asarray((ki + 127) << 23, np.int32).view(np.float32)
    return (val * scale).astype(np.float32)


def exp2(y: torch.Tensor) -> torch.Tensor:
    """2**y for f32 y (|y| <= ~100): branchless degree-7 polynomial on
    r = y - round(y), then the exponent scale."""
    y = y.to(torch.float32)
    k = torch.round(y)
    r = y - k                                    # exact, |r| <= 0.5
    c = r * (_E2F[0] + r * (_E2F[1] + r * (_E2F[2] + r * (_E2F[3]
            + r * (_E2F[4] + r * (_E2F[5] + r * _E2F[6]))))))
    return _exp2_scale(1.0 + c, k)


def exp2_np(y):
    y = np.asarray(y, np.float32)
    k = np.rint(y)
    r = (y - k).astype(np.float32)
    c = r * (_E2C[0] + r * (_E2C[1] + r * (_E2C[2] + r * (_E2C[3]
            + r * (_E2C[4] + r * (_E2C[5] + r * _E2C[6]))))))
    val = (np.float32(1.0) + c).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -126, 126)
    scale = np.asarray((ki + 127) << 23, np.int32).view(np.float32)
    return (val * scale).astype(np.float32)


def cos_cycles(x: torch.Tensor) -> torch.Tensor:
    return sin_cycles(x.to(torch.float32) + 0.25)


def cos_cycles_np(x):
    return sin_cycles_np(np.asarray(x, np.float32) + np.float32(0.25))


def frac_signed(x: torch.Tensor) -> torch.Tensor:
    """x - round(x): the exact signed fractional part, in [-0.5, 0.5]."""
    x = x.to(torch.float32)
    return x - torch.round(x)


def frac_signed_np(x):
    x = np.asarray(x, np.float32)
    return (x - np.rint(x)).astype(np.float32)


def phase_ratio(freq_num: int, freq_den: int, sr: int):
    """Reduce an LFO frequency ``freq_num/freq_den`` Hz at integer sample
    rate ``sr`` to ``(num, m, inv_m)``: the phase in cycles at sample i is
    ``(((i mod m) * num) mod m) * inv_m``, exact for any sample index."""
    num = int(freq_num)
    m = int(freq_den) * int(sr)
    if m <= 0 or num < 0:
        raise ValueError("phase_ratio needs positive den*sr and num >= 0")
    g = math.gcd(num, m)
    num //= g
    m //= g
    if m >= 2 ** 24 or num * (m - 1) >= 2 ** 32:
        raise ValueError("phase_ratio residue would overflow exact range")
    return np.uint32(num), np.uint32(m), np.float32(1.0 / m)


def phase_cycles(i: torch.Tensor, num, m, inv_m) -> torch.Tensor:
    """Long-range-exact LFO phase in cycles for sample indices ``i``
    (integer tensor of uint32 values, computed in int64)."""
    i = i.to(torch.int64)
    r = ((i % int(m)) * int(num)) % int(m)
    return r.to(torch.float32) * float(np.float32(inv_m))


def phase_cycles_np(i, num, m, inv_m):
    i = np.asarray(i, np.uint32)
    r = ((i % np.uint32(m)) * np.uint32(num)) % np.uint32(m)
    return (r.astype(np.float32) * np.float32(inv_m)).astype(np.float32)


def rounded(fn, *args) -> torch.Tensor:
    """``fn`` (a transcendental: exp, cos, log, pow, tanh, a complex
    magnitude or angle) evaluated on f64 copies of its tensor arguments
    and rounded once to f32 (complex64).  The card's and the CPU's f32
    exp / cos / pow differ in the last ulp; their f64 results differ by
    ~1e-16, which rounds to the same f32 on both (but for a result within
    1e-16 of a rounding midpoint), so Microsound's grains come out the
    same on every device.  A loud mix's soft clip turns an ulp of the mix
    into -100 dBFS, which a device-dependent ulp would cross."""
    wide = [a.to(torch.complex128 if a.is_complex() else torch.float64)
            if isinstance(a, torch.Tensor) else a for a in args]
    out = fn(*wide)
    return out.to(torch.complex64 if out.is_complex() else torch.float32)

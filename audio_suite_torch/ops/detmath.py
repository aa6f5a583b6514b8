"""Deterministic elementwise transcendentals — port of
audio_suite_tpu/ops/detmath.py (the sine and long-range LFO phase twins
the tape's wow/flutter curve is built from).

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

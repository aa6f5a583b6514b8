"""Integer and f32 building blocks of the plain references, in NumPy.

Frozen copies of the framework's host twins: the counter-noise hash
(murmur3 finalizer of seed, index and stream; Irwin-Hall(12) normals), the
sine / exp2 polynomials on arguments in cycles, the 12-bit significand
rounding, and the bit quantizer.  They define the suite's semantics bit
for bit, so the references draw the same noise and phases as any correct
renderer.  ``bf16`` rounds an array to bfloat16's 8-bit significand: the
controls run the references through it at every stage.
"""
from __future__ import annotations

import math

import numpy as np

_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)
_INV24 = np.float32(1.0 / (1 << 24))


def hash_u32(seed, idx, stream=0):
    seed = np.asarray(seed, np.int64).astype(np.uint32)
    idx = np.asarray(idx, np.int64).astype(np.uint32)
    stream = np.uint32(int(stream) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        h = seed * _GOLDEN + idx * _M1 + stream * _M2
        h = h ^ (h >> np.uint32(16))
        h = h * _M1
        h = h ^ (h >> np.uint32(13))
        h = h * _M2
        h = h ^ (h >> np.uint32(16))
    return h


def uniform(seed, idx, stream=0):
    """U[0, 1) with 24 random bits, f32."""
    return ((hash_u32(seed, idx, stream) >> np.uint32(8)).astype(np.float32)
            * _INV24)


def normal(seed, idx, stream=0):
    """Irwin-Hall(12) - 6, summed in f32 in stream order, f32."""
    acc = np.zeros(np.broadcast_shapes(np.shape(seed), np.shape(idx)),
                   np.float32)
    for k in range(12):
        acc = acc + uniform(seed, idx, stream * 12 + k + 1)
    return (acc - np.float32(6.0)).astype(np.float32)


# --- 12-bit significand rounding: products of two such pieces are exact

def round_sig12(x):
    b = np.asarray(x, np.float32).view(np.int32)
    return ((b + np.int32(0x0800)) & np.int32(~0x0FFF)).astype(np.int32) \
        .view(np.float32)


def sig12_pair(x):
    x = np.asarray(x, np.float32)
    hi = round_sig12(x)
    return hi, round_sig12((x - hi).astype(np.float32))


# --- sin(2 pi x) and 2**y on f32 arguments

_TWO_PI = 2.0 * np.pi
_S32 = [np.float32((_TWO_PI ** (2 * k + 1)) / math.factorial(2 * k + 1)
                   * (-1) ** k) for k in range(5)]
_C32 = [np.float32((_TWO_PI ** (2 * k)) / math.factorial(2 * k) * (-1) ** k)
        for k in range(5)]
_E2C = [np.float32(math.log(2.0) ** k / math.factorial(k))
        for k in range(1, 8)]


def _quadrant(x):
    x4 = np.asarray(x, np.float32) * np.float32(4.0)
    q = np.rint(x4)
    v = ((x4 - q) * np.float32(0.25)).astype(np.float32)
    return v, q.astype(np.int64).astype(np.int32) & 3


def _by_quadrant(m, sp, cp):
    return np.where(m == 0, sp, np.where(m == 1, cp, np.where(
        m == 2, -sp, -cp))).astype(np.float32)


def sin_cycles(x):
    v, m = _quadrant(x)
    z = v * v
    sp = v * (_S32[0] + z * (_S32[1] + z * (_S32[2] + z * (_S32[3]
                                                           + z * _S32[4]))))
    cp = _C32[0] + z * (_C32[1] + z * (_C32[2] + z * (_C32[3] + z * _C32[4])))
    return _by_quadrant(m, sp, cp)


def _horner_exact(c0, coefs, zh, zl):
    acc = np.full_like(zh, c0)
    for c in coefs:
        th, tl = sig12_pair(acc)
        acc = (c + (zh * th + zh * tl + zl * th)).astype(np.float32)
    return acc


def sin_cycles_precise(x):
    v, m = _quadrant(x)
    zh, zl = sig12_pair((v * v).astype(np.float32))
    sp = _horner_exact(_S32[4], _S32[3::-1], zh, zl)
    vh, vl = sig12_pair(v)
    ph, pl = sig12_pair(sp)
    sp = (vh * ph + vh * pl + vl * ph).astype(np.float32)
    cp = _horner_exact(_C32[4], _C32[3::-1], zh, zl)
    return _by_quadrant(m, sp, cp)


def exp2_precise(y):
    y = np.asarray(y, np.float32)
    k = np.rint(y)
    r = (y - k).astype(np.float32)
    rh, rl = sig12_pair(r)
    c = _horner_exact(_E2C[6], _E2C[5::-1], rh, rl)
    ch, cl = sig12_pair(c)
    c = (rh * ch + rh * cl + rl * ch).astype(np.float32)
    val = (np.float32(1.0) + c).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -126, 126)
    scale = np.asarray((ki + 127) << 23, np.int32).view(np.float32)
    return (val * scale).astype(np.float32)


def frac_signed(x):
    x = np.asarray(x, np.float32)
    return (x - np.rint(x)).astype(np.float32)


def quantize_to_bits(x, bits: int):
    """Symmetric quantization to +-1 in 2**(bits-1) - 1 steps, all f32,
    the downscale a multiply by the f32 reciprocal."""
    lm1 = 2 ** (bits - 1) - 1
    inv = np.float32(1.0 / float(lm1))
    y = np.clip(np.asarray(x, np.float32), np.float32(-1.0), np.float32(1.0))
    return (np.round(y * np.float32(lm1)) * inv).astype(np.float32)


def pcm16(x):
    """Float audio in [-1, 1] as int16 PCM: round half to even, clamp."""
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                   -32768.0, 32767.0).astype(np.int16)


def bf16(x):
    """x rounded to bfloat16 (round to nearest even on the f32 bits) and
    returned in x's float type; complex arrays round both parts."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return bf16(x.real) + 1j * bf16(x.imag)
    b = x.astype(np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
    return b.view(np.float32).astype(x.dtype if x.dtype.kind == "f"
                                     else np.float64)


def exact(x):
    """The references' precision hook at full precision: no rounding."""
    return x

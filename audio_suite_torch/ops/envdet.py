"""Deterministic envelope -> mod-speed chain — port of
audio_suite_tpu/ops/envdet.py, with its NumPy twins.

Grid Audio's clock modulation derives a per-sample speed from the RMS
envelope of an earlier track (box sum of x**2, sqrt, normalize to the max,
speed = clip(1 + amount*env, 0.25, 4)).  The device chain, its NumPy twin
and the JAX package's chain give one bit-identical speed array, so the
placement decisions (integer phase) never diverge.

How each float hazard is closed, as in the JAX package:

- **FMA contraction**: every float product is exact (12-bit significand
  splits of the square, power-of-two scales), except ``a_q12 * e15``,
  one single-rounded multiply that feeds a cast.  Eager PyTorch runs each
  op as its own launch, so nothing contracts; keep it so (no ``addcmul``,
  no ``torch.compile``, no fused kernel on this chain).
- **Association order**: the box sums are built from doubling level
  arrays by shifted adds in one fixed order (``_box_sums_direct``), the
  same DAG for every backend.
- **div / sqrt rounding**: the normalize -> sqrt -> speed stage is int32
  arithmetic; ``isqrt30`` corrects the f32 sqrt estimate by one in each
  direction, so the sqrt's rounding does not matter.

The JAX device twin masks the box sums beyond the true length of its
padded render; the port renders at the true length, so its device chain
is the host twin's computation at ``n`` and takes no mask.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import fixq

_HI_MASK = -4096                  # 0xFFFFF000 as int32: drop 12 mantissa bits
_HI_MASK_NP = np.int32(_HI_MASK)
_ENV_BITS = 15
_POS_ONE = 1 << fixq.POS_FRAC_BITS
_SPEED_LO = 1 << (fixq.POS_FRAC_BITS - 2)        # 0.25
_SPEED_HI = 4 << fixq.POS_FRAC_BITS              # 4.0


def exact_sq(x: torch.Tensor) -> torch.Tensor:
    """x**2 with every multiply exact: hi = x with its low 12 mantissa bits
    zeroed, lo = x - hi (exact), square as hi*hi + (2*hi)*lo + lo*lo; the
    two adds round, in this order."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    lo = x - hi
    return (hi * hi + (hi + hi) * lo) + lo * lo


def exact_sq_np(x):
    x = np.asarray(x, np.float32)
    hi = (x.view(np.int32) & _HI_MASK_NP).view(np.float32)
    lo = np.float32(x - hi)
    return np.float32(np.float32(np.float32(hi * hi)
                                 + np.float32(np.float32(hi + hi) * lo))
                      + np.float32(lo * lo))


def _box_sums_direct(x2, n: int, win: int, np_mod):
    """Box sums of the 'same' window over a zero-padded signal: s[i] =
    sum x2[i - win//2 .. i + (win-1)//2].  Level arrays S_k[j] = sum of
    2**k consecutive terms are built by shifted adds, and each window is
    assembled from the set bits of ``win`` at static offsets, from the low
    bit up.  ``np_mod`` is ``torch`` (x2 a tensor) or ``np``; both perform
    this DAG in this order, so the results are bit-equal (adding exact
    zeros is exact: x2 >= 0)."""
    levels = max(1, int(win).bit_length())
    lead = win // 2
    # at level k the array has shrunk by 2**k - 1 and the term offset can
    # reach 2**k - 1: 2*win of tail zeros keeps every slice in range
    m = lead + n + 2 * win + 2
    if np_mod is np:
        P = np.pad(np.asarray(x2, np.float32), (lead, m - lead - n))
        s = np.zeros(n, np.float32)
    else:
        P = F.pad(x2.to(torch.float32), (lead, m - lead - n))
        s = torch.zeros(n, dtype=torch.float32, device=x2.device)
    S = P
    off = 0
    for k in range(levels):
        if (win >> k) & 1:
            term = S[off:off + n]
            s = (s + term).astype(np.float32) if np_mod is np else s + term
        off += ((win >> k) & 1) << k
        if k + 1 < levels:
            sh = 1 << k
            if np_mod is np:
                S = np.float32(S[:-sh] + S[sh:]) if sh < len(S) else S
            else:
                S = S[:-sh] + S[sh:]
    return s


def isqrt30(uq: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(uq)) for int32 uq in [0, 2**30]: f32 sqrt estimate, then
    one integer correction each way ((y+1)**2 <= 2**30 + 2**16 stays in
    int32)."""
    uq = uq.to(torch.int32)
    y = torch.sqrt(uq.to(torch.float32)).to(torch.int32)
    y = torch.where(y * y > uq, y - 1, y)
    return torch.where((y + 1) * (y + 1) <= uq, y + 1, y)


def isqrt30_np(uq):
    uq = np.asarray(uq, np.int32)
    y = np.sqrt(uq.astype(np.float32)).astype(np.int32)
    y = np.where(y * y > uq, y - 1, y)
    y = np.where((y + 1) * (y + 1) <= uq, y + 1, y)
    return y


def amount_q12(amount: float) -> int:
    """Mod amount quantized to 2**-12."""
    return int(np.rint(float(amount) * (1 << 12)))


def _exp_scale_bits(smax_bits):
    """Bits of the f32 2**(29 - floor(log2(smax))), from the exponent bits
    of ``smax`` alone (an exact scale; integer ops)."""
    e = (smax_bits >> 23) - 127                   # unbiased exponent
    return ((29 - e) + 127) << 23


def mod_speed_fix(placed: torch.Tensor, win: int,
                  a_q12: int) -> torch.Tensor:
    """Device chain: placed f32 [n] -> int32 speed in 2**-22 units, in
    [0.25, 4].  Box sum of exact x**2 (the /win of a moving average
    cancels in the normalization), exponent-normalize so the max lands in
    [2**29, 2**30), a two-stage integer division for a 30-bit u = s/smax,
    a 15-bit integer sqrt, speed = 1 + a*env saturated in int32.  The max
    and its scale stay on the device."""
    placed = placed.to(torch.float32)
    n = placed.shape[0]
    win = max(1, min(int(win), n))
    s = _box_sums_direct(exact_sq(placed), n, win, torch)
    s = torch.clamp_min(s, 0.0)                   # cancellation guard
    smax = torch.clamp_min(s.max(), 2.0 ** -40)
    scale = _exp_scale_bits(smax.view(torch.int32)).view(torch.float32)
    s_q = (s * scale).to(torch.int32)             # exact scale + trunc
    smax_q = (smax * scale).to(torch.int32)       # in [2**29, 2**30)
    d = torch.clamp_min(smax_q >> _ENV_BITS, 1)
    # two-stage long division: the full 30-bit quotient u = s/smax
    q1 = torch.div(s_q, d, rounding_mode="floor")
    r1 = s_q - q1 * d
    q2 = torch.div(r1 << _ENV_BITS, d, rounding_mode="floor")
    u30 = torch.clamp_max((q1 << _ENV_BITS) + q2, 1 << 30)
    e15 = isqrt30(u30)                            # floor(sqrt(u) * 2**15)
    # a*env in 2**-22 units: the one rounded product, feeding a cast
    t = e15.to(torch.float32) * float(a_q12) * 2.0 ** -5
    t = torch.clamp(t, -float(1 << 26), float(1 << 26))
    inc = _POS_ONE + t.to(torch.int32)
    return torch.clamp(inc, _SPEED_LO, _SPEED_HI)


def mod_speed_fix_np(placed, win: int, a_q12: int):
    placed = np.asarray(placed, np.float32)
    n = placed.shape[0]
    win = max(1, min(int(win), n))
    x2 = exact_sq_np(placed)
    s = _box_sums_direct(x2, n, win, np)
    s = np.maximum(s, np.float32(0.0))
    smax = np.maximum(np.max(s) if n else np.float32(0.0),
                      np.float32(2.0 ** -40))
    sb = int(np.float32(smax).view(np.int32))
    scale = np.int32(_exp_scale_bits(sb)).view(np.float32)
    s_q = (s * scale).astype(np.int32)
    smax_q = np.int32(np.float32(smax * scale))
    d = np.int32(max(int(smax_q) >> _ENV_BITS, 1))
    q1 = s_q // d
    r1 = s_q - q1 * d
    q2 = (r1 << _ENV_BITS) // d
    u30 = np.minimum((q1 << _ENV_BITS) + q2, np.int32(1 << 30))
    e15 = isqrt30_np(u30)
    t = np.float32(np.float32(np.float32(float(a_q12))
                              * e15.astype(np.float32))
                   * np.float32(2.0 ** -5))
    t = np.clip(t, np.float32(-(1 << 26)), np.float32(1 << 26))
    inc = np.int32(_POS_ONE) + t.astype(np.int32)
    return np.clip(inc, np.int32(_SPEED_LO),
                   np.int32(_SPEED_HI)).astype(np.int32)


def speed_q_from_fix_np(inc):
    """Exact f32 view of the fixed-point speeds (2**-22 units): what the
    host placement accumulates in f64."""
    return (np.asarray(inc, np.int32).astype(np.float32)
            * np.float32(1.0 / (1 << fixq.POS_FRAC_BITS)))

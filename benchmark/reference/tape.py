"""Plain NumPy reference of a TapeTUC render (tape-tuc-main/
Tape_TUC_23-11-25_auto-slice_n_record.py: ``provide_samples`` :767-911,
wow/flutter :794-798 and :884-891, the splice envelope :83-88, the PCM_16
export :342), one visit at a time.

It takes a request's ``TapeParams`` fields (a plain dict) and the mono
tape, and works out everything itself: the sections from the markers, the
length of one duration-preserving pass, the wow/flutter curve, each
visit's read positions (a visit is one pass through a section between
crossings), the forward or reversed read inside a section, the linear
read, the anti-click dip within ``boundary_smooth_len`` of a boundary, the
splice envelope on a crossing, the clip and PCM16.  It imports nothing of
the program.  The audio math runs in float64.

It keeps the suite's conventions that decide discrete events, each a
departure from the app, which keeps float positions and speeds:

- positions are 2**-22 fixed point (an integer sample and a fraction),
  each sample's increment ``speed * mod`` rounded to the grid once, from
  its f32 product;
- section speeds are f32 values rounded to the same grid;
- the wow/flutter curve is the f32 one (``numerics``): each LFO's phase
  reduced exactly in integers (0.4 Hz and 7 Hz as the ratios 2/5 and
  7/1 of the rate), its sine the cycle-domain polynomial rounded to a
  12-bit significand, the depths rounded to 12 bits, the sum clipped to
  [0.1, 3] and rounded to the grid.

Float64 positions would drift from these by fractions of a sample over
millions of samples and move a splice trigger: a different answer, not a
rounding.  Inertia (a one-pole speed glide) is not modelled: a request
with it on is refused.

``q`` is the precision hook, applied to the tape, the fractions, the
read, the two gains and their product: ``exact`` for the reference,
``numerics.bf16`` for the control.
"""
from __future__ import annotations

import math

import numpy as np

from .numerics import exact, pcm16, round_sig12, sin_cycles

FRAC_BITS = 22
ONE = 1 << FRAC_BITS
MASK = ONE - 1
_F32_ONE = np.float32(ONE)
_INV_ONE = np.float32(1.0 / ONE)


def sections(markers, n: int):
    """Section starts [0] + markers, ends markers + [n] (Tape…py:491-501)."""
    m = sorted(int(x) for x in markers)
    return np.asarray([0] + m, np.int64), np.asarray(m + [int(n)], np.int64)


def boundaries(markers, n: int):
    """The sample indices the dip and the splice watch: 0, the markers and
    the tape's last sample."""
    return np.asarray(sorted({0, int(n) - 1, *(int(x) for x in markers)}),
                      np.int64)


def _speeds(p: dict, count: int) -> list[float]:
    v = p["section_speeds"]
    return [abs(float(v[i])) if i < len(v) else 1.0 for i in range(count)]


def frames(p: dict, n: int) -> int:
    """One full pass over the tape at the section speeds, wow/flutter
    left out: round(sum of length / speed)."""
    starts, ends = sections(p["markers"], n)
    v = p["section_speeds"]
    total = 0.0
    for i in range(len(starts)):
        speed = v[i] if i < len(v) and v[i] > 0 else 1.0
        total += max(1, int(ends[i] - starts[i])) / speed
    return int(round(total))


def _grid(x):
    """f32 values rounded to the 2**-22 grid, staying f32."""
    x = np.asarray(x, np.float32)
    return (np.rint(x * _F32_ONE) * _INV_ONE).astype(np.float32)


def _phase(T: int, num: int, den: int, sr: int):
    """An LFO of num/den Hz at rate sr, in f32 cycles at samples 0..T-1:
    the integer residue of i * num modulo den * sr, scaled once."""
    m = den * sr
    g = math.gcd(num, m)
    num, m = num // g, m // g
    r = ((np.arange(T, dtype=np.int64) % m) * num) % m
    return r.astype(np.float32) * np.float32(1.0 / m)


def wow_flutter(T: int, sr: int, tape_age: float):
    """The f32 speed modulation of samples 0..T-1: 1 + wow + flutter,
    clipped, on the position grid."""
    a = max(0.0, min(1.0, tape_age / 100.0))
    wd = round_sig12(np.float32(0.001 + 0.006 * a))
    fd = round_sig12(np.float32(0.0005 + 0.003 * a))
    sw = round_sig12(sin_cycles(_phase(T, 2, 5, sr)))
    sf = round_sig12(sin_cycles(_phase(T, 7, 1, sr)))
    mod = np.float32(1.0) + wd * sw + fd * sf
    return _grid(np.clip(mod, np.float32(0.1), np.float32(3.0)))


def positions(n: int, starts, ends, speeds_q, mod):
    """Each sample's (whole, frac, section), visit by visit from the
    tape's start: a visit reads its section at one speed until the
    position reaches the section's end, then the next visit starts where
    the position wrapped to."""
    T = len(mod)
    whole = np.empty(T, np.int64)
    frac = np.empty(T, np.int64)
    sec = np.empty(T, np.int64)
    w = f = i = 0
    while i < T:
        w %= n
        s = min(max(int(np.searchsorted(starts, w, side="right")) - 1, 0),
                len(starts) - 1)
        end = max(int(ends[s]), int(starts[s]) + 1)
        left = (end - w) * ONE - f       # grid steps to the section's end
        spd = speeds_q[s]
        # about the visit's length, then more if it runs on
        step = int(left / (ONE * float(spd) * 0.99)) + 1024
        acc = 0
        while i < T:
            k = min(step, T - i)
            inc = np.rint((spd * mod[i:i + k]) * _F32_ONE).astype(np.int64)
            csum = acc + np.cumsum(inc)
            hit = int(np.searchsorted(csum, left, side="left"))
            m = min(hit + 1, k)
            pos = f + csum[:m] - inc[:m]          # before each advance
            whole[i:i + m] = w + (pos >> FRAC_BITS)
            frac[i:i + m] = pos & MASK
            sec[i:i + m] = s
            i += m
            if hit < k:                           # crossed: a new visit
                pos = f + int(csum[hit])
                w, f = w + (pos >> FRAC_BITS), pos & MASK
                break
            acc = int(csum[-1])
    return whole, frac, sec


def render(p: dict, tape, q=exact) -> np.ndarray:
    """The int16 PCM of one duration-preserving pass of ``p`` (a
    ``TapeParams`` dict) over ``tape`` (mono)."""
    if p.get("inertia_enabled") and p.get("inertia_amount", 0) > 0:
        raise NotImplementedError("the reference has no inertia")
    x = q(np.asarray(tape, np.float32).astype(np.float64))
    n = len(x)
    starts, ends = sections(p["markers"], n)
    nsec = len(starts)
    speeds_q = _grid(np.asarray(_speeds(p, nsec), np.float32))
    rev_p = p["section_reverse"]
    rev = np.asarray([bool(rev_p[i]) if i < len(rev_p) else False
                      for i in range(nsec)])
    T = frames(p, n)
    whole, frac, sec = positions(
        n, starts, ends, speeds_q,
        wow_flutter(T, int(p["sample_rate"]), float(p["tape_age"])))

    # the read index (Tape…py:823-836): forward, or mirrored in the
    # section, where int() truncates toward zero at the tape's first sample
    s0 = starts[sec]
    e0 = np.maximum(ends[sec], s0 + 1)
    local = (whole - s0) % (e0 - s0)
    a = e0 - 1 - local
    has = frac > 0
    r = rev[sec]
    idx0 = np.where(r, np.where(has, np.where(a == 0, 0, a - 1), a),
                    s0 + local)
    fr = np.where(r, np.where(has, np.where(a == 0, -frac, ONE - frac), 0),
                  frac) / ONE
    idx0 = np.clip(idx0, 0, n - 1)
    fr = q(fr)
    s = q((1.0 - fr) * x[idx0] + fr * x[np.minimum(idx0 + 1, n - 1)])

    bnd = boundaries(p["markers"], n)
    gain = np.ones(T)
    smooth = int(p["boundary_smooth_len"])
    if p["anticlick_enabled"] and smooth > 0:
        # the dip within smooth samples of a boundary (Tape…py:838-849)
        j = np.searchsorted(bnd, idx0)
        lo = np.abs(idx0 - bnd[np.maximum(j - 1, 0)])
        hi = np.abs(bnd[np.minimum(j, len(bnd) - 1)] - idx0)
        dmin = np.minimum(np.where(j > 0, lo, 2 ** 30),
                          np.where(j < len(bnd), hi, 2 ** 30))
        amt = max(0.0, min(1.0, p["anticlick_amount"] / 100.0))
        g = np.maximum(0.0, 1.0 - (0.3 + 0.5 * amt)
                       * (smooth - dmin) / smooth)
        gain = q(np.where(dmin < smooth, g, 1.0))
    if p["enable_splice_fx"]:
        # the envelope from a read that lands on a boundary, one at a
        # time: a hit inside a running envelope starts none (:851-858)
        E = int(p["splice_env_len"])
        env = q(1.0 + 0.8 * np.exp(-5.0 * np.linspace(0.0, 1.0, E)))
        splice = np.ones(T)
        end = 0
        for t in np.flatnonzero(np.isin(idx0, bnd)):
            if t >= end:
                k = min(E, T - t)
                splice[t:t + k] = env[:k]
                end = t + E
        gain = q(gain * q(splice))
    return pcm16(np.clip(q(s * gain), -1.0, 1.0))

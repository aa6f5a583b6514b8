"""Plain NumPy reference of a Pattern Lab render (pattern lab
0.1/app/patterns.py, app/events.py, app/renderer.py:8-139, app/synth_fm.py
and app/synth_psg.py), note by note.

It takes the render settings (a plain dict of ``RenderConfig``'s fields)
and the names of the builtin generators, and works out everything itself:
the generators' events, the time ops, the note clamps, each FM or PSG
note, the mix, the tanh master bus and PCM16.  It imports nothing of the
program.  The phases and the bit quantizers follow the suite's f32
semantics (``numerics``), so a note's DAC steps land where a correct
renderer puts them; the one-pole lowpasses run in float64.

``q`` is the precision hook, applied to each note's stages and the mix:
``exact`` for the reference, ``numerics.bf16`` for the control.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
from scipy.signal import lfilter

from .numerics import (exact, exp2_precise, frac_signed, pcm16,
                       quantize_to_bits, round_sig12, sin_cycles,
                       sin_cycles_precise)

DAC_BITS = 14
POST_LP_HZ = 12000.0
A4 = 440.0
SCALES = {'major': [0, 2, 4, 5, 7, 9, 11], 'minor': [0, 2, 3, 5, 7, 8, 10],
          'dorian': [0, 2, 3, 5, 7, 9, 10], 'phrygian': [0, 1, 3, 5, 7, 8, 10],
          'glass': [0, 2, 5, 7, 9]}


@dataclass
class Note:
    t0: float
    dur: float
    midi: float
    vel: float = 1.0
    chan: int = 0
    engine: str = "FM"


# --- music helpers (app/music.py)

def midi_to_hz(m):
    return A4 * np.exp2((np.asarray(m, np.float64) - 69.0) / 12.0)


def pythagorean_ratio(steps):
    ratio = 1.5 ** steps
    while ratio >= 2.0:
        ratio *= 0.5
    while ratio < 1.0:
        ratio *= 2.0
    return ratio


def primes_upto(n):
    return [p for p in range(2, n + 1)
            if all(p % d for d in range(2, int(p ** 0.5) + 1))]


def fibonacci(n):
    out, a, b = [], 1, 1
    for _ in range(max(0, n)):
        out.append(a)
        a, b = b, a + b
    return out


def euclidean_rhythm(steps, pulses, rotate=0):
    """Bjorklund's gate pattern (app/music.py:45-86)."""
    steps = int(max(1, steps))
    pulses = int(np.clip(pulses, 0, steps))
    if pulses in (0, steps):
        pat = np.full(steps, 1 if pulses else 0, np.int32)
    else:
        pattern, counts, rems = [], [], [pulses]
        divisor, level = steps - pulses, 0
        while True:
            counts.append(divisor // rems[level])
            rems.append(divisor % rems[level])
            divisor = rems[level]
            level += 1
            if rems[level] <= 1:
                break
        counts.append(divisor)

        def build(lv):
            if lv == -1:
                pattern.append(0)
            elif lv == -2:
                pattern.append(1)
            else:
                for _ in range(counts[lv]):
                    build(lv - 1)
                if rems[lv] != 0:
                    build(lv - 2)
        build(level)
        pat = np.array(pattern[:steps], np.int32)
    return np.roll(pat, int(rotate) % steps) if rotate else pat


# --- the builtin generators (app/patterns.py:26-181) at their defaults

def _sec(cfg, beats):
    return float(beats) * 60.0 / float(cfg["bpm"])


def _rng(cfg):
    return np.random.default_rng(int(cfg["seed"]) & 0xFFFFFFFF)


def glass_cells(cfg, root=60, cell_len=8, voices=2, drift=0.0):
    rng, sc = _rng(cfg), SCALES['glass']
    degrees = ([0, 1, 2, 3, 2, 1, 4, 3] * 2)[:cell_len]
    step = 4.0 / cell_len
    bars = int(max(1, cfg["seconds"] / _sec(cfg, 4.0)))
    grow = list(range(2, cell_len + 1)) + list(range(cell_len - 1, 1, -1))
    ev, beat = [], 0.0
    for b in range(bars):
        for v in range(voices):
            for i in range(grow[b % len(grow)]):
                deg = degrees[i]
                midi = (root + sc[deg % len(sc)] + 12 * (deg // len(sc))
                        + v * 12)
                midi += drift * float(rng.normal(0, 0.02))
                ev.append(Note(_sec(cfg, beat + i * step),
                               _sec(cfg, step * 0.95), midi,
                               0.9 if i % 4 == 0 else 0.65, v % 6, 'FM'))
        beat += 4.0
    return ev


def fibonacci_gate(cfg, root=57, steps=64, pulses=13):
    rng, sc = _rng(cfg), SCALES['minor']
    fib = fibonacci(max(16, steps // 2))
    gate = euclidean_rhythm(steps, pulses, rotate=int(rng.integers(0, steps)))
    ev, beat = [], 0.0
    for i in range(steps):
        if gate[i] == 1:
            dur_mul = 1.0 + (fib[i % len(fib)] % 5) * 0.25
            ev.append(Note(
                _sec(cfg, beat), _sec(cfg, 0.25 * dur_mul * 0.92),
                root + sc[fib[i % len(fib)] % len(sc)]
                + 12 * (fib[(i + 3) % len(fib)] % 3),
                0.7 + 0.25 * float(i % 8 == 0), i % 6, 'FM'))
        beat += 0.25
        if _sec(cfg, beat) > cfg["seconds"]:
            break
    primes, beat = set(primes_upto(steps * 2)), 0.0
    for i in range(steps):
        if i in primes and i % 2 == 1:
            ev.append(Note(_sec(cfg, beat), _sec(cfg, 0.25 * 0.35), 48, 0.5,
                           0, 'PSG'))
        beat += 0.25
        if _sec(cfg, beat) > cfg["seconds"]:
            break
    return ev


def prime_phase(cfg, root=60):
    sc = SCALES['dorian']
    p1, p2 = primes_upto(50)[8], primes_upto(50)[10]
    ev, beat = [], 0.0
    for i in range(int(cfg["seconds"] / _sec(cfg, 0.25)) + 1):
        a, b = i % p1, i % p2
        ev.append(Note(_sec(cfg, beat), _sec(cfg, 0.225),
                       root + sc[a % len(sc)] + 12 * (a // len(sc)), 0.75, 0))
        ev.append(Note(_sec(cfg, beat + 0.125), _sec(cfg, 0.225),
                       root + 12 + sc[b % len(sc)] + 12 * (b // len(sc)), 0.65,
                       1))
        if i % 3 == 0:
            ev.append(Note(_sec(cfg, beat), _sec(cfg, 0.05), 60, 0.35, 0,
                           'PSG'))
        beat += 0.25
        if _sec(cfg, beat) > cfg["seconds"]:
            break
    return ev


def pythagorean_canon(cfg, base=52):
    fifths = [0, 1, 2, 3, 2, 1, 4, 5, 4, 3, 2, 1]
    ev, beat = [], 0.0
    for i in range(int(cfg["seconds"] / _sec(cfg, 0.5)) + 1):
        off = 12.0 * np.log2(pythagorean_ratio(fifths[i % len(fifths)]))
        for v in range(3):
            ev.append(Note(_sec(cfg, beat + v * 1.0), _sec(cfg, 0.9),
                           float(base + off + 12 * v), 0.55, v))
        if i % 4 == 0:
            ev.append(Note(_sec(cfg, beat), _sec(cfg, 0.475), base - 12, 0.5,
                           1, 'PSG'))
        beat += 0.5
        if _sec(cfg, beat) > cfg["seconds"]:
            break
    return ev


GENERATORS = {"Glass Cells": glass_cells, "Fibonacci Gate": fibonacci_gate,
              "Prime Phase": prime_phase,
              "Pythagorean Canon": pythagorean_canon}


# --- channels (app/renderer.py:45-71, synth_fm.py:38-60, synth_psg.py)

def _op(ratio, level, index, a, d, s, r):
    return dict(ratio=ratio, level=level, index=index, a=a, d=d, s=s, r=r)


_DEF_OPS = (_op(1.0, 0.9, 0.0, 0.01, 0.3, 0.7, 0.15),
            _op(2.0, 0.7, 2.0, 0.01, 0.25, 0.5, 0.15),
            _op(3.0, 0.6, 2.0, 0.01, 0.2, 0.4, 0.15),
            _op(1.0, 0.5, 2.0, 0.005, 0.15, 0.35, 0.2))
FM_CHANNELS = [
    dict(alg=1, fb=0.12, lfo_hz=5.0, lfo_depth=0.0, ops=_DEF_OPS),
    dict(alg=2, fb=0.05, lfo_hz=6.0, lfo_depth=0.1, ops=_DEF_OPS),
    dict(alg=1, fb=0.18, lfo_hz=4.5, lfo_depth=0.0, ops=_DEF_OPS),
    dict(alg=3, fb=0.0, lfo_hz=5.0, lfo_depth=0.0, ops=(
        _op(1.0, 0.8, 0.0, 0.01, 0.2, 0.8, 0.2),
        _op(2.0, 0.45, 0.0, 0.01, 0.2, 0.8, 0.2),
        _op(4.0, 0.25, 0.0, 0.01, 0.2, 0.8, 0.2),
        _op(8.0, 0.15, 0.0, 0.01, 0.2, 0.8, 0.2))),
    dict(alg=2, fb=0.2, lfo_hz=7.0, lfo_depth=0.0, ops=_DEF_OPS),
    dict(alg=1, fb=0.0, lfo_hz=5.0, lfo_depth=0.0, ops=(
        _op(0.5, 1.0, 0.0, 0.01, 0.35, 0.65, 0.2),
        _op(1.0, 0.8, 2.5, 0.01, 0.2, 0.45, 0.18),
        _op(2.0, 0.7, 2.2, 0.005, 0.15, 0.35, 0.18),
        _op(3.0, 0.6, 1.7, 0.003, 0.12, 0.25, 0.22))),
]
PSG_CHANNELS = [dict(noise=False, duty=0.5, a=0.001, d=0.08, s=0.5, r=0.08,
                     bits=10),
                dict(noise=False, duty=0.25, a=0.001, d=0.12, s=0.45, r=0.12,
                     bits=10),
                dict(noise=False, duty=0.75, a=0.001, d=0.1, s=0.35, r=0.1,
                     bits=10),
                dict(noise=True, duty=0.5, a=0.001, d=0.05, s=0.0, r=0.05,
                     bits=8)]


# --- time ops and clamps (app/renderer.py:8-31, :83-106)

def apply_time_ops(events, cfg):
    rng = _rng(cfg)
    swing = float(np.clip(cfg["swing"], 0.0, 0.5))
    out = []
    for e in events:
        t0 = float(e.t0) * float(cfg["time_stretch"])
        dur = float(e.dur) * float(cfg["time_stretch"])
        if swing > 0.0 and cfg["bpm"] > 0:
            s16 = 60.0 / float(cfg["bpm"]) / 4.0
            if s16 > 1e-6 and int(round(t0 / s16)) % 2 == 1:
                t0 += swing * s16
        if cfg["micro_jitter"] > 0.0:
            t0 = max(0.0, t0 + float(rng.normal(0.0, cfg["micro_jitter"])))
        out.append(Note(t0, max(1e-4, dur), float(e.midi), float(e.vel),
                        int(e.chan), e.engine))
    return out


def note_batch(events, cfg):
    """Kept notes as (k, start, n, midi f32, vel f32, chan, is_psg)."""
    sr = int(cfg["sample_rate"])
    n_total = int(max(1, round(float(cfg["seconds"]) * sr)))
    notes = []
    for k, e in enumerate(events):
        start = max(np.round(e.t0 * sr), 0.0)
        dur = min(e.dur, max(0.0, (n_total - start) / float(sr)))
        if start < n_total and dur > 1e-4:
            psg = e.engine.upper() == "PSG"
            notes.append((k, int(start), int(max(1.0, np.round(dur * sr))),
                          np.float32(e.midi), np.float32(e.vel),
                          int(e.chan) % (4 if psg else 6), psg))
    return n_total, notes


# --- voices

def adsr(n, sr, a, d, s, r, min_a, min_r):
    """The ADSR with the stage minimums, ramps by f32 reciprocal
    multiplies (app/synth_fm.py:64-99, synth_psg.py:48-77)."""
    A = int(sr * max(min_a, float(a)))
    D = int(sr * max(1e-4, float(d)))
    R = int(sr * max(min_r, float(r)))
    f32, one, s32 = np.float32, np.float32(1.0), np.float32(s)
    n_a = min(n, A)
    n_d = min(max(0, n - n_a), D)
    rem2 = max(0, n - n_a - n_d)
    n_r = min(rem2, R)
    n_s = rem2 - n_r
    inv_na, inv_nd = one / f32(max(1, n_a)), one / f32(max(1, n_d))
    inv_dr = one / f32(max(1, n_r - 1))
    last_d = f32(one + (s32 - one) * f32(f32(n_d - 1) * inv_nd))
    la = f32(f32(n_a - 1) * inv_na)
    startv = s32 if n_s > 0 else (last_d if n_d > 0 else (
        f32(la * la) if n_a > 0 else s32))
    i = np.arange(n)
    fi = i.astype(np.float32)
    ra = fi * inv_na
    val_d = one + (s32 - one) * ((i - n_a).astype(np.float32) * inv_nd)
    rs = n - n_r
    rr = (one - (i - rs).astype(np.float32) * inv_dr) if n_r > 1 \
        else np.ones(n, np.float32)
    return np.where(i < n_a, ra * ra, np.where(
        i < n_a + n_d, val_d, np.where(i < rs, s32, startv * (rr * rr)))) \
        .astype(np.float32)


def micro_fade(x, sr, fade_ms=12.0):
    x = np.asarray(x, np.float32).copy()
    n = x.size
    if n <= 16:
        return x
    f = int(max(8, min(int(round(sr * fade_ms / 1000.0)), n // 3)))
    ramp = (0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, f, dtype=np.float32))
            ).astype(np.float32)
    x[:f] *= ramp
    x[-f:] *= ramp[::-1]
    x[0] = x[-1] = 0.0
    return x


def one_pole(x, sr, cutoff, min_cutoff=20.0):
    a = np.exp(-2.0 * np.pi * max(min_cutoff, cutoff) / float(sr))
    return lfilter([1.0 - a], [1.0, -a], np.asarray(x, np.float64))


def fm_note(sr, n, midi, vel, ch, q=exact):
    f32 = np.float32
    t = np.arange(n, dtype=np.float32) * f32(1.0 / float(sr))
    vib = None
    if ch["lfo_depth"] > 0.0:
        v = sin_cycles_precise(f32(ch["lfo_hz"]) * t)
        vib = exp2_precise((f32(ch["lfo_depth"]) * v) * f32(1.0 / 12.0))
    base = midi_to_hz(midi)

    def op(k, pm):
        o = ch["ops"][k]
        c = f32(base * o["ratio"]) * t
        if vib is not None:
            c = c * vib
        r0 = frac_signed(c)
        if pm is not None:
            r0 = r0 + pm
        env = adsr(n, sr, o["a"], o["d"], o["s"], o["r"], 0.004, 0.008)
        return q((sin_cycles(r0) * env * f32(o["level"])).astype(np.float32))

    def pm(k, m):
        return round_sig12(f32(ch["ops"][k]["index"] / (2.0 * np.pi))) \
            * round_sig12(m)

    def fb(o4):
        if ch["fb"] <= 0:
            return o4
        prev = np.concatenate([[0.0], o4[:-1]]).astype(np.float32)
        return o4 + round_sig12(f32(ch["fb"])) * round_sig12(prev)

    if ch["alg"] == 1:
        o3 = op(2, pm(2, fb(op(3, None))))
        y = op(0, pm(0, op(1, pm(1, o3))))
    elif ch["alg"] == 2:
        o3 = op(2, pm(2, fb(op(3, None))))
        y = (o3 + op(0, pm(0, op(1, None)))) * f32(0.6)
    else:
        y = (op(0, None) + op(1, None) + op(2, None) + op(3, None)) * f32(0.25)
    y = quantize_to_bits((y * f32(vel)).astype(np.float32), DAC_BITS)
    y = micro_fade(q(y), sr)
    return q(one_pole(one_pole(y, sr, POST_LP_HZ).astype(np.float32), sr,
                      14000.0))


@lru_cache(maxsize=1)
def _lfsr_orbit():
    """The 15-bit LFSR's states along its one cycle of non-zero states,
    and each state's place on it."""
    orbit, s = [], 1
    while True:
        orbit.append(s)
        s = (s >> 1) | (((s ^ (s >> 1)) & 1) << 14)
        if s == 1:
            break
    orbit = np.asarray(orbit, np.int64)
    place = np.zeros(1 << 15, np.int64)
    place[orbit] = np.arange(orbit.size)
    return orbit, place


def lfsr_noise(n, seed):
    """+-1 from the low bit of each next state (app/synth_psg.py:89-97)."""
    s0 = int(seed) & 0x7FFF
    if s0 == 0:
        return -np.ones(n, np.float32)
    orbit, place = _lfsr_orbit()
    states = orbit[(place[s0] + 1 + np.arange(n)) % orbit.size]
    return np.where(states & 1, 1.0, -1.0).astype(np.float32)


def psg_note(sr, n, midi, vel, ch, seed, q=exact):
    env = adsr(n, sr, ch["a"], ch["d"], ch["s"], ch["r"], 0.003, 0.006)
    if ch["noise"]:
        sig = lfsr_noise(n, seed)
    else:
        t = np.arange(n, dtype=np.float32) * np.float32(1.0 / float(sr))
        prod = (t * np.float32(midi_to_hz(midi))).astype(np.float32)
        duty = np.float32(np.clip(ch["duty"], 0.05, 0.95))
        sig = np.where(prod - np.floor(prod) < duty, 1.0, -1.0) \
            .astype(np.float32)
    y = quantize_to_bits(q((sig * env * np.float32(vel)).astype(np.float32)),
                         int(ch["bits"]))
    return q(one_pole(micro_fade(q(y), sr), sr, 12000.0, min_cutoff=50.0))


def render(cfg: dict, generators, q=exact) -> np.ndarray:
    """The four generators' events through the time ops and the voices,
    mixed, tanh * master_gain; int16 PCM [n_total]."""
    events = []
    for name in generators:
        events.extend(GENERATORS[name](cfg))
    sr = int(cfg["sample_rate"])
    n_total, notes = note_batch(apply_time_ops(events, cfg), cfg)
    y = np.zeros(n_total)
    for k, start, n, midi, vel, chan, psg in notes:
        note = (psg_note(sr, n, midi, vel, PSG_CHANNELS[chan],
                         int(cfg["seed"]) + k, q) if psg
                else fm_note(sr, n, midi, vel, FM_CHANNELS[chan], q))
        seg = min(n, n_total - start)
        y[start:start + seg] += note[:seg]
    return pcm16(q(np.tanh(q(y)) * float(np.float32(cfg["master_gain"]))))

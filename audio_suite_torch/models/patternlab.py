"""Pattern Lab engine — port of audio_suite_tpu/models/patternlab.py:
algorithmic patterns through an FM + PSG voice bank.

- host: the pattern generators (emit NoteEvents), the channel presets and
  their tables, and ``MegaDriveInspiredSynth.prepare``, which clamps and
  buckets the note batch and packs every per-note argument into four
  matrices (one f32 and one int32 pack per engine family) — NumPy,
  identical to the JAX package's arrays;
- device: ``_render_dispatch``, a loop over the static bucket spec: each
  bucket (notes of one length bucket L, one FM algorithm and one vibrato
  flag, or PSG notes of one L) renders as a batch of notes [count, L]
  (``ops/synth.py``), is masked to the render's end and overlap-added in
  bucket order into a margin buffer (``ops/overlap_add.py``: the CUDA
  kernel on the card); then the tanh master bus and optionally PCM16.

Entry points run on ``device="cuda"`` unless the caller passes another
device.
"""
from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..events.notes import (NoteEvent, RenderConfig, apply_time_ops,
                            prepare_note_batch)
from ..ops import envelopes, overlap_add
from ..ops import synth as synth_ops
from ..utils import music
from ..utils.profiling import span

YM2612_DAC_BITS = 14     # app/constants.py
POST_LP_HZ = 12000.0

SCALES = {
    'major': [0, 2, 4, 5, 7, 9, 11],
    'minor': [0, 2, 3, 5, 7, 8, 10],
    'dorian': [0, 2, 3, 5, 7, 9, 10],
    'phrygian': [0, 1, 3, 5, 7, 8, 10],
    'glass': [0, 2, 5, 7, 9],
}

# ----------------------------------------------------------------------------
# Channel presets (app/renderer.py:45-71, app/synth_fm.py:38-60,
# app/synth_psg.py:36-45)
# ----------------------------------------------------------------------------

@dataclass
class OpParams:
    ratio: float = 1.0
    detune_cents: float = 0.0
    level: float = 1.0
    index: float = 1.0
    a: float = 0.01
    d: float = 0.2
    s: float = 0.6
    r: float = 0.2


@dataclass
class FMVoiceParams:
    algorithm: int = 1
    feedback: float = 0.0
    lfo_hz: float = 5.0
    lfo_depth: float = 0.0
    ops: tuple = (
        OpParams(ratio=1.0, level=0.9, index=0.0, a=0.01, d=0.3, s=0.7, r=0.15),
        OpParams(ratio=2.0, level=0.7, index=2.0, a=0.01, d=0.25, s=0.5, r=0.15),
        OpParams(ratio=3.0, level=0.6, index=2.0, a=0.01, d=0.2, s=0.4, r=0.15),
        OpParams(ratio=1.0, level=0.5, index=2.0, a=0.005, d=0.15, s=0.35, r=0.2),
    )


@dataclass
class PSGParams:
    noise: bool = False
    duty: float = 0.5
    a: float = 0.001
    d: float = 0.1
    s: float = 0.6
    r: float = 0.1
    bits: int = 12


def default_fm_channels() -> list[FMVoiceParams]:
    return [
        FMVoiceParams(algorithm=1, feedback=0.12, lfo_hz=5.0, lfo_depth=0.0),
        FMVoiceParams(algorithm=2, feedback=0.05, lfo_hz=6.0, lfo_depth=0.1),
        FMVoiceParams(algorithm=1, feedback=0.18, lfo_hz=4.5, lfo_depth=0.0),
        FMVoiceParams(algorithm=3, feedback=0.0, lfo_hz=5.0, lfo_depth=0.0,
                      ops=(
                          OpParams(ratio=1.0, level=0.8, index=0.0, a=0.01, d=0.2, s=0.8, r=0.2),
                          OpParams(ratio=2.0, level=0.45, index=0.0, a=0.01, d=0.2, s=0.8, r=0.2),
                          OpParams(ratio=4.0, level=0.25, index=0.0, a=0.01, d=0.2, s=0.8, r=0.2),
                          OpParams(ratio=8.0, level=0.15, index=0.0, a=0.01, d=0.2, s=0.8, r=0.2),
                      )),
        FMVoiceParams(algorithm=2, feedback=0.2, lfo_hz=7.0, lfo_depth=0.0),
        FMVoiceParams(algorithm=1, feedback=0.0, lfo_hz=5.0, lfo_depth=0.0,
                      ops=(
                          OpParams(ratio=0.5, level=1.0, index=0.0, a=0.01, d=0.35, s=0.65, r=0.2),
                          OpParams(ratio=1.0, level=0.8, index=2.5, a=0.01, d=0.2, s=0.45, r=0.18),
                          OpParams(ratio=2.0, level=0.7, index=2.2, a=0.005, d=0.15, s=0.35, r=0.18),
                          OpParams(ratio=3.0, level=0.6, index=1.7, a=0.003, d=0.12, s=0.25, r=0.22),
                      )),
    ]


def default_psg_channels() -> list[PSGParams]:
    return [
        PSGParams(noise=False, duty=0.5, a=0.001, d=0.08, s=0.5, r=0.08, bits=10),
        PSGParams(noise=False, duty=0.25, a=0.001, d=0.12, s=0.45, r=0.12, bits=10),
        PSGParams(noise=False, duty=0.75, a=0.001, d=0.1, s=0.35, r=0.1, bits=10),
        PSGParams(noise=True, duty=0.5, a=0.001, d=0.05, s=0.0, r=0.05, bits=8),
    ]


def _fm_channel_tables(channels: list[FMVoiceParams], sr: int) -> dict:
    """Per-channel arrays with the reference's stage minimums applied
    (synth_fm.py:64-68: a>=0.004, d>=1e-4, r>=0.008)."""
    C = len(channels)
    tab = {
        "level": np.zeros((C, 4), np.float32),
        "index_cyc": np.zeros((C, 4), np.float32),   # mod index / 2*pi
        "A": np.zeros((C, 4), np.int32),
        "D": np.zeros((C, 4), np.int32),
        "R": np.zeros((C, 4), np.int32),
        "s": np.zeros((C, 4), np.float32),
        "algorithm": np.zeros(C, np.int32),
        "feedback": np.zeros(C, np.float32),
        "lfo_hz": np.zeros(C, np.float32),
        "lfo_depth": np.zeros(C, np.float32),
        # host-only f64 factors of the per-note op frequencies
        "_ratio64": np.zeros((C, 4), np.float64),
        "_det64": np.zeros((C, 4), np.float64),
    }
    for c, p in enumerate(channels):
        tab["algorithm"][c] = p.algorithm
        tab["feedback"][c] = p.feedback
        tab["lfo_hz"][c] = p.lfo_hz
        tab["lfo_depth"][c] = p.lfo_depth
        for k, op in enumerate(p.ops):
            tab["_ratio64"][c, k] = op.ratio
            tab["_det64"][c, k] = 2.0 ** (op.detune_cents / 1200.0)
            tab["level"][c, k] = op.level
            tab["index_cyc"][c, k] = np.float32(op.index / (2.0 * np.pi))
            tab["A"][c, k] = int(sr * max(0.004, float(op.a)))
            tab["D"][c, k] = int(sr * max(1e-4, float(op.d)))
            tab["R"][c, k] = int(sr * max(0.008, float(op.r)))
            tab["s"][c, k] = op.s
    return tab


def fm_op_freqs(tab: dict, chans: np.ndarray, midis: np.ndarray) -> np.ndarray:
    """Per-note per-op frequencies in Hz, f32 (one f64->f32 cast of
    music.midi_to_hz's f64 math, vectorized)."""
    base = music.A4 * np.exp2((np.asarray(midis, np.float64) - 69.0) / 12.0)
    return (base[:, None] * tab["_ratio64"][chans]
            * tab["_det64"][chans]).astype(np.float32)


def _psg_channel_tables(channels: list[PSGParams], sr: int) -> dict:
    """synth_psg.py:52-55: a>=0.003, d>=1e-4, r>=0.006."""
    C = len(channels)
    tab = {
        "noise": np.zeros(C, np.bool_),
        "duty": np.zeros(C, np.float32),
        "A": np.zeros(C, np.int32),
        "D": np.zeros(C, np.int32),
        "R": np.zeros(C, np.int32),
        "s": np.zeros(C, np.float32),
        "levels_m1": np.zeros(C, np.float32),
        "inv_levels_m1": np.zeros(C, np.float32),
    }
    for c, p in enumerate(channels):
        tab["noise"][c] = p.noise
        tab["duty"][c] = float(np.clip(p.duty, 0.05, 0.95))
        tab["A"][c] = int(sr * max(0.003, float(p.a)))
        tab["D"][c] = int(sr * max(1e-4, float(p.d)))
        tab["R"][c] = int(sr * max(0.006, float(p.r)))
        tab["s"][c] = p.s
        lm1 = 2 ** (int(p.bits) - 1) - 1
        tab["levels_m1"][c] = float(lm1)
        tab["inv_levels_m1"][c] = float(np.float32(1.0 / float(lm1)))
    return tab


# ----------------------------------------------------------------------------
# Pattern generators (app/patterns.py) — host, emit events
# ----------------------------------------------------------------------------

def _rng(seed: int):
    return np.random.default_rng(int(seed) & 0xFFFFFFFF)


def _beat_to_sec(bpm: float, beats: float) -> float:
    return float(beats) * 60.0 / float(bpm)


def pattern_glass_cells(cfg: RenderConfig, root_midi: int = 60,
                        scale: str = 'glass', cell_len: int = 8,
                        voices: int = 2, drift: float = 0.0,
                        **_ignored) -> list[NoteEvent]:
    """app/patterns.py:26-61"""
    rng = _rng(cfg.seed)
    sc = SCALES.get(scale, SCALES['glass'])
    degrees = [0, 1, 2, 3, 2, 1, 4, 3]
    degrees = (degrees * ((cell_len + len(degrees) - 1) // len(degrees)))[:cell_len]

    events: list[NoteEvent] = []
    beat = 0.0
    bar_beats = 4.0
    step_beats = bar_beats / cell_len
    total_bars = int(max(1, cfg.seconds / _beat_to_sec(cfg.bpm, bar_beats)))
    grow = list(range(2, cell_len + 1)) + list(range(cell_len - 1, 1, -1))

    for b in range(total_bars):
        k = grow[b % len(grow)]
        for v in range(voices):
            chan = v % 6
            for i in range(k):
                deg = degrees[i]
                semis = sc[deg % len(sc)] + 12 * (deg // len(sc))
                midi = root_midi + semis + (v * 12)
                midi += drift * float(rng.normal(0, 0.02))
                t0 = _beat_to_sec(cfg.bpm, beat + i * step_beats)
                events.append(NoteEvent(t0=t0,
                                        dur=_beat_to_sec(cfg.bpm, step_beats * 0.95),
                                        midi=midi,
                                        vel=0.9 if (i % 4 == 0) else 0.65,
                                        chan=chan, engine='FM'))
        beat += bar_beats
    return events


def pattern_fibonacci(cfg: RenderConfig, root_midi: int = 57,
                      scale: str = 'minor', steps: int = 64,
                      pulses: int = 13, **_ignored) -> list[NoteEvent]:
    """app/patterns.py:64-113"""
    rng = _rng(cfg.seed)
    sc = SCALES.get(scale, SCALES['minor'])
    fib = music.fibonacci(max(16, steps // 2))
    gate = music.euclidean_rhythm(steps, pulses,
                                  rotate=int(rng.integers(0, steps)))

    events: list[NoteEvent] = []
    beat = 0.0
    base_step = 0.25
    for i in range(steps):
        dur_mul = 1.0 + (fib[i % len(fib)] % 5) * 0.25
        if gate[i] == 1:
            deg = fib[i % len(fib)] % len(sc)
            octv = (fib[(i + 3) % len(fib)] % 3)
            midi = root_midi + sc[deg] + 12 * octv
            chan = int(i % 6)
            vel = 0.7 + 0.25 * float((i % 8) == 0)
            events.append(NoteEvent(
                t0=_beat_to_sec(cfg.bpm, beat),
                dur=_beat_to_sec(cfg.bpm, base_step * dur_mul * 0.92),
                midi=midi, vel=vel, chan=chan, engine='FM'))
        beat += base_step
        if _beat_to_sec(cfg.bpm, beat) > cfg.seconds:
            break

    primes = set(music.primes_upto(steps * 2))
    beat = 0.0
    for i in range(steps):
        if i in primes and (i % 2 == 1):
            events.append(NoteEvent(
                t0=_beat_to_sec(cfg.bpm, beat),
                dur=_beat_to_sec(cfg.bpm, base_step * 0.35),
                midi=48, vel=0.5, chan=0, engine='PSG'))
        beat += base_step
        if _beat_to_sec(cfg.bpm, beat) > cfg.seconds:
            break
    return events


def pattern_prime_phase(cfg: RenderConfig, root_midi: int = 60,
                        scale: str = 'dorian', **_ignored) -> list[NoteEvent]:
    """app/patterns.py:116-147"""
    sc = SCALES.get(scale, SCALES['dorian'])
    primes = music.primes_upto(50)
    p1, p2 = primes[8], primes[10]

    events: list[NoteEvent] = []
    base_step = 0.25
    beat = 0.0
    for i in range(int(cfg.seconds / _beat_to_sec(cfg.bpm, base_step)) + 1):
        deg_a = (i % p1) % len(sc)
        midi_a = root_midi + sc[deg_a] + 12 * ((i % p1) // len(sc))
        events.append(NoteEvent(_beat_to_sec(cfg.bpm, beat),
                                _beat_to_sec(cfg.bpm, base_step * 0.9), midi_a,
                                vel=0.75, chan=0, engine='FM'))
        deg_b = (i % p2) % len(sc)
        midi_b = root_midi + 12 + sc[deg_b] + 12 * ((i % p2) // len(sc))
        events.append(NoteEvent(_beat_to_sec(cfg.bpm, beat + base_step * 0.5),
                                _beat_to_sec(cfg.bpm, base_step * 0.9), midi_b,
                                vel=0.65, chan=1, engine='FM'))
        if i % 3 == 0:
            events.append(NoteEvent(_beat_to_sec(cfg.bpm, beat),
                                    _beat_to_sec(cfg.bpm, base_step * 0.2), 60,
                                    vel=0.35, chan=0, engine='PSG'))
        beat += base_step
        if _beat_to_sec(cfg.bpm, beat) > cfg.seconds:
            break
    return events


def pattern_pythagorean(cfg: RenderConfig, base_midi: int = 52,
                        fifth_steps=None, **_ignored) -> list[NoteEvent]:
    """app/patterns.py:150-181"""
    if fifth_steps is None:
        fifth_steps = [0, 1, 2, 3, 2, 1, 4, 5, 4, 3, 2, 1]

    events: list[NoteEvent] = []
    base_step = 0.5
    beat = 0.0
    for i in range(int(cfg.seconds / _beat_to_sec(cfg.bpm, base_step)) + 1):
        st = fifth_steps[i % len(fifth_steps)]
        ratio = music.pythagorean_ratio(st)
        midi_off = 12.0 * np.log2(ratio)
        for v in range(3):
            t0 = _beat_to_sec(cfg.bpm, beat + v * base_step * 2.0)
            midi = base_midi + midi_off + 12 * v
            events.append(NoteEvent(t0, _beat_to_sec(cfg.bpm, base_step * 1.8),
                                    float(midi), vel=0.55, chan=v, engine='FM'))
        if i % 4 == 0:
            events.append(NoteEvent(_beat_to_sec(cfg.bpm, beat),
                                    _beat_to_sec(cfg.bpm, base_step * 0.95),
                                    base_midi - 12, vel=0.5, chan=1,
                                    engine='PSG'))
        beat += base_step
        if _beat_to_sec(cfg.bpm, beat) > cfg.seconds:
            break
    return events


def list_generators() -> list[str]:
    return ['Glass Cells', 'Fibonacci Gate', 'Prime Phase',
            'Pythagorean Canon', 'Python Script']


def generate(name: str, cfg: RenderConfig, **kwargs) -> list[NoteEvent]:
    """Dispatch by (fuzzy) name (app/patterns.py:188-214); "Python Script"
    loads ``script_path``'s ``entry`` through the plugin host and calls it
    as ``fn(cfg=cfg, **kwargs)``."""
    with span("patternlab.generate"):
        name = (name or '').strip().lower()
        if 'python' in name:
            from ..plugins.host import load_script_generator
            script_path = kwargs.pop('script_path', '')
            entry = kwargs.pop('entry', 'generate')
            if not script_path:
                raise ValueError(
                    "Python Script generator requires gen.script_path")
            fn = load_script_generator(Path(script_path), entry)
            return fn(cfg=cfg, **kwargs)
        if 'glass' in name:
            return pattern_glass_cells(cfg, **kwargs)
        if 'fibonacci' in name:
            return pattern_fibonacci(cfg, **kwargs)
        if 'prime' in name:
            return pattern_prime_phase(cfg, **kwargs)
        if 'pythag' in name:
            return pattern_pythagorean(cfg, **kwargs)
        return pattern_glass_cells(cfg)


# ----------------------------------------------------------------------------
# Renderer: bucketed voice bank
# ----------------------------------------------------------------------------

def _bucket_len(n: int, min_len: int = 256) -> int:
    L = min_len
    while L < n:
        L *= 2
    return L


@dataclass(frozen=True)
class PreparedRender:
    """Host pre-pass product: the static bucket spec and the packed note
    matrices on ``device``.  Prepare once, render many."""
    n_total: int
    spec: tuple           # ((is_psg, L, alg, vib, count), ...) row-ordered
    packs: dict           # fm32 [Nfm,36] / fmi [Nfm,26] / pg32 / pgi tensors
    device: torch.device


def prepared_to_device(n_total: int, spec, packs: dict,
                       device="cuda") -> PreparedRender:
    """A prepared program as NumPy (this package's ``prepare`` or the JAX
    package's ``PreparedRender``: its ``n_total``, ``spec`` and the four
    packs through ``np.asarray``) as the port's ``PreparedRender`` on
    ``device``."""
    device = torch.device(device)
    return PreparedRender(
        n_total=int(n_total),
        spec=tuple((bool(p), int(L), int(a), bool(v), int(c))
                   for (p, L, a, v, c) in spec),
        packs={k: torch.tensor(np.asarray(v), device=device)
               for k, v in packs.items()},
        device=device)


class MegaDriveInspiredSynth:
    """Port of app/renderer.py:34-132 (patternlab.py:383)."""

    def __init__(self, sr: int, seed: int = 1,
                 fm_channels=None, psg_channels=None, device="cuda"):
        self.sr = int(sr)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fm_channels = fm_channels or default_fm_channels()
        self.psg_channels = psg_channels or default_psg_channels()
        self._fm_tab = _fm_channel_tables(self.fm_channels, self.sr)
        self._psg_tab = _psg_channel_tables(self.psg_channels, self.sr)
        self._fade = int(round(self.sr * 0.012))
        self._lp1 = float(np.exp(-2.0 * np.pi * POST_LP_HZ / self.sr))
        self._lp2 = float(np.exp(-2.0 * np.pi * 14000.0 / self.sr))
        self._psg_lp = float(np.exp(-2.0 * np.pi * 12000.0 / self.sr))
        self._dac_m1 = float(2 ** (YM2612_DAC_BITS - 1) - 1)

    def set_fm_channel(self, i: int, params: FMVoiceParams):
        self.fm_channels[int(i) % 6] = params
        self._fm_tab = _fm_channel_tables(self.fm_channels, self.sr)

    def set_psg_channel(self, i: int, params: PSGParams):
        self.psg_channels[int(i) % 4] = params
        self._psg_tab = _psg_channel_tables(self.psg_channels, self.sr)

    def prepare_np(self, events, seconds: float):
        """The host pre-pass (patternlab.py:408): clamp the note batch,
        sort it into buckets keyed (is_psg, L, alg, vib) — stable, so notes
        keep event order within a bucket — and pack every per-note argument
        into fm32 / fmi / pg32 / pgi.  Returns (n_total, spec, packs) as
        NumPy."""
        cfg = RenderConfig(sample_rate=self.sr, seconds=seconds,
                           seed=self.seed)
        batch = prepare_note_batch(events, cfg)
        n_total = batch["n_total"]
        if batch["count"] == 0:
            return n_total, (), {}

        n = batch["n"]
        is_psg = batch["is_psg"]
        # smallest power of two >= n, at least 256
        Ls = (1 << np.ceil(np.log2(np.maximum(n, 1))).astype(np.int64)) \
            .astype(np.int64)
        Ls = np.maximum(256, Ls)
        chan = batch["chan"]
        alg = np.where(is_psg, 0, self._fm_tab["algorithm"][chan % 6])
        vib = np.where(is_psg, False,
                       self._fm_tab["lfo_depth"][chan % 6] > 0.0)
        # bucket order: is_psg slowest -> L -> alg -> vib
        order = np.lexsort((vib, alg, Ls, is_psg.astype(np.int8)))
        key = np.stack([is_psg[order].astype(np.int64), Ls[order],
                        alg[order].astype(np.int64),
                        vib[order].astype(np.int64)], axis=1)
        change = np.nonzero(np.any(key[1:] != key[:-1], axis=1))[0] + 1
        starts_g = np.concatenate([[0], change, [len(order)]])

        spec = []
        for gi in range(len(starts_g) - 1):
            o = int(starts_g[gi])
            cnt = int(starts_g[gi + 1]) - o
            spec.append((bool(key[o, 0]), int(key[o, 1]), int(key[o, 2]),
                         bool(key[o, 3]), cnt))
        spec = tuple(spec)

        fm_rows = order[~is_psg[order]]
        pg_rows = order[is_psg[order]]
        packs = {}
        if fm_rows.size:
            tab = self._fm_tab
            ch = chan[fm_rows] % 6
            # host ADSR stage constants per (note, op): the device envelope
            # divides nothing (envelopes.adsr_from_consts)
            ec = envelopes.adsr_consts_np(
                batch["n"][fm_rows][:, None], tab["A"][ch], tab["D"][ch],
                tab["R"][ch], tab["s"][ch])
            f32 = np.empty((fm_rows.size, 36), np.float32)
            f32[:, 0] = batch["vel"][fm_rows]
            f32[:, 1:5] = fm_op_freqs(tab, ch, batch["midi"][fm_rows])
            f32[:, 5:9] = tab["level"][ch]
            f32[:, 9:13] = tab["index_cyc"][ch]
            f32[:, 13:17] = tab["s"][ch]
            f32[:, 17] = tab["feedback"][ch]
            f32[:, 18] = tab["lfo_hz"][ch]
            f32[:, 19] = tab["lfo_depth"][ch]
            f32[:, 20:24] = ec["inv_na"]
            f32[:, 24:28] = ec["inv_nd"]
            f32[:, 28:32] = ec["inv_dr"]
            f32[:, 32:36] = ec["startv"]
            i32 = np.empty((fm_rows.size, 26), np.int32)
            i32[:, 0] = batch["n"][fm_rows]
            i32[:, 1] = batch["start"][fm_rows]
            i32[:, 2:6] = tab["A"][ch]
            i32[:, 6:10] = tab["D"][ch]
            i32[:, 10:14] = tab["R"][ch]
            i32[:, 14:18] = ec["n_a"]
            i32[:, 18:22] = ec["n_d"]
            i32[:, 22:26] = ec["n_r"]
            packs["fm32"], packs["fmi"] = f32, i32
        if pg_rows.size:
            tab = self._psg_tab
            ch = chan[pg_rows] % 4
            ec = envelopes.adsr_consts_np(
                batch["n"][pg_rows], tab["A"][ch], tab["D"][ch],
                tab["R"][ch], tab["s"][ch])
            f32 = np.empty((pg_rows.size, 10), np.float32)
            f32[:, 0] = (music.A4 * np.exp2(
                (np.asarray(batch["midi"][pg_rows], np.float64) - 69.0)
                / 12.0)).astype(np.float32)
            f32[:, 1] = batch["vel"][pg_rows]
            f32[:, 2] = tab["duty"][ch]
            f32[:, 3] = tab["s"][ch]
            f32[:, 4] = tab["levels_m1"][ch]
            f32[:, 5] = tab["inv_levels_m1"][ch]
            f32[:, 6] = ec["inv_na"]
            f32[:, 7] = ec["inv_nd"]
            f32[:, 8] = ec["inv_dr"]
            f32[:, 9] = ec["startv"]
            i32 = np.empty((pg_rows.size, 10), np.int32)
            i32[:, 0] = batch["n"][pg_rows]
            i32[:, 1] = batch["start"][pg_rows]
            i32[:, 2] = tab["A"][ch]
            i32[:, 3] = tab["D"][ch]
            i32[:, 4] = tab["R"][ch]
            i32[:, 5] = (self.seed + batch["k"][pg_rows]).astype(np.int32)
            i32[:, 6] = tab["noise"][ch].astype(np.int32)
            i32[:, 7] = ec["n_a"]
            i32[:, 8] = ec["n_d"]
            i32[:, 9] = ec["n_r"]
            packs["pg32"], packs["pgi"] = f32, i32
        return n_total, spec, packs

    def prepare(self, events, seconds: float) -> PreparedRender:
        """``prepare_np`` with the packs uploaded to the synth's device:
        re-rendering the same program uploads nothing."""
        with span("patternlab.pack"):
            prog = self.prepare_np(events, seconds)
        with span("patternlab.upload"):
            return prepared_to_device(*prog, device=self.device)

    def render_prepared(self, prep: PreparedRender,
                        master_gain: float = 0.9,
                        device_out: bool = False,
                        pcm16: bool = False):
        """Render a prepared program on its device: f32 samples, or int16
        PCM with ``pcm16``; a tensor on the device with ``device_out``,
        else a NumPy array."""
        y = _render_dispatch(self.sr, self._fade, self._lp1, self._lp2,
                             self._psg_lp, self._dac_m1, prep,
                             master_gain, pcm16)
        if device_out:
            return y
        with span("patternlab.pull"):
            return y.cpu().numpy()

    def render(self, events, seconds: float, master_gain: float = 0.9,
               device_out: bool = False, pcm16: bool = False):
        prep = self.prepare(events, seconds)
        return self.render_prepared(prep, master_gain=master_gain,
                                    device_out=device_out, pcm16=pcm16)


def _fm_bank(f32, i32, i_vec, alg, vib, fade, lp1, lp2, dac_m1, sr):
    """One FM bucket's notes [count, L] from its rows of fm32 / fmi."""
    cp = {"level": f32[:, 5:9], "index_cyc": f32[:, 9:13],
          "s": f32[:, 13:17], "feedback": f32[:, 17:18],
          "lfo_hz": f32[:, 18:19], "lfo_depth": f32[:, 19:20],
          "A": i32[:, 2:6], "D": i32[:, 6:10], "R": i32[:, 10:14],
          "env_n_a": i32[:, 14:18], "env_n_d": i32[:, 18:22],
          "env_n_r": i32[:, 22:26],
          "env_inv_na": f32[:, 20:24], "env_inv_nd": f32[:, 24:28],
          "env_inv_dr": f32[:, 28:32], "env_startv": f32[:, 32:36]}
    inv_dac = float(np.float32(1.0 / float(dac_m1)))
    return synth_ops.fm_note(i_vec, i32[:, 0:1], f32[:, 1:5], f32[:, 0:1],
                             cp, fade, lp1, lp2, float(np.float32(dac_m1)),
                             inv_dac, sr, alg_static=alg, vib_static=vib)


def _psg_bank(f32, i32, i_vec, fade, psg_lp, sr, lfsr):
    """One PSG bucket's notes [count, L] from its rows of pg32 / pgi."""
    orbit, base, pos, clen = lfsr
    return synth_ops.psg_note(
        i_vec, i32[:, 0:1], f32[:, 0:1], f32[:, 1:2], f32[:, 2:3],
        i32[:, 6:7] != 0, i32[:, 2:3], i32[:, 3:4], i32[:, 4:5],
        f32[:, 3:4], f32[:, 4:5], f32[:, 5:6], fade, psg_lp, i32[:, 5:6],
        orbit, base, pos, clen, sr,
        env_consts=(i32[:, 7:8], i32[:, 8:9], i32[:, 9:10], f32[:, 6:7],
                    f32[:, 7:8], f32[:, 8:9], f32[:, 9:10]))


def _render_dispatch(sr: int, fade: int, lp1: float, lp2: float,
                     psg_lp: float, dac_m1: float, prep: PreparedRender,
                     master_gain: float, pcm16: bool = False):
    """The device render of a prepared program (patternlab.py:577): per
    bucket of the static spec, the voice bank, the tail mask
    seg = min(n, n_total - start) and the overlap-add into a zero margin
    buffer of n_total + l_max samples, where every note window fits
    unclamped; buckets in spec order, notes in row order.  Then
    tanh(out[:n_total]) * master_gain, and PCM16 with ``pcm16``."""
    dev = prep.device
    l_max = max([L for (_p, L, _a, _v, _c) in prep.spec] + [1])
    out = torch.zeros(prep.n_total + l_max, dtype=torch.float32, device=dev)
    lfsr = synth_ops.lfsr_tables_on(dev) if "pgi" in prep.packs else None
    fm_off = pg_off = 0
    with span("patternlab.bank", device=dev):
        for (is_psg, L, alg, vib, count) in prep.spec:
            i_vec = torch.arange(L, dtype=torch.int32, device=dev)
            if is_psg:
                f32 = prep.packs["pg32"][pg_off: pg_off + count]
                i32 = prep.packs["pgi"][pg_off: pg_off + count]
                pg_off += count
                with span("patternlab.psg_bank"):
                    notes = _psg_bank(f32, i32, i_vec, fade, psg_lp, sr,
                                      lfsr)
            else:
                f32 = prep.packs["fm32"][fm_off: fm_off + count]
                i32 = prep.packs["fmi"][fm_off: fm_off + count]
                fm_off += count
                with span("patternlab.fm_bank"):
                    notes = _fm_bank(f32, i32, i_vec, alg, vib, fade, lp1,
                                     lp2, dac_m1, sr)
            # overlap-add with the tail clamp (app/renderer.py:113-131)
            starts = i32[:, 1].contiguous()
            seg = torch.minimum(i32[:, 0:1], prep.n_total - starts[:, None])
            contrib = torch.where(i_vec < seg, notes, 0.0).contiguous()
            overlap_add.overlap_add(out, contrib, starts)
    with span("patternlab.master", device=dev):
        y = torch.tanh(out[:prep.n_total]) * float(np.float32(master_gain))
        if pcm16:
            # PCM16 on the device (the reference saves PCM_16 WAVs)
            return torch.clamp(torch.round(y * 32768.0), -32768.0,
                               32767.0).to(torch.int16)
        return y


_RENDER_CACHE: OrderedDict = OrderedDict()


def render(events, cfg: RenderConfig, fm_channels=None, psg_channels=None,
           pcm16: bool = False, device="cuda"):
    """app/renderer.py:135-139 (patternlab.py:656): time-ops -> synth ->
    (host audio, events); int16 PCM with ``pcm16``.

    The host pre-pass (time-ops + prepare) is memoized on (events
    identity, channel-table identities, cfg content, device), LRU-bounded
    at 8 programs: callers must not mutate the events list in place
    between renders (regenerate instead).  master_gain is applied at
    render time, not baked into the program."""
    with span("patternlab.render") as sp:
        key = (id(events), id(fm_channels), id(psg_channels),
               json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                          default=str),
               str(torch.device(device)))
        ent = _RENDER_CACHE.pop(key, None)
        hit = ent is not None and ent["events"] is events
        sp.set(memo_hit=hit)
        if not hit:
            ev = apply_time_ops(events, cfg)
            s = MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed,
                                       fm_channels=fm_channels,
                                       psg_channels=psg_channels,
                                       device=device)
            ent = {"events": events, "ev": ev, "synth": s,
                   "prep": s.prepare(ev, cfg.seconds)}
        _RENDER_CACHE[key] = ent
        while len(_RENDER_CACHE) > 8:
            _RENDER_CACHE.popitem(last=False)
        y = ent["synth"].render_prepared(ent["prep"],
                                         master_gain=cfg.master_gain,
                                         pcm16=pcm16)
        return y, ent["ev"]


def render_device(events, cfg: RenderConfig, fm_channels=None,
                  psg_channels=None, device="cuda"):
    """render() with the output left on the device (no memo)."""
    ev = apply_time_ops(events, cfg)
    s = MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed,
                               fm_channels=fm_channels,
                               psg_channels=psg_channels, device=device)
    return s.render(ev, seconds=cfg.seconds, master_gain=cfg.master_gain,
                    device_out=True)


# ----------------------------------------------------------------------------
# Preset I/O (app/preset_io.py)
# ----------------------------------------------------------------------------

def load_preset(path) -> dict:
    with Path(path).open('r', encoding='utf-8') as f:
        return json.load(f)


def save_preset(path, preset: dict):
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open('w', encoding='utf-8') as f:
        json.dump(preset, f, indent=2, sort_keys=True)


def default_cfg() -> RenderConfig:
    return RenderConfig()


def render_preset(preset: dict, device="cuda"):
    """Render a {name, generator, cfg, gen} preset dict end to end."""
    cfg_d = dict(preset.get("cfg", {}))
    cfg = RenderConfig(**{k: v for k, v in cfg_d.items()
                          if k in RenderConfig.__dataclass_fields__})
    gen_kwargs = dict(preset.get("gen", {}))
    events = generate(preset.get("generator", "Glass Cells"), cfg,
                      **gen_kwargs)
    return render(events, cfg, device=device)

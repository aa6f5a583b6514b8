"""Note event model and time ops — the port's copy of
audio_suite_tpu/events/notes.py (pattern lab 0.1/app/events.py and
app/renderer.py:8-31).

Events are host-side control data; the renderer turns them into
struct-of-arrays batches for the voice bank.  Same seeded
``default_rng`` draws and the same banker's rounding as the original,
which ``tests/test_torch_patternlab.py`` holds it against."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.profiling import span


@dataclass
class NoteEvent:
    """app/events.py:5-12"""
    t0: float
    dur: float
    midi: float
    vel: float = 1.0
    chan: int = 0
    engine: str = "FM"   # 'FM' or 'PSG'


@dataclass
class RenderConfig:
    """app/events.py:15-23"""
    sample_rate: int = 44100
    seconds: float = 20.0
    bpm: float = 120.0
    swing: float = 0.0
    time_stretch: float = 1.0
    micro_jitter: float = 0.0
    master_gain: float = 0.9
    seed: int = 1


def apply_time_ops(events: list[NoteEvent], cfg: RenderConfig) -> list[NoteEvent]:
    """Stretch, swing (delay odd 16ths), Gaussian micro-jitter
    (app/renderer.py:8-31), with the same seeded Generator."""
    with span("patternlab.time_ops"):
        rng = np.random.default_rng(int(cfg.seed) & 0xFFFFFFFF)
        out: list[NoteEvent] = []
        swing = float(np.clip(cfg.swing, 0.0, 0.5))
        for e in events:
            t0 = float(e.t0) * float(cfg.time_stretch)
            dur = float(e.dur) * float(cfg.time_stretch)
            if swing > 0.0 and cfg.bpm > 0:
                sec_16th = 60.0 / float(cfg.bpm) / 4.0
                if sec_16th > 1e-6:
                    idx = int(round(t0 / sec_16th))
                    if idx % 2 == 1:
                        t0 += swing * sec_16th
            if cfg.micro_jitter > 0.0:
                t0 += float(rng.normal(0.0, cfg.micro_jitter))
                t0 = max(0.0, t0)
            out.append(NoteEvent(t0=t0, dur=max(1e-4, dur), midi=float(e.midi),
                                 vel=float(e.vel), chan=int(e.chan),
                                 engine=e.engine))
        return out


def prepare_note_batch(events: list[NoteEvent], cfg: RenderConfig):
    """Apply the renderer's defensive clamps (app/renderer.py:83-106) and
    return a struct-of-arrays dict.  `k` keeps the original event index
    (the PSG LFSR seed is `cfg.seed + k`, app/renderer.py:108-110)."""
    sr = int(cfg.sample_rate)
    n_total = int(max(1, round(float(cfg.seconds) * sr)))
    if not events:
        return {"n_total": n_total, "count": 0}
    # one attribute pass, then vectorized clamps (f64 math, banker's
    # rounding)
    raw = np.asarray([(e.t0, e.dur, e.midi, e.vel, e.chan,
                       1.0 if e.engine.upper() == "PSG" else 0.0)
                      for e in events], np.float64).reshape(-1, 6)
    start = np.maximum(np.round(raw[:, 0] * sr), 0.0)
    remain_s = np.maximum(0.0, (n_total - start) / float(sr))
    dur = np.minimum(raw[:, 1], remain_s)
    keep = (start < n_total) & (dur > 1e-4)
    if not keep.any():
        return {"n_total": n_total, "count": 0}
    k = np.nonzero(keep)[0]
    start = start[keep]
    n = np.maximum(1.0, np.round(dur[keep] * sr))
    is_psg = raw[keep, 5] != 0.0
    chan_i = raw[keep, 4].astype(np.int64)
    chan = np.where(is_psg, chan_i % 4, chan_i % 6)
    return {
        "n_total": n_total,
        "count": int(keep.sum()),
        "start": start.astype(np.int32),
        "n": n.astype(np.int32),
        "midi": raw[keep, 2].astype(np.float32),
        "vel": raw[keep, 3].astype(np.float32),
        "chan": chan.astype(np.int32),
        "is_psg": is_psg,
        "k": k.astype(np.int32),
    }

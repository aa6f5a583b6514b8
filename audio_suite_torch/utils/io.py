"""WAV / audio I/O helpers — the port's copy of the parts of
audio_suite_tpu/utils/io.py that the tape's ``render_to_wav`` uses.

Mirrors the reference's soundfile-based loaders semantically:
- mono fold by channel mean          (grid_audio_app_0.2/grid_audio_app.py:26-29)
- endpoint=False linear resampling   (grid_audio_app.py:31-40; tape-tuc-main/
  Tape_TUC_23-11-25_auto-slice_n_record.py:238-249)

These run on host (NumPy): file I/O is not device work. Arrays are handed to
engines as float32.
"""
from __future__ import annotations

import numpy as np

from . import wavcodec

try:
    import soundfile as sf
    HAVE_SOUNDFILE = True
except Exception:  # environment without libsndfile: use the built-in codec
    sf = None
    HAVE_SOUNDFILE = False


def to_mono(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim == 1:
        return x
    return x.mean(axis=1)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Duration-preserving linear resample (grid_audio_app.py:31-40)."""
    if sr_in == sr_out or len(x) == 0:
        return np.asarray(x, np.float32)
    duration = len(x) / sr_in
    n_out = max(1, int(round(duration * sr_out)))
    t_in = np.linspace(0.0, duration, num=len(x), endpoint=False)
    t_out = np.linspace(0.0, duration, num=n_out, endpoint=False)
    return np.interp(t_out, t_in, np.asarray(x, np.float64)).astype(np.float32)


def resample_to_rate(audio: np.ndarray, in_sr: int, out_sr: int) -> np.ndarray:
    """TapeTUC's variant (Tape_TUC_23-11-25_auto-slice_n_record.py:238-249):
    normalized [0,1) endpoint=False grids, f64 interp, f32 out."""
    audio = np.asarray(audio)
    if in_sr == out_sr or len(audio) == 0:
        return audio.astype(np.float32, copy=False)
    ratio = float(out_sr) / float(in_sr)
    new_len = int(round(len(audio) * ratio))
    if new_len <= 1:
        return audio.astype(np.float32, copy=False)
    old_x = np.linspace(0.0, 1.0, num=len(audio), endpoint=False, dtype=np.float64)
    new_x = np.linspace(0.0, 1.0, num=new_len, endpoint=False, dtype=np.float64)
    return np.interp(new_x, old_x, audio.astype(np.float64)).astype(np.float32)


def read_wav(path: str, always_2d: bool = False):
    """Read audio. WAV files go through the built-in RIFF codec; other
    formats (flac/ogg/aiff, per the reference's file dialogs) need the
    optional soundfile backend."""
    if path.lower().endswith(".wav") or not HAVE_SOUNDFILE:
        return wavcodec.read_wav(path, always_2d=always_2d)
    data, sr = sf.read(path, dtype="float32", always_2d=always_2d)
    return data, sr


def write_wav(path: str, audio: np.ndarray, sr: int, subtype: str | None = None):
    wavcodec.write_wav(path, np.asarray(audio, np.float32), int(sr),
                       subtype=subtype or "FLOAT")


def load_wav_mono(path: str, sr_target: int | None = None) -> tuple[np.ndarray, int]:
    """Load any soundfile-supported audio, fold to mono, optionally resample."""
    data, sr = read_wav(path, always_2d=True)
    mono = data.mean(axis=1) if data.shape[1] > 1 else data[:, 0]
    if sr_target is not None and sr_target != sr:
        mono = resample_linear(mono, sr, sr_target)
        sr = sr_target
    return mono.astype(np.float32), int(sr)

"""Parity / performance metrics — the port's copy of
audio_suite_tpu/utils/metrics.py (NumPy only).

The suite-wide acceptance metric is max deviation vs. the CPU NumPy oracle in
dBFS (full scale = 1.0); target <= -60 dBFS (BASELINE.json), plus realtime
factor (audio-seconds rendered per wall second per chip)."""
from __future__ import annotations

import numpy as np


def max_dev_dbfs(a: np.ndarray, b: np.ndarray) -> float:
    """20*log10(max |a-b|), with -inf -> -200 for identical signals."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = float(np.max(np.abs(a - b))) if a.size else 0.0
    if d <= 0.0:
        return -200.0
    return float(20.0 * np.log10(d))


def rtf(audio_seconds: float, wall_seconds: float) -> float:
    """Realtime factor: rendered audio time / wall-clock time."""
    if wall_seconds <= 0:
        return float("inf")
    return audio_seconds / wall_seconds

"""Render observability — the port of audio_suite_tpu/utils/profiling.py:
per-render meta (peak dBFS, realtime factor, duration), a stage timer, and
device traces on ``torch.profiler``.

The framework's first-class metric is audio-seconds rendered per wall
second (BASELINE.md), so every CLI render reports it.  ``peak_dbfs`` and
``render_meta`` take a NumPy array or a tensor on any device; a tensor is
pulled to the host once.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch


def _host(audio) -> np.ndarray:
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)


def peak_dbfs(audio) -> float:
    audio = _host(audio)
    m = float(np.max(np.abs(audio))) if audio.size else 0.0
    if m <= 0:
        return float("-inf")
    return 20.0 * float(np.log10(m))


def render_meta(audio, sample_rate: int, wall_seconds: float) -> dict:
    audio = _host(audio)
    dur = audio.shape[0] / float(sample_rate)
    return {
        "seconds": round(dur, 6),
        "sample_rate": int(sample_rate),
        "peak_dbfs": round(peak_dbfs(audio), 2),
        "wall_s": round(wall_seconds, 4),
        "rtf": round(dur / wall_seconds, 2) if wall_seconds > 0 else None,
    }


class StageTimer:
    """Named wall-clock stages; `report()` gives an ordered dict."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> dict:
        return {k: round(v, 4) for k, v in self.stages.items()}


@contextmanager
def device_trace(trace_dir: str | None, device=None):
    """Trace the enclosed region with ``torch.profiler`` and write it as a
    Chrome / Perfetto trace JSON, ``trace_<pid>_<ns>.json`` under
    ``trace_dir``: host activity always, the card's kernels too when
    ``device`` is a CUDA device.  No-op when trace_dir is falsy, so callers
    can thread a CLI flag straight through.  The profiler synchronizes the
    card when it stops, at the region's end, and nowhere inside it; traced
    runs carry its overhead and are not timings."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            str(trace_dir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A ``torch.profiler.record_function`` range: labels a host region so
    it shows on the captured timeline beside the device's kernels."""
    return torch.profiler.record_function(name)

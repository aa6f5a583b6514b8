"""Breakpoint automation lanes — the port's copy of
audio_suite_tpu/utils/breakpoints.py (microsound_0.2.1/main_v2.py:452-482):
parse "t:v, t:v" strings, piecewise-linear evaluation.  Host code."""
from __future__ import annotations

import numpy as np


def parse_breakpoints(s):
    pts = []
    s = (s or "").strip()
    if not s:
        return pts
    for part in s.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        t, v = part.split(":")
        try:
            pts.append((float(t.strip()), float(v.strip())))
        except Exception:
            pass
    pts.sort(key=lambda p: p[0])
    return pts


def eval_breakpoints(pts, t, default):
    if not pts:
        return default
    if t <= pts[0][0]:
        return pts[0][1]
    if t >= pts[-1][0]:
        return pts[-1][1]
    for i in range(len(pts) - 1):
        t0, v0 = pts[i]
        t1, v1 = pts[i + 1]
        if t0 <= t <= t1:
            a = (t - t0) / max(1e-12, (t1 - t0))
            return (1 - a) * v0 + a * v1
    return default


def eval_breakpoints_vec(pts, ts, default):
    """Vectorized eval_breakpoints over an array of times — identical IEEE
    arithmetic per element (same op order as the scalar loop), so results
    are bit-equal to calling eval_breakpoints per time."""
    ts = np.asarray(ts, np.float64)
    if not pts:
        return np.full(ts.shape, float(default), np.float64)
    kt = np.asarray([p[0] for p in pts], np.float64)
    kv = np.asarray([p[1] for p in pts], np.float64)
    if len(pts) == 1:
        # scalar loop: t <= first -> v0; t >= last -> v0 (same point)
        return np.full(ts.shape, kv[0], np.float64)
    # the scalar scan picks the FIRST segment with t0 <= t <= t1, which is
    # [k-1, k] for the first knot k with kt[k] >= t
    hi = np.clip(np.searchsorted(kt, ts, side="left"), 1, len(pts) - 1)
    lo = hi - 1
    t0, v0 = kt[lo], kv[lo]
    t1, v1 = kt[hi], kv[hi]
    a = (ts - t0) / np.maximum(1e-12, (t1 - t0))
    v = (1 - a) * v0 + a * v1
    v = np.where(ts <= kt[0], kv[0], v)
    v = np.where(ts >= kt[-1], kv[-1], v)
    return v

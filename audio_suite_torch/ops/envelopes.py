"""Envelopes — port of make_adsr (audio_suite_tpu/ops/envelopes.py:153-194)."""
from __future__ import annotations

import numpy as np
import torch


def make_adsr(n: int, sr: int, a_ms: float, d_ms: float, s: float,
              r_ms: float, curve: float = 1.8, device=None) -> torch.Tensor:
    """Microsound global ADSR with curve exponent, f32[n].  Each ramp's pow
    runs on its own segment only and the segments concatenate (the A/D/R
    spans are short next to n); same per-element arithmetic as the JAX
    package."""
    A = max(0, int(round(sr * a_ms / 1000.0)))
    D = max(0, int(round(sr * d_ms / 1000.0)))
    R = max(0, int(round(sr * r_ms / 1000.0)))
    s = float(np.clip(s, 0, 1))
    curve = float(max(1e-6, curve))
    f32 = dict(dtype=torch.float32, device=device)

    pos = 0
    parts = []
    if A > 0:
        ia = torch.arange(min(A, n), **f32)
        parts.append((ia / float(A)) ** curve)
        pos = min(A, n)
    j = min(n, pos + D)
    if D > 0 and j > pos:
        idd = torch.arange(j - pos, **f32)
        parts.append(1.0 - (1.0 - s) * (idd / float(j - pos)) ** curve)
    sus_start = j
    sus_end = max(sus_start, n - R)
    if sus_end > sus_start:
        parts.append(torch.full((sus_end - sus_start,), s, **f32))
    if R > 0 and n > sus_end:
        ir_ = torch.arange(n - sus_end, **f32)
        r_ramp = (ir_ / float(max(1, n - 1 - sus_end))) ** curve
        parts.append(float(np.float32(s)) * (1.0 - r_ramp))
    if not parts:
        return torch.ones(n, **f32)
    env = torch.cat(parts)
    if env.shape[0] < n:        # A+D+sus+R can undershoot when D spills
        env = torch.cat([env, torch.ones(n - env.shape[0], **f32)])
    return env[:n]

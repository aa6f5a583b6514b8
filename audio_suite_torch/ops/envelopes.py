"""Envelopes — port of audio_suite_tpu/ops/envelopes.py.

- ``adsr_clamped``, ``adsr_from_consts`` with its host twin
  ``adsr_consts_np``, and ``micro_fade_gain``: the Pattern Lab voices'
  stage-clamped ADSR and 12 ms half-cosine fade (pattern lab 0.1/app/
  synth_fm.py:7-24, 64-99), mask-based over padded sample indices;
- ``make_adsr``: Microsound's curve-exponent global ADSR.

Per-note arguments broadcast against the sample indices ``i`` [L]: a
batch of notes passes them as [B, 1] and gets [B, L].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import detmath


def adsr_clamped(i, n, A, D, R, s):
    """Stage-clamped ADSR (envelopes.py:17): stage lengths clamped to the
    note length n in the order A, D, R, sustain taking the rest.  ``i``
    int32 sample indices, ``n``, ``A``, ``D``, ``R`` int32, ``s`` f32;
    zero outside [0, n).  Divides on the device; the render uses
    ``adsr_from_consts``."""
    n_a = torch.minimum(n, A)
    rem = torch.clamp(n - n_a, min=0)
    n_d = torch.minimum(rem, D)
    rem = torch.clamp(rem - n_d, min=0)
    n_r = torch.minimum(rem, R)
    n_s = torch.clamp(rem - n_r, min=0)

    fi = i.to(torch.float32)
    # attack: linspace(0,1,n_a,endpoint=False)**2
    ramp_a = fi / torch.clamp(n_a, min=1).to(torch.float32)
    val_a = ramp_a * ramp_a
    # decay: linspace(1,s,n_d,endpoint=False)
    kd = (i - n_a).to(torch.float32)
    val_d = 1.0 + (s - 1.0) * (kd / torch.clamp(n_d, min=1).to(torch.float32))
    # release: startv * linspace(1,0,n_r,endpoint=True)**2
    rel_start = n_a + n_d + n_s
    kr = (i - rel_start).to(torch.float32)
    denom = torch.clamp(n_r - 1, min=1).to(torch.float32)
    ramp_r = torch.where(n_r > 1, 1.0 - kr / denom, 1.0)
    # startv = env[rel_start-1]: s if sustain exists, else last decay/attack
    last_d = 1.0 + (s - 1.0) * ((n_d - 1).to(torch.float32)
                                / torch.clamp(n_d, min=1).to(torch.float32))
    last_a_r = ((n_a - 1).to(torch.float32)
                / torch.clamp(n_a, min=1).to(torch.float32))
    last_a = last_a_r * last_a_r
    startv = torch.where(n_s > 0, s,
                         torch.where(n_d > 0, last_d,
                                     torch.where(n_a > 0, last_a, s)))
    val_r = startv * ramp_r * ramp_r

    env = torch.where(i < n_a, val_a,
                      torch.where(i < n_a + n_d, val_d,
                                  torch.where(i < rel_start, s, val_r)))
    return torch.where(i < n, env, 0.0)


def adsr_from_consts(i, n, n_a, n_d, n_r, inv_na, inv_nd, inv_dr, startv, s):
    """The stage-clamped ADSR from host-computed per-note constants
    (envelopes.py:66; ``adsr_consts_np``): no division on the device, so
    every op is one correctly rounded f32 multiply or add, bit-identical
    to the host twin on every backend.

    n_a, n_d, n_r : int32 clamped stage lengths;  inv_na = 1/max(1, n_a),
    inv_nd = 1/max(1, n_d), inv_dr = 1/max(1, n_r - 1), startv (the value
    entering the release) and s : f32."""
    fi = i.to(torch.float32)
    ramp_a = fi * inv_na
    val_a = ramp_a * ramp_a
    kd = (i - n_a).to(torch.float32)
    val_d = 1.0 + (s - 1.0) * (kd * inv_nd)
    rel_start = n - n_r
    kr = (i - rel_start).to(torch.float32)
    ramp_r = torch.where(n_r > 1, 1.0 - kr * inv_dr, 1.0)
    val_r = startv * (ramp_r * ramp_r)
    env = torch.where(i < n_a, val_a,
                      torch.where(i < n_a + n_d, val_d,
                                  torch.where(i < rel_start, s, val_r)))
    return torch.where(i < n, env, 0.0)


def adsr_consts_np(n, A, D, R, s):
    """Host twin: stage lengths, reciprocals and release start value for
    ``adsr_from_consts``, vectorized over note / op axes (envelopes.py:100;
    NumPy's f32 division is correctly rounded)."""
    n = np.asarray(n, np.int64)
    A = np.asarray(A, np.int64)
    D = np.asarray(D, np.int64)
    R = np.asarray(R, np.int64)
    s = np.asarray(s, np.float32)
    n_a = np.minimum(n, A)
    rem = np.maximum(0, n - n_a)
    n_d = np.minimum(rem, D)
    rem2 = np.maximum(0, rem - n_d)
    n_r = np.minimum(rem2, R)
    n_s = rem2 - n_r
    one = np.float32(1.0)
    inv_na = (one / np.maximum(1, n_a).astype(np.float32)).astype(np.float32)
    inv_nd = (one / np.maximum(1, n_d).astype(np.float32)).astype(np.float32)
    inv_dr = (one / np.maximum(1, n_r - 1).astype(np.float32)) \
        .astype(np.float32)
    last_d = (one + (s - one)
              * ((n_d - 1).astype(np.float32) * inv_nd)).astype(np.float32)
    la = ((n_a - 1).astype(np.float32) * inv_na).astype(np.float32)
    last_a = (la * la).astype(np.float32)
    startv = np.where(n_s > 0, s,
                      np.where(n_d > 0, last_d,
                               np.where(n_a > 0, last_a, s))) \
        .astype(np.float32)
    return dict(n_a=n_a.astype(np.int32), n_d=n_d.astype(np.int32),
                n_r=n_r.astype(np.int32), inv_na=inv_na, inv_nd=inv_nd,
                inv_dr=inv_dr, startv=startv)


def micro_fade_gain(i, n, fade_samples: int):
    """Gain curve of _apply_micro_fade (app/synth_fm.py:7-24;
    envelopes.py:133): half-cosine fade over fade_n = clip(fade_samples,
    8, n // 3) samples at both ends, endpoints zero; 1 for n <= 16.
    ``n`` int32."""
    fade_n = torch.clamp(torch.clamp(n // 3, max=int(fade_samples)), min=8)
    denom = torch.clamp(fade_n - 1, min=1).to(torch.float32)
    # front ramp: 0.5 - 0.5 cos(pi * i/(fade_n-1))
    front = 0.5 - 0.5 * torch.cos(math.pi * i.to(torch.float32) / denom)
    back_k = (n - 1 - i).to(torch.float32)
    back = 0.5 - 0.5 * torch.cos(math.pi * back_k / denom)
    g = torch.where(i < fade_n, front, 1.0)
    g = torch.where(i >= n - fade_n, back, g)
    g = torch.where((i == 0) | (i == n - 1), 0.0, g)
    return torch.where(n <= 16, 1.0, g)


def make_adsr(n: int, sr: int, a_ms: float, d_ms: float, s: float,
              r_ms: float, curve: float = 1.8, device=None) -> torch.Tensor:
    """Microsound global ADSR with curve exponent, f32[n].  Each ramp's pow
    runs on its own segment only and the segments concatenate (the A/D/R
    spans are short next to n); same per-element arithmetic as the JAX
    package, the pow in f64 rounded once (``detmath.rounded``)."""
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
        parts.append(detmath.rounded(torch.pow, ia / float(A), curve))
        pos = min(A, n)
    j = min(n, pos + D)
    if D > 0 and j > pos:
        idd = torch.arange(j - pos, **f32)
        parts.append(1.0 - (1.0 - s) * detmath.rounded(
            torch.pow, idd / float(j - pos), curve))
    sus_start = j
    sus_end = max(sus_start, n - R)
    if sus_end > sus_start:
        parts.append(torch.full((sus_end - sus_start,), s, **f32))
    if R > 0 and n > sus_end:
        ir_ = torch.arange(n - sus_end, **f32)
        r_ramp = detmath.rounded(torch.pow,
                                 ir_ / float(max(1, n - 1 - sus_end)), curve)
        parts.append(float(np.float32(s)) * (1.0 - r_ramp))
    if not parts:
        return torch.ones(n, **f32)
    env = torch.cat(parts)
    if env.shape[0] < n:        # A+D+sus+R can undershoot when D spills
        env = torch.cat([env, torch.ones(n - env.shape[0], **f32)])
    return env[:n]

"""Spectral grain ops — port of the lowpass and fused lowpass + stretch
paths of audio_suite_tpu/ops/spectral.py.

The JAX package selects the stretched spectrum's bins with one-hot MXU
matmuls (spectral.py:119, 319-358), which exist for the TPU's slow
gathers; here the same lerp is a direct gather,
``(1 - t) * X[i0] + t * X[i0 + 1]``, with the same validity mask and the same
``factor == 1`` bypass.

``sr``, ``cutoff`` and ``factor`` are Python floats or f32 tensors that
broadcast against the batch as [..., 1].
"""
from __future__ import annotations

import math

import torch

from . import exact_dft


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _freqs(L: int, sr: torch.Tensor) -> torch.Tensor:
    """rfftfreq for length L at sample rate sr (spectral.py:43)."""
    return torch.arange(L // 2 + 1, dtype=torch.float32, device=sr.device) \
        * (sr / float(L))


def _lowpass_gain(L: int, sr, cutoff, roll: float, device=None
                  ) -> torch.Tensor:
    """The lowpass gain curve with a cosine rolloff band (spectral.py:228),
    [..., L//2 + 1]."""
    sr = _f32(sr, device)
    nyq = 0.5 * sr
    cutoff = torch.minimum(torch.clamp_min(_f32(cutoff, device), 1.0), nyq)
    roll = max(float(roll), 0.0)
    f = _freqs(L, sr)
    if roll <= 0:
        return torch.where(f > cutoff, 0.0, 1.0)
    f1 = torch.minimum(nyq, cutoff + roll)
    t = (f - cutoff) / torch.clamp_min(f1 - cutoff, 1e-12)
    w_roll = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return torch.where(f > f1, 0.0, torch.where(f >= cutoff, w_roll, 1.0))


def lowpass_fft(x: torch.Tensor, sr, cutoff, roll: float = 0.0,
                n_fft: int | None = None) -> torch.Tensor:
    """FFT lowpass with cosine rolloff (spectral.py:49); with n_fft the
    transform runs at the exact grain length (identity below 8 samples)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 8:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    gain = _lowpass_gain(nfft, sr, cutoff, roll, device=x.device)
    return exact_dft.irfft_n(X * gain, nfft, out_len=L)


def _lerp_affine(X: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Lerp of the spectrum X [..., nf] at bin positions k * scale, zero
    outside the grid: the gather form of spectral._lerp_uniform_affine.
    Real and imaginary parts are interpolated separately."""
    nf = X.shape[-1]
    k = torch.arange(nf, dtype=torch.float32, device=X.device)
    pos = k * scale
    valid = (pos >= 0.0) & (pos <= float(nf - 1))
    i0 = torch.clamp(torch.floor(pos), 0.0, float(nf - 2))
    t = (pos - i0)[..., None]
    idx = i0.to(torch.int64).expand(X.shape)[..., None] \
        .expand(*X.shape, 2)
    Xr = torch.view_as_real(X)
    a = torch.gather(Xr, -2, idx)
    b = torch.gather(Xr, -2, idx + 1)
    v = a * (1.0 - t) + b * t
    v = torch.where(valid[..., None], v, 0.0)
    return torch.view_as_complex(v.contiguous())


def lowpass_stretch_fused(x: torch.Tensor, sr, cutoff, factor,
                          roll: float = 0.0, n_fft: int | None = None
                          ) -> torch.Tensor:
    """lowpass_fft followed by the partial stretch in one spectral pass
    (spectral.py:244).  Below 16 samples the stretch is the identity and
    only the lowpass runs, as in the reference."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        return lowpass_fft(x, sr, cutoff, roll=roll, n_fft=n_fft)
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    Xg = X * _lowpass_gain(nfft, sr, cutoff, roll, device=x.device)
    factor = _f32(factor, x.device)
    scale = 1.0 / torch.clamp_min(factor, 1e-12)
    Y = _lerp_affine(Xg, scale)
    Z = torch.where(torch.abs(factor - 1.0) < 1e-9, Xg, Y)
    return exact_dft.irfft_n(Z, nfft, out_len=L)


def lowpass_stretch_fused_shared(x: torch.Tensor, sr_v: torch.Tensor,
                                 cutoff_v: torch.Tensor, factor,
                                 roll: float = 0.0, shared_gain: bool = False,
                                 n_fft: int | None = None) -> torch.Tensor:
    """lowpass_stretch_fused for a grain bank x [E, L] whose stretch factor
    is shared by every event (spectral.py:268); sr_v and cutoff_v are
    per-event [E].  With ``shared_gain`` every event also shares
    (sr, cutoff) and one gain curve is broadcast."""
    if shared_gain:
        sr, cutoff = sr_v[0], cutoff_v[0]
    else:
        sr, cutoff = sr_v[:, None], cutoff_v[:, None]
    return lowpass_stretch_fused(x, sr, cutoff, factor, roll=roll,
                                 n_fft=n_fft)

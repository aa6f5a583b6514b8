"""Spectral grain ops — port of audio_suite_tpu/ops/spectral.py.

The JAX package selects resampled spectrum bins with one-hot MXU matmuls
(spectral.py:119, 319-358), which exist for the TPU's slow gathers; here
the same lerp is a direct gather, ``(1 - t) * X[i0] + t * X[i0 + 1]`` on
the real and imaginary parts, with the same validity mask and the same
``factor == 1`` bypass.  Grids of a static config constant (the power
warp's and the cepstral warp's positions) are computed in f64 on the host,
as the JAX package does, and cached on the device.

``sr``, ``cutoff`` and ``factor`` are Python floats or f32 tensors that
broadcast against the batch as [..., 1].  With ``n_fft`` a transform runs
at exactly that length (the true grain length) with the reference's
short-grain guards; without it, at the padded buffer length.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import detmath, exact_dft


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.floating, np.integer))


def _bin_hz(L: int, sr: torch.Tensor) -> torch.Tensor:
    """sr / L as the jitted JAX chain computes it: XLA rewrites a division
    by a constant as a multiply by its f32 reciprocal."""
    return sr * float(np.float32(1.0) / np.float32(L))


def _freqs(L: int, sr: torch.Tensor) -> torch.Tensor:
    """rfftfreq for length L at sample rate sr (spectral.py:43)."""
    return torch.arange(L // 2 + 1, dtype=torch.float32, device=sr.device) \
        * _bin_hz(L, sr)


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
    # f - cutoff as one fused multiply-add, k * (sr / L) - cutoff rounded
    # once (exact in f64, then to f32), as XLA contracts it in the jitted
    # JAX chain: where the cutoff clips to Nyquist (f1 == cutoff) the
    # Nyquist bin's sign of that residual over 1e-12 decides its gain
    k = torch.arange(L // 2 + 1, dtype=torch.float64, device=sr.device)
    num = (k * _bin_hz(L, sr).double() - cutoff.double()).float()
    t = num / torch.clamp_min(f1 - cutoff, 1e-12)
    w_roll = 0.5 * (1.0 + detmath.rounded(
        torch.cos, math.pi * torch.clamp(t, 0.0, 1.0)))
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


def bandpass_fft(x: torch.Tensor, sr, lo, hi, roll: float = 0.0,
                 n_fft: int | None = None) -> torch.Tensor:
    """FFT bandpass with cosine rolloffs (spectral.py:62); with n_fft the
    transform runs at the exact grain length (identity below 8 samples)."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 8:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    dev = x.device
    sr = _f32(sr, dev)
    nyq = 0.5 * sr
    lo = torch.clamp_min(_f32(lo, dev), 0.0)
    hi = torch.minimum(torch.maximum(lo, _f32(hi, dev)), nyq)
    roll = torch.clamp_min(_f32(roll, dev), 0.0)
    X = exact_dft.rfft_n(x, nfft)
    f = _freqs(nfft, sr)

    # low edge (0 -> 1 over [lo - roll, lo])
    lo_f0 = torch.clamp_min(lo - roll, 0.0)
    t_lo = (f - lo_f0) / torch.clamp_min(lo - lo_f0, 1e-12)
    w_lo = 0.5 * (1.0 - detmath.rounded(
        torch.cos, math.pi * torch.clamp(t_lo, 0.0, 1.0)))
    g_lo_roll = torch.where(f < lo_f0, 0.0, torch.where(f <= lo, w_lo, 1.0))
    g_lo_hard = torch.where(f < lo, 0.0, 1.0)
    g_lo = torch.where(lo > 0, torch.where(roll <= 0, g_lo_hard, g_lo_roll),
                       1.0)

    # high edge (1 -> 0 over [hi, hi + roll])
    hi_f1 = torch.minimum(nyq, hi + roll)
    t_hi = (f - hi) / torch.clamp_min(hi_f1 - hi, 1e-12)
    w_hi = 0.5 * (1.0 + detmath.rounded(
        torch.cos, math.pi * torch.clamp(t_hi, 0.0, 1.0)))
    g_hi_roll = torch.where(f > hi_f1, 0.0, torch.where(f >= hi, w_hi, 1.0))
    g_hi_hard = torch.where(f > hi, 0.0, 1.0)
    g_hi = torch.where(hi < nyq, torch.where(roll <= 0, g_hi_hard, g_hi_roll),
                       1.0)

    y = exact_dft.irfft_n(X * (g_lo * g_hi), nfft, out_len=L)
    return torch.where(hi <= 0, 0.0, y)


def _lerp_uniform(y: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of y [..., nf] (the uniform grid 0..nf-1) at
    fractional positions pos [..., P] (broadcast against y's batch), zero
    outside the grid (spectral.py:97); a complex y is interpolated on its
    real and imaginary parts."""
    nf = y.shape[-1]
    valid = (pos >= 0.0) & (pos <= float(nf - 1))
    i0 = torch.clamp(torch.floor(pos), 0.0, float(nf - 2))
    t = pos - i0
    shape = torch.broadcast_shapes(y.shape[:-1], pos.shape[:-1]) \
        + pos.shape[-1:]
    idx = i0.to(torch.int64).expand(shape)
    if y.is_complex():
        yr = torch.view_as_real(y).expand(*shape[:-1], nf, 2)
        idx = idx[..., None].expand(*shape, 2)
        t, valid = t[..., None], valid[..., None]
    else:
        yr = y.expand(*shape[:-1], nf)
    a = torch.gather(yr, -2 if y.is_complex() else -1, idx)
    b = torch.gather(yr, -2 if y.is_complex() else -1, idx + 1)
    v = torch.where(valid, a * (1.0 - t) + b * t, 0.0)
    return torch.view_as_complex(v.contiguous()) if y.is_complex() else v


def _interp_spectrum(X: torch.Tensor, k_in: torch.Tensor) -> torch.Tensor:
    """np.interp of Re / Im at fractional bin positions, zero outside
    (spectral.py:111)."""
    return _lerp_uniform(X, k_in)


def _lerp_affine(X: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Lerp of the spectrum X [..., nf] at bin positions k * scale, zero
    outside the grid: the gather form of spectral._lerp_uniform_affine."""
    k = torch.arange(X.shape[-1], dtype=torch.float32, device=X.device)
    return _lerp_uniform(X, k * scale)


@functools.lru_cache(maxsize=64)
def _host_grid(kind: str, size: int, value: float, device: str):
    """The f64 host lerp grid of a static config constant, on ``device``:
    (i0 int64, t f32, valid f32 or None).  ``kind`` "warp": the power
    warp's bin positions (k / kmax) ** (1 / power) * kmax over ``size``
    bins (spectral.py:212-218); "cep": the cepstral warp's quefrency
    positions q / factor over ``size`` samples (spectral.py:436-442)."""
    if kind == "warp":
        k = np.arange(size, dtype=np.float64)
        kmax = max(1.0, float(size - 1))
        pos = (k / kmax) ** (1.0 / max(1e-6, value)) * kmax
        valid = None                      # pos in [0, kmax]: all valid
    else:
        pos = np.arange(size, dtype=np.float64) / max(1e-12, value)
        valid = (pos <= float(size - 1)).astype(np.float32)
    i0 = np.clip(np.floor(pos), 0.0, size - 2).astype(np.int64)
    t = (pos - i0).astype(np.float32)
    dev = torch.device(device)
    return (torch.tensor(i0, device=dev), torch.tensor(t, device=dev),
            None if valid is None else torch.tensor(valid, device=dev))


def _lerp_grid(y: torch.Tensor, grid) -> torch.Tensor:
    """y [..., N] read at a host grid: ``y[i0] * (1 - t) + y[i0 + 1] * t``,
    times ``valid`` when the grid has one (real and imaginary parts
    apart for a complex y)."""
    i0, t, valid = grid
    if y.is_complex():
        yr = torch.view_as_real(y)
        v = yr[..., i0, :] * (1.0 - t)[:, None] + yr[..., i0 + 1, :] \
            * t[:, None]
        return torch.view_as_complex(v.contiguous())
    v = y[..., i0] * (1.0 - t) + y[..., i0 + 1] * t
    return v if valid is None else v * valid


def _warp_spectrum(X: torch.Tensor, power: float) -> torch.Tensor:
    return _lerp_grid(X, _host_grid("warp", X.shape[-1], float(power),
                                    str(X.device)))


def fft_warp_power(x: torch.Tensor, power, n_fft: int | None = None
                   ) -> torch.Tensor:
    """Power-law frequency warp (spectral.py:194); identity below 16
    samples with n_fft.  A number ``power`` warps on the f64 host grid
    (an f32 pow on the device flips floor() bin decisions); a tensor on
    the f32 device grid."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    nf = X.shape[-1]
    if _is_number(power):
        return exact_dft.irfft_n(_warp_spectrum(X, power), nfft, out_len=L)
    k = torch.arange(nf, dtype=torch.float32, device=x.device)
    kmax = max(1.0, float(nf - 1))
    u_in = detmath.rounded(torch.pow, k / kmax,
                           1.0 / torch.clamp_min(_f32(power, x.device), 1e-6))
    return exact_dft.irfft_n(_interp_spectrum(X, u_in * kmax), nfft,
                             out_len=L)


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


def fft_partial_stretch(x: torch.Tensor, factor, n_fft: int | None = None
                        ) -> torch.Tensor:
    """Linear partial stretch by spectrum resampling at k / factor
    (spectral.py:363); identity below 16 samples with n_fft and where
    factor is 1."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 16:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    factor = _f32(factor, x.device)
    X = exact_dft.rfft_n(x, nfft)
    Y = _lerp_affine(X, 1.0 / torch.clamp_min(factor, 1e-12))
    y = exact_dft.irfft_n(Y, nfft, out_len=L)
    return torch.where(torch.abs(factor - 1.0) < 1e-9, x, y)


def lock_passes(stretch_min: float, top_n: int) -> int:
    """Host: a bound on the peaks that one partial-lock offset sends to one
    bin, the scatters ``_lock_spectrum`` needs.  Peaks are distinct
    integers p and k2 = round(p * f): the peaks sharing a k2 lie within
    1 / f of each other, so at most floor(1 / f) + 1 of them (+1 for the
    f32 rounding of p * f at a half)."""
    f = float(stretch_min)
    if not f > 0.0:
        return int(top_n)
    return int(min(top_n, math.floor(1.0 / f) + 2))


def _lock_spectrum(X: torch.Tensor, factor: torch.Tensor, top_n: int,
                   neigh: int, passes: int | None) -> torch.Tensor:
    """The peak-locked spectrum (spectral.py:391-405): the top_n peaks of
    |X| above DC, each moved to round(k * factor) with a triangular spread
    of +-neigh bins, plus 0.12 of the dry spectrum.  The spreads add in
    JAX's order (offset by offset, peaks by falling magnitude) through
    ``ordered_scatter_add``: peaks that share a target add one rank per
    scatter.  ``passes`` bounds the rank (``lock_passes``; None: top_n).

    ``torch.topk`` and ``lax.top_k`` may break ties differently.  After a
    lowpass the bins above the cutoff are exact zeros: a tie there picks
    peaks whose X is 0, and adding a zero moves no bin."""
    from .generators import ordered_scatter_add
    if X.dim() == 1:
        return _lock_spectrum(X[None], factor, top_n, neigh, passes)[0]
    nf = X.shape[-1]
    mag = detmath.rounded(torch.abs, X)
    peaks = torch.topk(mag[..., 1:], top_n, dim=-1).indices + 1
    k2 = torch.round(peaks.to(torch.float32) * factor).to(torch.int64)
    eq = k2[..., :, None] == k2[..., None, :]
    rank = (eq & torch.ones(top_n, top_n, dtype=torch.bool,
                            device=X.device).tril(-1)).sum(-1)
    Xr = torch.view_as_real(X)
    Xp = torch.gather(Xr, -2, peaks[..., None].expand(*peaks.shape, 2))
    Y = torch.zeros(*X.shape[:-1], nf + 1, 2, dtype=torch.float32,
                    device=X.device)
    for d in range(-neigh, neigh + 1):
        w = float(np.float32(1.0 - (abs(d) / (neigh + 1))))
        kk = k2 + d
        ok = (kk >= 1) & (kk < nf)
        ordered_scatter_add(Y, torch.where(ok, kk, nf),
                            torch.where(ok[..., None], Xp * w, 0.0), rank,
                            top_n if passes is None else passes)
    Y = Y[..., :nf, :] + 0.12 * Xr
    return torch.view_as_complex(Y.contiguous())


def partial_lock_stretch(x: torch.Tensor, factor, top_n: int = 24,
                         neighborhood: int = 4, n_fft: int | None = None,
                         passes: int | None = None) -> torch.Tensor:
    """Peak-locked stretch (spectral.py:381); identity below 64 samples
    with n_fft and where factor is 1."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 64:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    factor = _f32(factor, x.device)
    X = exact_dft.rfft_n(x, nfft)
    y = exact_dft.irfft_n(_lock_spectrum(X, factor, top_n, neighborhood,
                                         passes), nfft, out_len=L)
    return torch.where(torch.abs(factor - 1.0) < 1e-9, x, y)


def _cep_warp_mag(logmag: torch.Tensor, factor: float, n: int
                  ) -> torch.Tensor:
    """log |X| through the cepstrum, warped on the host quefrency grid,
    back to a magnitude (spectral.py:431-448, 494-503)."""
    cep = exact_dft.irfft_n(torch.complex(logmag, torch.zeros_like(logmag)),
                            n)
    cep2 = _lerp_grid(cep, _host_grid("cep", n, float(factor),
                                      str(logmag.device)))
    return detmath.rounded(torch.exp, exact_dft.rfft_n(cep2, n).real)


def cepstral_warp(x: torch.Tensor, factor, n_fft: int | None = None
                  ) -> torch.Tensor:
    """Cepstral envelope warp (spectral.py:411) with the relative floor
    max(|X|, 1e-4 * peak) of each grain; identity below 64 samples with
    n_fft.  A number ``factor`` warps on the f64 host grid."""
    L = x.shape[-1]
    if n_fft is not None and int(n_fft) < 64:
        return x
    nfft = int(n_fft) if n_fft is not None else L
    X = exact_dft.rfft_n(x, nfft)
    mag = detmath.rounded(torch.abs, X)
    floor = 1e-4 * torch.clamp_min(torch.amax(mag, dim=-1, keepdim=True),
                                   1e-30)
    logmag = detmath.rounded(torch.log, torch.maximum(mag, floor))
    if _is_number(factor):
        mag2 = _cep_warp_mag(logmag, factor, nfft)
    else:
        cep = exact_dft.irfft_n(
            torch.complex(logmag, torch.zeros_like(logmag)), nfft)
        t = torch.arange(nfft, dtype=torch.float32, device=x.device)
        t_in = t / torch.clamp_min(_f32(factor, x.device), 1e-12)
        mag2 = detmath.rounded(
            torch.exp, exact_dft.rfft_n(_lerp_uniform(cep, t_in), nfft).real)
    Y = detmath.rounded(torch.polar, mag2, detmath.rounded(torch.angle, X))
    return exact_dft.irfft_n(Y, nfft, out_len=L)


def grain_chain_exact(x: torch.Tensor, sr, n_fft: int, cutoff=None,
                      roll: float = 0.0, warp_power=None, cep_factor=None,
                      lock=None, stretch=None, lock_passes_: int | None = None
                      ) -> torch.Tensor:
    """The whole grain spectral chain (lowpass -> power warp -> cepstral
    warp -> partial or lock stretch) in one exact-length spectral pass
    (spectral.py:453): filter-zeroed bins stay exactly zero into the
    cepstral stage, whose floor is the reference's literal
    ``|X| + 1e-12``.  Stage guards at the static n: lowpass from 8,
    warps and lock from 16 / 64, stretch from 16.  ``lock`` is
    (top_n, neighborhood); ``lock_passes_`` bounds its scatters."""
    L = x.shape[-1]
    n = int(n_fft)
    if n < 8:
        return x
    X = exact_dft.rfft_n(x, n)

    if cutoff is not None:
        X = X * _lowpass_gain(n, sr, cutoff, roll, device=x.device)

    if warp_power is not None and n >= 16:
        X = _warp_spectrum(X, warp_power)

    if cep_factor is not None and n >= 64:
        mag = detmath.rounded(torch.abs, X)
        mag2 = _cep_warp_mag(detmath.rounded(torch.log, mag + 1e-12),
                             cep_factor, n)
        den = mag + 1e-30
        Xr = torch.view_as_real(X)
        ph = torch.where((mag > 0)[..., None],
                         Xr / den[..., None],
                         torch.tensor([1.0, 0.0], device=x.device))
        X = torch.view_as_complex((ph * mag2[..., None]).contiguous())

    if lock is not None and n >= 64:
        top_n, neigh = lock
        factor = _f32(stretch, x.device)
        Y = _lock_spectrum(X, factor, top_n, neigh, lock_passes_)
        X = torch.where(torch.abs(factor - 1.0) < 1e-9, X, Y)
    elif stretch is not None and n >= 16:
        factor = _f32(stretch, x.device)
        Y = _lerp_affine(X, 1.0 / torch.clamp_min(factor, 1e-12))
        X = torch.where(torch.abs(factor - 1.0) < 1e-9, X, Y)

    return exact_dft.irfft_n(X, n, out_len=L)


def multiband_unfold(x: torch.Tensor, gen_sr, bands_out_hz, unfolds,
                     roll_hz: float = 0.0, n_fft: int | None = None
                     ) -> torch.Tensor:
    """Multi-band unfold (spectral.py:532): each output band (lo, hi) is
    the bandpass at (lo * u, hi * u) of the design rate; the bands are
    summed in order."""
    out = None
    for (lo_out, hi_out), u in zip(bands_out_hz, unfolds):
        band = bandpass_fft(x, gen_sr, float(lo_out) * float(u),
                            float(hi_out) * float(u), roll=roll_hz,
                            n_fft=n_fft)
        out = band if out is None else out + band
    return out if out is not None else x


def stft_mag_db(x, sr: int, win: int = 2048, hop: int = 256,
                max_frames: int = 3000, device=None) -> torch.Tensor:
    """Framed rfft magnitude in dB, [win//2 + 1, frames], for analysis
    views (spectral.py:547)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = x.shape[0]
    w = torch.tensor(np.hanning(win) if win > 1 else np.ones(win),
                     dtype=torch.float32, device=x.device)
    if n < win:
        pad = torch.zeros(win, dtype=torch.float32, device=x.device)
        pad[:n] = x * w[:n] if n > 1 else x
        X = torch.fft.rfft(pad)
        return 20.0 * torch.log10(torch.clamp_min(torch.abs(X), 1e-12))[:,
                                                                         None]
    frames = min(1 + (n - win) // hop, max_frames)
    idx = torch.arange(frames, device=x.device)[:, None] * hop \
        + torch.arange(win, device=x.device)[None, :]
    X = torch.fft.rfft(x[idx] * w[None, :], dim=-1)
    return (20.0 * torch.log10(torch.clamp_min(torch.abs(X), 1e-12))).T


def spectral_imprint_scan(mags: torch.Tensor, amount: float,
                          smooth: float) -> torch.Tensor:
    """SpectralImprint memory across an event sequence (spectral.py:567):
    mem_0 = mag_0, mem_i = smooth * mem_{i-1} + (1 - smooth) * mag_i, in
    event order (the JAX package evaluates the same recurrence as an
    associative scan, whose products round in another order).  Returns
    (1 - amount) * mag + amount * mem, [E, nf]."""
    sm = float(np.float32(smooth))
    one_m = float(np.float32(1.0) - np.float32(smooth))
    mem = torch.empty_like(mags)
    mem[0] = mags[0]
    for e in range(1, mags.shape[0]):
        mem[e] = sm * mem[e - 1] + one_m * mags[e]
    amt = float(np.float32(amount))
    return float(np.float32(1.0) - np.float32(amount)) * mags + amt * mem

"""Space FX — port of audio_suite_tpu/ops/space.py: partitioned FFT
convolution, the early-reflection tap kernel and the Jacobi-Anger stereo
diffusion (host NumPy parts are ported too, since the JAX module imports
jax), soft clip and normalize.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import detmath, exact_dft


def fft_convolve_causal(x: torch.Tensor, kernel: torch.Tensor,
                        block: int = 1 << 17) -> torch.Tensor:
    """y[:len(x)] of np.convolve(x, kernel) by overlap-add partitioned FFT
    (space.py:21), f32 [N].  The hop is exactly nfft/2, so each output
    sample gets contributions from two frames: a reshape and one shifted
    add.

    The transforms run in f64 (the JAX package's in f32).  The soft clip
    after this convolution multiplies its round-off by the loudness of
    the mix: at the reference app's factory settings a dense mix peaks
    30-40 dB above the clip, which turned f32 round-off of -128 dB into
    -96 dBFS between the card's cuFFT and the CPU's FFT; in f64 the
    convolution is exact to f32 on both."""
    N = x.shape[0]
    K = kernel.shape[0]
    if K == 0:
        return torch.zeros_like(x, dtype=torch.float32)
    x = x.to(torch.float64)
    kernel = kernel.to(torch.float64)
    nfft = 1
    while nfft < max(2 * (K - 1), min(2 * block, 2 * N, 1 << 16), 16):
        nfft *= 2
    hop = nfft // 2                     # K - 1 <= hop by construction
    nblocks = (N + hop - 1) // hop
    frames = F.pad(x, (0, nblocks * hop - N)).reshape(nblocks, hop)
    Kf = exact_dft.rfft_n(F.pad(kernel, (0, nfft - K)), nfft)
    Y = exact_dft.irfft_n(exact_dft.rfft_n(F.pad(frames, (0, nfft - hop)),
                                           nfft) * Kf, nfft)
    # out[b*hop : (b+1)*hop] = Y[b, :hop] + Y[b-1, hop:]
    h2 = F.pad(Y[:-1, hop:], (0, 0, 1, 0))
    return (Y[:, :hop] + h2).reshape(-1)[:N].to(torch.float32)


def er_tap_kernel(taps: int, max_ms: float, sr: int, seed: int) -> np.ndarray:
    """Host: the reflection cloud's tap kernel (space.py:61): delays
    U(0.3, max_ms) ms and gains U(-1, 1) * e^{-42 d} from rng(seed + 202),
    and an identity tap at 0 for the dry copy."""
    rng = np.random.default_rng(int(seed) + 202)
    delays = rng.uniform(0.3, max_ms, size=int(max(1, taps))) / 1000.0
    gains = rng.uniform(-1.0, 1.0, size=delays.size)
    gains *= np.exp(-delays * 42.0)
    k = np.zeros(int(round(max_ms / 1000.0 * sr)) + 2, np.float64)
    k[0] = 1.0
    for d, g in zip(delays, gains):
        off = int(round(d * sr))
        if 0 < off < len(k):
            k[off] += g
    return k.astype(np.float32)


def _bessel_j(m: int, phi: float) -> float:
    """J_m(phi) by its power series, in f64 (space.py:80)."""
    m = abs(int(m))
    term = (phi / 2.0) ** m / math.factorial(m)
    total = term
    for s in range(1, 24):
        term *= -(phi / 2.0) ** 2 / (s * (s + m))
        total += term
    return total


@lru_cache(maxsize=32)
def _diffusion_taps(phi: float) -> tuple:
    """The widener's phase rotation exp(i*phi*sin(4*pi*k/n)) as its exact
    Jacobi-Anger sparse circular FIR sum_m J_m(phi) * shift(2m)
    (space.py:93).  Returns ((offset, w), ...) with f32-rounded weights."""
    taps = []
    for m in range(-16, 17):
        # J_{-m} = (-1)^m J_m
        w = _bessel_j(m, phi) * (-1.0 if (m < 0 and (m % 2) != 0) else 1.0)
        if abs(w) >= 1e-12:
            taps.append((2 * m, float(np.float32(w))))
    return tuple(taps)


def spectral_diffusion_stereo(x: torch.Tensor, sr: int, width: float = 0.6
                              ) -> torch.Tensor:
    """Stereo widener (space.py:109): circular delays of both channels and
    the right channel's phase rotation as a sparse FIR.  Returns [N, 2]."""
    width = float(np.clip(width, 0.0, 1.0))
    n = x.shape[0]
    if n < 64:
        return torch.stack([x, x], dim=-1)
    dl = int(round((1 + 7 * width) * 0.0005 * sr))
    dr = int(round((1 + 9 * width) * 0.0007 * sr))
    left = torch.roll(x, dl)
    right = torch.roll(x, -dr)
    r2 = torch.zeros_like(right)
    for off, w in _diffusion_taps(width * 0.9):
        r2 = r2 + w * torch.roll(right, -off)
    return torch.stack([left, r2], dim=-1)


def soft_clip(x: torch.Tensor, drive: float = 1.0) -> torch.Tensor:
    """tanh soft clip (space.py:131)."""
    drive = float(drive)
    if drive <= 0:
        return x
    return detmath.rounded(torch.tanh, x * drive) / float(np.tanh(drive))


def normalize(x: torch.Tensor, peak: float = 0.98) -> torch.Tensor:
    """Scale to peak, up or down (space.py:139); silence stays silent."""
    m = torch.max(torch.abs(x))
    return torch.where(m <= 0, x, x * (peak / torch.clamp_min(m, 1e-30)))


def normalize_masked(x: torch.Tensor, mask: torch.Tensor,
                     peak: float = 0.98) -> torch.Tensor:
    """normalize() of each row of x [..., L] with the peak taken over the
    masked (true-length) samples only (space.py:145)."""
    m = torch.amax(torch.abs(torch.where(mask, x, 0.0)), dim=-1,
                   keepdim=True)
    scale = float(np.float32(peak)) / torch.clamp_min(m, 1e-30)
    return torch.where(m <= 0, x, x * scale)

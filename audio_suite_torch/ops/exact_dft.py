"""Exact-length real FFTs — port of the rfft_n / irfft_n semantics of
audio_suite_tpu/ops/exact_dft.py:252-284 on torch.fft.

torch.fft (pocketfft on the CPU, cuFFT on the card) transforms any length
exactly, so the JAX package's MXU four-step and Bluestein plans, which exist
for the TPU, have no counterpart here.

An f32 transform runs in f64 and rounds once to complex64 / f32: cuFFT's
and the CPU's f32 transforms differ by a few ulps of the grain, while
their f64 results round to the same f32 (see ``detmath.rounded``).  An
f64 input stays f64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rfft_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """np.fft.rfft(x[..., :n]) at the exact length n.  ``x`` may be longer
    than n (padded grain buffers); samples at or beyond n are ignored.
    Returns complex64 [..., n//2 + 1] (complex128 for an f64 x)."""
    n = int(n)
    if x.dtype == torch.float64:
        return torch.fft.rfft(x[..., :n], n=n)
    return torch.fft.rfft(x[..., :n].to(torch.float64), n=n) \
        .to(torch.complex64)


def irfft_n(Z: torch.Tensor, n: int, out_len: int | None = None
            ) -> torch.Tensor:
    """np.fft.irfft(Z, n=n) at the exact length n, optionally zero-padded
    to ``out_len`` (the grain buffer length L); f32, or f64 for a
    complex128 Z.

    NumPy's and JAX's irfft ignore the imaginary parts of bin 0 and (for
    even n) bin n/2; cuFFT's C2R transform does not promise to, and the
    drawn grain spectra have non-zero imaginary parts there, so they are
    zeroed before the transform."""
    n = int(n)
    Zr = torch.view_as_real(Z).to(torch.float64, copy=True)
    Zr[..., 0, 1] = 0.0
    if n % 2 == 0:
        Zr[..., n // 2, 1] = 0.0
    y = torch.fft.irfft(torch.view_as_complex(Zr), n=n)
    if Z.dtype != torch.complex128:
        y = y.to(torch.float32)
    if out_len is not None and out_len > n:
        y = F.pad(y, (0, out_len - n))
    return y

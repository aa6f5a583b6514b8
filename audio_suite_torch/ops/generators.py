"""Microsound micro-event generators — port of
audio_suite_tpu/ops/generators.py, "Noise burst" mode only.

Every function renders a batch of events over the padded index grid
``i`` (int64 [L]); per-event values (``n``, ``seed``, ...) are tensors of
shape [E] and broadcast against it as [E, 1].
"""
from __future__ import annotations

import torch

from . import exact_dft, noise

# noise stream ids (framework-defined, shared with the JAX package)
STREAM_MAIN = 0
STREAM_TILT_IM = 5   # imaginary component of the drawn tilt-noise spectrum

NOISE_BURST = 2      # index of "Noise burst" in GEN_MODES


def edge_fade(i: torch.Tensor, n: torch.Tensor, frac: float = 0.01,
              min_fade: int = 8) -> torch.Tensor:
    """gen_basic's 1% edge fade (generators.py:42)."""
    fade = torch.clamp_min((frac * n.to(torch.float32)).to(torch.int64),
                           min_fade)
    ff = fade.to(torch.float32)
    up = i.to(torch.float32) / ff
    down = (n - i).to(torch.float32) / ff
    w = torch.where(i < fade, up, torch.ones_like(up))
    return torch.where(i >= n - fade, down, w)


def _tilted_noise(n: torch.Tensor, seed: torch.Tensor, tilt_db_per_oct: float,
                  L: int, n_fft: int) -> torch.Tensor:
    """Spectrally tilted Gaussian noise (generators.py:86): the spectrum of
    n_fft white Gaussian samples is drawn directly from counter noise on
    the exact bin grid, tilted, and inverted at exactly n_fft; zero-padded
    to L.  n, seed: [E, 1]."""
    nf = n_fft // 2 + 1
    k = torch.arange(nf, dtype=torch.int64, device=n.device)
    wr = noise.normal(seed, k, STREAM_MAIN)
    wi = noise.normal(seed, k, STREAM_TILT_IM)
    r = k.to(torch.float32)
    r[0] = 1.0
    tilt = torch.tensor(tilt_db_per_oct, dtype=torch.float32)
    alpha = torch.log2(torch.tensor(10.0, dtype=torch.float32)
                       ** (tilt / 20.0)).to(n.device)
    g = (r ** alpha) * torch.sqrt(0.5 * n.to(torch.float32))
    W = torch.complex(wr * g, wi * g)
    return exact_dft.irfft_n(W, n_fft, out_len=L)


def gen_basic(i: torch.Tensor, n: torch.Tensor, seed: torch.Tensor,
              inv_gen_sr: torch.Tensor, micro_ms: float, mode_id: int,
              noise_tilt: float, n_fft: int) -> torch.Tensor:
    """gen_basic (generators.py:120-173) for mode 2, "Noise burst": tilted
    noise under an exponential decay, edge-faded, zero beyond n.

    i: int64 [L]; n, seed: int [E]; inv_gen_sr: f32 [E].  Returns f32 [E, L].
    """
    if mode_id != NOISE_BURST:
        raise NotImplementedError(
            f"generator mode {mode_id}: only 'Noise burst' is ported "
            "(ROADMAP queue 4, microsound generator modes)")
    L = i.shape[0]
    n = n.to(torch.int64)[:, None]
    # t by the host-computed reciprocal, as the JAX package does: a
    # vectorized divide may round differently from IEEE division
    t = i.to(torch.float32) * inv_gen_sr.to(torch.float32)[:, None]
    micro_s = torch.tensor(micro_ms, dtype=torch.float32) / 1000.0
    tau = float(torch.clamp_min(micro_s * 0.25, 1e-6))
    tn = _tilted_noise(n, seed[:, None], noise_tilt, L, n_fft)
    x = tn * torch.exp(-t / tau)
    x = x * edge_fade(i, n)
    return torch.where(i < n, x, 0.0)

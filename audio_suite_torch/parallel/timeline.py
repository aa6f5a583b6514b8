"""Timeline sharding: one long render split over the devices of a mesh —
port of audio_suite_tpu/parallel/timeline.py.

The core primitive is CAUSAL FIR CONVOLUTION (the Microsound IR / early-
reflection path, ``ops/space.fft_convolve_causal``) over a signal whose
time axis is split over a mesh axis.  Each shard convolves its own block
with the kernel on its device; the tail that spills past the block's end
goes to the shards on its right with ``ppermute``, one hop a block of
tail, and is added to their heads.  A tail never wraps onto the start of
the timeline.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.space import fft_convolve_causal
from .batch import Mesh, ppermute


def _local_conv(xb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """The full linear convolution of one block, length block + K - 1, by
    one power-of-two FFT (timeline.py:39-46).  The transforms run in f64
    and round once to f32, as the port's ``space.fft_convolve_causal``
    does."""
    full_len = xb.shape[0] + kb.shape[0] - 1
    nfft = 1
    while nfft < full_len:
        nfft *= 2
    X = torch.fft.rfft(xb.to(torch.float64), n=nfft)
    Kf = torch.fft.rfft(kb.to(torch.float64), n=nfft)
    return torch.fft.irfft(X * Kf, n=nfft)[:full_len].to(torch.float32)


def sharded_fir_conv(x, kernel, mesh: Mesh, axis: str = "dp"
                     ) -> torch.Tensor:
    """y[:len(x)] of np.convolve(x, kernel) with x's time axis split over
    ``mesh[axis]``.  x: f32[N] (N divisible by the axis size), kernel:
    f32[K], host arrays or tensors.  Returns y, the blocks concatenated in
    shard order on the axis's first device."""
    devs = mesh.axis_devices(axis)
    n_dev = len(devs)
    x = torch.as_tensor(x, dtype=torch.float32)
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    N, K = x.shape[0], kernel.shape[0]
    if N % n_dev != 0:
        raise ValueError(f"N={N} must divide over {n_dev} devices")
    block = N // n_dev
    hops = (K - 1) // block + 1 if K > 1 else 0

    ys, tails = [], []
    for i, d in enumerate(devs):
        Y = _local_conv(x[i * block:(i + 1) * block].to(d), kernel.to(d))
        ys.append(Y[:block])
        # the K - 1 spill, padded to a whole number of blocks
        tails.append(F.pad(Y[block:], (0, hops * block - (K - 1))))
    for h in range(hops):
        seg = [t[h * block:(h + 1) * block] for t in tails]
        # segment h goes h + 1 blocks right; what would wrap is dropped
        shifted = ppermute(seg, [(i, i + h + 1)
                                 for i in range(n_dev - h - 1)])
        ys = [y if i < h + 1 else y + s
              for i, (y, s) in enumerate(zip(ys, shifted))]
    return torch.cat([y.to(devs[0]) for y in ys])


def sharded_conv_reference(x, kernel, *, device="cuda") -> torch.Tensor:
    """The single-device reference: ``space.fft_convolve_causal`` on
    ``device``."""
    return fft_convolve_causal(
        torch.as_tensor(x, dtype=torch.float32, device=device),
        torch.as_tensor(kernel, dtype=torch.float32, device=device))

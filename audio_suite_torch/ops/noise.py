"""Counter-based deterministic noise — port of audio_suite_tpu/ops/noise.py.

A stateless murmur3-finalizer hash of (seed, index, stream) gives uniforms,
and Irwin-Hall(12) sums of them give Gaussians; bit-identical to the JAX
package and its NumPy twins.

PyTorch has no usable uint32 arithmetic, so the hash runs on int64 values
kept in [0, 2**32).  A product of two 32-bit values can reach 2**64 and
overflow int64, so every multiply by a 32-bit constant is split into its
16-bit halves: ``h * M == h * M_lo + ((h * M_hi) mod 2**16) << 16
(mod 2**32)``, with every intermediate below 2**49.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_INV24 = 1.0 / (1 << 24)    # exact in f32


def _as_u32(x, device) -> torch.Tensor:
    """x as int64 holding its uint32 value (negative ints wrap, as
    jnp.asarray(x, jnp.uint32) does)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK32


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for h in [0, 2**32) and a 32-bit constant m."""
    lo = h * (m & _MASK16)
    hi = ((h * (m >> 16)) & _MASK16) << 16
    return (lo + hi) & _MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_u32(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """uint32 hash of (seed, idx, stream), as int64 values in [0, 2**32).
    Arguments broadcast; seed and stream may be ints or tensors on idx's
    device."""
    device = idx.device
    h = (_mul32(_as_u32(seed, device), _GOLDEN)
         + _mul32(_as_u32(idx, device), _M1)
         + _mul32(_as_u32(stream, device), _M2)) & _MASK32
    return _mix(h)


def uniform(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """f32 uniform in [0, 1): top 24 bits * 2**-24 (exact scale)."""
    h = hash_u32(seed, idx, stream)
    return (h >> 8).to(torch.float32) * _INV24


def normal(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """Irwin-Hall(12) standard normal: the 12 uniforms are summed left to
    right in f32, then 6 is subtracted — the JAX package's order."""
    acc = None
    for k in range(12):
        u = uniform(seed, idx, stream * 12 + k + 1)
        acc = u if acc is None else acc + u     # 0 + u == u: u >= 0
    return acc - 6.0


# NumPy twins (copies of the JAX package's), for the scrub's host
# increment twin (models/scrub.py:_inc_np)

def hash_u32_np(seed, idx, stream=0):
    seed = np.asarray(seed, np.uint32)
    idx = np.asarray(idx, np.uint32)
    stream = np.asarray(stream, np.uint32)
    m1, m2 = np.uint32(_M1), np.uint32(_M2)
    with np.errstate(over="ignore"):
        h = seed * np.uint32(_GOLDEN) + idx * m1 + stream * m2
        h = h ^ (h >> np.uint32(16))
        h = h * m1
        h = h ^ (h >> np.uint32(13))
        h = h * m2
        h = h ^ (h >> np.uint32(16))
    return h


def uniform_np(seed, idx, stream=0):
    return ((hash_u32_np(seed, idx, stream) >> np.uint32(8))
            .astype(np.float32) * np.float32(_INV24))


def normal_np(seed, idx, stream=0):
    acc = np.zeros(np.broadcast_shapes(np.shape(seed), np.shape(idx)),
                   np.float32)
    for k in range(12):
        acc = acc + uniform_np(seed, idx, stream * 12 + k + 1)
    return (acc - np.float32(6.0)).astype(np.float32)

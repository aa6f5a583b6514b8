"""Counter-based deterministic noise — port of audio_suite_tpu/ops/noise.py.

A stateless murmur3-finalizer hash of (seed, index, stream) gives uniforms,
and Irwin-Hall(12) sums of them give Gaussians; bit-identical to the JAX
package and its NumPy twins.

PyTorch has no usable uint32 arithmetic, so the hash runs on int64 values
kept in [0, 2**32).  A product of two 32-bit values can reach 2**64 and
overflow int64, so every multiply by a 32-bit constant is split into its
16-bit halves: ``h * M == h * M_lo + ((h * M_hi) mod 2**16) << 16
(mod 2**32)``, with every intermediate below 2**49.

The hash is ``mix(seed*GOLDEN + idx*M1 + stream*M2 mod 2**32)``.  Its first
two terms are the per-index *key* (``cell_key``): a caller that draws many
streams over one index grid (a CA step, the 12 uniforms of a ``normal``)
computes the key once and hashes each stream from it (the ``*_key``
draws).  A seed or stream given as a Python int is reduced mod 2**32 and
multiplied on the host: only tensors reach the device, and no host value
is copied to it.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
_MASK8 = 0xFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_INV24 = 1.0 / (1 << 24)    # exact in f32
_INV16 = 1.0 / (1 << 16)    # exact in f32
_IH4_SCALE = float(np.float32(np.sqrt(3.0) / 256.0))


def _as_u32(x, device):
    """x's uint32 value (negative values wrap, as jnp.asarray(x, jnp.uint32)
    does): a tensor becomes int64 on ``device``; a Python or NumPy scalar
    stays a Python int, reduced on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK32
    if np.ndim(x) == 0:
        return int(x) & _MASK32
    return torch.as_tensor(np.asarray(x), device=device).to(torch.int64) \
        & _MASK32


def _mul32(h, m: int):
    """(h * m) mod 2**32 for h in [0, 2**32) and a 32-bit constant m; a
    Python int h is multiplied on the host."""
    if not isinstance(h, torch.Tensor):
        return (h * m) & _MASK32
    lo = h * (m & _MASK16)
    hi = ((h * (m >> 16)) & _MASK16) << 16
    return (lo + hi) & _MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def cell_key(seed, idx: torch.Tensor) -> torch.Tensor:
    """The per-index part of the hash, ``(seed*GOLDEN + idx*M1) mod 2**32``,
    as int64 on idx's device (seed: an int or a tensor that broadcasts)."""
    device = idx.device
    return (_mul32(_as_u32(seed, device), _GOLDEN)
            + _mul32(_as_u32(idx, device), _M1)) & _MASK32


def hash_key(key: torch.Tensor, stream=0) -> torch.Tensor:
    """``hash_u32`` from a precomputed ``cell_key``: exactly
    ``hash_u32(seed, idx, stream)``."""
    return _mix((key + _mul32(_as_u32(stream, key.device), _M2)) & _MASK32)


def hash_u32(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """uint32 hash of (seed, idx, stream), as int64 values in [0, 2**32).
    Arguments broadcast; seed and stream may be ints or tensors on idx's
    device."""
    return hash_key(cell_key(seed, idx), stream)


def uniform_key(key: torch.Tensor, stream=0) -> torch.Tensor:
    """``uniform`` from a precomputed ``cell_key``."""
    return (hash_key(key, stream) >> 8).to(torch.float32) * _INV24


def uniform(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """f32 uniform in [0, 1): top 24 bits * 2**-24 (exact scale)."""
    return uniform_key(cell_key(seed, idx), stream)


def uniform_signed(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """f32 uniform in [-1, 1): ``uniform * 2 - 1``, both steps exact."""
    return uniform(seed, idx, stream) * 2.0 - 1.0


def uniform_pair_key(key: torch.Tensor, stream=0):
    """``uniform_pair`` from a precomputed ``cell_key``."""
    h = hash_key(key, stream)
    return ((h >> 16).to(torch.float32) * _INV16,
            (h & _MASK16).to(torch.float32) * _INV16)


def uniform_pair(seed, idx: torch.Tensor, stream=0):
    """TWO f32 uniforms in [0, 1) from ONE hash: its hi and lo 16 bits
    (granularity 2**-16: not for rare events)."""
    return uniform_pair_key(cell_key(seed, idx), stream)


def normal_ih4_key(key: torch.Tensor, stream=0) -> torch.Tensor:
    """``normal_ih4`` from a precomputed ``cell_key``."""
    h = hash_key(key, stream)
    s = ((h & _MASK8) + ((h >> 8) & _MASK8)
         + ((h >> 16) & _MASK8) + (h >> 24))
    return (s.to(torch.float32) - 510.0) * _IH4_SCALE


def normal_ih4(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """Approximate standard normal from ONE hash: Irwin-Hall(4) over its
    four bytes, centered and scaled by sqrt(3)/256 (the integer sum is
    exact in f32, then one rounding)."""
    return normal_ih4_key(cell_key(seed, idx), stream)


def normal_key(key: torch.Tensor, stream=0) -> torch.Tensor:
    """``normal`` from a precomputed ``cell_key``: the 12 uniforms share
    it; their streams ``stream * 12 + k + 1`` wrap at 2**32, as JAX's
    uint32 arithmetic does."""
    s = _as_u32(stream, key.device)
    acc = None
    for k in range(12):
        u = uniform_key(key, (s * 12 + k + 1) & _MASK32)
        acc = u if acc is None else acc + u     # 0 + u == u: u >= 0
    return acc - 6.0


def normal(seed, idx: torch.Tensor, stream=0) -> torch.Tensor:
    """Irwin-Hall(12) standard normal: the 12 uniforms are summed left to
    right in f32, then 6 is subtracted — the JAX package's order."""
    return normal_key(cell_key(seed, idx), stream)


# NumPy twins (copies of the JAX package's): the scrub's host increment
# twin (models/scrub.py:_inc_np) and the forest fire's tests

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


def uniform_signed_np(seed, idx, stream=0):
    return uniform_np(seed, idx, stream) * np.float32(2.0) - np.float32(1.0)


def uniform_pair_np(seed, idx, stream=0):
    h = hash_u32_np(seed, idx, stream)
    return (((h >> np.uint32(16)).astype(np.float32) * np.float32(_INV16)),
            ((h & np.uint32(_MASK16)).astype(np.float32)
             * np.float32(_INV16)))


def normal_ih4_np(seed, idx, stream=0):
    h = hash_u32_np(seed, idx, stream)
    m8 = np.uint32(_MASK8)
    s = ((h & m8) + ((h >> np.uint32(8)) & m8)
         + ((h >> np.uint32(16)) & m8) + (h >> np.uint32(24)))
    return ((s.astype(np.float32) - np.float32(510.0))
            * np.float32(_IH4_SCALE)).astype(np.float32)


def normal_np(seed, idx, stream=0):
    acc = np.zeros(np.broadcast_shapes(np.shape(seed), np.shape(idx)),
                   np.float32)
    for k in range(12):
        acc = acc + uniform_np(seed, idx, stream * 12 + k + 1)
    return (acc - np.float32(6.0)).astype(np.float32)

"""JAX's threefry2x32 PRNG in PyTorch, bit-exact with ``jax.random``.

The JAX package's device grid cells (``plugins/jax_cells.py``) draw with
``jax.random``; their twins here (``plugins/torch_cells.py``) draw the same
numbers.  ``jax.random``'s default implementation is threefry2x32 with
``jax_threefry_partitionable=True`` (the default from JAX 0.5), and these
functions follow those paths:

- ``prng_key(seed)`` is ``PRNGKey(seed)``: the key ``(0, seed mod 2**32)``;
- ``split(key, num)`` hashes the 64-bit counters ``0 .. num - 1`` (high
  words 0, low words the iota): key ``i`` is the hash's two words at ``i``;
- ``bits(key, shape)`` hashes the counters ``0 .. prod(shape) - 1`` the
  same way and XORs the two words;
- ``uniform`` puts the top 23 bits of ``bits`` into the mantissa of a
  float in [1, 2), subtracts 1, scales to [minval, maxval) with one
  rounding (XLA's fused multiply-add) and clamps at minval; ``bernoulli(key, p)`` is ``uniform < p`` in f32;
- ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  [nextafter(-1, 0), 1).

PyTorch has no usable uint32 arithmetic, so the 32-bit words are held in
int64 and masked to [0, 2**32) after each add and shift, as
``ops/noise.py`` does for its hash.  The bits, uniforms and gates are
bit-equal to JAX's.  ``erf_inv`` is XLA's f32 approximation (M. Giles'
polynomials in w = -log1p(-x**2)); its Horner steps round once each, as
the fused multiply-adds of XLA's CPU code do, so the normals are within a
few ulps of JAX's CPU draws: the log's last bit can differ.

Keys are pairs of Python ints: ``split`` hashes on the host (two counters),
and only ``bits`` and the draws built on it run on ``device``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000
_NMANT = 23
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's ErfInv32 coefficients, highest degree first (w < 5, then w >= 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _MASK32) | (v >> (32 - r))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash of the counter words (x1, x2), int64 tensors
    of uint32 values, under the key (k1, k2): its two output words."""
    ks = (k1 & _MASK32, k2 & _MASK32, (k1 ^ k2 ^ _PARITY) & _MASK32)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (64-bit types off, JAX's default) as a
    pair of ints: ``(0, seed mod 2**32)`` for a seed of 32 bits, signed or
    not; a wider seed overflows there, and here."""
    seed = int(seed)
    if not -(1 << 31) <= seed <= _MASK32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return 0, seed & _MASK32


def _hash_iota(key, n: int, device):
    if n >= 1 << 32:
        raise ValueError(f"{n} draws: the counters' high words would be used")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as a list of key pairs."""
    w1, w2 = _hash_iota(key, int(num), "cpu")
    return list(zip(w1.tolist(), w2.tolist()))


def _shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(shape)


def bits(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values on
    ``device``."""
    shape = _shape(shape)
    w1, w2 = _hash_iota(key, math.prod(shape), device)
    return (w1 ^ w2).reshape(shape)


def uniform(key, shape, device="cuda", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    b = bits(key, shape, device)
    f = ((b >> (32 - _NMANT)) | _ONE_F32_BITS).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # f * (hi - lo) + lo rounded once, as XLA's CPU code fuses it: the
    # product is exact in f64
    y = (f.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(y, float(lo))


def bernoulli(key, p: float, shape, device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float p (f32)."""
    return uniform(key, shape, device) < float(np.float32(p))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``; each Horner step rounds once (in f64, where
    the product is exact), as XLA's CPU code fuses it."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    c = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0].double()
    for ci in c[1:]:
        p = (ci + p * w).float().double()
    r = p.float() * x
    return torch.where(x.abs() == 1.0, x * math.inf, r)


def normal(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(key, shape, device, _NORMAL_LO, 1.0)
    return erf_inv(u) * _SQRT2_F32

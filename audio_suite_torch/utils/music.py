"""Music math (host side) — the port's copy of
audio_suite_tpu/utils/music.py (pattern lab 0.1/app/music.py).

Pattern generation is control-rate host work that emits note events; only
the bit quantizer has a device twin (``ops/synth.py:quantize_to_bits``).
Same algorithms and integer math as the original, which
``tests/test_torch_patternlab.py`` holds it against."""
from __future__ import annotations

import numpy as np

A4 = 440.0


def midi_to_hz(m: float, a4: float = A4) -> float:
    """app/music.py:6-7"""
    return float(a4 * (2.0 ** ((m - 69.0) / 12.0)))


def pythagorean_ratio(steps: int) -> float:
    """Fifth-ratio folding into [1, 2) (app/music.py:10-21)."""
    ratio = (3.0 / 2.0) ** steps
    while ratio >= 2.0:
        ratio *= 0.5
    while ratio < 1.0:
        ratio *= 2.0
    return float(ratio)


def primes_upto(n: int) -> list[int]:
    """Sieve (app/music.py:24-32)."""
    if n < 2:
        return []
    sieve = np.ones(n + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p:n + 1:p] = False
    return [int(i) for i in np.nonzero(sieve)[0].tolist()]


def fibonacci(n: int) -> list[int]:
    """app/music.py:35-42 (1, 1, 2, 3, ...)"""
    if n <= 0:
        return []
    a, b = 1, 1
    out = [a]
    for _ in range(n - 1):
        a, b = b, a + b
        out.append(a)
    return out


def euclidean_rhythm(steps: int, pulses: int, rotate: int = 0) -> np.ndarray:
    """Bjorklund algorithm returning a 0/1 gate array (app/music.py:45-86)."""
    steps = int(max(1, steps))
    pulses = int(np.clip(pulses, 0, steps))
    if pulses == 0:
        pat = np.zeros(steps, dtype=np.int32)
    elif pulses == steps:
        pat = np.ones(steps, dtype=np.int32)
    else:
        pattern: list[int] = []
        counts: list[int] = []
        remainders: list[int] = []
        divisor = steps - pulses
        remainders.append(pulses)
        level = 0
        while True:
            counts.append(divisor // remainders[level])
            remainders.append(divisor % remainders[level])
            divisor = remainders[level]
            level += 1
            if remainders[level] <= 1:
                break
        counts.append(divisor)

        def build(level_: int):
            if level_ == -1:
                pattern.append(0)
            elif level_ == -2:
                pattern.append(1)
            else:
                for _ in range(counts[level_]):
                    build(level_ - 1)
                if remainders[level_] != 0:
                    build(level_ - 2)

        build(level)
        pat = np.array(pattern[:steps], dtype=np.int32)

    if rotate != 0:
        rotate = int(rotate) % steps
        pat = np.roll(pat, rotate)
    return pat


def quantize_to_bits_np(x: np.ndarray, bits: int) -> np.ndarray:
    """Symmetric quantization to +/-1 (app/music.py:89-94), in the
    reference's f64 promotion: the music-math API's quantizer."""
    levels = 2 ** (bits - 1)
    y = np.clip(x, -1.0, 1.0)
    yq = np.round(y * (levels - 1)) / (levels - 1)
    return yq.astype(np.float32)


def quantize_to_bits_f32_np(x: np.ndarray, bits: int) -> np.ndarray:
    """Bit-exact NumPy twin of ops/synth.quantize_to_bits: all-f32 op
    sequence with a reciprocal multiply."""
    lm1 = 2 ** (bits - 1) - 1
    inv = np.float32(1.0 / float(lm1))
    y = np.clip(np.asarray(x, np.float32), np.float32(-1.0), np.float32(1.0))
    return (np.round(y * np.float32(lm1)) * inv).astype(np.float32)

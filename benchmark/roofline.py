"""The chip's peaks and the kernels' least work, for roofline shares.

A kernel's bound is the larger of its bytes over the memory rate and its
f32 operations over the f32 rate: each input byte read once, each output
byte written once, whatever the kernel reads again.  A share is that bound
over the kernel's profiled time.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "f32_flop_s": 67e12},
}

# f32 operations a sample of the stick-slip kernel that draws its own
# noise does: the step's 9 (its terms, the force's add, compare, select,
# multiply) and its two Irwin-Hall(12) normals' 26 (11 adds, a scale and
# the - 6 each).
STICK_SLIP_FLOPS = 35


def peaks(device_name: str) -> dict:
    """The peaks of the card by its name (an H100 of another memory
    configuration has none here)."""
    return PEAKS.get(device_name, {})


def bound_s(nbytes: float, flops: float, pk: dict) -> float:
    return max(nbytes / pk["hbm_bytes_s"], flops / pk["f32_flop_s"])


def overlap_add_bytes(E: int, Lw: int, N: int) -> int:
    """overlap_add.cu: the windows f32 [E, Lw] and the starts i32 [E] read
    once, the buffer f32 [N] read and written once."""
    return 4 * E * Lw + 4 * E + 8 * N


def stick_slip_bytes(E: int, L: int) -> int:
    """grain_scan.cu's stick-slip with its noise drawn inside: the seeds
    i32 [E] read, the rows f32 [E, L] written."""
    return 4 * E + 4 * E * L


def stick_slip_flops(E: int, L: int) -> int:
    return STICK_SLIP_FLOPS * E * L


def share(run, record: tuple, kernel: str, work) -> float | None:
    """A kernel's share of its roofline in the run's profiled slice, in %:
    the bounds of its launches (``work(*shape)`` gives (bytes, flops) of
    the shape its ``record`` recorder kept) over its events' profiled
    time, summed.  Launches and events pair in order from the slice's end
    (the profiler may drop a window's first events).  None where the slice,
    the card's peaks, the launches or the events are missing."""
    sl, pk = run.slice, peaks(run.device_name)
    if not sl or not pk:
        return None
    calls = sl.records.get(".".join(record[:2]), [])
    ops = sorted(sl.ops_named(kernel), key=lambda op: op[1])
    n = min(len(calls), len(ops))
    if n == 0:
        return None
    bound = sum(bound_s(*work(*c), pk) for c in calls[-n:])
    return 100.0 * bound / sum(b - a for _, a, b in ops[-n:])

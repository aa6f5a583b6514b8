"""Device-computed Grid Audio cell generators — the port's twin of
audio_suite_tpu/plugins/jax_cells.py.

The same ``generate(sr, duration[, context])`` contract, the same ``sine``,
``glitch_slices`` and ``arpeggio``, and the same dispatch on
``cell_index % 3``; each returns a NumPy array, computed as a tensor on a
device and pulled once.  ``sine`` and ``arpeggio`` go through
``ops/detmath.sin_cycles``; ``glitch_slices`` draws with JAX's threefry,
ported bit-exact in ``ops/threefry.py`` (its gates equal JAX's, its normals
are within a few ulps).

Use as cells by path (this file works as a plugin: it defines generate()),
or import the individual functions.  A project on the card names this
file where a JAX project names ``jax_cells.py``, which needs ``jax``.

The device is ``context["device"]``, which the port's grid sets to its
render's device (``models/grid.py``), or ``"cuda"`` when the context lacks
it or there is none; the functions also take ``device=``.  The grid's
program memo (``grid.build_mix_program_cached``) is keyed on the project's
content and the render's device, so a render on the CPU never reuses
cells computed on the card.
"""
from __future__ import annotations

import numpy as np
import torch

try:
    from ..ops import detmath, threefry
except ImportError:
    # the plugin host loads this file as a standalone module (no package
    # context) — exactly like user cell scripts
    from audio_suite_torch.ops import detmath, threefry


def _device(context, device):
    if device is not None:
        return device
    return (context or {}).get("device", "cuda")


def _f32(v) -> float:
    return float(np.float32(v))


def sine(sr, duration, freq=440.0, gain=0.5, *, device="cuda"):
    n = int(round(sr * duration))
    # freq * (i * (1 / sr)), as XLA compiles it: the two scalars first
    cycles_per_sample = _f32(np.float32(freq) * np.float32(1.0 / int(sr)))
    x = torch.arange(n, dtype=torch.float32, device=device) \
        * cycles_per_sample
    y = _f32(gain) * detmath.sin_cycles(x)
    return y.cpu().numpy()


def glitch_slices(sr, duration, context=None, slices=16, seed=0, *,
                  device=None):
    # spectral-dust style texture: noise bursts gated by a shuffled slice
    # mask (examples/spectral_dust.py's idea)
    if context is not None:
        seed = int(seed) + int(context.get("cell_index", 0)) * 7919
    device = _device(context, device)
    n = int(round(sr * duration))
    slices = int(slices)
    k1, k2 = threefry.split(threefry.prng_key(int(seed)))
    x = _f32(0.4) * threefry.normal(k1, n, device)
    slice_len = max(1, n // slices)
    gates = threefry.bernoulli(k2, 0.45, slices + 1, device)
    g = gates.to(torch.float32).repeat_interleave(slice_len)[:n]
    pos = (torch.arange(n, device=device) % slice_len).to(torch.float32)
    env = torch.exp(-pos * _f32(6.0 / slice_len))
    return (x * g * env).cpu().numpy()


def arpeggio(sr, duration, context=None, root_hz=220.0,
             ratios=(1.0, 1.25, 1.5, 2.0), gain=0.4, *, device=None):
    device = _device(context, device)
    n = int(round(sr * duration))
    notes = [float(r) for r in ratios]
    step = max(1, n // max(1, len(notes)))
    i = torch.arange(n, device=device)
    k = torch.clamp_max(i // step, len(notes) - 1)
    r = torch.tensor(notes, dtype=torch.float32, device=device)[k]
    # per-step phase restart keeps pitches clean without clicks
    local = (i % step).to(torch.float32) * _f32(1.0 / int(sr))
    env = torch.exp(-local * 8.0)
    y = _f32(gain) * env * detmath.sin_cycles(_f32(root_hz) * r * local)
    return y.cpu().numpy()


def generate(sr, duration, context=None):
    """Default plugin entry: context-aware device-rendered cell."""
    if context is None:
        return sine(sr, duration)
    ci = int(context.get("cell_index", 0))
    if ci % 3 == 0:
        return arpeggio(sr, duration, context)
    if ci % 3 == 1:
        return glitch_slices(sr, duration, context)
    return sine(sr, duration, freq=220.0 * (1 + ci % 4),
                device=_device(context, None))

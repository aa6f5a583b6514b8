"""Varispeed tape playback on the device — port of the table engine of
audio_suite_tpu/ops/varispeed.py (``tape_device_render``, linear and sinc
reads).

The host (C++, utils/native_rt.py) reduces a render to compact control
tables: section visits with their entry positions, the inertia speed curve
as arithmetic-progression runs, and the splice trigger times.  The device
rebuilds every sample from them with integer math that is bit-identical
to the JAX package:

- ``_wow_flutter_device``: the wow/flutter speed modulation (detmath twins);
- ``tape_positions``: run expansion, fixed-point increments, the segmented
  position sum, the section read index and fraction, and the anti-click x
  splice gain;
- ``tape_device_render``: the linear read (``ops/lerp_read.py``, the CUDA
  kernel on the card) or the sinc read (``fixq.gather_sinc_clip``, plain
  PyTorch), gain, clip and PCM16.

The JAX package pads the tables to powers of two and the render to 32 768-
sample buckets only to avoid XLA recompiles; PyTorch runs eagerly, so the
port renders exactly T samples (the padding changes no sample below T).
Its blockwise one-hot read and detect-and-patch are TPU machinery and are
not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import detmath
from .fixq import (POS_FRAC_BITS, POS_INV_F, POS_ONE, gather_sinc_clip,
                   quantize_f32, round_sig12, segmented_pos_cumsum)
from .lerp_read import lerp_read

_INV = float(POS_INV_F)
_QUEUE6 = "ROADMAP queue 1 item 6, tape"


@dataclasses.dataclass(frozen=True)
class TapeConsts:
    """Static playback configuration; float fields hold exact f32 values
    (as Python floats), as in the JAX package."""
    anticlick_on: bool
    smooth_len: int                 # boundary_smooth_len (400)
    anticlick_strength: float       # 0.3 + 0.5 * amt/100, as f32 value
    splice_on: bool
    inertia_on: bool
    alpha_q: float                  # inertia one-pole coefficient, f32 value
    initial_speed_q: float          # quantized initial current_speed


def _read_index(whole, frac, sec_start, sec_end, rev):
    """Map a wrapped position to the interpolation index and fraction
    (Tape…py:823-836), including the reference's truncation toward zero in
    the reverse branch when the read position lands in (-1, 0): there the
    fraction is negative.  Returns (idx0 int32, fr f32)."""
    sec_len = sec_end - sec_start
    local_w = torch.remainder(whole - sec_start, sec_len)

    idx_f = sec_start + local_w                     # forward
    fr_f = frac.to(torch.float32) * _INV

    a = sec_end - 1 - local_w                       # reverse, before borrow
    has_frac = frac > 0
    idx_r = torch.where(has_frac, a - 1, a)
    fr_r = torch.where(has_frac, (POS_ONE - frac).to(torch.float32) * _INV,
                       0.0)
    neg = (a == 0) & has_frac
    idx_r = torch.where(neg, 0, idx_r)
    fr_r = torch.where(neg, -frac.to(torch.float32) * _INV, fr_r)

    return torch.where(rev, idx_r, idx_f), torch.where(rev, fr_r, fr_f)


def _boundary_min_dist(boundaries, idx0: torch.Tensor) -> torch.Tensor:
    """min |idx0 - b| over the (few) boundaries, a host sequence of ints."""
    d = torch.full_like(idx0, 2 ** 30)
    for b in boundaries:
        d = torch.minimum(d, torch.abs(idx0 - int(b)))
    return d


def _wow_flutter_device(T: int, mod_ints, mod_flts, phase0,
                        device) -> torch.Tensor:
    """Wow/flutter speed modulation f32[T] (models.tape.wow_flutter_mod's
    op sequence: exact integer phase reduction -> detmath sine -> 12-bit
    rounding -> exact-product depth scaling -> clip -> grid quantize)."""
    ints = [int(v) for v in np.asarray(mod_ints)]
    flts = [float(v) for v in np.asarray(mod_flts, np.float32)]
    ph0 = [float(v) for v in np.asarray(phase0, np.float32)]
    i = torch.arange(T, dtype=torch.int64, device=device)
    sw = round_sig12(detmath.sin_cycles(
        ph0[0] + detmath.phase_cycles(i, ints[0], ints[1], flts[0])))
    sf = round_sig12(detmath.sin_cycles(
        ph0[1] + detmath.phase_cycles(i, ints[2], ints[3], flts[1])))
    mod = 1.0 + flts[2] * sw + flts[3] * sf
    mod = torch.clamp(mod, float(np.float32(0.1)), 3.0)
    return quantize_f32(mod)


def tape_positions(tab: dict, consts: TapeConsts, n: int, T: int):
    """Per-sample read positions and gains of a tape render, rebuilt on
    the device from the control tables (the position part of the JAX
    package's tape_device_render, varispeed.py:956-1017).

    ``tab`` holds device tensors: ``mod_ints``/``mod_flts``/``phase0``
    (host arrays), int32 ``visit_start``/``visit_bw``/``visit_bf``/
    ``visit_sec``, ``run_start``/``run_s0``/``run_m``, the section tables
    ``starts``/``ends`` (int32) and ``reverse`` (bool), ``boundaries`` (host
    ints), int32 ``triggers`` and f32 ``splice_env``.  Returns (idx0 int32
    in [0, n), fr f32, gain f32), each [T]."""
    i32 = torch.int32
    dev = tab["visit_start"].device
    ii = torch.arange(T, dtype=i32, device=dev)

    mod = _wow_flutter_device(T, tab["mod_ints"], tab["mod_flts"],
                              tab["phase0"], dev)
    run_start = tab["run_start"]
    rid = torch.searchsorted(run_start, ii, right=True).to(i32) - 1
    rid = rid.clamp(0, run_start.shape[0] - 1)
    s_int = tab["run_s0"][rid] + tab["run_m"][rid] * (ii - run_start[rid])
    spd = s_int.to(torch.float32) * _INV
    inc = torch.round((spd * mod) * float(POS_ONE)).to(i32)

    reset = torch.zeros(T, dtype=torch.bool, device=dev)
    reset[tab["visit_start"][1:]] = True
    inc_shift = torch.cat([inc.new_zeros(1), inc[:-1]])
    inc_shift = torch.where(reset, 0, inc_shift)
    whole_rel, frac_rel = segmented_pos_cumsum(inc_shift, reset)
    vid = torch.cumsum(reset, 0, dtype=i32)
    vid = vid.clamp(0, tab["visit_bw"].shape[0] - 1)
    f = frac_rel + tab["visit_bf"][vid]
    carry = f >> POS_FRAC_BITS
    whole = whole_rel + tab["visit_bw"][vid] + carry
    frac = f - (carry << POS_FRAC_BITS)

    wrapped = torch.remainder(whole, n)
    sec = tab["visit_sec"][vid]
    sec_start = tab["starts"][sec]
    sec_end = torch.maximum(tab["ends"][sec], sec_start + 1)
    idx0, fr = _read_index(wrapped, frac, sec_start, sec_end,
                           tab["reverse"][sec])
    idx0 = idx0.clamp(0, n - 1)

    gain = torch.ones(T, dtype=torch.float32, device=dev)
    bnd = tab["boundaries"]
    if consts.anticlick_on and len(bnd) > 0 and consts.smooth_len > 0:
        dmin = _boundary_min_dist(bnd, idx0)
        inv_smooth = float(np.float32(1.0 / max(1, consts.smooth_len)))
        x = (consts.smooth_len - dmin).to(torch.float32) * inv_smooth
        g = torch.clamp_min(1.0 - float(np.float32(
            consts.anticlick_strength)) * x, 0.0)
        gain = torch.where(dmin < consts.smooth_len, g, gain)
    trig = tab["triggers"]
    if consts.splice_on and trig.shape[0] > 0:
        # triggers are >= E apart (host greedy suppression), so the rows
        # never overlap and the scatter is order-free
        env = tab["splice_env"]
        E = env.shape[0]
        rows = (trig[:, None] + torch.arange(E, dtype=i32, device=dev))
        buf = torch.ones(T + E, dtype=torch.float32, device=dev)
        buf[rows.reshape(-1)] = env.repeat(trig.shape[0])
        gain = gain * buf[:T]
    return idx0, fr, gain


def tape_device_render(audio: torch.Tensor, tab: dict, consts: TapeConsts,
                       T: int, out_i16: bool = False,
                       interp: str = "linear",
                       with_pieces: bool = False) -> torch.Tensor:
    """Whole tape render on the device from the control tables (see
    ``tape_positions`` for ``tab``): the linear read (``interp="linear"``)
    or the 16-tap Lanczos-sinc read (``"sinc"``), gain, clip to [-1, 1],
    and PCM16 with ``out_i16``.  Returns f32 [T] or int16 [T] on
    ``audio``'s device (any other ``interp`` reads linearly, as in the
    JAX package)."""
    if with_pieces:
        raise NotImplementedError("the splice-piece path of the trace "
                                  f"renderer is not ported ({_QUEUE6})")
    idx0, fr, gain = tape_positions(tab, consts, audio.shape[0], T)
    if interp == "sinc":
        # the sinc read takes its fraction in 2**-22 units: the JAX
        # package's quantization round trip (varispeed.py:1019-1031)
        fq = torch.round(fr * float(POS_ONE)).to(torch.int32)
        s = gather_sinc_clip(audio, idx0, fq)
    else:
        s = lerp_read(audio, idx0, fr)
    s = torch.clamp(s * gain, -1.0, 1.0)
    if out_i16:
        q = torch.clamp(torch.round(s * 32768.0), -32768.0, 32767.0)
        return q.to(torch.int16)
    return s

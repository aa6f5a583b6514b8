"""TapeTUC engine — port of audio_suite_tpu/models/tape.py.

Ported slice: the default render, ``render_tape(..., engine="device",
interp="linear")``, its ``render_to_wav`` entry point and the
``tape_table_render`` outputs (mono f32, PCM16, a stereo duplicate):

- host: ``TapeParams``, sections, retime, the wow/flutter constants, the
  splice envelope and ``build_tape_program`` — NumPy, the same arrays as
  the JAX package — and the control tables from the shared C++ runtime
  (``utils/native_rt.py``), memoized on the program as ``prog["_tables"]``;
- device: ``ops/varispeed.tape_device_render`` (positions, the linear read
  through the CUDA kernel on the card, gain, clip, PCM16).

The tape goes to the device once, when the program is built; a tensor
passed as ``audio`` that already lies on the device is used as is.  The
scan and segment engines, the sinc read, the trace renderer, beat
detection and the undo stack raise ``NotImplementedError`` or are absent
(``ROADMAP.md`` queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops import detmath, fixq, varispeed
from ..ops.varispeed import _QUEUE6, TapeConsts
from ..utils import io as audio_io
from ..utils import native_rt


@dataclass
class TapeParams:
    """Full parameter state of a tape session — the same fields and
    defaults as the JAX package's TapeParams."""
    sample_rate: int = 48000
    markers: list = field(default_factory=list)          # sorted sample indices
    section_speeds: list = field(default_factory=lambda: [1.0])
    section_reverse: list = field(default_factory=lambda: [False])
    tape_age: int = 50
    enable_splice_fx: bool = True
    anticlick_enabled: bool = True
    anticlick_amount: int = 50
    inertia_enabled: bool = False
    inertia_amount: int = 50
    current_speed: float = 1.0
    play_pos: float = 0.0
    boundary_smooth_len: int = 400
    splice_env_len: int = 256


def sections_from_markers(markers, num_samples):
    """starts = [0]+markers, ends = markers+[N] (Tape…py:491-501)."""
    m = sorted(int(x) for x in markers)
    starts = np.asarray([0] + m, dtype=np.int32)
    ends = np.asarray(m + [int(num_samples)], dtype=np.int32)
    return starts, ends


def boundary_array(markers, num_samples):
    s = set(int(x) for x in markers)
    s.add(0)
    if num_samples > 0:
        s.add(int(num_samples) - 1)
    return np.asarray(sorted(s), dtype=np.int32)


def fit_to_target_time(params: TapeParams, num_samples: int,
                       target_seconds: float) -> list[float]:
    """Duration-preserving retime: scales all section speeds by k =
    current_total_time / target, clamped to [0.25, 4] (Tape…py:665-705)."""
    if target_seconds <= 0 or num_samples <= 0:
        return list(params.section_speeds)
    sr = float(params.sample_rate)
    starts, ends = sections_from_markers(params.markers, num_samples)
    speeds = list(params.section_speeds)
    total_time = 0.0
    for i in range(len(starts)):
        length = max(1, int(ends[i]) - int(starts[i]))
        v = speeds[i] if i < len(speeds) and speeds[i] > 0 else 1.0
        total_time += length / (v * sr)
    if total_time <= 0:
        return speeds
    k = total_time / target_seconds
    return [float(np.clip(v * k, 0.25, 4.0)) for v in speeds]


def section_render_length(params: TapeParams, num_samples: int) -> int:
    """Output length of one full pass over the tape at the per-section
    speeds (ignoring wow/flutter): sum_i len_i / v_i."""
    starts, ends = sections_from_markers(params.markers, num_samples)
    speeds = params.section_speeds
    total = 0.0
    for i in range(len(starts)):
        length = max(1, int(ends[i]) - int(starts[i]))
        v = speeds[i] if i < len(speeds) and speeds[i] > 0 else 1.0
        total += length / v
    return int(round(total))


# Wow 0.4 Hz = 2/5, flutter 7 Hz = 7/1 (Tape…py:794-798) as exact integer
# rate ratios
WOW_RATE_RATIO = (2, 5)
FLUTTER_RATE_RATIO = (7, 1)


def wow_flutter_consts(sample_rate: int, tape_age: int,
                       wow_phase0: float = 0.0, flutter_phase0: float = 0.0):
    """Constants of the wow/flutter curve shared by the C++ table builder
    and the device: (ints u32[4] = wow num/m, flutter num/m; flts f32[4] =
    wow inv_m, flutter inv_m, wow depth, flutter depth; phase0 f32[2] in
    cycles)."""
    a = max(0.0, min(1.0, tape_age / 100.0))
    wd = fixq.round_sig12_np(np.float32(0.001 + 0.006 * a))
    fd = fixq.round_sig12_np(np.float32(0.0005 + 0.003 * a))
    wn, wm, winv = detmath.phase_ratio(*WOW_RATE_RATIO, sample_rate)
    fn, fm, finv = detmath.phase_ratio(*FLUTTER_RATE_RATIO, sample_rate)
    ints = np.asarray([wn, wm, fn, fm], np.uint32)
    flts = np.asarray([winv, finv, wd, fd], np.float32)
    ph0 = np.asarray([wow_phase0 / (2.0 * np.pi),
                      flutter_phase0 / (2.0 * np.pi)], np.float32)
    return ints, flts, ph0


def splice_envelope(env_len: int = 256) -> np.ndarray:
    """1 + 0.8 e^{-5x} over env_len samples (Tape…py:83-88)."""
    x = np.linspace(0, 1, env_len, dtype=np.float32)
    return (1.0 + 0.8 * np.exp(-5.0 * x)).astype(np.float32)


def build_tape_program(audio, params: TapeParams, num_frames: int, *,
                       device) -> dict:
    """Every array and constant the render needs: host NumPy tables, a
    TapeConsts, and the mono f32 tape on ``device`` (a tensor already
    there is used as is)."""
    if isinstance(audio, torch.Tensor):
        audio = audio.to(device=device, dtype=torch.float32).contiguous()
    else:
        audio = torch.as_tensor(np.ascontiguousarray(audio, np.float32),
                                device=device)
    if audio.dim() != 1:
        raise ValueError("tape render wants mono audio [n]")
    n = int(audio.shape[0])
    if n < 2:
        raise ValueError("tape render needs at least 2 samples of audio")

    starts, ends = sections_from_markers(params.markers, n)
    nsec = len(starts)
    speeds = [abs(float(params.section_speeds[i]))
              if i < len(params.section_speeds) else 1.0
              for i in range(nsec)]
    revs = [bool(params.section_reverse[i])
            if i < len(params.section_reverse) else False
            for i in range(nsec)]
    speeds_q = fixq.quantize_f32_np(np.asarray(speeds, np.float32))

    dt = 1.0 / float(params.sample_rate)
    if params.inertia_enabled and params.inertia_amount > 0:
        tau = (20.0 + 480.0 * (params.inertia_amount / 100.0)) / 1000.0
        alpha = min(1.0, dt / tau) if tau > 0 else 1.0
    else:
        alpha = 1.0

    amt = max(0.0, min(1.0, params.anticlick_amount / 100.0))
    consts = TapeConsts(
        anticlick_on=bool(params.anticlick_enabled),
        smooth_len=int(params.boundary_smooth_len),
        anticlick_strength=float(np.float32(0.3 + 0.5 * amt)),
        splice_on=bool(params.enable_splice_fx),
        inertia_on=bool(params.inertia_enabled and params.inertia_amount > 0),
        alpha_q=float(np.float32(alpha)),
        initial_speed_q=float(fixq.quantize_f32_np(
            np.float32(abs(params.current_speed)))),
    )

    return {
        "audio": audio,
        "mod_consts": wow_flutter_consts(params.sample_rate, params.tape_age),
        "starts": starts,
        "ends": ends,
        "speeds_q": np.asarray(speeds_q, np.float32),
        "reverse": np.asarray(revs, np.bool_),
        "boundaries": boundary_array(params.markers, n),
        "splice_env": splice_envelope(params.splice_env_len),
        "consts": consts,
        "num_frames": int(num_frames),
        "sample_rate": int(params.sample_rate),
    }


_TAPE_PROG_CACHE: OrderedDict = OrderedDict()


def build_tape_program_cached(audio, params: TapeParams, num_frames: int, *,
                              device) -> dict:
    """build_tape_program memoized on (audio identity, device, params
    content, num_frames), LRU-bounded at 8 programs, so that re-renders of
    an unchanged tape and parameters skip the host build and, through
    ``prog["_tables"]``, the C++ table walk.  The audio is keyed by object
    identity: reuse the same array or tensor across renders."""
    key = (id(audio), str(torch.device(device)), int(num_frames),
           json.dumps(dataclasses.asdict(params), sort_keys=True,
                      default=str))
    ent = _TAPE_PROG_CACHE.pop(key, None)
    if ent is not None and ent["audio"] is audio:
        _TAPE_PROG_CACHE[key] = ent
        return ent["prog"]
    prog = build_tape_program(audio, params, num_frames, device=device)
    _TAPE_PROG_CACHE[key] = {"audio": audio, "prog": prog}
    while len(_TAPE_PROG_CACHE) > 8:
        _TAPE_PROG_CACHE.popitem(last=False)
    return prog


def program_tables(prog: dict) -> dict:
    """The program's control tables (C++ walk on first use, then the
    memo ``prog["_tables"]``)."""
    tables = prog.get("_tables")
    if tables is None:
        tables = native_rt.tape_tables(
            prog["num_frames"], int(prog["audio"].shape[0]),
            prog["mod_consts"], prog["starts"], prog["ends"],
            prog["speeds_q"], prog["reverse"], prog["boundaries"],
            len(prog["splice_env"]), prog["consts"])
        prog["_tables"] = tables
    return tables


def device_tables(prog: dict) -> dict:
    """The tables ``ops/varispeed.tape_positions`` reads, on the tape's
    device (a few KB, copied once per program and memoized)."""
    tab = prog.get("_device_tables")
    if tab is None:
        tables = program_tables(prog)
        dev = prog["audio"].device

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)
        ints, flts, ph0 = prog["mod_consts"]
        tab = {k: i32(tables[k]) for k in (
            "visit_start", "visit_bw", "visit_bf", "visit_sec",
            "run_start", "run_s0", "run_m", "triggers")}
        tab.update(
            mod_ints=ints, mod_flts=flts, phase0=ph0,
            starts=i32(prog["starts"]), ends=i32(prog["ends"]),
            reverse=torch.as_tensor(prog["reverse"], device=dev),
            boundaries=[int(b) for b in prog["boundaries"]],
            splice_env=torch.as_tensor(prog["splice_env"], device=dev))
        prog["_device_tables"] = tab
    return tab


def tape_table_render(prog: dict, out_i16: bool = False,
                      device_out: bool = False, interp: str = "linear",
                      stereo: bool = False):
    """Device tape engine: compact host control tables -> full on-device
    reconstruction.  Returns (out, final playback state): out is f32 [T],
    or int16 PCM with ``out_i16``, [T, 2] with ``stereo`` (both channels
    the same samples); a tensor on the tape's device with ``device_out``,
    else a host NumPy array."""
    tab = device_tables(prog)
    out = varispeed.tape_device_render(prog["audio"], tab, prog["consts"],
                                       prog["num_frames"], out_i16, interp)
    if stereo:
        out = torch.stack([out, out], dim=-1)
    final = program_tables(prog)["final"]
    if device_out:
        return out, final
    return out.cpu().numpy(), final


def render_tape(audio, params: TapeParams,
                num_frames: Optional[int] = None, *, device,
                engine: str = "device",
                interp: str = "linear") -> np.ndarray:
    """Offline render of ``num_frames`` output samples (default: one full
    duration-preserving pass over the tape) on ``device``; returns the mono
    f32 render as a host NumPy array."""
    if engine != "device":
        raise NotImplementedError(f"engine={engine!r}: only the device "
                                  f"table engine is ported ({_QUEUE6})")
    n = int(audio.shape[0]) if hasattr(audio, "shape") else len(audio)
    if num_frames is None:
        num_frames = section_render_length(params, n)
    prog = build_tape_program_cached(audio, params, num_frames,
                                     device=device)
    out, _ = tape_table_render(prog, interp=interp)
    return out


def render_tape_trace(*args, **kwargs):
    raise NotImplementedError(f"the TapeTrace renderer is not ported "
                              f"({_QUEUE6})")


class TapeTrace:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"TapeTrace is not ported ({_QUEUE6})")


def render_to_wav(in_path: str, out_path: str, params: TapeParams,
                  num_frames: Optional[int] = None, *, device):
    """Load -> render -> save as PCM_16 (Tape…py:302-345, 342)."""
    audio, sr = audio_io.load_wav_mono(in_path)
    if sr != params.sample_rate:
        audio = audio_io.resample_to_rate(audio, sr, params.sample_rate)
    out = render_tape(audio, params, num_frames, device=device)
    audio_io.write_wav(out_path, out, params.sample_rate, subtype="PCM_16")
    return out

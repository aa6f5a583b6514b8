"""TapeTUC engine — port of audio_suite_tpu/models/tape.py.

- host: ``TapeParams`` (with its undo snapshots and ``UndoStack``),
  sections, retime, the wow/flutter curve and its constants (with the
  trace renderer's phase continuation, ``lfo_phase_cycles``), the splice
  envelope, beat detection and ``build_tape_program`` — NumPy, the same
  arrays as the JAX package — and the control tables, memoized on the
  program as ``prog["_tables"]``: on a card with inertia off from the
  hand-written table walk (``varispeed.tape_tables_on_card``), else from
  the shared C++ runtime (``utils/native_rt.py``), the same tables;
- ``render_tape`` with its three engines: ``"device"`` (the table engine,
  ``ops/varispeed.tape_device_render``: positions, the linear read
  through the CUDA kernel on the card or the plain-PyTorch sinc read,
  gain, clip, PCM16), ``"segment"`` (the C++ per-sample trajectory and
  one linear read) and ``"scan"`` (the per-sample recurrence on the
  hand-written ``kernels/tape_scan.cu``);
- the tracer's spans (``utils/profiling.py``, off by default) on the
  device engine's render: ``tape.render`` (the root; ``memo_hit``,
  ``frames``), ``tape.build`` (``hit``), ``tape.tables`` (``hit``, the
  table sizes ``visits``, ``runs``, ``triggers``, and ``on_card``,
  ``chunks_walked``, ``chunks_jumped``), ``tape.upload``, the
  device stages ``tape.positions`` and ``tape.read``, and ``tape.pull``;
- the performance renderer: a ``TapeTrace`` of timed edits, split at its
  event times into segment programs with the position, speed and splice
  state carried across them (``build_trace_programs``), each segment
  rendered by the table engine (``render_tape_trace``).

The tape goes to the device once, when the program is built; a tensor
passed as ``audio`` that already lies on the device is used as is.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops import detmath, fixq, varispeed
from ..ops.varispeed import TapeConsts
from ..utils import io as audio_io
from ..utils import native_rt
from ..utils.memo import Memo
from ..utils.profiling import span


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

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_snapshot(d: dict) -> "TapeParams":
        return TapeParams(**d)


class UndoStack:
    """50-deep parameter-state undo (Tape…py:707-759)."""

    def __init__(self, depth: int = 50):
        self.depth = depth
        self._stack: list[dict] = []

    def push(self, params: TapeParams):
        self._stack.append(params.snapshot())
        if len(self._stack) > self.depth:
            self._stack.pop(0)

    def pop(self) -> Optional[TapeParams]:
        if not self._stack:
            return None
        return TapeParams.from_snapshot(self._stack.pop())

    def __len__(self):
        return len(self._stack)


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


def wow_flutter_mod(num_frames: int, sample_rate: int, tape_age: int,
                    wow_phase0: float = 0.0, flutter_phase0: float = 0.0,
                    phase0_cycles=None) -> np.ndarray:
    """The quantized per-sample speed modulation f32 [num_frames] on the
    host: clip(1 + wow_depth sin(wow) + flutter_depth sin(flutter), 0.1, 3)
    (Tape…py:794-798, 884-891), 0.4 Hz wow and 7 Hz flutter with depths
    scaled by tape age, through the detmath f32 cycle-domain twins (exact
    integer phase reduction at any frame count) and 12-bit depths, so
    that the host, the C++ runtime and the device compute the same curve
    bit for bit."""
    ints, flts, ph0 = wow_flutter_consts(sample_rate, tape_age,
                                         wow_phase0, flutter_phase0,
                                         phase0_cycles)
    i = np.arange(num_frames, dtype=np.uint32)
    sw = fixq.round_sig12_np(detmath.sin_cycles_np(
        ph0[0] + detmath.phase_cycles_np(i, ints[0], ints[1], flts[0])))
    sf = fixq.round_sig12_np(detmath.sin_cycles_np(
        ph0[1] + detmath.phase_cycles_np(i, ints[2], ints[3], flts[1])))
    mod = np.float32(1.0) + flts[2] * sw + flts[3] * sf
    mod = np.clip(mod, np.float32(0.1), np.float32(3.0))
    return fixq.quantize_f32_np(mod)


# Wow 0.4 Hz = 2/5, flutter 7 Hz = 7/1 (Tape…py:794-798) as exact integer
# rate ratios, shared by wow_flutter_consts and lfo_phase_cycles so that a
# trace segment's phase continuation stays on the curve
WOW_RATE_RATIO = (2, 5)
FLUTTER_RATE_RATIO = (7, 1)


def wow_flutter_consts(sample_rate: int, tape_age: int,
                       wow_phase0: float = 0.0, flutter_phase0: float = 0.0,
                       phase0_cycles=None):
    """Constants of the wow/flutter curve shared by the host, the C++
    table builder and the device: (ints u32[4] = wow num/m, flutter num/m;
    flts f32[4] = wow inv_m, flutter inv_m, wow depth, flutter depth;
    phase0 f32[2] in cycles).  ``phase0_cycles``, when given, replaces the
    radian phases with exact f32 cycle-domain values (a trace segment's
    continuation: ``lfo_phase_cycles``)."""
    a = max(0.0, min(1.0, tape_age / 100.0))
    wd = fixq.round_sig12_np(np.float32(0.001 + 0.006 * a))
    fd = fixq.round_sig12_np(np.float32(0.0005 + 0.003 * a))
    wn, wm, winv = detmath.phase_ratio(*WOW_RATE_RATIO, sample_rate)
    fn, fm, finv = detmath.phase_ratio(*FLUTTER_RATE_RATIO, sample_rate)
    ints = np.asarray([wn, wm, fn, fm], np.uint32)
    flts = np.asarray([winv, finv, wd, fd], np.float32)
    if phase0_cycles is not None:
        ph0 = np.asarray(phase0_cycles, np.float32)
    else:
        ph0 = np.asarray([wow_phase0 / (2.0 * np.pi),
                          flutter_phase0 / (2.0 * np.pi)], np.float32)
    return ints, flts, ph0


def lfo_phase_cycles(sample_rate: int, sample_offset: int):
    """The f32 wow and flutter phases in cycles at a global output-sample
    offset (exact integer residues: no accumulation error at any offset).
    A trace segment starting at global sample t0 takes them as its phase0,
    so its locally indexed curve continues the performance's."""
    wn, wm, winv = detmath.phase_ratio(*WOW_RATE_RATIO, sample_rate)
    fn, fm, finv = detmath.phase_ratio(*FLUTTER_RATE_RATIO, sample_rate)
    i = np.uint32(sample_offset % (2 ** 32))
    pw = detmath.phase_cycles_np(i, wn, wm, np.float32(winv))
    pf = detmath.phase_cycles_np(i, fn, fm, np.float32(finv))
    return (np.float32(pw), np.float32(pf))


def splice_envelope(env_len: int = 256) -> np.ndarray:
    """1 + 0.8 e^{-5x} over env_len samples (Tape…py:83-88)."""
    x = np.linspace(0, 1, env_len, dtype=np.float32)
    return (1.0 + 0.8 * np.exp(-5.0 * x)).astype(np.float32)


def _device_audio(audio, device) -> torch.Tensor:
    """The mono f32 tape on ``device`` (a tensor already there is used as
    is)."""
    if isinstance(audio, torch.Tensor):
        audio = audio.to(device=device, dtype=torch.float32).contiguous()
    else:
        audio = torch.as_tensor(np.ascontiguousarray(audio, np.float32),
                                device=device)
    if audio.dim() != 1:
        raise ValueError("tape render wants mono audio [n]")
    if audio.shape[0] < 2:
        raise ValueError("tape render needs at least 2 samples of audio")
    return audio


#: the fastest section or initial speed a program takes: the walks' per-
#: sample increment rint(speed * mod * 2**22), mod <= 3, is an int32 (the
#: C++ walk's and the card's), which a speed past ~170 overflows
MAX_SPEED = 128.0


def _section_program(params: TapeParams, n: int, initial_speed: float):
    """The section tables and the TapeConsts of ``params`` over an
    n-sample tape, starting at ``initial_speed``; a speed whose magnitude
    is not a finite number at most MAX_SPEED raises ValueError."""
    starts, ends = sections_from_markers(params.markers, n)
    nsec = len(starts)
    speeds = [abs(float(params.section_speeds[i]))
              if i < len(params.section_speeds) else 1.0
              for i in range(nsec)]
    if not all(s <= MAX_SPEED for s in speeds + [abs(float(initial_speed))]):
        raise ValueError(f"tape speeds must be finite and at most "
                         f"{MAX_SPEED:g} in magnitude: sections {speeds}, "
                         f"initial {initial_speed}")
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
            np.float32(abs(initial_speed)))),
    )
    return {
        "starts": starts,
        "ends": ends,
        "speeds_q": np.asarray(speeds_q, np.float32),
        "reverse": np.asarray(revs, np.bool_),
        "boundaries": boundary_array(params.markers, n),
        "splice_env": splice_envelope(params.splice_env_len),
        "consts": consts,
    }


def build_tape_program(audio, params: TapeParams, num_frames: int, *,
                       device="cuda") -> dict:
    """Every array and constant the render needs: host NumPy tables, a
    TapeConsts, and the mono f32 tape on ``device`` (a tensor already
    there is used as is)."""
    audio = _device_audio(audio, device)
    prog = _section_program(params, int(audio.shape[0]),
                            params.current_speed)
    prog.update(
        audio=audio,
        mod_consts=wow_flutter_consts(params.sample_rate, params.tape_age),
        num_frames=int(num_frames),
        sample_rate=int(params.sample_rate))
    return prog


_TAPE_PROG_CACHE = Memo(8)


def build_tape_program_cached(audio, params: TapeParams, num_frames: int, *,
                              device="cuda") -> dict:
    """build_tape_program memoized on (audio identity, device, params
    content, num_frames), LRU-bounded at 8 programs, so that re-renders of
    an unchanged tape and parameters skip the host build and, through
    ``prog["_tables"]``, the table walk.  The audio is keyed by object
    identity: reuse the same array or tensor across renders."""
    return _cached_program(audio, params, num_frames, device)[0]


def _cached_program(audio, params: TapeParams, num_frames: int, device):
    """``build_tape_program_cached``'s program and whether the memo served
    it, in the ``tape.build`` span."""
    with span("tape.build") as sp:
        key = (int(num_frames),
               json.dumps(dataclasses.asdict(params), sort_keys=True,
                          default=str))
        prog, hit = _TAPE_PROG_CACHE.get(
            key, lambda: build_tape_program(audio, params, num_frames,
                                            device=device),
            device=device, pins=(audio,))
        sp.set(hit=hit)
        return prog, hit


def program_tables(prog: dict) -> dict:
    """The program's control tables (walked on first use, then the memo
    ``prog["_tables"]``), in the ``tape.tables`` span: ``hit``, the table
    sizes, ``on_card`` (1 where the card's walk built them) and its
    ``chunks_walked`` / ``chunks_jumped``."""
    with span("tape.tables") as sp:
        hit = prog.get("_tables") is not None
        walk = _walk(prog)
        tables = prog["_tables"]
        sp.set(hit=hit, visits=len(tables["visit_start"]),
               runs=len(tables["run_start"]),
               triggers=len(tables["triggers"]),
               on_card=int(walk is not None),
               chunks_walked=walk["chunks_walked"] if walk else 0,
               chunks_jumped=walk["chunks_jumped"] if walk else 0)
        return tables


def _walk(prog: dict):
    """``program_tables`` outside its span: leaves both memos set,
    ``prog["_tables"]`` (the NumPy tables) and ``prog["_device_tables"]``
    (those ``ops/varispeed.tape_positions`` reads, on the tape's device),
    and returns the card walk's chunk counts where it built the tables
    now, else None.  A program that carries ``_tables`` (the trace
    renderer's segments) keeps them; a tape off the CPU with inertia off
    walks on the card (``varispeed.tape_tables_on_card``: the tables stay
    there, nothing is copied up); the others (CPU tapes, inertia) take the
    C++ walk, whose tables are copied to the device here."""
    tables, walk = prog.get("_tables"), None
    if tables is None:
        args = (prog["num_frames"], int(prog["audio"].shape[0]),
                prog["mod_consts"], prog["starts"], prog["ends"],
                prog["speeds_q"], prog["reverse"], prog["boundaries"])
        if (prog["audio"].device.type != "cpu"
                and not prog["consts"].inertia_on):
            tables, tab, walk = varispeed.tape_tables_on_card(
                *args, prog["splice_env"], prog["consts"],
                prog["audio"].device)
            ints, flts, ph0 = prog["mod_consts"]
            prog["_device_tables"] = dict(
                tab, mod_ints=ints, mod_flts=flts, phase0=ph0,
                boundaries=[int(b) for b in prog["boundaries"]])
        else:
            tables = native_rt.tape_tables(*args, len(prog["splice_env"]),
                                           prog["consts"])
        prog["_tables"] = tables
    if prog.get("_device_tables") is None:
        prog["_device_tables"] = _upload(prog, tables)
    return walk


def _upload(prog: dict, tables: dict) -> dict:
    """The C++ walk's tables (a few KB) copied to the tape's device."""
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
    return tab


def device_tables(prog: dict) -> dict:
    """The tables ``ops/varispeed.tape_positions`` reads, on the tape's
    device, memoized on the program by its walk (``_walk``: the card's
    walk leaves them there, the C++ walk's are copied up with it), in the
    ``tape.upload`` span."""
    with span("tape.upload"):
        if prog.get("_device_tables") is None:
            _walk(prog)
        return prog["_device_tables"]


def tape_table_render(prog: dict, out_i16: bool = False,
                      device_out: bool = False, interp: str = "linear",
                      stereo: bool = False):
    """Device tape engine: compact host control tables -> full on-device
    reconstruction.  Returns (out, final playback state): out is f32 [T],
    or int16 PCM with ``out_i16``, [T, 2] with ``stereo`` (both channels
    the same samples); a tensor on the tape's device with ``device_out``,
    else a host NumPy array."""
    final = program_tables(prog)["final"]
    tab = device_tables(prog)
    out = varispeed.tape_device_render(prog["audio"], tab, prog["consts"],
                                       prog["num_frames"], out_i16, interp)
    if stereo:
        out = torch.stack([out, out], dim=-1)
    if device_out:
        return out, final
    with span("tape.pull"):
        return out.cpu().numpy(), final


ENGINES = ("device", "segment", "scan")


def render_tape(audio, params: TapeParams,
                num_frames: Optional[int] = None, *, device="cuda",
                engine: str = "device", interp: str = "linear",
                pcm16: bool = False) -> np.ndarray:
    """Offline render of ``num_frames`` output samples (default: one full
    duration-preserving pass over the tape) on ``device``; returns the mono
    f32 render as a host NumPy array, or with ``pcm16`` (the device engine
    only) the int16 PCM the card made from it (the app exports PCM_16,
    Tape…py:342).

    ``engine="device"`` (default): the host control tables and the full
    reconstruction on the device (``interp`` "linear" or "sinc"), in the
    ``tape.render`` span.  ``"segment"``: the host's exact per-sample
    trajectory and one linear read.  ``"scan"``: the sequential
    reference-structured recurrence (``kernels/tape_scan.cu`` on the card),
    kept for cross-validation.  The three make the same discrete decisions
    (the same fixed-point integers); the segment and scan engines read
    linearly."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {ENGINES}")
    if pcm16 and engine != "device":
        raise ValueError("pcm16 is made on the card by the device engine")
    n = int(audio.shape[0]) if hasattr(audio, "shape") else len(audio)
    if num_frames is None:
        num_frames = section_render_length(params, n)
    if engine == "device":
        with span("tape.render", frames=int(num_frames)) as sp:
            prog, hit = _cached_program(audio, params, num_frames, device)
            sp.set(memo_hit=hit)
            out, _ = tape_table_render(prog, out_i16=pcm16, interp=interp)
            return out
    # the segment and scan engines read the host wow/flutter curve (the
    # table engine makes its own on the device)
    prog = build_tape_program(audio, params, num_frames, device=device)
    mod_q = wow_flutter_mod(num_frames, params.sample_rate, params.tape_age)
    if engine == "segment":
        out, _ = varispeed.tape_segment_render(
            prog["audio"], mod_q, prog["starts"], prog["ends"],
            prog["speeds_q"], prog["reverse"], prog["boundaries"],
            prog["splice_env"], prog["consts"])
    else:
        out, _ = varispeed.tape_scan_render(
            *scan_inputs(prog, mod_q), prog["consts"])
    return out.cpu().numpy()


def scan_inputs(prog: dict, mod_q) -> tuple:
    """The scan engine's tensors of a ``build_tape_program`` program and
    its wow/flutter curve ``mod_q`` (``wow_flutter_mod``), on the tape's
    device: (audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
    splice_env)."""
    dev = prog["audio"].device

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return (prog["audio"], on(mod_q, torch.float32),
            on(prog["starts"], torch.int32), on(prog["ends"], torch.int32),
            on(prog["speeds_q"], torch.float32),
            on(prog["reverse"], torch.bool),
            on(prog["boundaries"], torch.int32),
            on(prog["splice_env"], torch.float32))


# ----------------------------------------------------------------------------
# Performance automation: TapeTrace
# ----------------------------------------------------------------------------
#
# TapeTUC is an instrument: the reference user mutates speeds, markers and
# toggles DURING playback (Tape…py:768-788) and the recording tap captures
# that performance (Tape…py:902-909).  A TapeTrace is its offline,
# reproducible form: timed parameter edits (the set the GUI can make),
# rendered as segment programs with the position, speed and splice state
# carried across segments.  The reference applies an edit at the next
# audio-pull block; the trace applies it at its exact sample.

#: ops a trace event may carry (the GUI's actions), with their fields:
#:   set_speed {section, value}        speed spinbox (Tape…py:545-549)
#:   set_reverse {section, value}      reverse checkbox (Tape…py:551-556)
#:   add_marker {sample}               marker add (Tape…py:558-583)
#:   remove_marker {sample}            marker delete
#:   set_markers {markers}             wholesale marker edit / beat slicing
#:   set_age {value}                   tape-age slider 0-100
#:   set_splice {value}                splice FX toggle
#:   set_anticlick {value}             anti-click toggle
#:   set_anticlick_amount {value}      anti-click amount 0-100
#:   set_inertia {value}               inertia toggle
#:   set_inertia_amount {value}        inertia amount 0-100
#:   retime {target}                   Fit to Target Time (Tape…py:665-705)
#:   seek {sample}                     position jump
TRACE_OPS = {
    "set_speed": ("section", "value"),
    "set_reverse": ("section", "value"),
    "add_marker": ("sample",),
    "remove_marker": ("sample",),
    "set_markers": ("markers",),
    "set_age": ("value",),
    "set_splice": ("value",),
    "set_anticlick": ("value",),
    "set_anticlick_amount": ("value",),
    "set_inertia": ("value",),
    "set_inertia_amount": ("value",),
    "retime": ("target",),
    "seek": ("sample",),
}


@dataclass
class TapeTrace:
    """A recorded performance: events = [{"t": seconds, "op": ..., ...}]."""
    events: list = field(default_factory=list)

    def add(self, t: float, op: str, **kw) -> "TapeTrace":
        if op not in TRACE_OPS:
            raise ValueError(f"unknown trace op {op!r}")
        missing = [k for k in TRACE_OPS[op] if k not in kw]
        if missing:
            raise ValueError(
                f"trace op {op!r} at t={t} missing required "
                f"field(s) {missing} (got {sorted(kw)})")
        self.events.append({"t": float(t), "op": op, **kw})
        return self

    def to_json(self) -> str:
        return json.dumps({"events": self.events}, indent=2)

    @staticmethod
    def from_json(text: str) -> "TapeTrace":
        d = json.loads(text)
        tr = TapeTrace()
        for e in d.get("events", []):
            kw = {k: v for k, v in e.items() if k not in ("t", "op")}
            tr.add(e["t"], e["op"], **kw)
        return tr

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "TapeTrace":
        with open(path) as f:
            return TapeTrace.from_json(f.read())


def _rebuild_sections_preserving(p: TapeParams):
    """Marker-edit section rebuild: speeds and reverse kept by index, new
    sections get 1.0 / False (Tape…py:509-519 rebuild_table)."""
    nsec = len(p.markers) + 1
    p.section_speeds = [p.section_speeds[i] if i < len(p.section_speeds)
                        else 1.0 for i in range(nsec)]
    p.section_reverse = [p.section_reverse[i] if i < len(p.section_reverse)
                         else False for i in range(nsec)]


def apply_trace_op(params: TapeParams, ev: dict,
                   num_samples: int) -> TapeParams:
    """Apply one trace event to a parameter snapshot (pure: returns a new
    TapeParams).  ``seek`` does not touch params: the renderer consumes
    it."""
    p = TapeParams.from_snapshot(params.snapshot())
    op = ev["op"]
    if op == "set_speed":
        i = int(ev["section"])
        while len(p.section_speeds) <= i:
            p.section_speeds.append(1.0)
        p.section_speeds[i] = float(np.clip(ev["value"], 0.25, 4.0))
    elif op == "set_reverse":
        i = int(ev["section"])
        while len(p.section_reverse) <= i:
            p.section_reverse.append(False)
        p.section_reverse[i] = bool(ev["value"])
    elif op == "add_marker":
        s = int(ev["sample"])
        if 0 < s < num_samples and s not in p.markers:
            p.markers = sorted(p.markers + [s])
            _rebuild_sections_preserving(p)
    elif op == "remove_marker":
        s = int(ev["sample"])
        if s in p.markers:
            p.markers = [m for m in p.markers if m != s]
            _rebuild_sections_preserving(p)
    elif op == "set_markers":
        p.markers = sorted(int(m) for m in ev["markers"]
                           if 0 < int(m) < num_samples)
        _rebuild_sections_preserving(p)
    elif op == "set_age":
        p.tape_age = int(np.clip(ev["value"], 0, 100))
    elif op == "set_splice":
        p.enable_splice_fx = bool(ev["value"])
    elif op == "set_anticlick":
        p.anticlick_enabled = bool(ev["value"])
    elif op == "set_anticlick_amount":
        p.anticlick_amount = int(np.clip(ev["value"], 0, 100))
    elif op == "set_inertia":
        p.inertia_enabled = bool(ev["value"])
    elif op == "set_inertia_amount":
        p.inertia_amount = int(np.clip(ev["value"], 0, 100))
    elif op == "retime":
        p.section_speeds = fit_to_target_time(p, num_samples,
                                              float(ev["target"]))
    elif op == "seek":
        pass
    else:
        raise ValueError(f"unknown trace op {op!r}")
    return p


def build_trace_programs(audio, params: TapeParams, trace: TapeTrace,
                         num_frames: Optional[int] = None, *,
                         device="cuda") -> list[dict]:
    """Split the output timeline at the event times and build one table
    program per segment, carrying the position and speed state through the
    host table builder as the realtime loop would (``init_whole`` /
    ``init_frac`` and ``initial_speed_q`` are the previous segment's final
    state).  The wow/flutter phases continue through exact integer
    residues (``lfo_phase_cycles``), so a segment's locally indexed curve
    is the performance's.

    Each segment is a ``build_tape_program``-style program on the tape's
    one copy on ``device`` (the NumPy oracle renders it as is), with its
    host curve ``mod_q``, t0 / t1, the initial position, its params, its
    tables from the NumPy ``varispeed.tape_tables`` (as ``tables`` and as
    the ``_tables`` memo that ``device_tables`` reads) and their raw
    boundary ``hits`` for the splice machine (the C++ tables have none)."""
    audio = _device_audio(audio, device)
    n = int(audio.shape[0])
    p = TapeParams.from_snapshot(params.snapshot())
    sr = int(p.sample_rate)
    if num_frames is None:
        num_frames = section_render_length(p, n)
    T = int(num_frames)

    grouped: dict[int, list] = {}
    for e in sorted(trace.events, key=lambda e: float(e["t"])):
        ts = int(round(float(e["t"]) * sr))
        if ts >= T:
            continue
        grouped.setdefault(max(0, ts), []).append(e)
    edges = [0] + sorted(t for t in grouped if t > 0) + [T]

    carry_w, carry_f = fixq.split_pos_np(float(p.play_pos) % n)
    carry_speed = abs(float(p.current_speed))

    segs = []
    for t0, t1 in zip(edges[:-1], edges[1:]):
        for e in grouped.get(t0, []):
            if e["op"] == "seek":
                carry_w, carry_f = fixq.split_pos_np(
                    float(e["sample"]) % n)
            else:
                p = apply_trace_op(p, e, n)
        Ts = t1 - t0
        seg = _section_program(p, n, carry_speed)
        ph0c = lfo_phase_cycles(sr, t0)
        mod_q = wow_flutter_mod(Ts, sr, p.tape_age, phase0_cycles=ph0c)
        tables = varispeed.tape_tables(
            n, mod_q, seg["starts"], seg["ends"], seg["speeds_q"],
            seg["reverse"], seg["boundaries"], p.splice_env_len,
            seg["consts"], init_whole=int(carry_w), init_frac=int(carry_f))
        seg.update({
            "t0": t0, "t1": t1,
            "audio": audio,
            "mod_q": mod_q,
            "mod_consts": wow_flutter_consts(sr, p.tape_age,
                                             phase0_cycles=ph0c),
            "num_frames": Ts,
            "sample_rate": sr,
            "tape_age": int(p.tape_age),
            "init_whole": int(carry_w), "init_frac": int(carry_f),
            "tables": tables,
            "_tables": tables,
            "hits": np.asarray(tables["hits"], np.int64),
            "params": TapeParams.from_snapshot(p.snapshot()),
        })
        segs.append(seg)
        fin = tables["final"]
        carry_w, carry_f = int(fin["whole"]), int(fin["frac"])
        carry_speed = float(fin["speed"])
    return segs


def _splice_pieces(segs: list[dict], env_len: int) -> list[tuple]:
    """The global splice state machine over the segments' raw boundary
    hits: the reference's per-sample rem / sidx evolution (Tape…py:851-858,
    the oracle's render_tape_np) at hit and segment-boundary granularity.
    A splice-off segment FREEZES the state (the gate wraps both trigger
    and application).  Returns [(global t, envelope offset, length)],
    non-overlapping by construction."""
    rem, sidx = 0, 0
    pieces = []
    for s in segs:
        if not (s["consts"].splice_on and len(s["boundaries"]) > 0):
            continue                      # frozen through this segment
        t0, t1 = s["t0"], s["t1"]
        hits = s["hits"]
        nh = len(hits)
        hi = 0
        t = t0
        while t < t1:
            if rem > 0 and sidx < env_len:
                run = min(rem, t1 - t)
                pieces.append((t, sidx, run))
                sidx += run
                rem -= run
                t += run
                continue
            while hi < nh and t0 + int(hits[hi]) < t:
                hi += 1                   # hits during application: rem > 0
            if hi >= nh:
                break
            t = t0 + int(hits[hi])
            hi += 1
            rem, sidx = env_len, 0
    return pieces


def render_trace_segments(segs: list[dict], splice_env_len: int,
                          interp: str = "linear") -> torch.Tensor:
    """The device half of ``render_tape_trace``: every segment of
    ``build_trace_programs`` through the table engine, one render (one
    linear read) a segment, concatenated on the device.  A segment's
    splice triggers are the global splice machine's pieces that start in
    it (``_splice_pieces``), not its own table's triggers: where every
    piece is a whole envelope, or one cut off at the segment's end, they
    take the plain trigger path (so an empty trace renders as
    ``render_tape``); otherwise the piece path (``with_pieces``)."""
    pieces = _splice_pieces(segs, splice_env_len)
    outs = []
    for s in segs:
        t0, t1 = s["t0"], s["t1"]
        Ts = t1 - t0
        if Ts == 0:
            continue
        local = [(gt - t0, off, ln) for (gt, off, ln) in pieces
                 if t0 <= gt < t1]
        dev = s["audio"].device

        def i32(vals):
            return torch.as_tensor(np.asarray(vals, np.int32), device=dev)
        tab = dict(device_tables(s), triggers=i32([x[0] for x in local]))
        whole = all(off == 0 and (ln == splice_env_len or lt + ln == Ts)
                    for (lt, off, ln) in local)
        off = None if whole else i32([x[1] for x in local])
        ln = None if whole else i32([x[2] for x in local])
        outs.append(varispeed.tape_device_render(
            s["audio"], tab, s["consts"], Ts, interp=interp,
            with_pieces=not whole, splice_off=off, splice_len=ln))
    if not outs:
        dev = segs[0]["audio"].device if segs else "cpu"
        return torch.zeros(0, dtype=torch.float32, device=dev)
    return torch.cat(outs)


def render_tape_trace(audio, params: TapeParams, trace: TapeTrace,
                      num_frames: Optional[int] = None,
                      interp: str = "linear", return_state: bool = False,
                      *, device="cuda"):
    """Render a performance on ``device``: ``params`` is the state at t =
    0, ``trace`` the timed edits.  One table-engine render a segment, the
    position, speed and splice state carried bit-exactly through the host
    table builder; the segments' outputs are concatenated on the device
    and pulled once.  Returns the f32 render as a host NumPy array (and,
    with ``return_state``, the final {params, whole, frac, speed} for a
    record -> reload continuation)."""
    segs = build_trace_programs(audio, params, trace, num_frames,
                                device=device)
    y = render_trace_segments(segs, int(params.splice_env_len),
                              interp).cpu().numpy()
    if return_state:
        last = segs[-1]["tables"]["final"] if segs else {
            "whole": 0, "frac": 0, "speed": 1.0}
        final_params = segs[-1]["params"] if segs else params
        return y, {"params": final_params, "whole": int(last["whole"]),
                   "frac": int(last["frac"]),
                   "speed": float(last["speed"])}
    return y


def detect_beats(audio: np.ndarray, sample_rate: int,
                 sensitivity: int = 50) -> list[int]:
    """Energy-flux beat detection -> marker sample indices (Tape…py:913-995):
    normalize -> 1024/512 frame energies -> 3-tap moving average ->
    positive first difference -> threshold mean + sens*std -> local maxima
    with a 0.2 s minimum gap."""
    x = np.asarray(audio, np.float32)
    n = len(x)
    if n <= 0 or sample_rate <= 0:
        return []
    max_abs = float(np.max(np.abs(x))) if x.size else 0.0
    if max_abs > 0:
        x = x / max_abs

    frame_size, hop = 1024, 512
    if n < frame_size + 1:
        return []
    num_frames = 1 + (n - frame_size) // hop
    if num_frames <= 1:
        return []

    idx = np.arange(num_frames)[:, None] * hop + np.arange(frame_size)[None, :]
    energies = np.sum(x[idx] * x[idx], axis=1, dtype=np.float32)

    if num_frames >= 3:
        kernel = np.ones(3, dtype=np.float32) / 3.0
        e_smooth = np.convolve(energies, kernel, mode="same")
    else:
        e_smooth = energies

    diff = np.maximum(e_smooth[1:] - e_smooth[:-1], 0.0)
    if diff.size == 0:
        return []
    mean = float(np.mean(diff))
    std = float(np.std(diff))
    sens = sensitivity / 100.0
    thresh = mean + sens * std
    min_gap = max(1, int(0.2 * sample_rate / hop))

    peaks = []
    last_peak = -min_gap
    for j in range(1, diff.size - 1):
        v = diff[j]
        if v < thresh:
            continue
        if not (v >= diff[j - 1] and v >= diff[j + 1]):
            continue
        if j - last_peak < min_gap:
            continue
        peaks.append(j)
        last_peak = j

    beats = [int(p * hop) for p in peaks]
    return sorted(set(b for b in beats if 0 < b < n))


def render_to_wav(in_path: str, out_path: str, params: TapeParams,
                  num_frames: Optional[int] = None, *, device="cuda"):
    """Load -> render -> save as PCM_16 (Tape…py:302-345, 342)."""
    audio, sr = audio_io.load_wav_mono(in_path)
    if sr != params.sample_rate:
        audio = audio_io.resample_to_rate(audio, sr, params.sample_rate)
    out = render_tape(audio, params, num_frames, device=device)
    audio_io.write_wav(out_path, out, params.sample_rate, subtype="PCM_16")
    return out

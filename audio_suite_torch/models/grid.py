"""Grid Audio engine — port of audio_suite_tpu/models/grid.py: the
multi-track grid DAW mixdown.

- host (NumPy and the user's cell scripts, the same values as the JAX
  package): the data model (``CellSource`` / ``Track`` / ``MasterClock`` /
  ``GridProject``, with the ``python`` division mode), restart events,
  cell and pattern rendering through ``plugins/host.py``, the pre-pass
  ``_build_mix_program`` and its memo ``build_mix_program_cached``, and
  the host engine ``_host_mixdown`` over ``placement_indices`` (the C++
  phase accumulator of ``native/ast_runtime.cpp``);
- device (``_mix``, plain functions on tensors): per track in pinned
  order, the mod-speed chain (``ops/envdet.py``) from the placed source
  track, or unit speed; the reset mask; the segmented fixed-point
  positions (``_track_positions``); a gather from the gain-premultiplied
  pattern bank under the valid mask; the sum, clip and optional PCM16.

Every step is integer math or a single-rounded f32 op in the JAX
package's order, so the device engine is bit-equal to the JAX package's
device and host engines, and to this module's host engine.  The JAX
package's one-hot MXU read (``fixq.gather_int_block_onehot``) equals a
plain gather on every valid position, and its ``MIX_PAD`` length buckets
and power-of-two bank exist to reuse XLA compiles: the port renders at the
true length from the bank as it is.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import math
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops import envdet, fixq
from ..plugins.host import load_py_module
from ..utils import io as audio_io
from ..utils import native_rt
from ..utils.memo import Memo

DEFAULT_DIVISION_SNIPPET = "def divisions(total):\n    return [total/16.0]*16\n"


def divisions_uniform(total: float, n: int) -> List[float]:
    n = max(1, int(n))
    return [total / n] * n


def parse_float_list(text: str) -> List[float]:
    """Sync-point parser (grid_audio_app.py:118-131)."""
    pts: List[float] = []
    for part in (text or "").replace(";", ",").split(","):
        s = part.strip()
        if not s:
            continue
        try:
            v = float(s)
            if np.isfinite(v):
                pts.append(v)
        except Exception:
            pass
    pts.sort()
    return pts


def moving_average(x: np.ndarray, win: int) -> np.ndarray:
    """(grid_audio_app.py:133-140) as an O(n) f64 cumulative-sum box
    filter; agrees with the reference's np.convolve to f64 rounding."""
    if win <= 1:
        return x
    win = min(win, len(x))
    if win <= 1:
        return x
    n = len(x)
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    # np.convolve 'same' window for output i: x[i - win//2 ... i + (win-1)//2]
    lo = np.clip(np.arange(n) - win // 2, 0, n)
    hi = np.clip(np.arange(n) + (win - 1) // 2 + 1, 0, n)
    return ((c[hi] - c[lo]) / float(win)).astype(np.float32)


def rms_envelope(x: np.ndarray, win: int) -> np.ndarray:
    """(grid_audio_app.py:142-147)"""
    if len(x) == 0:
        return x.astype(np.float32, copy=False)
    xx = x.astype(np.float32, copy=False) ** 2
    sm = moving_average(xx, max(1, win))
    return np.sqrt(np.maximum(sm, 0.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Data model (grid_audio_app.py:156-233)
# ---------------------------------------------------------------------------

@dataclass
class CellSource:
    kind: str = "empty"   # "empty" | "wav" | "py"
    path: str = ""


@dataclass
class Track:
    name: str = "Track"
    gain_db: float = 0.0
    mode: str = "tempo_bpm"   # "tempo_bpm" | "tempo_spm" | "duration"
    bpm: float = 120.0
    seconds_per_measure: float = 2.0
    beats_per_measure: int = 4
    measures: int = 4
    duration_seconds: float = 8.0

    start_offset_seconds: float = 0.0
    loop_to_master: bool = False
    sync_points_text: str = ""

    mod_source_index: int = -1
    mod_amount: float = 0.0
    mod_smoothing_ms: float = 50.0

    division_mode: str = "uniform"   # "uniform" | "python"
    uniform_n: int = 16
    python_code: str = DEFAULT_DIVISION_SNIPPET

    cells: List[CellSource] = field(default_factory=list)

    def total_duration(self) -> float:
        if self.mode == "duration":
            return max(0.0, float(self.duration_seconds))
        if self.mode == "tempo_spm":
            return float(self.measures) * max(1e-6,
                                              float(self.seconds_per_measure))
        bpm = max(1e-6, float(self.bpm))
        beats = max(1, int(self.beats_per_measure))
        return float(self.measures) * (60.0 / bpm) * beats

    def build_divisions(self) -> List[float]:
        """Uniform N, or exec of the user's ``divisions(total)`` code,
        normalized to sum == total (grid_audio_app.py:196-213).  The
        restricted builtins mirror the reference's whitelist and are not a
        security sandbox: project files are trusted input, like the
        reference's plugin cells."""
        total = self.total_duration()
        if total <= 0:
            return []
        if self.division_mode == "python":
            glb = {"__builtins__": {"range": range, "len": len, "sum": sum,
                                    "min": min, "max": max, "abs": abs,
                                    "float": float, "int": int}}
            loc: Dict[str, Any] = {}
            exec(self.python_code, glb, loc)
            if "divisions" not in loc:
                raise RuntimeError(
                    "Python divisions code must define: divisions(total)")
            out = [float(x) for x in loc["divisions"](total)]
            s = sum(out)
            if s <= 0:
                return []
            return [x * (total / s) for x in out]
        return divisions_uniform(total, self.uniform_n)

    def ensure_cells(self, n: int):
        n = max(0, int(n))
        if len(self.cells) < n:
            self.cells.extend(CellSource() for _ in range(n - len(self.cells)))
        elif len(self.cells) > n:
            self.cells = self.cells[:n]


@dataclass
class MasterClock:
    mode: str = "auto"   # "auto" | "fixed_seconds"
    fixed_seconds: float = 16.0

    def duration(self, tracks: List[Track]) -> float:
        if self.mode == "fixed_seconds":
            return max(0.01, float(self.fixed_seconds))
        m = 0.0
        for t in tracks:
            m = max(m, max(0.0, float(t.start_offset_seconds))
                    + max(0.0, t.total_duration()))
        return max(0.01, m)


@dataclass
class GridProject:
    tracks: List[Track] = field(default_factory=list)
    master: MasterClock = field(default_factory=MasterClock)
    sample_rate: int = 44100
    normalize: bool = False        # export-time 0.98 peak normalize


# ---------------------------------------------------------------------------
# Restart events (grid_audio_app.py:601-706)
# ---------------------------------------------------------------------------

MAX_EVENTS = 20000
MAX_OCCURRENCES = 10000


def collect_restart_events(project: GridProject, master_dur: float,
                           device="cuda") -> List[set]:
    """For every track x pattern occurrence x py cell with ``event()``,
    build the context dict, call it, and resolve ``{"restart_tracks": ...,
    "delay": s}`` into per-track sets of master-sample reset indices.  The
    reference's missing ``import math`` (grid_audio_app.py:630) is fixed,
    as in the JAX package.  The context's "device" is the render's, for
    cells that compute on the device (``plugins/torch_cells.py``)."""
    tracks = project.tracks
    sr = project.sample_rate
    n_tracks = len(tracks)
    restarts: List[set] = [set() for _ in range(n_tracks)]
    events_count = 0
    name_map = {t.name: i for i, t in enumerate(tracks)}

    for src_ti, t in enumerate(tracks):
        divs = t.build_divisions()
        if not divs:
            continue
        t.ensure_cells(len(divs))
        pat_dur = float(sum(divs))
        if pat_dur <= 1e-9:
            continue
        starts = np.cumsum([0.0] + divs[:-1])
        start0 = float(t.start_offset_seconds)
        if t.loop_to_master:
            occs = int(math.ceil(max(0.0, master_dur - start0)
                                 / pat_dur)) + 1
        else:
            occs = 1
        occs = max(0, min(occs, MAX_OCCURRENCES))

        for occ in range(occs):
            occ_start = start0 + occ * pat_dur
            if occ_start > master_dur:
                break
            for ci, (cell, cs) in enumerate(zip(t.cells, starts)):
                if cell.kind != "py" or not cell.path:
                    continue
                try:
                    mod = load_py_module(cell.path)
                except Exception:
                    continue     # plugin errors isolated per cell (:644-645)
                if mod.event is None:
                    continue
                master_time = occ_start + float(cs)
                if master_time < 0.0 or master_time > master_dur:
                    continue
                ctx = {
                    "track_index": src_ti,
                    "track_name": t.name,
                    "cell_index": ci,
                    "cells_total": len(divs),
                    "cell_start": float(cs),
                    "cell_duration": float(divs[ci]),
                    "track_pattern_duration": float(pat_dur),
                    "track_offset": float(t.start_offset_seconds),
                    "track_loop_to_master": bool(t.loop_to_master),
                    "track_sync_points_master":
                        parse_float_list(t.sync_points_text),
                    "master_time": float(master_time),
                    "master_duration": float(master_dur),
                    "tracks": [{"index": i, "name": tt.name}
                               for i, tt in enumerate(tracks)],
                    "device": str(device),
                }
                try:
                    ev = mod.event(ctx)
                except Exception:
                    continue     # swallowed per event cell (:670-672)
                if not isinstance(ev, dict):
                    continue
                targets = ev.get("restart_tracks", [])
                if targets == "all":
                    target_idx = list(range(n_tracks))
                elif targets == "all_except_self":
                    target_idx = [i for i in range(n_tracks) if i != src_ti]
                else:
                    target_idx = []
                    if isinstance(targets, (list, tuple)):
                        for it in targets:
                            if isinstance(it, int) and 0 <= it < n_tracks:
                                target_idx.append(it)
                            elif isinstance(it, str) and it in name_map:
                                target_idx.append(name_map[it])
                try:
                    delay = float(ev.get("delay", 0.0) or 0.0)
                except Exception:
                    delay = 0.0
                sidx = int(round((master_time + delay) * sr))
                if 0 <= sidx < int(round(master_dur * sr)) + 1:
                    for ti in target_idx:
                        restarts[ti].add(sidx)
                    events_count += 1
                    if events_count >= MAX_EVENTS:
                        return restarts
    return restarts


# ---------------------------------------------------------------------------
# Cell + pattern rendering (host: user scripts / wav files)
# ---------------------------------------------------------------------------

def render_cell_audio(cell: CellSource, sr: int, duration: float,
                      context: Dict[str, Any]) -> np.ndarray:
    """(grid_audio_app.py:816-837) — event-only scripts return silence."""
    duration = max(0.0, float(duration))
    if duration <= 0:
        return np.zeros(0, np.float32)
    if cell.kind == "wav":
        x, in_sr = audio_io.load_wav_mono(cell.path)
        x = audio_io.resample_to_rate(x, in_sr, sr)
        return audio_io.fit_to_duration(x, sr, duration)
    if cell.kind == "py":
        mod = load_py_module(cell.path)
        if mod.generate is None:
            return np.zeros(int(round(duration * sr)), np.float32)
        try:
            if len(inspect.signature(mod.generate).parameters) == 3:
                x = mod.generate(sr, duration, context)
            else:
                x = mod.generate(sr, duration)
        except TypeError:
            x = mod.generate(sr, duration)
        x = audio_io.to_mono(np.asarray(x, np.float32))
        return audio_io.fit_to_duration(x, sr, duration)
    return np.zeros(int(round(duration * sr)), np.float32)


def render_track_pattern(project: GridProject, ti: int, t: Track,
                         divs: List[float], pat_dur: float,
                         sync_pts_master: List[float],
                         device="cuda") -> np.ndarray:
    """Sum cells at cumulative-start offsets, clip +-1
    (grid_audio_app.py:758-784); the cells' context carries the render's
    "device"."""
    sr = project.sample_rate
    pat_n = max(1, int(round(pat_dur * sr)))
    pat = np.zeros(pat_n, np.float32)
    starts = np.cumsum([0.0] + divs[:-1])
    for ci, (cell, dur, st) in enumerate(zip(t.cells, divs, starts)):
        if cell.kind == "empty":
            continue
        start_samp = int(round(float(st) * sr))
        ctx = {
            "track_index": ti,
            "track_name": t.name,
            "cell_index": ci,
            "cells_total": len(divs),
            "cell_start": float(st),
            "cell_duration": float(dur),
            "track_pattern_duration": float(pat_dur),
            "track_offset": float(t.start_offset_seconds),
            "track_loop_to_master": bool(t.loop_to_master),
            "track_sync_points_master": list(sync_pts_master),
            "device": str(device),
        }
        seg = render_cell_audio(cell, sr, float(dur), ctx)
        end_samp = min(pat_n, start_samp + len(seg))
        if end_samp > start_samp:
            pat[start_samp:end_samp] += seg[:end_samp - start_samp]
    return np.clip(pat, -1.0, 1.0).astype(np.float32, copy=False)


# ---------------------------------------------------------------------------
# Placement: the phase accumulator (grid_audio_app.py:786-814)
# ---------------------------------------------------------------------------

def _pre_phase(start_idx: int, speed: Optional[np.ndarray]) -> float:
    """Phase reached by master sample 0 of a track that starts before it
    (:792-798): the sum of the first -start_idx speeds (at most the speed
    array's length), or -start_idx at unit speed."""
    if start_idx >= 0:
        return 0.0
    prelen = -start_idx
    if speed is None:
        return float(prelen)
    return float(np.sum(np.asarray(speed[: min(prelen, len(speed))],
                                   np.float64)))


def _start_idx(start_offset_seconds: float, sr: int,
               start_idx: Optional[int]) -> int:
    if start_idx is None:
        return int(round(start_offset_seconds * sr))
    return start_idx


def placement_indices(n_total: int, pat_n: int, start_offset_seconds: float,
                      sr: int, loop_to_master: bool,
                      speed: Optional[np.ndarray], reset_samples: set,
                      start_idx: Optional[int] = None):
    """(idx i64[n_total], valid bool[n_total]) with out[i] = pat[idx[i]]
    where valid: the reference's per-sample loop in C
    (``native_rt.grid_placement``; raises if the runtime cannot be
    built).  With 2**-22-quantized f32 speeds the f64 phase is exact, so
    the positions equal the device engine's fixed-point ones."""
    start_idx = _start_idx(start_offset_seconds, sr, start_idx)
    return native_rt.grid_placement(
        n_total, pat_n, start_idx, bool(loop_to_master), speed,
        set(int(r) for r in reset_samples if 0 <= r < n_total),
        _pre_phase(start_idx, speed))


def placement_indices_np(n_total: int, pat_n: int,
                         start_offset_seconds: float, sr: int,
                         loop_to_master: bool, speed: Optional[np.ndarray],
                         reset_samples: set,
                         start_idx: Optional[int] = None):
    """NumPy twin of ``placement_indices``: the same placement as
    segmented cumulative sums over the resets."""
    start_idx = _start_idx(start_offset_seconds, sr, start_idx)
    pre_phase = _pre_phase(start_idx, speed)
    i = np.arange(n_total, dtype=np.int64)

    # increments: speed[i] (or 1.0), accumulated only where local >= 0
    inc = np.ones(n_total, np.float64)
    if speed is not None:
        m = min(n_total, len(speed))
        inc[:m] = np.asarray(speed[:m], np.float64)
    inc_eff = np.where(i - start_idx >= 0, inc, 0.0)
    C = np.concatenate([[0.0], np.cumsum(inc_eff)])    # C[i] = sum inc[<i]

    resets = np.asarray(sorted(r for r in reset_samples
                               if 0 <= r < n_total), np.int64)
    if resets.size:
        k = np.searchsorted(resets, i, side="right") - 1
        has_reset = k >= 0
        last_reset = np.where(has_reset, resets[np.clip(k, 0, None)], 0)
        base = np.where(has_reset, C[last_reset], 0.0)
        phase = C[i] - base + np.where(has_reset, 0.0, pre_phase)
    else:
        phase = C[i] + pre_phase

    local = i - start_idx
    valid = local >= 0
    if loop_to_master:
        idx = phase.astype(np.int64) % pat_n
    else:
        idx = phase.astype(np.int64)
        # break conditions: local >= pat_n breaks BEFORE reading i;
        # phase+inc >= pat_n breaks AFTER reading i (:799-814)
        stop_before = local >= pat_n
        stop_after = (phase + inc_eff >= pat_n) & valid
        b1 = int(np.argmax(stop_before)) if stop_before.any() else n_total
        b2 = (int(np.argmax(stop_after)) + 1) if stop_after.any() else n_total
        valid = valid & (i < min(b1, b2))
        valid = valid & (idx >= 0) & (idx < pat_n)
    idx = np.clip(idx, 0, pat_n - 1)
    return idx, valid


# ---------------------------------------------------------------------------
# Device mixdown: each track's placement rebuilt on the device from compact
# tables (resets + static config), the cross-track mod-speed chain, the
# gather from the flat pattern bank, and the mix.  Host -> device per
# render: nothing once the bank and the reset tables are resident.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _TrackMeta:
    pat_n: int           # pattern length in samples (0 = silent track)
    base: int            # offset of this track's pattern in the flat bank
    start_idx: int       # start offset in master samples (may be < 0)
    loop: bool
    mod_src: int         # index of the mod-source track, -1 = unmodulated
    win: int             # RMS window (samples)
    a_q12: int           # mod amount in 2**-12 units (envdet.amount_q12)
    gain: float          # linear gain, an exact f32 value


@dataclass(frozen=True)
class _MixMeta:
    n_total: int         # render length in samples
    tracks: tuple
    pcm16: bool = False


def _track_positions(i: torch.Tensor, inc: torch.Tensor,
                     reset_mask: torch.Tensor, tm: _TrackMeta,
                     n_total: int):
    """Exclusive segmented fixed-point positions and validity of one track
    (the reference's phase accumulator, grid_audio_app.py:786-814, as
    exact integer math); ``inc`` is the per-sample speed in 2**-22 units,
    int32 [n_total]."""
    inc_eff = torch.where(i >= tm.start_idx, inc, 0)
    shifted = torch.cat([inc_eff.new_zeros(1), inc_eff[:-1]])
    shifted = torch.where(reset_mask, 0, shifted)

    if tm.start_idx < 0:
        if tm.mod_src >= 0:
            # pre-roll phase = the sum of the first prelen increments (the
            # speed array is n_total long, so it saturates there), kept on
            # the device: the JAX package reads it off a second cumsum
            prelen = min(-tm.start_idx, n_total)
            pre = inc[:prelen].to(torch.int64).sum()
            pre_w, pre_f = pre >> fixq.POS_FRAC_BITS, pre & fixq.POS_MASK
        else:
            # unit speed: the FULL -start_idx, uncapped
            pre_w, pre_f = -tm.start_idx, 0
    else:
        pre_w, pre_f = 0, 0

    whole, frac = fixq.segmented_pos_cumsum(shifted, reset_mask, pre_w,
                                            pre_f)
    local = i - tm.start_idx
    valid = local >= 0
    if tm.loop:
        idx = torch.remainder(whole, tm.pat_n)
    else:
        idx = whole
        # break BEFORE reading i: local rises with i, so this mask is
        # already its own running "any" (the JAX package's cumsum > 0)
        stop_before = local >= tm.pat_n
        wa, _ = fixq.pos_add(whole, frac, inc_eff)
        stop_after = ((wa >= tm.pat_n) & valid).to(torch.int32)
        # break AFTER reading i: any stop strictly before i
        sa = (torch.cumsum(stop_after, 0, dtype=torch.int32)
              - stop_after) > 0
        valid = valid & ~stop_before & ~sa & (idx >= 0) & (idx < tm.pat_n)
    return torch.clamp(idx, 0, tm.pat_n - 1), valid


def _mix(meta: _MixMeta, flat_pat: torch.Tensor,
         resets: tuple) -> torch.Tensor:
    """The device mix: f32 [n_total], or int16 with ``meta.pcm16``.
    ``resets[ti]``: int64 reset sample indices of track ti on the device."""
    n = meta.n_total
    dev = flat_pat.device
    i = torch.arange(n, dtype=torch.int32, device=dev)
    placed_cache = {}
    mix = torch.zeros(n, dtype=torch.float32, device=dev)
    mod_srcs = {tm.mod_src for tm in meta.tracks if tm.mod_src >= 0}
    for ti, tm in enumerate(meta.tracks):
        if tm.pat_n <= 0:
            placed = torch.zeros(n, dtype=torch.float32, device=dev)
        else:
            if tm.mod_src >= 0:
                inc = envdet.mod_speed_fix(placed_cache[tm.mod_src], tm.win,
                                           tm.a_q12)
            else:
                inc = torch.full((n,), fixq.POS_ONE, dtype=torch.int32,
                                 device=dev)
            reset_mask = torch.zeros(n, dtype=torch.bool, device=dev) \
                .index_fill_(0, resets[ti], True)
            idx, valid = _track_positions(i, inc, reset_mask, tm, n)
            # the bank is gain-premultiplied on the host, so the gather
            # gives the host twin's pat[idx] * gain exactly
            pat = flat_pat[tm.base: tm.base + tm.pat_n]
            placed = torch.where(valid, pat[idx], 0.0)
        if ti in mod_srcs:
            placed_cache[ti] = placed
        mix = mix + placed                     # pinned track order
    mix = torch.clamp(mix, -1.0, 1.0)
    if meta.pcm16:
        # PCM16 on the device (the reference exports PCM_16 WAVs), half
        # the bytes to pull
        return torch.clamp(torch.round(mix * 32768.0), -32768.0,
                           32767.0).to(torch.int16)
    return mix


def mod_speed_for_track(placed_src: np.ndarray, smoothing_ms: float,
                        amount: float, sr: int) -> np.ndarray:
    """Quantized f32 per-sample speed from a mod-source track's placed
    audio: the envdet chain that the host engine, the device engine and
    the oracle tests share bit for bit (grid_audio_app.py:735-742)."""
    win = max(1, int(round(max(0.0, smoothing_ms) * 0.001 * sr)))
    inc = envdet.mod_speed_fix_np(placed_src, win, envdet.amount_q12(amount))
    return envdet.speed_q_from_fix_np(inc)


def _build_mix_program(project: GridProject, device="cuda"):
    """Host pre-pass shared by both engines: restart events, per-track
    patterns (the cells run with ``device`` in their context), reset
    tables and the static placement config."""
    sr = project.sample_rate
    master_dur = project.master.duration(project.tracks)
    n_total = int(round(master_dur * sr))
    restarts = collect_restart_events(project, master_dur, device)

    rows = []
    for ti, t in enumerate(project.tracks):
        divs = t.build_divisions()
        pat = np.zeros(0, np.float32)
        pat_dur = float(sum(divs)) if divs else 0.0
        sync_pts = parse_float_list(t.sync_points_text)
        if divs and pat_dur > 1e-9:
            t.ensure_cells(len(divs))
            pat = render_track_pattern(project, ti, t, divs, pat_dur,
                                       sync_pts, device)
        reset = set(int(round(p * sr)) for p in sync_pts if p >= 0.0)
        reset |= restarts[ti]
        reset = np.asarray(sorted(r for r in reset if 0 <= r < n_total),
                           np.int32)
        modded = (t.mod_source_index >= 0 and t.mod_amount > 0
                  and t.mod_source_index < ti and len(pat) > 0)
        rows.append({
            "pat": pat,
            "start_idx": int(round(t.start_offset_seconds * sr)),
            "loop": bool(t.loop_to_master),
            "resets": reset,
            "mod_src": int(t.mod_source_index) if modded else -1,
            "win": max(1, min(n_total,
                              int(round(max(0.0, t.mod_smoothing_ms)
                                        * 0.001 * sr)))),
            "a_q12": envdet.amount_q12(t.mod_amount) if modded else 0,
            "gain": float(np.float32(10.0 ** (float(t.gain_db) / 20.0))),
        })
    return n_total, rows


def _host_mixdown(n_total: int, rows: list, return_tracks: bool):
    """Host engine: exact placement through ``placement_indices`` (the f64
    accumulation of 2**-22-quantized speeds is exact, so it matches the
    device engine's fixed-point positions bit for bit), host gather and
    mix."""
    placed_tracks: List[np.ndarray] = []
    mix = np.zeros(n_total, np.float32)
    for row in rows:
        pat = row["pat"]
        if len(pat) == 0:
            placed_tracks.append(np.zeros(n_total, np.float32))
            continue
        speed = None
        if row["mod_src"] >= 0:
            inc = envdet.mod_speed_fix_np(placed_tracks[row["mod_src"]],
                                          row["win"], row["a_q12"])
            speed = envdet.speed_q_from_fix_np(inc)
        idx, valid = placement_indices(
            n_total, len(pat), 0.0, 1, row["loop"], speed,
            set(int(r) for r in row["resets"]), start_idx=row["start_idx"])
        placed = np.where(valid, pat[idx], 0.0).astype(np.float32) \
            * np.float32(row["gain"])
        placed_tracks.append(placed)
        mix = mix + placed                     # pinned track order
    mix = np.clip(mix, -1.0, 1.0).astype(np.float32)
    return (mix, placed_tracks) if return_tracks else (mix, None)


_BANK_CACHE = Memo(8)


def _bank_device_cached(flat_pat: np.ndarray, device) -> torch.Tensor:
    """The pattern bank on ``device``, cached on (content hash, device):
    re-renders of an unchanged project upload nothing.  Bounded at 8
    banks, least recently used evicted."""
    key = hashlib.blake2b(flat_pat.view(np.uint8), digest_size=16).digest()
    return _BANK_CACHE.get(
        key, lambda: torch.as_tensor(flat_pat, device=device),
        device=device)[0]


@dataclass(frozen=True)
class _PreparedMix:
    """Host pre-pass product for the device engine: the static meta, the
    device-resident bank (gain-premultiplied) and each track's reset
    indices on the device.  Build once (``prepare_device_mix``), render
    many times."""
    meta: _MixMeta
    flat_pat: torch.Tensor
    resets: tuple


def prepare_device_mix(n_total: int, rows: list, pcm16: bool = False, *,
                       device="cuda") -> _PreparedMix:
    """The bank and reset tables of ``rows`` on ``device``, and the meta
    of a render of ``n_total`` samples."""
    bases, flat, metas = [], [], []
    off = 0
    for row in rows:
        bases.append(off)
        flat.append(row["pat"] * np.float32(row["gain"]))
        off += len(row["pat"])
    flat_pat = (np.concatenate(flat).astype(np.float32)
                if off else np.zeros(1, np.float32))
    flat_pat = _bank_device_cached(flat_pat, device)
    resets = tuple(torch.as_tensor(np.asarray(row["resets"], np.int64),
                                   device=device) for row in rows)
    for ti, row in enumerate(rows):
        metas.append(_TrackMeta(
            pat_n=len(row["pat"]), base=bases[ti],
            start_idx=row["start_idx"], loop=row["loop"],
            mod_src=row["mod_src"], win=row["win"], a_q12=row["a_q12"],
            gain=row["gain"]))
    meta = _MixMeta(n_total=n_total, tracks=tuple(metas), pcm16=pcm16)
    return _PreparedMix(meta=meta, flat_pat=flat_pat, resets=resets)


def _device_mixdown(n_total: int, rows: list, device_out: bool = False,
                    pcm16: bool = False, prepared: _PreparedMix = None, *,
                    device="cuda"):
    """Device engine: the mix of ``prepared`` (or of ``rows``, prepared
    on ``device``); exactly ``n_total`` samples, a host array or, with
    ``device_out``, the tensor on the device."""
    prep = prepared if prepared is not None \
        else prepare_device_mix(n_total, rows, pcm16, device=device)
    y = _mix(prep.meta, prep.flat_pat, prep.resets)
    if device_out:
        return y
    return y.cpu().numpy()


_PROGRAM_CACHE = Memo(4)


def _project_cache_key(project: GridProject) -> bytes:
    """Content hash of everything ``_build_mix_program`` reads: the project
    dict and (path, mtime_ns, size) of every referenced cell file, so an
    edited user script rebuilds on the next render."""
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(project_to_dict(project), sort_keys=True).encode())
    for t in project.tracks:
        for c in t.cells:
            if c.kind in ("py", "wav") and c.path:
                try:
                    st = os.stat(c.path)
                    h.update(f"{c.path}:{st.st_mtime_ns}:{st.st_size}"
                             .encode())
                except OSError:
                    h.update(f"{c.path}:missing".encode())
    return h.digest()


def build_mix_program_cached(project: GridProject, device="cuda") -> dict:
    """``_build_mix_program`` memoized on project content and the render's
    device: {"n_total", "rows", "prep"}, where "prep" holds the prepared
    device mixes by pcm16.  LRU-bounded at 4 entries.  The device is in
    the key because the cells run on it (``context["device"]``): a
    program whose cells ran on one device never serves a render on
    another, so each device a project renders on pays one host build."""
    def build():
        n_total, rows = _build_mix_program(project, device)
        return {"n_total": n_total, "rows": rows, "prep": {}}
    return _PROGRAM_CACHE.get(_project_cache_key(project), build,
                              device=device)[0]


def render_mixdown(project: GridProject, return_tracks: bool = False,
                   engine: str = "device", pcm16: bool = False, *,
                   device="cuda"):
    """Full mixdown (grid_audio_app.py:708-756): restart pre-pass ->
    per-track pattern -> mod-speed envelope -> reset-aware placement ->
    gain -> sum -> clip (+ the project's 0.98 peak normalize), as a host
    array.

    engine="device" (default): placement, mod chain and mix on ``device``
    from the memoized program.  engine="host": the host engine (the same
    integers and floats); ``return_tracks`` also takes the host engine,
    which builds every placed track anyway.  pcm16=True (device engine, no
    normalize): int16 from the device."""
    entry = build_mix_program_cached(project, device)
    n_total, rows = entry["n_total"], entry["rows"]

    if engine == "device" and not return_tracks:
        want_pcm16 = pcm16 and not project.normalize
        prep = entry["prep"].get(want_pcm16)
        if prep is None:
            prep = prepare_device_mix(n_total, rows, pcm16=want_pcm16,
                                      device=device)
            entry["prep"][want_pcm16] = prep
        mix = _device_mixdown(n_total, rows, prepared=prep)
        if want_pcm16:
            return mix
        placed_tracks = None
    else:
        mix, placed_tracks = _host_mixdown(n_total, rows, True)

    if project.normalize:
        peak = float(np.max(np.abs(mix))) if mix.size else 0.0
        if peak > 1e-12:
            mix = (mix * (0.98 / peak)).astype(np.float32)

    if return_tracks:
        return mix, placed_tracks
    return mix


def export_wav(project: GridProject, path: str, *,
               device="cuda") -> np.ndarray:
    """Render + save (grid_audio_app.py:579-598)."""
    mix = render_mixdown(project, device=device)
    audio_io.write_wav(path, mix, project.sample_rate)
    return mix


# ---------------------------------------------------------------------------
# Project JSON I/O (the framework's config-file replacement for the UI)
# ---------------------------------------------------------------------------

def project_to_dict(project: GridProject) -> dict:
    return {
        "sample_rate": project.sample_rate,
        "normalize": project.normalize,
        "master": {"mode": project.master.mode,
                   "fixed_seconds": project.master.fixed_seconds},
        "tracks": [
            {**{k: v for k, v in asdict(t).items() if k != "cells"},
             "cells": [{"kind": c.kind, "path": c.path} for c in t.cells]}
            for t in project.tracks],
    }


def project_from_dict(d: dict) -> GridProject:
    """A project from its dict; ``project_from_dict(p.project_to_dict())``
    of the JAX package's ``GridProject`` gives the port's."""
    tracks = []
    for td in d.get("tracks", []):
        cells = [CellSource(c.get("kind", "empty"), c.get("path", ""))
                 for c in td.get("cells", [])]
        kw = {k: v for k, v in td.items()
              if k in Track.__dataclass_fields__ and k != "cells"}
        tracks.append(Track(cells=cells, **kw))
    m = d.get("master", {})
    return GridProject(
        tracks=tracks,
        master=MasterClock(m.get("mode", "auto"),
                           m.get("fixed_seconds", 16.0)),
        sample_rate=int(d.get("sample_rate", 44100)),
        normalize=bool(d.get("normalize", False)))


def load_project(path: str) -> GridProject:
    """A project JSON file; relative cell paths resolve against its
    directory."""
    with open(path) as f:
        project = project_from_dict(json.load(f))
    base = os.path.dirname(os.path.abspath(path))
    for t in project.tracks:
        for c in t.cells:
            if c.path and not os.path.isabs(c.path):
                c.path = os.path.normpath(os.path.join(base, c.path))
    return project


def save_project(project: GridProject, path: str):
    with open(path, "w") as f:
        json.dump(project_to_dict(project), f, indent=2)

"""Varispeed tape playback — port of audio_suite_tpu/ops/varispeed.py: the
host control path and the three device engines.

Positions are exact int32 fixed point (``ops/fixq.py``), so every discrete
decision (section lookup, read index, splice trigger, boundary distance)
is integer math and bit-identical to the JAX package and its NumPy oracle.

- Host (NumPy, copies of the JAX package's functions, held bit-equal to
  them in the tests): ``tape_trajectory`` (per-sample read index,
  fraction and gains) and ``tape_tables`` (the compact control tables, with
  the raw boundary ``hits`` the trace renderer's splice machine needs;
  the C++ twin in ``utils/native_rt.py`` returns no ``hits``).
- The control tables on the card, ``tape_tables_on_card``: the C++
  walk's decisions (inertia off) by ``kernels/tape_scan.cu``'s table
  walk, from one copy of its inputs to one pull of the records; its
  plain twin ``tape_tables_plain`` runs the same chunk search on the CPU.
- The table engine, ``tape_device_render``: the device rebuilds every
  sample from the tables (``tape_positions``: the wow/flutter curve
  through the detmath twins, run expansion, the segmented position sum,
  the read index, the anti-click x splice gain, and with ``with_pieces``
  the trace renderer's splice-envelope pieces), then the linear read
  (``ops/lerp_read.py``, the CUDA kernel on the card) or the sinc read
  (``fixq.gather_sinc_clip``, plain PyTorch), gain, clip and PCM16: two
  device stages of the tracer, ``tape.positions`` and ``tape.read``.
- The segment engine, ``tape_segment_render``: the C++ per-sample
  trajectory, then ``tape_gather_render`` (the same linear read, the
  combined gain, the clip).
- The scan engine, ``tape_scan_render``: the reference-structured per-
  sample recurrence with the inertia, splice and position state carried
  from sample to sample, on the hand-written kernel
  ``kernels/tape_scan.cu`` for CUDA tensors and ``tape_scan_render_plain``
  (a per-sample loop mirroring the JAX step) for CPU tensors.

The JAX package pads the tables to powers of two and the render to 32 768-
sample buckets only to avoid XLA recompiles; PyTorch runs eagerly, so the
port renders exactly T samples (the padding changes no sample below T).
Its blockwise one-hot read and detect-and-patch are TPU machinery and are
not ported.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..utils.profiling import span
from . import detmath
from .fixq import (POS_FRAC_BITS, POS_INV_F, POS_ONE, gather_sinc_clip,
                   quantize_f32, round_sig12, segmented_pos_cumsum)
from .lerp_read import lerp_read, lerp_read_plain

_INV = float(POS_INV_F)


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




class TapeState(NamedTuple):
    """The scan engine's carried playback state, each a 0-d tensor on the
    render's device."""
    whole: torch.Tensor       # int32: integer sample part of the position
    frac: torch.Tensor        # int32: fractional part in 2**-POS_FRAC_BITS
    speed: torch.Tensor       # f32: current (inertia-smoothed) speed
    splice_rem: torch.Tensor  # int32: splice envelope samples remaining
    splice_idx: torch.Tensor  # int32: splice envelope read index


# ----------------------------------------------------------------------------
# Host control path (NumPy): copies of the JAX package's
# varispeed.py:227-666, bit-equal to them
# ----------------------------------------------------------------------------

def _speed_steps_np(speed_q: np.float32, target_q: np.float32,
                    alpha_q: np.float32, max_n: int) -> np.ndarray:
    """Speeds for up to max_n steps of the quantized one-pole
    speed += quantize_f32((target - speed) * alpha) (the scan's inertia
    branch), enumerated by runs of equal quantized step.  Returns the f32
    speeds array (may be shorter than max_n if the speed freezes — the
    caller extends with the frozen value)."""
    out = []
    s_int = int(np.rint(np.float64(speed_q) * POS_ONE))
    t_int = int(np.rint(np.float64(target_q) * POS_ONE))

    def step_int(si):
        d = np.float32(np.float32((t_int - si) * POS_INV_F))
        m = np.float32(d * alpha_q)
        return int(np.rint(np.float64(np.float32(m)) * POS_ONE))

    # vectorized accept-prefix run enumeration: evaluate the quantized step
    # over a window of candidate states at once (exact f32 path mirrored),
    # accept the leading stretch that still uses step m
    alpha_f = max(1e-12, float(alpha_q))
    n = 0
    while n < max_n:
        m = step_int(s_int)
        if m == 0:
            break
        k_max = min(max_n - n, int(1.0 / (alpha_f * abs(m))) + 64)
        cand = s_int + m * np.arange(1, k_max + 1, dtype=np.int64)
        d32 = ((t_int - cand).astype(np.float64)
               * POS_INV_F).astype(np.float32)
        m32 = d32 * np.float32(alpha_q)
        mv = np.rint(m32.astype(np.float64) * POS_ONE).astype(np.int64)
        diff = np.nonzero(mv != m)[0]
        k = int(diff[0]) + 1 if diff.size else k_max
        out.append(cand[:k])
        s_int = int(cand[k - 1])
        n += k
    if out:
        speeds_int = np.concatenate(out)
    else:
        speeds_int = np.zeros(0, np.int64)
    return (speeds_int.astype(np.float32) * POS_INV_F).astype(np.float32)


def tape_trajectory(audio_n: int, mod_q, starts, ends, speeds_q, reverse,
                    boundaries, splice_env_len: int, consts: TapeConsts,
                    init_whole: int = 0, init_frac: int = 0):
    """Host computation of the full playback control path, bit-identical to
    tape_scan_render's decisions.  Returns a dict with per-output-sample
    idx0 (i32), fr (f32), ga (anti-click gains f32), gs (splice gains f32)
    and the final TapeState fields."""
    T = len(mod_q)
    n = int(audio_n)
    mod_q = np.asarray(mod_q, np.float32)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    speeds_q = np.asarray(speeds_q, np.float32)
    reverse = np.asarray(reverse, bool)
    boundaries = np.asarray(boundaries, np.int64)
    num_secs = len(starts)

    whole = np.empty(T, np.int32)
    frac = np.empty(T, np.int32)
    sec_arr = np.empty(T, np.int32)

    w = int(init_whole)
    f = int(init_frac)
    speed = np.float32(consts.initial_speed_q)
    alpha_q = np.float32(consts.alpha_q)
    i = 0
    CHUNK = 1 << 16
    while i < T:
        w = w % n
        sec = min(max(int(np.searchsorted(starts, w, side="right")) - 1, 0),
                  num_secs - 1)
        sec_start = int(starts[sec])
        sec_end = int(ends[sec])
        if sec_end <= sec_start:
            sec_end = sec_start + 1
        target = np.float32(speeds_q[sec])

        # distance (fix units) until wrapped whole reaches sec_end
        d_fix = (sec_end - w) * POS_ONE - f

        # build the speed curve for this visit (inertia convergence runs,
        # then frozen), chunked until the crossing is found
        conv = (_speed_steps_np(speed, target, alpha_q, T - i)
                if consts.inertia_on else np.zeros(0, np.float32))
        j = i
        acc = 0
        while True:
            k0 = j - i
            kn = min(CHUNK, T - j)
            if kn <= 0:
                break
            spd = np.empty(kn, np.float32)
            c = min(max(len(conv) - k0, 0), kn)
            if c > 0:
                spd[:c] = conv[k0:k0 + c]
            if c < kn:
                if not consts.inertia_on:
                    spd[c:] = target
                elif len(conv) == 0:
                    spd[c:] = speed          # frozen from the start
                else:
                    spd[c:] = conv[-1]       # frozen after convergence
            # rint(speed*mod * POS_ONE): ONE f32 multiply + exact 2**22
            # scale, bit-identical to fixq.inc_fix on device
            inc = np.rint((spd * mod_q[j:j + kn])
                          * np.float32(POS_ONE)).astype(np.int64)
            csum = np.cumsum(inc)
            hit = int(np.searchsorted(csum, d_fix - acc, side="left"))
            m = min(hit + 1, kn)
            # positions for samples j..j+m-1: pre-advance state
            excl = np.concatenate([[0], csum[:m - 1]]) + acc
            fv = f + excl
            carry = fv >> POS_FRAC_BITS
            whole[j:j + m] = w + carry
            frac[j:j + m] = fv - (carry << POS_FRAC_BITS)
            sec_arr[j:j + m] = sec
            if hit < kn:
                # crossing happened after consuming samples j..j+hit
                fv_end = f + acc + int(csum[hit])
                carry = fv_end >> POS_FRAC_BITS
                w_end = w + carry
                f_end = fv_end - (carry << POS_FRAC_BITS)
                speed = np.float32(spd[hit])
                j += hit + 1
                w, f = int(w_end), int(f_end)
                break
            acc += int(csum[-1])
            speed = np.float32(spd[-1])
            j += kn
            if j >= T:
                fv_end = f + acc
                carry = fv_end >> POS_FRAC_BITS
                w, f = int(w + carry), int(fv_end - (carry << POS_FRAC_BITS))
                break
        i = j

    # ---- read index mapping (mirror of _read_index) ----
    wrapped = np.mod(whole, n)
    sec = sec_arr
    sec_start = starts[sec]
    sec_end = np.maximum(ends[sec], sec_start + 1)
    sec_len = sec_end - sec_start
    local_w = np.mod(wrapped - sec_start, sec_len)
    rev = reverse[np.clip(sec, 0, num_secs - 1)]

    idx_f = sec_start + local_w
    fr_f = frac.astype(np.float32) * POS_INV_F

    a = sec_end - 1 - local_w
    has_frac = frac > 0
    idx_r = np.where(has_frac, a - 1, a)
    fr_r = np.where(has_frac,
                    (POS_ONE - frac).astype(np.float32) * POS_INV_F,
                    np.float32(0.0))
    neg = (a == 0) & has_frac
    idx_r = np.where(neg, 0, idx_r)
    fr_r = np.where(neg, -frac.astype(np.float32) * POS_INV_F, fr_r)

    idx0 = np.where(rev, idx_r, idx_f)
    fr = np.where(rev, fr_r, fr_f).astype(np.float32)
    idx0 = np.clip(idx0, 0, n - 1).astype(np.int64)

    # ---- anti-click gains (mirror of the scan branch) ----
    ga = np.ones(T, np.float32)
    if consts.anticlick_on and len(boundaries) > 0 and consts.smooth_len > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        lo = boundaries[np.clip(jb - 1, 0, nb - 1)]
        hi = boundaries[np.clip(jb, 0, nb - 1)]
        d_lo = np.where(jb - 1 >= 0, np.abs(idx0 - lo), 2**30)
        d_hi = np.where(jb < nb, np.abs(hi - idx0), 2**30)
        dmin = np.minimum(d_lo, d_hi)
        inv_smooth = np.float32(1.0 / max(1, consts.smooth_len))
        x = (consts.smooth_len - dmin).astype(np.float32) * inv_smooth
        gain = np.maximum(np.float32(0.0),
                          np.float32(1.0)
                          - np.float32(consts.anticlick_strength) * x)
        ga = np.where(dmin < consts.smooth_len, gain,
                      np.float32(1.0)).astype(np.float32)

    # ---- splice gains (greedy trigger suppression, mirror of scan state) --
    gs = np.ones(T, np.float32)
    splice_rem = 0
    splice_idx = 0
    if consts.splice_on and len(boundaries) > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        hit = (jb < nb) & (boundaries[np.clip(jb, 0, nb - 1)] == idx0)
        hits = np.nonzero(hit)[0]
        env = None
        last_end = -1
        for t in hits:
            if t < last_end:
                continue
            if env is None:
                x = np.linspace(0, 1, splice_env_len, dtype=np.float32)
                env = (1.0 + 0.8 * np.exp(-5.0 * x)).astype(np.float32)
            e = min(T, t + splice_env_len)
            gs[t:e] = env[: e - t]
            last_end = t + splice_env_len
        if last_end > T:
            splice_rem = last_end - T
            splice_idx = splice_env_len - splice_rem

    final = dict(whole=int(w), frac=int(f),
                 speed=float(speed), splice_rem=int(splice_rem),
                 splice_idx=int(splice_idx))
    return dict(idx0=idx0.astype(np.int32), fr=fr, ga=ga, gs=gs,
                final=final)


# The table engine's compact control tables: section visits with their
# entry positions, the inertia speed curve as arithmetic-progression runs,
# and the splice triggers.

def _ap_runs(s_ints):
    """Segment an integer sequence into maximal arithmetic progressions.
    Returns a list of (start_index, s0, m) with
    s[j] = s0 + m*(j - start_index) for j in [start, next_start)."""
    c = len(s_ints)
    if c == 0:
        return []
    if c == 1:
        return [(0, int(s_ints[0]), 0)]
    d = np.diff(s_ints)
    chg = np.nonzero(np.diff(d) != 0)[0] + 1   # k with d[k] != d[k-1]
    runs = []
    p = 0
    while p < c:
        if p >= c - 1:
            runs.append((p, int(s_ints[p]), 0))
            break
        ci = int(np.searchsorted(chg, p, side="right"))
        q = int(chg[ci]) if ci < len(chg) else len(d)
        runs.append((p, int(s_ints[p]), int(d[p])))
        p = q + 1
    return runs


def tape_tables(audio_n: int, mod_q, starts, ends, speeds_q, reverse,
                boundaries, splice_env_len: int, consts: TapeConsts,
                init_whole: int = 0, init_frac: int = 0):
    """Host control path in compact-table form (NumPy reference; the C++
    twin is native_rt.tape_tables).  Decision-identical to tape_trajectory;
    returns visit/run/trigger tables + final state instead of per-sample
    arrays."""
    T = len(mod_q)
    n = int(audio_n)
    mod_q = np.asarray(mod_q, np.float32)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    speeds_q = np.asarray(speeds_q, np.float32)
    reverse = np.asarray(reverse, bool)
    boundaries = np.asarray(boundaries, np.int64)
    num_secs = len(starts)

    vis_start, vis_bw, vis_bf, vis_sec = [], [], [], []
    runs = []                      # (global_start, s0_int, m_int)

    w = int(init_whole)
    f = int(init_frac)
    speed = np.float32(consts.initial_speed_q)
    alpha_q = np.float32(consts.alpha_q)
    i = 0
    CHUNK = 1 << 16
    while i < T:
        w = w % n
        sec = min(max(int(np.searchsorted(starts, w, side="right")) - 1, 0),
                  num_secs - 1)
        sec_start = int(starts[sec])
        sec_end = int(ends[sec])
        if sec_end <= sec_start:
            sec_end = sec_start + 1
        target = np.float32(speeds_q[sec])
        d_fix = (sec_end - w) * POS_ONE - f

        vis_start.append(i)
        vis_bw.append(w)
        vis_bf.append(f)
        vis_sec.append(sec)

        conv = (_speed_steps_np(speed, target, alpha_q, T - i)
                if consts.inertia_on else np.zeros(0, np.float32))
        if consts.inertia_on:
            frozen = np.float32(conv[-1]) if len(conv) else speed
        else:
            frozen = target

        # crossing search (identical decisions to tape_trajectory)
        j = i
        acc = 0
        while True:
            k0 = j - i
            kn = min(CHUNK, T - j)
            if kn <= 0:
                break
            spd = np.empty(kn, np.float32)
            c = min(max(len(conv) - k0, 0), kn)
            if c > 0:
                spd[:c] = conv[k0:k0 + c]
            if c < kn:
                spd[c:] = frozen
            inc = np.rint((spd * mod_q[j:j + kn])
                          * np.float32(POS_ONE)).astype(np.int64)
            csum = np.cumsum(inc)
            hit = int(np.searchsorted(csum, d_fix - acc, side="left"))
            if hit < kn:
                fv_end = f + acc + int(csum[hit])
                carry = fv_end >> POS_FRAC_BITS
                w = int(w + carry)
                f = int(fv_end - (carry << POS_FRAC_BITS))
                speed = np.float32(spd[hit])
                j += hit + 1
                break
            acc += int(csum[-1])
            speed = np.float32(spd[-1])
            j += kn
            if j >= T:
                fv_end = f + acc
                carry = fv_end >> POS_FRAC_BITS
                w = int(w + carry)
                f = int(fv_end - (carry << POS_FRAC_BITS))
                break

        # speed runs for visit [i, j)
        L = j - i
        cL = min(L, len(conv))
        if cL > 0:
            s_ints = np.rint(conv[:cL].astype(np.float64)
                             * POS_ONE).astype(np.int64)
            for (rs, s0, m) in _ap_runs(s_ints):
                if rs < cL:
                    runs.append((i + rs, s0, m))
        if L > cL:
            frozen_int = int(np.rint(np.float64(frozen) * POS_ONE))
            if runs and runs[-1][1] == frozen_int and runs[-1][2] == 0 \
                    and cL == 0:
                pass                       # merged with previous frozen run
            else:
                runs.append((i + cL, frozen_int, 0))
        i = j

    # ---- vectorized position reconstruction (NumPy twin of the device
    # kernel) — needed host-side only to locate splice triggers ----
    vs = np.asarray(vis_start, np.int64)
    rs_a = np.asarray([r[0] for r in runs], np.int64)
    s0_a = np.asarray([r[1] for r in runs], np.int64)
    m_a = np.asarray([r[2] for r in runs], np.int64)
    ii = np.arange(T, dtype=np.int64)
    rid = np.searchsorted(rs_a, ii, side="right") - 1
    s_int = s0_a[rid] + m_a[rid] * (ii - rs_a[rid])
    spd_all = (s_int.astype(np.float32) * POS_INV_F).astype(np.float32)
    inc_all = np.rint((spd_all * mod_q) * np.float32(POS_ONE)).astype(np.int64)
    excl = np.cumsum(inc_all) - inc_all
    vid = np.searchsorted(vs, ii, side="right") - 1
    rel = excl - excl[vs[vid]]
    fv = np.asarray(vis_bf, np.int64)[vid] + rel
    carry = fv >> POS_FRAC_BITS
    whole = np.asarray(vis_bw, np.int64)[vid] + carry
    frac = fv - (carry << POS_FRAC_BITS)
    sec = np.asarray(vis_sec, np.int64)[vid]

    # read-index mapping (mirror of _read_index) for trigger detection
    wrapped = np.mod(whole, n)
    sec_start = starts[sec]
    sec_end = np.maximum(ends[sec], sec_start + 1)
    local_w = np.mod(wrapped - sec_start, sec_end - sec_start)
    rev = reverse[np.clip(sec, 0, num_secs - 1)]
    idx_f = sec_start + local_w
    a = sec_end - 1 - local_w
    has_frac = frac > 0
    idx_r = np.where(has_frac, a - 1, a)
    idx_r = np.where((a == 0) & has_frac, 0, idx_r)
    idx0 = np.where(rev, idx_r, idx_f)
    idx0 = np.clip(idx0, 0, n - 1)

    triggers = []
    splice_rem = 0
    splice_idx = 0
    hits = np.zeros(0, np.int64)
    if len(boundaries) > 0:
        jb = np.searchsorted(boundaries, idx0)
        nb = len(boundaries)
        hitm = (jb < nb) & (boundaries[np.clip(jb, 0, nb - 1)] == idx0)
        hits = np.nonzero(hitm)[0]
    if consts.splice_on and len(boundaries) > 0:
        last_end = -1
        for t in hits:
            if t < last_end:
                continue
            triggers.append(int(t))
            last_end = t + splice_env_len
        if last_end > T:
            splice_rem = last_end - T
            splice_idx = splice_env_len - splice_rem

    final = dict(whole=int(w), frac=int(f), speed=float(speed),
                 splice_rem=int(splice_rem), splice_idx=int(splice_idx))
    return dict(
        visit_start=np.asarray(vis_start, np.int32),
        visit_bw=np.asarray(vis_bw, np.int32),
        visit_bf=np.asarray(vis_bf, np.int32),
        visit_sec=np.asarray(vis_sec, np.int32),
        run_start=np.asarray([r[0] for r in runs], np.int32),
        run_s0=np.asarray([r[1] for r in runs], np.int32),
        run_m=np.asarray([r[2] for r in runs], np.int32),
        triggers=np.asarray(triggers, np.int32),
        # pre-suppression boundary-hit sample indices: the trace renderer's
        # splice state machine (models/tape.py) needs raw hits because a
        # carried-in envelope (rem > 0 at segment entry) changes WHICH hits
        # trigger — greedy-suppressed triggers can't recover that
        hits=np.asarray(hits, np.int64),
        final=final)


# ----------------------------------------------------------------------------
# The control tables on the card (kernels/tape_scan.cu's table walk) and
# its plain twin: the C++ walk's decisions by chunk sums
# ----------------------------------------------------------------------------

#: the records a table holds before the walk runs again with room
TABLES_CAP = 256
_TABLES_PULL = 512          # int32 words of the output's first pull
# the tables in the order the card walk packs them (4 of visits, 3 of runs)
_TABLE_NAMES = ("visit_start", "visit_bw", "visit_bf", "visit_sec",
                "run_start", "run_s0", "run_m", "triggers")


def _speed_rows(speeds_q):
    """Each section's row among the distinct speeds (in order of first
    use), and each row's integer t = rint(f64(speed) * 2**22) and f32
    speed t * 2**-22, as the C++ walk makes them."""
    t = np.rint(np.asarray(speeds_q, np.float32).astype(np.float64)
                * POS_ONE).astype(np.int64)
    _, first, inv = np.unique(t, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    row_t = t[np.sort(first)]
    row_v = (row_t.astype(np.float64) * 2.0 ** -POS_FRAC_BITS) \
        .astype(np.float32)
    return rank[inv.reshape(-1)].astype(np.int32), row_t, row_v


def _s_init(consts: TapeConsts) -> int:
    """The initial speed's fixed-point integer, as the C++ walk makes
    it."""
    return int(np.rint(np.float64(np.float32(consts.initial_speed_q))
                       * POS_ONE))


def _room(counts, cap: int) -> int:
    """The capacity of the walk's next run after a table passed ``cap``
    with these counts."""
    return int(max(max(int(c) for c in counts) + 16, cap * 2))


def _final(whole, frac, s_int, rem, sidx) -> dict:
    """The walk's final playback state as ``native_rt.tape_tables`` gives
    it."""
    speed = np.int64(s_int) * np.float32(1.0 / (1 << POS_FRAC_BITS))
    return dict(whole=int(whole), frac=int(frac),
                speed=float(np.float32(speed)), splice_rem=int(rem),
                splice_idx=int(sidx))


def tables_kernel_args(T: int, n: int, mod_consts, starts, ends, speeds_q,
                       reverse, boundaries, splice_env, consts: TapeConsts,
                       device) -> tuple:
    """``kernels.tape_tables``' arguments but the chunk and the capacity:
    the packed input, one int32 array copied to ``device`` at once (the
    sections' starts, ends, reverse flags and speed rows, the boundaries,
    the rows' f32 speeds (their bits) and integers (``_speed_rows``), then
    the splice envelope's f32 bits: the render's, not the walk's), its
    sizes, T, n, the envelope's length, the splice flag, the initial
    speed's integer and the wow/flutter and sine constants."""
    row, row_t, row_v = _speed_rows(speeds_q)
    packed = np.concatenate([
        np.asarray(starts, np.int32), np.asarray(ends, np.int32),
        np.asarray(reverse, bool).astype(np.int32), row,
        np.asarray(boundaries, np.int32), row_v.view(np.int32),
        row_t.astype(np.int32),
        np.asarray(splice_env, np.float32).view(np.int32)])
    ints, flts, ph0 = mod_consts
    flts = np.concatenate([np.asarray(flts, np.float32),
                           np.asarray(ph0, np.float32)])
    coeffs = np.asarray(detmath._S32 + detmath._C32, np.float32)
    return (torch.as_tensor(packed, device=device), len(starts),
            len(boundaries), len(row_t), int(T), int(n), len(splice_env),
            bool(consts.splice_on), _s_init(consts), ints, flts, coeffs)


def tape_tables_on_card(T: int, n: int, mod_consts, starts, ends, speeds_q,
                        reverse, boundaries, splice_env,
                        consts: TapeConsts, device,
                        chunk: int = kernels.TAPE_SCAN_CHUNK):
    """The control tables of a T-sample render of an n-sample tape from
    position 0 (``native_rt.tape_tables``' decisions; inertia off, every
    speed at most ``models/tape.py:MAX_SPEED``, so that each increment is
    an int32 >= 0 and the prefix is monotone), built on the card by
    ``kernels.tape_tables`` in chunks of ``chunk``: the inputs in one
    copy, the launch, one pull of the header and the records (a second
    where they pass its words), and the launch again with room where a
    table passed its capacity (TABLES_CAP first).

    Returns (tables, tab, walk): ``tables`` the NumPy dict
    ``native_rt.tape_tables`` returns; ``tab`` the tables
    ``tape_positions`` reads that live on the card, views of the output
    and of the input (int32 ``visit_*``, ``run_*``, ``triggers``,
    ``starts``, ``ends``; bool ``reverse``; f32 ``splice_env``); ``walk``
    the chunks walked and jumped and the launches."""
    args = tables_kernel_args(T, n, mod_consts, starts, ends, speeds_q,
                              reverse, boundaries, splice_env, consts,
                              device)
    packed, S, B, R, E = args[0], args[1], args[2], args[3], args[6]
    cap, launches = TABLES_CAP, 0
    while True:
        out = kernels.tape_tables(*args, chunk, cap)
        launches += 1
        head = out[:min(out.shape[0], _TABLES_PULL)].cpu().numpy()
        if not head[3]:
            break
        cap = _room(head[:3], cap)
    nv, nr, nt = (int(c) for c in head[:3])
    words = kernels.TAPE_TABLES_HEAD + 4 * nv + 3 * nr + nt
    if words > head.shape[0]:
        head = out[:words].cpu().numpy()
    fin = np.ascontiguousarray(head[4:14]).view(np.int64)
    tables, tab = {}, {}
    o = kernels.TAPE_TABLES_HEAD
    for name, size in zip(_TABLE_NAMES, (nv,) * 4 + (nr,) * 3 + (nt,)):
        tables[name] = head[o:o + size]
        tab[name] = out[o:o + size]
        o += size
    tables["final"] = _final(*fin[:5])
    env0 = 4 * S + B + 2 * R
    tab.update(starts=packed[:S], ends=packed[S:2 * S],
               reverse=packed[2 * S:3 * S] != 0,
               splice_env=packed[env0:env0 + E].view(torch.float32))
    walk = dict(chunks_walked=int(head[14]), chunks_jumped=int(head[15]),
                launches=launches)
    return tables, tab, walk


class _PlainWalk:
    """The card walk's searches on the CPU (``tape_scan.cu``'s TabWalk):
    a row's increments f32 -> int64 over all T, its chunks' sums, and the
    walked chunks' flags."""

    def __init__(self, T: int, K: int, mod: torch.Tensor, row_v):
        self.T, self.K = T, K
        self.nchunks = -(-T // K)
        self.flags = np.zeros(self.nchunks, bool)
        self._mod, self._row_v = mod, row_v
        self._inc, self._sums = {}, {}

    def inc(self, row: int) -> torch.Tensor:
        if row not in self._inc:
            v = torch.tensor(self._row_v[row], dtype=torch.float32)
            x = torch.round((v * self._mod) * float(POS_ONE)).to(torch.int64)
            pad = self.nchunks * self.K - self.T
            self._inc[row] = x
            self._sums[row] = torch.nn.functional.pad(x, (0, pad)) \
                .view(self.nchunks, self.K).sum(1)
        return self._inc[row]

    def exact(self, p: int, end: int, E: int, target: int, row: int):
        """Samples [p, end) of one chunk from E = E(p): ((k, E(k),
        E(k + 1)), E) for the first k whose E(k + 1) reaches target, or
        (None, E(end))."""
        self.flags[p // self.K] = True
        x = self.inc(row)[p:end]
        c = torch.cumsum(x, 0)
        k = int(torch.searchsorted(c, torch.tensor([target - E])))
        if k == c.shape[0]:
            return None, E + int(c[-1])
        return (p + k, E + int(c[k]) - int(x[k]), E + int(c[k])), E

    def jump(self, c: int, chi: int, E: int, target: int, row: int):
        """The first chunk of [c, chi) whose sum brings E to target (chi:
        none), and E at its start."""
        self.inc(row)
        s = self._sums[row][c:chi]
        cs = torch.cumsum(s, 0)
        k = int(torch.searchsorted(cs, torch.tensor([target - E])))
        if k == cs.shape[0]:
            return chi, E + int(cs[-1])
        return c + k, E + int(cs[k]) - int(s[k])

    def seek(self, p: int, E: int, target: int, kend: int, row: int):
        """(k, E(k), E(k + 1)) for the first k in [p, kend) whose E(k + 1)
        reaches target, else (kend, E(kend), E(kend)); E = E(p)."""
        K, T = self.K, self.T
        jumps = True
        while p < kend:
            if jumps and p % K == 0:
                c = p // K
                chi = self.nchunks if kend >= T else kend // K
                if chi > c:
                    c2, E = self.jump(c, chi, E, target, row)
                    if c2 == chi:
                        p = min(chi * K, T)
                        continue
                    p, jumps = c2 * K, False
            end = min((p // K + 1) * K, T, kend)
            hit, E = self.exact(p, end, E, target, row)
            if hit is not None:
                return hit
            p, jumps = end, True
        return kend, E, E

    def window(self, jj0: int, E0: int, jend: int, hi: int, b: int,
               visit: tuple, row: int, n: int, trigger) -> None:
        """The C++ rule in boundary b's window, TAPE_TABLES_TILE samples a
        round from jj0 (E0 = E(jj0)): ``trigger(t)`` for each sample t,
        in order, whose read index is b."""
        w, f, s0, e0, rv = visit
        x_all = self.inc(row)
        tile = kernels.TAPE_TABLES_TILE
        while jj0 < jend:
            tend = min(jj0 + tile, jend)
            self.flags[jj0 // self.K:(tend - 1) // self.K + 1] = True
            x = x_all[jj0:tend]
            c = torch.cumsum(x, 0)
            excl = E0 + c - x
            inside = excl < hi
            fv = f + excl
            carry = fv >> POS_FRAC_BITS
            lw = w + carry - s0
            if rv:
                a = e0 - 1 - lw
                idx0 = torch.where(fv - (carry << POS_FRAC_BITS) > 0,
                                   torch.where(a == 0, 0, a - 1), a)
            else:
                idx0 = s0 + lw
            idx0 = idx0.clamp(0, n - 1)
            for t in torch.nonzero(inside & (idx0 == b)).flatten().tolist():
                trigger(jj0 + t)
            if tend - jj0 < tile or not bool(inside.all()):
                return
            jj0, E0 = tend, E0 + int(c[-1])


def _plain_walk(T: int, n: int, mod: torch.Tensor, starts, ends, reverse,
                boundaries, rows, env_len: int, splice_on: bool, s_init: int,
                chunk: int, cap: int):
    """One run of the card walk's visit loop (``tables_walk_kernel``)
    with tables of ``cap`` records: (the tables' lists, the counts,
    whether one passed cap, the final state, the walk)."""
    row, row_t, row_v = rows
    walk = _PlainWalk(T, chunk, mod, row_v)
    S = len(starts)
    tabs = [[] for _ in range(8)]
    st = dict(nv=0, nr=0, nt=0, overflow=False, last_end=-1)

    def record(count: str, first: int, *vals):
        if st[count] < cap:
            for k, v in enumerate(vals):
                tabs[first + k].append(v)
        else:
            st["overflow"] = True
        st[count] += 1

    def trigger(t: int):
        if t >= st["last_end"]:
            record("nt", 7, t)
            st["last_end"] = t + env_len

    splice = splice_on and len(boundaries) > 0
    i = w = f = 0
    s_int, last_s0 = s_init, 0
    while i < T:
        w %= n
        sec = min(max(bisect.bisect_right(starts, w) - 1, 0), S - 1)
        s0, e0 = starts[sec], max(ends[sec], starts[sec] + 1)
        r = int(row[sec])
        t_int = int(row_t[r])
        record("nv", 0, i, w, f, sec)
        nr = st["nr"]
        if not (0 < nr <= cap and last_s0 == t_int):
            if nr < cap:
                last_s0 = t_int
            record("nr", 4, i, t_int, 0)
        k, Ek, Ek1 = walk.seek(i, 0, (e0 - w) * POS_ONE - f, T, r)
        jend, total = (k + 1, Ek1) if k < T else (T, Ek)
        if splice:
            b0 = bisect.bisect_left(boundaries, s0)
            b1 = bisect.bisect_left(boundaries, e0)
            rv = bool(reverse[sec])
            ck, cE = i, 0
            for step in range(b1 - b0):
                b = boundaries[b1 - 1 - step] if rv else boundaries[b0 + step]
                if rv:
                    wlo, wn = s0 + (e0 - 2 - b), 2
                    if wlo < w:
                        wlo, wn = w, wn - (w - wlo)
                    if wn <= 0:
                        continue
                elif b < w:
                    continue
                else:
                    wlo, wn = b, 1
                lo = (wlo - w) * POS_ONE - f
                hi = lo + wn * POS_ONE
                ja, Eja = i, 0
                if lo > 0:
                    y, cE, Eja = walk.seek(ck, cE, lo, jend - 1, r)
                    ck = y
                    ja = y + 1 if y < jend - 1 else jend
                walk.window(ja, Eja, jend, hi, b, (w, f, s0, e0, rv), r, n,
                            trigger)
        fv = f + total
        carry = fv >> POS_FRAC_BITS
        w, f = w + carry, fv - (carry << POS_FRAC_BITS)
        s_int, i = t_int, jend
    rem = st["last_end"] - T if st["last_end"] > T else 0
    final = (w, f, s_int, rem, env_len - rem if rem else 0)
    walked = int(walk.flags.sum())
    return (tabs, (st["nv"], st["nr"], st["nt"]), st["overflow"], final,
            dict(chunks_walked=walked, chunks_jumped=walk.nchunks - walked))


def tape_tables_plain(T: int, n: int, mod_consts, starts, ends, speeds_q,
                      reverse, boundaries, splice_env_len: int,
                      consts: TapeConsts,
                      chunk: int = kernels.TAPE_SCAN_CHUNK):
    """The card's table walk in plain PyTorch on the CPU, the reference
    ``kernels.tape_tables`` is held against: the wow/flutter curve
    (``_wow_flutter_device``), each distinct speed's int64 increments and
    their sums over chunks of ``chunk``, and for each visit the chunk
    search to the section's end, the exact sample inside that chunk, and
    each boundary window's per-sample rule in rounds of
    ``kernels.TAPE_TABLES_TILE``; tables of TABLES_CAP records, run again
    with room where one passes it.  Returns (tables, walk): the NumPy dict
    of ``native_rt.tape_tables`` and the chunks walked and jumped and the
    runs (as ``tape_tables_on_card``'s launches)."""
    ints, flts, ph0 = mod_consts
    mod = _wow_flutter_device(T, ints, flts, ph0, "cpu")
    args = (T, n, mod, [int(s) for s in starts], [int(e) for e in ends],
            np.asarray(reverse, bool), [int(b) for b in boundaries],
            _speed_rows(speeds_q), int(splice_env_len),
            bool(consts.splice_on), _s_init(consts), chunk)
    cap, runs = TABLES_CAP, 0
    while True:
        tabs, counts, overflow, final, walk = _plain_walk(*args, cap)
        runs += 1
        if not overflow:
            break
        cap = _room(counts, cap)
    tables = {k: np.asarray(v, np.int64).astype(np.int32)
              for k, v in zip(_TABLE_NAMES, tabs)}
    tables["final"] = _final(*final)
    return tables, dict(walk, launches=runs)


# ----------------------------------------------------------------------------
# Device engines
# ----------------------------------------------------------------------------

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


def _section_lookup(starts, ends, whole: int):
    """bisect_right(section_starts, pos) - 1, exactly (Tape…py:761-765), as
    the JAX package writes it: the count of starts <= ``whole``, less one,
    clipped (host ints).  Returns (sec, sec_start, sec_end)."""
    sec = sum(whole >= s for s in starts) - 1
    sec = min(max(sec, 0), len(starts) - 1)
    sec_start = starts[sec]
    sec_end = ends[sec]
    if sec_end <= sec_start:
        sec_end = sec_start + 1
    return sec, sec_start, sec_end


def _boundary_min_dist(boundaries, idx0: torch.Tensor) -> torch.Tensor:
    """min |idx0 - b| over the (few) boundaries, a host sequence of ints."""
    d = torch.full_like(idx0, 2 ** 30)
    for b in boundaries:
        d = torch.minimum(d, torch.abs(idx0 - int(b)))
    return d


def _boundary_hit(boundaries, idx0: int) -> bool:
    """idx0 equals one of the boundaries (host ints)."""
    return any(idx0 == b for b in boundaries)


def _anticlick_gain(consts: TapeConsts, boundaries, idx0: torch.Tensor
                    ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """The boundary dip's gain where it applies (Tape…py:838-849): (dmin <
    smooth_len, max(0, 1 - strength * x)), or None when the dip is off."""
    if not (consts.anticlick_on and len(boundaries) > 0
            and consts.smooth_len > 0):
        return None
    dmin = _boundary_min_dist(boundaries, idx0)
    inv_smooth = float(np.float32(1.0 / max(1, consts.smooth_len)))
    x = (consts.smooth_len - dmin).to(torch.float32) * inv_smooth
    g = torch.clamp_min(1.0 - float(np.float32(
        consts.anticlick_strength)) * x, 0.0)
    return dmin < consts.smooth_len, g


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


def _splice_gain(tab: dict, T: int, splice_off=None,
                 splice_len=None) -> torch.Tensor:
    """The splice envelope's gain f32 [T + E], 1 outside the envelopes,
    from the triggers ``tab["triggers"]``.  Without pieces every trigger
    starts a whole envelope; triggers are >= E apart (host greedy
    suppression), so the rows never overlap and the scatter is order-free.
    With ``splice_off``/``splice_len`` (int32, one per trigger) trigger k
    is an envelope PIECE: ``splice_len[k]`` values from offset
    ``splice_off[k]`` (a trace can pause an envelope mid-decay and resume
    it in a later segment).  A piece's filler rows of 1.0 can cross a
    neighbouring piece, so the pieces scatter with max: every envelope
    value exceeds 1, and the result is order-free (JAX: ``.at[].max``)."""
    trig = tab["triggers"]
    env = tab["splice_env"]
    E = env.shape[0]
    j = torch.arange(E, dtype=trig.dtype, device=trig.device)
    rows = (trig[:, None] + j).reshape(-1).to(torch.int64)
    buf = torch.ones(T + E, dtype=torch.float32, device=trig.device)
    if splice_off is None:
        buf[rows] = env.repeat(trig.shape[0])
    else:
        idx = (splice_off[:, None] + j).clamp(0, E - 1).to(torch.int64)
        vals = torch.where(j < splice_len[:, None], env[idx], 1.0)
        buf.scatter_reduce_(0, rows, vals.reshape(-1), reduce="amax")
    return buf


def tape_positions(tab: dict, consts: TapeConsts, n: int, T: int,
                   splice_off: Optional[torch.Tensor] = None,
                   splice_len: Optional[torch.Tensor] = None):
    """Per-sample read positions and gains of a tape render, rebuilt on
    the device from the control tables (the position part of the JAX
    package's tape_device_render, varispeed.py:956-1017).

    ``tab`` holds device tensors: ``mod_ints``/``mod_flts``/``phase0``
    (host arrays), int32 ``visit_start``/``visit_bw``/``visit_bf``/
    ``visit_sec``, ``run_start``/``run_s0``/``run_m``, the section tables
    ``starts``/``ends`` (int32) and ``reverse`` (bool), ``boundaries`` (host
    ints), int32 ``triggers`` and f32 ``splice_env``.  ``splice_off`` and
    ``splice_len`` (int32, one per trigger) make the triggers envelope
    pieces (``_splice_gain``).  Returns (idx0 int32 in [0, n), fr f32,
    gain f32), each [T]."""
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
    dip = _anticlick_gain(consts, tab["boundaries"], idx0)
    if dip is not None:
        gain = torch.where(dip[0], dip[1], gain)
    if consts.splice_on and tab["triggers"].shape[0] > 0:
        gain = gain * _splice_gain(tab, T, splice_off, splice_len)[:T]
    return idx0, fr, gain


def tape_device_render(audio: torch.Tensor, tab: dict, consts: TapeConsts,
                       T: int, out_i16: bool = False,
                       interp: str = "linear",
                       with_pieces: bool = False,
                       splice_off: Optional[torch.Tensor] = None,
                       splice_len: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Whole tape render on the device from the control tables (see
    ``tape_positions`` for ``tab``): the linear read (``interp="linear"``)
    or the 16-tap Lanczos-sinc read (``"sinc"``), gain, clip to [-1, 1],
    and PCM16 with ``out_i16``.  ``with_pieces`` (the trace renderer's
    path) takes ``tab["triggers"]`` as envelope pieces with their offsets
    ``splice_off`` and lengths ``splice_len`` (int32 tensors, one per
    trigger).  Returns f32 [T] or int16 [T] on ``audio``'s device (any
    other ``interp`` reads linearly, as in the JAX package)."""
    if with_pieces and (splice_off is None or splice_len is None):
        raise ValueError("with_pieces needs splice_off and splice_len")
    if not with_pieces:
        splice_off = splice_len = None
    with span("tape.positions", audio.device):
        idx0, fr, gain = tape_positions(tab, consts, audio.shape[0], T,
                                        splice_off, splice_len)
    with span("tape.read", audio.device):
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


# ----------------------------------------------------------------------------
# Segment engine: the host's per-sample trajectory + one read
# ----------------------------------------------------------------------------

def tape_gather_render(audio: torch.Tensor, idx0: torch.Tensor,
                       fr: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """The segment engine's device half: the linear read (``lerp_read``,
    the CUDA kernel on the card), the combined anti-click x splice gain
    and the clip (JAX ``tape_gather_render``).  Combining the two gains
    differs from the scan engine by <= 1 ulp of a sample."""
    return torch.clamp(lerp_read(audio, idx0, fr) * gain, -1.0, 1.0)


def tape_segment_render(audio: torch.Tensor, mod_q, starts, ends, speeds_q,
                        reverse, boundaries, splice_env, consts: TapeConsts):
    """Parallel tape engine: the C++ per-sample trajectory of the T =
    len(mod_q) samples (``utils/native_rt.tape_trajectory``; the host
    arrays of ``models.tape.build_tape_program`` and its
    ``wow_flutter_mod`` curve), its gains combined on
    the host, then ``tape_gather_render`` on ``audio``'s device.
    Decision-exact against the scan engine.  Returns (out f32 [T], the
    final state dict)."""
    from ..utils import native_rt
    env = np.asarray(splice_env, np.float32)
    traj = native_rt.tape_trajectory(
        len(mod_q), audio.shape[0], mod_q, starts, ends, speeds_q, reverse,
        boundaries, env, consts, 0, 0)
    dev = audio.device
    out = tape_gather_render(
        audio, torch.as_tensor(traj["idx0"], device=dev),
        torch.as_tensor(traj["fr"], device=dev),
        torch.as_tensor(traj["ga"] * traj["gs"], device=dev))
    return out, traj["final"]


# ----------------------------------------------------------------------------
# Scan engine: the per-sample recurrence
# ----------------------------------------------------------------------------

def _scan_check(audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
                splice_env):
    ts = (audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
          splice_env)
    if any(not isinstance(t, torch.Tensor) or t.dim() != 1 for t in ts):
        raise ValueError("the scan engine wants 1-D tensors")
    if any(t.device != audio.device for t in ts):
        raise ValueError("the scan engine's tensors must share one device")
    S = starts.shape[0]
    if S < 1 or not ends.shape[0] == speeds_q.shape[0] == \
            reverse.shape[0] == S:
        raise ValueError("the scan engine wants starts, ends, speeds_q and "
                         "reverse of one length >= 1")
    if audio.shape[0] < 1:
        raise ValueError("the scan engine needs at least one audio sample")


def _initial_state(consts: TapeConsts, device) -> TapeState:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    return TapeState(i32(0), i32(0),
                     torch.tensor(consts.initial_speed_q,
                                  dtype=torch.float32, device=device),
                     i32(0), i32(0))


def tape_scan_render_plain(audio: torch.Tensor, mod_q: torch.Tensor,
                           starts: torch.Tensor, ends: torch.Tensor,
                           speeds_q: torch.Tensor, reverse: torch.Tensor,
                           boundaries: torch.Tensor,
                           splice_env: torch.Tensor, consts: TapeConsts,
                           state: Optional[TapeState] = None):
    """The plain PyTorch version of the scan engine: the CPU path, and the
    reference the CUDA kernel is held against.  A per-sample loop mirrors
    the JAX step (varispeed.py:157-198): the position, section, splice and
    speed state on the host (the integers as Python ints, each f32
    operation of the speed on a 0-d f32 tensor, rounded once), writing
    each sample's read index, fraction and splice-envelope index; then one
    pass over all samples on ``audio``'s device reads, applies the
    anti-click gain, then the envelope, and clips, in the step's order.
    A loop step costs tens of microseconds: keep T to a few thousand.
    Returns (out f32 [T], final TapeState)."""
    _scan_check(audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
                splice_env)
    dev = audio.device
    n, T, E = audio.shape[0], mod_q.shape[0], splice_env.shape[0]
    st = [int(v) for v in starts.tolist()]
    en = [int(v) for v in ends.tolist()]
    rev = [bool(v) for v in reverse.tolist()]
    bnd = [int(v) for v in boundaries.tolist()]
    spd = speeds_q.detach().to("cpu", torch.float32)
    mq = mod_q.detach().to("cpu", torch.float32)
    alpha = torch.tensor(consts.alpha_q, dtype=torch.float32)
    if state is None:
        state = _initial_state(consts, "cpu")
    whole, frac = int(state.whole), int(state.frac)
    rem, sidx = int(state.splice_rem), int(state.splice_idx)
    speed = torch.as_tensor(state.speed).detach().to("cpu", torch.float32) \
        .reshape(())
    splice = consts.splice_on and len(bnd) > 0

    idx0s, frs, gis = [0] * T, [0.0] * T, [-1] * T
    for i in range(T):
        whole = whole % n
        sec, s0, e0 = _section_lookup(st, en, whole)
        local = (whole - s0) % (e0 - s0)
        if not rev[sec]:
            idx0, num = s0 + local, frac
        else:
            a = e0 - 1 - local
            if frac <= 0:
                idx0, num = a, 0
            elif a == 0:
                idx0, num = 0, -frac        # read position in (-1, 0)
            else:
                idx0, num = a - 1, POS_ONE - frac
        idx0 = min(max(idx0, 0), n - 1)
        idx0s[i] = idx0
        frs[i] = num * _INV                 # exact: |num| <= 2**22
        if splice:
            if _boundary_hit(bnd, idx0) and rem <= 0:
                rem, sidx = E, 0
            if rem > 0 and sidx < E:
                gis[i] = min(max(sidx, 0), E - 1)
                rem, sidx = rem - 1, sidx + 1
        target = spd[sec]
        if consts.inertia_on:
            speed = speed + quantize_f32((target - speed) * alpha)
        else:
            speed = target
        inc = int(torch.round((speed * mq[i]) * float(POS_ONE)))
        f = frac + inc
        carry = f >> POS_FRAC_BITS
        whole, frac = whole + carry, f - (carry << POS_FRAC_BITS)

    idx0_t = torch.tensor(idx0s, dtype=torch.int32, device=dev)
    s = lerp_read_plain(audio, idx0_t,
                        torch.tensor(frs, dtype=torch.float32, device=dev))
    dip = _anticlick_gain(consts, bnd, idx0_t)
    if dip is not None:
        s = torch.where(dip[0], s * dip[1], s)
    gi = torch.tensor(gis, dtype=torch.int64, device=dev)
    if E > 0:
        s = torch.where(gi >= 0, s * splice_env[gi.clamp_min(0)], s)
    s = torch.clamp(s, -1.0, 1.0)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    return s, TapeState(i32(whole), i32(frac), speed.to(dev), i32(rem),
                        i32(sidx))


def scan_state_words(state: Optional[TapeState], consts: TapeConsts,
                     device) -> torch.Tensor:
    """The kernel's int32 [5] state words of ``state`` (default: the start
    of the tape at ``consts.initial_speed_q``) on ``device``: whole, frac,
    the speed's f32 bits, splice rem, splice index."""
    if state is None:
        state = _initial_state(consts, device)

    def word(v, dtype):
        return torch.as_tensor(v, dtype=dtype).to(device).reshape(1) \
            .view(torch.int32)
    return torch.cat([word(state.whole, torch.int32),
                      word(state.frac, torch.int32),
                      word(state.speed, torch.float32),
                      word(state.splice_rem, torch.int32),
                      word(state.splice_idx, torch.int32)])


def scan_state(words: torch.Tensor) -> TapeState:
    """The TapeState of the kernel's int32 [5] state words."""
    return TapeState(words[0], words[1], words[2:3].view(torch.float32)[0],
                     words[3], words[4])


def tape_scan_render(audio: torch.Tensor, mod_q: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor,
                     speeds_q: torch.Tensor, reverse: torch.Tensor,
                     boundaries: torch.Tensor, splice_env: torch.Tensor,
                     consts: TapeConsts, state: Optional[TapeState] = None):
    """The reference-structured sequential engine (JAX
    ``tape_scan_render``): audio f32 [n], mod_q f32 [T] (the quantized
    wow/flutter curve), starts/ends int32 [S], speeds_q f32 [S], reverse
    bool [S], boundaries int32 [B], splice_env f32 [E], all on one device,
    and the carried ``state`` (default: the start of the tape at
    ``consts.initial_speed_q``).  CUDA tensors run ``kernels/tape_scan.cu``
    (its wrapper checks the tensors; a failed build or launch raises); CPU
    tensors run
    ``tape_scan_render_plain``.  Returns (out f32 [T], final TapeState)."""
    if audio.device.type == "cpu":
        return tape_scan_render_plain(audio, mod_q, starts, ends, speeds_q,
                                      reverse, boundaries, splice_env,
                                      consts, state)
    out, fin = kernels.tape_scan(
        audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
        splice_env, scan_state_words(state, consts, audio.device),
        anticlick_on=consts.anticlick_on, smooth_len=consts.smooth_len,
        strength=consts.anticlick_strength, splice_on=consts.splice_on,
        inertia_on=consts.inertia_on, alpha_q=consts.alpha_q)
    return out, scan_state(fin)

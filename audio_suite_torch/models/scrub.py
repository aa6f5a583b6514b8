"""Scrubber engine — port of audio_suite_tpu/models/scrub.py: gestural tape
scrubbing as an offline render.

    per-block gesture trace -> per-sample speed -> position = exclusive
    segmented prefix sum of fixed-point increments -> 1-3 head wrap-around
    fractional reads -> head gain x block dropout envelope -> PCM16

- host (NumPy, the same arrays as the JAX package): the constants,
  ``ScrubConfig``, ``GestureTrace``, ``constant_trace``,
  ``scripted_gesture_trace``, ``build_scrub_program`` (with its per-sample
  increment twin ``_inc_np`` for ``with_inc=True``) and
  ``build_scrub_program_cached`` (LRU-8 on object identity);
- device: ``_inc_device`` (detmath LFO sines in sig12 pairs, counter-noise
  stretch jitter) and ``_positions`` (segmented fixed-point prefix sum),
  bit-exact with the JAX package; the linear read, the envelope and
  PCM16 through ``ops/lerp_read.scrub_read`` (one fused CUDA kernel launch
  per head layout on the card, into one output buffer); the sinc read
  through ``ops/fixq.gather_sinc_wrap``, then the envelope and PCM16
  (``_finish``).

The linear read keeps the JAX package's branch: when the blockwise read
applies (``T % 128 == 0``, ``n > 2 * span * 128 + 32``) and every head
offset is an integer, the heads' samples are summed before one lerp
(form A); otherwise each head lerps and the lerps are summed (form B).
The two round differently, so ``span`` is computed exactly as
``render_scrub`` does.  The JAX package's one-hot MXU window selection is
TPU machinery: a direct gather gives the same samples.

The tape and the program's block-rate arrays go to the device once per
program and device (``device_program``, memoized on the program).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import detmath, fixq, noise
from ..ops.fixq import round_sig12, round_sig12_np
from ..ops.lerp_read import scrub_read
from ..utils.device import canonical_device
from ..utils.memo import Memo

# Config constants (scrubber_0.7.py:35-75)
DEFAULT_HEAD_OFFSETS = (-2000.0, 0.0, 2000.0)
HEAD_GAIN = 0.8
TAPE_FRICTION_PER_FRAME = 0.93
MOUSE_SPEED_TO_TAPE_SPEED = 70.0
WOW_FREQ = 0.5
WOW_DEPTH = 0.006
FLUTTER_FREQ = 6.0
FLUTTER_DEPTH = 0.002
STRETCH_DEPTH = 0.007
STRETCH_SPEED_SCALE = 25000.0
DROPOUT_DEPTH = 0.35
DROPOUT_PROB = 0.008
DROPOUT_MIN_BLOCKS = 3
DROPOUT_MAX_BLOCKS = 10
MAX_TAPE_SPEED = 40_000.0
FPS = 60.0
BLOCK_SIZE = 1024
HEAD_OFFSET_STEP = 200.0


@dataclass
class ScrubConfig:
    sample_rate: int = 44100
    head_count: int = 3                       # 1-3 (scrubber_0.7.py:107-118)
    head_offsets: tuple = DEFAULT_HEAD_OFFSETS  # [left, center, right] samples
    block_size: int = BLOCK_SIZE
    seed: int = 1234
    stretch_jitter: bool = True
    dropouts: bool = True

    def active_offsets(self) -> list[float]:
        """Head-count -> offsets mapping (scrubber_0.7.py:107-118)."""
        left, center, right = self.head_offsets
        if self.head_count <= 1:
            return [center]
        if self.head_count == 2:
            return [left, right]
        return [left, center, right]


@dataclass
class GestureTrace:
    """Block-rate control trace.

    base_speed[b]    : base speed factor in [-1, 1] (keyboard Up/Down/0)
    gesture_speed[b] : scrub speed in samples/sec (LMB drag)
    jump[b]          : sample position to jump to at block b start (RMB),
                       or NaN for no jump
    head_count[b]    : live head-count keys 1/2/3; None = cfg.head_count
    head_offsets[b,3]: live offset nudges Z/X C/V B/N, reset R;
                       None = cfg.head_offsets
    """
    base_speed: np.ndarray
    gesture_speed: np.ndarray
    jump: np.ndarray
    head_count: Optional[np.ndarray] = None
    head_offsets: Optional[np.ndarray] = None

    @property
    def num_blocks(self) -> int:
        return len(self.base_speed)


def constant_trace(num_blocks: int, base_speed: float = 0.5,
                   gesture: float = 0.0) -> GestureTrace:
    return GestureTrace(
        base_speed=np.full(num_blocks, base_speed, np.float64),
        gesture_speed=np.full(num_blocks, gesture, np.float64),
        jump=np.full(num_blocks, np.nan),
    )


#: key -> (head index, offset delta) for the nudge keys
#: (scrubber_0.7.py:344-356)
_NUDGE_KEYS = {"Z": (0, -HEAD_OFFSET_STEP), "X": (0, +HEAD_OFFSET_STEP),
               "C": (1, -HEAD_OFFSET_STEP), "V": (1, +HEAD_OFFSET_STEP),
               "B": (2, -HEAD_OFFSET_STEP), "N": (2, +HEAD_OFFSET_STEP)}


def scripted_gesture_trace(num_blocks: int, sample_rate: int,
                           block_size: int = BLOCK_SIZE,
                           drag_events=(), base_speed: float = 0.0,
                           jumps=(), key_events=(),
                           head_count: int = 3,
                           head_offsets=DEFAULT_HEAD_OFFSETS) -> GestureTrace:
    """Simulate the GUI loop: drags set gesture_speed = dx*70*FPS; friction
    multiplies by 0.93 per GUI frame when not dragging.  drag_events:
    (start_sec, dx_pixels_per_frame, duration_sec); jumps: (sec,
    target_sample); key_events: (sec, key) with "1"/"2"/"3" (head count),
    "Z/X C/V B/N" (nudge a head offset by -/+200 samples), "R" (reset the
    offsets), "Up"/"Down"/"0" (base speed factor +-0.1 / 0).  Keys apply at
    the start of the block that holds their time."""
    blocks_per_sec = sample_rate / block_size
    keys_by_block: dict[int, list[str]] = {}
    for (sec, key) in key_events:
        b = int(sec * blocks_per_sec)
        if 0 <= b < num_blocks:
            keys_by_block.setdefault(b, []).append(str(key))

    gesture = np.zeros(num_blocks, np.float64)
    base = np.zeros(num_blocks, np.float64)
    counts = np.zeros(num_blocks, np.int32)
    offsets = np.zeros((num_blocks, 3), np.float64)
    g = 0.0
    bsf = float(base_speed)
    cnt = int(head_count)
    offs = [float(o) for o in head_offsets]
    friction_per_block = TAPE_FRICTION_PER_FRAME ** (FPS / blocks_per_sec)
    for b in range(num_blocks):
        for key in keys_by_block.get(b, []):
            if key in ("1", "2", "3"):
                cnt = int(key)
            elif key in _NUDGE_KEYS:
                h, d = _NUDGE_KEYS[key]
                offs[h] += d
            elif key == "R":
                offs = [float(o) for o in DEFAULT_HEAD_OFFSETS]
            elif key == "Up":
                bsf = min(1.0, bsf + 0.1)
            elif key == "Down":
                bsf = max(-1.0, bsf - 0.1)
            elif key == "0":
                bsf = 0.0
        t = b / blocks_per_sec
        dragging = False
        for (t0, dx, dur) in drag_events:
            if t0 <= t < t0 + dur:
                g = dx * MOUSE_SPEED_TO_TAPE_SPEED * FPS
                dragging = True
        if not dragging:
            g *= friction_per_block
        gesture[b] = g
        base[b] = bsf
        counts[b] = cnt
        offsets[b] = offs
    jump = np.full(num_blocks, np.nan)
    for (sec, target) in jumps:
        b = int(sec * blocks_per_sec)
        if 0 <= b < num_blocks:
            jump[b] = float(target)
    # head lanes only when a head-affecting key occurred: a speed-only
    # trace must not override ScrubConfig.head_count / head_offsets
    head_keys = {"1", "2", "3", "R", *_NUDGE_KEYS}
    live_heads = any(k in head_keys
                     for ks in keys_by_block.values() for k in ks)
    return GestureTrace(
        base_speed=base, gesture_speed=gesture, jump=jump,
        head_count=counts if live_heads else None,
        head_offsets=offsets if live_heads else None)


_J_STREAM = 7  # counter-noise stream for stretch jitter


def _mod_consts(sr: float) -> dict:
    """Constants shared by the device and NumPy increment twins: the wow
    (0.5 Hz) and flutter (6 Hz) LFO phase ratios (exact integer phase
    reduction) and their depths as hi/lo 12-bit pairs, so every product
    is exact in f32."""
    if float(sr) != float(int(sr)):
        raise ValueError("scrub requires an integer sample rate")
    wn, wm, winv = detmath.phase_ratio(1, 2, int(sr))    # 0.5 Hz wow
    fn, fm, finv = detmath.phase_ratio(6, 1, int(sr))    # 6 Hz flutter
    wdh, wdl = fixq.sig12_pair_np(np.float32(WOW_DEPTH))
    fdh, fdl = fixq.sig12_pair_np(np.float32(FLUTTER_DEPTH))
    return {
        "ints": np.asarray([wn, wm, fn, fm], np.uint32),
        "flts": np.asarray([winv, finv, wdh, fdh, wdl, fdl], np.float32),
    }


def _inc_np(base_inc_q, js_q, seed, bs, consts):
    """NumPy twin of the device increment synthesis (bit-identical)."""
    nb = len(base_inc_q)
    T = nb * bs
    i = np.arange(T, dtype=np.uint32)
    ci, cf_ = consts["ints"], consts["flts"]
    swh, swl = fixq.sig12_pair_np(detmath.sin_cycles_precise_np(
        detmath.phase_cycles_np(i, ci[0], ci[1], cf_[0])))
    sfh, sfl = fixq.sig12_pair_np(detmath.sin_cycles_precise_np(
        detmath.phase_cycles_np(i, ci[2], ci[3], cf_[1])))
    # hi/lo piece products are exact in f32, so these sums are FMA-safe
    wow = cf_[2] * swh + cf_[2] * swl + cf_[4] * swh
    flut = cf_[3] * sfh + cf_[3] * sfl + cf_[5] * sfh
    sf = np.float32(1.0) + wow + flut
    nz = round_sig12_np(noise.normal_np(np.uint32(seed), i,
                                        np.uint32(_J_STREAM)))
    jf = np.float32(1.0) + np.repeat(js_q, bs) * nz
    inc_f = np.repeat(base_inc_q, bs) * (sf * jf)
    return np.rint(inc_f * np.float32(fixq.POS_ONE)).astype(np.int32)


def _inc_device(base_inc_q: torch.Tensor, js_q: torch.Tensor, seed: int,
                bs: int, consts) -> torch.Tensor:
    """Device twin of _inc_np: int32 [nb * bs] fixed-point increments.
    ``consts`` is the host pair (ints u32[4], flts f32[6]); every op rounds
    once, in the JAX package's order."""
    nb = base_inc_q.shape[0]
    T = nb * bs
    i = torch.arange(T, dtype=torch.int64, device=base_inc_q.device)
    ci = [int(v) for v in np.asarray(consts[0])]
    cf_ = np.asarray(consts[1], np.float32)
    f = [float(v) for v in cf_]
    swh, swl = fixq.sig12_pair(detmath.sin_cycles_precise(
        detmath.phase_cycles(i, ci[0], ci[1], cf_[0])))
    sfh, sfl = fixq.sig12_pair(detmath.sin_cycles_precise(
        detmath.phase_cycles(i, ci[2], ci[3], cf_[1])))
    wow = f[2] * swh + f[2] * swl + f[4] * swh
    flut = f[3] * sfh + f[3] * sfl + f[5] * sfh
    sf = 1.0 + wow + flut
    nz = round_sig12(noise.normal(int(seed), i, _J_STREAM))
    jf = 1.0 + js_q.repeat_interleave(bs) * nz
    inc_f = base_inc_q.repeat_interleave(bs) * (sf * jf)
    return torch.round(inc_f * fixq.POS_ONE_F).to(torch.int32)


def span_bound_blocks(base_inc_q, js_q) -> int:
    """Certain host-side upper bound on per-sample position movement (in
    samples), from block-rate params only: |inc| <= max|base_inc| *
    (1 + wow + flutter) * (1 + 8*js) (the Irwin-Hall normal is below 8 in
    magnitude)."""
    if len(base_inc_q) == 0:
        return 1
    m = float(np.max(np.abs(base_inc_q)))
    jmax = float(np.max(js_q)) if len(js_q) else 0.0
    b = m * (1.0 + WOW_DEPTH + FLUTTER_DEPTH) * (1.0 + 8.0 * jmax)
    return int(b) + 1


def build_scrub_program(audio, cfg: ScrubConfig, trace: GestureTrace,
                        tape_pos0: float = 0.0,
                        with_inc: bool = False) -> dict:
    """Expand the block-rate trace into quantized block speeds, jitter
    depths, per-block dropout gains (seeded NumPy RNG, as the JAX package),
    jump resets and head layouts.  ``with_inc=True`` also materializes the
    per-sample increment twin ``inc_fix`` (the NumPy oracle's input; the
    render synthesizes increments on the device).  ``audio`` is a host
    array, or a tensor, kept as it is (only its length is read here)."""
    if not isinstance(audio, torch.Tensor):
        audio = np.asarray(audio, np.float32)
    sr = float(cfg.sample_rate)
    bs = int(cfg.block_size)
    nb = trace.num_blocks
    T = nb * bs
    rng = np.random.default_rng(cfg.seed)

    # per-block total speed, clamped (scrubber_0.7.py:171-176)
    total = trace.base_speed * sr + trace.gesture_speed
    total = np.clip(total, -MAX_TAPE_SPEED, MAX_TAPE_SPEED)
    base_inc = total / sr                              # samples per out sample

    base_inc_q = round_sig12_np(np.asarray(base_inc, np.float32))
    js_q = np.zeros(nb, np.float32)
    if cfg.stretch_jitter and STRETCH_DEPTH > 0.0:
        moving = np.abs(total) > 1.0
        js = STRETCH_DEPTH * np.tanh(np.abs(total) / STRETCH_SPEED_SCALE)
        js_q = np.where(moving, round_sig12_np(js.astype(np.float32)),
                        np.float32(0.0)).astype(np.float32)

    env = np.ones(nb, np.float32)
    dropout_active = False
    dropout_blocks_left = 0
    for b in range(nb):
        # block dropout state machine (scrubber_0.7.py:212-225)
        if cfg.dropouts:
            if dropout_active:
                env[b] = 1.0 - DROPOUT_DEPTH
                dropout_blocks_left -= 1
                if dropout_blocks_left <= 0:
                    dropout_active = False
            else:
                env[b] = 1.0
                if rng.random() < DROPOUT_PROB:
                    dropout_active = True
                    dropout_blocks_left = int(rng.integers(
                        DROPOUT_MIN_BLOCKS, DROPOUT_MAX_BLOCKS + 1))
                    env[b] = 1.0 - DROPOUT_DEPTH

    consts = _mod_consts(sr)
    inc_fix = (_inc_np(base_inc_q, js_q, cfg.seed, bs, consts)
               if with_inc else None)

    # jumps -> segmented-scan resets (block-aligned)
    reset = np.zeros(T, np.bool_)
    jump_flags = np.zeros(nb, np.bool_)
    w0, f0 = fixq.split_pos_np(tape_pos0)
    seg_bases_w = [w0]
    seg_bases_f = [f0]
    for b in range(nb):
        if np.isfinite(trace.jump[b]):
            reset[b * bs] = True
            jump_flags[b] = True
            jw, jf = fixq.split_pos_np(trace.jump[b])
            seg_bases_w.append(jw)
            seg_bases_f.append(jf)

    offsets = cfg.active_offsets()
    head_off = np.asarray([fixq.split_pos_np(o) for o in offsets], np.int32)
    head_off_whole = head_off[:, 0].astype(np.int32)
    head_off_frac = head_off[:, 1].astype(np.int32)

    # live voice-configuration segments (keys 1/2/3, Z/X C/V B/N): maximal
    # runs of constant (count, offsets), each read with its own head
    # layout and gain; positions are head-independent
    head_segments = []
    if trace.head_count is not None or trace.head_offsets is not None:
        cnts = (np.asarray(trace.head_count, np.int32)
                if trace.head_count is not None
                else np.full(nb, cfg.head_count, np.int32))
        offs_b = (np.asarray(trace.head_offsets, np.float64)
                  if trace.head_offsets is not None
                  else np.tile(np.asarray(cfg.head_offsets, np.float64),
                               (nb, 1)))
        b0 = 0
        for b in range(1, nb + 1):
            if (b == nb or cnts[b] != cnts[b0]
                    or not np.array_equal(offs_b[b], offs_b[b0])):
                left, center, right = offs_b[b0]
                c = int(cnts[b0])
                act = ([center] if c <= 1
                       else [left, right] if c == 2
                       else [left, center, right])
                ho = np.asarray([fixq.split_pos_np(o) for o in act],
                                np.int32)
                head_segments.append({
                    "b0": b0, "b1": b,
                    "off_whole": ho[:, 0].astype(np.int32),
                    "off_frac": ho[:, 1].astype(np.int32),
                    "gain": np.float32(HEAD_GAIN / max(1, len(act))),
                })
                b0 = b
    if not head_segments:
        head_segments = [{"b0": 0, "b1": nb,
                          "off_whole": head_off_whole,
                          "off_frac": head_off_frac,
                          "gain": np.float32(HEAD_GAIN
                                             / max(1, len(offsets)))}]

    return {
        "audio": audio,
        "inc_fix": inc_fix,           # NumPy twin (oracle; with_inc only)
        "base_inc_q": base_inc_q,
        "js_q": js_q,
        "seed": int(cfg.seed),
        "mod_consts": (consts["ints"], consts["flts"]),
        "reset": reset,
        "jump_flags": jump_flags,
        "seg_bases_whole": np.asarray(seg_bases_w, np.int32),
        "seg_bases_frac": np.asarray(seg_bases_f, np.int32),
        "env_blocks": env,
        "head_off_whole": head_off_whole,
        "head_off_frac": head_off_frac,
        "head_gain": np.float32(HEAD_GAIN / max(1, len(offsets))),
        "head_segments": head_segments,
        "block_size": bs,
        "num_frames": T,
    }


def reads_summed(T: int, n: int, span_blocks: int, off_frac,
                 interp: str = "linear") -> bool:
    """Whether a read of T positions over an n-sample tape takes form A
    (heads summed, one lerp): where the JAX package takes its blockwise
    read (scrub.py:611, :683) with integer head offsets."""
    return (T % 128 == 0 and n > 2 * span_blocks * 128 + 32
            and interp == "linear" and not np.any(off_frac))


def _read_sinc(audio: torch.Tensor, whole: torch.Tensor,
               frac: torch.Tensor, off_whole, off_frac,
               gain: float) -> torch.Tensor:
    """One head layout's sinc read of [T] positions, scaled by ``gain``."""
    ow = [int(v) for v in np.asarray(off_whole)]
    of = [int(v) for v in np.asarray(off_frac)]
    buf = torch.zeros(whole.shape[0], dtype=torch.float32,
                      device=audio.device)
    for h in range(len(ow)):
        f2 = frac + of[h]
        c2 = f2 >> fixq.POS_FRAC_BITS
        w2 = whole + ow[h] + c2
        f2 = f2 - (c2 << fixq.POS_FRAC_BITS)
        buf = buf + fixq.gather_sinc_wrap(audio, w2, f2)
    return buf * float(gain)


def _read_linear(out: torch.Tensor, audio: torch.Tensor, whole: torch.Tensor,
                 frac: torch.Tensor, env_blocks: torch.Tensor,
                 block_size: int, t0: int, t1: int, off_whole, off_frac,
                 gain: float, span_blocks: int, interp: str) -> None:
    """One head layout's linear read of samples ``t0 .. t1`` (any interp
    but "sinc" reads linearly, as in the JAX package), scaled by ``gain``,
    with the envelope and, into an int16 ``out``, PCM16: written into
    ``out`` in form A or B, as the JAX package picks for a read of
    ``t1 - t0`` samples."""
    ow = [int(v) for v in np.asarray(off_whole)]
    of = [int(v) for v in np.asarray(off_frac)]
    summed = reads_summed(t1 - t0, audio.shape[0], span_blocks, of, interp)
    scrub_read(audio, whole, frac, ow, of, float(gain), summed, env_blocks,
               block_size, out, t0, t1)


def _positions(base_inc_q, js_q, seed, mod_consts, jump_flags,
               seg_bases_whole, seg_bases_frac, block_size: int):
    """Device increment synthesis + segmented fixed-point exclusive prefix
    sum -> per-sample (whole, frac) int32 tape positions (shared by both
    renders: positions are head-independent)."""
    nb = base_inc_q.shape[0]
    inc_fix = _inc_device(base_inc_q, js_q, seed, block_size, mod_consts)
    reset = torch.zeros((nb, block_size), dtype=torch.bool,
                        device=inc_fix.device)
    reset[:, 0] = jump_flags
    reset = reset.reshape(-1)
    # exclusive prefix: position i excludes its own increment, and no
    # increment carries across a jump
    inc_shift = torch.cat([inc_fix.new_zeros(1), inc_fix[:-1]])
    inc_shift = torch.where(reset, 0, inc_shift)
    whole, frac = fixq.segmented_pos_cumsum(inc_shift, reset)
    seg_id = torch.cumsum(reset, 0)
    f = frac + seg_bases_frac[seg_id]
    carry = f >> fixq.POS_FRAC_BITS
    whole = whole + seg_bases_whole[seg_id] + carry
    frac = f - (carry << fixq.POS_FRAC_BITS)
    return whole, frac


def _finish(buf: torch.Tensor, env_blocks: torch.Tensor, block_size: int,
            out_i16: bool) -> torch.Tensor:
    """Dropout envelope (block-repeated) and optional PCM16 of the sinc
    read (the linear read does both in ``scrub_read``)."""
    y = buf * env_blocks.repeat_interleave(block_size)
    if out_i16:
        return torch.clamp(torch.round(y * 32768.0), -32768.0,
                           32767.0).to(torch.int16)
    return y


def _out(T: int, out_i16: bool, device) -> torch.Tensor:
    """An uninitialized render buffer: int16 for PCM16, else f32."""
    return torch.empty(T, dtype=torch.int16 if out_i16 else torch.float32,
                       device=device)


def _as(x, dtype, device) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``; a tensor moved
    there (a no-op where it already lies)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, dtype), device=device)


def scrub_render_kernel(audio, base_inc_q, js_q, seed, mod_consts,
                        jump_flags, seg_bases_whole, seg_bases_frac,
                        env_blocks, head_off_whole, head_off_frac, head_gain,
                        block_size: int, span_blocks: int = 1,
                        out_i16: bool = False, interp: str = "linear",
                        stereo: bool = False, *,
                        device="cuda") -> torch.Tensor:
    """Render of one voice layout on ``device``: positions, the read, the
    envelope, PCM16 with ``out_i16``; [T, 2] with ``stereo`` (both channels
    the mono render's samples).  Array arguments are host arrays or tensors
    (moved to ``device`` if they lie elsewhere); ``mod_consts`` and the head
    offsets stay on the host.  The JAX package's ``heads_integer`` flag is
    not taken: the read works it out from ``head_off_frac``."""
    audio = _as(audio, np.float32, device).contiguous()
    env = _as(env_blocks, np.float32, device).contiguous()
    whole, frac = _positions(
        _as(base_inc_q, np.float32, device), _as(js_q, np.float32, device),
        int(seed), mod_consts, _as(jump_flags, np.bool_, device),
        _as(seg_bases_whole, np.int32, device),
        _as(seg_bases_frac, np.int32, device), block_size)
    gain = float(np.float32(head_gain))
    if interp == "sinc":
        y = _finish(_read_sinc(audio, whole, frac, head_off_whole,
                               head_off_frac, gain), env, block_size, out_i16)
    else:
        y = _out(whole.shape[0], out_i16, audio.device)
        _read_linear(y, audio, whole, frac, env, block_size, 0, y.shape[0],
                     head_off_whole, head_off_frac, gain, span_blocks, interp)
    return torch.stack([y, y], dim=-1) if stereo else y


def scrub_render_segments(prog: dict, span_blocks: int,
                          out_i16: bool = False, interp: str = "linear",
                          stereo: bool = False, *,
                          device="cuda") -> torch.Tensor:
    """Live-control render: one position pass, then each control segment
    (``prog["head_segments"]``) read with its own head layout, gain and
    read form into its samples of one output buffer (one fused kernel
    launch per segment on the card)."""
    dp = device_program(prog, device)
    bs = int(prog["block_size"])
    whole, frac = _positions(dp["base_inc_q"], dp["js_q"], prog["seed"],
                             prog["mod_consts"], dp["jump_flags"],
                             dp["seg_bases_whole"], dp["seg_bases_frac"], bs)
    segs = [(int(s["b0"]) * bs, int(s["b1"]) * bs, s)
            for s in prog["head_segments"]]
    if interp == "sinc":
        parts = [_read_sinc(dp["audio"], whole[t0:t1], frac[t0:t1],
                            s["off_whole"], s["off_frac"], float(s["gain"]))
                 for t0, t1, s in segs]
        buf = torch.cat(parts) if len(parts) > 1 else parts[0]
        y = _finish(buf, dp["env_blocks"], bs, out_i16)
    else:
        y = _out(whole.shape[0], out_i16, whole.device)
        for t0, t1, s in segs:
            _read_linear(y, dp["audio"], whole, frac, dp["env_blocks"], bs,
                         t0, t1, s["off_whole"], s["off_frac"],
                         float(s["gain"]), span_blocks, interp)
    return torch.stack([y, y], dim=-1) if stereo else y


def device_program(prog: dict, device="cuda") -> dict:
    """The program's tape and block-rate arrays as tensors on ``device``,
    copied once and memoized on the program (a tape tensor already there
    is used as is)."""
    key = canonical_device(device)
    memo = prog.setdefault("_device", {})
    dp = memo.get(key)
    if dp is None:
        dp = {"audio": _as(prog["audio"], np.float32, device).contiguous(),
              "base_inc_q": _as(prog["base_inc_q"], np.float32, device),
              "js_q": _as(prog["js_q"], np.float32, device),
              "jump_flags": _as(prog["jump_flags"], np.bool_, device),
              "seg_bases_whole": _as(prog["seg_bases_whole"], np.int32,
                                     device),
              "seg_bases_frac": _as(prog["seg_bases_frac"], np.int32,
                                    device),
              "env_blocks": _as(prog["env_blocks"], np.float32,
                                device).contiguous()}
        memo[key] = dp
    return dp


_SCRUB_PROG_CACHE = Memo(8)


def build_scrub_program_cached(audio, cfg: ScrubConfig, trace: GestureTrace,
                               tape_pos0: float = 0.0) -> dict:
    """build_scrub_program memoized on (audio identity, trace identity,
    cfg content, tape_pos0), LRU-bounded at 8 programs: re-renders of an
    unchanged gesture skip the host expansion and, through
    ``device_program``, the upload.  Reuse the same audio and trace
    objects across renders."""
    key = (float(tape_pos0),
           json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str))
    return _SCRUB_PROG_CACHE.get(
        key, lambda: build_scrub_program(audio, cfg, trace, tape_pos0),
        pins=(audio, trace))[0]


def program_span(prog: dict) -> int:
    """The read's span as ``render_scrub`` computes it: the host bound,
    rounded up to a power of two (it decides form A against B)."""
    span = span_bound_blocks(prog["base_inc_q"], prog["js_q"])
    return 1 << (span - 1).bit_length()


def render_scrub(audio, cfg: ScrubConfig, trace: GestureTrace,
                 tape_pos0: float = 0.0, stereo: bool = False,
                 device_out: bool = False, pcm16: bool = False,
                 interp: str = "linear", *, device="cuda"):
    """Offline scrub render on ``device``: mono f32 [T] (int16 with
    ``pcm16``, [T, 2] with ``stereo``), a host NumPy array, or the tensor
    on ``device`` with ``device_out``."""
    prog = build_scrub_program_cached(audio, cfg, trace, tape_pos0)
    span = program_span(prog)
    if len(prog["head_segments"]) > 1:
        # live head-control events in the trace
        out = scrub_render_segments(prog, span, pcm16, interp, stereo,
                                    device=device)
    else:
        # a constant voice configuration, from the config or the trace:
        # segment 0 is the whole render
        seg0 = prog["head_segments"][0]
        dp = device_program(prog, device)
        out = scrub_render_kernel(
            dp["audio"], dp["base_inc_q"], dp["js_q"], prog["seed"],
            prog["mod_consts"], dp["jump_flags"], dp["seg_bases_whole"],
            dp["seg_bases_frac"], dp["env_blocks"], seg0["off_whole"],
            seg0["off_frac"], seg0["gain"], prog["block_size"], span, pcm16,
            interp, stereo, device=device)
    if device_out:
        return out
    return out.cpu().numpy()

"""Microsound engine — port of audio_suite_tpu/models/microsound.py.

Every render path of ``MicrosoundParams``:

- host: ``MicrosoundParams``, ``load_preset`` / ``save_preset``,
  ``build_program`` (the vectorized event program with each event's
  auxiliary draws), ``chain_cfg``, event chunking and the ER / IR space
  kernels — NumPy, identical to the JAX package's arrays;
- device: ``chunk_body`` — the eleven generator modes, the shared-stretch
  fused lowpass + stretch or the per-event chain (exact-length or padded,
  warps, partial lock, resonator, waveguide, multi-band unfold), the
  event feedback / spectral imprint scan with its carry across chunks,
  and the ordered overlap-add into the margin-layout buffer — and
  ``fx_body`` (ADSR, ER/IR convolution, stereo diffusion, soft clip,
  normalize, PCM16), driven by ``render``.

PyTorch runs eagerly, so the JAX package's single-chunk fused dispatch and
its multi-chunk loop are one loop here (``render_device``).  The batch
render over a seeds x unfolds x stretches grid (``batch_render``) pipelines
one job deep, with a resumable manifest.  ``load_image_gray`` reads the
image-scanline mode's image through PIL, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

from ..events.schedulers import generate_event_times
from ..ops import (detmath, envelopes, exact_dft, generators, overlap_add,
                   space, spectral)
from ..utils.breakpoints import (eval_breakpoints, eval_breakpoints_vec,
                                parse_breakpoints)
from ..utils.device import canonical_device
from ..utils.memo import Memo
from ..utils.profiling import span

GEN_MODES = (
    "Gaussian click", "Dust impulses", "Noise burst", "Skewed transient",
    "Resonant strike", "Crackle / corona", "Stick–slip friction",
    "Micro-chaos", "Wavelet atoms", "IR fragment", "Image scanline",
)
MAX_GEN_SR = 30_000_000  # design-rate clamp


@dataclass
class MicrosoundParams:
    """The reference's parameter schema with its factory defaults — the
    same fields and defaults as the JAX package's MicrosoundParams."""
    base_sr: int = 48000
    out_dur_s: float = 8.0
    time_unfold: float = 25.0
    peak: float = 0.98
    sat_drive: float = 1.0
    stereo_on: bool = True
    stereo_width: float = 0.65

    gen_mode: str = "Gaussian click"
    micro_ms: float = 1.25
    seed: int = 12345
    dust_density: float = 0.02
    noise_tilt: float = -3.0
    ring_hz: float = 4200.0
    ring_decay_ms: float = 12.0

    crackle_alpha: float = 1.4
    crackle_density: float = 180.0
    crackle_kernel: int = 64

    ss_threshold: float = 0.9
    ss_build: float = 0.06
    ss_decay: float = 0.75
    ss_noise: float = 0.08

    chaos_r: float = 3.92
    chaos_gate: float = 0.35

    wav_base_hz: float = 2400.0
    wav_count: int = 8
    wav_spread: float = 0.6

    unfold_mode: str = "Classic reinterpret"
    partial_stretch: float = 1.0
    partial_lock_on: bool = False
    pl_top_n: int = 24
    pl_neigh: int = 4
    nl_warp_on: bool = False
    nl_warp_power: float = 1.25
    cep_warp_on: bool = False
    cep_factor: float = 1.2

    mb_b1: float = 2000.0
    mb_b2: float = 8000.0
    mb_b3: float = 20000.0
    mb_u1: float = 35.0
    mb_u2: float = 20.0
    mb_u3: float = 12.0
    mb_roll: float = 2000.0

    bandlimit_on: bool = True
    bandlimit_out_hz: float = 18000.0
    bandlimit_roll_hz: float = 2500.0

    event_process: str = "Poisson"
    grains_per_sec: float = 18.0
    max_grains: int = 4000
    grain_amp_rand: float = 0.35
    grain_offset_on: bool = True
    grain_offset_max_ms: float = 60.0
    cluster_size: int = 6
    cluster_spread_ms: float = 25.0
    hawkes_gain: float = 0.6
    hawkes_decay_s: float = 0.25

    bp_density: str = "0:18, 4:40, 8:14"
    bp_unfold: str = ""
    bp_cutoff: str = ""
    bp_stretch: str = ""

    res_bank_on: bool = False
    res_modes: int = 24
    res_fmin: float = 120.0
    res_fmax: float = 12000.0
    res_decay_ms: float = 80.0

    wg_on: bool = False
    wg_lines: int = 8
    wg_max_ms: float = 8.0
    wg_fb: float = 0.7

    event_feedback_on: bool = False
    event_feedback_amt: float = 0.35
    spectral_imprint_on: bool = False
    spectral_imprint_amt: float = 0.35
    spectral_imprint_smooth: float = 0.92

    er_cloud_on: bool = True
    er_taps: int = 320
    er_max_ms: float = 45.0
    space_ir_on: bool = False
    space_ir_max_samps: int = 12000

    env_a: float = 20.0
    env_d: float = 250.0
    env_s: float = 0.65
    env_r: float = 1800.0
    env_curve: float = 1.8

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "MicrosoundParams":
        """Factory-default merge for partial presets: known keys override
        the defaults (cast to the default's type), unknown keys are
        ignored."""
        names = {f.name for f in dataclasses.fields(MicrosoundParams)}
        p = MicrosoundParams()
        for k, v in (d or {}).items():
            if k in names:
                cur = getattr(p, k)
                if isinstance(cur, bool):
                    v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                else:
                    v = str(v)
                setattr(p, k, v)
        return p


# ---------------------------------------------------------------------------
# Host event program
# ---------------------------------------------------------------------------

def load_preset(path: str) -> MicrosoundParams:
    """A preset JSON merged over the factory defaults (microsound.py:183)."""
    with open(path) as f:
        return MicrosoundParams.from_dict(json.load(f))


def save_preset(params: MicrosoundParams, path: str):
    """The full parameter snapshot as JSON (microsound.py:1290): loadable
    by the reference app and by either package's load_preset."""
    with open(path, "w") as f:
        json.dump(params.to_dict(), f, indent=2, sort_keys=True)


def load_image_gray(path: str):
    """Load an image as a grayscale uint8-range array for the Image
    scanline generator (main_v2.py:1415-1429 uses Qt's grayscale
    conversion; this uses PIL's 'L' mode — same ITU-R 601 luma).  PIL is
    imported here, so a machine without it raises ``ImportError`` only
    when an image is asked for."""
    from PIL import Image
    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float64)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_AUX_MODES = ("Dust impulses", "Crackle / corona", "Wavelet atoms",
              "IR fragment", "Image scanline")

_EVENT_N_FLOORS = {"Stick–slip friction": 64, "Micro-chaos": 64,
                   "Wavelet atoms": 128, "Image scanline": 64}

_AUX_KEYS = ("dust_pos", "dust_amp", "dust_k", "dust_klen", "ck_pos",
             "ck_amp", "wl_f0", "wl_sigma", "wl_phase", "wl_shift", "frag",
             "frag_len", "res_f", "res_ph", "wg_d", "wg_g", "wg_m")


def _event_n(mode: str, gen_sr: int, micro_ms: float, have_ir: bool) -> int:
    """One event's grain length: the mode's floor (an IR fragment with no
    IR loaded falls back to 16) or micro_ms at the event's design rate."""
    floor_n = 64 if (mode == "IR fragment" and have_ir) else \
        _EVENT_N_FLOORS.get(mode, 16)
    return int(max(floor_n, round(gen_sr * micro_ms / 1000.0)))


def build_program_seq(params: MicrosoundParams, ir_audio=None,
                      img_gray=None) -> dict:
    """The scalar per-event twin of ``build_program`` (microsound.py:215):
    the reference-shaped loop, one event at a time, kept as the ground
    truth that ``build_program`` equals array for array."""
    p = params
    base_sr = int(p.base_sr)
    out_n = int(max(1, round(float(p.out_dur_s) * base_sr)))
    base_unfold = max(1.0, float(p.time_unfold))

    bp_density = parse_breakpoints(p.bp_density)
    bp_unfold = parse_breakpoints(p.bp_unfold)
    bp_cutoff = parse_breakpoints(p.bp_cutoff)
    bp_stretch = parse_breakpoints(p.bp_stretch)

    rate = float(p.grains_per_sec)
    times = generate_event_times(
        p.event_process, float(p.out_dur_s), rate, seed=int(p.seed),
        cluster_size=int(p.cluster_size),
        cluster_spread_ms=float(p.cluster_spread_ms),
        hawkes_gain=float(p.hawkes_gain),
        hawkes_decay_s=float(p.hawkes_decay_s))
    times = times[: int(p.max_grains)]

    rng = np.random.default_rng(int(p.seed) + 123456)
    mode = p.gen_mode
    have_ir = ir_audio is not None and np.asarray(ir_audio).size >= 32
    ir_mono = None
    if ir_audio is not None:
        ir_mono = np.asarray(ir_audio, np.float64)
        if ir_mono.ndim > 1:
            ir_mono = ir_mono.mean(axis=1)

    ev = {k: [] for k in ("seed", "n", "gen_sr", "inv_gen_sr", "amp",
                          "offset", "start", "cutoff_gen", "stretch")}
    aux = {k: [] for k in _AUX_KEYS}
    for i, t0 in enumerate(times):
        dens = eval_breakpoints(bp_density, t0, default=rate)
        ufac = eval_breakpoints(bp_unfold, t0, default=base_unfold)
        cutoff_out = eval_breakpoints(bp_cutoff, t0,
                                      default=float(p.bandlimit_out_hz))
        stretch = eval_breakpoints(bp_stretch, t0,
                                   default=float(p.partial_stretch))

        amp = 1.0
        if rate > 0:
            amp *= float(np.clip(dens / max(1e-6, rate), 0.15, 4.0))
        amp *= float(rng.uniform(1.0 - float(p.grain_amp_rand),
                                 1.0 + float(p.grain_amp_rand)))

        ufac = max(1.0, float(ufac))
        gen_sr_evt = int(np.clip(int(round(base_sr * ufac)),
                                 base_sr, MAX_GEN_SR))
        n = _event_n(mode, gen_sr_evt, float(p.micro_ms), have_ir)

        start = int(round(t0 * base_sr))
        if start >= out_n:
            continue  # the reference skips before the offset draw

        offset = 0
        if p.grain_offset_on:
            max_off = int(round(float(p.grain_offset_max_ms) / 1000.0
                                * base_sr))
            if max_off > 0:
                offset = int(rng.integers(0, max(1, min(max_off, n))))

        ev["seed"].append(int(p.seed) + i)
        ev["n"].append(n)
        ev["gen_sr"].append(float(gen_sr_evt))
        ev["inv_gen_sr"].append(float(np.float32(1.0)
                                      / np.float32(gen_sr_evt)))
        ev["amp"].append(amp)
        ev["offset"].append(offset)
        ev["start"].append(start)
        ev["cutoff_gen"].append(float(cutoff_out) * ufac)
        ev["stretch"].append(float(stretch))
        _event_aux_draws(p, mode, i, n, gen_sr_evt, have_ir, ir_mono,
                         img_gray, aux)

    E = len(ev["seed"])
    prog = {
        "out_n": out_n,
        "E": E,
        "gen_sr_base": int(np.clip(int(round(base_sr * base_unfold)),
                                   base_sr, MAX_GEN_SR)),
    }
    if E == 0:
        return prog
    L = _next_pow2(max(ev["n"]))
    prog["L"] = L
    for k in ("seed", "n", "offset", "start"):
        prog[k] = np.asarray(ev[k], np.int32)
    for k in ("gen_sr", "inv_gen_sr", "amp", "cutoff_gen", "stretch"):
        prog[k] = np.asarray(ev[k], np.float32)
    _finalize_aux(p, mode, prog, aux, L)
    return prog


def build_program(params: MicrosoundParams, ir_audio=None,
                  img_gray=None) -> dict:
    """The event program (microsound.py:457): times, per-event lengths,
    design rates, amps, offsets, cutoffs and stretch factors, with the
    reference's sequential rng(seed + 123456) draw order, and each kept
    event's auxiliary draws from its rng(seed + i), rng(seed + i + 321)
    and rng(seed + i + 777) streams.  Array for array equal to the JAX
    package's build_program."""
    with span("microsound.build"):
        p = params
        base_sr = int(p.base_sr)
        out_n = int(max(1, round(float(p.out_dur_s) * base_sr)))
        base_unfold = max(1.0, float(p.time_unfold))

        bp_density = parse_breakpoints(p.bp_density)
        bp_unfold = parse_breakpoints(p.bp_unfold)
        bp_cutoff = parse_breakpoints(p.bp_cutoff)
        bp_stretch = parse_breakpoints(p.bp_stretch)

        rate = float(p.grains_per_sec)
        times = generate_event_times(
            p.event_process, float(p.out_dur_s), rate, seed=int(p.seed),
            cluster_size=int(p.cluster_size),
            cluster_spread_ms=float(p.cluster_spread_ms),
            hawkes_gain=float(p.hawkes_gain),
            hawkes_decay_s=float(p.hawkes_decay_s))
        times = np.asarray(times, np.float64)[: int(p.max_grains)]
        T = times.size

        rng = np.random.default_rng(int(p.seed) + 123456)
        mode = p.gen_mode
        have_ir = ir_audio is not None and np.asarray(ir_audio).size >= 32
        ir_mono = None
        if ir_audio is not None:
            ir_mono = np.asarray(ir_audio, np.float64)
            if ir_mono.ndim > 1:
                ir_mono = ir_mono.mean(axis=1)

        dens = eval_breakpoints_vec(bp_density, times, default=rate)
        ufac = np.maximum(1.0, eval_breakpoints_vec(bp_unfold, times,
                                                    default=base_unfold))
        cutoff_out = eval_breakpoints_vec(bp_cutoff, times,
                                          default=float(p.bandlimit_out_hz))
        stretch = eval_breakpoints_vec(bp_stretch, times,
                                       default=float(p.partial_stretch))
        gen_sr_evt = np.clip(np.rint(base_sr * ufac).astype(np.int64),
                             base_sr, MAX_GEN_SR)
        floor_n = 64 if (mode == "IR fragment" and have_ir) else \
            _EVENT_N_FLOORS.get(mode, 16)
        n_ev = np.maximum(floor_n,
                          np.rint(gen_sr_evt * float(p.micro_ms) / 1000.0)
                          .astype(np.int64))
        start = np.rint(times * base_sr).astype(np.int64)
        keep = start < out_n
        amp_base = np.ones(T, np.float64)
        if rate > 0:
            amp_base = np.clip(dens / max(1e-6, rate), 0.15, 4.0)

        # the reference's sequential draw order: one amp uniform per event,
        # then (kept events only) one bounded integers draw
        max_off = 0
        if p.grain_offset_on:
            max_off = int(round(float(p.grain_offset_max_ms) / 1000.0
                                * base_sr))
        lo_a = 1.0 - float(p.grain_amp_rand)
        hi_a = 1.0 + float(p.grain_amp_rand)
        amp_u = np.empty(T, np.float64)
        offs = np.zeros(T, np.int64)
        if max_off > 0:
            bound = np.maximum(1, np.minimum(max_off, n_ev))
            for i in range(T):
                amp_u[i] = rng.uniform(lo_a, hi_a)
                if keep[i]:
                    offs[i] = rng.integers(0, bound[i])
        elif T:
            amp_u[:] = rng.uniform(lo_a, hi_a, size=T)

        kept = np.flatnonzero(keep)
        E = int(kept.size)
        prog = {
            "out_n": out_n,
            "E": E,
            "gen_sr_base": int(np.clip(int(round(base_sr * base_unfold)),
                                       base_sr, MAX_GEN_SR)),
        }
        if E == 0:
            return prog

        n_k = n_ev[kept]
        L = _next_pow2(int(n_k.max()))
        prog["L"] = L
        prog["seed"] = (int(p.seed) + kept).astype(np.int32)
        prog["n"] = n_k.astype(np.int32)
        prog["offset"] = offs[kept].astype(np.int32)
        prog["start"] = start[kept].astype(np.int32)
        gsr_k = gen_sr_evt[kept]
        prog["gen_sr"] = gsr_k.astype(np.float32)
        prog["inv_gen_sr"] = np.float32(1.0) / gsr_k.astype(np.float32)
        prog["amp"] = (amp_base * amp_u)[kept].astype(np.float32)
        prog["cutoff_gen"] = (cutoff_out * ufac)[kept].astype(np.float32)
        prog["stretch"] = stretch[kept].astype(np.float32)

        if mode in _AUX_MODES or p.res_bank_on or p.wg_on:
            aux = {k: [] for k in _AUX_KEYS}
            for i in kept:
                _event_aux_draws(p, mode, int(i), int(n_ev[i]),
                                 int(gen_sr_evt[i]), have_ir, ir_mono,
                                 img_gray, aux)
            _finalize_aux(p, mode, prog, aux, L)
        return prog


def _event_aux_draws(p, mode, i, n, gen_sr_evt, have_ir, ir_mono, img_gray,
                     aux):
    """Event i's auxiliary draws (microsound.py:324): dust impulses
    (later writes to one position win), crackle spikes, wavelet atoms,
    the IR slice or image row, resonator modes, waveguide lines."""
    if mode in _AUX_MODES:
        erng = np.random.default_rng(int(p.seed) + i)
        if mode == "Dust impulses":
            k = int(max(1, round(float(p.dust_density) * n)))
            idx = erng.integers(0, n, size=k)
            amps = erng.uniform(-1, 1, size=k)
            _, keep = np.unique(idx[::-1], return_index=True)
            keep = (len(idx) - 1) - keep
            aux["dust_pos"].append(idx[keep])
            aux["dust_amp"].append(amps[keep])
            aux["dust_k"].append(len(keep))
            aux["dust_klen"].append(max(8, int(0.01 * n)))
        elif mode == "Crackle / corona":
            steps = erng.pareto(float(p.crackle_alpha),
                                int(max(8, float(p.crackle_density))))
            tt = np.cumsum(steps)
            tt = tt[tt < n].astype(np.int64)
            amps = np.asarray([erng.uniform(-1, 1) for _ in range(len(tt))],
                              np.float64)
            aux["ck_pos"].append(tt)
            aux["ck_amp"].append(amps)
        elif mode == "Wavelet atoms":
            f0s, sigs, phs, shs = [], [], [], []
            for _ in range(int(max(1, p.wav_count))):
                f0s.append(float(p.wav_base_hz)
                           * 2.0 ** erng.uniform(-p.wav_spread, p.wav_spread))
                sigs.append(max(0.03, float(p.micro_ms)
                                * erng.uniform(0.04, 0.18)) / 1000.0)
                phs.append(erng.uniform(0, 2 * np.pi) / (2 * np.pi))
                shs.append(int(erng.integers(-(n // 8), n // 8)))
            aux["wl_f0"].append(f0s)
            aux["wl_sigma"].append(sigs)
            aux["wl_phase"].append(phs)
            aux["wl_shift"].append(shs)
        elif mode == "IR fragment":
            if have_ir:
                st = int(erng.integers(0, max(1, ir_mono.size - 256)))
                sl = ir_mono[st:st + 256]
                aux["frag"].append(sl.astype(np.float32))
                aux["frag_len"].append(len(sl))
            else:
                aux["frag"].append(np.zeros(2, np.float32))
                aux["frag_len"].append(2)
        elif mode == "Image scanline":
            if img_gray is not None:
                h, w = img_gray.shape
                y = int(erng.integers(0, h))
                line = img_gray[y, :].astype(np.float64) / 255.0
                line = (line - line.mean()) * 2.0
                aux["frag"].append(line.astype(np.float32))
                aux["frag_len"].append(w)
            else:
                aux["frag"].append(np.zeros(2, np.float32))
                aux["frag_len"].append(2)

    if p.res_bank_on:
        rrng = np.random.default_rng(int(p.seed) + i + 321)
        modes = int(max(1, p.res_modes))
        fs, ps = [], []
        for k in range(modes):
            f = float(p.res_fmin) * ((float(p.res_fmax)
                                      / max(1.0, float(p.res_fmin)))
                                     ** (k / max(1, modes - 1)))
            f *= 2.0 ** rrng.uniform(-0.02, 0.02)
            ps.append(rrng.uniform(0, 2 * np.pi) / (2 * np.pi))
            fs.append(f)
        aux["res_f"].append(fs)
        aux["res_ph"].append(ps)
    if p.wg_on:
        wrng = np.random.default_rng(int(p.seed) + i + 777)
        ds, gs, ms = [], [], []
        for _ in range(int(max(1, p.wg_lines))):
            ds.append(int(max(1, round(wrng.uniform(0.4, float(p.wg_max_ms))
                                       / 1000.0 * gen_sr_evt))))
            gs.append(float(p.wg_fb) * wrng.uniform(0.6, 0.98))
            ms.append(wrng.uniform(0.15, 0.45))
        aux["wg_d"].append(ds)
        aux["wg_g"].append(gs)
        aux["wg_m"].append(ms)


def _finalize_aux(p, mode, prog, aux, L):
    """Stack the per-event aux rows into padded program arrays
    (microsound.py:410)."""
    def pad2d(rows, dtype, fill=0):
        m = max(max((len(r) for r in rows), default=1), 1)
        out = np.full((len(rows), m), fill, dtype)
        for j, r in enumerate(rows):
            out[j, :len(r)] = r
        return out

    if mode == "Dust impulses":
        prog["dust_pos"] = pad2d(aux["dust_pos"], np.int32, fill=L)
        prog["dust_amp"] = pad2d(aux["dust_amp"], np.float32)
        prog["dust_k"] = np.asarray(aux["dust_k"], np.int32)
        prog["dust_klen"] = np.asarray(aux["dust_klen"], np.int32)
        prog["dust_kmax"] = int(max(aux["dust_klen"]))
    elif mode == "Crackle / corona":
        prog["ck_pos"] = pad2d(aux["ck_pos"], np.int32, fill=L)
        prog["ck_amp"] = pad2d(aux["ck_amp"], np.float32)
        prog["ck_klen"] = int(max(8, int(p.crackle_kernel)))
    elif mode == "Wavelet atoms":
        prog["wl_f0"] = pad2d(aux["wl_f0"], np.float32)
        prog["wl_sigma"] = pad2d(aux["wl_sigma"], np.float32)
        prog["wl_phase"] = pad2d(aux["wl_phase"], np.float32)
        prog["wl_shift"] = pad2d(aux["wl_shift"], np.int32)
    elif mode in ("IR fragment", "Image scanline"):
        prog["frag"] = pad2d(aux["frag"], np.float32)
        prog["frag_len"] = np.asarray(aux["frag_len"], np.int32)
    if p.res_bank_on:
        prog["res_f"] = pad2d(aux["res_f"], np.float32)
        prog["res_ph"] = pad2d(aux["res_ph"], np.float32)
    if p.wg_on:
        prog["wg_d"] = pad2d(aux["wg_d"], np.int32, fill=1)
        prog["wg_g"] = pad2d(aux["wg_g"], np.float32)
        prog["wg_m"] = pad2d(aux["wg_m"], np.float32)
        prog["wg_dmax"] = int(prog["wg_d"].max())
    return prog


# ---------------------------------------------------------------------------
# Grain chain configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainCfg:
    """The grain chain's static configuration (microsound.py:584), less the
    TPU's overlap-add strategy and one-hot window, plus the scatter passes
    of the crackle and the partial lock."""
    mode_id: int
    L: int                       # grain buffer length (pow2 cover of n)
    out_n: int
    shared_stretch: bool         # one stretch factor for all, and the chain
    #                              is generate -> fused lowpass + stretch
    micro_ms: float
    noise_tilt: float
    ring_hz: float
    ring_decay_ms: float
    ss: tuple                    # (threshold, build, decay, noise)
    chaos: tuple                 # (r, gate)
    wav_count: int
    dust_kmax: int
    ck_klen: int
    bandlimit_on: bool
    bandlimit_roll: float
    nl_warp_on: bool
    nl_warp_power: float
    cep_warp_on: bool
    cep_factor: float
    partial_lock_on: bool
    pl_top_n: int
    pl_neigh: int
    res_on: bool
    res_modes: int
    res_decay_ms: float
    wg_on: bool
    wg_lines: int
    wg_dmax: int
    multiband: tuple             # () or (bands, unfolds, roll)
    fb_on: bool
    fb_amt: float
    imprint_on: bool
    imprint_amt: float
    imprint_smooth: float
    shared_gain: bool = False    # every event shares (gen_sr, cutoff)
    oa_win: int = 0              # overlap-add window (1024-bucketed cover
    #                              of n; samples at or beyond n are zero)
    n_fft: int = 0               # the true grain length every event shares
    #                              (0: mixed lengths, the padded-L chain)
    ck_passes: int = 1           # most crackle spikes on one sample
    lock_passes: int = 1         # bound on peaks one lock offset sends to
    #                              one bin (spectral.lock_passes)


def chain_cfg(params: MicrosoundParams, prog: dict) -> ChainCfg:
    """The chain configuration of a non-empty program (microsound.py:645),
    with JAX's rules for the shared stretch, the shared gain and the exact
    grain length."""
    if int(prog.get("E", 0)) <= 0:
        raise ValueError("chain_cfg requires a non-empty event program "
                         "(prog['E'] == 0: nothing to chain)")
    p = params
    mb = ()
    if p.unfold_mode != "Classic reinterpret":
        bands = ((0.0, float(p.mb_b1)), (float(p.mb_b1), float(p.mb_b2)),
                 (float(p.mb_b2), float(p.mb_b3)))
        unfolds = (float(p.mb_u1), float(p.mb_u2), float(p.mb_u3))
        mb = (bands, unfolds, float(p.mb_roll))
    fuse = (bool(p.bandlimit_on) and not p.nl_warp_on and not p.cep_warp_on
            and not p.partial_lock_on)
    shared = (fuse and not p.res_bank_on and not p.wg_on and not mb
              and bool(np.all(prog["stretch"] == prog["stretch"][0])))
    shared_gain = bool(
        shared and np.all(prog["gen_sr"] == prog["gen_sr"][0])
        and np.all(prog["cutoff_gen"] == prog["cutoff_gen"][0]))
    n_fft = 0
    if bool(np.all(prog["n"] == prog["n"][0])):
        n_fft = int(prog["n"][0])
    ck_passes = 1
    if "ck_pos" in prog:
        ck_passes = generators.crackle_passes(prog["ck_pos"], prog["n"])
    return ChainCfg(
        n_fft=n_fft,
        shared_gain=shared_gain,
        oa_win=_oa_window_len(prog),
        mode_id=GEN_MODES.index(p.gen_mode),
        L=int(prog["L"]), out_n=int(prog["out_n"]),
        shared_stretch=shared,
        micro_ms=float(p.micro_ms), noise_tilt=float(p.noise_tilt),
        ring_hz=float(p.ring_hz), ring_decay_ms=float(p.ring_decay_ms),
        ss=(float(p.ss_threshold), float(p.ss_build), float(p.ss_decay),
            float(p.ss_noise)),
        chaos=(float(p.chaos_r), float(p.chaos_gate)),
        wav_count=int(max(1, p.wav_count)),
        dust_kmax=int(prog.get("dust_kmax", 8)),
        ck_klen=int(prog.get("ck_klen", 8)),
        bandlimit_on=bool(p.bandlimit_on),
        bandlimit_roll=float(p.bandlimit_roll_hz),
        nl_warp_on=bool(p.nl_warp_on), nl_warp_power=float(p.nl_warp_power),
        cep_warp_on=bool(p.cep_warp_on), cep_factor=float(p.cep_factor),
        partial_lock_on=bool(p.partial_lock_on),
        pl_top_n=int(p.pl_top_n), pl_neigh=int(p.pl_neigh),
        res_on=bool(p.res_bank_on), res_modes=int(max(1, p.res_modes)),
        res_decay_ms=float(p.res_decay_ms),
        wg_on=bool(p.wg_on), wg_lines=int(max(1, p.wg_lines)),
        wg_dmax=int(prog.get("wg_dmax", 1)),
        multiband=mb,
        fb_on=bool(p.event_feedback_on), fb_amt=float(p.event_feedback_amt),
        imprint_on=bool(p.spectral_imprint_on),
        imprint_amt=float(p.spectral_imprint_amt),
        imprint_smooth=float(p.spectral_imprint_smooth),
        ck_passes=ck_passes,
        lock_passes=spectral.lock_passes(float(np.min(prog["stretch"])),
                                         int(p.pl_top_n)),
    )


_EV_CHUNK_KEYS = ("seed", "n", "gen_sr", "inv_gen_sr", "amp", "offset",
                  "start", "cutoff_gen", "stretch") + _AUX_KEYS


def _oa_window_len(prog: dict) -> int:
    """The 1024-bucketed cover of the largest true grain length n
    (microsound.py:941): samples at or beyond n are exactly zero, so the
    overlap-add skips them (adding +0.0 changes nothing)."""
    L = int(prog["L"])
    n_max = int(np.max(prog["n"]))
    return min(L, max(1024, -(-n_max // 1024) * 1024))


def _event_chunk(E: int, L: int) -> int:
    """Default events per chunk (microsound.py:1152-1164): E rounded up to
    a sixteenth-octave quantum, capped at ~256 MB of grain buffers."""
    quantum = max(8, _next_pow2(max(1, E)) // 16)
    return max(1, min(-(-E // quantum) * quantum, (1 << 26) // max(1, L)))


def _chunk_events(prog: dict, ec: int) -> list[dict]:
    """Split the per-event arrays into chunks of ec events (microsound.py:
    955, without the TPU ring plan).  Padding events (amp 0, start at the
    end of the render, n 16, zero aux rows but a waveguide delay of L:
    one link a column, the kernel's cheapest) fill the last chunk and add
    only zeros.  Each chunk carries ``oa_start = L + start - offset``, its
    windows' starts in the margin-layout buffer — NOT sorted: offsets
    reach back past earlier events."""
    E = prog["E"]
    L = int(prog["L"])
    chunks = []
    for s in range(0, E, ec):
        e = min(E, s + ec)
        c = {}
        for k in _EV_CHUNK_KEYS:
            if k not in prog:
                continue
            a = prog[k][s:e]
            if e - s < ec:
                pad = [(0, ec - (e - s))] + [(0, 0)] * (a.ndim - 1)
                fill = {"start": prog["out_n"], "n": 16,
                        "wg_d": L}.get(k, 0)
                a = np.pad(a, pad, constant_values=fill)
                if k == "gen_sr":
                    a[e - s:] = 48000.0
            c[k] = a
        c["oa_start"] = (L + c["start"].astype(np.int64)
                         - c["offset"].astype(np.int64)).astype(np.int32)
        chunks.append(c)
    return chunks


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def _generate(ev: dict, cfg: ChainCfg) -> torch.Tensor:
    """The selected micro-generator for a batch of events
    (microsound.py:714): raw grains f32 [E, L], zero beyond each n."""
    i = torch.arange(cfg.L, device=ev["n"].device)
    n = ev["n"]
    m = cfg.mode_id
    if m <= 4:
        return generators.gen_basic(
            i, n, ev["seed"], ev["inv_gen_sr"], cfg.micro_ms, m,
            cfg.noise_tilt, cfg.n_fft or cfg.L, dust_pos=ev.get("dust_pos"),
            dust_amp=ev.get("dust_amp"), dust_k=ev.get("dust_k"),
            dust_klen=ev.get("dust_klen"), dust_kmax=cfg.dust_kmax,
            ring_hz=cfg.ring_hz, ring_decay_ms=cfg.ring_decay_ms)
    if m == 5:      # Crackle / corona
        return generators.gen_crackle(
            i, n, ev["ck_pos"], ev["ck_amp"],
            generators.exp_kernel(cfg.ck_klen, 6.0), cfg.ck_klen,
            passes=cfg.ck_passes)
    if m == 6:      # Stick–slip friction
        return generators.gen_stick_slip(i, n, ev["seed"], *cfg.ss)
    if m == 7:      # Micro-chaos
        r, gate = cfg.chaos
        return generators.gen_micro_chaos(i, n, ev["seed"], r, gate,
                                          generators.exp_kernel(48, 5.0))
    if m == 8:      # Wavelet atoms
        return generators.gen_wavelet_atoms(
            i, n, ev["inv_gen_sr"], ev["wl_f0"], ev["wl_sigma"],
            ev["wl_phase"], ev["wl_shift"], cfg.wav_count)
    nc = n.to(torch.int64)[:, None]
    x = generators.gen_from_fragment(i, n, ev["frag"], ev["frag_len"])
    x = x * generators.hann_t(i, nc)
    if m == 9:      # IR fragment: interp -> hann -> normalize 0.9
        return space.normalize_masked(x, i < nc, 0.9)
    # Image scanline: interp -> hann -> exp smear
    x = generators.masked_conv_same(x, generators.exp_kernel(48, 5.0), 48)
    return torch.where(i < nc, x, 0.0)


def _one_grain(ev: dict, cfg: ChainCfg) -> torch.Tensor:
    """The full per-event chain for a batch of events (microsound.py:760):
    generator, spectral chain (fused, exact-length or padded), resonator,
    waveguide, multi-band unfold; f32 [E, L], zero beyond each n."""
    i = torch.arange(cfg.L, device=ev["n"].device)
    n = ev["n"].to(torch.int64)[:, None]
    gsr = ev["gen_sr"][:, None]
    cutoff = ev["cutoff_gen"][:, None]
    stretch = ev["stretch"][:, None]
    nfft = cfg.n_fft or None
    x = _generate(ev, cfg)

    fuse = (cfg.bandlimit_on and not cfg.nl_warp_on and not cfg.cep_warp_on
            and not cfg.partial_lock_on)
    if fuse:
        x = spectral.lowpass_stretch_fused(x, gsr, cutoff, stretch,
                                           roll=cfg.bandlimit_roll,
                                           n_fft=nfft)
    elif nfft is not None:
        x = spectral.grain_chain_exact(
            x, gsr, nfft, cutoff=cutoff if cfg.bandlimit_on else None,
            roll=cfg.bandlimit_roll,
            warp_power=cfg.nl_warp_power if cfg.nl_warp_on else None,
            cep_factor=cfg.cep_factor if cfg.cep_warp_on else None,
            lock=((cfg.pl_top_n, cfg.pl_neigh)
                  if cfg.partial_lock_on else None),
            stretch=stretch, lock_passes_=cfg.lock_passes)
    else:
        if cfg.bandlimit_on:
            x = spectral.lowpass_fft(x, gsr, cutoff, roll=cfg.bandlimit_roll)
        if cfg.nl_warp_on:
            x = spectral.fft_warp_power(x, cfg.nl_warp_power)
        if cfg.cep_warp_on:
            x = spectral.cepstral_warp(x, cfg.cep_factor)
        if cfg.partial_lock_on:
            x = spectral.partial_lock_stretch(x, stretch, top_n=cfg.pl_top_n,
                                              neighborhood=cfg.pl_neigh,
                                              passes=cfg.lock_passes)
        else:
            x = spectral.fft_partial_stretch(x, stretch)

    if cfg.res_on:
        y = generators.resonator_bank(x, i, n, ev["inv_gen_sr"], ev["res_f"],
                                      ev["res_ph"], cfg.res_decay_ms,
                                      cfg.res_modes)
        x = torch.where(n >= 32, y, x)   # the reference skips short grains

    if cfg.wg_on:
        y = generators.waveguide_splinters(x, n, ev["wg_d"], ev["wg_g"],
                                           ev["wg_m"], cfg.wg_lines,
                                           cfg.wg_dmax)
        x = torch.where(n >= 64, y, x)

    if cfg.multiband:
        bands, unfolds, roll = cfg.multiband
        x = spectral.multiband_unfold(x, gsr, bands, unfolds, roll_hz=roll,
                                      n_fft=nfft)
        # unfold_reinterpret itself is the identity on samples
    return torch.where(i < n, x, 0.0)


def _init_carry(cfg: ChainCfg, device) -> tuple:
    """The feedback / imprint carry before the first event: (previous
    grain [L], its n, whether there is one, the imprint memory [nf],
    whether it holds a grain)."""
    nf = (cfg.n_fft or cfg.L) // 2 + 1
    return (torch.zeros(cfg.L, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros(nf, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def _fb_imprint_scan(grains: torch.Tensor, ns: torch.Tensor, carry,
                     cfg: ChainCfg):
    """The event-to-event feedback crossfade and the SpectralImprint EMA
    (microsound.py:827), one event after another: each grain blends with
    the previous output grain, then its magnitude spectrum with the
    running memory, on the exact grain length's bins (``cfg.n_fft``) or
    the padded length's.  Returns (carry, grains [E, L]); the carry goes
    on to the next chunk."""
    L = cfg.L
    j = torch.arange(L, device=grains.device)
    nfft = cfg.n_fft or L
    prev, prev_n, prev_valid, mem, mem_valid = (
        _init_carry(cfg, grains.device) if carry is None else carry)
    fb = float(np.float32(cfg.fb_amt))
    keep = float(np.float32(1.0) - np.float32(cfg.fb_amt))
    # the smooth and amount weights round as JAX's Python-float products
    sm, one_m_sm = cfg.imprint_smooth, 1.0 - cfg.imprint_smooth
    amt, one_m_amt = cfg.imprint_amt, 1.0 - cfg.imprint_amt
    phase_one = torch.tensor([1.0, 0.0], device=grains.device)
    true = torch.ones((), dtype=torch.bool, device=grains.device)
    out = torch.empty_like(grains)
    for e in range(grains.shape[0]):
        g, n = grains[e], ns[e]
        if cfg.fb_on:
            lim = torch.minimum(n, prev_n)
            blend = keep * g + fb * prev
            g = torch.where(prev_valid & (j < lim), blend, g)
        if cfg.imprint_on and cfg.imprint_amt > 0:
            X = exact_dft.rfft_n(g, nfft)
            mag = detmath.rounded(torch.abs, X)
            mem_new = torch.where(mem_valid, sm * mem + one_m_sm * mag, mag)
            mag2 = one_m_amt * mag + amt * mem_new
            Xr = torch.view_as_real(X)
            ph = torch.where((mag > 0)[:, None], Xr / (mag + 1e-30)[:, None],
                             phase_one)
            Y = torch.view_as_complex((mag2[:, None] * ph).contiguous())
            g2 = exact_dft.irfft_n(Y, nfft, out_len=L)
            g2 = torch.where(j < n, g2, 0.0)
            use = n >= 64                      # the imprint's gate
            g = torch.where(use, g2, g)
            mem = torch.where(use, mem_new, mem)
            mem_valid = mem_valid | use
        out[e] = g
        prev, prev_n, prev_valid = g, n, true
    return (prev, prev_n, prev_valid, mem, mem_valid), out


def chunk_body(cfg: ChainCfg, ev: dict, out: torch.Tensor, carry=None):
    """Render one chunk of events into the margin-layout buffer ``out``
    (in place; real audio lives at out[L : L + out_n]); returns (carry,
    the chunk's last grain).  Both branches of microsound.py:874: with
    one shared stretch, grain bank -> one fused lowpass + stretch pass;
    else the per-event chain.  Then the feedback / imprint scan (its carry
    across chunks), amp * window [offset, n) and the ordered overlap-add
    at oa_start = L + start - offset."""
    j = torch.arange(cfg.L, device=out.device)
    n = ev["n"].to(torch.int64)[:, None]
    if cfg.shared_stretch:
        raw = _generate(ev, cfg)
        x = spectral.lowpass_stretch_fused_shared(
            raw, ev["gen_sr"], ev["cutoff_gen"], ev["stretch"][0],
            roll=cfg.bandlimit_roll, shared_gain=cfg.shared_gain,
            n_fft=cfg.n_fft or None)
        grains = torch.where(j < n, x, 0.0)
    else:
        grains = _one_grain(ev, cfg)
    if cfg.fb_on or cfg.imprint_on:
        carry, grains = _fb_imprint_scan(grains, ev["n"], carry, cfg)
    valid = (j >= ev["offset"][:, None]) & (j < n)
    val = ev["amp"][:, None] * torch.where(valid, grains, 0.0)
    # the pow2 pad leaves [max n, L) exactly zero: the OA walks oa_win only
    val = val[:, :cfg.oa_win].contiguous()
    overlap_add.overlap_add(out, val, ev["oa_start"])
    return carry, grains[-1]


def _micro_last(prog: dict, cfg: ChainCfg, device) -> torch.Tensor:
    """The raw generator output of the LAST event (the reference's
    micro_last microscope buffer, microsound.py:1071), cut to its n."""
    last = {k: torch.tensor(prog[k][-1:], device=device)
            for k in _EV_CHUNK_KEYS if k in prog}
    return _generate(last, cfg)[0, :int(prog["n"][-1])]


@dataclass(frozen=True)
class FxCfg:
    out_n: int
    sr: int
    env: tuple            # (a, d, s, r, curve)
    er_on: bool
    ir_on: bool
    stereo_on: bool
    stereo_width: float
    sat_drive: float
    peak: float
    pcm16: bool = False   # return int16 PCM (wavcodec convention)


def fx_body(cfg: FxCfg, out: torch.Tensor, er_kernel: torch.Tensor,
            ir_kernel: torch.Tensor) -> torch.Tensor:
    """Global FX chain (microsound.py:1018): ADSR, one causal convolution
    (the ER kernel, already convolved with the IR when both are on),
    stereo diffusion, soft clip, normalize and optionally PCM16."""
    a, d, s, r, curve = cfg.env
    out = out * envelopes.make_adsr(cfg.out_n, cfg.sr, a, d, s, r, curve,
                                    device=out.device)
    if cfg.er_on:
        out = space.fft_convolve_causal(out, er_kernel)
    elif cfg.ir_on:
        out = space.fft_convolve_causal(out, ir_kernel)
    if cfg.stereo_on:
        st = space.spectral_diffusion_stereo(out, cfg.sr,
                                             width=cfg.stereo_width)
    else:
        st = torch.stack([out, out], dim=-1)
    st = space.soft_clip(st, drive=cfg.sat_drive)
    st = space.normalize(st, peak=cfg.peak)
    if cfg.pcm16:
        q = torch.clamp(torch.round(st * 32768.0), -32768.0, 32767.0)
        return q.to(torch.int16)
    return st


def render_device(cfg: ChainCfg | None, fx: FxCfg, chunks: list[dict],
                  er_kernel: torch.Tensor, ir_kernel: torch.Tensor,
                  progress=None):
    """The device part of a render (the JAX package's _fused_fn and its
    multi-chunk loop): every chunk overlap-adds into one margin-layout
    buffer made on the device, the feedback / imprint carry going from
    chunk to chunk, then the FX run on the audio span.  Returns (stereo,
    last grain or None).

    ``progress(pct, msg)``, where given, is called where the JAX package
    calls it (microsound.py:1177, :1194, :1213): after each chunk of a
    render of several, then once with (100, "Done.").  Its arguments come
    from the host's chunk count, so it adds no device work and no sync."""
    grain_last = None
    dev = er_kernel.device
    with span("microsound.chain", device=dev):
        if chunks:
            out = torch.zeros(overlap_add.ring_out_len(fx.out_n, cfg.L),
                              dtype=torch.float32, device=dev)
            carry = None
            n = len(chunks)
            for ci, ev in enumerate(chunks):
                carry, grain_last = chunk_body(cfg, ev, out, carry)
                if progress and n > 1:
                    progress(int(5 + 70 * (ci + 1) / n),
                             f"Events chunk {ci + 1}/{n}")
            audio = out[cfg.L: cfg.L + fx.out_n]
        else:
            audio = torch.zeros(fx.out_n, dtype=torch.float32, device=dev)
    with span("microsound.fx", device=dev):
        stereo = fx_body(fx, audio, er_kernel, ir_kernel)
    if progress:
        progress(100, "Done.")
    return stereo, grain_last


def program_to_device(prog: dict, device) -> dict:
    """A NumPy program dict (this package's or the JAX package's
    build_program output, a chunk of it, or the space kernels) as tensors
    on ``device``; NumPy arrays are copied with their dtype, other values
    pass through."""
    return {k: torch.tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in prog.items()}


_SPACE_KERNEL_CACHE = Memo(8)


def _space_ir(p: MicrosoundParams, ir_audio) -> np.ndarray | None:
    """The IR as the space FX convolve it: f64, channels averaged, cut to
    ``space_ir_max_samps`` and 8 192 taps; None where the IR is off or
    shorter than 8 taps."""
    if not p.space_ir_on or ir_audio is None:
        return None
    irm = np.asarray(ir_audio, np.float64)
    if irm.ndim > 1:
        irm = irm.mean(axis=1)
    irm = irm[: int(p.space_ir_max_samps)]
    irm = irm[: min(irm.size, 8192)]       # convolve_ir_short cap
    return irm if irm.size >= 8 else None


def _space_kernels(p: MicrosoundParams, ir_audio, device="cuda"):
    """ER tap kernel, IR kernel and, by convolution associativity, their
    combined form (microsound.py:1084) — memoized on the ER parameters,
    the IR's digest and the device, since parameter sweeps re-render with
    one space setup.  On the CPU they are NumPy arrays, on a CUDA device
    tensors on it; the combined kernel is ``space.er_ir_kernels``'s, made
    only where the ER cloud and the IR are both on.  The span's
    ``launched`` says whether that ran its kernel on a card."""
    dev = canonical_device(device)
    with span("microsound.space_kernels") as sp:
        irm = _space_ir(p, ir_audio)
        ir_on = irm is not None
        key = (bool(p.er_cloud_on), int(p.er_taps), float(p.er_max_ms),
               int(p.base_sr), int(p.seed),
               hashlib.blake2b(irm.tobytes(), digest_size=16).digest()
               if ir_on else None)
        sp.set(launched=False)

        def build():
            er_kernel = np.zeros(2, np.float32)
            if p.er_cloud_on:
                er_kernel = space.er_tap_kernel(int(p.er_taps),
                                                float(p.er_max_ms),
                                                int(p.base_sr), int(p.seed))
            if p.er_cloud_on and ir_on:
                sp.set(launched=dev.type != "cpu")
                return (*space.er_ir_kernels(er_kernel, irm, dev), ir_on)
            ir_kernel = (irm.astype(np.float32) if ir_on
                         else np.zeros(2, np.float32))
            if dev.type == "cpu":
                return er_kernel, ir_kernel, ir_on
            return (torch.from_numpy(er_kernel).to(dev),
                    torch.from_numpy(ir_kernel).to(dev), ir_on)

        out, hit = _SPACE_KERNEL_CACHE.get(key, build, device=dev)
        sp.set(hit=hit)
        return out


def fx_cfg(params: MicrosoundParams, out_n: int, ir_on: bool,
           pcm16: bool) -> FxCfg:
    p = params
    return FxCfg(out_n=out_n, sr=int(p.base_sr),
                 env=(float(p.env_a), float(p.env_d), float(p.env_s),
                      float(p.env_r), float(p.env_curve)),
                 er_on=bool(p.er_cloud_on), ir_on=ir_on,
                 stereo_on=bool(p.stereo_on),
                 stereo_width=float(p.stereo_width),
                 sat_drive=float(p.sat_drive), peak=float(p.peak),
                 pcm16=bool(pcm16))


def render_program(params: MicrosoundParams, prog: dict, space_kernels,
                   *, device="cuda", event_chunk: int | None = None,
                   pcm16: bool = False, want_micro_last: bool = False,
                   progress=None):
    """Render a built program: ``prog`` from build_program (this package's
    or the JAX package's) and ``space_kernels`` = (er_kernel, ir_kernel,
    ir_on) from _space_kernels.  Returns (stereo on ``device``, meta):
    stereo is f32 [out_n, 2], or int16 PCM with ``pcm16``; with
    ``want_micro_last`` meta also holds micro_last, the last event's raw
    generator output cut to its n.  ``progress(pct, msg)`` is called as
    ``render_device`` says."""
    er_kernel, ir_kernel, ir_on = space_kernels
    fx = fx_cfg(params, prog["out_n"], ir_on, pcm16)
    cfg, chunks = None, []
    with span("microsound.upload"):
        if prog["E"] > 0:
            ec = event_chunk or _event_chunk(prog["E"], prog["L"])
            cfg = chain_cfg(params, prog)
            chunks = [program_to_device(c, device)
                      for c in _chunk_events(prog, ec)]
        kern = program_to_device({"er": er_kernel, "ir": ir_kernel}, device)
    stereo, grain_last = render_device(cfg, fx, chunks, kern["er"],
                                       kern["ir"], progress)
    meta = {"out_sr": int(params.base_sr),
            "design_sr_base": prog["gen_sr_base"],
            "events": prog["E"],
            "grain_last": grain_last}
    if want_micro_last and cfg is not None:
        meta["micro_last"] = _micro_last(prog, cfg, device)
    return stereo, meta


def render(params: MicrosoundParams, ir_audio=None, img_gray=None, *,
           device="cuda", event_chunk: int | None = None,
           pcm16: bool = False, want_micro_last: bool = False,
           progress=None):
    """Full Microsound render (microsound.py:1124) on ``device``: returns
    (stereo tensor [out_n, 2] on the device — f32, or int16 PCM with
    ``pcm16`` — and a meta dict with out_sr, design_sr_base, events,
    grain_last, the last event's grain after the chain, and with
    ``want_micro_last`` micro_last).  ``img_gray`` is the image-scanline
    mode's grayscale array (0-255, rows x columns); ``ir_audio`` feeds
    the IR-fragment mode and the IR convolution.  ``progress(pct, msg)``,
    where given, hears of each chunk of a render of several and of the
    end, as in the JAX package."""
    with span("microsound.render"):
        prog = build_program(params, ir_audio=ir_audio, img_gray=img_gray)
        return render_program(params, prog,
                              _space_kernels(params, ir_audio, device),
                              device=device, event_chunk=event_chunk,
                              pcm16=pcm16, want_micro_last=want_micro_last,
                              progress=progress)


def _start_pull(stereo: torch.Tensor, stream):
    """Start copying a render to the host; returns a function that waits
    for the copy and gives the NumPy array.  On the card the copy runs on
    ``stream`` into pinned memory once the render's work on the current
    stream is done, so the next job's render proceeds meanwhile (a plain
    ``.cpu()`` would wait for every job already enqueued)."""
    if stereo.device.type != "cuda":
        return stereo.numpy
    host = torch.empty(stereo.shape, dtype=stereo.dtype, pin_memory=True)
    with torch.cuda.device(stereo.device):
        rendered = torch.cuda.Event()
        rendered.record()
        with torch.cuda.stream(stream):
            stream.wait_event(rendered)
            host.copy_(stereo, non_blocking=True)
            stereo.record_stream(stream)
            copied = torch.cuda.Event()
            copied.record(stream)

    def wait() -> np.ndarray:
        copied.synchronize()
        return host.numpy()
    return wait


def batch_render(params: MicrosoundParams, out_dir: str,
                 seeds=None, unfolds=None, stretches=None,
                 ir_audio=None, img_gray=None, manifest_path=None,
                 progress=None, *, device="cuda") -> list[str]:
    """Batch render over a seeds x unfolds x stretches grid
    (main_v2.py:1524-1596; microsound.py:1218) on ``device``, with a
    resumable manifest (``parallel.batch.BatchManifest``): jobs marked
    done are skipped and their paths returned, a job that fails is marked
    failed with its error while the others go on.  One job deep: job k's
    render is dispatched, then job k-1 is pulled and written as a float
    WAV.  Returns the written WAV paths."""
    import os

    from ..parallel.batch import BatchManifest
    from ..utils import io as audio_io

    seeds = list(seeds) if seeds else [params.seed]
    unfolds = list(unfolds) if unfolds else [params.time_unfold]
    stretches = list(stretches) if stretches else [params.partial_stretch]

    os.makedirs(out_dir, exist_ok=True)
    jobs = [(s, u, st) for s in seeds for u in unfolds for st in stretches]
    job_ids = [f"seed{s}_unfold{u:g}_stretch{st:g}" for s, u, st in jobs]
    manifest = None
    if manifest_path:
        manifest = BatchManifest.open_or_create(manifest_path, job_ids)
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    written = []
    pending = None     # (pull, path, jid, meta): the 1-deep pipeline

    def _flush(item):
        pull, path, jid, meta = item
        try:
            audio_io.write_wav(path, pull(), int(params.base_sr))
            written.append(path)
            if manifest:
                manifest.mark(jid, "done", events=meta["events"])
        except Exception as e:   # per-item error isolation (SURVEY.md §5)
            if manifest:
                manifest.mark(jid, "failed",
                              error=f"{type(e).__name__}: {e}")
            else:
                raise

    for k, ((s, u, st), jid) in enumerate(zip(jobs, job_ids)):
        path = os.path.join(out_dir, jid + ".wav")
        if manifest and manifest.jobs.get(jid, {}).get("status") == "done":
            written.append(path)
            continue
        p = MicrosoundParams.from_dict(params.to_dict())
        p.seed = int(s)
        p.time_unfold = float(u)
        p.partial_stretch = float(st)
        try:
            # dispatch job k's render, THEN pull job k-1, whose copy runs
            # on the side stream behind it while job k computes
            stereo, meta = render(p, ir_audio=ir_audio, img_gray=img_gray,
                                  device=dev)
            item = (_start_pull(stereo, stream), path, jid, meta)
            if pending is not None:
                _flush(pending)
            pending = item
        except Exception as e:
            if manifest:
                manifest.mark(jid, "failed", error=f"{type(e).__name__}: {e}")
            else:
                raise
        if progress:
            progress(int(100 * (k + 1) / len(jobs)), jid)
    if pending is not None:
        _flush(pending)
    return written

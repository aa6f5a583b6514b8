"""Microsound engine — port of audio_suite_tpu/models/microsound.py.

Ported slice: the "Noise burst" generator at a fixed grain length, with a
stretch factor shared by every event, through the fused lowpass + stretch,
the ordered overlap-add and the global FX:

- host: ``MicrosoundParams``, ``build_program`` (the vectorized event
  program), ``chain_cfg``, event chunking and the ER / IR space
  kernels — NumPy, identical to the JAX package's arrays;
- device: ``chunk_body`` (grain bank -> fused spectral pass -> overlap-add
  into the margin-layout buffer) and ``fx_body`` (ADSR, ER/IR convolution,
  stereo diffusion, soft clip, normalize, PCM16), driven by ``render``.

PyTorch runs eagerly, so the JAX package's single-chunk fused dispatch and
its multi-chunk loop are one loop here (``render_device``).  Everything
outside the slice raises ``NotImplementedError`` naming its ROADMAP queue
item; nothing renders silently wrong.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..events.schedulers import generate_event_times
from ..ops import envelopes, generators, overlap_add, space, spectral
from ..utils.breakpoints import eval_breakpoints_vec, parse_breakpoints

GEN_MODES = (
    "Gaussian click", "Dust impulses", "Noise burst", "Skewed transient",
    "Resonant strike", "Crackle / corona", "Stick–slip friction",
    "Micro-chaos", "Wavelet atoms", "IR fragment", "Image scanline",
)
MAX_GEN_SR = 30_000_000  # design-rate clamp

_QUEUE4 = "ROADMAP queue 4, Microsound all paths"


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

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_AUX_MODES = ("Dust impulses", "Crackle / corona", "Wavelet atoms",
              "IR fragment", "Image scanline")

_EVENT_N_FLOORS = {"Stick–slip friction": 64, "Micro-chaos": 64,
                   "Wavelet atoms": 128, "Image scanline": 64}


def build_program(params: MicrosoundParams, ir_audio=None) -> dict:
    """The event program (microsound.py:457): times, per-event lengths,
    design rates, amps, offsets, cutoffs and stretch factors, with the
    reference's sequential rng(seed + 123456) draw order.  Array for array
    equal to the JAX package's build_program.  Modes and options that need
    per-event auxiliary draws are not ported and raise."""
    del ir_audio        # used only by the (unported) IR-fragment mode
    p = params
    mode = p.gen_mode
    if mode in _AUX_MODES or p.res_bank_on or p.wg_on:
        raise NotImplementedError(
            f"per-event auxiliary draws (mode {mode!r}, resonator bank or "
            f"waveguide) are not ported ({_QUEUE4})")
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

    dens = eval_breakpoints_vec(bp_density, times, default=rate)
    ufac = np.maximum(1.0, eval_breakpoints_vec(bp_unfold, times,
                                                default=base_unfold))
    cutoff_out = eval_breakpoints_vec(bp_cutoff, times,
                                      default=float(p.bandlimit_out_hz))
    stretch = eval_breakpoints_vec(bp_stretch, times,
                                   default=float(p.partial_stretch))
    gen_sr_evt = np.clip(np.rint(base_sr * ufac).astype(np.int64),
                         base_sr, MAX_GEN_SR)
    floor_n = _EVENT_N_FLOORS.get(mode, 16)
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
        max_off = int(round(float(p.grain_offset_max_ms) / 1000.0 * base_sr))
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
    prog["L"] = _next_pow2(int(n_k.max()))
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
    return prog


# ---------------------------------------------------------------------------
# Grain chain configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChainCfg:
    """What the ported grain chain needs to know about a program."""
    mode_id: int
    L: int                 # grain buffer length (pow2 cover of n)
    n_fft: int             # the true grain length every event shares
    oa_win: int            # overlap-add window (1024-bucketed cover of n)
    shared_gain: bool      # every event shares (gen_sr, cutoff)
    micro_ms: float
    noise_tilt: float
    bandlimit_roll: float


def chain_cfg(params: MicrosoundParams, prog: dict) -> ChainCfg:
    """The chain configuration of a non-empty program (microsound.py:645).
    Raises NotImplementedError for every chain the port does not have."""
    if int(prog.get("E", 0)) <= 0:
        raise ValueError("chain_cfg requires a non-empty event program "
                         "(prog['E'] == 0: nothing to chain)")
    p = params
    if p.gen_mode != GEN_MODES[generators.NOISE_BURST]:
        raise NotImplementedError(f"generator mode {p.gen_mode!r} ({_QUEUE4})")
    if p.event_feedback_on or p.spectral_imprint_on:
        raise NotImplementedError(f"event feedback / spectral imprint scan "
                                  f"({_QUEUE4})")
    if (not p.bandlimit_on or p.nl_warp_on or p.cep_warp_on
            or p.partial_lock_on or p.unfold_mode != "Classic reinterpret"):
        raise NotImplementedError(f"unfused warp chain: the port runs only "
                                  f"the fused lowpass + stretch ({_QUEUE4})")
    if not bool(np.all(prog["stretch"] == prog["stretch"][0])):
        raise NotImplementedError(f"per-event stretch factors ({_QUEUE4})")
    if not bool(np.all(prog["n"] == prog["n"][0])):
        raise NotImplementedError(f"mixed grain lengths, the padded-L "
                                  f"fallback ({_QUEUE4})")
    shared_gain = bool(np.all(prog["gen_sr"] == prog["gen_sr"][0])
                       and np.all(prog["cutoff_gen"] == prog["cutoff_gen"][0]))
    return ChainCfg(
        mode_id=generators.NOISE_BURST, L=int(prog["L"]),
        n_fft=int(prog["n"][0]),
        oa_win=_oa_window_len(prog), shared_gain=shared_gain,
        micro_ms=float(p.micro_ms), noise_tilt=float(p.noise_tilt),
        bandlimit_roll=float(p.bandlimit_roll_hz))


_EV_CHUNK_KEYS = ("seed", "n", "gen_sr", "inv_gen_sr", "amp", "offset",
                  "start", "cutoff_gen", "stretch")


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
    end of the render) fill the last chunk and add only zeros.  Each chunk
    carries ``oa_start = L + start - offset``, its windows' starts in the
    margin-layout buffer — NOT sorted: offsets reach back past earlier
    events."""
    E = prog["E"]
    L = int(prog["L"])
    chunks = []
    for s in range(0, E, ec):
        e = min(E, s + ec)
        c = {}
        for k in _EV_CHUNK_KEYS:
            a = prog[k][s:e]
            if e - s < ec:
                fill = prog["out_n"] if k == "start" else (
                    16 if k == "n" else 0)
                a = np.pad(a, (0, ec - (e - s)), constant_values=fill)
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

def chunk_body(cfg: ChainCfg, ev: dict, out: torch.Tensor) -> torch.Tensor:
    """Render one chunk of events into the margin-layout buffer ``out``
    (in place; real audio lives at out[L : L + out_n]) and return the
    chunk's last grain.  The shared-stretch branch of microsound.py:874:
    grain bank -> one fused lowpass + stretch pass -> mask to n ->
    amp * window [offset, n) -> ordered overlap-add at
    oa_start = L + start - offset."""
    j = torch.arange(cfg.L, device=out.device)
    raw = generators.gen_basic(j, ev["n"], ev["seed"], ev["inv_gen_sr"],
                               cfg.micro_ms, cfg.mode_id, cfg.noise_tilt,
                               cfg.n_fft)
    x = spectral.lowpass_stretch_fused_shared(
        raw, ev["gen_sr"], ev["cutoff_gen"], ev["stretch"][0],
        roll=cfg.bandlimit_roll, shared_gain=cfg.shared_gain,
        n_fft=cfg.n_fft)
    n = ev["n"][:, None]
    grains = torch.where(j < n, x, 0.0)
    valid = (j >= ev["offset"][:, None]) & (j < n)
    val = ev["amp"][:, None] * torch.where(valid, grains, 0.0)
    # the pow2 pad leaves [max n, L) exactly zero: the OA walks oa_win only
    val = val[:, :cfg.oa_win].contiguous()
    overlap_add.overlap_add(out, val, ev["oa_start"])
    return grains[-1]


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
                  er_kernel: torch.Tensor, ir_kernel: torch.Tensor):
    """The device part of a render (the JAX package's _fused_fn and its
    multi-chunk loop): every chunk overlap-adds into one margin-layout
    buffer made on the device, then the FX run on the audio span.
    Returns (stereo, last grain or None)."""
    grain_last = None
    if chunks:
        out = torch.zeros(overlap_add.ring_out_len(fx.out_n, cfg.L),
                          dtype=torch.float32, device=er_kernel.device)
        for ev in chunks:
            grain_last = chunk_body(cfg, ev, out)
        audio = out[cfg.L: cfg.L + fx.out_n]
    else:
        audio = torch.zeros(fx.out_n, dtype=torch.float32,
                            device=er_kernel.device)
    return fx_body(fx, audio, er_kernel, ir_kernel), grain_last


def program_to_device(prog: dict, device) -> dict:
    """A NumPy program dict (this package's or the JAX package's
    build_program output, a chunk of it, or the space kernels) as tensors
    on ``device``; NumPy arrays are copied with their dtype, other values
    pass through."""
    return {k: torch.tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in prog.items()}


_SPACE_KERNEL_CACHE: dict = {}


def _space_kernels(p: MicrosoundParams, ir_audio):
    """ER tap kernel, IR kernel and, by convolution associativity, their
    combined form (microsound.py:1084) — memoized on the ER parameters and
    the IR's digest, since the f64 host convolution is costly and
    parameter sweeps re-render with one space setup."""
    ir_on = bool(p.space_ir_on) and ir_audio is not None
    irm = None
    if ir_on:
        irm = np.asarray(ir_audio, np.float64)
        if irm.ndim > 1:
            irm = irm.mean(axis=1)
        irm = irm[: int(p.space_ir_max_samps)]
        irm = irm[: min(irm.size, 8192)]       # convolve_ir_short cap
        ir_on = irm.size >= 8

    key = (bool(p.er_cloud_on), int(p.er_taps), float(p.er_max_ms),
           int(p.base_sr), int(p.seed),
           hashlib.blake2b(irm.tobytes(), digest_size=16).digest()
           if ir_on else None)
    hit = _SPACE_KERNEL_CACHE.get(key)
    if hit is not None:
        return hit

    er_kernel = np.zeros(2, np.float32)
    if p.er_cloud_on:
        er_kernel = space.er_tap_kernel(int(p.er_taps), float(p.er_max_ms),
                                        int(p.base_sr), int(p.seed))
    ir_kernel = irm.astype(np.float32) if ir_on else np.zeros(2, np.float32)
    if p.er_cloud_on and ir_on:
        er_kernel = np.convolve(er_kernel.astype(np.float64),
                                irm).astype(np.float32)
    if len(_SPACE_KERNEL_CACHE) >= 8:
        _SPACE_KERNEL_CACHE.pop(next(iter(_SPACE_KERNEL_CACHE)))
    _SPACE_KERNEL_CACHE[key] = (er_kernel, ir_kernel, ir_on)
    return er_kernel, ir_kernel, ir_on


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
                   pcm16: bool = False):
    """Render a built program: ``prog`` from build_program (this package's
    or the JAX package's) and ``space_kernels`` = (er_kernel, ir_kernel,
    ir_on) from _space_kernels.  Returns (stereo on ``device``, meta):
    stereo is f32 [out_n, 2], or int16 PCM with ``pcm16``."""
    er_kernel, ir_kernel, ir_on = space_kernels
    fx = fx_cfg(params, prog["out_n"], ir_on, pcm16)
    cfg, chunks = None, []
    if prog["E"] > 0:
        ec = event_chunk or _event_chunk(prog["E"], prog["L"])
        cfg = chain_cfg(params, prog)
        chunks = [program_to_device(c, device)
                  for c in _chunk_events(prog, ec)]
    kern = program_to_device({"er": er_kernel, "ir": ir_kernel}, device)
    stereo, grain_last = render_device(cfg, fx, chunks, kern["er"],
                                       kern["ir"])
    meta = {"out_sr": int(params.base_sr),
            "design_sr_base": prog["gen_sr_base"],
            "events": prog["E"],
            "grain_last": grain_last}
    return stereo, meta


def render(params: MicrosoundParams, ir_audio=None, *, device="cuda",
           event_chunk: int | None = None, pcm16: bool = False):
    """Full Microsound render (microsound.py:1124) on ``device``: returns
    (stereo tensor [out_n, 2] on the device — f32, or int16 PCM with
    ``pcm16`` — and a meta dict with out_sr, design_sr_base, events and
    grain_last, the last event's grain after the chain)."""
    prog = build_program(params, ir_audio=ir_audio)
    return render_program(params, prog, _space_kernels(params, ir_audio),
                          device=device, event_chunk=event_chunk,
                          pcm16=pcm16)

"""Plain NumPy reference of a Microsound render (the reference app's
microsound_0.2.1/main_v2.py:588-792 under the suite's exact-length grain
convention), in float64.

It takes the render's parameters (a plain dict: every ``MicrosoundParams``
field, as the configuration file states them) and the IR, and works out
everything else itself: the event times, the per-event draws, each grain,
the spectral chain, the overlap-add and the FX.  It imports nothing of the
program.  Paths: the "Noise burst" and "Stick–slip friction" generators at
one true grain length, the band limit with the shared partial stretch,
the ER cloud and the IR convolution, the stereo diffusion, the soft clip,
the normalize and PCM16.  Any other path raises ``NotImplementedError``.

``q`` is the precision hook, applied to every stage's output: ``exact``
for the reference, ``numerics.bf16`` for the control.
"""
from __future__ import annotations

import numpy as np

from .numerics import exact, normal, pcm16

MAX_GEN_SR = 30_000_000
STREAM_MAIN, STREAM_BUILD, STREAM_OUT, STREAM_TILT_IM = 0, 2, 3, 5
_MODES = {"Noise burst": 16, "Stick–slip friction": 64}   # mode: n floor
_OFF = ("nl_warp_on", "cep_warp_on", "partial_lock_on", "res_bank_on",
        "wg_on", "event_feedback_on", "spectral_imprint_on")


def _supported(p: dict):
    if p["gen_mode"] not in _MODES:
        raise NotImplementedError(f"mode {p['gen_mode']!r}")
    if p["unfold_mode"] != "Classic reinterpret" or any(p[k] for k in _OFF):
        raise NotImplementedError("only the band-limit + stretch chain")
    if not p["bandlimit_on"]:
        raise NotImplementedError("only the band-limited chain")
    if p["event_process"] not in ("Poisson", "Single"):
        raise NotImplementedError(f"process {p['event_process']!r}")


def parse_breakpoints(s):
    pts = []
    for part in (s or "").split(","):
        if ":" in part:
            t, v = part.split(":")
            try:
                pts.append((float(t), float(v)))
            except ValueError:
                pass
    return sorted(pts, key=lambda q: q[0])


def eval_breakpoints(pts, ts, default):
    """Piecewise-linear lane values at times ts; the default where the
    lane is empty, the end values beyond its knots."""
    ts = np.asarray(ts, np.float64)
    if not pts:
        return np.full(ts.shape, float(default))
    kt = np.asarray([q[0] for q in pts])
    kv = np.asarray([q[1] for q in pts])
    if len(pts) == 1:
        return np.full(ts.shape, kv[0])
    hi = np.clip(np.searchsorted(kt, ts, side="left"), 1, len(pts) - 1)
    lo = hi - 1
    a = (ts - kt[lo]) / np.maximum(1e-12, kt[hi] - kt[lo])
    v = (1 - a) * kv[lo] + a * kv[hi]
    return np.where(ts <= kt[0], kv[0], np.where(ts >= kt[-1], kv[-1], v))


def event_times(p: dict) -> np.ndarray:
    """Poisson arrivals at grains_per_sec over the render, from
    rng(seed + 9999), cut to max_grains."""
    if p["event_process"] == "Single" or p["grains_per_sec"] <= 0:
        return np.zeros(1)
    rng = np.random.default_rng(int(p["seed"]) + 9999)
    times, t, dur = [], 0.0, float(p["out_dur_s"])
    while t < dur:
        t += rng.exponential(1.0 / float(p["grains_per_sec"]))
        if t < dur:
            times.append(t)
    return np.asarray(times, np.float64)[: int(p["max_grains"])]


def build_events(p: dict) -> dict:
    """The kept events: seed, n, design rate, amp, offset, start, design
    cutoff and stretch, with rng(seed + 123456) drawn as the reference
    app draws it (an amp a time, then a kept event's offset)."""
    sr = int(p["base_sr"])
    out_n = int(max(1, round(float(p["out_dur_s"]) * sr)))
    rate = float(p["grains_per_sec"])
    times = event_times(p)
    T = times.size
    ufac = np.maximum(1.0, eval_breakpoints(
        parse_breakpoints(p["bp_unfold"]), times,
        max(1.0, float(p["time_unfold"]))))
    dens = eval_breakpoints(parse_breakpoints(p["bp_density"]), times, rate)
    cutoff = eval_breakpoints(parse_breakpoints(p["bp_cutoff"]), times,
                              float(p["bandlimit_out_hz"]))
    stretch = eval_breakpoints(parse_breakpoints(p["bp_stretch"]), times,
                               float(p["partial_stretch"]))
    gsr = np.clip(np.rint(sr * ufac).astype(np.int64), sr, MAX_GEN_SR)
    n = np.maximum(_MODES[p["gen_mode"]],
                   np.rint(gsr * float(p["micro_ms"]) / 1000.0)
                   .astype(np.int64))
    start = np.rint(times * sr).astype(np.int64)
    keep = start < out_n
    amp = (np.clip(dens / max(1e-6, rate), 0.15, 4.0) if rate > 0
           else np.ones(T))
    rng = np.random.default_rng(int(p["seed"]) + 123456)
    lo, hi = 1.0 - float(p["grain_amp_rand"]), 1.0 + float(p["grain_amp_rand"])
    max_off = (int(round(float(p["grain_offset_max_ms"]) / 1000.0 * sr))
               if p["grain_offset_on"] else 0)
    amp_u, off = np.empty(T), np.zeros(T, np.int64)
    for i in range(T):
        amp_u[i] = rng.uniform(lo, hi)
        if max_off > 0 and keep[i]:
            off[i] = rng.integers(0, max(1, min(max_off, int(n[i]))))
    k = np.flatnonzero(keep)
    return {"out_n": out_n, "seed": int(p["seed"]) + k, "n": n[k],
            "gen_sr": gsr[k].astype(np.float32).astype(np.float64),
            "amp": (amp * amp_u)[k].astype(np.float32).astype(np.float64),
            "offset": off[k], "start": start[k],
            "cutoff": (cutoff * ufac)[k].astype(np.float32)
            .astype(np.float64),
            "stretch": stretch[k].astype(np.float32).astype(np.float64)}


def _noise_burst(p, seed, n, gsr):
    """Tilted Gaussian noise drawn as its spectrum on the n-point bin grid,
    under an exponential decay and a 1% edge fade; [B, n]."""
    nf = n // 2 + 1
    k = np.arange(nf)
    wr = normal(seed[:, None], k[None], STREAM_MAIN).astype(np.float64)
    wi = normal(seed[:, None], k[None], STREAM_TILT_IM).astype(np.float64)
    alpha = np.log2(10.0 ** (float(p["noise_tilt"]) / 20.0))
    kk = k.astype(np.float64)
    kk[0] = 1.0
    g = kk ** alpha * np.sqrt(0.5 * n)
    y = np.fft.irfft((wr + 1j * wi) * g, n=n)
    i = np.arange(n)
    tau = max(1e-6, float(p["micro_ms"]) / 1000.0 * 0.25)
    x = y * np.exp(-(i[None] / gsr[:, None]) / tau)
    fade = max(8, int(0.01 * n))
    w = np.where(i < fade, i / fade, 1.0)
    w = np.where(i >= n - fade, (n - i) / fade, w)
    return x * w


def _stick_slip(p, seed, n):
    """The stick-slip recurrence, every op rounded once in f32 (a chaotic
    map: its decisions follow the f32 trajectory), under a Hann window;
    [B, n]."""
    f32 = np.float32
    thr, build, decay, nz = (f32(p[k]) for k in ("ss_threshold", "ss_build",
                                                  "ss_decay", "ss_noise"))
    i = np.arange(n)
    bn = normal(seed[:, None], i[None], STREAM_BUILD).T.copy()
    on = normal(seed[:, None], i[None], STREAM_OUT).T.copy()
    B = seed.size
    xs = np.empty((n, B), np.float32)
    sticking = np.ones(B, bool)
    force = np.zeros(B, np.float32)
    c02, c025, c002 = f32(0.2), f32(0.25), f32(0.02)
    for t in range(n):
        f_stick = force + build * (bn[t] * nz + c02)
        out_slip = force + c025 * on[t]
        f_slip = force * decay
        back = np.abs(f_slip) < c002
        f_slip = np.where(back, f32(0.0), f_slip)
        xs[t] = np.where(sticking, f32(0.0), out_slip)
        force = np.where(sticking, f_stick, f_slip)
        sticking = np.where(sticking, np.abs(f_stick) <= thr, back)
    nf = max(1.0, n - 1.0)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / nf)
    return xs.T.astype(np.float64) * hann


def _lowpass_gain(n, gsr, cutoff, roll):
    """The band limit on the n-point bin grid, a cosine roll of ``roll``
    Hz above the cutoff; [B, nf]."""
    nyq = 0.5 * gsr[:, None]
    c = np.minimum(np.maximum(cutoff[:, None], 1.0), nyq)
    f = np.arange(n // 2 + 1)[None] * (gsr[:, None] / n)
    if roll <= 0:
        return np.where(f > c, 0.0, 1.0)
    f1 = np.minimum(nyq, c + roll)
    t = np.clip((f - c) / np.maximum(1e-12, f1 - c), 0.0, 1.0)
    w = 0.5 * (1.0 + np.cos(np.pi * t))
    return np.where(f > f1, 0.0, np.where(f >= c, w, 1.0))


def _stretch(X, stretch):
    """Each row's spectrum read at bins k / stretch, linearly, zero
    outside (identity where the stretch is 1)."""
    nf = X.shape[1]
    k = np.arange(nf, dtype=np.float64)
    out = X.copy()
    for b in range(X.shape[0]):
        if abs(stretch[b] - 1.0) >= 1e-9:
            pos = k / max(1e-12, stretch[b])
            out[b] = (np.interp(pos, k, X[b].real, left=0.0, right=0.0)
                      + 1j * np.interp(pos, k, X[b].imag, left=0.0,
                                       right=0.0))
    return out


def grains(p: dict, ev: dict, q=exact, block: int = 64):
    """Yield (event indices, grains [B, n]) after the spectral chain."""
    n = int(ev["n"][0])
    if np.any(ev["n"] != n) or n < 16:
        raise NotImplementedError("only one true grain length of 16 or more")
    for s in range(0, ev["n"].size, block):
        sl = slice(s, s + block)
        seed, gsr = ev["seed"][sl], ev["gen_sr"][sl]
        if p["gen_mode"] == "Noise burst":
            x = _noise_burst(p, seed, n, gsr)
        else:
            x = _stick_slip(p, seed, n)
        X = np.fft.rfft(q(x), axis=1)
        X = X * _lowpass_gain(n, gsr, ev["cutoff"][sl],
                              max(float(p["bandlimit_roll_hz"]), 0.0))
        X = _stretch(q(X), ev["stretch"][sl])
        yield np.arange(s, min(s + block, ev["n"].size)), \
            q(np.fft.irfft(X, n=n, axis=1))


def make_adsr(n, sr, a_ms, d_ms, s, r_ms, curve):
    A = max(0, int(round(sr * a_ms / 1000.0)))
    D = max(0, int(round(sr * d_ms / 1000.0)))
    R = max(0, int(round(sr * r_ms / 1000.0)))
    s = float(np.clip(s, 0, 1))
    curve = max(1e-6, float(curve))
    env = np.ones(n)
    i = 0
    if A > 0:
        env[:A] = (np.arange(min(A, n)) / A) ** curve
        i = A
    j = min(n, i + D)
    if D > 0 and j > i:
        env[i:j] = 1.0 - (1.0 - s) * ((np.arange(j - i) / (j - i)) ** curve)
    sus_end = max(j, n - R)
    env[j:sus_end] = s
    if R > 0 and n > sus_end:
        env[sus_end:] = s * (1.0 - np.linspace(0, 1, n - sus_end) ** curve)
    return env


def er_tap_kernel(taps, max_ms, sr, seed):
    """The reflection cloud: taps at U(0.3, max_ms) ms with gains
    U(-1, 1) e^(-42 d) from rng(seed + 202), and the dry tap at 0."""
    rng = np.random.default_rng(int(seed) + 202)
    delays = rng.uniform(0.3, max_ms, size=int(max(1, taps))) / 1000.0
    gains = rng.uniform(-1.0, 1.0, size=delays.size) * np.exp(-delays * 42.0)
    k = np.zeros(int(round(max_ms / 1000.0 * sr)) + 2)
    k[0] = 1.0
    for d, g in zip(delays, gains):
        off = int(round(d * sr))
        if 0 < off < len(k):
            k[off] += g
    return k.astype(np.float32).astype(np.float64)


def convolve_head(x, k):
    """The first len(x) samples of the full convolution x * k, by FFT."""
    n = x.size + k.size - 1
    nfft = 1 << (n - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(k, nfft),
                        nfft)[: x.size]


def fx(p: dict, out, ir, q=exact):
    """ADSR, ER cloud, IR, stereo diffusion, soft clip, normalize; [N, 2]."""
    sr, n = int(p["base_sr"]), out.size
    out = q(out * make_adsr(n, sr, p["env_a"], p["env_d"], p["env_s"],
                            p["env_r"], p["env_curve"]))
    if p["er_cloud_on"]:
        out = q(convolve_head(out, er_tap_kernel(
            p["er_taps"], p["er_max_ms"], sr, p["seed"])))
    if p["space_ir_on"] and ir is not None:
        irm = np.asarray(ir, np.float64)
        irm = irm.mean(axis=1) if irm.ndim > 1 else irm
        irm = irm[: int(p["space_ir_max_samps"])][:8192]
        if irm.size >= 8:
            out = q(convolve_head(out, irm.astype(np.float32)
                                  .astype(np.float64)))
    if p["stereo_on"] and n >= 64:
        width = float(np.clip(p["stereo_width"], 0.0, 1.0))
        dl = int(round((1 + 7 * width) * 0.0005 * sr))
        dr = int(round((1 + 9 * width) * 0.0007 * sr))
        right = np.roll(out, -dr)
        X = np.fft.rfft(right)
        k = np.arange(X.size)
        rot = np.exp(1j * width * 0.9 * np.sin(2 * np.pi * k / (X.size - 1)))
        st = np.column_stack([np.roll(out, dl), np.fft.irfft(X * rot, n=n)])
    else:
        st = np.column_stack([out, out])
    st = q(st)
    if p["sat_drive"] > 0:
        st = q(np.tanh(st * p["sat_drive"]) / np.tanh(p["sat_drive"]))
    m = np.max(np.abs(st))
    return q(st * (p["peak"] / m)) if m > 0 else st


def render(p: dict, ir=None, q=exact) -> np.ndarray:
    """The render as int16 PCM [out_n, 2]."""
    _supported(p)
    ev = build_events(p)
    out_n = ev["out_n"]
    out = np.zeros(out_n)
    if ev["n"].size:
        n = int(ev["n"][0])
        for idx, g in grains(p, ev, q):
            for b, e in enumerate(idx):
                off, st = int(ev["offset"][e]), int(ev["start"][e])
                lim = min(out_n - st, n - off)
                if lim > 0:
                    out[st:st + lim] += ev["amp"][e] * g[b, off:off + lim]
    return pcm16(fx(p, q(out), ir, q))

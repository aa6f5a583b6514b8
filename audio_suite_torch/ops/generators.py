"""Microsound micro-event generators — port of
audio_suite_tpu/ops/generators.py, every mode.

Every function renders a batch of events over the padded index grid
``i`` (int64 [L]); per-event values (``n``, ``seed``, ...) are tensors of
shape [E] (or [E, K] for per-event tables) and broadcast against it as
[E, 1].  Scalars that the JAX package rounds to f32 are rounded to f32 on
the host here, so each op rounds once, as there.

The per-sample recurrences (stick-slip, micro-chaos, the waveguide's delay
lines) are ``lax.scan``s in the JAX package.  Here each has a plain
PyTorch version, a loop over t on [E] tensors (``*_scan_plain``), and a
dispatcher (``*_scan``) that runs the plain version for tensors on the CPU
and the hand-written CUDA kernel (``kernels/grain_scan.cu``) for tensors on
the card; both round every op once, so they are bit-equal.  Stick-slip's
dispatcher is ``stick_slip_noise_scan``, whose kernel also draws the
recurrence's two counter-noise rows itself, bit-equal to ``noise.normal``;
its plain version draws the rows and runs ``stick_slip_scan_plain``.

Scatter-adds whose targets can repeat (crackle's spikes) add in a fixed
order, one scatter per rank of a repeated target (``ordered_scatter_add``),
so the card gives the same sum on every run; the FIR smears are shifted
adds, never cuDNN (which may run f32 convolutions in TF32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from . import detmath, exact_dft, noise

# noise stream ids (framework-defined, shared with the JAX package)
STREAM_MAIN = 0
STREAM_EXC = 1
STREAM_BUILD = 2
STREAM_OUT = 3
STREAM_GATE = 4
STREAM_TILT_IM = 5   # imaginary component of the drawn tilt-noise spectrum

NOISE_BURST = 2      # index of "Noise burst" in GEN_MODES

_TWO_PI32 = float(np.float32(2.0 * np.pi))


def _f32(v) -> float:
    """A host scalar rounded to f32, as a Python float (an f32 tensor meets
    it as an f32 operand, exactly)."""
    return float(np.float32(v))


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-event [E] tensor as [E, 1]; an [E, 1] or 0-d one unchanged."""
    return v[:, None] if v.dim() == 1 else v


def hann_t(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """hann(n) over the padded indices (generators.py:34); n: [E, 1]."""
    nf = torch.clamp_min(n - 1, 1).to(torch.float32)
    w = 0.5 - 0.5 * detmath.rounded(torch.cos,
                                    _TWO_PI32 * i.to(torch.float32) / nf)
    return torch.where(n <= 1, 1.0, w)


def edge_fade(i: torch.Tensor, n: torch.Tensor, frac: float = 0.01,
              min_fade: int = 8) -> torch.Tensor:
    """gen_basic's 1% edge fade (generators.py:42)."""
    fade = torch.clamp_min((frac * n.to(torch.float32)).to(torch.int64),
                           min_fade)
    ff = fade.to(torch.float32)
    up = i.to(torch.float32) / ff
    down = (n - i).to(torch.float32) / ff
    w = torch.where(i < fade, up, torch.ones_like(up))
    return torch.where(i >= n - fade, down, w)


def exp_kernel(K: int, end: float) -> np.ndarray:
    """exp(-linspace(0, end, K)) as a host f32 array (generators.py:72)."""
    return np.exp(-np.linspace(0.0, end, K)).astype(np.float32)


def exp_kernel_t(K: int, klen: torch.Tensor, end: float) -> torch.Tensor:
    """exp(-linspace(0, end, klen)) per event in K slots, zero beyond klen
    (generators.py:77); klen: [E] -> [E, K]."""
    klen = _col(klen)
    j = torch.arange(K, dtype=torch.float32, device=klen.device)
    step = _f32(end) / torch.clamp_min(klen - 1, 1).to(torch.float32)
    k = detmath.rounded(torch.exp, -j * step)
    return torch.where(torch.arange(K, device=klen.device) < klen, k, 0.0)


def masked_conv_same(x: torch.Tensor, kernel, klen) -> torch.Tensor:
    """np.convolve(x, kernel[:klen], mode='same') for each row of x [E, L]
    (generators.py:56): ``kernel`` is [K] (host array or tensor) or
    per-event [E, K] zero beyond klen; ``klen`` an int or per-event [E].

    Shifted adds, one per tap in tap order, instead of a convolution: on
    the card ``F.conv1d`` goes through cuDNN, which may use TF32 for f32
    (the twin of the bf16 trap the JAX package avoids with
    Precision.HIGHEST)."""
    E, L = x.shape
    k = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    K = k.shape[-1]
    k = k.expand(E, K)
    xp = F.pad(x, (K, K))
    if isinstance(klen, int):
        start = (klen - 1) // 2
        taps = (xp[:, K + start - t: K + start - t + L] for t in range(K))
    else:
        start = _col((klen.to(torch.int64) - 1) // 2)
        base = torch.arange(L, device=x.device) + K + start
        taps = (torch.gather(xp, 1, base - t) for t in range(K))
    out = None
    for t, xs in enumerate(taps):
        term = k[:, t:t + 1] * xs
        out = term if out is None else out + term
    return out


def ordered_scatter_add(base: torch.Tensor, idx: torch.Tensor,
                        val: torch.Tensor, rank: torch.Tensor,
                        passes: int) -> torch.Tensor:
    """``base[e, idx[e, m]] += val[e, m]`` in m order, in place, where
    ``rank[e, m]`` counts the earlier m' with the same target and every
    rank is below ``passes``.  Targets are unique within one rank, so each
    of the ``passes`` scatters meets no repeated target: the sum has the
    sequential loop's order on every device and every run.  The last
    column of ``base`` takes what is dropped (it must be passed zeros).
    ``base`` is real [E, N] (or [E, N, 2], a complex view)."""
    drop = base.shape[1] - 1
    if base.dim() == 3:
        idx = idx[..., None].expand(*idx.shape, 2)
        rank = rank[..., None].expand(*rank.shape, 2)
    for r in range(passes):
        sel = rank == r
        base.scatter_add_(1, torch.where(sel, idx, drop),
                          torch.where(sel, val, 0.0))
    return base


def _tilted_noise(n: torch.Tensor, seed: torch.Tensor, tilt_db_per_oct: float,
                  L: int, n_fft: int) -> torch.Tensor:
    """Spectrally tilted Gaussian noise (generators.py:86): the spectrum of
    n_fft white Gaussian samples is drawn directly from counter noise on
    the exact bin grid, tilted, and inverted at exactly n_fft; zero-padded
    to L.  n, seed: [E, 1]."""
    nf = n_fft // 2 + 1
    k = torch.arange(nf, dtype=torch.int64, device=n.device)
    wr = noise.normal(seed, k, STREAM_MAIN)
    wi = noise.normal(seed, k, STREAM_TILT_IM)
    r = k.to(torch.float32)
    r[0] = 1.0
    tilt = torch.tensor(tilt_db_per_oct, dtype=torch.float32)
    alpha = torch.log2(torch.tensor(10.0, dtype=torch.float32)
                       ** (tilt / 20.0)).to(n.device)
    g = detmath.rounded(torch.pow, r, alpha) \
        * torch.sqrt(0.5 * n.to(torch.float32))
    W = torch.complex(wr * g, wi * g)
    return exact_dft.irfft_n(W, n_fft, out_len=L)


def gen_basic(i: torch.Tensor, n: torch.Tensor, seed: torch.Tensor,
              inv_gen_sr: torch.Tensor, micro_ms: float, mode_id: int,
              noise_tilt: float, n_fft: int, *, dust_pos=None, dust_amp=None,
              dust_k=None, dust_klen=None, dust_kmax: int = 8,
              ring_hz: float = 4200.0, ring_decay_ms: float = 12.0
              ) -> torch.Tensor:
    """gen_basic (generators.py:120): mode 0 Gaussian click, 1 dust
    impulses (``dust_*``: the host-drawn positions [E, S], amps [E, S],
    counts [E] and smear lengths [E]), 2 noise burst, 3 skewed transient,
    4 resonant strike, any other the default noise; edge-faded, zero
    beyond n.  ``n_fft`` is the tilted noise's transform length (the true
    grain length, or L for mixed lengths).

    i: int64 [L]; n, seed: int [E]; inv_gen_sr: f32 [E].  Returns f32 [E, L].
    """
    L = i.shape[0]
    n = _col(n.to(torch.int64))
    seed = _col(seed)
    fi = i.to(torch.float32)
    # t by the host-computed reciprocal, as the JAX package does: a
    # vectorized divide may round differently from IEEE division
    t = fi * _col(inv_gen_sr.to(torch.float32))
    micro_s = np.float32(micro_ms) / np.float32(1000.0)

    if mode_id == 0:        # Gaussian click
        sigma = torch.clamp_min((0.0025 * n.to(torch.float32))
                                .to(torch.int64), 1).to(torch.float32)
        q = fi / sigma
        g = detmath.rounded(torch.exp, -0.5 * (q * q))
        x = g * (noise.normal(seed, i, STREAM_MAIN) * 0.12 + 1.0)
    elif mode_id == 1:      # dust impulses -> exp-kernel smear
        valid = torch.arange(dust_pos.shape[-1], device=i.device) \
            < _col(dust_k)
        imp = torch.zeros(n.shape[0], L + 1, dtype=torch.float32,
                          device=i.device)
        # the host draw keeps one amp per position: no repeated target
        imp.scatter_add_(1, torch.where(valid, dust_pos.to(torch.int64), L),
                         torch.where(valid, dust_amp, 0.0))
        x = masked_conv_same(imp[:, :L],
                             exp_kernel_t(dust_kmax, dust_klen, 6.0),
                             dust_klen)
    elif mode_id in (2, 3):
        tn = _tilted_noise(n, seed, noise_tilt, L, n_fft)
        if mode_id == 2:    # noise burst
            tau = _f32(max(np.float32(1e-6), micro_s * np.float32(0.25)))
            x = tn * detmath.rounded(torch.exp, -t / tau)
        else:               # skewed transient
            w3 = torch.clamp_min(tn, 0.0)
            d3 = torch.diff(w3, dim=-1, prepend=w3[:, :1])
            tau = _f32(max(np.float32(1e-6), micro_s * np.float32(0.2)))
            x = d3 * detmath.rounded(torch.exp, -t / tau)
    elif mode_id == 4:      # resonant strike
        f4 = _f32(max(np.float32(10.0), np.float32(ring_hz)))
        tau4 = _f32(max(np.float32(1e-6),
                        np.float32(ring_decay_ms) / np.float32(1000.0)))
        s4 = detmath.sin_cycles(f4 * t) * detmath.rounded(torch.exp,
                                                          -t / tau4)
        tau_x = _f32(max(np.float32(1e-6), micro_s * np.float32(0.15)))
        exc = noise.normal(seed, i, STREAM_EXC) \
            * detmath.rounded(torch.exp, -t / tau_x)
        x = 0.9 * s4 + 0.25 * exc
    else:                   # default noise
        x = noise.normal(seed, i, STREAM_MAIN) * 0.1
    x = x * edge_fade(i, n)
    return torch.where(i < n, x, 0.0)


def crackle_passes(spike_pos: np.ndarray, n: np.ndarray) -> int:
    """Host: the most spikes that share one sample in any event (at least
    1), counting spikes below n only — the number of scatters
    ``gen_crackle`` needs.  Positions are a truncated cumsum of Pareto
    steps, which can be below 1, so spikes can repeat a sample."""
    best = 1
    for row, m in zip(np.asarray(spike_pos), np.asarray(n)):
        row = row[row < m]
        if row.size:
            best = max(best, int(np.unique(row, return_counts=True)[1]
                                 .max()))
    return best


def gen_crackle(i: torch.Tensor, n: torch.Tensor, spike_pos: torch.Tensor,
                spike_amp: torch.Tensor, kernel, klen: int,
                passes: int) -> torch.Tensor:
    """Pareto-interval crackle (generators.py:176): host-drawn spike
    positions [E, S] (ascending per event, padded with L) and amps, added
    into an impulse train in spike order, then smeared by ``kernel``.
    ``passes`` bounds the spikes that share one sample
    (``crackle_passes``)."""
    L = i.shape[0]
    n = _col(n.to(torch.int64))
    pos = spike_pos.to(torch.int64)
    valid = pos < n
    # rank among equal positions: they are adjacent in an ascending row
    j = torch.arange(pos.shape[-1], device=i.device).expand_as(pos)
    first = torch.ones_like(valid)
    first[:, 1:] = pos[:, 1:] != pos[:, :-1]
    rank = j - torch.cummax(torch.where(first, j, 0), dim=-1).values
    imp = torch.zeros(n.shape[0], L + 1, dtype=torch.float32,
                      device=i.device)
    ordered_scatter_add(imp, torch.where(valid, pos, L),
                        torch.where(valid, spike_amp, 0.0), rank, passes)
    y = masked_conv_same(imp[:, :L], kernel, klen)
    return torch.where(i < n, y, 0.0)


# ---------------------------------------------------------------------------
# Per-sample recurrences: plain versions and their dispatchers
# ---------------------------------------------------------------------------

def stick_slip_scan_plain(bn: torch.Tensor, on: torch.Tensor, threshold,
                          build, decay, noise_amt) -> torch.Tensor:
    """The stick-slip recurrence (generators.py:194-206) over t, for every
    event at once: bn, on f32 [E, L] -> xs f32 [E, L].  Each op rounds
    once (the JAX scan's order; jitted XLA may contract its multiply-adds,
    this loop does not)."""
    thr, build, decay, nz = (_f32(v) for v in (threshold, build, decay,
                                               noise_amt))
    E, L = bn.shape
    xs = torch.empty_like(bn)
    sticking = torch.ones(E, dtype=torch.bool, device=bn.device)
    force = torch.zeros(E, dtype=torch.float32, device=bn.device)
    for t in range(L):
        force_stick = force + build * (bn[:, t] * nz + 0.2)
        new_sticking_s = torch.abs(force_stick) <= thr
        out_slip = force + 0.25 * on[:, t]
        force_slip = force * decay
        back = torch.abs(force_slip) < 0.02
        force_slip = torch.where(back, 0.0, force_slip)
        xs[:, t] = torch.where(sticking, 0.0, out_slip)
        force = torch.where(sticking, force_stick, force_slip)
        sticking = torch.where(sticking, new_sticking_s, back)
    return xs


def stick_slip_noise_scan_plain(seed: torch.Tensor, L: int, threshold,
                                build, decay, noise_amt) -> torch.Tensor:
    """The stick-slip recurrence over its own counter noise: the rows
    ``noise.normal(seed, t, STREAM_BUILD)`` and ``(..., STREAM_OUT)`` for t
    in [0, L), then ``stick_slip_scan_plain``; seed [E] -> xs f32 [E, L]."""
    i = torch.arange(L, device=seed.device)
    seed = seed.reshape(-1, 1)
    return stick_slip_scan_plain(noise.normal(seed, i, STREAM_BUILD),
                                 noise.normal(seed, i, STREAM_OUT),
                                 threshold, build, decay, noise_amt)


def chaos_scan_plain(gates: torch.Tensor, y0: torch.Tensor, r,
                     gate) -> torch.Tensor:
    """The gated logistic map (generators.py:223-229) over t, for every
    event at once: gates f32 [E, L], y0 f32 [E] -> xs f32 [E, L]."""
    r, gate = _f32(r), _f32(gate)
    xs = torch.empty_like(gates)
    y = y0.to(torch.float32)
    for t in range(gates.shape[1]):
        y = r * y * (1.0 - y)
        xs[:, t] = torch.where(gates[:, t] < gate, y - 0.5, 0.0)
    return xs


def waveguide_scan_plain(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                         mix: torch.Tensor) -> torch.Tensor:
    """The waveguide's feedback delay lines (generators.py:308-322), in
    line order, each from a zeroed ring buffer, for every event at once:
    x f32 [E, L], d int [E, lines], g and mix f32 [E, lines] -> y [E, L].
    The write pointer wraps at d (a d of 0 acts as 1), so it stays below
    min(d, L)."""
    E, L = x.shape
    rows = torch.arange(E, device=x.device)
    y = x
    for ln in range(d.shape[1]):
        dl, gl, ml = d[:, ln].to(torch.int64), g[:, ln], mix[:, ln]
        keep = 1.0 - ml
        buf = torch.zeros(E, max(1, L), dtype=torch.float32, device=x.device)
        wp = torch.zeros(E, dtype=torch.int64, device=x.device)
        out = torch.empty_like(x)
        for t in range(L):
            yt = y[:, t]
            v = yt + gl * buf[rows, wp]
            buf[rows, wp] = v
            wp = torch.where(wp + 1 >= dl, 0, wp + 1)
            out[:, t] = keep * yt + ml * v
        y = out
    return y


def stick_slip_noise_scan(seed, L, threshold, build, decay, noise_amt):
    """``stick_slip_noise_scan_plain`` for a seed tensor on the CPU; on the
    card the ``grain_scan.cu`` kernel, which draws both noise rows itself
    (a failed build or launch raises)."""
    if seed.device.type == "cpu":
        return stick_slip_noise_scan_plain(seed, L, threshold, build, decay,
                                           noise_amt)
    return kernels.stick_slip_noise_scan(
        seed.reshape(-1).to(torch.int32).contiguous(), L, _f32(threshold),
        _f32(build), _f32(decay), _f32(noise_amt),
        (STREAM_BUILD, STREAM_OUT))


def chaos_scan(gates, y0, r, gate):
    """``chaos_scan_plain`` for CPU tensors; on the card the
    ``grain_scan.cu`` kernel."""
    if gates.device.type == "cpu":
        return chaos_scan_plain(gates, y0, r, gate)
    return kernels.chaos_scan(gates, y0, _f32(r), _f32(gate))


def waveguide_scan(x, d, g, mix):
    """``waveguide_scan_plain`` for CPU tensors; on the card the
    ``grain_scan.cu`` kernel."""
    if x.device.type == "cpu":
        return waveguide_scan_plain(x, d, g, mix)
    return kernels.waveguide_scan(x, d, g, mix)


# ---------------------------------------------------------------------------
# Scan modes, atoms and fragments
# ---------------------------------------------------------------------------

def gen_stick_slip(i: torch.Tensor, n: torch.Tensor, seed: torch.Tensor,
                   threshold, build, decay, noise_amt) -> torch.Tensor:
    """Stateful stick-slip friction (generators.py:188): the recurrence
    over counter noise, under a Hann window, zero beyond n.  ``i`` is the
    padded index grid ``arange(L)``, as its one caller
    (``models/microsound.py:_generate``) passes it: the noise is drawn at
    t in [0, L), on the card inside the kernel
    (``stick_slip_noise_scan``)."""
    n = _col(n.to(torch.int64))
    xs = stick_slip_noise_scan(seed, i.shape[-1], threshold, build, decay,
                               noise_amt)
    return torch.where(i < n, xs * hann_t(i, n), 0.0)


def chaos_y0(seed: torch.Tensor) -> torch.Tensor:
    """The logistic map's start, (seed % 10000) / 10000 by the reciprocal
    multiply (generators.py:220): a 1-ulp change of a chaotic map's seed
    diverges."""
    return (seed % 10000).to(torch.float32) * _f32(1.0 / 10000.0)


def gen_micro_chaos(i: torch.Tensor, n: torch.Tensor, seed: torch.Tensor, r,
                    gate, chaos_kernel) -> torch.Tensor:
    """Gated logistic map (generators.py:214) + exp smear + Hann."""
    n = _col(n.to(torch.int64))
    gates = noise.uniform(_col(seed), i, STREAM_GATE)
    xs = chaos_scan(gates, chaos_y0(seed.reshape(-1)), r, gate)
    xs = torch.where(i < n, xs, 0.0)   # the reference's buffer ends at n
    x = masked_conv_same(xs, chaos_kernel, int(chaos_kernel.shape[-1]))
    return torch.where(i < n, x * hann_t(i, n), 0.0)


def morlet_atom_t(i: torch.Tensor, n: torch.Tensor, inv_gen_sr, f0, sigma_s,
                  phase_cyc) -> torch.Tensor:
    """Morlet atom over (padded or rolled) indices (generators.py:236), in
    cycles; every argument broadcasts as [E, 1] against i."""
    t = (i.to(torch.float32) - n.to(torch.float32) / 2.0) * inv_gen_sr
    q = t / torch.clamp_min(sigma_s, 1e-9)
    envl = detmath.rounded(torch.exp, -0.5 * (q * q))
    return envl * detmath.cos_cycles(f0 * t + phase_cyc)


def gen_wavelet_atoms(i: torch.Tensor, n: torch.Tensor, inv_gen_sr, f0s,
                      sigma_ss, phase_cycs, shifts, count: int
                      ) -> torch.Tensor:
    """Random Morlet cloud (generators.py:245): per-atom parameters
    [E, A] drawn on the host, each atom rolled by its shift within the
    true length n, weighted 1 / (1 + 0.6 k), under a Hann window."""
    n = _col(n.to(torch.int64))
    inv = _col(inv_gen_sr.to(torch.float32))
    x = torch.zeros(n.shape[0], i.shape[0], dtype=torch.float32,
                    device=i.device)
    for k in range(min(f0s.shape[1], count)):
        # np.roll(atom, shift)[:n]: the atom read at (i - shift) mod n
        src = torch.remainder(i - shifts[:, k:k + 1].to(torch.int64),
                              torch.clamp_min(n, 1))
        atom = morlet_atom_t(src, n, inv, f0s[:, k:k + 1],
                             sigma_ss[:, k:k + 1], phase_cycs[:, k:k + 1])
        gain = _f32(np.float32(1.0) / (np.float32(1.0)
                                       + np.float32(k) * np.float32(0.6)))
        x = x + gain * atom
    return torch.where(i < n, x * hann_t(i, n), 0.0)


def gen_from_fragment(i: torch.Tensor, n: torch.Tensor, frag: torch.Tensor,
                      frag_len: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of each event's host fragment (true length
    frag_len inside frag [E, S]) to its length n (generators.py:265): the
    shared head of the IR-fragment and image-scanline modes."""
    S = frag.shape[-1]
    n = _col(n.to(torch.int64))
    fl = _col(frag_len.to(torch.int64))
    pos = i.to(torch.float32) / torch.clamp_min(n - 1, 1).to(torch.float32) \
        * torch.clamp_min(fl - 1, 1).to(torch.float32)
    i0 = torch.clamp(pos.to(torch.int64), 0, S - 2)
    i0 = torch.minimum(i0, torch.clamp_min(fl - 2, 0))
    fr = pos - i0.to(torch.float32)
    x = torch.gather(frag, 1, i0) * (1.0 - fr) \
        + torch.gather(frag, 1, i0 + 1) * fr
    return torch.where(i < n, x, 0.0)


# ---------------------------------------------------------------------------
# Physical models
# ---------------------------------------------------------------------------

def resonator_bank(x: torch.Tensor, i: torch.Tensor, n: torch.Tensor,
                   inv_gen_sr, freqs, phase_cycs, decay_ms: float,
                   modes: int) -> torch.Tensor:
    """Resonator bank (generators.py:285): host-drawn mode frequencies and
    phases [E, M], weighted 1 / (1 + 0.35 k) under one exp decay,
    peak-normalized over n and mixed in through sign(x)."""
    n = _col(n.to(torch.int64))
    t = i.to(torch.float32) * _col(inv_gen_sr.to(torch.float32))
    tau = _f32(max(np.float32(1e-6),
                   np.float32(decay_ms) / np.float32(1000.0)))
    envl = detmath.rounded(torch.exp, -t / tau)
    out = torch.zeros_like(x)
    for k in range(min(freqs.shape[1], modes)):
        carrier = detmath.sin_cycles(freqs[:, k:k + 1] * t
                                     + phase_cycs[:, k:k + 1])
        gain = _f32(np.float32(1.0) / (np.float32(1.0)
                                       + np.float32(k) * np.float32(0.35)))
        out = out + gain * carrier * envl
    peak = torch.clamp_min(torch.amax(torch.abs(torch.where(i < n, out, 0.0)),
                                      dim=-1, keepdim=True), 1e-12)
    out = out / peak
    y = 0.55 * x + 0.45 * out * torch.sign(x)
    return torch.where(i < n, y, 0.0)


def waveguide_splinters(x: torch.Tensor, n: torch.Tensor, delays, gains,
                        mixes, lines: int, dmax: int) -> torch.Tensor:
    """N feedback delay lines (generators.py:304) through
    ``waveguide_scan``; zero beyond n.  ``dmax`` mirrors the JAX
    signature, where it sizes the ring: here no ring is kept."""
    y = waveguide_scan(x, delays[:, :lines].contiguous(),
                       gains[:, :lines].contiguous(),
                       mixes[:, :lines].contiguous())
    return torch.where(torch.arange(x.shape[1], device=x.device)
                       < _col(n.to(torch.int64)), y, 0.0)

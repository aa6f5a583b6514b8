"""FM / PSG voices — port of audio_suite_tpu/ops/synth.py (pattern lab
0.1/app/synth_fm.py, a 4-operator phase-modulation voice with feedback and
vibrato, and app/synth_psg.py, a duty square or 15-bit LFSR noise).

The JAX package vmaps one note over padded sample indices; here the notes
of a bucket are a batch axis: per-note scalars are [B, 1] tensors and
per-operator values [B, 4], against the sample indices ``i`` int32 [L], so
a voice returns [B, L] (a single note may pass [1] and [4] and get [L]).

Every op is one eager PyTorch kernel with one IEEE rounding, in the JAX
package's order: ``t`` is a reciprocal multiply, the phase-modulation and
feedback products take ``round_sig12`` operands, the vibrato uses the
precise twins, and the envelope takes host reciprocals.  A last-ulp
difference upstream of the 14-bit DAC quantizer would flip a whole
quantization step (about -78 dBFS).

On a CUDA device a bucket of the render's voice bank runs in
``kernels/voice_bank.cu`` instead (``fm_bank_fused``, ``psg_bank_fused``;
one launch, a few passes more for a lowpass too long for an FIR), which
computes the same ops with the same roundings; ``bank_fused`` says where
it runs.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from . import detmath
from .envelopes import adsr_clamped, adsr_from_consts, micro_fade_gain
from .fixq import round_sig12, sig12_pair_np


def _f32(x) -> float:
    """A host constant rounded to f32, as a Python float (a Python scalar
    meets an f32 tensor as that f32 value)."""
    return float(np.float32(x))


# ----------------------------------------------------------------------------
# Quantizer (app/music.py:89-94)
# ----------------------------------------------------------------------------

def quantize_to_bits(x, levels_minus_1, inv_levels_m1):
    """Symmetric bit quantization; levels_minus_1 = 2**(bits-1) - 1 (f32),
    the downscale a multiply by its host f32 reciprocal
    (``utils.music.quantize_to_bits_f32_np`` is the NumPy twin)."""
    y = torch.clamp(x, -1.0, 1.0)
    return torch.round(y * levels_minus_1) * inv_levels_m1


# ----------------------------------------------------------------------------
# One-pole lowpass
# ----------------------------------------------------------------------------

def _fir_len(a: float) -> int:
    """Taps K of the truncated impulse response (1-a)*a**k: the first k
    with a**k < 2**-31, at most ``kernels.VOICE_BANK_MAX_TAPS`` (64), where
    the filter runs as the doubling scan instead."""
    K, p = 1, a
    while p >= 2.0 ** -31 and K < kernels.VOICE_BANK_MAX_TAPS:
        p *= a
        K += 1
    return K


def fir_weights(a) -> np.ndarray:
    """The truncated FIR's f32 weights (1-a)*a**k of the f32 ``a``, from
    float64."""
    af = _f32(a)
    return ((1.0 - np.float64(af)) * np.float64(af)
            ** np.arange(_fir_len(af))).astype(np.float32)


def one_pole_lp(x: torch.Tensor, a) -> torch.Tensor:
    """y[t] = a*y[t-1] + (1-a)*x[t], y[-1] = 0, along the last axis
    (synth.py:48).  ``a`` is a host number.  For the synth's cutoffs
    (a <= ~0.19) the impulse response falls below one f32 ulp within ~13
    taps, so the IIR runs as a truncated FIR of K shifted adds with
    weights from float64, as in the JAX package; a coefficient too close
    to 1 for that (K would reach 64) runs a log-depth scan."""
    af = _f32(a)
    if _fir_len(af) >= kernels.VOICE_BANK_MAX_TAPS:
        return _one_pole_scan(x, af)
    w = fir_weights(af)
    y = float(w[0]) * x
    for k in range(1, len(w)):
        xk = F.pad(x, (k, 0))[..., :-k]
        y = y + float(w[k]) * xk
    return y


def _one_pole_scan(x: torch.Tensor, af: float) -> torch.Tensor:
    """The recurrence as an inclusive scan of (A, b) pairs with
    combine(l, r) = (A_l*A_r, A_r*b_l + b_r), in log2(L) doubling steps
    (the JAX package runs ``lax.associative_scan``, whose association
    differs: the two agree to output ulps)."""
    b = _f32(np.float32(1.0) - np.float32(af)) * x
    A = torch.full_like(x, af)
    L = x.shape[-1]
    d = 1
    while d < L:
        b = torch.cat([b[..., :d], A[..., d:] * b[..., :-d] + b[..., d:]],
                      dim=-1)
        A = torch.cat([A[..., :d], A[..., :-d] * A[..., d:]], dim=-1)
        d *= 2
    return b


# ----------------------------------------------------------------------------
# LFSR noise via orbit tables
# ----------------------------------------------------------------------------

def _lfsr_next(s: int) -> int:
    """synth_psg.py:92-95: bit = (s ^ (s>>1)) & 1; s' = (s>>1) | (bit<<14)."""
    bit = (s ^ (s >> 1)) & 1
    return (s >> 1) | (bit << 14)


@lru_cache(maxsize=1)
def lfsr_tables():
    """The 15-bit LFSR transition (a bijection) split into its orbits, on
    the host (synth.py:102): (orbit_pm1 f32[2**15], base, pos, clen
    int32[2**15]) such that the k-th output sample for seed s is
    orbit_pm1[base[s] + (pos[s] + 1 + k) % clen[s]]."""
    N = 1 << 15
    nxt = np.empty(N, np.int32)
    for s in range(N):
        nxt[s] = _lfsr_next(s)
    visited = np.zeros(N, bool)
    base = np.zeros(N, np.int32)
    pos = np.zeros(N, np.int32)
    clen = np.zeros(N, np.int32)
    flat = []
    for s0 in range(N):
        if visited[s0]:
            continue
        cyc = []
        s = s0
        while not visited[s]:
            visited[s] = True
            cyc.append(s)
            s = nxt[s]
        b = len(flat)
        for p, st in enumerate(cyc):
            base[st] = b
            pos[st] = p
            clen[st] = len(cyc)
        flat.extend(cyc)
    flat = np.asarray(flat, np.int32)
    orbit_pm1 = np.where((flat & 1) != 0, 1.0, -1.0).astype(np.float32)
    return orbit_pm1, base, pos, clen


@lru_cache(maxsize=None)
def _lfsr_tables_on(device: str) -> tuple:
    return tuple(torch.tensor(a, device=device) for a in lfsr_tables())


def lfsr_tables_on(device) -> tuple:
    """``lfsr_tables`` as tensors on ``device``, uploaded once per device."""
    return _lfsr_tables_on(str(torch.device(device)))


def lfsr_noise(i, seed, orbit_pm1, base, pos, clen):
    """±1 noise samples for int32 ``seed`` at indices ``i`` (a gather in
    the orbit tables; the indices are non-negative, so ``%`` is the JAX
    package's ``mod``)."""
    s = (seed & 0x7FFF).long()
    idx = base[s] + (pos[s] + 1 + i) % clen[s]
    return orbit_pm1[idx.long()]


# ----------------------------------------------------------------------------
# PSG voice (synth_psg.py:100-124)
# ----------------------------------------------------------------------------

def psg_note(i, n, hz, vel, duty, use_noise, A, D, R, s, levels_m1,
             inv_levels_m1, fade_samples, lp_a, seed, orbit_pm1, base, pos,
             clen, sr, env_consts=None):
    """PSG notes over padded indices ``i``; zero at and beyond n
    (synth.py:154).  env_consts: optional (n_a, n_d, n_r, inv_na, inv_nd,
    inv_dr, startv), the host envelope constants of ``adsr_from_consts``."""
    if env_consts is not None:
        env = adsr_from_consts(i, n, *env_consts, s)
    else:
        env = adsr_clamped(i, n, A, D, R, s)
    # t by reciprocal multiply and phase by floor-subtract: exact IEEE
    # ops, so the duty-cycle decision never flips
    t = i.to(torch.float32) * _f32(1.0 / float(sr))
    prod = t * hz
    phase = prod - torch.floor(prod)
    square = torch.where(phase < duty, 1.0, -1.0)
    noise = lfsr_noise(i, seed, orbit_pm1, base, pos, clen)
    sig = torch.where(use_noise, noise, square)
    y = sig * env * vel
    y = quantize_to_bits(y, levels_m1, inv_levels_m1)
    y = y * micro_fade_gain(i, n, fade_samples)
    y = one_pole_lp(y, lp_a)
    return torch.where(i < n, y, 0.0)


# ----------------------------------------------------------------------------
# FM voice (synth_fm.py:127-191)
# ----------------------------------------------------------------------------

def fm_note(i, n, f_ops, vel, chan_params, fade_samples, lp_a1, lp_a2,
            dac_levels_m1, inv_dac_levels_m1, sr, alg_static=None,
            vib_static=None):
    """4-operator FM notes over padded indices ``i`` (synth.py:187).

    f_ops: f32 [..., 4] per-op frequencies in Hz; n, vel: [..., 1].
    chan_params: level, index_cyc (PM depth in cycles), s, and A, D, R or
    the host envelope constants env_n_a, env_n_d, env_n_r, env_inv_na,
    env_inv_nd, env_inv_dr, env_startv, all [..., 4]; feedback, lfo_hz,
    lfo_depth and (without ``alg_static``) algorithm, [..., 1].

    alg_static: the algorithm (1, 2 or 3) of every note, so only its
    operator stack runs; None evaluates all three and selects per note.
    vib_static: False skips the vibrato chain, True applies it, None
    selects per note by lfo_depth > 0."""
    cp = chan_params
    t = i.to(torch.float32) * _f32(1.0 / float(sr))

    def op(a, k):
        return a[..., k:k + 1]

    if vib_static is None or vib_static:
        lfo_depth = cp["lfo_depth"]
        # the precise (FMA-safe) twins: the vibrato ratio scales the carrier
        # phase, so an ulp here is amplified by the cycle count
        vib = detmath.sin_cycles_precise(cp["lfo_hz"] * t)
        vib_ratio = detmath.exp2_precise((lfo_depth * vib) * _f32(1.0 / 12.0))
        if vib_static is None:
            has_vib = lfo_depth > 0.0

    def op_sig(k, pm_cyc):
        # carrier cycles, reduced before adding the small PM term
        c = op(f_ops, k) * t
        if vib_static is None:
            c = torch.where(has_vib, c * vib_ratio, c)
        elif vib_static:
            c = c * vib_ratio
        r0 = detmath.frac_signed(c)
        if pm_cyc is not None:
            r0 = r0 + pm_cyc
        sig = detmath.sin_cycles(r0)
        if "env_n_a" in cp:
            env = adsr_from_consts(
                i, n, op(cp["env_n_a"], k), op(cp["env_n_d"], k),
                op(cp["env_n_r"], k), op(cp["env_inv_na"], k),
                op(cp["env_inv_nd"], k), op(cp["env_inv_dr"], k),
                op(cp["env_startv"], k), op(cp["s"], k))
        else:
            env = adsr_clamped(i, n, op(cp["A"], k), op(cp["D"], k),
                               op(cp["R"], k), op(cp["s"], k))
        return sig * env * op(cp["level"], k)

    fb = round_sig12(torch.clamp(cp["feedback"], min=0.0))
    idx = round_sig12(cp["index_cyc"])

    def pm(k, m):
        # exact product (both operands 12-bit significands)
        return op(idx, k) * round_sig12(m)

    # shared by algorithms 1 and 2: op4 with a one-sample feedback delay
    o4 = op_sig(3, None)
    o4fb = o4 + fb * round_sig12(F.pad(o4, (1, 0))[..., :-1])
    o4_eff = torch.where(fb > 0, o4fb, o4)

    def y_alg1():
        # algorithm 1: 4 -> 3 -> 2 -> 1
        o3 = op_sig(2, pm(2, o4_eff))
        o2 = op_sig(1, pm(1, o3))
        return op_sig(0, pm(0, o2))

    def y_alg2():
        # algorithm 2: (4->3) + (2->1), sum * 0.6
        o3 = op_sig(2, pm(2, o4_eff))
        o2 = op_sig(1, None)
        o1 = op_sig(0, pm(0, o2))
        return (o3 + o1) * _f32(0.6)

    def y_alg3():
        # algorithm 3: all carriers * 0.25
        return (op_sig(0, None) + op_sig(1, None) + op_sig(2, None)
                + o4) * 0.25

    if alg_static is not None:
        y = {1: y_alg1, 2: y_alg2, 3: y_alg3}[int(alg_static)]()
    else:
        alg = cp["algorithm"]
        y = torch.where(alg == 1, y_alg1(),
                        torch.where(alg == 2, y_alg2(), y_alg3()))

    y = y * vel
    y = quantize_to_bits(y, dac_levels_m1, inv_dac_levels_m1)
    y = y * micro_fade_gain(i, n, fade_samples)
    y = one_pole_lp(y, lp_a1)
    y = one_pole_lp(y, lp_a2)
    return torch.where(i < n, y, 0.0)


# ----------------------------------------------------------------------------
# The voice bank as one kernel a bucket (kernels/voice_bank.cu)
# ----------------------------------------------------------------------------

# voice_bank.cu's BankConsts, field for field: (name, floats)
BANK_CONSTS = (("sin_c", 5), ("cos_c", 5), ("exp2_c", 7), ("sin4_pair", 2),
               ("cos4_pair", 2), ("exp26_pair", 2), ("inv_sr", 1), ("pi", 1),
               ("inv12", 1), ("alg2_gain", 1), ("dac_m1", 1), ("inv_dac", 1),
               ("w1", kernels.VOICE_BANK_MAX_TAPS - 1),
               ("w2", kernels.VOICE_BANK_MAX_TAPS - 1))


def bank_fused(device) -> bool:
    """Whether a render's voice bank runs in ``voice_bank.cu``: on a CUDA
    device, and there for every bucket; elsewhere op by op."""
    return torch.device(device).type == "cuda"


def _is_fir(a: float) -> bool:
    return _fir_len(a) < kernels.VOICE_BANK_MAX_TAPS


@lru_cache(maxsize=16)
def bank_consts(sr: int, lp_a1: float, lp_a2: float | None = None,
                dac_m1: float = 1.0) -> np.ndarray:
    """The kernel's constants as f32 [sum of BANK_CONSTS]: the detmath
    polynomials and the 12-bit splits of their first Horner constants,
    the voices' scalar constants (the FM's DAC levels ``dac_m1``) and the
    FIR weights of the lowpasses ``lp_a1`` (the PSG's one) and ``lp_a2``,
    zero-padded (all zero for a lowpass that runs as the scan)."""
    def taps(a):
        w = np.zeros(kernels.VOICE_BANK_MAX_TAPS - 1, np.float32)
        if a is not None and _is_fir(a):
            fw = fir_weights(a)
            w[:len(fw)] = fw
        return w

    vals = {"sin_c": detmath._S32, "cos_c": detmath._C32,
            "exp2_c": detmath._E2C,
            "sin4_pair": sig12_pair_np(detmath._S32[4]),
            "cos4_pair": sig12_pair_np(detmath._C32[4]),
            "exp26_pair": sig12_pair_np(detmath._E2C[6]),
            "inv_sr": 1.0 / float(sr), "pi": np.pi, "inv12": 1.0 / 12.0,
            "alg2_gain": 0.6, "dac_m1": dac_m1,
            "inv_dac": np.float32(1.0 / float(dac_m1)),
            "w1": taps(lp_a1), "w2": taps(lp_a2)}
    out = np.concatenate([np.asarray(vals[k], np.float32).reshape(-1)
                          for k, _ in BANK_CONSTS])
    out.flags.writeable = False
    return out


@lru_cache(maxsize=16)
def scan_coefs(af: float) -> np.ndarray:
    """``_one_pole_scan``'s constants of the f32 ``af`` as f32 [32]: 1 - a,
    then the multiplier of each step d = 2**s, s = 0 .. 30: a**d squared
    up in f32, as the scan's A is where i >= d."""
    p = [np.float32(af)]
    for _ in range(30):
        p.append(p[-1] * p[-1])
    out = np.array([np.float32(1.0) - np.float32(af)] + p, np.float32)
    out.flags.writeable = False
    return out


def _lowpass_fused(x, i32, n_total: int, af: float):
    """One lowpass of ``af`` as a pass of its own over a bucket's rows."""
    if _is_fir(af):
        return kernels.voice_bank_fir(x, i32, n_total, fir_weights(af))
    return kernels.voice_bank_scan(x, i32, n_total, scan_coefs(af))


def fm_bank_fused(f32, i32, L: int, n_total: int, alg: int, vib: bool,
                  fade_samples: int, lp_a1, lp_a2, dac_m1, sr):
    """One FM bucket's masked contributions f32 [count, L] from its rows
    of the fm32 / fmi packs (``MegaDriveInspiredSynth.prepare_np``'s
    columns): ``fm_note`` with ``alg_static`` and ``vib_static``, then
    zero from min(n, n_total - start) on.  One launch where both lowpasses
    are FIRs; else the signal, then each lowpass as a pass."""
    a1, a2 = _f32(lp_a1), _f32(lp_a2)
    consts = bank_consts(int(sr), a1, a2, float(dac_m1))
    if _is_fir(a1) and _is_fir(a2):
        return kernels.voice_bank_fm(f32, i32, L, n_total, alg, vib,
                                     fade_samples, _fir_len(a1),
                                     _fir_len(a2), consts)
    x = kernels.voice_bank_fm(f32, i32, L, n_total, alg, vib, fade_samples,
                              0, 0, consts)
    x = _lowpass_fused(x, i32, n_total, a1)
    return _lowpass_fused(x, i32, n_total, a2)


def psg_bank_fused(f32, i32, L: int, n_total: int, fade_samples: int, lp_a,
                   sr, lfsr):
    """One PSG bucket's masked contributions f32 [count, L] from its rows
    of the pg32 / pgi packs and the orbit tables ``lfsr``
    (``lfsr_tables_on``): ``psg_note``, then zero from min(n, n_total -
    start) on.  One launch where the lowpass is an FIR; else the signal,
    then the scan."""
    a = _f32(lp_a)
    consts = bank_consts(int(sr), a)
    if _is_fir(a):
        return kernels.voice_bank_psg(f32, i32, L, n_total, lfsr,
                                      fade_samples, _fir_len(a), consts)
    x = kernels.voice_bank_psg(f32, i32, L, n_total, lfsr, fade_samples, 0,
                               consts)
    return _lowpass_fused(x, i32, n_total, a)

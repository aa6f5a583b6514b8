"""Hand-written CUDA kernels of the port and their loader.

Each ``<name>.cu`` in this directory is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, on first use,
into ``_build/`` beside it (git-ignored), named by a hash of the source and
the flags, and loaded with ``ctypes``.  Nothing is built or loaded at import
time.  A failed build or launch raises: there is no fallback.

Each kernel wrapper checks its tensors with ``_check`` and launches through
``_launch``, which counts the launch in the wrapper's ``launches``
attribute, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..utils.profiling import span

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source on first use")


def _paths(name: str) -> tuple[str, str]:
    """``<name>.cu`` and its library's path, named by a hash of the
    source and the flags."""
    src = os.path.join(KERNEL_DIR, name + ".cu")
    with open(src, "rb") as f:
        code = f.read()
    tag = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(name: str) -> str:
    """Compile ``<name>.cu`` (if not built yet) and return the library's
    path.  The compiler's output is kept in ``_build/<lib>.log``."""
    src, so = _paths(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# C signatures of each library: function -> (argtypes, restype).  Pointers
# and the stream are c_void_p: a plain int argument would be cut to 32 bits.
_P = ctypes.c_void_p
_SIGNATURES = {
    "overlap_add": {
        "oa_launch": ([_P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, _P], ctypes.c_int),
        "oa_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "lerp_read": {
        "lr_launch": ([_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
                      ctypes.c_int),
        "sr_launch": ([_P, ctypes.c_int, _P, _P, _P, ctypes.c_int, _P,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_float, _P],
                      ctypes.c_int),
        "lr_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "grain_scan": {
        "gs_stick_slip_noise": ([_P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_uint32, ctypes.c_uint32, _P],
                                ctypes.c_int),
        "gs_chaos": ([_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, _P], ctypes.c_int),
        "gs_waveguide": ([_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, _P], ctypes.c_int),
        "gs_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "voice_bank": {
        "vb_fm_launch": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                          _P], ctypes.c_int),
        "vb_psg_launch": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P,
                           ctypes.c_int, _P, _P], ctypes.c_int),
        "vb_fir_launch": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P, _P, _P],
                          ctypes.c_int),
        "vb_scan_launch": ([_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                            _P], ctypes.c_int),
        "vb_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "tape_scan": {
        "ts_launch": ([_P, ctypes.c_int, _P, ctypes.c_longlong, _P, _P, _P,
                       _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, _P, ctypes.c_int, _P, _P, _P, _P, _P,
                       _P], ctypes.c_int),
        "ts_scratch_words": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
                             ctypes.c_longlong),
        "ts_tables_launch": ([_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_longlong, _P, _P, _P,
                              ctypes.c_int, ctypes.c_int, _P, _P, _P],
                             ctypes.c_int),
        "ts_tables_scratch_words": ([ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int],
                                    ctypes.c_longlong),
        "ts_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "space_conv": {
        "sc_launch": ([_P, _P, ctypes.c_int, _P, ctypes.c_int, _P,
                       ctypes.c_int, _P], ctypes.c_int),
        "sc_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}
TAPE_SCAN_MAX_TABLE_WORDS = 12288   # tape_scan.cu's kMaxTableWords
TAPE_SCAN_CHUNK = 1024  # tape_scan.cu's steps a chunk: a power of two in
TAPE_SCAN_CHUNKS = (32, 4096)  # this range (kMinChunk, kMaxChunk)
TAPE_SCAN_REC_WORDS = 8  # a chunk's record (kRecWords); bit 0 of word 5:
#                          jumped
TAPE_TABLES_HEAD = 16    # tape_scan.cu's kTabHead: the tables' header words
TAPE_TABLES_TILE = 512   # kTabThreads: the walk's block, a window's round
MAX_HEADS = 3           # scrub_read_kernel's head slots (lerp_read.cu)
VOICE_BANK_MAX_TAPS = 64  # a one-pole lowpass of fewer taps is a truncated
#                           FIR (ops/synth.py:_fir_len), others the doubling
#                           scan; voice_bank.cu's FIRs hold kMaxTaps = 63
VOICE_BANK_TILE = 1024    # voice_bank.cu's kTile: the scan's first pass
#                           takes its steps d < it


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with span("kernels.load", lib=name) as sp:
                sp.set(built=not os.path.exists(_paths(name)[1]))
                lib = ctypes.CDLL(build(name))
                for fn, (args, res) in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = res
            _libs[name] = lib
        return lib


# each library's error string: the entry named <prefix>_error_string
_ERROR_STRING = {name: next(fn for fn in sigs if fn.endswith("_error_string"))
                 for name, sigs in _SIGNATURES.items()}


def _launch(name: str, lib: str, fn: str, dev: torch.device, *args,
            tail=()) -> None:
    """Launch ``fn`` of library ``lib`` on ``dev``'s current stream: its
    arguments are ``args``, the stream, then ``tail``.  A failed launch
    raises with the library's error string; a launch is counted in the
    ``launches`` of the wrapper ``name``, looked up in the module, so a
    stand-in set there by ``setattr`` counts it."""
    so = _lib(lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(so, fn)(*args, stream, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({fn}): "
                           + getattr(so, _ERROR_STRING[lib])(rc).decode())
    globals()[name].launches += 1


def _counted(wrapper):
    """A kernel wrapper with its launch counter at 0."""
    wrapper.launches = 0
    return wrapper


def _check(name: str, tensors, dtypes, shapes) -> None:
    """Every tensor on one CUDA device, contiguous, of its dtype and shape:
    a tuple is the shape, an int the number of dimensions (the wrapper
    checks how those lengths relate).  Each test is one cheap call: a
    launch pays them all on the host."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: tensors must be on a CUDA device")
    for t, dt, shp in zip(tensors, dtypes, shapes):
        if t.device != dev:
            raise ValueError(f"{name} kernel: tensors must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: tensors must be contiguous")
        if t.dtype != dt:
            raise TypeError(f"{name} kernel: wants {dt}, got {t.dtype}")
        if t.dim() != shp if type(shp) is int else t.shape != shp:
            raise ValueError(f"{name} kernel: wants shape {shp}, got "
                             f"{tuple(t.shape)}")


_F32, _F64, _I32 = torch.float32, torch.float64, torch.int32


@_counted
def overlap_add(out: torch.Tensor, vals: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """Launch ``overlap_add.cu`` on the current stream: ``out`` f32[N] +=
    the windows ``vals`` f32[E, Lw] at ``starts`` i32[E], in event order,
    in place.  All three on one CUDA device, contiguous; 0 < Lw <= N."""
    _check("overlap_add", (out, vals, starts), (_F32, _F32, _I32), (1, 2, 1))
    E, Lw = vals.shape
    N = out.shape[0]
    if starts.shape[0] != E or not 0 < Lw <= N:
        raise ValueError(f"overlap_add kernel: {E} windows of {Lw}, "
                         f"{starts.shape[0]} starts, buffer {N}")
    if E:
        _launch("overlap_add", "overlap_add", "oa_launch", out.device,
                vals.data_ptr(), starts.data_ptr(), out.data_ptr(), E, Lw, N)
    return out


@_counted
def lerp_read(audio: torch.Tensor, idx0: torch.Tensor,
              fr: torch.Tensor) -> torch.Tensor:
    """Launch ``lerp_read.cu`` on the current stream and return the new
    f32[T] ``(1 - fr) * audio[i0] + fr * audio[i1]``, with
    ``i0 = clamp(idx0, 0, n - 1)`` and ``i1 = min(i0 + 1, n - 1)``.
    ``audio`` f32[n], ``idx0`` i32[T], ``fr`` f32[T], all on one CUDA
    device, contiguous; 0 < n < 2**31."""
    _check("lerp_read", (audio, idx0, fr), (_F32, _I32, _F32),
           (1, 1, idx0.shape))
    n, T = audio.shape[0], idx0.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"lerp_read kernel: audio length {n}")
    out = torch.empty(T, dtype=torch.float32, device=audio.device)
    if T:
        _launch("lerp_read", "lerp_read", "lr_launch", audio.device,
                audio.data_ptr(), idx0.data_ptr(), fr.data_ptr(),
                out.data_ptr(), T, n)
    return out


@_counted
def scrub_read(audio: torch.Tensor, whole: torch.Tensor, frac: torch.Tensor,
               off_whole, off_frac, gain: float, summed: bool,
               env_blocks: torch.Tensor, block_size: int, out: torch.Tensor,
               t0: int, t1: int) -> torch.Tensor:
    """Launch ``lerp_read.cu``'s fused scrub read on the current stream:
    ``out[t0:t1]`` = the wrap-around multi-head read of ``whole[t0:t1]``,
    ``frac[t0:t1]`` (forms A, ``summed``, and B: see the source), times
    ``gain``, times ``env_blocks[g // block_size]`` for sample g, as f32 or
    (an int16 ``out``) PCM16; returns ``out``.  ``audio`` f32[n], ``whole``
    / ``frac`` i32[T], ``out`` [T], ``env_blocks`` f32, all on one CUDA
    device, contiguous, 0 < n < 2**31, T < 2**30; ``off_whole`` /
    ``off_frac`` 1 to 3 host ints each; ``gain`` an f32 value."""
    if out.dtype not in (_F32, torch.int16):
        raise TypeError("scrub_read kernel: out must be float32 or int16")
    _check("scrub_read", (audio, whole, frac, env_blocks, out),
           (_F32, _I32, _I32, _F32, out.dtype), (1, out.shape, out.shape, 1, 1))
    ow, of = [int(v) for v in off_whole], [int(v) for v in off_frac]
    if not 1 <= len(ow) == len(of) <= MAX_HEADS:
        raise ValueError(f"scrub_read kernel: {len(ow)} / {len(of)} head "
                         f"offsets (1 to {MAX_HEADS})")
    if summed and any(of):
        raise ValueError("scrub_read kernel: the summed form takes integer "
                         "head offsets only")
    n, T = audio.shape[0], out.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"scrub_read kernel: audio length {n}")
    if T >= 2 ** 30:
        raise ValueError(f"scrub_read kernel: {T} samples (at most 2**30)")
    if not (0 <= t0 <= t1 <= T and block_size >= 1):
        raise ValueError(f"scrub_read kernel: samples [{t0}, {t1}) of {T}, "
                         f"block size {block_size}")
    if t1 > t0 and (t1 - 1) // block_size >= env_blocks.shape[0]:
        raise ValueError(f"scrub_read kernel: {env_blocks.shape[0]} "
                         f"envelope blocks of {block_size} for {t1} samples")
    if t1 > t0:
        heads = ctypes.c_int * len(ow)
        _launch("scrub_read", "lerp_read", "sr_launch", audio.device,
                audio.data_ptr(), n, whole.data_ptr(), frac.data_ptr(),
                env_blocks.data_ptr(), int(block_size), out.data_ptr(),
                int(out.dtype == torch.int16), int(t0), int(t1), len(ow),
                heads(*ow), heads(*of), int(bool(summed)), float(gain))
    return out


@_counted
def stick_slip_noise_scan(seed: torch.Tensor, L: int, threshold: float,
                          build: float, decay: float, noise_amt: float,
                          streams: tuple[int, int]) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s stick-slip recurrence with its noise
    drawn in the kernel, on the current stream, and return the new xs
    f32 [E, L]: the rows are ``ops/noise.py``'s ``normal(seed, t, s)`` for
    t in [0, L) and s each of ``streams`` (the build and the out stream),
    from the seeds int32 [E] (contiguous, on a CUDA device; read as
    uint32); the scalars are f32 values."""
    _check("stick_slip_noise", (seed,), (_I32,), (1,))
    if L < 1:
        raise ValueError(f"stick_slip_noise kernel: L {L} (at least 1)")
    E = seed.shape[0]
    xs = torch.empty(E, L, dtype=torch.float32, device=seed.device)
    if E:
        sb, so = (int(s) & 0xFFFFFFFF for s in streams)
        _launch("stick_slip_noise_scan", "grain_scan", "gs_stick_slip_noise",
                seed.device, seed.data_ptr(), xs.data_ptr(), E, L, threshold,
                build, decay, noise_amt, sb, so)
    return xs


@_counted
def chaos_scan(gates: torch.Tensor, y0: torch.Tensor, r: float,
               gate: float) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s gated logistic map on the current stream
    and return the new xs f32 [E, L] from gates f32 [E, L] and the starts
    y0 f32 [E]."""
    _check("chaos", (gates, y0), (_F32, _F32), (2, 1))
    E, L = gates.shape
    if y0.shape[0] != E:
        raise ValueError(f"chaos kernel: {E} rows, {y0.shape[0]} starts")
    xs = torch.empty_like(gates)
    if E and L:
        _launch("chaos_scan", "grain_scan", "gs_chaos", gates.device,
                gates.data_ptr(), y0.data_ptr(), xs.data_ptr(), E, L, r,
                gate)
    return xs


@_counted
def waveguide_scan(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                   mix: torch.Tensor) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s waveguide delay lines on the current
    stream and return the new y f32 [E, L] from x f32 [E, L], the delays
    d i32 [E, lines], the gains g and the mixes f32 [E, lines]: one block
    per event, its row in shared memory where it fits."""
    _check("waveguide", (x, d, g, mix), (_F32, _I32, _F32, _F32),
           (2, 2, d.shape, d.shape))
    (E, L), lines = x.shape, d.shape[1]
    if d.shape[0] != E:
        raise ValueError(f"waveguide kernel: {E} rows, {d.shape[0]} delays")
    y = torch.empty_like(x)
    if E and L and lines:
        _launch("waveguide_scan", "grain_scan", "gs_waveguide", x.device,
                x.data_ptr(), d.data_ptr(), g.data_ptr(), mix.data_ptr(),
                y.data_ptr(), E, L, lines)
    else:
        y.copy_(x)
    return y


def _vb_rows(name: str, x, i32, widths=None) -> tuple[int, int]:
    """A voice-bank launch's rows x f32 [count, n] and ints i32 [count, W]
    (W >= 2, n >= 1; ``widths``: a pack's (n, W)): (count, n)."""
    count, n = x.shape
    if (i32.shape[0] != count or i32.shape[1] < 2 or n < 1
            or widths is not None and (n, i32.shape[1]) != widths):
        raise ValueError(f"{name} kernel: rows {tuple(x.shape)}, ints "
                         f"{tuple(i32.shape)}"
                         + (f" (widths {widths})" if widths else ""))
    return count, n


def _vb_params(name: str, L: int, taps, consts) -> None:
    """A voice-bank launch's own scalars: the length, the lowpasses' tap
    counts and the host constants."""
    if L < 1 or not (all(1 <= k < VOICE_BANK_MAX_TAPS for k in taps)
                     or not any(taps)):
        raise ValueError(f"{name} kernel: L {L}, taps {taps} (L >= 1, "
                         f"1 to {VOICE_BANK_MAX_TAPS - 1} taps, or all 0)")
    if consts.dtype != np.float32 or consts.ndim != 1:
        raise TypeError(f"{name} kernel: consts must be a host f32 vector")


@_counted
def voice_bank_fm(f32: torch.Tensor, i32: torch.Tensor, L: int,
                  n_total: int, alg: int, vib: bool, fade: int, taps1: int,
                  taps2: int, consts: np.ndarray) -> torch.Tensor:
    """Launch ``voice_bank.cu``'s FM bank on the current stream and return
    the new f32 [count, L] of one bucket's masked notes, from its rows f32
    [count, 36] and i32 [count, 26] of the fm32 / fmi packs (contiguous, on
    one CUDA device), algorithm ``alg`` (1-3), the vibrato flag, the
    render's length, the fade's samples, the two lowpasses' tap counts
    (both 0: the signal unfiltered) and the host constants ``consts``
    (``ops/synth.py:bank_consts``)."""
    _check("voice_bank_fm", (f32, i32), (_F32, _I32), (2, 2))
    count, _ = _vb_rows("voice_bank_fm", f32, i32, (36, 26))
    _vb_params("voice_bank_fm", L, (taps1, taps2), consts)
    if alg not in (1, 2, 3):
        raise ValueError(f"voice_bank_fm kernel: algorithm {alg}")
    out = torch.empty(count, L, dtype=torch.float32, device=f32.device)
    if count:
        _launch("voice_bank_fm", "voice_bank", "vb_fm_launch", f32.device,
                f32.data_ptr(), i32.data_ptr(), count, L, int(n_total),
                int(alg), int(bool(vib)), int(fade), int(taps1), int(taps2),
                consts.ctypes.data, consts.size, out.data_ptr())
    return out


@_counted
def voice_bank_psg(f32: torch.Tensor, i32: torch.Tensor, L: int,
                   n_total: int, lfsr, fade: int, taps: int,
                   consts: np.ndarray) -> torch.Tensor:
    """Launch ``voice_bank.cu``'s PSG bank on the current stream and
    return the new f32 [count, L] of one bucket's masked notes, from its
    rows f32 [count, 10] and i32 [count, 10] of the pg32 / pgi packs, the
    LFSR orbit tables ``lfsr`` (orbit f32, base / pos / len i32, each
    [2**15], on the packs' device), the render's length, the fade's
    samples, the lowpass's tap count (0: the signal unfiltered) and the
    host constants."""
    orbit, base, pos, clen = lfsr
    _check("voice_bank_psg", (f32, i32, orbit, base, pos, clen),
           (_F32, _I32, _F32, _I32, _I32, _I32), (2, 2) + ((1 << 15,),) * 4)
    count, _ = _vb_rows("voice_bank_psg", f32, i32, (10, 10))
    _vb_params("voice_bank_psg", L, (taps,), consts)
    out = torch.empty(count, L, dtype=torch.float32, device=f32.device)
    if count:
        _launch("voice_bank_psg", "voice_bank", "vb_psg_launch", f32.device,
                f32.data_ptr(), i32.data_ptr(), count, L, int(n_total),
                orbit.data_ptr(), base.data_ptr(), pos.data_ptr(),
                clen.data_ptr(), int(fade), int(taps), consts.ctypes.data,
                consts.size, out.data_ptr())
    return out


@_counted
def voice_bank_fir(x: torch.Tensor, i32: torch.Tensor, n_total: int,
                   w: np.ndarray) -> torch.Tensor:
    """Launch ``voice_bank.cu``'s FIR pass on the current stream: the new
    f32 [count, L] of the truncated FIR of host f32 weights ``w`` (1 to 63
    taps: y = w0*x, then y + w_k*x[i-k]) along each row of ``x`` f32
    [count, L], zero from each row's clamp min(n, n_total - start) on; n
    and start are the first two columns of ``i32`` int32 [count, W]."""
    _check("voice_bank_fir", (x, i32), (_F32, _I32), (2, 2))
    count, L = _vb_rows("voice_bank_fir", x, i32)
    if w.dtype != np.float32 or not 1 <= w.size < VOICE_BANK_MAX_TAPS:
        raise ValueError(f"voice_bank_fir kernel: weights {w.dtype} "
                         f"{w.shape}")
    w = np.ascontiguousarray(w)
    out = torch.empty_like(x)
    if count:
        _launch("voice_bank_fir", "voice_bank", "vb_fir_launch", x.device,
                x.data_ptr(), i32.data_ptr(), i32.shape[1], count, L,
                int(n_total), w.size, w.ctypes.data, out.data_ptr())
    return out


@_counted
def voice_bank_scan(x: torch.Tensor, i32: torch.Tensor, n_total: int,
                    coefs: np.ndarray) -> torch.Tensor:
    """Launch ``voice_bank.cu``'s doubling scan of a one-pole lowpass on
    the current stream: the new f32 [count, L] of ``ops/synth.py:
    _one_pole_scan`` along each row of ``x``, zero from each row's clamp
    on (rows and clamp as for ``voice_bank_fir``); ``coefs`` the host f32
    [32] (1 - a, a, a**2, a**4, ..., a**(2**30)) of
    ``synth.scan_coefs``.  One launch for
    the steps d < VOICE_BANK_TILE, one for each later step d < L."""
    _check("voice_bank_scan", (x, i32), (_F32, _I32), (2, 2))
    count, L = _vb_rows("voice_bank_scan", x, i32)
    if coefs.dtype != np.float32 or coefs.shape != (32,):
        raise ValueError(f"voice_bank_scan kernel: coefs {coefs.dtype} "
                         f"{coefs.shape}, not f32 (32,)")
    out = torch.empty_like(x)
    if not count:
        return out
    tmp = torch.empty_like(x) if L > VOICE_BANK_TILE else None
    d, src = 0, x
    while True:
        _launch("voice_bank_scan", "voice_bank", "vb_scan_launch", x.device,
                src.data_ptr(), i32.data_ptr(), i32.shape[1], count, L,
                int(n_total), d, coefs.ctypes.data, coefs.size,
                out.data_ptr())
        d = max(2 * d, VOICE_BANK_TILE)
        if d >= L:
            return out
        src, out = out, (tmp if src is x else src)


@_counted
def tape_scan(audio: torch.Tensor, mod_q: torch.Tensor, starts: torch.Tensor,
              ends: torch.Tensor, speeds_q: torch.Tensor,
              reverse: torch.Tensor, boundaries: torch.Tensor,
              splice_env: torch.Tensor, state: torch.Tensor, *,
              anticlick_on: bool, smooth_len: int, strength: float,
              splice_on: bool, inertia_on: bool, alpha_q: float,
              chunk: int = TAPE_SCAN_CHUNK, return_records: bool = False,
              marks=None):
    """Launch ``tape_scan.cu`` (the chunk sums, the walk, the replay) on
    the current stream and
    return the new (out f32 [T], final state int32 [5]) of the tape's scan
    engine from audio f32 [n], mod_q f32 [T], starts / ends int32 [S],
    speeds_q f32 [S], reverse bool [S], boundaries int32 [B], splice_env
    f32 [E] and the initial ``state`` int32 [5] (whole, frac, the speed's
    f32 bits, splice rem, splice index), all contiguous on one CUDA
    device; 0 < n < 2**31, S >= 1 and 4 S + B <= TAPE_SCAN_MAX_TABLE_WORDS;
    the scalars are the TapeConsts fields (f32 values).  ``chunk`` is the
    steps a chunk (a power of two in TAPE_SCAN_CHUNKS); with
    ``return_records`` a third item, the chunks' records int32
    [ceil(T / chunk), TAPE_SCAN_REC_WORDS] (each chunk's start state, and
    in word 5 whether it was jumped), and a fourth, the walked chunks'
    count (int32 [1]), both on the device.  ``marks``: two
    ``torch.cuda.Event``s recorded after the chunk sums and after the
    walk, to time the passes."""
    _check("tape_scan",
           (audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
            splice_env, state),
           (_F32, _F32, _I32, _I32, _F32, torch.bool, _I32, _F32, _I32),
           (1, 1, 1, starts.shape, starts.shape, starts.shape, 1, 1, (5,)))
    n, T, S, B, E = (audio.shape[0], mod_q.shape[0], starts.shape[0],
                     boundaries.shape[0], splice_env.shape[0])
    if not 0 < n < 2 ** 31:
        raise ValueError(f"tape_scan kernel: audio length {n}")
    if S < 1 or 4 * S + B > TAPE_SCAN_MAX_TABLE_WORDS:
        raise ValueError(f"tape_scan kernel: {S} sections and {B} "
                         f"boundaries (at least 1 section, 4 S + B <= "
                         f"{TAPE_SCAN_MAX_TABLE_WORDS})")
    lo, hi = TAPE_SCAN_CHUNKS
    if not (lo <= chunk <= hi and chunk & (chunk - 1) == 0):
        raise ValueError(f"tape_scan kernel: chunk {chunk} (a power of two "
                         f"in [{lo}, {hi}])")
    dev = audio.device
    out = torch.empty(T, dtype=torch.float32, device=dev)
    fin = torch.empty(5, dtype=torch.int32, device=dev)
    scratch = torch.empty(_lib("tape_scan").ts_scratch_words(T, S, chunk),
                          dtype=torch.int32, device=dev)
    handles = [None] * 2
    if marks is not None:
        if len(marks) != 2:
            raise ValueError(f"tape_scan kernel: {len(marks)} marks (2)")
        for e in marks:
            e.record()                     # creates the event
        handles = [e.cuda_event for e in marks]
    _launch("tape_scan", "tape_scan", "ts_launch", dev,
            audio.data_ptr(), n, mod_q.data_ptr(), T, starts.data_ptr(),
            ends.data_ptr(), speeds_q.data_ptr(), reverse.data_ptr(), S,
            boundaries.data_ptr(), B, splice_env.data_ptr(), E,
            int(bool(anticlick_on)), int(smooth_len), float(strength),
            1.0 / max(1, int(smooth_len)), int(bool(splice_on)),
            int(bool(inertia_on)), float(alpha_q), state.data_ptr(),
            int(chunk), scratch.data_ptr(), out.data_ptr(), fin.data_ptr(),
            tail=handles)
    if not return_records:
        return out, fin
    nch = -(-T // chunk)
    w = TAPE_SCAN_REC_WORDS
    return (out, fin, scratch[:w * nch].view(nch, w),
            scratch[w * nch:w * nch + 1])


@_counted
def tape_tables(packed: torch.Tensor, S: int, B: int, R: int, T: int, n: int,
                env_len: int, splice_on: bool, s_init: int,
                mod_ints: np.ndarray, mod_flts: np.ndarray,
                coeffs: np.ndarray, chunk: int, cap: int) -> torch.Tensor:
    """Launch ``tape_scan.cu``'s table walk (the chunk sums, the one-block
    walk) on the current stream and return its new output int32
    [TAPE_TABLES_HEAD + 8 cap]: the counts of visits, runs and triggers,
    whether one passed ``cap``, the final whole, frac, speed integer,
    splice rem and index (int64 each from word 4), the walked and jumped
    chunks, then the records packed (``ops/varispeed.py:
    tape_tables_on_card`` reads them).  ``packed`` int32 (contiguous, on a
    CUDA device): the S sections' starts, ends, reverse and speed rows,
    the B boundaries, the R rows' f32 speeds and integers
    (``varispeed.tables_kernel_args``); ``s_init`` the initial speed's
    fixed-point integer; the wow/flutter constants ``mod_ints`` uint32
    [4], ``mod_flts`` f32 [6] (inverse periods, depths, start phases) and
    the sine's ``coeffs`` f32 [10] on the host; ``chunk`` a power of two
    in TAPE_SCAN_CHUNKS; T < 2**31."""
    _check("tape_tables", (packed,), (_I32,), (1,))
    lo, hi = TAPE_SCAN_CHUNKS
    if not (lo <= chunk <= hi and chunk & (chunk - 1) == 0):
        raise ValueError(f"tape_tables kernel: chunk {chunk} (a power of "
                         f"two in [{lo}, {hi}])")
    if not (1 <= R <= S and B >= 0 and 0 <= T < 2 ** 31 and 0 < n < 2 ** 31
            and cap >= 1 and packed.shape[0] >= 4 * S + B + 2 * R):
        raise ValueError(f"tape_tables kernel: S {S}, B {B}, R {R}, T {T}, "
                         f"n {n}, cap {cap}, {packed.shape[0]} input words")
    consts = [np.ascontiguousarray(a, dt) for a, dt in
              ((mod_ints, np.uint32), (mod_flts, np.float32),
               (coeffs, np.float32))]
    if [c.size for c in consts] != [4, 6, 10]:
        raise ValueError("tape_tables kernel: wants 4 ints, 6 floats and "
                         "10 coefficients")
    dev = packed.device
    lib = _lib("tape_scan")
    scratch = torch.empty(lib.ts_tables_scratch_words(T, R, chunk, cap),
                          dtype=torch.int32, device=dev)
    out = torch.empty(TAPE_TABLES_HEAD + 8 * cap, dtype=torch.int32,
                      device=dev)
    _launch("tape_tables", "tape_scan", "ts_tables_launch", dev,
            packed.data_ptr(), S, B, R, T, n, int(env_len),
            int(bool(splice_on)), int(s_init), consts[0].ctypes.data,
            consts[1].ctypes.data, consts[2].ctypes.data, int(chunk),
            int(cap), scratch.data_ptr(), out.data_ptr())
    return out


@_counted
def space_conv(offs: torch.Tensor, gains: torch.Tensor, ir: torch.Tensor,
               n_er: int) -> torch.Tensor:
    """Launch ``space_conv.cu`` on the current stream and return the new
    f32 [n_er + n_ir - 1] ER (x) IR: out[j] = the sum over the taps, in
    their order, of f64(gains[t]) * ir[j - offs[t]] where 0 <= j - offs[t]
    < n_ir, rounded once to f32.  ``offs`` int32 [T] (ascending, in [0,
    n_er)) and ``gains`` f32 [T] are the ER kernel's nonzero taps, ``ir``
    f64 [n_ir]; all contiguous on one CUDA device; n_er >= 1, n_ir >= 1."""
    _check("space_conv", (ir, offs, gains), (_F64, _I32, _F32),
           (1, 1, offs.shape))
    T, n_ir = offs.shape[0], ir.shape[0]
    n_out = n_er + n_ir - 1
    if n_er < 1 or n_ir < 1 or n_out >= 2 ** 31:
        raise ValueError(f"space_conv kernel: ER {n_er} taps, IR {n_ir}")
    out = torch.empty(n_out, dtype=torch.float32, device=ir.device)
    _launch("space_conv", "space_conv", "sc_launch", ir.device,
            offs.data_ptr(), gains.data_ptr(), T, ir.data_ptr(), n_ir,
            out.data_ptr(), n_out)
    return out

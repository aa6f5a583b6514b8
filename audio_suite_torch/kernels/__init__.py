"""Hand-written CUDA kernels of the port and their loader.

Each ``<name>.cu`` in this directory is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, on first use,
into ``_build/`` beside it (git-ignored), named by a hash of the source and
the flags, and loaded with ``ctypes``.  Nothing is built or loaded at import
time.  A failed build or launch raises: there is no fallback.

Each kernel wrapper counts its launches in its ``launches`` attribute, so
a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

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
        "gs_stick_slip": ([_P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_float, ctypes.c_float,
                           ctypes.c_float, _P], ctypes.c_int),
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
    "tape_scan": {
        "ts_launch": ([_P, ctypes.c_int, _P, ctypes.c_longlong, _P, _P, _P,
                       _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, _P, ctypes.c_int, _P, _P, _P, _P, _P,
                       _P], ctypes.c_int),
        "ts_scratch_words": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
                             ctypes.c_longlong),
        "ts_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}
TAPE_SCAN_MAX_TABLE_WORDS = 12288   # tape_scan.cu's kMaxTableWords
TAPE_SCAN_CHUNK = 1024  # tape_scan.cu's steps a chunk: a power of two in
TAPE_SCAN_CHUNKS = (32, 4096)  # this range (kMinChunk, kMaxChunk)
TAPE_SCAN_REC_WORDS = 8  # a chunk's record (kRecWords); bit 0 of word 5:
#                          jumped
MAX_HEADS = 3           # scrub_read_kernel's head slots (lerp_read.cu)


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


def overlap_add(out: torch.Tensor, vals: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """Launch ``overlap_add.cu`` on the current stream: ``out`` f32[N] +=
    the windows ``vals`` f32[E, Lw] at ``starts`` i32[E], in event order,
    in place.  All three on one CUDA device, contiguous; 0 < Lw <= N."""
    for t in (out, vals, starts):
        if t.device.type != "cuda":
            raise ValueError("overlap_add kernel: tensors must be on CUDA")
        if not t.is_contiguous():
            raise ValueError("overlap_add kernel: tensors must be "
                             "contiguous")
    if starts.dtype != torch.int32:
        raise TypeError("overlap_add kernel: starts must be int32")
    E, Lw = vals.shape
    N = out.shape[0]
    if not 0 < Lw <= N:
        raise ValueError(f"overlap_add kernel: window {Lw}, buffer {N}")
    if E == 0:
        return out
    lib = _lib("overlap_add")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.oa_launch(vals.data_ptr(), starts.data_ptr(),
                           out.data_ptr(), E, Lw, N, stream)
    if rc != 0:
        raise RuntimeError("overlap_add kernel launch failed: "
                           + lib.oa_error_string(rc).decode())
    overlap_add.launches += 1
    return out


overlap_add.launches = 0


def lerp_read(audio: torch.Tensor, idx0: torch.Tensor,
              fr: torch.Tensor) -> torch.Tensor:
    """Launch ``lerp_read.cu`` on the current stream and return the new
    f32[T] ``(1 - fr) * audio[i0] + fr * audio[i1]``, with
    ``i0 = clamp(idx0, 0, n - 1)`` and ``i1 = min(i0 + 1, n - 1)``.
    ``audio`` f32[n], ``idx0`` i32[T], ``fr`` f32[T], all on one CUDA
    device, contiguous; 0 < n < 2**31."""
    for t in (audio, idx0, fr):
        if t.device.type != "cuda":
            raise ValueError("lerp_read kernel: tensors must be on CUDA")
        if not t.is_contiguous():
            raise ValueError("lerp_read kernel: tensors must be contiguous")
    if not (audio.device == idx0.device == fr.device):
        raise ValueError("lerp_read kernel: tensors must share one device")
    if audio.dtype != torch.float32 or fr.dtype != torch.float32:
        raise TypeError("lerp_read kernel: audio and fr must be float32")
    if idx0.dtype != torch.int32:
        raise TypeError("lerp_read kernel: idx0 must be int32")
    if audio.dim() != 1 or idx0.dim() != 1 or idx0.shape != fr.shape:
        raise ValueError("lerp_read kernel: wants audio [n], idx0 [T], "
                         "fr [T]")
    n, T = audio.shape[0], idx0.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"lerp_read kernel: audio length {n}")
    out = torch.empty(T, dtype=torch.float32, device=audio.device)
    if T == 0:
        return out
    lib = _lib("lerp_read")
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = lib.lr_launch(audio.data_ptr(), idx0.data_ptr(), fr.data_ptr(),
                           out.data_ptr(), T, n, stream)
    if rc != 0:
        raise RuntimeError("lerp_read kernel launch failed: "
                           + lib.lr_error_string(rc).decode())
    lerp_read.launches += 1
    return out


lerp_read.launches = 0


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
    tensors = (audio, whole, frac, env_blocks, out)
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError("scrub_read kernel: tensors must be on CUDA")
        if not t.is_contiguous():
            raise ValueError("scrub_read kernel: tensors must be "
                             "contiguous")
    if any(t.device != audio.device for t in tensors):
        raise ValueError("scrub_read kernel: tensors must share one device")
    if audio.dtype != torch.float32 or env_blocks.dtype != torch.float32:
        raise TypeError("scrub_read kernel: audio and env_blocks must be "
                        "float32")
    if whole.dtype != torch.int32 or frac.dtype != torch.int32:
        raise TypeError("scrub_read kernel: whole and frac must be int32")
    if out.dtype not in (torch.float32, torch.int16):
        raise TypeError("scrub_read kernel: out must be float32 or int16")
    if any(t.dim() != 1 for t in tensors) \
            or not whole.shape == frac.shape == out.shape:
        raise ValueError("scrub_read kernel: wants audio [n], whole [T], "
                         "frac [T], env_blocks [B], out [T]")
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
    if t1 == t0:
        return out
    lib = _lib("lerp_read")
    heads = ctypes.c_int * len(ow)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = lib.sr_launch(audio.data_ptr(), n, whole.data_ptr(),
                           frac.data_ptr(), env_blocks.data_ptr(),
                           int(block_size), out.data_ptr(),
                           int(out.dtype == torch.int16), int(t0), int(t1),
                           len(ow), heads(*ow), heads(*of),
                           int(bool(summed)), float(gain), stream)
    if rc != 0:
        raise RuntimeError("scrub_read kernel launch failed: "
                           + lib.lr_error_string(rc).decode())
    scrub_read.launches += 1
    return out


scrub_read.launches = 0


def _scan_check(name: str, tensors, dtypes, shapes):
    """The grain-scan wrappers' checks: every tensor on one CUDA device,
    contiguous, of its dtype and shape."""
    dev = tensors[0].device
    for t, dt, shp in zip(tensors, dtypes, shapes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} kernel: tensors must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: tensors must be contiguous")
        if t.dtype != dt:
            raise TypeError(f"{name} kernel: wants {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name} kernel: wants shape {tuple(shp)}, "
                             f"got {tuple(t.shape)}")


def _gs_run(fn: str, dev, *args):
    lib = _lib("grain_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"grain_scan kernel {fn} launch failed: "
                           + lib.gs_error_string(rc).decode())


def stick_slip_scan(bn: torch.Tensor, on: torch.Tensor, threshold: float,
                    build: float, decay: float, noise_amt: float
                    ) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s stick-slip recurrence on the current
    stream and return the new xs f32 [E, L] from the noise rows bn, on
    f32 [E, L] (contiguous, on one CUDA device); the scalars are f32
    values."""
    E, L = bn.shape
    _scan_check("stick_slip", (bn, on), (torch.float32,) * 2, ((E, L),) * 2)
    xs = torch.empty_like(bn)
    if E and L:
        _gs_run("gs_stick_slip", bn.device, bn.data_ptr(), on.data_ptr(),
                xs.data_ptr(), E, L, threshold, build, decay, noise_amt)
        stick_slip_scan.launches += 1
    return xs


stick_slip_scan.launches = 0


def stick_slip_noise_scan(seed: torch.Tensor, L: int, threshold: float,
                          build: float, decay: float, noise_amt: float,
                          streams: tuple[int, int]) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s stick-slip recurrence with its noise
    drawn in the kernel, on the current stream, and return the new xs
    f32 [E, L]: the rows are ``ops/noise.py``'s ``normal(seed, t, s)`` for
    t in [0, L) and s each of ``streams`` (the build and the out stream),
    from the seeds int32 [E] (contiguous, on a CUDA device; read as
    uint32); the scalars are f32 values."""
    E = seed.shape[0] if seed.dim() == 1 else -1
    _scan_check("stick_slip_noise", (seed,), (torch.int32,), ((E,),))
    if L < 1:
        raise ValueError(f"stick_slip_noise kernel: L {L} (at least 1)")
    xs = torch.empty(E, L, dtype=torch.float32, device=seed.device)
    if E:
        sb, so = (int(s) & 0xFFFFFFFF for s in streams)
        _gs_run("gs_stick_slip_noise", seed.device, seed.data_ptr(),
                xs.data_ptr(), E, L, threshold, build, decay, noise_amt, sb,
                so)
        stick_slip_noise_scan.launches += 1
    return xs


stick_slip_noise_scan.launches = 0


def chaos_scan(gates: torch.Tensor, y0: torch.Tensor, r: float,
               gate: float) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s gated logistic map on the current stream
    and return the new xs f32 [E, L] from gates f32 [E, L] and the starts
    y0 f32 [E]."""
    E, L = gates.shape
    _scan_check("chaos", (gates, y0), (torch.float32,) * 2, ((E, L), (E,)))
    xs = torch.empty_like(gates)
    if E and L:
        _gs_run("gs_chaos", gates.device, gates.data_ptr(), y0.data_ptr(),
                xs.data_ptr(), E, L, r, gate)
        chaos_scan.launches += 1
    return xs


chaos_scan.launches = 0


def waveguide_scan(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor,
                   mix: torch.Tensor) -> torch.Tensor:
    """Launch ``grain_scan.cu``'s waveguide delay lines on the current
    stream and return the new y f32 [E, L] from x f32 [E, L], the delays
    d i32 [E, lines], the gains g and the mixes f32 [E, lines]: one block
    per event, its row in shared memory where it fits."""
    E, L = x.shape
    lines = d.shape[1] if d.dim() == 2 else -1
    _scan_check("waveguide", (x, d, g, mix),
                (torch.float32, torch.int32, torch.float32, torch.float32),
                ((E, L), (E, lines), (E, lines), (E, lines)))
    y = torch.empty_like(x)
    if E and L and lines > 0:
        _gs_run("gs_waveguide", x.device, x.data_ptr(), d.data_ptr(),
                g.data_ptr(), mix.data_ptr(), y.data_ptr(), E, L, lines)
        waveguide_scan.launches += 1
    else:
        y.copy_(x)
    return y


waveguide_scan.launches = 0


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
    S, B, E, T = (starts.shape[0], boundaries.shape[0], splice_env.shape[0],
                  mod_q.shape[0])
    n = audio.shape[0]
    _scan_check("tape_scan",
                (audio, mod_q, starts, ends, speeds_q, reverse, boundaries,
                 splice_env, state),
                (torch.float32, torch.float32, torch.int32, torch.int32,
                 torch.float32, torch.bool, torch.int32, torch.float32,
                 torch.int32),
                ((n,), (T,), (S,), (S,), (S,), (S,), (B,), (E,), (5,)))
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
    lib = _lib("tape_scan")
    out = torch.empty(T, dtype=torch.float32, device=dev)
    fin = torch.empty(5, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.ts_scratch_words(T, S, chunk),
                          dtype=torch.int32, device=dev)
    inv_smooth = 1.0 / max(1, int(smooth_len))
    handles = [None] * 2
    if marks is not None:
        if len(marks) != 2:
            raise ValueError(f"tape_scan kernel: {len(marks)} marks (2)")
        for e in marks:
            e.record()                     # creates the event
        handles = [e.cuda_event for e in marks]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ts_launch(
            audio.data_ptr(), n, mod_q.data_ptr(), T, starts.data_ptr(),
            ends.data_ptr(), speeds_q.data_ptr(), reverse.data_ptr(), S,
            boundaries.data_ptr(), B, splice_env.data_ptr(), E,
            int(bool(anticlick_on)), int(smooth_len), float(strength),
            inv_smooth, int(bool(splice_on)), int(bool(inertia_on)),
            float(alpha_q), state.data_ptr(), int(chunk),
            scratch.data_ptr(), out.data_ptr(), fin.data_ptr(), stream,
            *handles)
    if rc != 0:
        raise RuntimeError("tape_scan kernel launch failed: "
                           + lib.ts_error_string(rc).decode())
    tape_scan.launches += 1
    if not return_records:
        return out, fin
    nch = -(-T // chunk)
    w = TAPE_SCAN_REC_WORDS
    return (out, fin, scratch[:w * nch].view(nch, w),
            scratch[w * nch:w * nch + 1])


tape_scan.launches = 0

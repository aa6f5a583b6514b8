"""The tape's host control tables from the C++ host runtime — port of
audio_suite_tpu/utils/native_rt.py:tape_tables, with its own loader.

``native/ast_runtime.cpp`` is host code shared with the JAX package (read
and compiled, never edited).  ``get_lib`` compiles it with g++ on first use
into the git-ignored ``_build/`` beside this module, with the float flags
of the JAX package's loader (``-ffp-contract=off -fno-fast-math``), so the
tables stay bit-equal to the ones the JAX package builds.  A failed build
raises with the compiler's message: there is no host fallback.  This
module passes the port's own detmath sine coefficients.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops import detmath

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "ast_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# IEEE round-to-nearest with no contraction: every f32/f64 operation rounds
# like the NumPy twins.  -march=native only lets the loops vectorize
# (vroundps keeps rintf's round-half-even), so the results do not change.
CFLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off", "-fno-fast-math",
          "-march=native")

_lib = None
_lock = threading.Lock()


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(CFLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libast_runtime_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CFLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native tape table builder "
                           "(native/ast_runtime.cpp) is built from source "
                           "on first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded runtime with ``ast_tape_tables`` bound; built on first
    use.  Raises if it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float

            def arr(dtype):
                return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

            p_i64, p_f32 = arr(np.int64), arr(np.float32)
            # native_rt.py:107-118 of the JAX package; after T and n: mod
            # ints / flts / phase0 and the sine coefficients
            lib.ast_tape_tables.argtypes = [
                i64, i64,
                arr(np.uint32), p_f32, p_f32, p_f32,
                p_i64, p_i64, p_f32, arr(np.uint8), i64,
                ctypes.c_void_p, i64,
                i64,
                i32, i32, f32, f32,
                i64, i64, i64,
                p_i64, p_i64, p_i64, p_i64,
                p_i64, p_i64, p_i64,
                p_i64, p_i64, p_i64]
            lib.ast_tape_tables.restype = i32
            _lib = lib
        return _lib


def tape_tables(T: int, n: int, mod_consts, starts, ends, speeds_q, reverse,
                boundaries, splice_env_len: int, consts) -> dict:
    """Compact control tables of a T-sample render of an n-sample tape
    (visits, speed runs, splice triggers) and the final playback state;
    the C twin of the JAX package's varispeed.tape_tables, which
    synthesizes the wow/flutter curve itself from ``mod_consts``."""
    lib = get_lib()
    ints, flts, ph0 = mod_consts
    ints = np.ascontiguousarray(ints, np.uint32)
    flts = np.ascontiguousarray(flts, np.float32)
    ph0 = np.ascontiguousarray(ph0, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    speeds_q = np.ascontiguousarray(speeds_q, np.float32)
    reverse = np.ascontiguousarray(reverse, np.uint8)
    bnd = np.ascontiguousarray(boundaries, np.int64)
    coeffs = np.asarray(detmath._S32 + detmath._C32, np.float32)

    cap = 4096
    while True:
        vis = [np.zeros(cap, np.int64) for _ in range(4)]
        run = [np.zeros(cap, np.int64) for _ in range(3)]
        trg = np.zeros(cap, np.int64)
        counts = np.zeros(3, np.int64)
        fin = np.zeros(5, np.int64)
        rc = lib.ast_tape_tables(
            int(T), int(n), ints, flts, ph0, coeffs,
            starts, ends, speeds_q, reverse, len(starts),
            bnd.ctypes.data if len(bnd) else None, len(bnd),
            int(splice_env_len),
            1 if consts.splice_on else 0, 1 if consts.inertia_on else 0,
            np.float32(consts.alpha_q), np.float32(consts.initial_speed_q),
            0, 0, cap,
            vis[0], vis[1], vis[2], vis[3],
            run[0], run[1], run[2], trg, counts, fin)
        if rc == 0:
            break
        cap = int(max(int(counts.max()) + 16, cap * 2))   # retry with room
    nv, nr, nt = int(counts[0]), int(counts[1]), int(counts[2])
    final = dict(whole=int(fin[0]), frac=int(fin[1]),
                 speed=float(np.float32(fin[2]
                                        * np.float32(1.0 / (1 << 22)))),
                 splice_rem=int(fin[3]), splice_idx=int(fin[4]))
    return dict(
        visit_start=vis[0][:nv].astype(np.int32),
        visit_bw=vis[1][:nv].astype(np.int32),
        visit_bf=vis[2][:nv].astype(np.int32),
        visit_sec=vis[3][:nv].astype(np.int32),
        run_start=run[0][:nr].astype(np.int32),
        run_s0=run[1][:nr].astype(np.int32),
        run_m=run[2][:nr].astype(np.int32),
        triggers=trg[:nt].astype(np.int32),
        final=final)

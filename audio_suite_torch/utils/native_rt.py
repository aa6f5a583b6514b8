"""The tape's host control tables from the shared C++ runtime — port of
audio_suite_tpu/utils/native_rt.py:tape_tables.

``native/ast_runtime.cpp`` is host code shared with the JAX package: its
loader, ``audio_suite_tpu.utils.native_rt.get_lib`` (jax-free), compiles it
with g++ on first use.  This module passes the port's own detmath sine
coefficients.  There is no host fallback: without the library (no g++, or
``AST_DISABLE_NATIVE`` set) the render raises.
"""
from __future__ import annotations

import numpy as np

from audio_suite_tpu.utils.native_rt import get_lib

from ..ops import detmath


def tape_tables(T: int, n: int, mod_consts, starts, ends, speeds_q, reverse,
                boundaries, splice_env_len: int, consts) -> dict:
    """Compact control tables of a T-sample render of an n-sample tape
    (visits, speed runs, splice triggers) and the final playback state;
    the C twin of the JAX package's varispeed.tape_tables, which
    synthesizes the wow/flutter curve itself from ``mod_consts``."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ast_tape_tables"):
        raise RuntimeError("the native tape table builder "
                           "(native/ast_runtime.cpp) is unavailable: it "
                           "needs g++, and AST_DISABLE_NATIVE unset")
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

#!/usr/bin/env python3
"""A/B of overlap-add kernel sources on one NVIDIA GPU, in one process.

    python3 oa_ab.py LABEL=path.cu [LABEL=path.cu ...]

Each source must have the C interface of
``audio_suite_torch/kernels/overlap_add.cu`` (``oa_launch``,
``oa_error_string``); the port's own source joins as ``port``.  Each is
built with the port's nvcc flags into the git-ignored ``kernels/_build/``,
checked bit-equal to the plain overlap-add at the full-size Microsound
config-3 shapes, with the render's starts and with as many starts evenly
spaced, and timed on each in turns (A B .. B A, ROUNDS times), warm and
with the L2 flushed before each call, as ``chip_smoke.py`` times a
kernel; beside them PyTorch's copy of the windows as a yardstick.  Prints
ptxas's register and shared-memory use of each source, the events that
cover each output tile, and one JSON line of times.  Imports nothing of
JAX or of the JAX package.
"""
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs

ROUNDS = 3


def build(label: str, src: str):
    """(library, ptxas summary) of ``src`` built as ``ab_<label>.so``."""
    from audio_suite_torch import kernels
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, f"ab_{label}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.oa_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, p]
    lib.oa_launch.restype = ctypes.c_int
    lib.oa_error_string.argtypes = [ctypes.c_int]
    lib.oa_error_string.restype = ctypes.c_char_p
    ptxas = " | ".join(ln.split(":", 1)[-1].strip()
                       for ln in proc.stderr.splitlines()
                       if "registers" in ln or "spill" in ln)
    return lib, ptxas


def tile_hits(starts, Lw: int, N: int, tile: int) -> dict:
    """Events covering each output tile of ``tile`` samples (host
    arithmetic on the clamped windows): the work of one CTA."""
    s = np.clip(starts.cpu().numpy().astype(np.int64), 0, N - Lw)
    tiles = -(-N // tile)
    hits = np.zeros(tiles + 1, np.int64)
    np.add.at(hits, s // tile, 1)
    np.add.at(hits, (s + Lw - 1) // tile + 1, -1)
    hits = np.cumsum(hits)[:tiles]
    return {"tiles": tiles, "mean": float(hits.mean()),
            "max": int(hits.max()), "at_least_20": int((hits >= 20).sum()),
            "empty": int((hits == 0).sum())}


def main() -> int:
    if not torch.cuda.is_available():
        print("oa_ab: no CUDA device", file=sys.stderr)
        return 1
    from audio_suite_torch.kernels import KERNEL_DIR
    from audio_suite_torch.ops import overlap_add as oa
    srcs = {"port": os.path.join(KERNEL_DIR, "overlap_add.cu")}
    srcs.update(arg.split("=", 1) for arg in sys.argv[1:])
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build, srcs, srcs.values())))
    for k, (_, ptxas) in built.items():
        print(f"ptxas {k}: {ptxas}", flush=True)

    dev = torch.device("cuda", 0)
    E, Lw, N, starts, vals, base = cs.config3_oa_inputs(dev)
    # the render's starts, and the same count evenly spaced: without the
    # padding stack (18 events at one start), to show what the stack costs
    layouts = {"config3": starts,
               "even": torch.linspace(0, N - Lw, E, device=dev).int()}

    def launch(lib, out, st):
        rc = lib.oa_launch(vals.data_ptr(), st.data_ptr(), out.data_ptr(),
                           E, Lw, N, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(lib.oa_error_string(rc).decode())
        return out

    bound, bound_by = cs.bound_ms(4 * (vals.numel() + E + 2 * N),
                                  vals.numel())
    rows = {}
    for name, st in layouts.items():
        want = oa.overlap_add_plain(base.clone(), vals, st)
        for k, (lib, _) in built.items():
            got = launch(lib, base.clone(), st)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{k} differs from the plain version on {name}: max "
                    f"|err| {(got - want).abs().max().item()}")
        warm = {k: [] for k in built}
        cold = {k: [] for k in built}
        for k in (list(built) + list(built)[::-1]) * ROUNDS:
            fn = functools.partial(launch, built[k][0], base.clone(), st)
            warm[k].append(cs.kernel_ms(fn, cs.TIMED_KERNEL_RUNS,
                                        cs.KERNEL_LAUNCHES))
            cold[k].append(cs.flushed_ms(fn, cs.KERNEL_LAUNCHES))
        rows[name] = {k: {"warm_ms": statistics.median(warm[k]),
                          "l2_flushed_ms": statistics.median(cold[k]),
                          "share_of_bound_l2_flushed":
                              bound / statistics.median(cold[k]),
                          "warm_ms_in_turns": warm[k],
                          "l2_flushed_ms_in_turns": cold[k]}
                      for k in built}
        print(f"every source bit-equal to plain on {name} (E {E} Lw {Lw} "
              f"N {N}); hits per tile of 1024 / 2048 samples: "
              f"{tile_hits(st, Lw, N, 1024)} / {tile_hits(st, Lw, N, 2048)}",
              flush=True)
    # yardstick: PyTorch's copy of the windows, a plain stream of their
    # bytes, so the kernels' shares can be read against what one such call
    # reaches at this size
    dst = torch.empty_like(vals)
    copy = {"warm_ms": cs.kernel_ms(lambda: dst.copy_(vals),
                                    cs.TIMED_KERNEL_RUNS, cs.KERNEL_LAUNCHES),
            "l2_flushed_ms": cs.flushed_ms(lambda: dst.copy_(vals),
                                           cs.KERNEL_LAUNCHES),
            "bound_ms": cs.bound_ms(2 * vals.nbytes, 0)[0]}
    print(json.dumps({"oa_ab": rows, "windows_copy": copy, "E": E,
                      "Lw": Lw, "N": N, "bound_ms": bound,
                      "bound_by": bound_by,
                      "card": cs.smi("name,power.limit")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

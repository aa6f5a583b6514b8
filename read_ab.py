#!/usr/bin/env python3
"""A/B of scrub-read kernel designs on one NVIDIA GPU, in one process.

    python3 read_ab.py [LABEL=path.cu ...]

The port's own source (``audio_suite_torch/kernels/lerp_read.cu``) joins
as ``port``, its fused scrub read (the multi-head read, envelope and PCM16
in one kernel).  A source given on the command line (an edited copy of
the port's, written into the git-ignored ``_local/``) joins with the same
``sr_launch`` interface as one more fused design; one with the earlier
``hr_launch`` interface (the unfused multi-head read, e.g. ``git show
be0b9ac:audio_suite_torch/kernels/lerp_read.cu``) joins as a baseline: its
read, then the render's PyTorch tail ``models.scrub._finish`` (envelope
and PCM16).

Each source is built with the port's nvcc flags into the git-ignored
``kernels/_build/`` (``chip_smoke.build_ab``); each design is checked
bit-equal to the plain fused version (``ops.lerp_read.scrub_read_plain``)
at the full-size bench config 2 positions (``chip_smoke.config2_positions``)
in the render's form A, in PCM16 and f32, and timed in turns, warm and
with the L2 flushed (``chip_smoke.in_turns``); beside them the timing
protocol's floor (an empty ``torch.cuda._sleep(0)`` timed the same ways).
Prints ptxas's registers of each source; where ``ncu`` runs, one profile
of the port's design (DRAM throughput, achieved occupancy, warp stall
reasons), else why not; and one JSON line of times.  Imports nothing of
JAX or of the JAX package.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs

ROUNDS = 3
OUTS = {"pcm16": torch.int16, "f32": torch.float32}


def build(label: str, src: str):
    """(library, interface, ptxas summary) of ``src`` built as
    ``ab_read_<label>.so``; the interface is "sr" (fused) or "hr" (the
    unfused read)."""
    lib, ptxas = cs.build_ab(f"ab_read_{label}", src)
    p, i = ctypes.c_void_p, ctypes.c_int
    heads = ctypes.POINTER(ctypes.c_int)
    if hasattr(lib, "sr_launch"):
        kind = "sr"
        lib.sr_launch.argtypes = [p, i, p, p, p, i, p, i, ctypes.c_longlong,
                                  ctypes.c_longlong, i, heads, heads, i,
                                  ctypes.c_float, p]
        lib.sr_launch.restype = i
    else:
        kind = "hr"
        lib.hr_launch.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, heads,
                                  heads, i, ctypes.c_float, p]
        lib.hr_launch.restype = i
    lib.lr_error_string.argtypes = [i]
    lib.lr_error_string.restype = ctypes.c_char_p
    return lib, kind, ptxas


def inputs(dev):
    """Config 2's read at full size: the tape, positions, envelope and the
    one head layout."""
    prog, dp, whole, frac = cs.config2_positions(dev)
    seg = prog["head_segments"][0]
    return {"a": dp["audio"], "whole": whole, "frac": frac,
            "env": dp["env_blocks"], "bs": prog["block_size"],
            "ow": [int(v) for v in seg["off_whole"]],
            "of": [int(v) for v in seg["off_frac"]],
            "gain": float(seg["gain"]), "T": whole.numel()}


def designs(built: dict, x: dict) -> dict:
    """label -> fn(out) that computes the read into (or, the unfused
    baseline, as) a render buffer like ``out``."""
    from audio_suite_torch.models import scrub
    heads = ctypes.c_int * len(x["ow"])
    ow, of = heads(*x["ow"]), heads(*x["of"])

    def check(lib, rc):
        if rc != 0:
            raise RuntimeError(lib.lr_error_string(rc).decode())

    def fused(lib):
        def fn(out):
            check(lib, lib.sr_launch(
                x["a"].data_ptr(), x["a"].numel(), x["whole"].data_ptr(),
                x["frac"].data_ptr(), x["env"].data_ptr(), x["bs"],
                out.data_ptr(), int(out.dtype == torch.int16), 0, x["T"],
                len(x["ow"]), ow, of, 1, x["gain"],
                torch.cuda.current_stream().cuda_stream))
            return out
        return fn

    def unfused(lib):
        def fn(out):
            buf = torch.empty(x["T"], device=out.device)
            check(lib, lib.hr_launch(
                x["a"].data_ptr(), x["whole"].data_ptr(),
                x["frac"].data_ptr(), buf.data_ptr(), x["T"],
                x["a"].numel(), len(x["ow"]), ow, of, 1, x["gain"],
                torch.cuda.current_stream().cuda_stream))
            return scrub._finish(buf, x["env"], x["bs"],
                                 out.dtype == torch.int16)
        return fn

    return {label + ("+_finish" if kind == "hr" else ""):
            unfused(lib) if kind == "hr" else fused(lib)
            for label, (lib, kind, _) in built.items()}


def ncu_profile() -> str:
    """One ncu profile of the port's design at config 2 (PCM16), or why
    there is none."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(ncu):
        return "ncu: not found; no profile"
    try:
        proc = subprocess.run(
            [ncu, "--kernel-name", "regex:scrub_read_kernel",
             "--launch-count", "1", "--section", "SpeedOfLight",
             "--section", "Occupancy", "--section", "WarpStateStats",
             sys.executable, os.path.abspath(__file__), "--ncu-child"],
            capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return "ncu: timed out after 300 s; no profile"
    text = proc.stdout + proc.stderr
    if proc.returncode != 0 or "scrub_read_kernel" not in text:
        tail = " | ".join(text.strip().splitlines()[-4:])
        return f"ncu: did not profile the kernel (rc {proc.returncode}): {tail}"
    keep = ("DRAM Throughput", "Memory Throughput", "Duration",
            "Achieved Occupancy", "Theoretical Occupancy", "Registers",
            "Stall", "stall", "Warp Cycles")
    return "\n".join("ncu: " + ln.strip() for ln in text.splitlines()
                     if any(k in ln for k in keep))


def ncu_child() -> int:
    """Launch the port's design once at config 2, for ncu to profile."""
    from audio_suite_torch import kernels
    x = inputs(torch.device("cuda", 0))
    out = torch.empty(x["T"], dtype=torch.int16, device="cuda")
    kernels.scrub_read(x["a"], x["whole"], x["frac"], x["ow"], x["of"],
                       x["gain"], True, x["env"], x["bs"], out, 0, x["T"])
    torch.cuda.synchronize()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("read_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, cs.REPO)
    if sys.argv[1:] == ["--ncu-child"]:
        return ncu_child()
    from audio_suite_torch.kernels import KERNEL_DIR
    from audio_suite_torch.ops import lerp_read as lr
    srcs = {"port": os.path.join(KERNEL_DIR, "lerp_read.cu")}
    srcs.update(arg.split("=", 1) for arg in sys.argv[1:])
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build, srcs, srcs.values())))
    for k, (_, kind, ptxas) in built.items():
        for row in ptxas:
            print(f"ptxas {k} ({kind}_launch): {row}", flush=True)

    dev = torch.device("cuda", 0)
    x = inputs(dev)
    fns = designs(built, x)
    rows, bounds = {}, {}
    for label, dtype in OUTS.items():
        want = lr.scrub_read_plain(x["a"], x["whole"], x["frac"], x["ow"],
                                   x["of"], x["gain"], True, x["env"],
                                   x["bs"], torch.empty(x["T"], dtype=dtype,
                                                        device=dev))
        out = torch.empty_like(want)
        for k, fn in fns.items():
            got = fn(torch.full_like(want, 7))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{k} differs from the plain fused read ({label}): max "
                    f"|err| {(got.float() - want.float()).abs().max().item()}")
        nbytes = (x["a"].nbytes + x["whole"].nbytes + x["frac"].nbytes
                  + x["env"].nbytes + out.nbytes)
        bounds[label] = cs.bound_ms(nbytes, 0)[0]
        rows[label] = cs.in_turns(
            {k: (lambda fn=fn: fn(out)) for k, fn in fns.items()}, ROUNDS,
            bounds[label])
        print(f"every design bit-equal to the plain fused read ({label}, "
              f"{nbytes / 1e6:.2f} MB, bound {bounds[label]:.4f} ms):",
              flush=True)
        for k, r in rows[label].items():
            print(f"  {k}: warm {r['warm_ms']:.4f} ms "
                  f"({r['share_of_bound_warm']:.1%}), L2 flushed "
                  f"{r['l2_flushed_ms']:.4f} ms "
                  f"({r['share_of_bound_l2_flushed']:.1%})", flush=True)
    floor = {"warm_ms": cs.kernel_ms(lambda: torch.cuda._sleep(0),
                                     cs.TIMED_KERNEL_RUNS, cs.KERNEL_LAUNCHES),
             "l2_flushed_ms": cs.flushed_ms(lambda: torch.cuda._sleep(0),
                                            cs.KERNEL_LAUNCHES)}
    print(ncu_profile(), flush=True)
    print(json.dumps({"read_ab": rows, "floor": floor, "bound_ms": bounds,
                      "n": x["a"].numel(), "T": x["T"], "heads": x["ow"],
                      "card": cs.smi("name,power.limit")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives audio_suite_torch's main path — the Microsound render of the bench's
high-rate transient-field configuration (bench.py:343-354: 192 kHz, 4 s,
270 noise-burst grains, x100 time unfold, x4 spectral stretch, seeded IR) —
at full size on the card, in phases; any failure raises and the exit code
is non-zero:

1. probe: a CUDA device is required (there is no CPU fallback);
2. build every kernel of the path from the sources in this checkout;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the render gives it: bit-equal, timed with CUDA events;
4. the render through ``models.microsound.render`` with every kernel
   launch counted; output checks; the float render bit-equal to one made
   with the plain overlap-add; the port's smoke-size render on the card
   within -100 dBFS of the same render on the CPU;
5. timing: median wall time of renders and device time of the grain
   chain + FX, beside the card's name and power limit.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the card's name and power limit from nvidia-smi, and
the one before that the kernels' table as JSON.  Imports no JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SECONDS = 4.0          # audio length of the full-size render
TIMED_RENDERS = 7
TIMED_KERNEL_RUNS = 20


def config3(full: bool):
    """bench.py:343-354 (``full``: _SMOKE off) and its seeded IR."""
    from audio_suite_torch.models import microsound as ms
    sr, seconds = (192000, SECONDS) if full else (48000, 0.5)
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192) * np.exp(-np.arange(8192) / 800.0)) \
        .astype(np.float32)
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=sr, out_dur_s=seconds, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
        max_grains=400 if full else 24, partial_stretch=4.0,
        bandlimit_on=True, bandlimit_out_hz=18000.0,
        bandlimit_roll_hz=2500.0, er_cloud_on=True, space_ir_on=True,
        stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
        bp_stretch="", seed=5))
    return p, ir


def cuda_ms(fn, runs: int) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run."""
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    # ---- 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from audio_suite_torch import kernels
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import overlap_add as oa

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    card = f"[{smi}]"
    print(f"probe: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} {card}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    so = kernels.build("overlap_add")
    print(f"build: overlap_add.cu -> {os.path.relpath(so, REPO)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain at the render's OA shapes
    p, ir = config3(full=True)
    prog = ms.build_program(p, ir_audio=ir)
    ec = ms._event_chunk(prog["E"], prog["L"])
    cfg = ms.chain_cfg(p, prog)
    (chunk,) = ms._chunk_events(prog, ec)
    E, Lw = ec, cfg.oa_win
    N = oa.ring_out_len(prog["out_n"], prog["L"])
    starts = torch.tensor(chunk["oa_start"], device=dev)
    rng = np.random.default_rng(3)
    vals = torch.tensor(rng.standard_normal((E, Lw)).astype(np.float32),
                        device=dev)
    base = torch.tensor(rng.standard_normal(N).astype(np.float32),
                        device=dev)
    assert bool((starts[1:] < starts[:-1]).any()), "starts are sorted"
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    got = kernels.overlap_add(base.clone(), vals, starts)
    torch.cuda.synchronize()
    oa_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"overlap_add kernel differs from its plain "
                             f"version: max |err| {oa_err}")
    buf = base.clone()
    kernel_ms = cuda_ms(lambda: kernels.overlap_add(buf, vals, starts),
                        TIMED_KERNEL_RUNS)
    plain_ms = cuda_ms(lambda: oa.overlap_add_plain(buf, vals, starts),
                       TIMED_KERNEL_RUNS)
    print(f"overlap_add: E {E} Lw {Lw} N {N}: bit-equal to plain; "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {TIMED_KERNEL_RUNS}) {card}", flush=True)

    # ---- 4. the main path, every launch counted
    kernels.overlap_add.launches = 0
    y16, meta = ms.render(p, ir_audio=ir, device=dev, pcm16=True)
    torch.cuda.synchronize()
    launches = {"overlap_add": kernels.overlap_add.launches}
    out_n = int(round(SECONDS * p.base_sr))
    if tuple(y16.shape) != (out_n, 2) or y16.dtype != torch.int16:
        raise AssertionError(f"render gave {tuple(y16.shape)} {y16.dtype}")
    peak16 = int(y16.abs().max())
    if peak16 < 1000:
        raise AssertionError(f"render is near silent: peak {peak16}")
    if launches["overlap_add"] < 1:
        raise AssertionError("the render did not launch the overlap_add "
                             "kernel")
    print(f"render: {meta['events']} events -> {tuple(y16.shape)} int16, "
          f"peak {peak16}; kernel launches {launches}", flush=True)

    y_kernel, _ = ms.render(p, ir_audio=ir, device=dev)
    with mock.patch.object(oa, "overlap_add", oa.overlap_add_plain):
        y_plain, _ = ms.render(p, ir_audio=ir, device=dev)
    if not torch.equal(y_kernel, y_plain):
        raise AssertionError("float render with the kernel differs from the "
                             "render with the plain overlap-add")
    if not bool(torch.isfinite(y_kernel).all()):
        raise AssertionError("non-finite samples in the float render")
    ps, irs = config3(full=False)
    ys_gpu, _ = ms.render(ps, ir_audio=irs, device=dev)
    ys_cpu, _ = ms.render(ps, ir_audio=irs, device="cpu")
    dev_db = 20 * np.log10(max((ys_gpu.cpu().double() - ys_cpu.double())
                               .abs().max().item(), 1e-300))
    if dev_db > -100.0:
        raise AssertionError(f"smoke render on the card is {dev_db:.1f} "
                             "dBFS from the CPU render")
    print(f"check: float render bit-equal with plain OA; smoke render "
          f"card vs CPU {dev_db:.2f} dBFS", flush=True)

    # ---- 5. timing
    walls = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        y, _ = ms.render(p, ir_audio=ir, device=dev, pcm16=True)
        y.cpu()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    er_kernel, ir_kernel, _ = ms._space_kernels(p, ir)
    kern = ms.program_to_device({"er": er_kernel, "ir": ir_kernel}, dev)
    fx = ms.fx_cfg(p, prog["out_n"], True, True)
    chunk_dev = ms.program_to_device(chunk, dev)
    full_ms = cuda_ms(lambda: ms.render_device(cfg, fx, [chunk_dev],
                                               kern["er"], kern["ir"]),
                      TIMED_RENDERS)
    buf = torch.zeros(N, device=dev)
    chain_ms = cuda_ms(lambda: ms.chunk_body(cfg, chunk_dev, buf),
                       TIMED_RENDERS)
    audio = buf[cfg.L: cfg.L + prog["out_n"]].contiguous()
    fx_ms = cuda_ms(lambda: ms.fx_body(fx, audio, kern["er"], kern["ir"]),
                    TIMED_RENDERS)
    print(f"timing: render wall median {wall * 1e3:.2f} ms of "
          f"{TIMED_RENDERS} (incl. host build and pull) -> realtime "
          f"x{SECONDS / wall:.1f}; device: grain chain + OA + FX "
          f"{full_ms:.3f} ms (chain + OA {chain_ms:.3f} ms, FX "
          f"{fx_ms:.3f} ms) {card}", flush=True)

    table = {"kernels": [{
        "name": "overlap_add", "route": "cuda",
        "source": "audio_suite_torch/kernels/overlap_add.cu",
        "replaces": "audio_suite_tpu/ops/pallas_oa.py:153",
        "launches": launches["overlap_add"], "max_abs_err": oa_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

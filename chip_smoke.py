#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives audio_suite_torch's two ported paths at full size on the card, in
phases; any failure raises and the exit code is non-zero.  The paths:

- Microsound: the bench's high-rate transient-field configuration
  (bench.py:343-354: 192 kHz, 4 s, 270 noise-burst grains, x100 time
  unfold, x4 spectral stretch, seeded IR);
- tape: bench config 1 (bench.py:157-265: a 180 s 48 kHz tape chopped into
  six sections at mixed speeds, three reversed, retimed to 180 s; 8 745 204
  output frames), the default device render.

Phases:

1. probe: a CUDA device is required (there is no CPU fallback);
2. build every kernel of both paths from the sources in this checkout, one
   nvcc per source, all started together;
3. Microsound: the overlap-add kernel against its plain PyTorch version at
   the render's shapes (bit-equal, timed with CUDA events); the render
   through ``models.microsound.render`` with every kernel launch counted;
   output checks; the float render bit-equal to one made with the plain
   overlap-add; the smoke-size render on the card within -100 dBFS of the
   same render on the CPU; timing;
4. tape: the lerp-read kernel against its plain version at the full-size
   render's own positions (bit-equal, timed); the render through
   ``models.tape.render_tape`` and ``tape_table_render(out_i16=True)``
   with every kernel launch counted; output checks; the float render
   bit-equal to one made with the plain read; the smoke-size render on
   the card within -120 dBFS of the same render on the CPU; timing of the
   bench's protocol (cached program, PCM16 render, pull, host stereo
   duplication), the render's device time and a fresh-program render.

Every kernel's launch count is set to 0 just before a path is driven and
read just after it.

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
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SECONDS = 4.0          # audio length of the full-size render
TIMED_RENDERS = 7
TIMED_KERNEL_RUNS = 20
KERNELS = ("overlap_add", "lerp_read")
TAPE_SECONDS = 180.0   # bench config 1's tape and target length
TAPE_FRAMES = 8745204  # its output frames after the retime


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


def config1(seconds: float):
    """bench.py:157-265 (``seconds`` 180: _SMOKE off; 4: its smoke size):
    the bench's tape (bench.py:_test_audio), params and output frames."""
    from audio_suite_torch.models import tape
    sr = 48000
    rng = np.random.default_rng(7)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    audio = (x / np.max(np.abs(x))).astype(np.float32)
    n = len(audio)
    p = tape.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.12, 0.3, 0.45,
                                                      0.6, 0.8)],
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    p.section_speeds = tape.fit_to_target_time(p, n, seconds)
    return audio, p, tape.section_render_length(p, n)


def reset_counts():
    from audio_suite_torch import kernels
    for k in KERNELS:
        getattr(kernels, k).launches = 0


def read_counts() -> dict:
    from audio_suite_torch import kernels
    return {k: getattr(kernels, k).launches for k in KERNELS}


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


def microsound_path(dev, card: str) -> dict:
    """Phase 3: the Microsound config-3 path; returns its kernel row."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import overlap_add as oa

    # kernel vs plain at the render's OA shapes
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

    # the main path, every launch counted
    reset_counts()
    y16, meta = ms.render(p, ir_audio=ir, device=dev, pcm16=True)
    torch.cuda.synchronize()
    launches = read_counts()
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

    # timing
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

    return {"name": "overlap_add", "route": "cuda",
            "source": "audio_suite_torch/kernels/overlap_add.cu",
            "replaces": "audio_suite_tpu/ops/pallas_oa.py:153",
            "launches": launches["overlap_add"], "max_abs_err": oa_err,
            "ms": kernel_ms, "plain_ms": plain_ms}


def tape_path(dev, card: str) -> dict:
    """Phase 4: the tape config-1 path; returns its kernel row."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import tape
    from audio_suite_torch.ops import lerp_read as lr
    from audio_suite_torch.ops import varispeed
    from audio_suite_torch.utils import native_rt

    audio, p, frames = config1(TAPE_SECONDS)
    if frames != TAPE_FRAMES:
        raise AssertionError(f"config 1 renders {frames} frames")
    sr = p.sample_rate
    adev = torch.as_tensor(audio, device=dev)     # the tape, loaded once
    prog = tape.build_tape_program(adev, p, frames, device=dev)
    # the shared C++ host runtime: g++ builds it on a fresh checkout, kept
    # out of the table walk's time
    t0 = time.perf_counter()
    native_rt.get_lib()
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = tape.program_tables(prog)
    walk_s = time.perf_counter() - t0
    sizes = {k: len(tables[k]) for k in ("visit_start", "run_start",
                                         "triggers")}
    print(f"tape: n {len(audio)} -> T {frames}; host runtime ready in "
          f"{lib_s:.2f} s; tables {sizes}, C++ walk {walk_s * 1e3:.1f} ms",
          flush=True)

    # kernel vs plain at the full-size render's own positions
    idx0, fr, gain = varispeed.tape_positions(
        tape.device_tables(prog), prog["consts"], len(audio), frames)
    want = lr.lerp_read_plain(adev, idx0, fr)
    got = kernels.lerp_read(adev, idx0, fr)
    torch.cuda.synchronize()
    lr_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"lerp_read kernel differs from its plain "
                             f"version: max |err| {lr_err}")
    kernel_ms = cuda_ms(lambda: kernels.lerp_read(adev, idx0, fr),
                        TIMED_KERNEL_RUNS)
    plain_ms = cuda_ms(lambda: lr.lerp_read_plain(adev, idx0, fr),
                       TIMED_KERNEL_RUNS)
    print(f"lerp_read: n {len(audio)} T {frames}: bit-equal to plain; "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {TIMED_KERNEL_RUNS}) {card}", flush=True)

    # the main path, every launch counted: the default render and the
    # bench's PCM16 render of the cached program
    reset_counts()
    y = tape.render_tape(adev, p, device=dev)
    cached = tape.build_tape_program_cached(adev, p, frames, device=dev)
    y16, final = tape.tape_table_render(cached, out_i16=True)
    launches = read_counts()
    if y.shape != (frames,) or y.dtype != np.float32:
        raise AssertionError(f"render gave {y.shape} {y.dtype}")
    if y16.shape != (frames,) or y16.dtype != np.int16:
        raise AssertionError(f"PCM16 render gave {y16.shape} {y16.dtype}")
    if not np.isfinite(y).all() or np.abs(y).max() > 1.0:
        raise AssertionError("non-finite or unclipped samples")
    peak16 = int(np.abs(y16.astype(np.int32)).max())
    if peak16 < 10000:
        raise AssertionError(f"render is near silent: peak {peak16}")
    lsb = int(np.abs(np.rint(y.astype(np.float64) * 32768.0).clip(
        -32768, 32767) - y16).max())
    if lsb != 0:
        raise AssertionError(f"PCM16 render is {lsb} LSB from the float one")
    if launches["lerp_read"] < 1:
        raise AssertionError("the render did not launch the lerp_read "
                             "kernel")
    print(f"render: {frames} frames f32 peak {np.abs(y).max():.4f}, PCM16 "
          f"peak {peak16}; final {final}; kernel launches {launches}",
          flush=True)

    y_kernel, _ = tape.tape_table_render(prog, device_out=True)
    with mock.patch.object(varispeed, "lerp_read", lr.lerp_read_plain):
        y_plain, _ = tape.tape_table_render(prog, device_out=True)
    if not torch.equal(y_kernel, y_plain):
        raise AssertionError("float render with the kernel differs from the "
                             "render with the plain read")
    a_s, p_s, f_s = config1(4.0)
    ys_gpu = tape.render_tape(a_s, p_s, f_s, device=dev)
    ys_cpu = tape.render_tape(a_s, p_s, f_s, device="cpu")
    dmax = np.abs(ys_gpu.astype(np.float64) - ys_cpu).max()
    dev_db = 20 * np.log10(max(dmax, 1e-300))
    if dev_db > -120.0:
        raise AssertionError(f"smoke render on the card is {dev_db:.1f} "
                             "dBFS from the CPU render")
    print(f"check: float render bit-equal with the plain read; smoke "
          f"render card vs CPU {dev_db:.2f} dBFS (bit-equal: "
          f"{bool(np.array_equal(ys_gpu, ys_cpu))})", flush=True)

    # timing: the bench's run() (bench.py:196-203), the render's device
    # time, and one fresh program (table walk included)
    def run():
        prg = tape.build_tape_program_cached(adev, p, frames, device=dev)
        mono = tape.tape_table_render(prg, out_i16=True)[0]
        return np.repeat(mono[:, None], 2, axis=1)

    walls = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    device_ms = cuda_ms(lambda: tape.tape_table_render(
        cached, out_i16=True, device_out=True), TIMED_RENDERS)
    t0 = time.perf_counter()
    fresh = tape.build_tape_program(adev, p, frames, device=dev)
    np.repeat(tape.tape_table_render(fresh, out_i16=True)[0][:, None], 2,
              axis=1)
    fresh_s = time.perf_counter() - t0
    print(f"timing: bench run() wall median {wall * 1e3:.2f} ms of "
          f"{TIMED_RENDERS} (cached program, PCM16 render, pull, host "
          f"stereo) -> realtime x{frames / sr / wall:.1f}; device "
          f"{device_ms:.3f} ms; fresh program {fresh_s * 1e3:.2f} ms "
          f"{card}", flush=True)

    return {"name": "lerp_read", "route": "cuda",
            "source": "audio_suite_torch/kernels/lerp_read.cu",
            "replaces": "audio_suite_tpu/ops/pallas_read.py:94",
            "launches": launches["lerp_read"], "max_abs_err": lr_err,
            "ms": kernel_ms, "plain_ms": plain_ms}


def main() -> int:
    # ---- 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from audio_suite_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    card = f"[{smi}]"
    print(f"probe: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} {card}", flush=True)

    # ---- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(kernels.build, KERNELS)))
    for k, so in built.items():
        print(f"build: {k}.cu -> {os.path.relpath(so, REPO)}", flush=True)
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---- 3., 4. the paths
    rows = [microsound_path(dev, card), tape_path(dev, card)]

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --scan-ab path/to/grain_scan.cu
    python3 chip_smoke.py --tape-scan-ab path/to/tape_scan.cu

The second form builds the kernels, then only holds another grain_scan.cu
(e.g. an earlier commit's, from ``git archive`` into the git-ignored
``_local/``) against the port's at phase 9's two shapes and times the two
in turns (``scan_ab``); a source without the stick-slip kernel that draws
its own noise meets it with its whole path (two ``noise.normal`` draws
and its row kernel).  The third does the same for another tape_scan.cu
at config 1's full size (``tape_scan_ab``): a source whose ``ts_launch``
takes per-sample scratch (idx0, fr, gi), as the one-warp design's does.

Drives audio_suite_torch's ported paths at full size on the card, in
phases; any failure raises and the exit code is non-zero.  The paths:

- Microsound: the bench's high-rate transient-field configuration
  (bench.py:343-354: 192 kHz, 4 s, 270 noise-burst grains, x100 time
  unfold, x4 spectral stretch, seeded IR);
- tape: bench config 1 (bench.py:157-265: a 180 s 48 kHz tape chopped into
  six sections at mixed speeds, three reversed, retimed to 180 s; 8 745 204
  output frames), the default device render;
- Pattern Lab: bench config 4 (bench.py:430-447: 44.1 kHz, 8 s, bpm 128,
  seed 9, the four builtin generators: 333 events, 326 notes in 14
  buckets), rendered through ``models.patternlab.render``;
- scrub: bench config 2 (bench.py:268-292: a 10 s 48 kHz tape scrubbed
  for 30 s by three heads, three drags, a jump; 1 439 744 frames),
  rendered through ``models.scrub.render_scrub``;
- grid: the grid half of bench config 5 (bench.py:502-525: 48 kHz, 16 s,
  four looped tracks of eight py cells from ``examples/cells/``, a
  three-deep mod chain, sync points; 768 000 samples) and
  ``examples/grid_showcase.json`` (44.1 kHz, 12 s, restart cells, a
  non-loop track, normalize), rendered through
  ``models.grid.render_mixdown``;
- config 5 end to end (bench.py:527-541): the grid half, then the Forest
  Fire CA at 220 x 160 (seed 2, ignited at (110, 80)) for 480 steps through
  ``models.forestfire.ForestFireModel.simulate``, then one threshold rule
  over the stats through ``events.rules.WatchEngine.run_stream`` into an
  OSC recorder;
- Microsound, all paths: the reference app's factory settings
  (``MicrosoundParams()``: 48 kHz, 8 s, x25 unfold, 156 events of 1 500
  samples in 2 048) once per generator mode, the option paths at those
  settings (warps, partial lock, resonator and waveguide, multi-band
  unfold, feedback and imprint, breakpoint lanes), and bench config 3 at
  full width through the whole warp chain and in stick-slip mode,
  rendered through ``models.microsound.render``;
- the tape's other paths: bench config 1 with a performance (the 180 s
  tape with tests/test_tape_trace.py's dense trace, its times x60: speed,
  reverse, age, a marker added and removed, inertia, a splice gap, a seek,
  anti-click and a retime; 13 segments) through
  ``models.tape.render_tape_trace``, and config 1 through
  ``render_tape``'s segment and scan engines;
- the parallel layer: config 3 as a batch of two seeds x two stretches
  through ``models.microsound.batch_render`` (and a stick-slip batch),
  the Forest Fire CA at 220 x 160 row-sharded over one card repeated 4
  and 8 times through ``parallel.ca.simulate_sharded``, a time-sharded
  FIR convolution at config 3's length through
  ``parallel.timeline.sharded_fir_conv``, the engine dry run
  ``parallel.dryrun.dryrun_multichip`` and the multi-process self-test of
  ``parallel.distributed``.

Phases:

1. probe: a CUDA device is required (there is no CPU fallback);
2. build every kernel of the paths from the sources in this checkout, one
   nvcc per source, all started together;
3. Microsound: the overlap-add kernel against its plain PyTorch version at
   the render's shapes (bit-equal), timed beside the plain version and the
   one-call yardstick ``index_add_``, with its bound; the render
   through ``models.microsound.render`` with every kernel launch counted;
   output checks; the float render bit-equal to one made with the plain
   overlap-add; the smoke-size render on the card within -100 dBFS of the
   same render on the CPU; timing;
4. tape: the lerp-read kernel against its plain version at the full-size
   render's own positions (bit-equal, timed, with its bound; no one
   PyTorch call computes the read); the render through
   ``models.tape.render_tape`` and ``tape_table_render(out_i16=True)``
   with every kernel launch counted; output checks; the float render
   bit-equal to one made with the plain read; the smoke-size render on
   the card within -120 dBFS of the same render on the CPU; timing of the
   bench's protocol (cached program, PCM16 render, pull, host stereo
   duplication), the render's device time and a fresh-program render;
5. Pattern Lab: the overlap-add kernel against its plain version at
   config 4's largest bucket (E 62, Lw 32 768, N 385 568, the render's own
   starts; bit-equal, timed with its bound, the plain version and
   ``index_add_``); the render with every launch counted (one overlap-add
   per bucket: 14); output checks; the float render bit-equal to one made
   with the plain overlap-add; the smoke-size render (2 s) on the card
   within -100 dBFS of the same render on the CPU; timing of the bench's
   ``run()`` (memoized prepare, PCM16 render, pull), the render's device
   time, a fresh prepare, and one ``torch.profiler`` window (device events
   and device-busy time per render, the top kernels);
6. scrub: the fused scrub-read kernel (``lerp_read.cu``'s wrap-around
   multi-head read with the envelope and PCM16) against its plain version
   at the full-size render's own positions, bit-equal in both forms and
   both outputs, and on a synthetic case that forces its fallbacks
   (positions outside [0, 2n), carries that take the 64-bit mod, a launch
   off the 32-sample grid with a ragged end); timed warm and L2
   flushed in PCM16 and f32 with their bounds, beside the timing
   protocol's floor (an empty ``torch.cuda._sleep(0)`` timed the same
   two ways; no one PyTorch call computes the read); the PCM16 and float
   renders through ``render_scrub`` with every launch counted (one per
   render); output checks; the float render bit-equal to one made with
   the plain read; the smoke size (plain and with the drags and jump
   scaled into it) and the ``scrub_keys`` golden within -120 dBFS of the
   CPU render, the ``scrub_sinc`` golden within -100 dBFS; timing of the
   bench's ``run()`` (cached program, PCM16 render, pull, host stereo),
   the render's device time, a fresh program, and one profiler window;
7. grid: config 5's grid half and the showcase rendered on the card in
   f32 and PCM16 with every hand-kernel launch counted (the path reaches
   none: the grid's gather is a plain one, as ``ROADMAP.md`` says of the
   JAX package's one-hot read), each render bit-equal to the port's CPU
   render and to its host engine; n_total, peaks, restart events and
   resets; timing of the bench ``run()``'s grid half
   (``render_mixdown(project, pcm16=True)`` on a memo hit, pull
   included), the render's device time, a fresh program and prepare, and
   one profiler window, with run()'s memo-hit key and pull timed apart
   and one render run under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync inside a render);
8. config 5 end to end: the bench's ``run()`` (grid mixdown in PCM16,
   ``simulate(480)``, ``run_stream``) once with every hand-kernel launch
   counted (the path reaches none: the JAX CA is one ``jax.jit`` of XLA
   ops); output checks (the stats' shape, step column and cell counts, a
   fire that takes and sends); ``simulate(480)`` on the card from a fresh
   model bit-equal to the port's CPU run in the stats, the state, fuel,
   moisture and age planes and the OSC packets, and the same for
   ``fast_noise`` over 120 steps; the trajectory's figures (burning peak,
   ignitions, embers, rain steps, OSC messages); the step loop of
   ``simulate(4)`` under ``torch.cuda.set_sync_debug_mode("error")``;
   timing of ``run()`` (its grid, CA and rules parts) and of
   ``simulate(480)`` alone from fresh models, 3 calls each, with steps per
   second against the 30 Hz tick; the step loop's device window and one
   profiler window of 10 steps (device events and busy ms per step, top
   kernels), and one of the same steps with the noise draws served from a
   cache (``CachedDraws``): the difference is the draws' share;
9. Microsound, all paths: each ``grain_scan.cu`` entry point (the
   stick-slip recurrence from its noise rows and drawing them itself,
   the micro-chaos recurrence, the waveguide's delay lines) against its
   plain version at the factory size (E 160, L 2 048) and at config 3's
   width (E 288, L 32 768; the waveguide held at its first line there,
   the plain loop being ~100 us of host time a step), bit-equal, timed
   warm and L2 flushed beside its bounds (bytes over the memory rate, the
   dependency chain: steps x dependent f32 ops x 4 cycles at the card's
   maximum SM clock, and for the stick-slip that draws its noise the
   hashes x their SASS instructions, counted from ``cuobjdump -sass``,
   over each class's issue rate) and the plain version, the fused
   stick-slip also beside the unfused path it replaces; the 20 renders
   (11 modes, 7 option paths, 2 at config 3's width) with every launch
   counted (each scan kernel launched on its mode's render; the
   stick-slip renders launch the fused kernel, never the row form, and
   make no torch draw of its noise rows); each render finite, loud, and
   within -100 dBFS of the same render on the CPU;
   per render the wall (median of 3, PCM16, pulled), one profiler
   window's device events and busy ms, and its launches, the two
   stick-slip renders' also on a line of their own; feedback and
   imprint in chunks of 32 bit-equal to the whole render; the
   ``microsound_chaos`` and ``microsound_cepstral`` golden fingerprints
   (tests/test_goldens.py) from the card's renders;
10. the tape's other paths: config 1 with a performance rendered once
   through ``render_tape_trace`` with every launch counted (one
   ``lerp_read`` a segment, 13); output checks; the render bit-equal to
   one made with the plain read; its wall split into the host
   ``build_trace_programs`` and the segments' device window, and its
   realtime factor; the trace on the card within -120 dBFS of the CPU at
   the tests' size (its parity case and its splice-freeze case, which
   takes the piece path); the segment engine at config 1's full size
   within -120 dBFS of the device engine, one ``lerp_read``, and
   bit-equal to itself with the plain read; the scan kernel
   (``kernels/tape_scan.cu``) bit-equal to its plain version at 4 000
   frames of config 1's smoke tape with and without inertia, final state
   equal, at config 1's full size through ``render_tape`` (one launch)
   within -120 dBFS of the segment engine with its final whole, frac and
   speed equal, bit-identical across chunk lengths 256, 1 024 and 4 096
   (samples and state), and bit-equal to its plain version, all five
   state words too, on windows of config 1's full-size program across
   each section change and the wrap, each from the C++ trajectory's
   state there, and on two whose section change falls on the first and
   on the last step of one of the window launch's chunks
   (``scan_windows``; and on a variant with inertia on and section 0
   reversed, whose reads reach (-1, 0)); its time at each chunk length,
   split into its walk (the chunk sums and the walk) and its replay (CUDA
   events between the passes), with
   the chunks jumped and walked, beside its function's bound (bytes and
   f32 operations), its design's own bytes (``scan_design_bytes``) and
   the walk's decisions (``scan_decisions``); the
   same for the inertia variant at full size; and the plain version's
   time a sample;
11. the parallel layer: config 3's batch (seeds 5 and 6 x stretches 4
   and 2, a manifest) with every launch counted (one overlap-add a job),
   each WAV bit-equal to a single render on the card, a second call that
   resumes and renders nothing, a job made to fail (its WAV path a
   directory) marked failed while the others finish, and a stick-slip
   batch of two seeds (``grain_scan.cu``'s fused kernel), each bit-equal
   to its single render; the batch's wall beside the same four jobs
   rendered, pulled and written one after another, in turns; the sharded
   CA on ``[cuda:0] * 4`` (120 steps) and ``* 8`` (40) bit-identical to
   the dense ``simulate`` in the stats and the four planes, with embers
   and fire in several shards, its steps per second beside the dense
   engine's; the timeline conv of 768 000 samples over ``[cuda:0] * 8``
   with config 3's ER (x) IR kernel and one longer than a block, each
   within 1e-5 relative of ``space.fft_convolve_causal``;
   ``dryrun_multichip(4, [cuda:0] * 4)`` with its launches counted (the
   overlap-add, the clamp read and the scrub read); the two-process
   self-test (each rank's jobs on cuda:0, gathered through gloo) and a
   world-size-1 NCCL group's ``all_gather`` of a CUDA tensor, each in
   processes of their own; and the phase's duration.  The batch's and the
   dry run's launches join their kernels' rows under
   ``launches_by_path``.

Every kernel's launch count is set to 0 just before a path is driven and
read just after it.  A kernel is timed twice.  Warm (its ``ms``, the
in-render figure): one CUDA event pair around a run of back-to-back
calls, divided by their count, the median over several runs; nothing is
flushed between the calls, so the L2 stays warm, as in the render, where
the windows of the overlap-add have just been written.  L2 flushed
(``ms_l2_flushed``): a 256 MiB read before each call evicts the L2, and
one event pair around each call; the median.  A plain version is timed
with one event pair per call, the gaps between its launches included.
A kernel's bound is the larger of its bytes (each input read once, each
output written once) over the 3.35 TB/s of device memory and its f32
operations over 67 TFLOP/s; the flushed time is the one that faces that
memory rate.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the card's name and power limit from nvidia-smi, and
the one before that the kernels' table as JSON.  Imports nothing of JAX or
of the JAX package.
"""
import ctypes
import json
import os
import re
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
TIMED_KERNEL_RUNS = 7      # event-pair runs per kernel time (their median)
KERNEL_LAUNCHES = 50       # back-to-back launches per run
SLEEP_CYCLES = 10_000_000  # ~5 ms at the H100's clock: longer than the host
#                            takes to enqueue one run of launches
FLUSH_BYTES = 256 << 20    # read before each L2-flushed call (L2: 50 MB)
HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_S = 67e12         # H100 SXM f32 rate outside the tensor cores
KERNELS = ("overlap_add", "lerp_read", "grain_scan", "tape_scan")  # one
#                                                      nvcc each
# launch-counting wrappers: lerp_read.cu's two kernels and grain_scan.cu's
# four entry points count apart
WRAPPERS = ("overlap_add", "lerp_read", "scrub_read", "stick_slip_scan",
            "stick_slip_noise_scan", "chaos_scan", "waveguide_scan",
            "tape_scan")
TAPE_SECONDS = 180.0   # bench config 1's tape and target length
TAPE_FRAMES = 8745204  # its output frames after the retime
PL_SECONDS = 8.0       # bench config 4's render length
PROFILED_RENDERS = 3   # renders in a profiler window
SCRUB_SECONDS, SCRUB_TAPE = 30.0, 10.0   # bench config 2's render and tape
SCRUB_FRAMES = 1439744  # its output frames: 1 406 blocks of 1 024
GRID_SECONDS = 16.0    # bench config 5's master length
GRID_FRAMES = 768000   # its samples at 48 kHz
FIRE_STEPS = 480       # bench config 5's CA steps: 16 s at the 30 Hz tick
FIRE_FAST_STEPS = 120  # the fast_noise check's steps
FIRE_TICK_HZ = 30.0    # the reference's tick rate (bench.py:534)
TIMED_FIRE = 3         # timed 480-step calls (each takes seconds)
PROFILED_STEPS = 10    # CA steps in the profiler window


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


def bench_audio(sr: int, seconds: float) -> np.ndarray:
    """bench.py:_test_audio."""
    rng = np.random.default_rng(7)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


def config1(seconds: float):
    """bench.py:157-265 (``seconds`` 180: _SMOKE off; 4: its smoke size):
    the bench's tape (bench.py:_test_audio), params and output frames."""
    from audio_suite_torch.models import tape
    sr = 48000
    audio = bench_audio(sr, seconds)
    n = len(audio)
    p = tape.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.12, 0.3, 0.45,
                                                      0.6, 0.8)],
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    p.section_speeds = tape.fit_to_target_time(p, n, seconds)
    return audio, p, tape.section_render_length(p, n)


def config3_oa_inputs(dev):
    """The overlap-add's shapes and starts in the full-size config-3 render
    (one chunk of E events), with seeded random windows and base buffer:
    (E, Lw, N, starts, vals, base)."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import overlap_add as oa
    p, ir = config3(full=True)
    prog = ms.build_program(p, ir_audio=ir)
    E = ms._event_chunk(prog["E"], prog["L"])
    (chunk,) = ms._chunk_events(prog, E)
    Lw = ms.chain_cfg(p, prog).oa_win
    N = oa.ring_out_len(prog["out_n"], prog["L"])
    rng = np.random.default_rng(3)
    return (E, Lw, N, torch.tensor(chunk["oa_start"], device=dev),
            torch.tensor(rng.standard_normal((E, Lw)).astype(np.float32),
                         device=dev),
            torch.tensor(rng.standard_normal(N).astype(np.float32),
                         device=dev))


def config4(seconds: float):
    """bench.py:430-447 (``seconds`` 8: _SMOKE off; 2: its smoke size): the
    four builtin generators' events and the RenderConfig."""
    from audio_suite_torch.models import patternlab as pl
    cfg = pl.RenderConfig(sample_rate=44100, seconds=seconds, bpm=128,
                          seed=9)
    events = [e for g in pl.list_generators() if g != "Python Script"
              for e in pl.generate(g, cfg)]
    return events, cfg


def config2(seconds: float, audio_seconds: float, scale: float = 1.0):
    """bench.py:268-292 (``seconds`` 30 over 10 s of tape: _SMOKE off; 2
    over 2: its smoke size, where ``scale`` 2/30 moves the drags and the
    jump into the 2 s): (audio, cfg, trace)."""
    from audio_suite_torch.models import scrub
    sr = 48000
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=3)
    trace = scrub.scripted_gesture_trace(
        int(seconds * sr / scrub.BLOCK_SIZE), sr,
        drag_events=[(t * scale, dx, d * scale) for t, dx, d in
                     ((2.0, 8.0, 3.0), (10.0, -14.0, 4.0), (20.0, 4.0, 5.0))],
        base_speed=0.5, jumps=[(15.0 * scale, 1000.0)])
    return bench_audio(sr, audio_seconds), cfg, trace


def config5(seconds: float):
    """bench.py:502-525 (``seconds`` 16: _SMOKE off; 4: its smoke size):
    the grid half of bench config 5, a 48 kHz project of four looped
    tracks of eight py cells each from ``examples/cells/``, gain -3 dB per
    track index, tracks 1-3 with sync points at 4.0 and 9.5 s and
    modulated by the track before at amount 0.6."""
    from audio_suite_torch.models import grid
    cells = os.path.join(REPO, "examples", "cells")
    files = ["slow_pulse_pad.py", "euclid_clicks.py", "shard_scatter.py",
             "poly_impulses.py"]
    tracks = []
    for ti in range(4):
        t = grid.Track(name=f"t{ti}", mode="duration",
                       duration_seconds=2.0 + ti, uniform_n=8,
                       loop_to_master=True, gain_db=-3.0 * ti,
                       sync_points_text="4.0, 9.5" if ti else "")
        if ti >= 1:
            t.mod_source_index = ti - 1
            t.mod_amount = 0.6
        t.cells = [grid.CellSource(kind="py",
                                   path=os.path.join(cells, files[ti]))
                   for _ in range(t.uniform_n)]
        tracks.append(t)
    return grid.GridProject(tracks=tracks,
                            master=grid.MasterClock("fixed_seconds", seconds),
                            sample_rate=48000)


def config5_fire(device, fast_noise: bool = False):
    """bench.py:527-533: the second half of bench config 5, the Forest Fire
    CA at its default 220 x 160 (seed 2, ignited at (110, 80), radius 4)
    and one rising-edge rule, burning > 50, on a fixed clock: (model,
    engine, recorder)."""
    from audio_suite_torch.events import rules
    from audio_suite_torch.models import forestfire as ff
    model = ff.ForestFireModel(ff.ModelParams(fast_noise=fast_noise), seed=2,
                               device=device)
    model.ignite_at(110, 80, radius=4)
    eng = rules.WatchEngine(now_fn=lambda: 0.0)
    eng.set_rules([rules.ThresholdRule(metric_key="burning", op=">",
                                       threshold=50, edge="rising",
                                       cooldown_s=0.0)])
    return model, eng, rules.OSCRecorder()


def config2_positions(dev):
    """Bench config 2 at full size on ``dev``: (prog, device program,
    whole, frac), the render's own positions."""
    from audio_suite_torch.models import scrub
    audio, cfg, trace = config2(SCRUB_SECONDS, SCRUB_TAPE)
    prog = scrub.build_scrub_program_cached(audio, cfg, trace)
    dp = scrub.device_program(prog, dev)
    whole, frac = scrub._positions(
        dp["base_inc_q"], dp["js_q"], prog["seed"], prog["mod_consts"],
        dp["jump_flags"], dp["seg_bases_whole"], dp["seg_bases_frac"],
        prog["block_size"])
    return prog, dp, whole, frac


def scrub_golden(name: str):
    """The ``scrub_keys`` and ``scrub_sinc`` golden configurations
    (tests/test_goldens.py:165-183): (audio, cfg, trace, render kwargs)."""
    from audio_suite_torch.models import scrub
    sr = 8000
    t = np.arange(sr * 2) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)
             + 0.25 * np.sin(2 * np.pi * 933 * t)).astype(np.float32)
    if name == "scrub_keys":
        cfg = scrub.ScrubConfig(sample_rate=sr, seed=5, head_count=3)
        trace = scrub.scripted_gesture_trace(
            40, sr, drag_events=[(0.3, 4.0, 0.4)], base_speed=0.5,
            jumps=[(0.9, 3000.0)],
            key_events=[(0.2, "2"), (0.4, "Z"), (0.6, "1"), (0.8, "V"),
                        (1.0, "3"), (1.2, "Down")])
        return audio, cfg, trace, {"tape_pos0": 2000.0}
    cfg = scrub.ScrubConfig(sample_rate=sr, seed=11, head_count=1)
    trace = scrub.scripted_gesture_trace(
        30, sr, drag_events=[(0.4, -6.0, 0.6)], base_speed=0.8)
    return audio, cfg, trace, {"interp": "sinc"}


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` of card 0, as CSV."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def reset_counts():
    from audio_suite_torch import kernels
    for k in WRAPPERS:
        getattr(kernels, k).launches = 0


def read_counts() -> dict:
    from audio_suite_torch import kernels
    return {k: getattr(kernels, k).launches for k in WRAPPERS}


def cuda_ms(fn, runs: int) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run,
    after a warm-up call."""
    fn()
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


def kernel_ms(fn, runs: int, launches: int) -> float:
    """Median device time of one fn() call in ms: one CUDA event pair
    around ``launches`` back-to-back calls, divided by their count, over
    ``runs`` runs after a warm-up call.  A sleep kernel holds the stream
    while the host enqueues each run, so the calls run back to back on the
    card and the time is the kernels', not the host's launch rate.
    Nothing is flushed between the calls, so the L2 stays warm."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def flushed_ms(fn, launches: int) -> float:
    """Median device time of one fn() call in ms with the L2 flushed
    before it: a read of FLUSH_BYTES before each of ``launches`` calls,
    one CUDA event pair around each call, after a warm-up call.  A read
    leaves the L2 holding clean lines, so no write-back of the flush
    lands in the timed call.  A sleep kernel holds the stream while the
    host enqueues them."""
    scratch = torch.ones(FLUSH_BYTES // 4, device="cuda")
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in pairs:
        scratch.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profile_renders(fn, renders: int) -> dict:
    """One ``torch.profiler`` window over ``renders`` calls of fn(): device
    events (kernels, copies, sets) and device-busy ms per call, the union
    of the device events' intervals, and the top kernels by device time.
    Empty if the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(renders):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    by_name: dict = {}
    for e in evs:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"events_per_render": len(evs) / renders,
            "busy_ms_per_render": busy / 1e3 / renders,
            "top": [(name.replace("at::native::", "")[:160],
                     t / 1e3 / renders, c / renders)
                    for name, (t, c) in top]}


def ptxas_summary(so: str) -> list:
    """Each kernel's registers, shared memory and spills, from the
    ``-Xptxas -v`` report that ``kernels.build`` keeps beside the library
    (a mangled name's template arguments shown as <3,1,0>)."""
    with open(so[:-3] + ".log") as f:
        log = f.read()
    rows, entry, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(r"\d+([a-z_]+kernel)(I(?:L[bi]\d+E)+E)?",
                              name)
            entry = name if not short else short.group(1) + (
                "<" + ",".join(re.findall(r"L[bi](\d+)E", short.group(2)))
                + ">" if short.group(2) else "")
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            rows.append(f"{entry}: {ln.split(':', 1)[1].strip()}; {spill}")
    return rows


def build_ab(name: str, src: str):
    """For the A/B scripts (``oa_ab.py``, ``read_ab.py``): ``src`` built
    with the port's nvcc flags into the git-ignored ``kernels/_build/`` as
    ``<name>.so``, with its ptxas report beside it; returns (the ctypes
    library, unbound, and its ``ptxas_summary``)."""
    from audio_suite_torch import kernels
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, name + ".so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    return ctypes.CDLL(so), ptxas_summary(so)


def in_turns(fns: dict, rounds: int, bound: float, runs: int = None,
             launches: int = None) -> dict:
    """For the A/B scripts: each fn() of ``fns`` timed warm (``kernel_ms``)
    and L2 flushed (``flushed_ms``) in turns, A B .. B A, ``rounds`` times
    (``runs`` and ``launches`` default to TIMED_KERNEL_RUNS and
    KERNEL_LAUNCHES); label -> the medians, their shares of the ``bound``
    (ms) and the times in turns."""
    runs = runs or TIMED_KERNEL_RUNS
    launches = launches or KERNEL_LAUNCHES
    warm = {k: [] for k in fns}
    cold = {k: [] for k in fns}
    for k in (list(fns) + list(fns)[::-1]) * rounds:
        warm[k].append(kernel_ms(fns[k], runs, launches))
        cold[k].append(flushed_ms(fns[k], launches))
    rows = {}
    for k in fns:
        w, c = statistics.median(warm[k]), statistics.median(cold[k])
        rows[k] = {"warm_ms": w, "l2_flushed_ms": c,
                   "share_of_bound_warm": bound / w,
                   "share_of_bound_l2_flushed": bound / c,
                   "warm_ms_in_turns": warm[k],
                   "l2_flushed_ms_in_turns": cold[k]}
    return rows


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate (published
    H100 SXM peaks at 700 W)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oa_index(starts, Lw: int, N: int):
    """The flat int64 target index of every window sample, for the
    ``index_add_`` yardstick."""
    s = starts.long().clamp(0, N - Lw)
    return (s[:, None] + torch.arange(Lw, device=s.device)).reshape(-1)


def microsound_path(dev, card: str) -> dict:
    """Phase 3: the Microsound config-3 path; returns its kernel row."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import overlap_add as oa

    # kernel vs plain at the render's OA shapes
    p, ir = config3(full=True)
    prog = ms.build_program(p, ir_audio=ir)
    cfg = ms.chain_cfg(p, prog)
    (chunk,) = ms._chunk_events(prog, ms._event_chunk(prog["E"], prog["L"]))
    E, Lw, N, starts, vals, base = config3_oa_inputs(dev)
    assert bool((starts[1:] < starts[:-1]).any()), "starts are sorted"
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    got = kernels.overlap_add(base.clone(), vals, starts)
    torch.cuda.synchronize()
    oa_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"overlap_add kernel differs from its plain "
                             f"version: max |err| {oa_err}")
    idx = oa_index(starts, Lw, N)
    lib_err = (base.clone().index_add_(0, idx, vals.view(-1)) - want) \
        .abs().max().item()
    # warm: back to back on one buffer, the windows stay in L2, as in the
    # render, where the grain chain has just written them
    buf = base.clone()
    oa_ms = kernel_ms(lambda: kernels.overlap_add(buf, vals, starts),
                      TIMED_KERNEL_RUNS, KERNEL_LAUNCHES)
    cold_ms = flushed_ms(lambda: kernels.overlap_add(buf, vals, starts),
                         KERNEL_LAUNCHES)
    plain_ms = cuda_ms(lambda: oa.overlap_add_plain(buf, vals, starts),
                       TIMED_KERNEL_RUNS)
    library_ms = kernel_ms(lambda: buf.index_add_(0, idx, vals.view(-1)),
                           TIMED_KERNEL_RUNS, KERNEL_LAUNCHES)
    bound, bound_by = bound_ms(4 * (vals.numel() + starts.numel() + 2 * N),
                               vals.numel())
    print(f"overlap_add: E {E} Lw {Lw} N {N}: bit-equal to plain; kernel "
          f"L2 flushed {cold_ms:.4f} ms ({bound / cold_ms:.1%} of its "
          f"{bound:.4f} ms bound by {bound_by} at the memory rate); warm "
          f"{oa_ms:.4f} ms (the in-render figure: the L2 serves part of "
          f"the bytes, so its {bound / oa_ms:.1%} of that bound overstates"
          f"); plain {plain_ms:.4f} ms (one event pair per call); "
          f"index_add_ warm {library_ms:.4f} ms (max |err| vs plain "
          f"{lib_err:.3g}, for information) {card}", flush=True)

    # the main path, every launch counted: one render
    reset_counts()
    y16, meta = ms.render(p, ir_audio=ir, device=dev, pcm16=True)
    torch.cuda.synchronize()
    launches = read_counts()
    renders = 1
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
            "launches": launches["overlap_add"],
            "launches_per_render": launches["overlap_add"] / renders,
            "max_abs_err": oa_err, "ms": oa_ms, "ms_l2_flushed": cold_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


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
    lr_ms = kernel_ms(lambda: kernels.lerp_read(adev, idx0, fr),
                      TIMED_KERNEL_RUNS, KERNEL_LAUNCHES)
    cold_ms = flushed_ms(lambda: kernels.lerp_read(adev, idx0, fr),
                         KERNEL_LAUNCHES)
    plain_ms = cuda_ms(lambda: lr.lerp_read_plain(adev, idx0, fr),
                       TIMED_KERNEL_RUNS)
    T = idx0.numel()
    bound, bound_by = bound_ms(4 * (adev.numel() + 3 * T), 4 * T)
    print(f"lerp_read: n {len(audio)} T {frames}: bit-equal to plain; "
          f"kernel warm {lr_ms:.4f} ms ({bound / lr_ms:.1%} of its "
          f"{bound:.4f} ms bound by {bound_by}), L2 flushed {cold_ms:.4f} "
          f"ms ({bound / cold_ms:.1%}); plain {plain_ms:.4f} ms (one event "
          f"pair per call) {card}", flush=True)
    print("lerp_read: no library time: no one PyTorch call computes the "
          "read (grid_sample wants normalised float32 coordinates, which "
          "cannot address 8.64 M samples to a fraction)", flush=True)

    # the main path, every launch counted: the default render and the
    # bench's PCM16 render of the cached program
    reset_counts()
    y = tape.render_tape(adev, p, device=dev)
    cached = tape.build_tape_program_cached(adev, p, frames, device=dev)
    y16, final = tape.tape_table_render(cached, out_i16=True)
    launches = read_counts()
    renders = 2
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
            "launches": launches["lerp_read"],
            "launches_per_render": launches["lerp_read"] / renders,
            "max_abs_err": lr_err, "ms": lr_ms, "ms_l2_flushed": cold_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def patternlab_path(dev, card: str) -> dict:
    """Phase 5: the Pattern Lab config-4 path; returns the overlap-add's
    figures at config 4's shapes."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import patternlab as pl
    from audio_suite_torch.ops import overlap_add as oa

    events, cfg = config4(PL_SECONDS)
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed,
                                      device=dev)
    ev = pl.apply_time_ops(events, cfg)
    n_total, spec, packs = synth.prepare_np(ev, cfg.seconds)
    N = n_total + max(L for (_p, L, _a, _v, _c) in spec)
    print(f"patternlab: {len(events)} events -> "
          f"{sum(c for (_p, _L, _a, _v, c) in spec)} notes in {len(spec)} "
          f"buckets, n_total {n_total}, OA buffer {N}", flush=True)

    # kernel vs plain at the largest bucket, with the render's own starts
    off, big = {"fmi": 0, "pgi": 0}, None
    for (is_psg, L, _alg, _vib, count) in spec:
        k = "pgi" if is_psg else "fmi"
        if big is None or count * L > big[0] * big[1]:
            big = (count, L, packs[k][off[k]: off[k] + count, 1])
        off[k] += count
    E, Lw, starts = big
    rng = np.random.default_rng(4)
    starts = torch.tensor(starts, device=dev)
    vals = torch.tensor(rng.standard_normal((E, Lw)).astype(np.float32),
                        device=dev)
    base = torch.tensor(rng.standard_normal(N).astype(np.float32),
                        device=dev)
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    got = kernels.overlap_add(base.clone(), vals, starts)
    torch.cuda.synchronize()
    oa_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"overlap_add kernel differs from its plain "
                             f"version at config 4: max |err| {oa_err}")
    idx = oa_index(starts, Lw, N)
    buf = base.clone()
    oa_ms = kernel_ms(lambda: kernels.overlap_add(buf, vals, starts),
                      TIMED_KERNEL_RUNS, KERNEL_LAUNCHES)
    cold_ms = flushed_ms(lambda: kernels.overlap_add(buf, vals, starts),
                         KERNEL_LAUNCHES)
    plain_ms = cuda_ms(lambda: oa.overlap_add_plain(buf, vals, starts),
                       TIMED_KERNEL_RUNS)
    library_ms = kernel_ms(lambda: buf.index_add_(0, idx, vals.view(-1)),
                           TIMED_KERNEL_RUNS, KERNEL_LAUNCHES)
    nbytes = 4 * (vals.numel() + starts.numel() + 2 * N)
    bound, bound_by = bound_ms(nbytes, vals.numel())
    print(f"overlap_add: E {E} Lw {Lw} N {N} ({nbytes / 1e6:.2f} MB): "
          f"bit-equal to plain; kernel L2 flushed {cold_ms:.4f} ms "
          f"({bound / cold_ms:.1%} of its {bound:.4f} ms bound by "
          f"{bound_by}); warm {oa_ms:.4f} ms; plain {plain_ms:.4f} ms "
          f"(one event pair per call); index_add_ warm {library_ms:.4f} ms "
          f"{card}", flush=True)

    # the main path, every launch counted: the bench's render
    reset_counts()
    y16, _ = pl.render(events, cfg, pcm16=True, device=dev)
    launches = read_counts()
    if y16.shape != (n_total,) or y16.dtype != np.int16:
        raise AssertionError(f"render gave {y16.shape} {y16.dtype}")
    peak16 = int(np.abs(y16.astype(np.int32)).max())
    if peak16 < 1000:
        raise AssertionError(f"render is near silent: peak {peak16}")
    if launches["overlap_add"] != len(spec):
        raise AssertionError(f"{launches['overlap_add']} overlap_add "
                             f"launches for {len(spec)} buckets")
    print(f"render: {n_total} samples int16, peak {peak16}; kernel "
          f"launches {launches} ({len(spec)} buckets)", flush=True)

    prep = synth.prepare(ev, cfg.seconds)
    y_kernel = synth.render_prepared(prep, master_gain=cfg.master_gain,
                                     device_out=True)
    with mock.patch.object(oa, "overlap_add", oa.overlap_add_plain):
        y_plain = synth.render_prepared(prep, master_gain=cfg.master_gain,
                                        device_out=True)
    if not torch.equal(y_kernel, y_plain):
        raise AssertionError("float render with the kernel differs from the "
                             "render with the plain overlap-add")
    if not bool(torch.isfinite(y_kernel).all()):
        raise AssertionError("non-finite samples in the float render")
    ev_s, cfg_s = config4(2.0)
    ys_gpu, _ = pl.render(ev_s, cfg_s, device=dev)
    ys_cpu, _ = pl.render(ev_s, cfg_s, device="cpu")
    dmax = np.abs(ys_gpu.astype(np.float64) - ys_cpu).max()
    dev_db = 20 * np.log10(max(dmax, 1e-300))
    if dev_db > -100.0:
        raise AssertionError(f"smoke render on the card is {dev_db:.1f} "
                             "dBFS from the CPU render")
    print(f"check: float render bit-equal with plain OA; smoke render card "
          f"vs CPU {dev_db:.2f} dBFS (bit-equal: "
          f"{bool(np.array_equal(ys_gpu, ys_cpu))})", flush=True)

    # timing: the bench's run() (bench.py:444-447, the prepare memoized),
    # the render's device time, a fresh prepare, one profiler window
    walls = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        pl.render(events, cfg, pcm16=True, device=dev)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    def device_render():
        return synth.render_prepared(prep, master_gain=cfg.master_gain,
                                     device_out=True, pcm16=True)

    device_ms = cuda_ms(device_render, TIMED_RENDERS)
    prep_s = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        synth.prepare(ev, cfg.seconds)
        torch.cuda.synchronize()
        prep_s.append(time.perf_counter() - t0)
    prof = profile_renders(device_render, PROFILED_RENDERS)
    print(f"timing: bench run() wall median {wall * 1e3:.2f} ms of "
          f"{TIMED_RENDERS} (memoized prepare, PCM16 render, pull) -> "
          f"realtime x{cfg.seconds / wall:.1f}; device {device_ms:.3f} ms "
          f"(render_prepared, device_out, pcm16); fresh prepare median "
          f"{statistics.median(prep_s) * 1e3:.2f} ms {card}", flush=True)
    if prof:
        print(f"profile ({PROFILED_RENDERS} renders): "
              f"{prof['events_per_render']:.0f} device events per render, "
              f"device-busy {prof['busy_ms_per_render']:.3f} ms per render "
              f"({prof['busy_ms_per_render'] / device_ms:.1%} of the "
              f"device time) {card}", flush=True)
        for name, t, c in prof["top"]:
            print(f"profile:   {t:.3f} ms {c:.0f}x {name}", flush=True)
    else:
        print("profile: the profiler saw no device event; launches and "
              "busy time not measured", flush=True)

    return {"launches": launches["overlap_add"],
            "launches_per_render": launches["overlap_add"],
            "shape": [E, Lw, N], "max_abs_err": oa_err, "ms": oa_ms,
            "ms_l2_flushed": cold_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


def scrub_fallback_case(dev, n: int, T: int):
    """A synthetic fused read that takes every fallback of the kernel:
    positions spread over [-3n, 3n) (outside [0, 2n): the 32-bit mod),
    form B fractions outside [0, 2**22) (carries other than 0 or 1: the
    64-bit mod), rows one element off the 16-byte grid, a launch that
    starts off the 32-sample grid and ends in a ragged tile, a block size
    of 1 000 (the division, not the shift): (audio, whole, frac, env)."""
    rng = np.random.default_rng(17)
    audio = torch.tensor(rng.uniform(-1, 1, n).astype(np.float32),
                         device=dev)
    raw = torch.tensor(np.stack([
        rng.integers(-3 * n, 3 * n, T + 1),
        rng.integers(-(1 << 27), 1 << 27, T + 1)]).astype(np.int32),
        device=dev)
    env = torch.tensor(rng.choice(np.float32([0.0, 0.65, 1.0, 2.5]),
                                  -(-T // 1000)), device=dev)
    return audio, raw[0, 1:], raw[1, 1:], env


def scrub_path(dev, card: str) -> dict:
    """Phase 6: the scrub config-2 path; returns the fused scrub-read
    kernel's row."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import scrub
    from audio_suite_torch.ops import lerp_read as lr

    audio, cfg, trace = config2(SCRUB_SECONDS, SCRUB_TAPE)
    prog = scrub.build_scrub_program_cached(audio, cfg, trace)
    T, span = prog["num_frames"], scrub.program_span(prog)
    bs = prog["block_size"]
    segs = prog["head_segments"]
    if T != SCRUB_FRAMES or len(segs) != 1:
        raise AssertionError(f"config 2 renders {T} frames in {len(segs)} "
                             "head segments")
    seg = segs[0]
    ow, of, gain = seg["off_whole"].tolist(), seg["off_frac"].tolist(), \
        float(seg["gain"])
    if not scrub.reads_summed(T, len(audio), span, of):
        raise AssertionError("config 2 no longer reads in form A")
    print(f"scrub: n {len(audio)} -> T {T}, span {span}, heads {ow} "
          f"(gain {gain:.4f}), form A (heads summed, one lerp); "
          f"{int(prog['jump_flags'].sum())} jump, "
          f"{int((prog['env_blocks'] < 1).sum())} dropout blocks",
          flush=True)

    # the fused kernel vs its plain version at the full-size render's own
    # positions: both forms, both outputs
    _, dp, whole, frac = config2_positions(dev)
    a, env = dp["audio"], dp["env_blocks"]
    outs = {"pcm16": torch.int16, "f32": torch.float32}

    def fused(dtype, summed, read=kernels.scrub_read):
        return read(a, whole, frac, ow, of, gain, summed, env, bs,
                    torch.empty(T, dtype=dtype, device=dev), 0, T)

    errs = []
    for summed in (True, False):          # A, the render's; B for coverage
        for label, dtype in outs.items():
            want = fused(dtype, summed, lr.scrub_read_plain)
            got = fused(dtype, summed)
            torch.cuda.synchronize()
            errs.append((got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"scrub_read kernel (form {'A' if summed else 'B'}, "
                    f"{label}) differs from its plain version: max |err| "
                    f"{errs[-1]}")
    # the plain version is the unfused read followed by the render's tail
    y = lr.heads_read_plain(a, whole, frac, ow, of, gain, True)
    for label, dtype in outs.items():
        if not torch.equal(scrub._finish(y, env, bs, dtype == torch.int16),
                           fused(dtype, True, lr.scrub_read_plain)):
            raise AssertionError(f"scrub_read_plain ({label}) differs from "
                                 "_finish(heads_read_plain(...))")
    n = a.numel()
    in_2n = bool(((whole >= 0) & (whole < 2 * n)).all())

    # the synthetic case that forces the fallbacks
    fa, fw, ff, fe = scrub_fallback_case(dev, 20011, 100003)
    for summed in (True, False):
        o_f = [0, 0, 0] if summed else [4194303, 1 << 21, 0]
        for label, dtype in outs.items():
            got, want = (read(fa, fw, ff, ow, o_f, gain, summed, fe, 1000,
                              torch.full((fw.numel(),), 7, dtype=dtype,
                                         device=dev), 13, fw.numel() - 5)
                         for read in (kernels.scrub_read,
                                      lr.scrub_read_plain))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"scrub_read kernel differs from its plain version on "
                    f"the fallback case (form {'A' if summed else 'B'}, "
                    f"{label})")
    print(f"scrub_read: bit-equal to plain in forms A and B, PCM16 and f32, "
          f"at config 2 (positions {int(whole.min())} .. {int(whole.max())}"
          f", all in [0, 2n): {in_2n}) and on the fallback case (n "
          f"{fa.numel()}, {fw.numel()} positions in [-3n, 3n), carries "
          f"outside 0..1, rows off the 16-byte grid, samples 13 .. "
          f"{fw.numel() - 5}, blocks of 1 000)", flush=True)

    # timing, in the render's form A: warm, L2 flushed, the plain version,
    # and the protocol's floor; bytes and operations from this run's
    # tensors (per sample: two adds a head, the fraction, the lerp's four
    # operations, gain, envelope; PCM16 scale, round, clamp, convert)
    times = {}
    for label, dtype in outs.items():
        out = torch.empty(T, dtype=dtype, device=dev)
        nbytes = (a.nbytes + whole.nbytes + frac.nbytes + env.nbytes
                  + out.nbytes)
        ops = T * (2 * len(ow) + 7 + (5 if dtype == torch.int16 else 0))
        bound, bound_by = bound_ms(nbytes, ops)

        def launch(out=out):
            kernels.scrub_read(a, whole, frac, ow, of, gain, True, env, bs,
                               out, 0, T)

        times[label] = {
            "ms": kernel_ms(launch, TIMED_KERNEL_RUNS, KERNEL_LAUNCHES),
            "ms_l2_flushed": flushed_ms(launch, KERNEL_LAUNCHES),
            "plain_ms": cuda_ms(lambda out=out: lr.scrub_read_plain(
                a, whole, frac, ow, of, gain, True, env, bs, out),
                TIMED_KERNEL_RUNS),
            "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}
    floor = {"ms": kernel_ms(lambda: torch.cuda._sleep(0), TIMED_KERNEL_RUNS,
                             KERNEL_LAUNCHES),
             "ms_l2_flushed": flushed_ms(lambda: torch.cuda._sleep(0),
                                         KERNEL_LAUNCHES)}
    for label, t in times.items():
        print(f"scrub_read {label}: n {a.numel()} T {T} heads {len(ow)} "
              f"({t['bytes'] / 1e6:.2f} MB, {t['ops']} operations): warm "
              f"{t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%} of its "
              f"{t['bound_ms']:.4f} ms bound by {t['bound_by']}), L2 "
              f"flushed {t['ms_l2_flushed']:.4f} ms "
              f"({t['bound_ms'] / t['ms_l2_flushed']:.1%}); plain "
              f"{t['plain_ms']:.4f} ms (one event pair per call) {card}",
              flush=True)
    print(f"scrub_read: the protocol's floor, an empty torch.cuda._sleep(0) "
          f"timed the same ways: warm {floor['ms']:.4f} ms, L2 flushed "
          f"{floor['ms_l2_flushed']:.4f} ms {card}", flush=True)
    print("scrub_read: no library time: no one PyTorch call computes the "
          "wrap-around multi-head read (grid_sample wants normalised "
          "float32 coordinates and has no wrap at a tape's length)",
          flush=True)

    # the main path, every launch counted: the bench's PCM16 render and
    # the float render, both through render_scrub
    reset_counts()
    y16 = scrub.render_scrub(audio, cfg, trace, pcm16=True, device=dev)
    y = scrub.render_scrub(audio, cfg, trace, device=dev)
    launches = read_counts()
    renders = 2
    if y16.shape != (T,) or y16.dtype != np.int16:
        raise AssertionError(f"PCM16 render gave {y16.shape} {y16.dtype}")
    if y.shape != (T,) or y.dtype != np.float32:
        raise AssertionError(f"render gave {y.shape} {y.dtype}")
    if not np.isfinite(y).all():
        raise AssertionError("non-finite samples in the float render")
    peak16 = int(np.abs(y16.astype(np.int32)).max())
    if peak16 < 10000:
        raise AssertionError(f"render is near silent: peak {peak16}")
    lsb = int(np.abs(np.rint(y.astype(np.float64) * 32768.0).clip(
        -32768, 32767) - y16).max())
    if lsb != 0:
        raise AssertionError(f"PCM16 render is {lsb} LSB from the float one")
    if launches["scrub_read"] != renders:
        raise AssertionError(f"{launches['scrub_read']} scrub_read launches "
                             f"for {renders} renders")
    print(f"render: {T} frames f32 peak {np.abs(y).max():.4f}, PCM16 peak "
          f"{peak16}; kernel launches {launches}", flush=True)

    y_kernel = scrub.render_scrub(audio, cfg, trace, device=dev,
                                  device_out=True)
    with mock.patch.object(scrub, "scrub_read", lr.scrub_read_plain):
        y_plain = scrub.render_scrub(audio, cfg, trace, device=dev,
                                     device_out=True)
    if not torch.equal(y_kernel, y_plain):
        raise AssertionError("float render with the kernel differs from the "
                             "render with the plain read")
    checks = []
    for label, (a_s, c_s, t_s, kw), tol in (
            ("config 2 smoke", (*config2(2.0, 2.0), {}), -120.0),
            ("config 2 smoke, scaled drags and jump",
             (*config2(2.0, 2.0, 2.0 / 30.0), {}), -120.0),
            ("scrub_keys golden", scrub_golden("scrub_keys"), -120.0),
            ("scrub_sinc golden", scrub_golden("scrub_sinc"), -100.0)):
        ys_gpu = scrub.render_scrub(a_s, c_s, t_s, device=dev, **kw)
        ys_cpu = scrub.render_scrub(a_s, c_s, t_s, device="cpu", **kw)
        dmax = np.abs(ys_gpu.astype(np.float64) - ys_cpu).max()
        dev_db = 20 * np.log10(max(dmax, 1e-300))
        if dev_db > tol:
            raise AssertionError(f"{label} on the card is {dev_db:.1f} "
                                 "dBFS from the CPU render")
        checks.append(f"{label} {dev_db:.2f} dBFS (bit-equal: "
                      f"{bool(np.array_equal(ys_gpu, ys_cpu))})")
    print("check: float render bit-equal with the plain read; card vs CPU: "
          + "; ".join(checks), flush=True)

    # timing: the bench's run() (bench.py:290-292: cached program, PCM16
    # render, pull, host stereo), the render's device time, a fresh
    # program, one profiler window
    def run():
        mono = scrub.render_scrub(audio, cfg, trace, pcm16=True, device=dev)
        return np.repeat(mono[:, None], 2, axis=1)

    walls = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    def device_render():
        return scrub.render_scrub(audio, cfg, trace, pcm16=True, device=dev,
                                  device_out=True)

    device_ms = cuda_ms(device_render, TIMED_RENDERS)
    fresh_s = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        scrub.build_scrub_program(audio, cfg, trace)
        fresh_s.append(time.perf_counter() - t0)
    prof = profile_renders(device_render, PROFILED_RENDERS)
    print(f"timing: bench run() wall median {wall * 1e3:.2f} ms of "
          f"{TIMED_RENDERS} (cached program, PCM16 render, pull, host "
          f"stereo) -> realtime x{SCRUB_SECONDS / wall:.1f}; device "
          f"{device_ms:.3f} ms (render_scrub, device_out, pcm16); fresh "
          f"build_scrub_program median {statistics.median(fresh_s) * 1e3:.2f}"
          f" ms (host) {card}", flush=True)
    if prof:
        print(f"profile ({PROFILED_RENDERS} renders): "
              f"{prof['events_per_render']:.0f} device events per render, "
              f"device-busy {prof['busy_ms_per_render']:.3f} ms per render "
              f"({prof['busy_ms_per_render'] / device_ms:.1%} of the "
              f"device time) {card}", flush=True)
        for name, t, c in prof["top"]:
            print(f"profile:   {t:.3f} ms {c:.0f}x {name}", flush=True)
    else:
        print("profile: the profiler saw no device event; launches and "
              "busy time not measured", flush=True)

    t16 = times["pcm16"]
    return {"name": "scrub_read", "route": "cuda",
            "source": "audio_suite_torch/kernels/lerp_read.cu",
            # the JAX scrub reaches no Pallas kernel: this is its XLA read
            # (to :512) and, at :639-651, its gain, envelope and PCM16
            "replaces": "audio_suite_tpu/models/scrub.py:411",
            "launches": launches["scrub_read"],
            "launches_per_render": launches["scrub_read"] / renders,
            "shape": [a.numel(), T, len(ow)], "form": "A", "out": "pcm16",
            "max_abs_err": max(errs), "ms": t16["ms"],
            "ms_l2_flushed": t16["ms_l2_flushed"],
            "plain_ms": t16["plain_ms"], "bound_ms": t16["bound_ms"],
            "bound_by": t16["bound_by"], "library_ms": None,
            "f32": times["f32"], "floor": floor,
            "events_per_render": prof.get("events_per_render"),
            "busy_ms_per_render": prof.get("busy_ms_per_render")}


def grid_check(label: str, project, dev) -> dict:
    """One grid project on the card in f32 and PCM16, each bit-equal to the
    port's CPU render and to its host engine; returns its figures."""
    from audio_suite_torch.models import grid
    entry = grid.build_mix_program_cached(project)
    n_total, rows = entry["n_total"], entry["rows"]
    y16 = grid.render_mixdown(project, pcm16=True, device=dev)
    y = grid.render_mixdown(project, device=dev)
    pcm16 = not project.normalize          # normalize renders float only
    if y.shape != (n_total,) or y.dtype != np.float32:
        raise AssertionError(f"{label}: render gave {y.shape} {y.dtype}")
    if y16.shape != (n_total,) or y16.dtype != (np.int16 if pcm16
                                                 else np.float32):
        raise AssertionError(f"{label}: PCM16 render gave {y16.shape} "
                             f"{y16.dtype}")
    if not np.isfinite(y).all() or np.abs(y).max() > 1.0:
        raise AssertionError(f"{label}: non-finite or unclipped samples")
    cpu = grid.render_mixdown(project, device="cpu")
    cpu16 = grid.render_mixdown(project, pcm16=True, device="cpu")
    host = grid.render_mixdown(project, engine="host")
    for name, a, b in (("f32 vs the CPU render", y, cpu),
                       ("PCM16 vs the CPU render", y16, cpu16),
                       ("f32 vs the host engine", y, host)):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label}: card {name}: {int(np.sum(a != b))} samples differ")
    if pcm16 and not np.array_equal(
            y16, np.clip(np.round(y * 32768.0), -32768, 32767)):
        raise AssertionError(f"{label}: PCM16 is not the rounded f32 render")
    peak16 = int(np.abs(y16.astype(np.int32)).max()) if pcm16 else None
    if float(np.abs(y).max()) < 0.05:
        raise AssertionError(f"{label}: render is near silent")
    restarts = grid.collect_restart_events(project,
                                           project.master.duration(
                                               project.tracks))
    return {"n_total": n_total, "peak": float(np.abs(y).max()),
            "peak16": peak16, "restarts": sum(len(r) for r in restarts),
            "resets": [len(r["resets"]) for r in rows],
            "modulated": [r["mod_src"] for r in rows]}


def grid_path(dev, card: str) -> dict:
    """Phase 7: the grid half of bench config 5 and the showcase project;
    returns the grid's figures (it reaches no hand kernel)."""
    from audio_suite_torch.models import grid

    project = config5(GRID_SECONDS)
    t0 = time.perf_counter()
    entry = grid.build_mix_program_cached(project)
    first_s = time.perf_counter() - t0
    if entry["n_total"] != GRID_FRAMES:
        raise AssertionError(f"config 5 renders {entry['n_total']} samples")
    showcase = grid.load_project(os.path.join(REPO, "examples",
                                              "grid_showcase.json"))

    # the main path, every launch counted: the bench's PCM16 render and
    # the float render, then the showcase; no hand kernel is on it
    reset_counts()
    figs = {"config 5": grid_check("config 5", project, dev),
            "showcase": grid_check("showcase", showcase, dev)}
    launches = read_counts()
    for label, f in figs.items():
        forms = ("f32 and PCM16" if f["peak16"] is not None
                 else "f32 (normalized: no PCM16)")
        print(f"grid {label}: n_total {f['n_total']}, peak {f['peak']:.4f}"
              f", PCM16 peak {f['peak16']}, {f['restarts']} restart events"
              f", resets per track {f['resets']}, mod sources "
              f"{f['modulated']}; {forms} bit-equal to the CPU render and "
              f"the host engine", flush=True)
    print(f"grid: hand-kernel launches {launches} (none on this path); "
          f"first program build {first_s * 1e3:.1f} ms (user cells, host)",
          flush=True)

    # timing: the bench's run() half (bench.py:538: a memo hit, PCM16
    # render, pull), the render's device time, a fresh program and
    # prepare, one profiler window
    walls = []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        grid.render_mixdown(project, pcm16=True, device=dev)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    n_total, rows = entry["n_total"], entry["rows"]
    prep = entry["prep"][(True, str(torch.device(dev)))]

    def device_render():
        return grid._device_mixdown(n_total, rows, device_out=True,
                                    prepared=prep)

    device_ms = cuda_ms(device_render, TIMED_RENDERS)
    # no host sync inside a render: the max, its scale and every seed
    # stay on the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        device_render()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # run()'s host parts: the memo-hit key and the pull
    key_s, pull_s = [], []
    for _ in range(TIMED_RENDERS):
        t0 = time.perf_counter()
        grid.build_mix_program_cached(project)
        key_s.append(time.perf_counter() - t0)
        y = device_render()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.cpu().numpy()
        pull_s.append(time.perf_counter() - t0)
    fresh_s = []
    for _ in range(TIMED_RENDERS):
        grid._BANK_CACHE.clear()
        t0 = time.perf_counter()
        n, r = grid._build_mix_program(project)
        grid.prepare_device_mix(n, r, pcm16=True, device=dev)
        torch.cuda.synchronize()
        fresh_s.append(time.perf_counter() - t0)
    prof = profile_renders(device_render, PROFILED_RENDERS)
    print(f"timing: bench run() grid half wall median {wall * 1e3:.2f} ms "
          f"of {TIMED_RENDERS} (memo hit, PCM16 render, pull) -> realtime "
          f"x{GRID_SECONDS / wall:.1f}; device {device_ms:.3f} ms "
          f"(_device_mixdown, device_out, pcm16); fresh _build_mix_program "
          f"+ prepare_device_mix median "
          f"{statistics.median(fresh_s) * 1e3:.2f} ms; in run(): memo-hit "
          f"key {statistics.median(key_s) * 1e3:.3f} ms, pull of "
          f"{GRID_FRAMES * 2 / 1e6:.2f} MB "
          f"{statistics.median(pull_s) * 1e3:.3f} ms; no host sync inside "
          f"a render {card}", flush=True)
    if prof:
        print(f"profile ({PROFILED_RENDERS} renders): "
              f"{prof['events_per_render']:.0f} device events per render, "
              f"device-busy {prof['busy_ms_per_render']:.3f} ms per render "
              f"({prof['busy_ms_per_render'] / device_ms:.1%} of the "
              f"device time) {card}", flush=True)
        for name, t, c in prof["top"]:
            print(f"profile:   {t:.3f} ms {c:.0f}x {name}", flush=True)
    else:
        print("profile: the profiler saw no device event; launches and "
              "busy time not measured", flush=True)
    return {"launches": launches, "run_wall_ms": wall * 1e3,
            "device_ms": device_ms,
            "fresh_ms": statistics.median(fresh_s) * 1e3,
            "key_ms": statistics.median(key_s) * 1e3,
            "pull_ms": statistics.median(pull_s) * 1e3,
            "events_per_render": prof.get("events_per_render"),
            "busy_ms_per_render": prof.get("busy_ms_per_render"),
            "checks": figs}


class CachedDraws:
    """``ops/noise.py`` for the CA's step loop, each draw served from a dict
    after its first call: a profiler window of the loop run through it
    sees every launch but the noise draws', so the difference to the real
    loop is the draws' share.  A draw is keyed by its function and its
    host arguments (seed, stream): one model's loop, one grid."""

    def __init__(self):
        from audio_suite_torch.ops import noise
        self._noise, self._memo = noise, {}

    def __getattr__(self, name):
        fn = getattr(self._noise, name)

        def cached(*args):
            key = (name,) + tuple(a for a in args
                                  if not isinstance(a, torch.Tensor))
            if key not in self._memo:
                self._memo[key] = fn(*args)
            return self._memo[key]
        return cached


def fire_check(label: str, dev, steps: int, fast_noise: bool) -> tuple:
    """Config 5's CA and rule from a fresh model, ``steps`` steps on the card
    and on the CPU: stats, the four planes and the OSC packets must be
    equal; returns (stats, packets)."""
    from audio_suite_torch.models import forestfire as ff
    runs = []
    for device in (dev, "cpu"):
        model, eng, rec = config5_fire(device, fast_noise)
        stats = model.simulate(steps)
        eng.run_stream(ff.stats_rows_to_dicts(stats), rec.send)
        runs.append((stats, model._np, rec.packets))
    (s_gpu, np_gpu, p_gpu), (s_cpu, np_cpu, p_cpu) = runs
    if not np.array_equal(s_gpu, s_cpu):
        rows = np.nonzero((s_gpu != s_cpu).any(axis=1))[0]
        raise AssertionError(f"{label}: card stats differ from the CPU run's "
                             f"from step {int(rows[0]) + 1}")
    for k in ("state", "fuel", "moisture", "age"):
        diff = int((np_gpu[k] != np_cpu[k]).sum())
        if diff:
            raise AssertionError(f"{label}: card {k} plane differs from the "
                                 f"CPU run's in {diff} cells")
    if p_gpu != p_cpu:
        raise AssertionError(f"{label}: OSC packets differ from the CPU run's")
    return s_gpu, p_gpu


def fire_path(dev, card: str, grid_run_ms: float):
    """Phase 8: bench config 5 end to end (bench.py:538-541: the grid
    mixdown, the CA's 480 steps, the rules over their stats); the path
    reaches no hand kernel."""
    from audio_suite_torch.models import forestfire as ff
    from audio_suite_torch.models import grid

    project = config5(GRID_SECONDS)
    model, eng, rec = config5_fire(dev)
    cells = model.params.w * model.params.h

    def run(split=None):
        t0 = time.perf_counter()
        mix = grid.render_mixdown(project, pcm16=True, device=dev)
        t1 = time.perf_counter()
        stats = model.simulate(FIRE_STEPS)
        t2 = time.perf_counter()
        eng.run_stream(ff.stats_rows_to_dicts(stats), rec.send)
        t3 = time.perf_counter()
        if split is not None:
            split.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
        return mix, stats

    # the main path, every launch counted: one run() from the bench's start
    reset_counts()
    mix, stats = run()
    launches = read_counts()
    if mix.shape != (GRID_FRAMES,) or mix.dtype != np.int16:
        raise AssertionError(f"config 5's mixdown gave {mix.shape} "
                             f"{mix.dtype}")
    if stats.shape != (FIRE_STEPS, 8) or stats.dtype != np.int32:
        raise AssertionError(f"simulate gave {stats.shape} {stats.dtype}")
    if not np.array_equal(stats[:, 0], np.arange(1, FIRE_STEPS + 1)):
        raise AssertionError(f"the stats' step column is not 1..{FIRE_STEPS}")
    if not (stats[:, 1:5].sum(axis=1) == cells).all():
        raise AssertionError("trees + burning + ash + empty != the grid")
    if stats[:, 2].max() <= 50 or not rec.packets:
        raise AssertionError(f"the fire did not take: burning peak "
                             f"{stats[:, 2].max()}, {len(rec.packets)} OSC "
                             "messages")

    # the card against the port's CPU run, from fresh models
    s_def, p_def = fire_check("config 5", dev, FIRE_STEPS, False)
    if not np.array_equal(s_def, stats) or p_def != rec.packets:
        raise AssertionError("a fresh model's run differs from run()'s")
    s_fast, p_fast = fire_check("config 5, fast_noise", dev, FIRE_FAST_STEPS,
                                True)
    for label, s, p in (("default noise", s_def, p_def),
                        ("fast_noise", s_fast, p_fast)):
        print(f"fire {label}: {len(s)} steps on {model.params.w} x "
              f"{model.params.h}, burning peak {int(s[:, 2].max())} (step "
              f"{int(s[:, 2].argmax()) + 1}), ignitions {int(s[:, 5].sum())}, "
              f"embers {int(s[:, 6].sum())}, rain steps {int(s[:, 7].sum())}, "
              f"final trees {int(s[-1, 1])} ash {int(s[-1, 3])}; "
              f"{len(p)} OSC messages; stats, state, fuel, moisture, age and "
              f"packets bit-equal to the CPU run", flush=True)
    print(f"fire: hand-kernel launches {launches} (none on this path)",
          flush=True)

    # no host sync in the step loop: simulate(4)'s loop, the one pull at
    # its end left out (that pull is the sync the loop saves for its end)
    carry = model._carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, stats4 = ff._sim(carry, 4, model.params, model.seed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if stats4.shape != (4, 8):
        raise AssertionError(f"the checked loop gave {tuple(stats4.shape)}")

    # timing: the bench's run() (the model carries on, as in the bench),
    # simulate(480) alone from fresh models, the step loop's device window
    # and one profiler window
    split = []
    for _ in range(TIMED_FIRE):
        run(split)
    run_s = statistics.median(s[3] for s in split)
    sims = []
    for _ in range(TIMED_FIRE):
        m = config5_fire(dev)[0]
        t0 = time.perf_counter()
        m.simulate(FIRE_STEPS)
        sims.append(time.perf_counter() - t0)
    sim_s = statistics.median(sims)
    step_ms = cuda_ms(lambda: ff._sim(carry, PROFILED_STEPS, model.params,
                                      model.seed), TIMED_FIRE) \
        / PROFILED_STEPS
    prof = profile_renders(lambda: ff._sim(carry, PROFILED_STEPS,
                                           model.params, model.seed), 1)
    with mock.patch.object(ff, "noise", CachedDraws()):
        prof_nodraw = profile_renders(lambda: ff._sim(
            carry, PROFILED_STEPS, model.params, model.seed), 1)
    part = [statistics.median(s[i] for s in split) * 1e3 for i in range(3)]
    print(f"timing: bench run() wall median {run_s * 1e3:.1f} ms of "
          f"{TIMED_FIRE} (grid {part[0]:.2f} ms, simulate({FIRE_STEPS}) "
          f"{part[1]:.1f} ms, rules {part[2]:.2f} ms; the grid alone in "
          f"phase 7: {grid_run_ms:.2f} ms); simulate({FIRE_STEPS}) "
          f"from a fresh model {sim_s * 1e3:.1f} ms median of {TIMED_FIRE} "
          f"({[round(s * 1e3, 1) for s in sims]} ms) -> "
          f"{FIRE_STEPS / sim_s:.1f} steps/s, "
          f"x{FIRE_STEPS / sim_s / FIRE_TICK_HZ:.2f} the "
          f"{FIRE_TICK_HZ:.0f} Hz tick; the step loop's device window "
          f"{step_ms:.3f} ms per step {card}", flush=True)
    if prof:
        per = {k: prof[k] / PROFILED_STEPS for k in ("events_per_render",
                                                     "busy_ms_per_render")}
        print(f"profile ({PROFILED_STEPS} steps): "
              f"{per['events_per_render']:.1f} device events per step, "
              f"device-busy {per['busy_ms_per_render']:.3f} ms per step "
              f"({per['busy_ms_per_render'] / step_ms:.1%} of the device "
              f"window) {card}", flush=True)
        for name, t, c in prof["top"]:
            print(f"profile:   {t / PROFILED_STEPS:.4f} ms "
                  f"{c / PROFILED_STEPS:.1f}x per step {name}", flush=True)
        if prof_nodraw:
            rest = {k: prof_nodraw[k] / PROFILED_STEPS
                    for k in ("events_per_render", "busy_ms_per_render")}
            ev = per["events_per_render"] - rest["events_per_render"]
            busy = per["busy_ms_per_render"] - rest["busy_ms_per_render"]
            print(f"profile: the noise draws (the step loop with its draws "
                  f"served from a cache, less the real loop): {ev:.1f} "
                  f"device events ({ev / per['events_per_render']:.1%}) and "
                  f"{busy:.3f} ms busy "
                  f"({busy / per['busy_ms_per_render']:.1%}) per step; the rest {rest['events_per_render']:.1f} "
                  f"events, {rest['busy_ms_per_render']:.3f} ms {card}",
                  flush=True)
    else:
        print("profile: the profiler saw no device event; launches and "
              "busy time not measured", flush=True)


# ---- phase 9: every Microsound mode and option

# the grain_scan entry points of phase 9's renders, each with the render
# that launches it
MS_SCANS = {"stick_slip_noise_scan": "a:Stick–slip friction",
            "chaos_scan": "a:Micro-chaos",
            "waveguide_scan": "b:resonator+waveguide"}
MS_STICK_SLIP = ("a:Stick–slip friction", "c:config3 stick-slip")
MS_TIMED = 3           # timed renders per case (their median)
MS_CHUNK = 32          # the chunked feedback / imprint render's chunk
# dependent f32 ops a step adds to the critical path (4 cycles each on
# Hopper), where every step reads the step before: the stick-slip force's
# add, compare and select; the map's two multiplies
SCAN_CHAIN_OPS = {"stick_slip_scan": 3, "stick_slip_noise_scan": 3,
                  "chaos_scan": 2}
# f32 operations a sample: the stick-slip step's 9 (its terms, the force's
# add, compare, select, multiply), the fused kernel's two normals 26 more
# (11 adds, a scale and - 6 each), the map's 4, a waveguide line's 5
SCAN_FLOPS = {"stick_slip_scan": 9, "stick_slip_noise_scan": 35,
              "chaos_scan": 4, "waveguide_scan": 5}
SS_HASHES = 24            # murmur3 hashes a sample of the fused stick-slip
# per-SM issue rates a clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput) of the SASS classes
# that ``sass_hash_counts`` counts: 32-bit integer add, logic, shift,
# compare and select (I2FP, the integer-to-f32 conversion that nvcc emits
# for sm_90, counted with them: the Programming Guide's 16 for
# conversions would lengthen the bound), integer multiply-add, f32 add /
# multiply / compare / select, and 4 warp instructions a clock in all
SASS_RATES = {"alu": 64, "imad": 64, "conv": 16, "fp": 128, "all": 128}
SCAN_WIDTHS = ("factory", "config3")   # the shapes of ``scan_inputs``
SCAN_C3_PLAIN_LINES = 1   # waveguide lines held against the plain loop at
#                           config 3's width (~6 s of host time a line)
SCAN_AB_SLOW_MS = 5.0     # scan A/B: a call slower than this is timed in
#                           runs of 5 launches
SCAN_REPLACES = {
    "stick_slip_scan": "audio_suite_tpu/ops/generators.py:188",
    "stick_slip_noise_scan": "audio_suite_tpu/ops/generators.py:188",
    "chaos_scan": "audio_suite_tpu/ops/generators.py:214",
    "waveguide_scan": "audio_suite_tpu/ops/generators.py:304"}


def ms_cases():
    """Phase 9's renders: (label, params, render kwargs).  (a) the
    reference app's factory settings (``MicrosoundParams()``: 48 kHz, 8 s,
    x25 unfold, micro_ms 1.25: gen_sr 1.2 MHz, n 1 500, L 2 048, 156
    events) once per generator mode; (b) option paths at the factory
    settings; (c) bench config 3 at full width (bench.py:348-353) through
    the whole warp chain and in stick-slip mode."""
    from audio_suite_torch.models import microsound as ms
    _, ir = config3(full=True)
    # the image-scanline mode's seeded 64 x 256 grayscale image (0-255)
    img = np.random.default_rng(13).integers(0, 256, size=(64, 256)) \
        .astype(np.float64)
    fac = ms.MicrosoundParams().to_dict()
    cases = []
    for mode in ms.GEN_MODES:
        kw = {"ir_audio": ir} if mode == "IR fragment" else (
            {"img_gray": img} if mode == "Image scanline" else {})
        cases.append((f"a:{mode}", dict(fac, gen_mode=mode), kw))
    for label, ch in [
            ("b:warps", dict(nl_warp_on=True, cep_warp_on=True)),
            ("b:partial lock", dict(partial_lock_on=True,
                                    partial_stretch=2.0)),
            ("b:resonator+waveguide", dict(res_bank_on=True, wg_on=True)),
            ("b:multiband", dict(unfold_mode="Multi-band unfold")),
            ("b:feedback+imprint", dict(event_feedback_on=True,
                                        spectral_imprint_on=True)),
            ("b:bp lanes", dict(bp_unfold="0:20, 8:30",
                                bp_stretch="0:0.8, 8:1.6")),
            # the padded-length chain through the cepstral warp, which
            # reads the phase of FFT round-off (ROADMAP.md section 3)
            ("b:bp lanes+cepstral", dict(bp_unfold="0:20, 8:30",
                                         bp_stretch="0:0.8, 8:1.6",
                                         cep_warp_on=True))]:
        cases.append((label, dict(fac, **ch), {}))
    p3, _ = config3(full=True)
    c3 = p3.to_dict()
    cases.append(("c:config3 warp chain", dict(
        c3, nl_warp_on=True, cep_warp_on=True, partial_lock_on=True),
        {"ir_audio": ir}))
    cases.append(("c:config3 stick-slip", dict(
        c3, gen_mode="Stick–slip friction"), {"ir_audio": ir}))
    return cases


def resonator_inputs(p, kw: dict, dev) -> torch.Tensor:
    """The grains that enter the resonator bank, whose sign(x) gate moves
    the output by up to 0.9 of the bank where a sample crosses 0, in one
    render of ``p`` on ``dev`` (on the host)."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import generators
    seen = []
    bank = generators.resonator_bank

    def spy(x, *args, **kwargs):
        seen.append(x.cpu())
        return bank(x, *args, **kwargs)

    generators.resonator_bank = spy
    try:
        ms.render(p, device=dev, **kw)
    finally:
        generators.resonator_bank = bank
    return torch.cat(seen)


def dbfs(a: torch.Tensor, b: torch.Tensor) -> float:
    return 20 * float(np.log10(max((a.cpu().double() - b.cpu().double())
                                   .abs().max().item(), 1e-300)))


def scan_inputs(dev, width: str):
    """The grain_scan kernels' inputs as the render draws them, and the
    chunk's real event count (the rest are padding).  ``width`` "factory":
    the factory program with the waveguide on (its one chunk: E 160 with
    padding, L 2 048); "config3": bench config 3 in stick-slip mode with
    the waveguide on (its one chunk: E 288, L 32 768).  The stick-slip
    noise rows and micro-chaos gates of the chunk's seeds, the seeds
    themselves for the stick-slip kernel that draws its own rows, and the
    waveguide's delays, gains and mixes over seeded grains."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import generators, noise
    if width == "factory":
        d = ms.MicrosoundParams().to_dict()
    else:
        p3, _ = config3(full=True)
        d = dict(p3.to_dict(), gen_mode="Stick–slip friction")
    prog = ms.build_program(ms.MicrosoundParams.from_dict(dict(d,
                                                               wg_on=True)))
    (ch,) = ms._chunk_events(prog, ms._event_chunk(prog["E"], prog["L"]))
    ev = ms.program_to_device(ch, dev)
    i = torch.arange(prog["L"], device=dev)
    seed = ev["seed"][:, None]
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.standard_normal(
        (len(ch["n"]), prog["L"])).astype(np.float32), device=dev)
    return {
        "stick_slip_scan": (noise.normal(seed, i, generators.STREAM_BUILD),
                            noise.normal(seed, i, generators.STREAM_OUT),
                            0.9, 0.06, 0.75, 0.08),
        "stick_slip_noise_scan": (ev["seed"].contiguous(), prog["L"], 0.9,
                                  0.06, 0.75, 0.08),
        "chaos_scan": (noise.uniform(seed, i, generators.STREAM_GATE),
                       generators.chaos_y0(ev["seed"]), 3.92, 0.35),
        "waveguide_scan": (x, ev["wg_d"], ev["wg_g"], ev["wg_m"])}, \
        prog["E"]


def chain_ops(name: str, args, real: int) -> int:
    """The longest chain of dependent f32 ops in one event's recurrence,
    from this run's inputs.  Stick-slip and micro-chaos: every step reads
    the one before, L steps.  The waveguide: v(t) = y(t) + g v(t - d)
    reads the step d before (a multiply and an add), so one line's chain
    has floor((L - 1) / d) links, and line l + 1 at step t reads line l at
    step t (an add, a multiply and an add), so the lines pipeline: 3 ops
    a line plus 2 a link on the event's smallest d, the longest over the
    chunk's ``real`` events (the padding events' rows are discarded)."""
    if name == "stick_slip_noise_scan":
        return args[1] * SCAN_CHAIN_OPS[name]
    if name != "waveguide_scan":
        return args[0].shape[1] * SCAN_CHAIN_OPS[name]
    L = args[0].shape[1]
    d = args[1][:real].to(torch.int64).clamp_min(1)
    links = (L - 1) // d.amin(dim=1)
    return 3 * d.shape[1] + 2 * int(links.max())


def scan_shape(name: str, args) -> tuple[int, int]:
    """A grain_scan call's (E, L)."""
    if name == "stick_slip_noise_scan":
        return args[0].shape[0], args[1]
    return tuple(args[0].shape)


def sass_class(op: str) -> str:
    """The issue class of a SASS opcode for ``SASS_RATES`` ("other":
    memory, control, barriers)."""
    base = op.split(".")[0]
    if base == "I2F":
        return "conv"
    if base.startswith("IMAD"):
        return "imad"
    if base in ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET"):
        return "fp"
    if base in ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "VIADD",
                "VIADDMNMX", "IABS", "PRMT", "I2FP", "MOV", "IMNMX",
                "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV", "CS2R"):
        return "alu"
    return "other"


def sass_hash_counts(so: str) -> dict:
    """The fused stick-slip kernel's SASS instructions a hash, by issue
    class, from ``cuobjdump -sass`` of the built library: the loop that
    holds the kernel's integer-to-f32 conversions (one a hash), from the
    target of its back edge to that edge, over its conversions.  The loop
    is the producers' whole work a sample (its key, the 24 hashes, the two
    sums and terms, their stores and the loop's own counting)."""
    from audio_suite_torch import kernels
    cuobj = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)
                if "stick_slip_kernelILb1E" in f.split("\n", 1)[0])
    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                     r"([A-Z][\w.]*)([^;]*);")
    ins = [(int(a, 16), op, rest) for a, op, rest in pat.findall(body)]
    conv = [a for a, op, _ in ins if op.startswith("I2F")]
    for a, op, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if a > max(conv) and op.startswith("BRA") and m \
                and int(m.group(1), 16) <= min(conv):
            lo, hi = int(m.group(1), 16), a
            break
    loop = [op for a, op, _ in ins if lo <= a <= hi and op != "NOP"]
    hashes = sum(op.startswith("I2F") for op in loop)
    counts = {k: 0 for k in SASS_RATES}
    for op in loop:
        cls = sass_class(op)
        if cls in counts:
            counts[cls] += 1
        counts["all"] += 1
    return {"loop_instructions": len(loop), "hashes_in_loop": hashes,
            "per_hash": {k: v / hashes for k, v in counts.items()}}


def scan_bounds(name: str, args, real: int, sm_mhz: float,
                hash_sass: dict = None) -> dict:
    """A grain_scan call's bounds from its inputs: bytes (each input read
    once, the output written once) over the memory rate, its f32 ops over
    the f32 rate, and its dependency chain (``chain_ops`` x 4 cycles at
    the card's maximum SM clock).  The fused stick-slip kernel also hashes
    (``SS_HASHES`` a sample): its hash bound is the hashes x the SASS
    instructions a hash in each class (``hash_sass``) over that class's
    rate on every SM, the slowest class, and counts as its operations."""
    E, L = scan_shape(name, args)
    lines = args[1].shape[1] if name == "waveguide_scan" else 1
    nbytes = 4 * (sum(t.numel() for t in args
                      if isinstance(t, torch.Tensor)) + E * L)
    bound, bound_by = bound_ms(nbytes, SCAN_FLOPS[name] * E * L * lines)
    ops = chain_ops(name, args, real)
    bd = {"E": E, "L": L, "lines": lines, "nbytes": nbytes,
          "bound_ms": bound, "bound_by": bound_by, "chain_ops": ops,
          "chain_bound_ms": ops * 4 / (sm_mhz * 1e3)}
    if name == "stick_slip_noise_scan":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per = hash_sass["per_hash"]
        cls = max(SASS_RATES, key=lambda k: per[k] / SASS_RATES[k])
        cycles = SS_HASHES * E * L * per[cls] / SASS_RATES[cls] / sms
        bd.update(hashes=SS_HASHES * E * L, hash_bound_ms=cycles /
                  (sm_mhz * 1e3), hash_bound_by=cls,
                  hash_sass_per_hash=per)
        if bd["hash_bound_ms"] > bound:
            bd["bound_ms"], bd["bound_by"] = bd["hash_bound_ms"], "operations"
    return bd


def scan_kernel(name: str):
    """The launch-counting wrapper of a grain_scan entry point, called
    with its ``scan_inputs`` arguments."""
    from audio_suite_torch import kernels
    from audio_suite_torch.ops import generators
    if name == "stick_slip_noise_scan":
        return lambda *a: kernels.stick_slip_noise_scan(
            *a, (generators.STREAM_BUILD, generators.STREAM_OUT))
    return getattr(kernels, name)


def scan_rows(dev, card: str, so: str) -> dict:
    """Each grain_scan entry point against its plain version, bit-equal,
    timed warm and L2 flushed, with its bounds (``scan_bounds``), at the
    factory size and at config 3's width (``scan_inputs``).  At config 3's
    width the waveguide is held against its plain loop at its first
    SCAN_C3_PLAIN_LINES lines (the loop takes ~100 us of host time a step)
    and timed at all of them.  The stick-slip kernel that draws its own
    noise is held against its plain version, the two ``noise.normal``
    draws (timed, and equal to the row form's inputs) and the row form's
    plain loop on them (its result and time taken from the row form's
    check just before), and is timed beside the unfused path it replaces
    (the two draws and the row form's kernel); the row form, off the
    render's path, is reported inside its row (``row_form``).  ``so``:
    the built grain_scan library, whose SASS gives the hash bound."""
    from audio_suite_torch.ops import generators, noise
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    hash_sass = sass_hash_counts(so)
    print(f"grain_scan SASS: the fused stick-slip's hashing loop, "
          f"{hash_sass['loop_instructions']} instructions for "
          f"{hash_sass['hashes_in_loop']} hashes; a hash: "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      hash_sass["per_hash"].items()), flush=True)
    rows, row_form = {}, {}
    for width in SCAN_WIDTHS:
        inputs, real = scan_inputs(dev, width)
        plain_rows = None
        for name, args in inputs.items():
            kern = scan_kernel(name)
            plain = getattr(generators, name + "_plain")
            cargs = args
            if name == "waveguide_scan" and width == "config3":
                cargs = (args[0],) + tuple(
                    t[:, :SCAN_C3_PLAIN_LINES].contiguous() for t in args[1:])
            got = kern(*cargs)
            extra = {}
            if name == "stick_slip_noise_scan":
                seed, L = args[0][:, None], args[1]
                i = torch.arange(L, device=dev)
                draw = lambda: (
                    noise.normal(seed, i, generators.STREAM_BUILD),
                    noise.normal(seed, i, generators.STREAM_OUT))
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                bn, on = draw()
                b.record()
                torch.cuda.synchronize()
                rows_args = inputs["stick_slip_scan"]
                if not (torch.equal(bn, rows_args[0])
                        and torch.equal(on, rows_args[1])):
                    raise AssertionError("the fused stick-slip's draws "
                                         "differ from the row form's inputs")
                want, loop_ms = plain_rows
                plain_ms = a.elapsed_time(b) + loop_ms
                rows_kern = scan_kernel("stick_slip_scan")
                extra["unfused_ms"] = cuda_ms(
                    lambda: rows_kern(*draw(), *rows_args[2:]), 3)
            else:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                want = plain(*cargs)
                b.record()
                torch.cuda.synchronize()
                plain_ms = a.elapsed_time(b)
                if name == "stick_slip_scan":
                    plain_rows = (want, plain_ms)
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} kernel differs from its plain "
                                     f"version at the {width} shape: max "
                                     f"|err| {err}")
            ms_warm = kernel_ms(lambda: kern(*args), TIMED_KERNEL_RUNS,
                                KERNEL_LAUNCHES)
            ms_cold = flushed_ms(lambda: kern(*args), KERNEL_LAUNCHES)
            bd = scan_bounds(name, args, real, sm_mhz, hash_sass)
            governs = max(bd["bound_ms"], bd["chain_bound_ms"])
            gov_by = "chain" if bd["chain_bound_ms"] > bd["bound_ms"] \
                else bd["bound_by"]
            held = cargs[1].shape[1] if cargs is not args else bd["lines"]
            print(f"{name} ({width}): E {bd['E']} L {bd['L']} lines "
                  f"{bd['lines']}: bit-equal to plain"
                  + (f" at its first {held} of them" if held != bd["lines"]
                     else "")
                  + f"; warm {ms_warm:.4f} ms, L2 flushed {ms_cold:.4f} ms; "
                  f"bound by {bd['bound_by']} {bd['bound_ms']:.4f} ms "
                  f"({bd['nbytes'] / 1e6:.2f} MB"
                  + (f"; {bd['hashes'] / 1e6:.1f} M hashes, "
                     f"{bd['hash_bound_ms']:.4f} ms by "
                     f"{bd['hash_bound_by']}" if "hashes" in bd else "")
                  + f"), dependency chain "
                  f"{bd['chain_bound_ms']:.4f} ms ({bd['chain_ops']} "
                  f"dependent ops x 4 cycles at {sm_mhz:.0f} MHz); the "
                  f"{gov_by} governs, warm at {governs / ms_warm:.2%} of "
                  f"it, L2 flushed at {governs / ms_cold:.2%}; plain "
                  f"{plain_ms:.2f} ms"
                  + (f"; the unfused path (two noise.normal draws and the "
                     f"row form) {extra['unfused_ms']:.3f} ms"
                     if extra else "") + f" {card}", flush=True)
            fig = dict({"max_abs_err": err, "ms": ms_warm,
                        "ms_l2_flushed": ms_cold, "plain_ms": plain_ms,
                        "plain_lines": held, "bound_ms": bd["bound_ms"],
                        "bound_by": bd["bound_by"],
                        "chain_bound_ms": bd["chain_bound_ms"],
                        "shape": {"E": bd["E"], "L": bd["L"],
                                  "lines": bd["lines"]}}, **extra)
            if "hashes" in bd:
                fig.update(hashes=bd["hashes"],
                           hash_bound_ms=bd["hash_bound_ms"],
                           hash_bound_by=bd["hash_bound_by"],
                           hash_sass_per_hash=bd["hash_sass_per_hash"])
            if name == "stick_slip_scan":
                if width == "factory":
                    row_form.update(fig, launches_on_main_path=0)
                else:
                    row_form[width] = fig
            elif width == "factory":
                rows[name] = dict({
                    "name": name, "route": "cuda",
                    "source": "audio_suite_torch/kernels/grain_scan.cu",
                    "replaces": SCAN_REPLACES[name] + " (lax.scan; no "
                                "Pallas kernel)", "library_ms": None}, **fig)
            else:
                rows[name][width] = fig
    rows["stick_slip_noise_scan"]["row_form"] = row_form
    return rows


def scan_ab(dev, card: str, src: str) -> dict:
    """The grain_scan entry points of the port's source against those of
    ``src`` (another grain_scan.cu; one whose ``gs_waveguide`` takes a ring
    scratch and its cap, as an earlier commit's does, gets a ring of
    min(max d, L) floats an event; one without ``gs_stick_slip_noise``, as
    the parent commit's, meets the fused stick-slip with its own whole
    path: the two ``noise.normal`` draws and its ``gs_stick_slip``), at
    both widths of ``scan_inputs``: each checked bit-equal to the port's
    output, then timed in turns (``in_turns``, one round: port, other,
    other, port; fewer launches a run where a call takes over
    SCAN_AB_SLOW_MS)."""
    from audio_suite_torch import kernels
    from audio_suite_torch.ops import generators, noise
    lib, ptxas = build_ab("ab_grain_scan", src)
    for row in ptxas:
        print(f"scan A/B: ptxas other {row}", flush=True)
    with open(src) as f:
        text = f.read()
    ring = re.search(r"gs_waveguide\([^)]*\bcap\b", text) is not None
    fused = "gs_stick_slip_noise" in text
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    lib.gs_stick_slip.argtypes = [P, P, P, I, I, F, F, F, F, P]
    if fused:
        lib.gs_stick_slip_noise.argtypes = [P, P, I, I, F, F, F, F, U, U, P]
    lib.gs_chaos.argtypes = [P, P, P, I, I, F, F, P]
    lib.gs_waveguide.argtypes = [P] * (6 if ring else 5) + [I] * (
        4 if ring else 3) + [P]
    lib.gs_error_string.restype = ctypes.c_char_p

    def run(fn, *a):
        rc = getattr(lib, fn)(*a, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(lib.gs_error_string(rc).decode())

    def stick_slip(bn, on, scalars):
        out = torch.empty_like(bn)
        run("gs_stick_slip", bn.data_ptr(), on.data_ptr(), out.data_ptr(),
            *bn.shape, *scalars)
        return out

    def other(name, args):
        if name == "stick_slip_noise_scan":
            seed, L = args[0], args[1]
            if not fused:
                i = torch.arange(L, device=seed.device)
                return stick_slip(
                    noise.normal(seed[:, None], i, generators.STREAM_BUILD),
                    noise.normal(seed[:, None], i, generators.STREAM_OUT),
                    args[2:])
            out = torch.empty(seed.shape[0], L, device=seed.device)
            run("gs_stick_slip_noise", seed.data_ptr(), out.data_ptr(),
                seed.shape[0], L, *args[2:], generators.STREAM_BUILD,
                generators.STREAM_OUT)
            return out
        x = args[0]
        E, L = x.shape
        if name == "stick_slip_scan":
            return stick_slip(args[0], args[1], args[2:])
        out = torch.empty_like(x)
        if name == "chaos_scan":
            run("gs_chaos", args[0].data_ptr(), args[1].data_ptr(),
                out.data_ptr(), E, L, *args[2:])
        else:
            lines = args[1].shape[1]
            ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
            if ring:
                cap = max(1, min(int(args[1].max()), L))
                scratch = torch.empty(E * cap, device=x.device)
                run("gs_waveguide", *ptrs, scratch.data_ptr(), E, L, lines,
                    cap)
            else:
                run("gs_waveguide", *ptrs, E, L, lines)
        return out

    sm_mhz = float(smi("clocks.max.sm").split()[0])
    hash_sass = sass_hash_counts(kernels.build("grain_scan"))
    rows = {}
    for width in SCAN_WIDTHS:
        inputs, real = scan_inputs(dev, width)
        for name, args in inputs.items():
            port = scan_kernel(name)
            want = port(*args)
            got = other(name, args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"scan A/B: {name} ({width}) differs "
                                     "from the port's")
            bd = scan_bounds(name, args, real, sm_mhz, hash_sass)
            governs = max(bd["bound_ms"], bd["chain_bound_ms"])
            label = "other" if fused or name != "stick_slip_noise_scan" \
                else "other: two draws + gs_stick_slip"
            fns = {"port": lambda: port(*args),
                   label: lambda: other(name, args)}
            t0 = time.perf_counter()
            other(name, args)
            torch.cuda.synchronize()
            slow = (time.perf_counter() - t0) * 1e3 > SCAN_AB_SLOW_MS
            r = in_turns(fns, 1, governs, runs=3 if slow else None,
                         launches=5 if slow else None)
            rows[f"{name} ({width})"] = dict(r, bounds=bd)
            print(f"scan A/B {name} ({width}), bit-equal; governing bound "
                  f"{governs:.4f} ms: "
                  + "; ".join(f"{k} warm {v['warm_ms']:.4f} ms "
                              f"({v['share_of_bound_warm']:.2%}), L2 flushed "
                              f"{v['l2_flushed_ms']:.4f} ms" for k, v in
                              r.items()) + f" {card}", flush=True)
    return rows


def microsound_all_path(dev, card: str):
    """Phase 9: every Microsound mode and option; returns (the grain_scan
    rows, the phase's overlap-add launches).  The stick-slip renders draw
    their two noise rows in the kernel: a torch ``noise.normal`` call of
    the build or out stream during the main path fails the phase."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import generators, noise
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_goldens as tg

    t_phase = time.perf_counter()
    rows = scan_rows(dev, card, kernels.build("grain_scan"))
    print(f"phase 9: grain_scan rows in {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)

    # the main path, every launch counted: each case once on the card, with
    # the torch draws of the stick-slip streams counted
    cases = ms_cases()
    ss_streams = (generators.STREAM_BUILD, generators.STREAM_OUT)
    ss_draws = []
    normal = noise.normal

    def counted_normal(seed, idx, stream=0):
        if stream in ss_streams:
            ss_draws.append(stream)
        return normal(seed, idx, stream)

    reset_counts()
    outs, per_case = {}, {}
    for label, d, kw in cases:
        before = read_counts()
        with mock.patch.object(noise, "normal", counted_normal):
            y, meta = ms.render(ms.MicrosoundParams.from_dict(d), device=dev,
                                **kw)
        torch.cuda.synchronize()
        after = read_counts()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{label}: non-finite samples")
        if y.shape[1] != 2 or float(y.abs().max()) < 0.5:
            raise AssertionError(f"{label}: render {tuple(y.shape)} peak "
                                 f"{float(y.abs().max())}")
        outs[label] = y
        per_case[label] = ({k: after[k] - before[k] for k in WRAPPERS},
                           meta["events"])
    launches = read_counts()
    for name, label in MS_SCANS.items():
        if per_case[label][0][name] < 1:
            raise AssertionError(f"{label} did not launch {name}")
        rows[name]["launches"] = launches[name]
    if launches["stick_slip_scan"] or ss_draws:
        raise AssertionError(
            f"the stick-slip renders took the row form "
            f"({launches['stick_slip_scan']} launches) or drew its rows in "
            f"torch ({len(ss_draws)} noise.normal calls)")
    print(f"check: the stick-slip renders launched the fused kernel "
          + ", ".join(f"{per_case[lb][0]['stick_slip_noise_scan']}x "
                      f"({lb}, {per_case[lb][1]} events)"
                      for lb in MS_STICK_SLIP)
          + ", no row form and no torch draw of their rows", flush=True)
    if launches["overlap_add"] < len(cases):
        raise AssertionError("a render did not launch the overlap_add "
                             "kernel")

    # each render against the port's CPU render, then timing
    ss_prof = {}
    for label, d, kw in cases:
        p = ms.MicrosoundParams.from_dict(d)
        cpu, _ = ms.render(p, device="cpu", **kw)
        db = dbfs(outs[label], cpu)
        stage = ""
        if p.res_bank_on:
            # the card's and the CPU's renders agree only where the
            # resonator's input grains do, sign for sign
            xc, xh = (resonator_inputs(p, kw, at) for at in (dev, "cpu"))
            stage = (f"; resonator input grains: {int((xc != xh).sum())} "
                     f"of {xc.numel()} samples differ, "
                     f"{int((torch.sign(xc) != torch.sign(xh)).sum())} "
                     f"across 0")
        if db > -100.0:
            raise AssertionError(f"{label}: card {db:.2f} dBFS from the "
                                 f"CPU{stage}")
        walls = []
        for _ in range(MS_TIMED):
            t0 = time.perf_counter()
            y16, _ = ms.render(p, device=dev, pcm16=True, **kw)
            y16.cpu()
            walls.append(time.perf_counter() - t0)
        prof = profile_renders(lambda: ms.render(p, device=dev, **kw), 1)
        counts, events = per_case[label]
        wall = statistics.median(walls) * 1e3
        print(f"microsound {label}: {events} events, card vs CPU "
              f"{db:.2f} dBFS{stage}; wall median {wall:.2f} ms of "
              f"{MS_TIMED} (PCM16, pulled); "
              + (f"{prof['events_per_render']:.0f} device events, "
                 f"{prof['busy_ms_per_render']:.3f} ms busy; "
                 if prof else "profile: no device event; ")
              + f"launches {counts} {card}", flush=True)
        for name, t, c in (prof["top"][:3] if prof else []):
            print(f"profile:   {t:.3f} ms {c:.0f}x {name}", flush=True)
        if label in MS_STICK_SLIP:
            ss_prof[label] = (wall, prof)
    print("stick-slip renders: " + "; ".join(
        f"{lb} wall {w:.2f} ms, "
        + (f"{pr['events_per_render']:.0f} device events, "
           f"{pr['busy_ms_per_render']:.3f} ms busy" if pr else
           "profile: no device event") for lb, (w, pr) in ss_prof.items())
        + f" {card}", flush=True)

    # feedback and imprint: chunked bit-equal to whole on the card
    p = ms.MicrosoundParams.from_dict(dict(cases[0][1],
                                           event_feedback_on=True,
                                           spectral_imprint_on=True))
    whole, meta = ms.render(p, device=dev)
    chunked, _ = ms.render(p, device=dev, event_chunk=MS_CHUNK)
    if not torch.equal(whole, chunked):
        raise AssertionError(f"feedback + imprint at event_chunk "
                             f"{MS_CHUNK} is {dbfs(whole, chunked):.2f} "
                             f"dBFS from the whole render on the card")
    print(f"check: feedback + imprint in chunks of {MS_CHUNK} "
          f"({-(-meta['events'] // MS_CHUNK)} chunks) bit-equal to whole",
          flush=True)

    # the two goldens on the card
    with open(tg.GOLDEN_PATH) as f:
        goldens = json.load(f)
    for key, d in MS_GOLDENS.items():
        y, _ = ms.render(ms.MicrosoundParams.from_dict(d), device=dev)
        tg._compare(key, tg._fingerprint(y.cpu().numpy()), goldens[key])
        print(f"check: golden {key} passes on the card", flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return list(rows.values()), launches["overlap_add"]


# tests/test_goldens.py:203-229 (SR 8000)
MS_GOLDENS = {
    "microsound_chaos": dict(
        base_sr=8000, out_dur_s=0.4, time_unfold=3.0, micro_ms=8.0,
        gen_mode="Micro-chaos", chaos_r=3.92, chaos_gate=0.35,
        grains_per_sec=15.0, max_grains=12, nl_warp_on=True,
        nl_warp_power=1.25, bandlimit_on=True, bandlimit_out_hz=3000.0,
        bandlimit_roll_hz=500.0, seed=41, er_cloud_on=False, bp_density="",
        bp_unfold="", bp_cutoff="", bp_stretch=""),
    "microsound_cepstral": dict(
        base_sr=8000, out_dur_s=0.4, time_unfold=2.5, micro_ms=6.0,
        gen_mode="Crackle / corona", crackle_density=150.0, cep_warp_on=True,
        cep_factor=1.2, grains_per_sec=20.0, max_grains=12, stereo_on=True,
        stereo_width=0.65, seed=17, er_cloud_on=False, bp_density="",
        bp_unfold="", bp_cutoff="", bp_stretch=""),
}


# ---- phase 10: the tape's other paths: the performance renderer, the
# segment engine and the scan engine

TRACE_SR = 8000         # tests/test_tape_trace.py's rate
TRACE_SEGMENTS = 13     # the config-1 trace's segments
TIMED_TRACES = 3        # timed config-1 trace renders (each ~2 s)
SCAN_PLAIN_FRAMES = 4000  # the scan's plain loop: ~0.1 ms of host time a step
SCAN_CHUNKS = (256, 1024, 4096)  # the full-size launch's chunk lengths
SCAN_GROUP = 128        # chunks a walk decision (tape_scan.cu's kGroupChunks)
SCAN_VARIANT_RUNS = 3   # timed runs of the inertia variant (~30 ms a call)
SCAN_AB_TURNS = 2       # --tape-scan-ab: calls a turn (port, other, other,
#                         port); the one-warp design takes ~0.7 s a call
SCAN_WINDOW = 2000      # frames of a full-size window held against the
#                         plain loop (~10-35 us of host time a step)
# f32 operations a sample: the lerp's 4, the two gains' 2 and the clip's
# 2, the increment's 2 multiplies; inertia 5 more
TAPE_SCAN_FLOPS = {False: 10, True: 15}


def config1_trace(n: int):
    """Bench config 1 with a performance: tests/test_tape_trace.py's
    _perf_trace with its times x60 and the marker at n // 2."""
    from audio_suite_torch.models import tape
    tr = tape.TapeTrace()
    for t, op, kw in (
            (12.0, "set_speed", dict(section=0, value=1.7)),
            (27.0, "set_reverse", dict(section=1, value=True)),
            (42.0, "set_age", dict(value=95)),
            (54.0, "add_marker", dict(sample=n // 2)),
            (66.0, "set_inertia", dict(value=True)),
            (69.0, "set_inertia_amount", dict(value=80)),
            (84.0, "set_splice", dict(value=False)),
            (93.0, "set_splice", dict(value=True)),
            (108.0, "seek", dict(sample=100)),
            (123.0, "set_anticlick_amount", dict(value=90)),
            (138.0, "remove_marker", dict(sample=n // 2)),
            (156.0, "retime", dict(target=180.0))):
        tr.add(t, op, **kw)
    return tr


def small_traces():
    """The card-against-CPU cases at tests/test_tape_trace.py's size (SR
    8 000): its parity case (_perf_trace over 3 s of a 2 s tape) and its
    splice-freeze case (splice off 100 samples in, on 60 samples later: a
    paused envelope resumed, the piece path).  Label -> (audio, params,
    trace, frames)."""
    from audio_suite_torch.models import tape
    sr = TRACE_SR

    def tape_audio(n):
        rng = np.random.default_rng(3)
        t = np.arange(n) / sr
        return np.asarray(0.5 * np.sin(2 * np.pi * 180 * t)
                          + 0.2 * np.sin(2 * np.pi * 733 * t)
                          + 0.05 * rng.standard_normal(n), np.float32)

    perf = tape.TapeTrace()
    for t, op, kw in (
            (0.20, "set_speed", dict(section=0, value=1.7)),
            (0.45, "set_reverse", dict(section=1, value=True)),
            (0.70, "set_age", dict(value=95)),
            (0.90, "add_marker", dict(sample=sr // 2)),
            (1.10, "set_inertia", dict(value=True)),
            (1.15, "set_inertia_amount", dict(value=80)),
            (1.40, "set_splice", dict(value=False)),
            (1.55, "set_splice", dict(value=True)),
            (1.80, "seek", dict(sample=100)),
            (2.05, "set_anticlick_amount", dict(value=90)),
            (2.30, "remove_marker", dict(sample=sr // 2)),
            (2.60, "retime", dict(target=1.2))):
        perf.add(t, op, **kw)
    freeze = tape.TapeTrace()
    freeze.add(100 / sr, "set_splice", value=False)
    freeze.add(160 / sr, "set_splice", value=True)
    return {
        "perf": (tape_audio(2 * sr), tape.TapeParams(
            sample_rate=sr, markers=[3000, 9000],
            section_speeds=[1.0, 0.5, 2.0],
            section_reverse=[False, False, True], tape_age=40),
            perf, 3 * sr),
        "splice freeze": (tape_audio(sr), tape.TapeParams(
            sample_rate=sr, markers=[sr // 2], section_speeds=[1.0, 1.0],
            tape_age=0, anticlick_enabled=False), freeze, 600)}


def tape_state(st) -> tuple:
    """A scan TapeState's (whole, frac, speed, rem, sidx) on the host."""
    return (int(st.whole), int(st.frac), float(st.speed),
            int(st.splice_rem), int(st.splice_idx))


def scan_call(ins: tuple, consts, chunk: int):
    """A call of ``kernels.tape_scan`` on the scan inputs ``ins`` from the
    start of the tape, its state words made once: it returns (out, the
    final state words, the chunk records, the walked count), and passes
    its keywords (``marks``) on."""
    from audio_suite_torch import kernels
    from audio_suite_torch.ops import varispeed
    words = varispeed.scan_state_words(None, consts, ins[0].device)
    kw = dict(anticlick_on=consts.anticlick_on, smooth_len=consts.smooth_len,
              strength=consts.anticlick_strength,
              splice_on=consts.splice_on, inertia_on=consts.inertia_on,
              alpha_q=consts.alpha_q, chunk=chunk, return_records=True)
    return lambda **extra: kernels.tape_scan(*ins, words, **kw, **extra)


def scan_decisions(jumped: np.ndarray) -> int:
    """The walk's sequential decisions for the chunks' jumped flags: one
    a group of up to SCAN_GROUP consecutive jumped chunks, one a walked
    chunk."""
    cuts = np.flatnonzero(np.diff(np.r_[0, jumped.astype(np.int8), 0]))
    runs = cuts[1::2] - cuts[::2]
    return int(-(-runs // SCAN_GROUP).sum() + (~jumped).sum())


def scan_timing(fn, result, runs: int, launches: int) -> dict:
    """``fn`` (a ``scan_call``) timed warm (``kernel_ms``) and split into
    its passes: behind a sleep kernel, one event before a call, its two
    marks (after the chunk sums, after the walk) and one after it (the
    replay), the median of ``runs`` calls each; with its chunks jumped and
    walked from ``result`` (a call's return) and the walk's decisions."""
    _, _, rec, nwalked = result
    jumped = (rec[:, 5] & 1).bool().cpu().numpy()
    if int(nwalked[0]) != int((~jumped).sum()):
        raise AssertionError(f"walked count {int(nwalked[0])}, records "
                             f"{int((~jumped).sum())}")
    ms = kernel_ms(fn, runs, launches)
    parts = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[0].record()
        fn(marks=ev[1:3])
        ev[3].record()
        ev[3].synchronize()
        parts.append([ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    sums, walk, replay = (statistics.median(q[k] for q in parts)
                          for k in range(3))
    decisions = scan_decisions(jumped)
    return {"ms": ms, "walk_ms": sums + walk, "sums_ms": sums,
            "replay_ms": replay,
            "chunks": len(jumped), "jumped": int(jumped.sum()),
            "walked": int((~jumped).sum()),
            "jumped_share": float(jumped.mean()) if len(jumped) else 1.0,
            "decisions": decisions,
            "walk_us_a_decision": walk * 1e3 / max(decisions, 1)}


def scan_design_bytes(n: int, T: int, chunk: int, S: int, B: int, E: int,
                      walked: int) -> int:
    """The bytes tape_scan.cu's passes must move at least: the function's
    own (audio, mod_q, the output, the tables), mod_q once more (the sums
    pass and the replay each read it), the sums' table written and read
    (16 bytes a chunk and row, kTableRows rows at most), the chunks'
    records written and read (32 bytes each), and the walked chunks' mod
    values staged twice (the walk and the replay)."""
    nch = -(-T // chunk)
    rows = min(S, 16)
    return (4 * (n + 2 * T + 4 * S + B + E + 10) + 4 * T
            + 16 * nch * (rows + 1) + 64 * nch + 8 * chunk * walked)


def tape_scan_ab(dev, card: str, src: str) -> dict:
    """The port's tape_scan.cu against ``src`` (another tape_scan.cu, e.g.
    the parent commit's, from ``git archive`` into ``_local/``) at config
    1's full size (T 8 745 204): the other's output and final state held
    bit-equal to the port's, then each timed in turns (port, other,
    other, port), SCAN_AB_TURNS calls a turn, one CUDA event pair a call
    behind a sleep kernel; the medians and every time.  The other's ``ts_launch`` must take
    per-sample scratch (idx0, fr, gi), as the one-warp design's does."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import tape
    from audio_suite_torch.ops import varispeed
    lib, ptxas = build_ab("ab_tape_scan", src)
    for row in ptxas:
        print(f"tape_scan A/B: ptxas other {row}", flush=True)
    with open(src) as f:
        per_sample = re.search(r"ts_launch\([^)]*\bint\* idx0",
                               f.read()) is not None
    if not per_sample:
        raise ValueError(f"{src}: its ts_launch takes no per-sample "
                         "scratch; only the one-warp design is compared")
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ts_launch.argtypes = [P, I, P, L, P, P, P, P, I, P, I, P, I, I, I, F,
                              F, I, I, F, P, P, P, P, P, P, P]
    lib.ts_error_string.restype = ctypes.c_char_p
    audio, p, frames = config1(TAPE_SECONDS)
    adev = torch.as_tensor(audio, device=dev)
    prog = tape.build_tape_program(adev, p, frames, device=dev)
    ins = tape.scan_inputs(prog, tape.wow_flutter_mod(frames, p.sample_rate,
                                                       p.tape_age))
    consts = prog["consts"]
    port = scan_call(ins, consts, kernels.TAPE_SCAN_CHUNK)
    words = varispeed.scan_state_words(None, consts, dev)
    T, n = ins[1].shape[0], ins[0].shape[0]
    scratch = [torch.empty(T, dtype=dt, device=dev)
               for dt in (torch.int32, torch.float32, torch.int32)]

    def other():
        out = torch.empty(T, dtype=torch.float32, device=dev)
        fin = torch.empty(5, dtype=torch.int32, device=dev)
        rc = lib.ts_launch(
            ins[0].data_ptr(), n, ins[1].data_ptr(), T, ins[2].data_ptr(),
            ins[3].data_ptr(), ins[4].data_ptr(), ins[5].data_ptr(),
            ins[2].shape[0], ins[6].data_ptr(), ins[6].shape[0],
            ins[7].data_ptr(), ins[7].shape[0], int(consts.anticlick_on),
            int(consts.smooth_len), float(consts.anticlick_strength),
            1.0 / max(1, int(consts.smooth_len)), int(consts.splice_on),
            int(consts.inertia_on), float(consts.alpha_q),
            words.data_ptr(), *(t.data_ptr() for t in scratch),
            out.data_ptr(), fin.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(lib.ts_error_string(rc).decode())
        return out, fin

    want, fin_w = port()[:2]
    got, fin_g = other()
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(fin_g, fin_w)):
        raise AssertionError("the other tape_scan.cu differs from the port's")
    fns = {"port": lambda: port(), "other": other}
    times = {k: [] for k in fns}
    for k in ("port", "other", "other", "port"):
        for _ in range(SCAN_AB_TURNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"tape_scan A/B (config 1, T {T}): bit-equal; port "
          f"{med['port']:.4f} ms, other {med['other']:.2f} ms in turns "
          f"(x{med['other'] / med['port']:.0f}) {card}", flush=True)
    return {"T": T, "ms": med, "ms_in_turns": times,
            "speedup": med["other"] / med["port"]}


def scan_windows(label: str, prog: dict, mod_q: np.ndarray,
                 y_full: np.ndarray = None) -> tuple[float, dict]:
    """The scan kernel bit-equal to its plain loop, all five state words
    too, on windows of SCAN_WINDOW frames of a full-size program: one
    centred on each visit's first frame (each section change, the wrap)
    of the program's C++ tables, each window started from the state the
    C++ trajectory gives at its first frame; and two at the first visit
    that starts a chunk or more in, whose first frame is the first (step
    K) and the last (step K - 1) step of one of the window launch's
    chunks (K = kernels.TAPE_SCAN_CHUNK).  With ``y_full`` (the full-size
    launch of the main path) each window must also give that launch's
    samples.  Returns (max |err|, what the windows held: the section
    changes by section entered, the wraps, the splice triggers, the
    reversed reads and those of them in (-1, 0), the chunk-edge windows
    with the step of their section change)."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import tape
    from audio_suite_torch.ops import varispeed
    from audio_suite_torch.utils import native_rt
    T, n = len(mod_q), int(prog["audio"].shape[0])
    consts, dev = prog["consts"], prog["audio"].device
    tab = tape.program_tables(prog)
    host = (prog["starts"], prog["ends"], prog["speeds_q"], prog["reverse"],
            prog["boundaries"], prog["splice_env"], consts, 0, 0)
    traj = native_rt.tape_trajectory(T, n, mod_q, *host)
    ins = tape.scan_inputs(prog, mod_q)
    vs = [int(v) for v in tab["visit_start"]]
    vsec = [int(v) for v in tab["visit_sec"]]
    wins = []
    for v in vs:
        a = min(max(v - SCAN_WINDOW // 2, 0), max(T - SCAN_WINDOW, 0))
        if wins and a < wins[-1][1]:
            a = wins[-1][1]
        if a < T:
            wins.append((a, min(a + SCAN_WINDOW, T)))
    K = kernels.TAPE_SCAN_CHUNK
    v_edge = next(v for v in vs[1:] if v >= K)
    edges = {"first": v_edge - K, "last": v_edge - K + 1}
    wins += [(a, min(a + SCAN_WINDOW, T)) for a in edges.values()]
    held = np.zeros(T, bool)
    err = 0.0
    for a, b in wins:
        held[a:b] = True
        st = None
        if a > 0:
            fin = native_rt.tape_trajectory(a, n, mod_q[:a], *host)["final"]
            st = varispeed.TapeState(*(
                torch.tensor(fin[k], dtype=torch.float32 if k == "speed"
                             else torch.int32, device=dev)
                for k in ("whole", "frac", "speed", "splice_rem",
                          "splice_idx")))
        w_ins = (ins[0], ins[1][a:b]) + ins[2:]
        want, st_w = varispeed.tape_scan_render_plain(*w_ins, consts, st)
        got, st_g = varispeed.tape_scan_render(*w_ins, consts, st)
        err = max(err, (got - want).abs().max().item())
        if not torch.equal(got, want) or tape_state(st_g) != \
                tape_state(st_w):
            raise AssertionError(
                f"tape_scan kernel differs from its plain version ({label}, "
                f"frames {a}-{b}): max |err| {err}, states "
                f"{tape_state(st_g)} / {tape_state(st_w)}")
        if y_full is not None and not np.array_equal(got.cpu().numpy(),
                                                     y_full[a:b]):
            raise AssertionError(f"tape_scan window {a}-{b} ({label}) "
                                 "differs from the full-size launch")
    rev = np.asarray(prog["reverse"], bool)
    vid = np.searchsorted(np.asarray(vs), np.arange(T), side="right") - 1
    rev_read = held & rev[np.asarray(vsec)[vid]]
    cover = {
        "windows": len(wins), "frames": int(held.sum()),
        "sections_entered": sorted({vsec[k] for k in range(1, len(vs))
                                    if held[vs[k]]}),
        "wraps": sum(1 for k in range(1, len(vs))
                     if held[vs[k]] and vsec[k] <= vsec[k - 1]),
        "splice_triggers": int(sum(held[t] for t in tab["triggers"])),
        "reversed_reads": int(rev_read.sum()),
        "reversed_reads_in_(-1,0)": int((rev_read & (traj["fr"] < 0)).sum()),
        "chunk_edge_windows": {k: [a, min(a + SCAN_WINDOW, T), v_edge - a]
                               for k, a in edges.items()}}
    return err, cover


def tape_other_path(dev, card: str):
    """Phase 10: the performance renderer at bench config 1's full size, the
    trace on the card against the CPU, the segment engine and the scan
    kernel; returns (lerp_read launches by path, the tape_scan row)."""
    from audio_suite_torch import kernels
    from audio_suite_torch.models import tape
    from audio_suite_torch.ops import lerp_read as lr
    from audio_suite_torch.ops import varispeed
    from audio_suite_torch.utils import native_rt

    t_phase = time.perf_counter()
    audio, p, frames = config1(TAPE_SECONDS)
    sr, n = p.sample_rate, len(audio)
    adev = torch.as_tensor(audio, device=dev)
    tr = config1_trace(n)

    # the trace, the main path: one render, every launch counted; then
    # TIMED_TRACES renders timed in render_tape_trace's two halves, the
    # host build_trace_programs and the segments' renders with the pull;
    # the render of the median wall gives the split
    reset_counts()
    y = tape.render_tape_trace(adev, p, tr, device=dev)
    trace_launches = read_counts()
    env_len = p.splice_env_len
    timed = []
    for _ in range(TIMED_TRACES):
        t0 = time.perf_counter()
        segs = tape.build_trace_programs(adev, p, tr, device=dev)
        t1 = time.perf_counter()
        tape.render_trace_segments(segs, env_len).cpu().numpy()
        t2 = time.perf_counter()
        timed.append((t2 - t0, t1 - t0, t2 - t1))
    wall, build_s, rest_s = sorted(timed)[len(timed) // 2]
    t0 = time.perf_counter()
    tape.wow_flutter_mod(frames, sr, p.tape_age)  # the segments' curves'
    curve_s = time.perf_counter() - t0            # work, in one call
    if len(segs) != TRACE_SEGMENTS:
        raise AssertionError(f"the config-1 trace has {len(segs)} segments")
    if trace_launches["lerp_read"] != len(segs) or any(
            v for k, v in trace_launches.items() if k != "lerp_read"):
        raise AssertionError(f"the trace's launches {trace_launches}: one "
                             f"lerp_read a segment ({len(segs)})")
    if y.shape != (frames,) or y.dtype != np.float32:
        raise AssertionError(f"trace render gave {y.shape} {y.dtype}")
    if not np.isfinite(y).all() or np.abs(y).max() > 1.0:
        raise AssertionError("trace render: non-finite or unclipped samples")
    peak = float(np.abs(y).max())
    if peak < 0.3:
        raise AssertionError(f"trace render is near silent: peak {peak}")
    device_ms = cuda_ms(lambda: tape.render_trace_segments(segs, env_len), 3)
    y_kernel = tape.render_trace_segments(segs, env_len)
    with mock.patch.object(varispeed, "lerp_read", lr.lerp_read_plain):
        y_plain = tape.render_trace_segments(segs, env_len)
    if not (torch.equal(y_kernel, y_plain)
            and np.array_equal(y_kernel.cpu().numpy(), y)):
        raise AssertionError("trace render with the kernel differs from the "
                             "render with the plain read")
    pieces = tape._splice_pieces(segs, env_len)
    print(f"trace: config 1 with a performance, {len(tr.events)} events -> "
          f"{len(segs)} segments ({', '.join(str(s['t1'] - s['t0']) for s in segs)} "
          f"frames), {len(pieces)} splice pieces; T {frames} f32 peak "
          f"{peak:.4f}; launches {trace_launches}; bit-equal with the plain "
          f"read; render wall median {wall * 1e3:.1f} ms of {TIMED_TRACES} "
          f"({', '.join(f'{w[0] * 1e3:.1f}' for w in timed)}) = host "
          f"build_trace_programs {build_s * 1e3:.1f} ms (the host "
          f"wow/flutter curve over the {frames} frames alone "
          f"{curve_s * 1e3:.1f} ms) + the segments' renders and the pull "
          f"{rest_s * 1e3:.1f} ms (their device window {device_ms:.3f} ms); "
          f"realtime x{frames / sr / wall:.1f} {card}", flush=True)

    # the trace on the card against the CPU at the tests' size
    for label, (a, pp, ttr, nf) in small_traces().items():
        yg = tape.render_tape_trace(a, pp, ttr, nf, device=dev)
        yc = tape.render_tape_trace(a, pp, ttr, nf, device="cpu")
        d = np.abs(yg.astype(np.float64) - yc).max()
        db = 20 * np.log10(max(d, 1e-300))
        if db > -120.0:
            raise AssertionError(f"trace {label} on the card is {db:.1f} "
                                 "dBFS from the CPU")
        print(f"trace {label} (SR {TRACE_SR}, {nf} frames): card vs CPU "
              f"{db:.2f} dBFS (bit-equal: {bool(np.array_equal(yg, yc))})",
              flush=True)

    # the segment engine at full size, its launches counted, against the
    # device engine, and against itself with the plain read (mocked as in
    # phase 4) on the same inputs
    y_dev = tape.render_tape(adev, p, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    y_seg = tape.render_tape(adev, p, device=dev, engine="segment")
    seg_wall = time.perf_counter() - t0
    seg_launches = read_counts()
    t0 = time.perf_counter()
    full = tape.build_tape_program(adev, p, frames, device=dev)
    mod_q = tape.wow_flutter_mod(frames, sr, p.tape_age)
    seg_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_rt.tape_trajectory(
        frames, n, mod_q, full["starts"], full["ends"], full["speeds_q"],
        full["reverse"], full["boundaries"], full["splice_env"],
        full["consts"], 0, 0)
    seg_traj = time.perf_counter() - t0
    if seg_launches["lerp_read"] != 1 or any(
            v for k, v in seg_launches.items() if k != "lerp_read"):
        raise AssertionError(f"the segment engine's launches {seg_launches}")
    db = 20 * np.log10(max(np.abs(y_seg.astype(np.float64) - y_dev).max(),
                           1e-300))
    if db > -120.0:
        raise AssertionError(f"segment engine {db:.1f} dBFS from the device "
                             "engine")
    sec_args = (mod_q, full["starts"], full["ends"], full["speeds_q"],
                full["reverse"], full["boundaries"], full["splice_env"],
                full["consts"])
    with mock.patch.object(varispeed, "lerp_read", lr.lerp_read_plain):
        y_seg_plain, _ = varispeed.tape_segment_render(adev, *sec_args)
    if not np.array_equal(y_seg_plain.cpu().numpy(), y_seg):
        raise AssertionError("segment engine with the kernel differs from "
                             "the render with the plain read")
    print(f"segment engine: T {frames}, {db:.2f} dBFS from the device "
          f"engine; bit-equal with the plain read; launches {seg_launches}; "
          f"wall {seg_wall * 1e3:.1f} ms: the program with its host "
          f"wow/flutter curve {seg_build * 1e3:.1f} ms, the C++ trajectory "
          f"{seg_traj * 1e3:.1f} ms, the rest (upload, read, pull) "
          f"{(seg_wall - seg_build - seg_traj) * 1e3:.1f} ms {card}",
          flush=True)

    # the scan kernel against its plain version at the smoke tape's start
    a_s, p_s, _ = config1(4.0)
    err, plain_s, small_ms = 0.0, {}, {}
    for inertia in (True, False):
        p_s.inertia_enabled = inertia
        prog = tape.build_tape_program(a_s, p_s, SCAN_PLAIN_FRAMES,
                                       device=dev)
        ins = tape.scan_inputs(prog, tape.wow_flutter_mod(
            SCAN_PLAIN_FRAMES, sr, p_s.tape_age))
        t0 = time.perf_counter()
        want, st_w = varispeed.tape_scan_render_plain(*ins, prog["consts"])
        torch.cuda.synchronize()
        plain_s[inertia] = time.perf_counter() - t0
        got, st_g = varispeed.tape_scan_render(*ins, prog["consts"])
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        if not torch.equal(got, want) or tape_state(st_g) != tape_state(st_w):
            raise AssertionError(f"tape_scan kernel differs from its plain "
                                 f"version (inertia {inertia}): max |err| "
                                 f"{err}, states {tape_state(st_g)} / "
                                 f"{tape_state(st_w)}")
        small_ms[inertia] = cuda_ms(
            lambda: varispeed.tape_scan_render(*ins, prog["consts"]), 3)
        print(f"tape_scan (config 1's smoke tape, {SCAN_PLAIN_FRAMES} "
              f"frames, inertia {inertia}): bit-equal to plain, final state "
              f"{tape_state(st_g)} equal; kernel {small_ms[inertia]:.4f} ms, "
              f"plain {plain_s[inertia] * 1e3:.1f} ms "
              f"({plain_s[inertia] / SCAN_PLAIN_FRAMES * 1e6:.1f} us a "
              f"sample) {card}", flush=True)

    # the scan engine at full size: the main path's launch, against the
    # segment engine, with the final state; the kernel bit-identical at
    # each chunk length; against its plain loop on windows across every
    # section change of config 1's program and of a variant with inertia
    # on and section 0 reversed and slowed (its last frame read in (-1,
    # 0)); then its times, split and bounds, and the variant's
    reset_counts()
    y_scan = tape.render_tape(adev, p, device=dev, engine="scan")
    scan_launches = read_counts()
    if scan_launches["tape_scan"] != 1 or any(
            v for k, v in scan_launches.items() if k != "tape_scan"):
        raise AssertionError(f"the scan engine's launches {scan_launches}")
    db = 20 * np.log10(max(np.abs(y_scan.astype(np.float64) - y_seg).max(),
                           1e-300))
    if db > -120.0:
        raise AssertionError(f"scan engine {db:.1f} dBFS from the segment "
                             "engine")
    ins = tape.scan_inputs(full, mod_q)
    calls = {K: scan_call(ins, full["consts"], K) for K in SCAN_CHUNKS}
    runs = {K: fn() for K, fn in calls.items()}
    out0, fin0 = runs[kernels.TAPE_SCAN_CHUNK][:2]
    if not np.array_equal(out0.cpu().numpy(), y_scan):
        raise AssertionError("the scan launch differs from render_tape's")
    for K, (out, fin, _, _) in runs.items():
        if not (torch.equal(out, out0) and torch.equal(fin, fin0)):
            raise AssertionError(f"the scan at chunk {K} differs from chunk "
                                 f"{kernels.TAPE_SCAN_CHUNK}")
    st = varispeed.scan_state(fin0)
    _, fin = varispeed.tape_segment_render(adev, *sec_args)
    if tape_state(st)[:3] != (fin["whole"], fin["frac"], fin["speed"]):
        raise AssertionError(f"scan final state {tape_state(st)}, segment "
                             f"engine's {fin}")
    p_b = tape.TapeParams.from_snapshot(p.snapshot())
    p_b.section_reverse = [True] + list(p.section_reverse[1:])
    p_b.section_speeds = [0.5] + list(p.section_speeds[1:])
    p_b.inertia_enabled, p_b.inertia_amount = True, 80
    full_b = tape.build_tape_program(adev, p_b, frames, device=dev)
    t0 = time.perf_counter()
    covers = {}
    for label, prog, yf in (("config 1", full, y_scan),
                            ("inertia, section 0 reversed", full_b, None)):
        e, covers[label] = scan_windows(label, prog, mod_q, yf)
        err = max(err, e)
    win_s = time.perf_counter() - t0
    c1, cb = covers["config 1"], covers["inertia, section 0 reversed"]
    revs = {k for k, r in enumerate(p.section_reverse) if r}
    if not (revs <= set(c1["sections_entered"]) and c1["wraps"]
            and c1["splice_triggers"] and cb["reversed_reads_in_(-1,0)"]
            and 1 in cb["sections_entered"]):
        raise AssertionError(f"the scan windows miss a case: {covers}")
    print(f"tape_scan windows (config 1's full-size program, T {frames}, "
          f"{SCAN_WINDOW} frames each, from the C++ trajectory's state): "
          f"bit-equal to plain, all five state words equal, and equal to "
          f"the full-size launch's samples: {json.dumps(c1)}; with inertia "
          f"and section 0 reversed at speed 0.5: {json.dumps(cb)}; "
          f"{win_s:.1f} s", flush=True)

    inertia = full["consts"].inertia_on
    S, B = len(full["starts"]), len(full["boundaries"])
    E = len(full["splice_env"])
    bound, bound_by = bound_ms(4 * (n + 2 * frames + 4 * S + B + E + 10),
                               TAPE_SCAN_FLOPS[inertia] * frames)
    by_chunk = {}
    for K, fn in calls.items():
        by_chunk[K] = scan_timing(fn, runs[K], TIMED_KERNEL_RUNS,
                                  KERNEL_LAUNCHES)
        by_chunk[K].update(design_bytes_bound_ms=scan_design_bytes(
            n, frames, K, S, B, E, by_chunk[K]["walked"]) / HBM_BYTES_S
            * 1e3)
    main = by_chunk[kernels.TAPE_SCAN_CHUNK]
    ins_b = tape.scan_inputs(full_b, mod_q)
    fn_b = scan_call(ins_b, full_b["consts"], kernels.TAPE_SCAN_CHUNK)
    variant = scan_timing(fn_b, fn_b(), SCAN_VARIANT_RUNS, 1)
    for K, t in by_chunk.items():
        print(f"tape_scan (config 1, T {frames}, inertia {inertia}, chunk "
              f"{K}): {t['ms']:.4f} ms; one call's passes: walk "
              f"{t['walk_ms']:.4f} (the sums {t['sums_ms']:.4f}) + replay "
              f"{t['replay_ms']:.4f}; chunks {t['chunks']}: jumped "
              f"{t['jumped']} ({t['jumped_share']:.3%}), walked "
              f"{t['walked']}; the walk's {t['decisions']} decisions, "
              f"{t['walk_us_a_decision']:.3f} us each (the sums apart); the "
              f"design's bytes "
              f"{t['design_bytes_bound_ms']:.4f} ms, the function's bound "
              f"{bound:.4f} ms by {bound_by} ({bound / t['ms']:.2%} of it "
              f"reached) {card}", flush=True)
    print(f"tape_scan (config 1): {db:.2f} dBFS from the segment engine, "
          f"final whole/frac/speed equal {tape_state(st)[:3]}; launches "
          f"{scan_launches}; bit-identical at chunks {list(SCAN_CHUNKS)}; "
          f"the inertia variant (inertia 80, section 0 reversed at 0.5), "
          f"chunk {kernels.TAPE_SCAN_CHUNK}: {variant['ms']:.4f} ms = walk "
          f"{variant['walk_ms']:.4f} + replay {variant['replay_ms']:.4f}; "
          f"jumped {variant['jumped']} of {variant['chunks']} "
          f"({variant['jumped_share']:.3%}), walked {variant['walked']}; "
          f"plain {plain_s[True] / SCAN_PLAIN_FRAMES * 1e6:.1f} us a "
          f"sample (inertia on, {SCAN_PLAIN_FRAMES} frames) {card}",
          flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)

    row = {"name": "tape_scan", "route": "cuda",
           "source": "audio_suite_torch/kernels/tape_scan.cu",
           "replaces": "audio_suite_tpu/ops/varispeed.py:126 (tape_scan_"
                       "render's lax.scan; no Pallas kernel)",
           "launches": scan_launches["tape_scan"], "max_abs_err": err,
           "ms": main["ms"], "plain_ms": plain_s[True] * 1e3,
           "plain_frames": SCAN_PLAIN_FRAMES,
           "ms_at_plain_frames": small_ms[True],
           "bound_ms": bound, "bound_by": bound_by,
           "chunk": kernels.TAPE_SCAN_CHUNK, "by_chunk": by_chunk,
           "inertia_variant": variant, "windows": covers,
           "library_ms": None}
    by_path = {"trace": trace_launches["lerp_read"],
               "segment": seg_launches["lerp_read"]}
    return by_path, row


# ---- phase 11: the parallel layer: Microsound batch renders, the sharded
# CA, the sharded timeline, the dry run, multi-process dispatch

PAR_STRETCHES = (4.0, 2.0)  # the batch's stretches (config 3's x4, then x2)
PAR_TIMED_ROUNDS = 2       # batch, sequential, sequential, batch: x this
PAR_CA = ((4, 120), (8, 40))   # (shards on one card, steps)
PAR_CONV_N = 768000        # config 3's length: 4 s at 192 kHz
PAR_CONV_SHARDS = 8
PAR_LONG_K = 200000        # a kernel longer than one of its 96 000 blocks
PAR_DRYRUN = 4             # dryrun_multichip's mesh


def batch_jobs(p, seeds) -> list:
    """The batch's params in job order (seeds x stretches)."""
    from audio_suite_torch.models import microsound as ms
    return [ms.MicrosoundParams.from_dict(dict(p.to_dict(), seed=s,
                                               partial_stretch=st))
            for s in seeds for st in PAR_STRETCHES]


def sequential_renders(jobs, ir, dev, out_dir: str) -> np.ndarray:
    """Each job rendered, pulled and written before the next; returns the
    host ms of each part (the render's call, the pull, the write) summed
    over the jobs."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.utils import io as audio_io
    parts = np.zeros(3)
    for k, q in enumerate(jobs):
        t0 = time.perf_counter()
        y, _ = ms.render(q, ir_audio=ir, device=dev)
        t1 = time.perf_counter()
        host = y.cpu().numpy()
        t2 = time.perf_counter()
        audio_io.write_wav(os.path.join(out_dir, f"seq{k}.wav"), host,
                           int(q.base_sr))
        parts += np.array([t1 - t0, t2 - t1, time.perf_counter() - t2]) * 1e3
    return parts


def burnt_shards(state: np.ndarray, state0: np.ndarray, D: int) -> int:
    """Shards holding a cell that burnt (fire or ash, from a tree) in the
    run: more than one shows the fire crossed shard rows."""
    from audio_suite_torch.models import forestfire as ff
    burnt = (state != state0) & ((state == ff.FIRE) | (state == ff.ASH))
    rows = np.nonzero(burnt.any(axis=1))[0]
    return len({int(r) // (state.shape[0] // D) for r in rows})


def parallel_batch(dev, card: str, tmp: str) -> tuple:
    """Phase 11's Microsound batches; returns (the config-3 batch's launch
    counts, the stick-slip batch's)."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.parallel import batch as pb
    from audio_suite_torch.utils import io as audio_io

    p, ir = config3(full=True)
    seeds = (p.seed, p.seed + 1)
    jobs = batch_jobs(p, seeds)
    man = os.path.join(tmp, "m.json")
    reset_counts()
    paths = ms.batch_render(p, os.path.join(tmp, "b"), seeds=seeds,
                            stretches=PAR_STRETCHES, ir_audio=ir,
                            manifest_path=man, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    if len(paths) != len(jobs) or pb.BatchManifest.load(man).pending():
        raise AssertionError(f"batch wrote {len(paths)} of {len(jobs)} "
                             "jobs")
    if counts["overlap_add"] != len(jobs):
        raise AssertionError(f"batch launched {counts['overlap_add']} "
                             f"overlap-adds for {len(jobs)} jobs")
    for q, path in zip(jobs, paths):
        want, _ = ms.render(q, ir_audio=ir, device=dev)
        got, sr = audio_io.read_wav(path)
        if sr != p.base_sr or not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(f"{os.path.basename(path)} differs from "
                                 "the single render on the card")
    reset_counts()
    again = ms.batch_render(p, os.path.join(tmp, "b"), seeds=seeds,
                            stretches=PAR_STRETCHES, ir_audio=ir,
                            manifest_path=man, device=dev)
    resumed = read_counts()["overlap_add"]
    if again != paths or resumed:
        raise AssertionError(f"the resumed batch rendered ({resumed} "
                             "overlap-adds)")
    print(f"batch: config 3 x seeds {list(seeds)} x stretches "
          f"{list(PAR_STRETCHES)}: {len(paths)} WAVs bit-equal to single "
          f"renders on the card; launches {counts}; resumed with 0 renders",
          flush=True)

    # a job made to fail (its WAV path is a directory) is marked failed,
    # the others finish
    out2, man2 = os.path.join(tmp, "f"), os.path.join(tmp, "f.json")
    bad = os.path.join(out2, f"seed{seeds[1]}_unfold100_stretch4.wav")
    os.makedirs(bad)
    done = ms.batch_render(p, out2, seeds=(seeds[0], seeds[1],
                                           seeds[1] + 1),
                           stretches=PAR_STRETCHES[:1], ir_audio=ir,
                           manifest_path=man2, device=dev)
    m2 = pb.BatchManifest.load(man2)
    failed = {j: v for j, v in m2.jobs.items() if v["status"] != "done"}
    if (len(done) != 2 or list(failed) != [os.path.basename(bad)[:-4]]
            or "IsADirectoryError" not in failed[list(failed)[0]]["error"]):
        raise AssertionError(f"failed-job isolation: {m2.jobs}")
    print(f"batch: a job made to fail is marked failed "
          f"({failed[list(failed)[0]]['error'][:40]}...), the other "
          f"{len(done)} done", flush=True)

    # stick-slip: grain_scan.cu's fused kernel on the batch's path
    pss = ms.MicrosoundParams.from_dict(dict(p.to_dict(),
                                             gen_mode="Stick–slip friction"))
    reset_counts()
    ss_paths = ms.batch_render(pss, os.path.join(tmp, "s"), seeds=seeds,
                               ir_audio=ir, device=dev)
    torch.cuda.synchronize()
    ss_counts = read_counts()
    if len(ss_paths) != 2 or ss_counts["stick_slip_noise_scan"] < 2 \
            or ss_counts["stick_slip_scan"]:
        raise AssertionError(f"stick-slip batch: {len(ss_paths)} WAVs, "
                             f"launches {ss_counts}")
    for s, path in zip(seeds, ss_paths):
        want, _ = ms.render(ms.MicrosoundParams.from_dict(
            dict(pss.to_dict(), seed=s)), ir_audio=ir, device=dev)
        if not np.array_equal(audio_io.read_wav(path)[0],
                              want.cpu().numpy()):
            raise AssertionError(f"stick-slip {path} differs from its "
                                 "single render")
    print(f"batch: stick-slip x seeds {list(seeds)} bit-equal to single "
          f"renders; launches {ss_counts}", flush=True)

    # the batch's wall beside the same jobs one after another, in turns
    walls = {"batch": [], "sequential": []}
    parts = []
    for r in range(PAR_TIMED_ROUNDS):
        for kind in ("batch", "sequential", "sequential", "batch"):
            d = os.path.join(tmp, f"t{r}{kind}{len(walls[kind])}")
            os.makedirs(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "batch":
                ms.batch_render(p, d, seeds=seeds, stretches=PAR_STRETCHES,
                                ir_audio=ir, device=dev)
            else:
                parts.append(sequential_renders(jobs, ir, dev, d))
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in walls.items()}
    split = np.median(np.stack(parts), axis=0)
    print(f"timing: {len(jobs)}-job config-3 batch wall median "
          f"{med['batch']:.2f} ms (in turns {walls['batch']}) against "
          f"{len(jobs)} sequential render + pull + write {med['sequential']:.2f}"
          f" ms ({walls['sequential']}): the pipeline "
          f"{'overlapped' if med['batch'] < med['sequential'] else 'did not overlap'}"
          f" ({med['sequential'] - med['batch']:.2f} ms); the sequential "
          f"jobs' host time: render calls {split[0]:.2f} ms, pulls "
          f"{split[1]:.2f} ms, WAV writes {split[2]:.2f} ms {card}",
          flush=True)
    med["sequential_split_ms"] = dict(zip(("render", "pull", "write"),
                                          split.tolist()))
    return counts, ss_counts, med


def parallel_ca(dev, card: str) -> dict:
    """Phase 11's sharded CA at config 5's size on one card repeated."""
    from audio_suite_torch.parallel import batch as pb
    from audio_suite_torch.parallel import ca
    out = {}
    for D, steps in PAR_CA:
        model, _, _ = config5_fire(dev)
        carry0 = {k: np.array(v) for k, v in model._np.items()}
        mesh = pb.make_mesh(D, axis_names=("sp",), devices=[dev] * D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, stats = ca.simulate_sharded(model.params, carry0, steps, mesh,
                                           seed=model.seed)
        t_sh = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = model.simulate(steps)
        t_de = time.perf_counter() - t0
        if not np.array_equal(stats, dense):
            raise AssertionError(f"sharded CA on {D} shards: stats differ "
                                 "from the dense engine")
        for k in ("state", "fuel", "moisture", "age"):
            if not np.array_equal(carry[k].cpu().numpy(), model._np[k]):
                raise AssertionError(f"sharded CA on {D} shards: {k} "
                                     "differs from the dense engine")
        shards = burnt_shards(model._np["state"], carry0["state"], D)
        embers = int(stats[:, 6].sum())
        if embers == 0 or shards < 2:
            raise AssertionError(f"sharded CA on {D} shards: {embers} "
                                 f"embers, fire in {shards} shards")
        out[D] = {"steps": steps, "sharded_steps_s": steps / t_sh,
                  "dense_steps_s": steps / t_de}
        print(f"ca: {D} shards of {model.params.h // D} rows, {steps} steps "
              f"bit-identical to dense (stats and the state, fuel, moisture "
              f"and age planes); {embers} embers, fire in {shards} of {D} "
              f"shards; sharded {steps / t_sh:.1f} steps/s against dense "
              f"{steps / t_de:.1f} steps/s {card}", flush=True)
    return out


def parallel_conv(dev, card: str):
    """Phase 11's timeline conv at config 3's length on 8 shards."""
    from audio_suite_torch.models import microsound as ms
    from audio_suite_torch.ops import space
    from audio_suite_torch.parallel import batch as pb
    from audio_suite_torch.parallel import timeline as tl
    p, ir = config3(full=True)
    er_ir, _, _ = ms._space_kernels(p, ir)
    rng = np.random.default_rng(17)
    x = rng.standard_normal(PAR_CONV_N).astype(np.float32)
    long_k = (rng.standard_normal(PAR_LONG_K)
              * np.exp(-np.arange(PAR_LONG_K) / 40000.0)).astype(np.float32)
    mesh = pb.make_mesh(PAR_CONV_SHARDS, devices=[dev] * PAR_CONV_SHARDS)
    for label, k in (("config 3's ER (x) IR", er_ir), ("long", long_k)):
        got = tl.sharded_fir_conv(x, k, mesh)
        ms_sh = cuda_ms(lambda: tl.sharded_fir_conv(x, k, mesh), 3)
        want = space.fft_convolve_causal(torch.as_tensor(x, device=dev),
                                         torch.as_tensor(k, device=dev))
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel <= 1e-5:
            raise AssertionError(f"timeline conv ({label}, K {len(k)}) "
                                 f"{rel:.3g} relative")
        print(f"timeline: {PAR_CONV_N} samples over {PAR_CONV_SHARDS} "
              f"shards, {label} kernel K {len(k)} "
              f"({(len(k) - 1) // (PAR_CONV_N // PAR_CONV_SHARDS) + 1} "
              f"hops): {rel:.3g} relative to fft_convolve_causal on the "
              f"card; {ms_sh:.2f} ms a call (host upload included) {card}",
              flush=True)


def parallel_distributed(card: str):
    """Phase 11's multi-process checks: the two-process self-test (each
    rank's jobs on cuda:0, gathered through gloo) and a world-size-1 NCCL
    group that all_gathers a CUDA tensor, each in its own processes."""
    import socket
    import tempfile

    def port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=REPO)
    with tempfile.TemporaryDirectory() as tmp:
        coord = f"127.0.0.1:{port()}"
        outs = [os.path.join(tmp, f"p{i}.json") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "audio_suite_torch.parallel.distributed",
             coord, "2", str(i), outs[i], "cuda"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        try:
            res = []
            for pr, out in zip(procs, outs):
                so, se = pr.communicate(timeout=300)
                if pr.returncode != 0:
                    raise AssertionError(f"self-test rank failed "
                                         f"rc={pr.returncode}:\n{so}\n{se}")
                with open(out) as f:
                    res.append(json.load(f))
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.communicate()
    for r in res:
        if not (r["ok"] and r["process_count"] == 2
                and r["global_devices"] == 4 and r["mesh_shape"] == [2, 2]
                and r["device"] == "cuda"):
            raise AssertionError(f"self-test: {r}")
    print(f"distributed: two-process self-test on cuda:0, gathered through "
          f"gloo: max_err {res[0]['max_err']:.3g}, mix_err "
          f"{res[0]['mix_err']:.3g}, mesh {res[0]['mesh_shape']}", flush=True)
    code = (
        "import torch, torch.distributed as dist\n"
        f"dist.init_process_group('nccl', init_method='tcp://127.0.0.1:"
        f"{port()}', world_size=1, rank=0)\n"
        "x = torch.arange(8, dtype=torch.float32, device='cuda:0')\n"
        "parts = [torch.empty_like(x)]\n"
        "dist.all_gather(parts, x)\n"
        "torch.cuda.synchronize()\n"
        "assert torch.equal(parts[0], x), parts\n"
        "dist.destroy_process_group()\n"
        "print('nccl ok')\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or "nccl ok" not in r.stdout:
        raise AssertionError(f"NCCL world-size-1 all_gather failed "
                             f"rc={r.returncode}:\n{r.stdout}\n{r.stderr}")
    print("distributed: a world-size-1 NCCL group all_gathered a CUDA "
          "tensor; more than one NCCL rank needs a card each (NCCL refuses "
          "two ranks on one card), so it waits for a machine with several "
          "cards", flush=True)


def parallel_path(dev, card: str) -> dict:
    """Phase 11: the parallel layer; returns each path's launch counts
    ("batch": the config-3 and stick-slip batches, "dryrun") and the
    figures."""
    import tempfile
    from audio_suite_torch.parallel import dryrun
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts, ss_counts, walls = parallel_batch(dev, card, tmp)
    ca_rates = parallel_ca(dev, card)
    parallel_conv(dev, card)
    reset_counts()
    notes = dryrun.dryrun_multichip(PAR_DRYRUN, devices=[dev] * PAR_DRYRUN)
    torch.cuda.synchronize()
    dry = read_counts()
    for k in ("overlap_add", "lerp_read", "scrub_read"):
        if not dry[k]:
            raise AssertionError(f"the dry run did not launch {k}")
    print(f"dryrun: {len(notes)} checks on [cuda:0] x {PAR_DRYRUN}; "
          f"launches {dry}", flush=True)
    parallel_distributed(card)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    batch = {k: counts[k] + ss_counts[k] for k in counts}
    return {"batch": batch, "dryrun": dry, "batch_walls_ms": walls,
            "ca_steps_s": ca_rates}


def main() -> int:
    # ---- 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from audio_suite_torch import kernels

    dev = torch.device("cuda", 0)
    name_limit = smi("name,power.limit")
    card = f"[{name_limit}]"
    print(f"probe: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} {card}", flush=True)

    # ---- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(kernels.build, KERNELS)))
    for k, so in built.items():
        print(f"build: {k}.cu -> {os.path.relpath(so, REPO)}", flush=True)
        for row in ptxas_summary(so):
            print(f"build:   ptxas {row}", flush=True)
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if sys.argv[1:2] == ["--scan-ab"]:
        print(json.dumps({"scan_ab": scan_ab(dev, card, sys.argv[2])}))
        print(name_limit)
        return 0
    if sys.argv[1:2] == ["--tape-scan-ab"]:
        print(json.dumps({"tape_scan_ab": tape_scan_ab(dev, card,
                                                       sys.argv[2])}))
        print(name_limit)
        return 0

    # ---- 3.-8. the paths; the overlap-add runs on two of them, so its
    # row counts the launches of both and holds config 4's figures; the
    # lerp read's clamp form carries the tape, its fused scrub form (a
    # second kernel of the same source) the scrub
    oa_row = microsound_path(dev, card)
    lr_row = tape_path(dev, card)
    pl_oa = patternlab_path(dev, card)
    sr_row = scrub_path(dev, card)
    grid = grid_path(dev, card)
    fire_path(dev, card, grid["run_wall_ms"])
    scan_rows_, ms_oa = microsound_all_path(dev, card)
    oa_row["launches_by_path"] = {"microsound": oa_row["launches"],
                                  "patternlab": pl_oa["launches"],
                                  "microsound_all_paths": ms_oa}
    oa_row["launches"] += pl_oa["launches"] + ms_oa
    oa_row["config4"] = pl_oa
    # ---- 10. the tape's trace, segment and scan paths; the clamp read
    # carries the trace and the segment engine too
    lr_paths, ts_row = tape_other_path(dev, card)
    lr_row["launches_by_path"] = dict(config1=lr_row["launches"], **lr_paths)
    lr_row["launches"] += sum(lr_paths.values())
    # ---- 11. the parallel layer: each path's launches join its rows
    par = parallel_path(dev, card)
    sr_row.setdefault("launches_by_path", {"config2": sr_row["launches"]})
    ss_row = next(r for r in scan_rows_
                  if r["name"] == "stick_slip_noise_scan")
    ss_row.setdefault("launches_by_path",
                      {"microsound_all_paths": ss_row["launches"]})
    for row, name in ((oa_row, "overlap_add"), (lr_row, "lerp_read"),
                      (sr_row, "scrub_read"),
                      (ss_row, "stick_slip_noise_scan")):
        for path in ("batch", "dryrun"):
            if par[path][name]:
                row["launches_by_path"][path] = par[path][name]
                row["launches"] += par[path][name]
    rows = [oa_row, lr_row, sr_row] + scan_rows_ + [ts_row]

    print(json.dumps({"kernels": rows}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

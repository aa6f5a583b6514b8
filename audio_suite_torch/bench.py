"""Benchmark harness of the port: bench.py's five configurations, rendered
through the port's public API on a CUDA card (or, asked for explicitly,
on the CPU):

    python -m audio_suite_torch.bench                  # on the card
    python -m audio_suite_torch.bench --device cpu --smoke
    python -m audio_suite_torch.cli --device cuda bench

Prints ONE JSON line: {"metric": "rtf_geomean", "value", "unit",
"vs_baseline", "rtf_<config>" for the five configurations, the
"rtf_*_compute" rates, "rtf_tape_param_tweak", "patternlab_prepare_ms",
"decomp_<engine>", "null_loop_latency_ms", "d2h_MBps", "device"} and
"failures" when a configuration raised; the process then exits non-zero.
metric = the geometric mean of the five realtime factors (audio seconds
per wall second); vs_baseline divides it by bench.py's 1000x target.
"device" names the card and its power limit as nvidia-smi gives them.

The configurations keep bench.py's sizes, parameters and seeds
(``--smoke``: its BENCH_SMOKE=1 sizes, for the CPU tests).  Each ``run()``
renders PCM16 through the engine's entry point, pulls it to the host and,
for the mono engines, duplicates the channel on the host, all inside the
timed region.  Timing protocol:

- a configuration's wall: the best of 2-3 timed ``run()`` calls after
  one warm-up, its outputs checked finite;
- a compute rate: ``time_device``, K back-to-back dispatches of the
  device render (output left on the device) between two CUDA events,
  after a synchronize; K grows until the loop is at least 4x the null
  loop, the best of 3 loops divided by K: the amortized time a dispatch
  takes, idle gaps included;
- ``null_loop_latency_ms``: one trivial launch and a ``.item()`` drain,
  the median of 5; ``d2h_MBps``: one 8 MB int16 ``.cpu()``.

On the CPU the same loops run on ``time.perf_counter``.  The harness never
falls back to the CPU: ``--device cuda`` (the default) without a card
exits with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("tape", "scrub", "microsound", "patternlab", "grid_forestfire")
BASELINE_RTF = 1000.0     # bench.py's target: 1000x realtime per chip


class Clock:
    """The timing protocol on one device: CUDA events on a card,
    ``time.perf_counter`` on the CPU (whose ops return when done)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._null_s = None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def null_loop_s(self) -> float:
        """One trivial launch and a data-dependent scalar drain, the
        median of 5 after a warm-up."""
        if self._null_s is None:
            y = torch.zeros(8, dtype=torch.float32, device=self.device)
            y = y + 1.0
            float(y.abs().sum().item())
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                y = y + 1.0
                float(y.abs().sum().item())
                ts.append(time.perf_counter() - t0)
            self._null_s = statistics.median(ts)
        return self._null_s

    def _loop_s(self, fn, K: int) -> float:
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(K):
                fn()
            return time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(K):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3

    def time_device(self, fn, K: int = 5) -> float:
        """Amortized seconds a dispatch of ``fn`` takes: K back-to-back
        calls between two events, K grown until the loop is at least 4x
        the null loop, the best of 3 loops over K."""
        lat = self.null_loop_s()
        fn()
        self.sync()
        while True:
            total = self._loop_s(fn, K)
            if total >= 4.0 * lat or K >= 160:
                break
            K *= 4
        for _ in range(2):
            total = min(total, self._loop_s(fn, K))
        return total / K

    def time_best(self, fn, repeats: int = 3, check=None) -> float:
        """Best wall of ``repeats`` timed calls after one warm-up; the
        ``check`` dict's values must be finite after the warm-up."""
        fn()
        if check is not None:
            for k, v in check.items():
                if not np.isfinite(np.asarray(v)).all():
                    raise FloatingPointError(f"non-finite {k}")
        return self.best_s(fn, repeats)

    def best_s(self, fn, repeats: int = 3) -> float:
        """Best wall of ``repeats`` calls (callers warm up); each call is
        followed by a synchronize, so device work is inside it."""
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            self.sync()
            best = min(best, time.perf_counter() - t0)
        return best


def _decomp(extras, name, e2e_s, kernel_s, stages):
    """bench.py's per-engine decomposition, in ms: e2e = host build +
    device kernel + pull + host post + residual; ``stages`` maps label ->
    seconds; host_nonlink_ms sums the build and host stages."""
    d = {"e2e_ms": round(e2e_s * 1e3, 2),
         "kernel_ms": round(kernel_s * 1e3, 2)}
    acc = kernel_s
    host = 0.0
    for label, sec in stages.items():
        d[f"{label}_ms"] = round(sec * 1e3, 2)
        acc += sec
        if label == "build" or label.startswith("host"):
            host += sec
    d["residual_ms"] = round((e2e_s - acc) * 1e3, 2)
    d["host_nonlink_ms"] = round(host * 1e3, 2)
    extras[f"decomp_{name}"] = d


def _test_audio(sr, seconds, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


def bench_tape(clock: Clock, extras: dict, smoke: bool) -> float:
    """Config 1 (bench.py:157): a 180 s tape chopped into six sections at
    mixed speeds, two reversed, retimed to its length; stereo 48 kHz as
    the mono render's channel duplicated on the host.  run() goes through
    the cached program; rtf_tape_param_tweak rebuilds it every call."""
    from .models import tape

    dev = clock.device
    sr = 48000
    seconds = 4.0 if smoke else 180.0
    audio = _test_audio(sr, seconds)
    n = len(audio)
    markers = [int(n * f) for f in (0.12, 0.3, 0.45, 0.6, 0.8)]
    params = tape.TapeParams(
        sample_rate=sr, markers=markers,
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    params.section_speeds = tape.fit_to_target_time(params, n, seconds)
    frames = tape.section_render_length(params, n)
    adev = torch.as_tensor(audio, device=dev)     # the tape, loaded once
    out = {}

    def run():
        prog = tape.build_tape_program_cached(adev, params, frames,
                                              device=dev)
        mono = tape.tape_table_render(prog, out_i16=True)[0]
        out["y"] = np.repeat(mono[:, None], 2, axis=1)

    wall = clock.time_best(run, check=out)

    prog = tape.build_tape_program(adev, params, frames, device=dev)
    kernel_s = clock.time_device(lambda: tape.tape_table_render(
        prog, device_out=True, stereo=True)[0])
    extras["rtf_tape_compute"] = round((frames / sr) / kernel_s, 2)

    t_build = clock.best_s(lambda: tape.build_tape_program_cached(
        adev, params, frames, device=dev))
    kern_mono_s = clock.time_device(lambda: tape.tape_table_render(
        prog, out_i16=True, device_out=True)[0])
    ydev = tape.tape_table_render(prog, out_i16=True, device_out=True)[0]
    clock.sync()
    t_pull = clock.best_s(lambda: ydev.cpu())
    mono_h = ydev.cpu().numpy()
    t_dup = clock.best_s(lambda: np.repeat(mono_h[:, None], 2, axis=1))
    _decomp(extras, "tape", wall, kern_mono_s,
            {"build": t_build, "pull": t_pull, "host_post": t_dup})

    # every call changes a section speed: a fresh program and tables
    tweak = {"i": 0}

    def run_tweak():
        tweak["i"] += 1
        pp = dataclasses.replace(
            params, section_speeds=list(params.section_speeds),
            section_reverse=list(params.section_reverse))
        pp.section_speeds[tweak["i"] % len(pp.section_speeds)] *= \
            (1.0 + 0.001 * (tweak["i"] % 7))
        fr = tape.section_render_length(pp, n)
        prog2 = tape.build_tape_program(adev, pp, fr, device=dev)
        tape.tape_table_render(prog2, device_out=True, stereo=True)
        return fr / sr

    run_tweak()
    clock.sync()
    K = 3
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K):
            asec = run_tweak()
        clock.sync()
        best = min(best, time.perf_counter() - t0)
    extras["rtf_tape_param_tweak"] = round(asec / max(1e-9, best / K), 2)
    return (frames / sr) / wall


def bench_scrub(clock: Clock, extras: dict, smoke: bool) -> float:
    """Config 2 (bench.py:268): a 10 s tape scrubbed for 30 s by three
    heads along a scripted trace (three drags, a jump); stereo as the mono
    render duplicated on the host."""
    from .models import scrub

    dev = clock.device
    sr = 48000
    audio = _test_audio(sr, 2.0 if smoke else 10.0)
    seconds = 2.0 if smoke else 30.0
    blocks = int(seconds * sr / scrub.BLOCK_SIZE)
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=3)
    trace = scrub.scripted_gesture_trace(
        blocks, sr, drag_events=[(2.0, 8.0, 3.0), (10.0, -14.0, 4.0),
                                 (20.0, 4.0, 5.0)],
        base_speed=0.5, jumps=[(15.0, 1000.0)])
    out = {}
    audio_sec = blocks * scrub.BLOCK_SIZE / sr

    def run():
        mono = scrub.render_scrub(audio, cfg, trace, pcm16=True, device=dev)
        out["y"] = np.repeat(mono[:, None], 2, axis=1)

    wall = clock.time_best(run, check=out)

    # compute: a fresh program's arrays on the device, one layout
    prog = scrub.build_scrub_program(audio, cfg, trace, 0.0)
    dp = scrub.device_program(prog, dev)
    kargs = (dp["audio"], dp["base_inc_q"], dp["js_q"], prog["seed"],
             prog["mod_consts"], dp["jump_flags"], dp["seg_bases_whole"],
             dp["seg_bases_frac"], dp["env_blocks"], prog["head_off_whole"],
             prog["head_off_frac"], prog["head_gain"])
    extras["rtf_scrub_compute"] = round(audio_sec / clock.time_device(
        lambda: scrub.scrub_render_kernel(
            *kargs, block_size=prog["block_size"],
            span_blocks=scrub.program_span(prog), stereo=True,
            device=dev)), 2)

    t_build = clock.best_s(lambda: scrub.build_scrub_program_cached(
        audio, cfg, trace, 0.0))
    kern_mono_s = clock.time_device(lambda: scrub.render_scrub(
        audio, cfg, trace, pcm16=True, device_out=True, device=dev))
    ydev = scrub.render_scrub(audio, cfg, trace, pcm16=True,
                              device_out=True, device=dev)
    clock.sync()
    t_pull = clock.best_s(lambda: ydev.cpu())
    mono_h = ydev.cpu().numpy()
    t_dup = clock.best_s(lambda: np.repeat(mono_h[:, None], 2, axis=1))
    _decomp(extras, "scrub", wall, kern_mono_s,
            {"build": t_build, "pull": t_pull, "host_post": t_dup})
    return audio_sec / wall


def _microsound_device_call(ms, p, ir, dev):
    """bench.py's fused call: the program built, its events in one chunk
    of E (at most 2**26 samples of grains) and the space kernels on the
    device; returns a function that renders them."""
    prog = ms.build_program(p, ir_audio=ir)
    ec = max(1, min(prog["E"], (1 << 26) // max(1, prog["L"])))
    chunks = [ms.program_to_device(c, dev) for c in ms._chunk_events(prog,
                                                                    ec)]
    cfg = ms.chain_cfg(p, prog)
    er_k, ir_k, ir_on = ms._space_kernels(p, ir, dev)
    fx = ms.fx_cfg(p, prog["out_n"], ir_on, False)
    kern = ms.program_to_device({"er": er_k, "ir": ir_k}, dev)
    return lambda: ms.render_device(cfg, fx, chunks, kern["er"],
                                    kern["ir"])[0]


def bench_microsound(clock: Clock, extras: dict, smoke: bool) -> float:
    """Config 3 (bench.py:338): a 192 kHz band-limited transient field,
    x100 time unfold, x4 spectral stretch, ER and IR convolution."""
    from .models import microsound as ms

    dev = clock.device
    sr = 48000 if smoke else 192000
    seconds = 0.5 if smoke else 4.0
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192) * np.exp(-np.arange(8192) / 800.0)) \
        .astype(np.float32)
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=sr, out_dur_s=seconds, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
        max_grains=24 if smoke else 400, partial_stretch=4.0,
        bandlimit_on=True, bandlimit_out_hz=18000.0,
        bandlimit_roll_hz=2500.0, er_cloud_on=True, space_ir_on=True,
        stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
        bp_stretch="", seed=5))
    out = {}

    def run():
        y, _ = ms.render(p, ir_audio=ir, pcm16=True, device=dev)
        out["y"] = y.cpu().numpy()

    wall = clock.time_best(run, repeats=2, check=out)

    kernel_s = clock.time_device(_microsound_device_call(ms, p, ir, dev))
    extras["rtf_microsound_compute"] = round(seconds / kernel_s, 2)
    extras["microsound_oa"] = ("overlap_add.cu" if clock.cuda
                               else "plain")

    t_build = clock.best_s(lambda: ms.build_program(p, ir_audio=ir))
    ydev, _ = ms.render(p, ir_audio=ir, pcm16=True, device=dev)
    clock.sync()
    t_pull = clock.best_s(lambda: ydev.cpu())
    _decomp(extras, "microsound", wall, kernel_s,
            {"build": t_build, "pull": t_pull})

    # the same pipeline at 48 kHz output (a 4.8 MHz design rate)
    p48 = ms.MicrosoundParams.from_dict({**p.to_dict(), "base_sr": 48000})
    extras["rtf_microsound_48k_compute"] = round(seconds / clock.time_device(
        _microsound_device_call(ms, p48, ir, dev)), 2)
    return seconds / wall


def bench_patternlab(clock: Clock, extras: dict, smoke: bool) -> float:
    """Config 4 (bench.py:430): the four builtin generators' patterns
    through the FM + PSG voice bank, 44.1 kHz."""
    from .models import patternlab as pl

    dev = clock.device
    cfg = pl.RenderConfig(sample_rate=44100, seconds=2.0 if smoke else 8.0,
                          bpm=128, seed=9)
    events = [e for g in pl.list_generators() if g != "Python Script"
              for e in pl.generate(g, cfg)]
    out = {}

    def run():
        out["y"], _ = pl.render(events, cfg, pcm16=True, device=dev)

    wall = clock.time_best(run, repeats=2, check=out)

    ev = pl.apply_time_ops(events, cfg)
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed,
                                      device=dev)
    t0 = time.perf_counter()
    prep = synth.prepare(ev, cfg.seconds)
    clock.sync()
    extras["patternlab_prepare_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 2)
    kernel_s = clock.time_device(
        lambda: synth.render_prepared(prep, master_gain=cfg.master_gain,
                                      device_out=True))
    extras["rtf_patternlab_compute"] = round(cfg.seconds / kernel_s, 2)

    # render() memoizes the prepare; its hit pays one cfg JSON dump
    t_build = clock.best_s(lambda: json.dumps(
        dataclasses.asdict(cfg), sort_keys=True, default=str))
    kern16_s = clock.time_device(
        lambda: synth.render_prepared(prep, master_gain=cfg.master_gain,
                                      device_out=True, pcm16=True))
    ydev = synth.render_prepared(prep, master_gain=cfg.master_gain,
                                 device_out=True, pcm16=True)
    clock.sync()
    t_pull = clock.best_s(lambda: ydev.cpu())
    _decomp(extras, "patternlab", wall, kern16_s,
            {"build": t_build, "pull": t_pull})
    return cfg.seconds / wall


def bench_grid_forestfire(clock: Clock, extras: dict, smoke: bool) -> float:
    """Config 5 (bench.py:488): a four-track grid of ``examples/cells/``
    mixed down through ``render_mixdown``, then the Forest Fire CA for
    the same span at its 30 Hz tick with one rule on its stats.  The RTF
    counts the mixdown's audio."""
    from .events import rules as R
    from .models import forestfire as ff
    from .models import grid

    dev = clock.device
    sr = 48000
    seconds = 4.0 if smoke else 16.0
    cells_dir = os.path.join(REPO, "examples", "cells")
    cell_files = ["slow_pulse_pad.py", "euclid_clicks.py",
                  "shard_scatter.py", "poly_impulses.py"]
    tracks = []
    for ti in range(4):
        t = grid.Track(name=f"t{ti}", mode="duration",
                       duration_seconds=2.0 + ti, uniform_n=8,
                       loop_to_master=True, gain_db=-3.0 * ti,
                       sync_points_text="4.0, 9.5" if ti else "")
        if ti >= 1:
            t.mod_source_index = ti - 1
            t.mod_amount = 0.6
        t.ensure_cells(t.uniform_n)
        for ci in range(t.uniform_n):
            t.cells[ci] = grid.CellSource(
                kind="py", path=os.path.join(cells_dir, cell_files[ti]))
        tracks.append(t)
    project = grid.GridProject(
        tracks=tracks, master=grid.MasterClock("fixed_seconds", seconds),
        sample_rate=sr)

    model = ff.ForestFireModel(ff.ModelParams(), seed=2, device=dev)
    model.ignite_at(110, 80, radius=4)
    eng = R.WatchEngine(now_fn=lambda: 0.0)
    eng.set_rules([R.ThresholdRule(metric_key="burning", op=">",
                                   threshold=50, edge="rising",
                                   cooldown_s=0.0)])
    rec = R.OSCRecorder()
    n_ca_steps = int(seconds * 30)   # the reference's tick over the span
    out = {}

    def run_ca():
        stats = model.simulate(n_ca_steps)
        eng.run_stream(ff.stats_rows_to_dicts(stats), rec.send)

    def run():
        out["mix"] = grid.render_mixdown(project, pcm16=True, device=dev)
        run_ca()

    wall = clock.time_best(run, repeats=2, check=out)

    n_total, rows = grid._build_mix_program(project, dev)
    prep = grid.prepare_device_mix(n_total, rows, device=dev)
    extras["rtf_grid_compute"] = round(seconds / clock.time_device(
        lambda: grid._device_mixdown(n_total, rows, device_out=True,
                                     prepared=prep)), 2)

    t_build = clock.best_s(lambda: grid.build_mix_program_cached(project,
                                                                 dev))
    prep16 = grid.prepare_device_mix(n_total, rows, pcm16=True, device=dev)
    kern16_s = clock.time_device(
        lambda: grid._device_mixdown(n_total, rows, device_out=True,
                                     prepared=prep16))
    ydev = grid._device_mixdown(n_total, rows, device_out=True,
                                prepared=prep16)
    clock.sync()
    t_pull = clock.best_s(lambda: ydev.cpu())
    t_ca = clock.best_s(run_ca)
    _decomp(extras, "grid", wall, kern16_s,
            {"build": t_build, "pull": t_pull, "ca": t_ca})
    return seconds / wall


BENCHES = {"tape": bench_tape, "scrub": bench_scrub,
           "microsound": bench_microsound, "patternlab": bench_patternlab,
           "grid_forestfire": bench_grid_forestfire}


def _link_stats(clock: Clock, extras: dict):
    """The null loop and the device-to-host rate of an 8 MB int16 pull."""
    extras["null_loop_latency_ms"] = round(clock.null_loop_s() * 1e3, 4)
    buf = torch.zeros(4 << 20, dtype=torch.int16, device=clock.device) + 1
    clock.sync()
    t0 = time.perf_counter()
    buf.cpu()
    dt = time.perf_counter() - t0
    extras["d2h_MBps"] = round(8.0 / max(1e-9, dt), 1)


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(idx)], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(idx)}, power limit not read"


def run_all(device="cuda", smoke: bool = False) -> dict:
    """Every configuration on ``device``; returns the JSON line's dict.
    A configuration that raises goes into "failures" and the rest run."""
    clock = Clock(device)
    results, failures, extras = {}, {}, {}
    _link_stats(clock, extras)
    for name in CONFIGS:
        try:
            results[name] = BENCHES[name](clock, extras, smoke)
        except Exception as e:  # a boundary: report the config, run on
            failures[name] = f"{type(e).__name__}: {e}"
            print(f"[bench] {name} FAILED: {failures[name]}",
                  file=sys.stderr)
    geomean = (float(np.exp(np.mean([np.log(max(1e-9, v))
                                     for v in results.values()])))
               if results else 0.0)
    line = {"metric": "rtf_geomean", "value": round(geomean, 2),
            "unit": "audio_sec/sec/chip",
            "vs_baseline": round(geomean / BASELINE_RTF, 4)}
    for k, v in results.items():
        line[f"rtf_{k}"] = round(v, 2)
    line.update(extras)
    line["device"] = device_name(clock.device)
    if failures:
        line["failures"] = failures
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="audio_suite_torch.bench",
        description="bench.py's five configurations on the port")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; needs a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's BENCH_SMOKE=1 sizes (seconds of CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"audio_suite_torch.bench: --device {args.device}, "
                         f"but no CUDA device is available; pass --device "
                         f"cpu to run on the CPU")
    line = run_all(device, smoke=args.smoke)
    print(json.dumps(line))
    return 1 if "failures" in line else 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

The loop is closed with one client: request k + 1 is made once request
k's PCM is on the host, as a user presses Render again once the audio is
back.  Set-up warms the cell's own shapes with requests of another stream
than the window's, so no memo of the program serves a window request
that it would not serve a user.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import guard, spec, tracing
from .generator import Reservoir, Traffic

SLICE_RENDERS = 12     # renders in the profiled slice (after two settling)


@dataclass
class Window:
    latencies: list = field(default_factory=list)   # s, every render
    audio_s: list = field(default_factory=list)     # s of audio, completed
    wall_s: float = 0.0                             # first issue -> last PCM
    attempted: int = 0
    failed: int = 0


@dataclass
class RunData:
    """What a metric's ``read(run)`` reads."""
    device_name: str
    setup_s: float
    window: Window
    spans: tracing.Spans | None = None    # the traced window's host spans
    slice: tracing.Slice | None = None    # the profiled slice


def _sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _window(engine, state, traffic, seconds, spans, sample, torch, device):
    w = Window()
    t_open = time.perf_counter()
    t_last = t_open
    k = 0
    while time.perf_counter() - t_open < seconds:
        req = engine.request(state, traffic.request(k))
        t0 = time.perf_counter()
        try:
            pcm = (engine.render_traced(state, req, spans) if spans
                   else engine.render(state, req))
        except Exception:       # a failed render counts, the loop goes on
            traceback.print_exc(file=sys.stderr)
            pcm = None
        t_last = time.perf_counter()
        w.attempted += 1
        w.latencies.append(t_last - t0)
        if pcm is None:
            w.failed += 1
        else:
            w.audio_s.append(engine.audio_seconds(state, req))
            sample.offer((k, req, pcm))
        k += 1
    _sync(torch, device)
    w.wall_s = t_last - t_open
    return w


def _profiled_slice(engine, state, traffic, metrics):
    """Two settling renders, then SLICE_RENDERS renders under
    ``torch.profiler``, each in a ``bench.render`` range, with the metrics'
    recorders on around the slice's renders only."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = tracing.Spans()
    recs = {}
    for _, mod in metrics:
        rec = getattr(mod, "RECORD", None)
        if rec and ".".join(rec[:2]) not in recs:
            recs[".".join(rec[:2])] = tracing.Recorder(*rec)
    req = lambda k: engine.request(state, traffic.request(k, "slice"))
    engine.render_traced(state, req(0), spans)
    for r in recs.values():
        r.install()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.render_traced(state, req(1), spans)
            spans.annotate = True
            for r in recs.values():
                r.on = True
            for k in range(SLICE_RENDERS):
                with record_function(tracing.PREFIX + "render"):
                    engine.render_traced(state, req(2 + k), spans)
            for r in recs.values():
                r.on = False
            torch.cuda.synchronize()
    finally:
        for r in recs.values():
            r.remove()
    return tracing.reduce_events(tracing.kineto_events(prof),
                                 {k: r.calls for k, r in recs.items()})


def _card():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def max_lsb(got, want) -> int:
    """The widest gap between two int16 PCM arrays, in steps; a shape
    that differs reads 65536."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return 65536
    if got.size == 0:
        return 0
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             config: dict | None = None, mix: dict | None = None):
    """Run the cell; returns (result dict, check lines).  ``t_start`` is
    the process start on the ``time.perf_counter`` clock.  ``config`` and
    ``mix`` replace the cell's files (the tests' small sizes)."""
    import torch
    config = config or spec.load_json("configs", cell["config"])
    mix = mix or spec.load_json("traffic", cell["traffic"])
    engine = spec.load_module("engines", config["engine"])
    metrics = [(m, spec.load_module("metrics", m["name"]))
               for m in spec.metrics_for(bench, cell["name"], trace)]
    cuda = device.startswith("cuda")
    traffic = Traffic(mix, seed)

    state = engine.setup(config, seed, device)
    for k in range(traffic.warmup):
        req = engine.request(state, traffic.request(k, "warmup"))
        if trace:
            engine.render_traced(state, req, tracing.Spans())
        else:
            engine.render(state, req)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start

    spans = tracing.Spans() if trace else None
    sample = Reservoir(traffic.checked, traffic.rng("sample"))
    window = _window(engine, state, traffic, seconds, spans, sample, torch,
                     device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = RunData(device_name=torch.cuda.get_device_name(0) if cuda
                  else "cpu", setup_s=setup_s, window=window, spans=spans)
    if trace and cuda:
        run.slice = _profiled_slice(engine, state, traffic, metrics)

    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    engine.release(state)
    if cuda:
        torch.cuda.empty_cache()

    # the check: each sampled render against the plain reference
    limit = config["check"]["pcm_max_lsb"]
    worst = 0
    for k, req, pcm in sample.items:
        worst = max(worst, max_lsb(pcm, engine.reference(state, req)))
    checked = len(sample.items)
    correct = window.failed == 0 and checked > 0 and worst <= limit

    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": values, "device": dev}
    if run.slice is not None:
        dev["busy_s"] = run.slice.busy_s()
        dev["window_s"] = run.slice.window_s
        result["breakdown"] = tracing.breakdown(run.slice)
    result["card"] = _card() if cuda else "cpu"
    result["checks"] = {
        "pcm_max_lsb": {"value": worst, "limit": limit},
        "renders_checked": {"value": checked, "limit": 1},
        "renders_failed": {"value": window.failed, "limit": 0}}
    lat = sorted(window.latencies) or [0.0]
    pick = lambda f: 1e3 * lat[min(len(lat) - 1, int(f * len(lat)))]
    lines = [f"renders {window.attempted}, latency ms p50 {pick(0.5):.3f} "
             f"p90 {pick(0.9):.3f} p99 {pick(0.99):.3f} max "
             f"{1e3 * lat[-1]:.3f}"]
    lines += [f"check {k}: {v['value']} (limit {v['limit']})"
              for k, v in result["checks"].items()]
    return result, lines


def emit(result: dict, lines: list) -> int:
    """Print the check lines last on stderr and the result last on stdout,
    unless the process loaded JAX or the JAX package; then exit 3."""
    found = guard.forbidden_loaded()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for ln in lines:                  # the check lines come last
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

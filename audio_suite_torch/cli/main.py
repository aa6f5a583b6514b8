"""CLI entry points of the port — audio_suite_tpu/cli/main.py's seven
subcommands, with the same flags and defaults, rendering on a CUDA card
(or, with ``--device cpu``, on the CPU):

    python -m audio_suite_torch.cli microsound preset.json -o out.wav
    python -m audio_suite_torch.cli tape in.wav -o out.wav --markers 1.0,2.5 \
        --speeds 1.0,2.0,0.5 --reverse 0,1,0 --target-time 8
    python -m audio_suite_torch.cli scrub in.wav -o out.wav --seconds 20 \
        --drag 2.0:8.0:3.0 --base-speed 0.5
    python -m audio_suite_torch.cli patternlab -o out.wav --generator \
        "Glass Cells" --seconds 8
    python -m audio_suite_torch.cli grid project.json -o out.wav
    python -m audio_suite_torch.cli forestfire --steps 900 --osc 127.0.0.1:9000
    python -m audio_suite_torch.cli bench
    python -m audio_suite_torch.cli --device cpu microsound -o out.wav

``--device`` (default ``cuda``) is every engine's ``device``: without a
card, ``cuda`` exits with an error and nothing renders on the CPU unless
asked.  ``--trace DIR`` writes a ``torch.profiler`` trace of the run
(``utils/profiling.device_trace``), each render inside a
``<subcommand>.render`` range.  Each render is pulled to the host once and
written as a float WAV, the tape's as PCM16, as the JAX CLI writes them.
``bench`` runs the port's harness (``audio_suite_torch/bench.py``) on
``--device``; ``bench --smoke`` at its CPU-test sizes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _floats(s):
    return [float(x) for x in s.split(",") if x.strip()]


def cmd_microsound(args):
    from ..models import microsound as ms
    from ..utils import io as audio_io
    from ..utils.profiling import annotate

    p = ms.load_preset(args.preset) if args.preset else ms.MicrosoundParams()
    if args.dur is not None:
        p.out_dur_s = args.dur
    if args.seed is not None:
        p.seed = args.seed
    ir = None
    if args.ir:
        ir, _ = audio_io.load_wav_mono(args.ir)
    img = None
    if args.image:
        img = ms.load_image_gray(args.image)

    def progress(pct, msg):
        print(f"\r[{pct:3d}%] {msg:<60}", end="", file=sys.stderr)

    if args.batch_seeds or args.batch_unfolds or args.batch_stretches:
        with annotate("microsound.render"):
            paths = ms.batch_render(
                p, args.out or "renders",
                seeds=[int(x) for x in _floats(args.batch_seeds or "")]
                or None,
                unfolds=_floats(args.batch_unfolds or "") or None,
                stretches=_floats(args.batch_stretches or "") or None,
                ir_audio=ir, img_gray=img, manifest_path=args.manifest,
                progress=progress, device=args.device)
        print(f"\nwrote {len(paths)} files under {args.out or 'renders'}")
        return
    with annotate("microsound.render"):
        stereo, meta = ms.render(p, ir_audio=ir, img_gray=img,
                                 progress=progress, device=args.device)
        stereo = stereo.cpu().numpy()
    out = args.out or "microsound.wav"
    audio_io.write_wav(out, stereo, p.base_sr)
    print(f"\n{out}: {stereo.shape[0] / p.base_sr:.2f}s @ {p.base_sr} Hz, "
          f"{meta['events']} events, design SR {meta['design_sr_base']} Hz")


def cmd_tape(args):
    from ..models import tape
    from ..utils import io as audio_io
    from ..utils.profiling import annotate, render_meta

    audio, sr = audio_io.load_wav_mono(args.input)
    params = tape.TapeParams(sample_rate=sr)
    if args.detect_beats:
        params.markers = tape.detect_beats(audio, sr, args.beat_sensitivity)
        print(f"detected {len(params.markers)} beats", file=sys.stderr)
    if args.markers:
        params.markers = sorted(int(t * sr) for t in _floats(args.markers))
    n_sec = len(params.markers) + 1
    params.section_speeds = (_floats(args.speeds) if args.speeds
                             else [1.0] * n_sec)
    params.section_reverse = ([bool(int(x)) for x in args.reverse.split(",")]
                              if args.reverse else [False] * n_sec)
    params.tape_age = args.tape_age
    if args.target_time:
        params.section_speeds = tape.fit_to_target_time(
            params, len(audio), args.target_time)
    t0 = time.perf_counter()
    with annotate("tape.render"):
        if args.automation:
            trace = tape.TapeTrace.load(args.automation)
            nf = (int(args.duration * sr) if args.duration
                  else tape.section_render_length(params, len(audio)))
            out = tape.render_tape_trace(audio, params, trace, num_frames=nf,
                                         interp=args.interp,
                                         device=args.device)
        else:
            out = tape.render_tape(audio, params, interp=args.interp,
                                   device=args.device)
    meta = render_meta(out, sr, time.perf_counter() - t0)
    audio_io.write_wav(args.out, out, sr, subtype="PCM_16")
    print(f"{args.out}: {meta['seconds']:.2f}s @ {sr} Hz, "
          f"peak {meta['peak_dbfs']} dBFS, RTF {meta['rtf']}x")


def cmd_scrub(args):
    from ..models import scrub
    from ..utils import io as audio_io
    from ..utils.profiling import annotate, render_meta

    audio, sr = audio_io.load_wav_mono(args.input)
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=args.heads)
    blocks = int(args.seconds * sr / cfg.block_size)
    drags = []
    for spec in args.drag or []:
        t0, dx, dur = (float(x) for x in spec.split(":"))
        drags.append((t0, dx, dur))
    keys = []
    for spec in args.key or []:
        t, k = spec.split(":")
        keys.append((float(t), k))
    trace = scrub.scripted_gesture_trace(blocks, sr, drag_events=drags,
                                         base_speed=args.base_speed,
                                         key_events=keys,
                                         head_count=args.heads)
    t0 = time.perf_counter()
    with annotate("scrub.render"):
        out = scrub.render_scrub(audio, cfg, trace, interp=args.interp,
                                 device=args.device)
    meta = render_meta(out, sr, time.perf_counter() - t0)
    audio_io.write_wav(args.out, out, sr)
    print(f"{args.out}: {meta['seconds']:.2f}s scrub @ {sr} Hz, "
          f"{args.heads} heads, peak {meta['peak_dbfs']} dBFS, "
          f"RTF {meta['rtf']}x")


def cmd_patternlab(args):
    from ..models import patternlab as pl
    from ..utils import io as audio_io
    from ..utils.profiling import annotate

    if args.preset:
        preset = pl.load_preset(args.preset)
        with annotate("patternlab.render"):
            y, events = pl.render_preset(preset, device=args.device)
        sr = int(preset.get("cfg", {}).get("sample_rate", 44100))
    else:
        cfg = pl.RenderConfig(seconds=args.seconds, bpm=args.bpm,
                              seed=args.seed or 1)
        gen_kwargs = {}
        for spec in args.gen or []:
            k, v = spec.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            gen_kwargs[k] = v
        if args.script:
            from pathlib import Path

            from ..plugins.host import (ensure_pattern_lab_examples_importable,
                                        load_script_generator)
            ensure_pattern_lab_examples_importable()
            events = load_script_generator(Path(args.script))(cfg,
                                                              **gen_kwargs)
        else:
            events = pl.generate(args.generator, cfg, **gen_kwargs)
        with annotate("patternlab.render"):
            y, events = pl.render(events, cfg, device=args.device)
        sr = cfg.sample_rate
    audio_io.write_wav(args.out, y, sr)
    print(f"{args.out}: {len(y) / sr:.2f}s, {len(events)} notes")


def cmd_grid(args):
    from ..models import grid
    from ..utils import io as audio_io
    from ..utils.profiling import annotate

    project = grid.load_project(args.project)
    with annotate("grid.render"):
        mix = grid.render_mixdown(project, device=args.device)
    audio_io.write_wav(args.out, mix, project.sample_rate)
    print(f"{args.out}: {len(mix) / project.sample_rate:.2f}s, "
          f"{len(project.tracks)} tracks")


def cmd_forestfire(args):
    from ..events import rules as R
    from ..models import forestfire as ff
    from ..utils.profiling import annotate

    params = ff.ModelParams()
    model = ff.ForestFireModel(params, seed=args.seed or 1,
                               device=args.device)
    if args.ignite:
        x, y = (int(v) for v in args.ignite.split(","))
        model.ignite_at(x, y, radius=4)

    eng = R.WatchEngine()
    if args.rules:
        with open(args.rules) as f:
            rules = [R.ThresholdRule(**r) for r in json.load(f)]
    else:
        rules = [
            R.ThresholdRule(metric_key="burning", op=">", threshold=100,
                            edge="rising", osc_address="/fire/burning_hi"),
            R.ThresholdRule(metric_key="ignitions", op=">", threshold=20,
                            edge="rising",
                            osc_address="/fire/ignitions_spike"),
            R.ThresholdRule(metric_key="embers", op=">", threshold=10,
                            edge="rising", osc_address="/fire/embers_spike"),
            R.ThresholdRule(metric_key="rain", op=">", threshold=0.5,
                            edge="rising", osc_address="/fire/rain"),
        ]
    eng.set_rules(rules)

    sender = None
    if args.osc:
        host, port = args.osc.split(":")
        sender = R.OSCSender(R.OSCConfig(host=host, port=int(port)))
        send = sender.send
    else:
        rec = R.OSCRecorder()
        send = rec.send

    chunk = 120
    done = 0
    with annotate("forestfire.render"):
        while done < args.steps:
            n = min(chunk, args.steps - done)
            stats = model.simulate(n)
            eng.run_stream(ff.stats_rows_to_dicts(stats), send)
            done += n
            s = model.get_stats()
            print(f"t={s['t']} trees={s['trees']} burning={s['burning']} "
                  f"ash={s['ash']}", file=sys.stderr)
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump(model.get_stats(), f, indent=2)
    if sender is None:
        print(f"{len(rec.messages)} OSC events (no --osc target; use "
              f"host:port to emit over UDP)")
        for addr, a in rec.messages[:20]:
            print(f"  {addr} {list(a)}")


def cmd_bench(args):
    from .. import bench

    code = bench.main(["--device", args.device]
                      + (["--smoke"] if args.smoke else []))
    if code:
        raise SystemExit(code)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="audio_suite_torch",
        description="CUDA renders of the audio-suite apps (PyTorch port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every render: cuda (default; "
                         "needs a card) or cpu")
    ap.add_argument("--trace", metavar="DIR",
                    help="capture a torch.profiler trace of the run into "
                         "DIR (Chrome / Perfetto trace JSON)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("microsound", help="granular unfold synth render")
    m.add_argument("preset", nargs="?", help="preset JSON (reference-compatible)")
    m.add_argument("-o", "--out")
    m.add_argument("--dur", type=float)
    m.add_argument("--seed", type=int)
    m.add_argument("--ir", help="impulse-response WAV")
    m.add_argument("--image", help="grayscale image for Image scanline mode "
                                   "(needs PIL)")
    m.add_argument("--batch-seeds")
    m.add_argument("--batch-unfolds")
    m.add_argument("--batch-stretches")
    m.add_argument("--manifest", help="resumable batch manifest path")
    m.set_defaults(fn=cmd_microsound)

    t = sub.add_parser("tape", help="varispeed tape render")
    t.add_argument("--interp", choices=("linear", "sinc"), default="linear",
                   help="read interpolation: linear (reference parity, "
                        "default) or windowed sinc (quality mode)")
    t.add_argument("input")
    t.add_argument("-o", "--out", required=True)
    t.add_argument("--markers", help="comma-separated seconds")
    t.add_argument("--speeds", help="per-section speeds 0.25-4")
    t.add_argument("--reverse", help="per-section 0/1 flags")
    t.add_argument("--tape-age", type=int, default=50)
    t.add_argument("--target-time", type=float,
                   help="duration-preserving retime target (s)")
    t.add_argument("--detect-beats", action="store_true")
    t.add_argument("--beat-sensitivity", type=int, default=50)
    t.add_argument("--automation",
                   help="TapeTrace JSON: timed param mutations rendered as "
                        "a reproducible performance (the offline form of "
                        "the reference's live GUI mutations)")
    t.add_argument("--duration", type=float,
                   help="performance length in seconds (with --automation)")
    t.set_defaults(fn=cmd_tape)

    s = sub.add_parser("scrub", help="gestural tape scrub render")
    s.add_argument("--interp", choices=("linear", "sinc"), default="linear",
                   help="read interpolation: linear (reference parity, "
                        "default) or windowed sinc (quality mode)")
    s.add_argument("input")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--seconds", type=float, default=10.0)
    s.add_argument("--heads", type=int, default=3, choices=(1, 2, 3))
    s.add_argument("--base-speed", type=float, default=0.5)
    s.add_argument("--drag", action="append",
                   help="t0:dx:dur gesture (repeatable)")
    s.add_argument("--key", action="append",
                   help="t:KEY live control event (repeatable): 1/2/3 head "
                        "count, Z/X C/V B/N head-offset nudges, R reset, "
                        "Up/Down/0 base speed (scrubber_0.7.py:320-361)")
    s.set_defaults(fn=cmd_scrub)

    pl = sub.add_parser("patternlab", help="FM+PSG pattern render")
    pl.add_argument("-o", "--out", required=True)
    pl.add_argument("--preset", help="{name, generator, cfg, gen} JSON")
    pl.add_argument("--generator", default="Glass Cells")
    pl.add_argument("--script", help="user generator script (.py)")
    pl.add_argument("--gen", action="append",
                    help="generator kwarg key=value (repeatable; value "
                         "parsed as JSON when possible)")
    pl.add_argument("--seconds", type=float, default=8.0)
    pl.add_argument("--bpm", type=float, default=120.0)
    pl.add_argument("--seed", type=int)
    pl.set_defaults(fn=cmd_patternlab)

    g = sub.add_parser("grid", help="grid DAW mixdown")
    g.add_argument("project", help="project JSON")
    g.add_argument("-o", "--out", required=True)
    g.set_defaults(fn=cmd_grid)

    f = sub.add_parser("forestfire", help="forest-fire CA -> OSC events")
    f.add_argument("--steps", type=int, default=900)
    f.add_argument("--seed", type=int)
    f.add_argument("--ignite", help="x,y brush ignition")
    f.add_argument("--osc", help="host:port UDP target")
    f.add_argument("--rules", help="rules JSON (list of ThresholdRule kwargs)")
    f.add_argument("--stats-out")
    f.set_defaults(fn=cmd_forestfire)

    b = sub.add_parser("bench", help="the benchmark harness: bench.py's "
                                     "five configurations, one JSON line")
    b.add_argument("--smoke", action="store_true",
                   help="bench.py's BENCH_SMOKE=1 sizes")
    b.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"audio_suite_torch: --device {args.device}, but "
                         f"no CUDA device is available; pass --device cpu "
                         f"to render on the CPU")
    from ..utils.profiling import device_trace

    with device_trace(args.trace, device):
        args.fn(args)


if __name__ == "__main__":
    main()

"""The port's CLI (``audio_suite_torch/cli/main.py``) held against the JAX
CLI (``audio_suite_tpu/cli/main.py``) on the CPU.

The same argv goes through the JAX CLI's ``main`` in-process (jitted, on
the CPU, as Tier-1 runs it) and through the port's ``main`` with
``--device cpu``, at smoke sizes; the WAVs each writes are read back and
compared:

- ``microsound --dur 0.2``: within -100 dBFS;
- ``tape``, a 1 s input with markers, speeds, reverse flags and a tape
  age: PCM16 both, at most 1 LSB apart (the count of samples that differ
  is printed);
- ``scrub``, 2 s of three heads with two drags: within -120 dBFS;
- ``patternlab`` with ``--generator`` and with ``--script
  examples/patterns/prime_echoes.py --gen root=60``: within -60 dBFS of
  JAX's jitted render, as PERF.md section 2 holds config 4;
- ``grid``, a two-track project of ``examples/cells/`` and a wav cell:
  bit-equal;
- ``forestfire --steps 30 --seed 2`` (ignited, with
  ``examples/demo_rules.json``): the ``--stats-out`` JSON and the printed
  OSC events equal;
- ``bench`` dispatches to ``audio_suite_torch.bench`` with the CLI's
  ``--device`` (its ``main`` stubbed: the smoke harness itself runs in
  ``tests/test_torch_bench_smoke.py``) and exits 0 with ``--smoke``;
- a single ``microsound`` render writes the same progress to stderr as
  the JAX CLI's;
- ``--trace DIR`` writes a trace JSON holding the ``microsound.render``
  range;
- ``python -m audio_suite_torch.cli`` in a subprocess, with ``jax`` and
  the JAX package blocked, writes the same WAV as the port in-process;
- without ``--device cpu`` on a machine with no card, the CLI exits
  non-zero rather than rendering on the CPU.
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_suite_torch.cli import main as tcli
from audio_suite_torch.utils import io as audio_io
from audio_suite_torch.utils.metrics import max_dev_dbfs
from audio_suite_tpu.cli import main as jcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _input_wav(path, sr: int, seconds: float):
    """A seeded test tape: two sines and a little noise."""
    rng = np.random.default_rng(7)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    audio_io.write_wav(str(path), (0.9 * x / np.max(np.abs(x)))
                       .astype(np.float32), sr)
    return str(path)


def _both(tmp_path, argv):
    """Run ``argv`` (with ``{out}`` for the output path) through both CLIs;
    returns (the JAX CLI's WAV, the port's), of one rate and shape."""
    outs = {}
    for tag, main, pre in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.wav")
        main(pre + [a.format(out=out) for a in argv])
        outs[tag] = audio_io.read_wav(out)
    (yj, srj), (yt, srt) = outs["jax"], outs["torch"]
    assert srj == srt
    assert yj.shape == yt.shape and yj.dtype == yt.dtype
    return yj, yt


def test_microsound_matches_jax(tmp_path):
    yj, yt = _both(tmp_path, ["microsound", "-o", "{out}", "--dur", "0.2",
                              "--seed", "3"])
    assert yt.shape == (9600, 2) and float(np.abs(yt).max()) > 1e-3
    assert max_dev_dbfs(yj, yt) <= -100.0


def test_microsound_progress_on_stderr(tmp_path, capsys):
    """A single render reports its progress on stderr, as the JAX CLI's
    does, and starts its summary on a new line."""
    got = {}
    for tag, main, pre in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.wav")
        capsys.readouterr()
        main(pre + ["microsound", "-o", out, "--dur", "0.2", "--seed", "3"])
        got[tag] = capsys.readouterr()
    err = got["torch"].err
    assert err == got["jax"].err
    assert "[100%] Done." in err and err.startswith("\r")
    assert got["torch"].out.startswith("\n")
    assert got["torch"].out.replace("torch.wav", "") == \
        got["jax"].out.replace("jax.wav", "")


def test_tape_matches_jax(tmp_path):
    wav = _input_wav(tmp_path / "in.wav", 8000, 1.0)
    yj, yt = _both(tmp_path, ["tape", wav, "-o", "{out}", "--markers",
                              "0.3,0.55", "--speeds", "1.0,2.0,0.5",
                              "--reverse", "0,1,0", "--tape-age", "60"])
    qj = np.rint(yj.astype(np.float64) * 32768.0)
    qt = np.rint(yt.astype(np.float64) * 32768.0)
    assert np.array_equal(qj / 32768.0, yj)      # both written as PCM16
    d = np.abs(qj - qt)
    print(f"tape: {int((d > 0).sum())} of {d.size} PCM16 samples differ, "
          f"max {int(d.max())} LSB")
    assert d.max() <= 1
    assert float(np.abs(yt).max()) > 0.1


def test_scrub_matches_jax(tmp_path):
    wav = _input_wav(tmp_path / "in.wav", 8000, 2.0)
    yj, yt = _both(tmp_path, ["scrub", wav, "-o", "{out}", "--seconds", "2",
                              "--heads", "3", "--drag", "0.2:6.0:0.5",
                              "--drag", "1.0:-4.0:0.4"])
    assert float(np.abs(yt).max()) > 0.1
    assert max_dev_dbfs(yj, yt) <= -120.0


@pytest.mark.parametrize("gen", [
    ["--generator", "Glass Cells"],
    ["--script", os.path.join(REPO, "examples", "patterns",
                              "prime_echoes.py"), "--gen", "root=60"]],
    ids=["generator", "script"])
def test_patternlab_matches_jax(tmp_path, gen):
    yj, yt = _both(tmp_path, ["patternlab", "-o", "{out}", "--seconds", "1",
                              "--bpm", "128", "--seed", "9", *gen])
    assert yt.shape == (44100,) and float(np.abs(yt).max()) > 0.05
    assert max_dev_dbfs(yj, yt) <= -60.0


def test_grid_bit_equal_to_jax(tmp_path):
    sr = 8000
    wav = _input_wav(tmp_path / "cell.wav", sr, 0.5)
    cells = os.path.join(REPO, "examples", "cells")
    project = {
        "sample_rate": sr, "normalize": False,
        "master": {"mode": "fixed_seconds", "fixed_seconds": 2.0},
        "tracks": [
            {"name": "a", "mode": "duration", "duration_seconds": 1.0,
             "uniform_n": 4, "loop_to_master": True,
             "cells": [{"kind": "wav", "path": wav},
                       {"kind": "py",
                        "path": os.path.join(cells, "euclid_clicks.py")},
                       {"kind": "empty", "path": ""},
                       {"kind": "py",
                        "path": os.path.join(cells, "slow_pulse_pad.py")}]},
            {"name": "b", "mode": "duration", "duration_seconds": 0.75,
             "uniform_n": 2, "loop_to_master": True, "gain_db": -6.0,
             "mod_source_index": 0, "mod_amount": 0.5,
             "sync_points_text": "0.9",
             "cells": [{"kind": "py",
                        "path": os.path.join(cells, "shard_scatter.py")},
                       {"kind": "empty", "path": ""}]},
        ],
    }
    path = tmp_path / "proj.json"
    path.write_text(json.dumps(project))
    yj, yt = _both(tmp_path, ["grid", str(path), "-o", "{out}"])
    assert yt.shape == (2 * sr,) and float(np.abs(yt).max()) > 1e-3
    assert np.array_equal(yj, yt)


def test_forestfire_matches_jax(tmp_path, capsys):
    rules = os.path.join(REPO, "examples", "demo_rules.json")
    got = {}
    for tag, main, pre in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        stats = tmp_path / f"{tag}.json"
        capsys.readouterr()
        main(pre + ["forestfire", "--steps", "30", "--seed", "2",
                    "--ignite", "110,80", "--rules", rules,
                    "--stats-out", str(stats)])
        got[tag] = (json.loads(stats.read_text()), capsys.readouterr().out)
    (sj, oj), (st, ot) = got["jax"], got["torch"]
    assert st == sj and st["t"] == 30 and st["burning"] > 0
    assert ot == oj and "OSC events" in ot
    print(ot)


def test_bench_runs_the_port_harness(monkeypatch):
    from audio_suite_torch import bench
    calls = []

    def harness(argv):
        calls.append(argv)
        return 0 if "--smoke" in argv else 1

    monkeypatch.setattr(bench, "main", harness)
    tcli.main(["--device", "cpu", "bench", "--smoke"])
    assert calls == [["--device", "cpu", "--smoke"]]
    # a harness that reports failures makes the CLI exit non-zero
    with pytest.raises(SystemExit) as e:
        tcli.main(["--device", "cpu", "bench"])
    assert e.value.code == 1 and calls[-1] == ["--device", "cpu"]


def test_trace_holds_the_render_range(tmp_path):
    trace_dir = tmp_path / "trace"
    tcli.main(["--device", "cpu", "--trace", str(trace_dir), "microsound",
               "-o", str(tmp_path / "m.wav"), "--dur", "0.1", "--seed", "3"])
    (path,) = glob.glob(str(trace_dir / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "microsound.render" in names


def test_cuda_default_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    out = tmp_path / "m.wav"
    with pytest.raises(SystemExit) as e:
        tcli.main(["microsound", "-o", str(out), "--dur", "0.1"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)
    assert not out.exists()


_MODULE_RUN = """
import runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads({threads})     # the parent's: CPU sums split by it
sys.argv = ["audio_suite_torch.cli"] + {argv!r}
try:
    runpy.run_module("audio_suite_torch.cli", run_name="__main__")
finally:
    assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
                   for m in sys.modules if sys.modules[m] is not None)
"""


def test_module_entry_runs_with_jax_blocked(tmp_path):
    argv = ["--device", "cpu", "microsound", "-o", str(tmp_path / "sub.wav"),
            "--dur", "0.1", "--seed", "4"]
    r = subprocess.run([sys.executable, "-c",
                        _MODULE_RUN.format(repo=REPO, argv=argv,
                                           threads=torch.get_num_threads())],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "sub.wav" in r.stdout
    tcli.main(argv[:4] + [str(tmp_path / "inproc.wav")] + argv[5:])
    with open(tmp_path / "sub.wav", "rb") as a, \
            open(tmp_path / "inproc.wav", "rb") as b:
        assert a.read() == b.read()

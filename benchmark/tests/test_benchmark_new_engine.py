"""A cell of a new engine goes in with new files and entries only: a
made-up engine with no overlap-add (``toy``: a bank of sine voices mixed
to PCM16) is dropped into a copy of this folder beside the engines that
exist, with its configuration, mix, twins of two per-layer metrics and
its program (a module of its own), and nothing is edited.  Its run is
correct, each fault it names fails the run, and the program-span reader
takes its wiring from its file: its renders grouped, its syncs counted,
its idle gaps labelled and read, its upload timed."""
import json
import shutil
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness, spec, tracing  # noqa: E402
from audio_suite_torch.utils import profiling as prof  # noqa: E402

SEED = 2 ** 31 + 2121
CELL = "toy-1.seeds"

PROGRAM = '''
"""A made-up program: a bank of sine voices mixed to PCM16."""
import math

import numpy as np
import torch

from audio_suite_torch.utils import profiling


def build(seed, voices, length):
    with profiling.span("toy.build"):
        rng = np.random.default_rng(seed)
        return {"inc": rng.uniform(1e-3, 2e-2, voices),
                "gain": rng.uniform(0.02, 0.1, voices), "length": length}


def integrate(inc):
    """Each voice's phase: the running sum of its increments."""
    return torch.cumsum(inc, dim=1)


def mix(voices):
    return voices.sum(dim=0)


def to_pcm16(y):
    return torch.round(y * 32767).clamp(-32768, 32767).to(torch.int16)


def render_program(prog, device):
    with profiling.span("toy.upload"):
        inc = torch.tensor(prog["inc"], device=device)
        gain = torch.tensor(prog["gain"], device=device)
    with profiling.span("toy.voices", device):
        ph = integrate(inc[:, None].repeat(1, prog["length"]))
        v = torch.sin(2 * math.pi * ph) * gain[:, None]
    with profiling.span("toy.mix", device):
        return to_pcm16(mix(v))


def render(seed, voices, length, device="cpu"):
    with profiling.span("toy.render"):
        return render_program(build(seed, voices, length), device)
'''

ENGINE = '''
"""The made-up engine through ``toy_program``'s entry."""
from types import SimpleNamespace

import numpy as np
import toy_program

from benchmark import faults


def _unchanged(monkeypatch):
    monkeypatch.setattr(toy_program, "integrate", lambda inc: inc)


def _half(monkeypatch):
    orig = toy_program.mix
    monkeypatch.setattr(toy_program, "mix",
                        lambda v: orig(v[: v.shape[0] // 2]))


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half,
          "answer_altered": faults.sample_altered("toy_program",
                                                  "to_pcm16")}
PROGRAM_SPANS = {
    "root": "toy.render",
    "last": "toy.mix",
    "wraps": {"host_build": ["toy.build"],
              "dispatch": ["toy.upload", "toy.voices", "toy.mix"]},
    "upload": "toy.upload",
}


def setup(config, seed, device):
    return SimpleNamespace(device=device, **config["params"])


def request(state, fields):
    return dict(fields)


def render(state, req):
    return toy_program.render(req["seed"], state.voices, state.length,
                              state.device).cpu().numpy()


def render_traced(state, req, span):
    with span("host_build"):
        prog = toy_program.build(req["seed"], state.voices, state.length)
    with span("dispatch"):
        y = toy_program.render_program(prog, state.device)
    with span("pull"):
        return y.cpu().numpy()


def audio_seconds(state, req):
    return state.length / state.sample_rate


def release(state):
    pass


def reference(state, req, q=None):
    rng = np.random.default_rng(req["seed"])
    inc = rng.uniform(1e-3, 2e-2, state.voices)
    gain = rng.uniform(0.02, 0.1, state.voices)
    ph = np.cumsum(np.repeat(inc[:, None], state.length, axis=1), axis=1)
    y = (np.sin(2 * np.pi * ph) * gain[:, None]).sum(axis=0)
    return np.clip(np.round(y * 32767), -32768, 32767).astype(np.int16)
'''

TWIN = '''from benchmark import spec

read = spec.load_module("metrics", "{}").read
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """This folder copied with the toy's new files added, ``spec.HERE``
    on the copy, the toy's program importable, the port's tracer on and
    empty; BENCHMARK.json with the toy's new entries."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (tmp_path / "program").mkdir()
    (tmp_path / "program" / "toy_program.py").write_text(PROGRAM)
    (here / "engines" / "toy.py").write_text(ENGINE)
    (here / "configs" / "toy-1.json").write_text(json.dumps(
        {"engine": "toy", "params": {"voices": 8, "length": 4000,
                                     "sample_rate": 8000},
         "check": {"pcm_max_lsb": 1}}))
    (here / "traffic" / "toy-seeds.json").write_text(json.dumps(
        {"draw": {"seed": {"int": [1, 2 ** 40]}}, "warmup": 2,
         "checked": 3}))
    for name in ("syncs_per_render", "upload_ms"):
        (here / "metrics" / f"{name}.toy.py").write_text(TWIN.format(name))
    monkeypatch.syspath_prepend(str(tmp_path / "program"))
    monkeypatch.setattr(spec, "HERE", here)
    from benchmark import program_trace
    prof.enable()
    prof.reset()

    bench = spec.load_benchmark(ROOT)
    bench["configs"].append({"name": "toy-1", "file": "toy-1.json"})
    bench["workloads"].append({"name": CELL, "config": "toy-1",
                               "traffic": "toy-seeds", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "rtf":
            m["workloads"].append(CELL)
    bench["per_layer"] += [
        {"name": f"{n}.toy", "unit": u, "moves": "rtf", "workloads": [CELL]}
        for n, u in (("syncs_per_render", "count"), ("upload_ms", "ms"))]
    yield SimpleNamespace(bench=bench, cell=spec.cell(bench, CELL),
                          reader=program_trace)
    prof.reset()
    sys.modules.pop("toy_program", None)


def _run(toy, trace=False):
    result, _ = harness.run_cell(toy.bench, toy.cell, SEED, 0.2, trace,
                                 "cpu", time.perf_counter())
    return result


def test_a_toy_run_is_correct(toy):
    r = _run(toy)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["renders_checked"]["value"] == 3
    assert set(r["metrics"]) == {"rtf", "setup_s"}


@pytest.mark.parametrize("fault", faults.KINDS)
def test_each_fault_the_toy_names_fails_its_run(toy, monkeypatch, fault):
    spec.load_module("engines", "toy").FAULTS[fault](monkeypatch)
    r = _run(toy)
    assert r["correct"] is False, (fault, r["checks"])
    assert r["checks"]["pcm_max_lsb"]["value"] > 1


def test_the_reader_merges_the_toys_wiring_with_the_others(toy):
    w = toy.reader.wiring()
    assert w.roots == ("microsound.render", "patternlab.render",
                       "toy.render")
    assert w.last == ("microsound.fx", "patternlab.master", "toy.mix")
    assert w.uploads == ("microsound.upload", "patternlab.upload",
                         "toy.upload")
    assert w.wraps["host_build"] == ("microsound.build", "toy.build")
    assert w.wraps["dispatch"][-3:] == ("toy.upload", "toy.voices",
                                        "toy.mix")


def test_a_traced_toy_run_reads_its_program_spans(toy):
    r = _run(toy, trace=True)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"syncs_per_render.toy", "upload_ms.toy"}
    assert r["metrics"]["syncs_per_render.toy"]["value"] == 0   # no card
    assert r["metrics"]["upload_ms.toy"]["value"] > 0
    groups = toy.reader.renders(toy.reader.records())
    assert len(groups) == 2 + r["attempted"]          # warm-up + window
    assert {tuple(x.name for x in g) for g in groups} == {
        ("toy.build", "toy.upload", "toy.voices", "toy.mix")}
    prof.reset()
    sys.modules["toy_program"].render(5, 4, 100)     # the entry: a root
    (g,) = toy.reader.renders(toy.reader.records())
    assert sorted(x.name for x in g) == sorted(
        ["toy.render", "toy.build", "toy.upload", "toy.voices", "toy.mix"])


# --- a synthetic trace of three toy renders of the traced path, 20 ms
# apart: the benchmark's spans, the program's, and the card's operations

ORG = 1_760_000_000_000_000_000 + 654_321      # the slice's zero, epoch ns


def _trace():
    recs, notes, ops, ids = [], [], [], iter(range(1, 10 ** 6))

    def rec(name, a_us, b_us, **kw):
        rid = next(ids)
        recs.append(SimpleNamespace(
            name=name, attrs={}, id=rid, parent=None, request=rid,
            start_ns=ORG + a_us * 1000, end_ns=ORG + b_us * 1000,
            syncs=kw.get("syncs", 0), stream_ms=kw.get("stream_ms")))
    for k in range(3):
        t = 20_000 * k
        notes += [("render", t, t + 18_000), ("host_build", t, t + 3_000),
                  ("dispatch", t + 3_000, t + 12_000),
                  ("device_wait", t + 12_000, t + 17_000),
                  ("pull", t + 17_000, t + 18_000)]
        rec("toy.build", t + 10, t + 2_990)
        rec("toy.upload", t + 3_010, t + 4_000, syncs=2 + k)
        rec("toy.voices", t + 4_000, t + 9_000, syncs=1, stream_ms=6.0)
        rec("toy.mix", t + 9_000, t + 11_990, stream_ms=3.0)
        ops += [("voices", t + 5_000, t + 7_000),
                ("mix", t + 10_000, t + 11_000)]
    s = lambda us: us * 1e-6
    sl = tracing.Slice(renders=3, window_s=s(58_000),
                       device_ops=[(n, s(a), s(b)) for n, a, b in ops],
                       annotations=[(n, s(a), s(b)) for n, a, b in notes])
    return recs, sl


def test_the_reader_groups_counts_and_labels_a_toy_trace(toy):
    recs, sl = _trace()
    rd = toy.reader
    groups = rd.renders(recs)
    assert [[r.name for r in g] for g in groups] == [
        ["toy.build", "toy.upload", "toy.voices", "toy.mix"]] * 3
    assert rd.syncs_per_render(recs) == 4               # 3, 4, 5
    org, width = rd.origin(sl, recs)
    assert org == pytest.approx(ORG, abs=1)
    assert width == pytest.approx(20_000, abs=1)        # 10 µs each side
    labels = [(r.name if r else None, round(a * 1e6), round(b * 1e6))
              for r, a, b in rd.label_gaps(sl, recs, org)]
    assert labels == [("toy.build", 0, 5_000),
                      ("toy.voices", 7_000, 10_000), (None, 11_000, 25_000),
                      ("toy.voices", 27_000, 30_000), (None, 31_000, 45_000),
                      ("toy.voices", 47_000, 50_000), (None, 51_000, 58_000)]
    assert rd.idle_ms(sl, "toy.voices", recs) == pytest.approx(3.0)
    assert rd.idle_ms(sl, "toy.build", recs) == pytest.approx(0.0)
    assert rd.stream_ms("toy.voices", recs) == 6.0

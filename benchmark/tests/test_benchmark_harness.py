"""The harness's own pieces on the CPU: traffic, window metrics, byte
counts, the import guard, finding parts by name, the trace reduction and
BENCHMARK.json against its contract."""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import guard, harness, roofline, spec, tracing  # noqa: E402
from benchmark.generator import Reservoir, Traffic  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _metric(name):
    return spec.load_module("metrics", name)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_requests_are_a_function_of_the_seed_alone(cell):
    mix = spec.load_json("traffic", spec.cell(BENCH, cell)["traffic"])
    big = 2 ** 31 + 12345
    a, b = Traffic(mix, big), Traffic(mix, big)
    reqs = [a.request(k) for k in range(50)]
    assert reqs == [b.request(k) for k in range(50)]
    assert reqs != [Traffic(mix, big + 1).request(k) for k in range(50)]
    assert reqs[0] != a.request(0, "warmup")
    assert len({json.dumps(r, sort_keys=True) for r in reqs}) == 50
    assert Traffic(mix, -7).request(3) == Traffic(mix, -7).request(3)


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for s in range(400):
        r = Reservoir(2, np.random.default_rng([s]))
        for i in range(10):
            r.offer(i)
        picks += r.items
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 50 and counts.max() < 110
    r1, r2 = (Reservoir(3, np.random.default_rng([9])) for _ in range(2))
    for i in range(100):
        r1.offer(i)
        r2.offer(i)
    assert r1.items == r2.items


def test_rtf_and_p95_cover_every_render_of_a_window_with_a_stall():
    lat = [0.03] * 95 + [0.5] * 5 + [2.0]         # 101 renders, one stall
    w = harness.Window(latencies=lat, audio_s=[4.0] * 101,
                       wall_s=sum(lat) + 0.05, attempted=101)
    run = harness.RunData(device_name="cpu", setup_s=1.5, window=w)
    assert _metric("rtf").read(run) == pytest.approx(404.0 / w.wall_s)
    # the 96th of 101 sorted latencies: a stalled render, not a median
    assert _metric("render_ms_p95").read(run) == pytest.approx(500.0)
    assert _metric("setup_s").read(run) == 1.5
    empty = harness.RunData(device_name="cpu", setup_s=0.0,
                            window=harness.Window())
    assert _metric("rtf").read(empty) is None
    assert _metric("render_ms_p95").read(empty) is None


def test_byte_counts_match_the_hand_counts():
    # overlap_add.cu at config 3 (E 288, Lw 19 456, N 851 968) and config
    # 4 (E 62, Lw 32 768, N 385 568): 29.23 and 11.21 MB
    assert roofline.overlap_add_bytes(288, 19456, 851968) == \
        4 * 288 * 19456 + 4 * 288 + 8 * 851968
    assert round(roofline.overlap_add_bytes(288, 19456, 851968) / 1e6,
                 2) == 29.23
    assert round(roofline.overlap_add_bytes(62, 32768, 385568) / 1e6,
                 2) == 11.21
    # the fused stick-slip at config 3's width (E 288, L 32 768): 37.75 MB
    # and 35 f32 operations a sample; the bytes govern
    assert round(roofline.stick_slip_bytes(288, 32768) / 1e6, 2) == 37.75
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    b = roofline.bound_s(roofline.stick_slip_bytes(288, 32768),
                         roofline.stick_slip_flops(288, 32768), pk)
    assert b == pytest.approx(roofline.stick_slip_bytes(288, 32768)
                              / 3.35e12)
    assert roofline.peaks("cpu") == {}


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"jax": 1}) == ["jax"]
    assert guard.forbidden_loaded({"jax.numpy": 1, "numpy": 1}) == ["jax"]
    assert guard.forbidden_loaded({"audio_suite_tpu.models": 1}) == \
        ["audio_suite_tpu"]
    assert guard.forbidden_loaded({"jaxlib": 1, "flax.linen": 1}) == \
        ["flax", "jaxlib"]
    assert guard.forbidden_loaded({"audio_suite_torch": 1,
                                   "audio_suite_torch.models": 1,
                                   "jaxtyping": 1, "benchmark": 1}) == []


def test_emit_refuses_to_print_when_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.emit({"correct": True}, ["check x: 0 (limit 0)"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_emit_prints_the_checks_last(capsys):
    assert harness.emit({"correct": True, "checks": {}}, ["check a: 1"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["correct"] is True
    assert out.err.strip().splitlines()[-1] == "check a: 1"


def test_new_parts_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix, an engine and a metric dropped in
    as new files, with new BENCHMARK.json entries, and nothing edited."""
    for kind in ("configs", "traffic", "engines", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "toy-1.json").write_text(json.dumps(
        {"engine": "toy", "check": {"pcm_max_lsb": 0}}))
    (tmp_path / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"fixed": {"len": 3}, "draw": {"seed": {"int": [1, 9]}}}))
    (tmp_path / "engines" / "toy.py").write_text("NAME = 'toy'\n")
    (tmp_path / "metrics" / "toy_ms.toy.py").write_text(
        "def read(run):\n    return 7.0\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    bench = {"workloads": [{"name": "toy.cell", "config": "toy-1",
                            "traffic": "toy-mix", "chips": 1}],
             "end_to_end": [{"name": "rtf", "moves": None}],
             "per_layer": [{"name": "toy_ms.toy", "moves": "rtf"},
                           {"name": "other", "moves": "rtf",
                            "workloads": ["elsewhere"]}]}
    cell = spec.cell(bench, "toy.cell")
    assert spec.load_json("configs", cell["config"])["engine"] == "toy"
    assert Traffic(spec.load_json("traffic", cell["traffic"]), 5) \
        .request(0)["len"] == 3
    assert spec.load_module("engines", "toy").NAME == "toy"
    got = spec.metrics_for(bench, "toy.cell", trace=True)
    assert [m["name"] for m in got] == ["toy_ms.toy"]
    assert spec.load_module("metrics", "toy_ms.toy").read(None) == 7.0
    with pytest.raises(FileNotFoundError):
        spec.load_json("configs", "missing")
    with pytest.raises(ValueError):
        spec.load_json("configs", "../outside")


def _slice():
    ms = 1e6   # ns
    events = [("bench.render", False, 0, 10 * ms),
              ("bench.dispatch", False, 0, 6 * ms),
              ("bench.pull", False, 8 * ms, 10 * ms),
              ("bench.render", False, 10 * ms, 20 * ms),
              ("bench.host_build", False, 10 * ms, 14 * ms),
              ("k1", True, 1 * ms, 3 * ms), ("k2", True, 2 * ms, 5 * ms),
              ("overlap_add_kernel(float)", True, 16 * ms, 18 * ms),
              ("outside", True, 25 * ms, 26 * ms)]
    return tracing.reduce_events(events, {"m.f": [(1, 2, 3)]})


def test_slice_reduction_busy_idle_and_breakdown():
    sl = _slice()
    assert sl.renders == 2 and sl.window_s == pytest.approx(0.020)
    assert len(sl.device_ops) == 3            # "outside" is past the end
    assert sl.busy_s() == pytest.approx(0.006)
    gaps = dict(tracing.breakdown(sl)["idle_gaps"])
    # [0, 1) dispatch; [5, 16): its middle at 10.5 ms, in host_build;
    # [18, 20) render
    assert gaps["dispatch"] == pytest.approx(0.001)
    assert gaps["host_build"] == pytest.approx(0.011)
    assert gaps["render"] == pytest.approx(0.002)
    ops = tracing.breakdown(sl)["device_ops"]
    assert ops[0] == ["k2", pytest.approx(0.003)]
    run = harness.RunData(device_name="cpu", setup_s=0, window=None,
                          slice=sl)
    assert _metric("launches_per_render").read(run) == 1.5
    assert _metric("device_busy_ms").read(run) == pytest.approx(3.0)
    assert _metric("device_idle_pct").read(run) == pytest.approx(70.0)
    assert tracing.union_s([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert tracing.reduce_events([("k", True, 0, 1)]) is None


def test_roofline_pairs_launches_and_kernels_from_the_slices_end():
    mod = _metric("overlap_add_roofline")
    sl = tracing.Slice(renders=1, window_s=1.0, device_ops=[
        ("overlap_add_kernel(x)", 0.1, 0.1 + 2e-5),
        ("overlap_add_kernel(x)", 0.2, 0.2 + 1e-5)], annotations=[],
        records={"audio_suite_torch.kernels.overlap_add":
                 [(9, 9, 9), (288, 19456, 851968)]})
    run = harness.RunData(device_name="NVIDIA H100 80GB HBM3", setup_s=0,
                          window=None, slice=sl)
    # both kernels pair with both launches
    want = 100 * (roofline.overlap_add_bytes(9, 9, 9)
                  + roofline.overlap_add_bytes(288, 19456, 851968)) \
        / 3.35e12 / 3e-5
    assert mod.read(run) == pytest.approx(want)
    # a dropped first kernel event: the last launch pairs with the last
    sl.device_ops = sl.device_ops[1:]
    assert mod.read(run) == pytest.approx(
        100 * roofline.overlap_add_bytes(288, 19456, 851968) / 3.35e12
        / 1e-5)
    run.device_name = "cpu"
    assert mod.read(run) is None
    sl.records = {}
    run.device_name = "NVIDIA H100 80GB HBM3"
    assert mod.read(run) is None


def test_recorder_stands_in_and_hands_the_counter_back(monkeypatch):
    import types
    m = types.ModuleType("fake_kernels")
    exec("def launch(x):\n    launch.launches += 1\n    return x\n"
         "launch.launches = 0\ndef caller(x):\n    return launch(x)\n",
         m.__dict__)
    monkeypatch.setitem(sys.modules, "fake_kernels", m)
    rec = tracing.Recorder("fake_kernels", "launch", lambda x: (x,))
    rec.install()
    m.caller(1)
    rec.on = True
    m.caller(2)
    rec.remove()
    m.caller(3)
    assert rec.calls == [(2,)] and m.launch.launches == 3
    assert m.launch.__name__ == "launch"


def test_spans_time_each_name():
    sp = tracing.Spans()
    for _ in range(3):
        with sp("a"):
            pass
    assert len(sp.s["a"]) == 3 and sp.mean_ms("a") >= 0
    assert sp.mean_ms("b") is None


def test_benchmark_json_keeps_its_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells fits the driver's 43 200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        spec.load_json("traffic", w["traffic"])
        assert any(m["name"] == "setup_s" for m in
                   spec.metrics_for(b, w["name"], False))
        assert len(spec.metrics_for(b, w["name"], False)) >= 2
        assert spec.metrics_for(b, w["name"], True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert callable(_metric(m["name"]).read)
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        # each cell it is read in reports the end-to-end metric it moves
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  spec.metrics_for(b, w, False)}
    assert cells == len({w["name"] for w in b["workloads"]})
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_exits_without_a_result_when_there_is_no_card(capsys,
                                                          monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from benchmark import run
    assert run.main(["--workload", "ms-c3-noiseburst", "--seed",
                     str(2 ** 31 + 5), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

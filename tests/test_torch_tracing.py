"""The port's tracer (``audio_suite_torch/utils/profiling.py``) and the
benchmark's reader of its spans (``benchmark/program_trace.py`` and the
per-layer metrics that use it), on the CPU:

- off, a render leaves no record; on and off, the PCM is bit-identical;
- on, every span of a Microsound and a Pattern Lab render is there once
  with its parent and its request, ``_space_kernels``' ``hit`` and
  Pattern Lab's ``memo_hit`` say what the memos did, the tape's
  ``tape.tables`` carries ``on_card`` and the walk's chunk counts beside
  ``hit`` and the table sizes, and a kernel library's first load is a
  ``kernels.load`` span;
- the spans' starts agree with their ``record_function`` ranges under a
  CPU ``torch.profiler``; the store is bounded and counts its drops; the
  sync debug mode and the warning hooks come back on ``disable()``, and
  torch's sync warnings are counted against the innermost span;
- the reader recovers a slice's origin, refuses an empty, contradictory
  or wide one, labels idle gaps by the innermost program span, and each
  new metric reads the expected value from synthetic records and slices,
  and None from an empty tracer;
- the off span's cost, timed over 10^5 calls.
"""
import importlib
import statistics
import sys
import time
import timeit
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_suite_torch import kernels
from audio_suite_torch.models import microsound as ms
from audio_suite_torch.models import patternlab as pl
from audio_suite_torch.utils import profiling as prof

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, spec, tracing  # noqa: E402

IR = np.random.default_rng(7).standard_normal(256).astype(np.float32)
GENERATORS = ["Glass Cells", "Fibonacci Gate", "Prime Phase",
              "Pythagorean Canon"]


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and empty."""
    prof.disable()
    prof.reset()
    yield
    prof.disable()
    prof.reset()


@pytest.fixture
def reader():
    """``benchmark/program_trace.py``; its import turns the tracer on."""
    return importlib.import_module("benchmark.program_trace")


def _ms_params(seed=11):
    return ms.MicrosoundParams.from_dict(dict(
        base_sr=8000, out_dur_s=0.3, time_unfold=2.0, micro_ms=4.0,
        seed=seed, grains_per_sec=30.0, max_grains=24, er_cloud_on=True,
        er_taps=32, er_max_ms=20.0, stereo_on=True,
        gen_mode="Noise burst"))


def _ms_render(seed=11):
    y, _ = ms.render(_ms_params(seed), ir_audio=IR, pcm16=True,
                     device="cpu")
    return y.numpy()


def _pl_events(seed=5):
    cfg = pl.RenderConfig(sample_rate=11025, seconds=1.0, seed=seed)
    events = []
    for g in GENERATORS:
        events.extend(pl.generate(g, cfg))
    return events, cfg


def _pl_render(seed=5):
    events, cfg = _pl_events(seed)
    y, _ = pl.render(events, cfg, pcm16=True, device="cpu")
    return y


RENDERS = {"microsound": _ms_render, "patternlab": _pl_render}


@pytest.mark.parametrize("engine", sorted(RENDERS))
def test_off_a_render_leaves_no_record(engine):
    RENDERS[engine]()
    assert not prof.enabled()
    assert prof.records() == [] and prof.dropped() == 0


@pytest.mark.parametrize("engine", sorted(RENDERS))
def test_pcm_is_bit_identical_on_and_off(engine):
    off = RENDERS[engine]()
    prof.enable()
    on = RENDERS[engine]()
    prof.disable()
    assert prof.records()
    assert off.dtype == on.dtype == np.int16
    assert np.array_equal(off, on)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_microsound_spans_once_a_render_under_its_root():
    prof.enable()
    _ms_render(seed=12)
    _ms_render(seed=13)
    recs = prof.records()
    roots = [r for r in recs if r.name == "microsound.render"]
    assert len(roots) == 2
    for root in roots:
        assert root.parent is None and root.request == root.id
        kids = _by_name(r for r in recs if r.request == root.id
                        and r is not root)
        assert sorted(kids) == sorted(
            ["microsound.build", "microsound.space_kernels",
             "microsound.upload", "microsound.chain", "microsound.fx"])
        for name, calls in kids.items():
            (r,) = calls
            assert r.parent == root.id, name
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
            assert r.stream_ms is None      # device stages on the CPU
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns)][1:6]
    assert order == ["microsound.build", "microsound.space_kernels",
                     "microsound.upload", "microsound.chain",
                     "microsound.fx"]


def test_patternlab_spans_and_memo_hit():
    events, cfg = _pl_events(seed=6)
    prof.enable()
    pl.render(events, cfg, pcm16=True, device="cpu")
    pl.render(events, cfg, pcm16=True, device="cpu")   # the memo serves
    recs = prof.records()
    miss, hit = [r for r in recs if r.name == "patternlab.render"]
    assert miss.attrs == {"memo_hit": False}
    assert hit.attrs == {"memo_hit": True}
    for root, once in ((miss, ["patternlab.time_ops", "patternlab.pack",
                               "patternlab.upload", "patternlab.bank",
                               "patternlab.master", "patternlab.pull"]),
                       (hit, ["patternlab.bank", "patternlab.master",
                              "patternlab.pull"])):
        kids = _by_name(r for r in recs if r.request == root.id
                        and r is not root)
        for name in once:
            (r,) = kids.pop(name)
            assert r.parent == root.id, name
        (bank,) = [r for r in recs if r.request == root.id
                   and r.name == "patternlab.bank"]
        buckets = kids.pop("patternlab.fm_bank") \
            + kids.pop("patternlab.psg_bank")
        assert buckets and all(r.parent == bank.id for r in buckets)
        assert not kids
    # the generators run before the render, each a request of its own
    prof.reset()
    _pl_events(seed=6)
    gens = prof.records()
    assert [r.name for r in gens] == ["patternlab.generate"] * 4
    assert len({r.request for r in gens}) == 4
    assert all(r.parent is None for r in gens)


def test_space_kernels_hit_is_false_then_true():
    ms._SPACE_KERNEL_CACHE.clear()
    prof.enable()
    p = _ms_params(seed=21)
    first = ms._space_kernels(p, IR, device="cpu")
    second = ms._space_kernels(p, IR, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(first[:2], second[:2]))
    hits = [r.attrs["hit"] for r in prof.records()
            if r.name == "microsound.space_kernels"]
    assert hits == [False, True]


def test_the_tape_tables_span_carries_the_walk():
    from audio_suite_torch.models import tape
    tape._TAPE_PROG_CACHE.clear()
    audio = np.random.default_rng(3).uniform(-0.5, 0.5, 8000) \
        .astype(np.float32)
    p = tape.TapeParams(sample_rate=8000, markers=[3000, 5000],
                        section_speeds=[1.0, 2.0, 0.5],
                        section_reverse=[False, True, False])
    prof.enable()
    for _ in range(2):
        tape.render_tape(audio, p, device="cpu", pcm16=True)
    recs = [r.attrs for r in prof.records() if r.name == "tape.tables"]
    tape._TAPE_PROG_CACHE.clear()
    assert [a["hit"] for a in recs] == [False, True]
    for a in recs:
        assert set(a) == {"hit", "visits", "runs", "triggers", "on_card",
                          "chunks_walked", "chunks_jumped"}
        assert a["on_card"] == a["chunks_walked"] == a["chunks_jumped"] == 0
        assert a["visits"] >= 3 and a["runs"] >= 3


def test_a_kernel_librarys_first_load_is_a_span(monkeypatch):
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, fn):
            return SimpleNamespace()

    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build", lambda name: f"/x/lib{name}.so")
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    prof.enable()
    assert kernels._lib("overlap_add") is kernels._lib("overlap_add")
    (r,) = prof.records()
    assert loaded == ["/x/liboverlap_add.so"]
    assert r.name == "kernels.load" and r.attrs["lib"] == "overlap_add"
    assert isinstance(r.attrs["built"], bool)


def test_spans_start_with_their_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    prof.enable()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for k in range(20):
            with prof.span(f"clock.span{k}"):
                torch.ones(4).sum()
    starts = {r.name: r.start_ns for r in prof.records()}
    ranges = {e.name(): e.start_ns()
              for e in p.profiler.kineto_results.events()
              if e.name().startswith("clock.span")}
    assert set(ranges) == set(starts)
    lag_us = statistics.median(abs(ranges[n] - starts[n]) / 1e3
                               for n in starts)
    assert lag_us < 100, lag_us


def test_the_store_is_bounded_and_counts_drops():
    prof.enable()
    extra = 5
    for _ in range(prof.CAPACITY + extra):
        with prof.span("store.s"):
            pass
    recs = prof.records()
    assert len(recs) == prof.CAPACITY and prof.dropped() == extra
    assert recs[0].id < recs[-1].id       # the oldest went
    prof.reset()
    assert prof.records() == [] and prof.dropped() == 0


def test_enable_and_disable_restore_the_sync_debug_mode(monkeypatch,
                                                       recwarn):
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])

    def set_mode(m):
        # torch warns that the mode is a prototype as it sets it
        warnings.warn(f"sync debug mode {m} is a prototype")
        mode["now"] = {"default": 0, "warn": 1, "error": 2}.get(m, m)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    shown = warnings.showwarning
    for before in (0, 2):
        mode["now"] = before
        prof.enable()
        assert mode["now"] == 1 and warnings.showwarning is not shown
        prof.enable()                       # on already: nothing changes
        prof.disable()
        assert mode["now"] == before and warnings.showwarning is shown
        assert not prof.enabled()
    # passed on to the hook that was in place, not swallowed
    assert [str(w.message).split()[3] for w in recwarn] == [
        "warn", "0", "warn", "2"]


def test_sync_warnings_count_against_the_innermost_span(recwarn):
    prof.enable()
    with prof.span("sync.outer"):
        warnings.warn(prof.SYNC_WARNING)
        with prof.span("sync.inner"):
            for _ in range(3):      # one source line, counted each time
                warnings.warn(prof.SYNC_WARNING + " (Triggered internally)")
        warnings.warn("another warning")
    warnings.warn(prof.SYNC_WARNING)        # no span open: not counted
    prof.disable()
    syncs = {r.name: r.syncs for r in prof.records()}
    assert syncs == {"sync.inner": 3, "sync.outer": 1}
    # sync warnings are counted, not shown; others go on as before
    assert [str(w.message) for w in recwarn] == ["another warning"]


def test_device_trace_turns_the_tracer_on_for_its_region(tmp_path):
    with prof.device_trace(str(tmp_path), "cpu"):
        assert prof.enabled()
        with prof.span("region.s"):
            pass
    assert not prof.enabled()
    assert [r.name for r in prof.records()] == ["region.s"]
    prof.enable()
    with prof.device_trace(str(tmp_path), "cpu"):
        pass
    assert prof.enabled()                   # left on as it was


# ---------------------------------------------------------------------------
# The reader, on synthetic records and slices
# ---------------------------------------------------------------------------

ORG = 1_760_000_000_000_000_000 + 123_456      # the slice's zero, epoch ns
RENDERS_N = 3


def _rec(name, a_us, b_us, *, rid, parent=None, request=None, syncs=0,
         stream_ms=None, **attrs):
    """A record of a span over slice µs [a_us, b_us]."""
    return SimpleNamespace(name=name, attrs=attrs, id=rid, parent=parent,
                           request=rid if request is None else request,
                           start_ns=ORG + a_us * 1000,
                           end_ns=ORG + b_us * 1000, syncs=syncs,
                           stream_ms=stream_ms)


def _ms_trace():
    """Three Microsound renders of the traced path (no root), 50 ms
    apart: (records, slice)."""
    recs, notes, ops, ids = [], [], [], iter(range(1, 10 ** 6))
    for k in range(RENDERS_N):
        t = 50_000 * k
        notes += [("render", t, t + 46_000), ("host_build", t, t + 2_000),
                  ("space_kernels", t + 2_000, t + 18_000),
                  ("dispatch", t + 18_000, t + 30_000),
                  ("device_wait", t + 30_000, t + 45_000),
                  ("pull", t + 45_000, t + 46_000)]
        recs.append(_rec("microsound.build", t + 10, t + 1_990,
                         rid=next(ids)))
        recs.append(_rec("microsound.space_kernels", t + 2_010, t + 17_990,
                         rid=next(ids), hit=False))
        recs.append(_rec("microsound.upload", t + 18_010, t + 19_000,
                         rid=next(ids), syncs=3))
        chain = _rec("microsound.chain", t + 19_000, t + 27_000,
                     rid=next(ids), syncs=1, stream_ms=20.0 + k)
        recs.append(chain)
        if k == 0:          # the first render loads a kernel library
            recs.append(_rec("kernels.load", t + 19_500, t + 24_500,
                             rid=next(ids), parent=chain.id,
                             request=chain.id, lib="overlap_add",
                             built=False))
        recs.append(_rec("microsound.fx", t + 27_000, t + 29_990,
                         rid=next(ids), stream_ms=5.0))
        ops += [("k1", t + 20_000, t + 21_000), ("k2", t + 24_000, t + 26_000),
                ("k3", t + 28_500, t + 29_500)]
    return recs, _slice(notes, ops, 50_000 * (RENDERS_N - 1) + 46_000)


def _pl_trace():
    """Three Pattern Lab renders of the traced path, 100 ms apart."""
    recs, notes, ops, ids = [], [], [], iter(range(1, 10 ** 6))
    for k in range(RENDERS_N):
        t = 100_000 * k
        notes += [("render", t, t + 91_000), ("host_prepare", t, t + 8_000),
                  ("dispatch", t + 8_000, t + 60_000),
                  ("device_wait", t + 60_000, t + 90_000),
                  ("pull", t + 90_000, t + 91_000)]
        for i in range(4):
            recs.append(_rec("patternlab.generate", t + 20 + 800 * i,
                             t + 700 + 800 * i, rid=next(ids)))
        recs.append(_rec("patternlab.time_ops", t + 3_200, t + 3_800,
                         rid=next(ids)))
        recs.append(_rec("patternlab.pack", t + 4_000, t + 6_500,
                         rid=next(ids)))
        recs.append(_rec("patternlab.upload", t + 6_600, t + 7_990,
                         rid=next(ids), syncs=2))
        bank = _rec("patternlab.bank", t + 8_010, t + 50_000, rid=next(ids),
                    stream_ms=40.0 + k, fused=3 - k % 2, eager=k % 2)
        recs.append(bank)
        recs.append(_rec("patternlab.fm_bank", t + 9_000, t + 20_000,
                         rid=next(ids), parent=bank.id, request=bank.id,
                         syncs=1))
        recs.append(_rec("patternlab.psg_bank", t + 21_000, t + 30_000,
                         rid=next(ids), parent=bank.id, request=bank.id))
        recs.append(_rec("patternlab.master", t + 50_000, t + 59_990,
                         rid=next(ids), stream_ms=4.0))
        ops += [("k1", t + 10_000, t + 12_000), ("k2", t + 34_000, t + 40_000),
                ("k3", t + 52_000, t + 56_000)]
    return recs, _slice(notes, ops, 100_000 * (RENDERS_N - 1) + 91_000)


def _slice(notes, ops, window_us):
    s = lambda us: us * 1e-6
    return tracing.Slice(renders=RENDERS_N, window_s=s(window_us),
                         device_ops=[(n, s(a), s(b)) for n, a, b in ops],
                         annotations=[(n, s(a), s(b)) for n, a, b in notes])


def test_the_origin_is_recovered_within_a_tenth_of_a_ms(reader):
    for recs, sl in (_ms_trace(), _pl_trace()):
        org, width = reader.origin(sl, recs)
        assert abs(org - ORG) <= 100_000 and 0 <= width <= 100_000
        # the spans' 10-20 µs slack inside the benchmark's: 20 µs wide
        assert width == pytest.approx(20_000, abs=1)
        assert org == pytest.approx(ORG, abs=1)


def _shift(recs, name, by_us):
    return [SimpleNamespace(**{**vars(r), "start_ns": r.start_ns + by_us
                               * 1000, "end_ns": r.end_ns + by_us * 1000})
            if r.name == name else r for r in recs]


def _widen(recs, name, by_us):
    return [SimpleNamespace(**{**vars(r), "end_ns": r.end_ns + by_us * 1000})
            if r.name == name else r for r in recs]


@pytest.mark.parametrize("case", ["no records", "no spans in the slice",
                                  "contradictory", "wider than 0.1 ms"])
def test_the_origin_is_none_when_it_cannot_be_found(reader, case):
    recs, sl = _ms_trace()
    if case == "no records":
        recs = []
    elif case == "no spans in the slice":
        sl = _slice([], [("k", 0, 1)], 10)
    elif case == "contradictory":
        # the build longer than the benchmark span around it
        recs = _widen(recs, "microsound.build", 30)
    else:
        # every program span 0.2 ms inside the benchmark's
        recs = [SimpleNamespace(**{**vars(r),
                                   "start_ns": r.start_ns + 200_000,
                                   "end_ns": max(r.start_ns + 200_000,
                                                 r.end_ns - 200_000)})
                for r in recs]
    assert reader.origin(sl, recs) is None
    assert reader.idle_ms(sl, "microsound.chain", recs) is None
    assert reader.origin(None, recs) is None


def test_idle_gaps_are_labelled_by_the_innermost_program_span(reader):
    recs, sl = _ms_trace()
    labels = [(r.name if r else None, round(a * 1e6), round(b * 1e6))
              for r, a, b in reader.label_gaps(sl, recs, ORG)]
    assert labels[:4] == [("microsound.space_kernels", 0, 20_000),
                          ("kernels.load", 21_000, 24_000),  # in the chain
                          ("microsound.fx", 26_000, 28_500),
                          (None, 29_500, 70_000)]             # device wait
    assert labels[4:6] == [("microsound.chain", 71_000, 74_000),
                           ("microsound.fx", 76_000, 78_500)]
    recs, sl = _pl_trace()
    labels = [(r.name if r else None, round(a * 1e6), round(b * 1e6))
              for r, a, b in reader.label_gaps(sl, recs, ORG)]
    assert labels[:4] == [("patternlab.pack", 0, 10_000),
                          ("patternlab.psg_bank", 12_000, 34_000),
                          ("patternlab.bank", 40_000, 52_000),
                          (None, 56_000, 110_000)]


def test_renders_group_the_traced_path_and_the_entries(reader):
    recs, _ = _pl_trace()
    groups = reader.renders(recs)
    assert len(groups) == RENDERS_N
    assert [sum(r.syncs for r in g) for g in groups] == [3] * RENDERS_N
    prof.enable()
    _ms_render(seed=14)
    _ms_render(seed=15)
    live = prof.records()
    assert [len(g) for g in reader.renders(live)] == [6, 6]


# (metric, trace, expected): the synthetic traces' values, by hand
EXPECTED = [
    ("space_kernels_ms.microsound", "ms", 15.98),
    ("space_kernels_ms.microsound.p95", "ms", 15.98),
    ("upload_ms", "ms", 0.99),
    ("upload_ms", "pl", 1.39),
    ("chain_dispatch_ms.microsound", "ms", 8.0),
    ("chain_dispatch_ms.microsound.p95", "ms", 8.0),
    ("fx_dispatch_ms.microsound", "ms", 2.99),
    ("chain_stream_ms.microsound", "ms", 21.0),
    ("fx_stream_ms.microsound", "ms", 5.0),
    ("chain_idle_ms.microsound", "ms", 3.0),     # the load's gap counts
    ("pack_ms.patternlab", "pl", 2.5),
    ("bank_dispatch_ms.patternlab", "pl", 41.99),
    ("bank_stream_ms.patternlab", "pl", 41.0),
    ("bank_idle_ms.patternlab", "pl", 34.0),     # 22 under psg_bank + 12
    ("syncs_per_render", "ms", 4),
    ("syncs_per_render", "pl", 3),
    ("kernel_load_ms", "ms", 5.0),
    ("kernel_load_ms", "pl", 0.0),
    ("bank_fused_share.patternlab", "pl", 8 / 9),   # 3 + 2 + 3 of 3 buckets x 3
]


@pytest.mark.parametrize("name,trace,want", EXPECTED)
def test_each_new_metric_reads_the_tracer(reader, monkeypatch, name, trace,
                                          want):
    mod = spec.load_module("metrics", name)
    recs, sl = _ms_trace() if trace == "ms" else _pl_trace()
    run = harness.RunData(device_name="cpu", setup_s=0.0, window=None,
                          slice=sl)
    monkeypatch.setattr(reader, "records", lambda: recs)
    assert mod.read(run) == pytest.approx(want, abs=1e-9)
    monkeypatch.setattr(reader, "records", lambda: [])
    assert mod.read(run) is None
    assert mod.read(harness.RunData("cpu", 0.0, None)) is None


def test_the_fused_share_is_none_where_the_bank_counts_nothing(reader,
                                                             monkeypatch):
    """A program whose bank span has no ``fused`` / ``eager`` counts (one
    from before the fused bank) gives no share, nor does an empty bank."""
    mod = spec.load_module("metrics", "bank_fused_share.patternlab")
    recs, sl = _pl_trace()
    for r in recs:
        r.attrs = {}
    run = harness.RunData(device_name="cpu", setup_s=0.0, window=None,
                          slice=sl)
    monkeypatch.setattr(reader, "records", lambda: recs)
    assert mod.read(run) is None
    recs[0].attrs = {"fused": 0, "eager": 0}
    recs[0].name = "patternlab.bank"
    assert mod.read(run) is None
    recs[1].attrs = {"fused": 0, "eager": 4}
    recs[1].name = "patternlab.bank"
    assert mod.read(run) == 0.0


def test_every_new_metric_is_in_benchmark_json():
    bench = spec.load_benchmark(ROOT)
    names = {m["name"] for m in bench["per_layer"]}
    assert {n for n, _, _ in EXPECTED} <= names


def test_an_off_span_costs_under_half_a_microsecond():
    n = 100_000

    def spans():
        for _ in range(n):
            with prof.span("cost.s"):
                pass

    def loop():
        for _ in range(n):
            pass
    best = min(timeit.repeat(spans, number=1, repeat=7))
    base = min(timeit.repeat(loop, number=1, repeat=7))
    ns = (best - base) / n * 1e9
    print(f"off span: {ns:.1f} ns a span on this CPU ({time.ctime()})")
    assert prof.records() == []
    assert ns <= 500, ns

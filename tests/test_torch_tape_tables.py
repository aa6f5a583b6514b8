"""The tape's control tables built by chunk sums
(``ops/varispeed.py:tape_tables_plain``, on a card
``kernels/tape_scan.cu``'s table walk through ``tape_tables_on_card``)
held bit for bit against the C++ walk ``native_rt.tape_tables``: every
table, the counts and the final state.  Imports no jax, so the card's
tests run where only PyTorch with CUDA and nvcc are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tape_tables.py -q

The programs: bench config 1 at its smoke size, speeds at 0.25 and 4.0,
every section reversed, the splice on and off, boundaries at 0, 1, n - 1
and n, a visit that crosses on a chunk's last sample and one on a chunk's
first (chunks of 256), a trigger whose run of samples on the boundary
straddles two chunks (chunks of 32), T shorter than a chunk of 1 024, a
section at speed 0, sections at ``tape.MAX_SPEED``, more distinct speeds
than the kernel's table holds, and markers dense enough that the tables
pass their capacity and the walk runs again; each at chunks of 32, 256,
1 024 and 4 096.

On the CPU: the twin on every program; the card path's unpacking with the
kernel stood in for by the twin's own walk (the retry and the second pull
included); ``models/tape.py:_walk`` keeps the C++ walk on CPU tapes and
with inertia on (``on_card`` 0, its tables copied to the device with it),
and walks nothing for a program that carries its tables; a speed past
``tape.MAX_SPEED`` (or not finite) is refused when the program is built.  On the card: the kernel's
tables equal the C++ walk's and its walked chunks the twin's, at full
config 1 over traffic draws too; the device engine's PCM16 is the same
with the C++ tables uploaded; ``tape.tables`` reports the walk.
"""
import numpy as np
import pytest
import torch

from audio_suite_torch import kernels
from audio_suite_torch.models import tape
from audio_suite_torch.ops import varispeed
from audio_suite_torch.utils import native_rt
from audio_suite_torch.utils import profiling as prof
import chip_smoke

SR = 48000
CHUNKS = (32, 256, 1024, 4096)
NAMES = ("visit_start", "visit_bw", "visit_bf", "visit_sec", "run_start",
         "run_s0", "run_m", "triggers")


def _config1():
    """Bench config 1 at its smoke size: (n, T, params)."""
    audio, p, T = chip_smoke.config1(4.0)
    return len(audio), T, p


def _two(m: int, speeds=(1.0, 0.5), **kw):
    return 12000, 9000, tape.TapeParams(sample_rate=SR, markers=[m],
                                        section_speeds=list(speeds),
                                        section_reverse=[False, False],
                                        tape_age=50, **kw)


def _dense(n=48000, count=300):
    markers = sorted(set(int(x) for x in
                         np.linspace(1, n - 1, count + 2)[1:-1]))
    k = len(markers) + 1
    return n, n + n // 3, tape.TapeParams(
        sample_rate=SR, markers=markers,
        section_speeds=[(0.5, 1.0, 2.0)[i % 3] for i in range(k)],
        section_reverse=[i % 4 == 1 for i in range(k)], splice_env_len=16)


def _many_speeds(n=30000, k=20):
    return n, n, tape.TapeParams(
        sample_rate=44100, markers=[n * (i + 1) // k for i in range(k - 1)],
        section_speeds=[0.25 + 0.19 * i for i in range(k)],
        section_reverse=[i % 3 == 0 for i in range(k)], tape_age=90)


# name -> () -> (n, T, params)
PROGRAMS = {
    "config1_smoke": _config1,
    "speeds_quarter_and_four": lambda: (20000, 40000, tape.TapeParams(
        sample_rate=SR, markers=[5000, 9000, 15000],
        section_speeds=[0.25, 4.0, 0.25, 4.0],
        section_reverse=[False, True, True, False], tape_age=100)),
    "all_reversed": lambda: (16000, 24000, tape.TapeParams(
        sample_rate=44100, markers=[3000, 7000, 12000],
        section_speeds=[0.7, 1.4, 2.2, 0.9],
        section_reverse=[True, True, True, True], tape_age=30)),
    "splice_off": lambda: (16000, 24000, tape.TapeParams(
        sample_rate=44100, markers=[3000, 7000, 12000],
        section_speeds=[0.7, 1.4, 2.2, 0.9],
        section_reverse=[True, False, True, False], tape_age=30,
        enable_splice_fx=False)),
    "boundaries_0_1_n": lambda: (10000, 30000, tape.TapeParams(
        sample_rate=8000, markers=[1, 9999, 10000],
        section_speeds=[1.0, 0.5, 2.0, 1.0],
        section_reverse=[True, False, True, False], tape_age=70)),
    "crossing_on_chunk_last": lambda: _two(3077),
    "crossing_on_chunk_first": lambda: _two(3078),
    "window_straddles_chunks": lambda: (12000, 20000, tape.TapeParams(
        sample_rate=SR, markers=[2014, 4028], section_speeds=[1.0, 0.25, 1.0],
        section_reverse=[False, True, False], tape_age=50)),
    "shorter_than_a_chunk": lambda: (3000, 500, tape.TapeParams(
        sample_rate=SR, markers=[100, 300], section_speeds=[2.0, 0.25, 1.0],
        section_reverse=[False, True, False])),
    "a_section_at_speed_0": lambda: _two(4000, speeds=(1.0, 0.0)),
    "speeds_at_the_limit": lambda: (16000, 3000, tape.TapeParams(
        sample_rate=SR, markers=[2000, 2100, 6000, 6100, 12000, 12100],
        section_speeds=[tape.MAX_SPEED, 1.0] * 3 + [tape.MAX_SPEED],
        section_reverse=[False, False, True, True, False, True, False],
        tape_age=100)),
    "more_speeds_than_the_table": _many_speeds,
    "dense_markers_past_capacity": _dense,
}


def _program(name: str, device="cpu"):
    n, T, p = PROGRAMS[name]()
    return tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                   device=device)


def _args(prog) -> tuple:
    return (prog["num_frames"], int(prog["audio"].shape[0]),
            prog["mod_consts"], prog["starts"], prog["ends"],
            prog["speeds_q"], prog["reverse"], prog["boundaries"])


def _cxx(prog) -> dict:
    return native_rt.tape_tables(*_args(prog), len(prog["splice_env"]),
                                 prog["consts"])


def _plain(prog, chunk=kernels.TAPE_SCAN_CHUNK, **kw):
    return varispeed.tape_tables_plain(*_args(prog), len(prog["splice_env"]),
                                       prog["consts"], chunk=chunk, **kw)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in NAMES:
        assert got[k].dtype == want[k].dtype == np.int32, k
        assert np.array_equal(got[k], want[k]), (k, got[k][:8], want[k][:8])
    assert got["final"] == want["final"]


@pytest.fixture(autouse=True)
def _tracer_off():
    prof.disable()
    prof.reset()
    yield
    prof.disable()
    prof.reset()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plain_twin_bit_equal_to_the_cxx_walk(name, chunk):
    prog = _program(name)
    got, walk = _plain(prog, chunk)
    _assert_same(got, _cxx(prog))
    nchunks = -(-prog["num_frames"] // chunk)
    assert walk["chunks_walked"] + walk["chunks_jumped"] == nchunks
    assert walk["launches"] == (2 if name.startswith("dense") else 1)


def test_the_programs_reach_their_edges():
    """Each edge case is what its name says, in the C++ walk's tables."""
    def starts(name):
        return _cxx(_program(name))["visit_start"]
    assert starts("crossing_on_chunk_last")[1] % 256 == 0
    assert (starts("crossing_on_chunk_first")[1] - 1) % 256 == 0
    prog = _program("window_straddles_chunks")
    tabs = _cxx(prog)
    T, n = prog["num_frames"], int(prog["audio"].shape[0])
    idx0 = native_rt.tape_trajectory(
        T, n, tape.wow_flutter_mod(T, SR, 50), prog["starts"], prog["ends"],
        prog["speeds_q"], prog["reverse"], prog["boundaries"],
        prog["splice_env"], prog["consts"], 0, 0)["idx0"]
    runs = []
    for t in tabs["triggers"]:
        j = t
        while j + 1 < T and idx0[j + 1] == idx0[t]:
            j += 1
        runs.append((t // 32, j // 32))
    assert any(a != b for a, b in runs), runs
    assert _program("shorter_than_a_chunk")["num_frames"] < 1024
    assert len(set(_program("more_speeds_than_the_table")["speeds_q"])) > 16
    dense = _cxx(_program("dense_markers_past_capacity"))
    assert len(dense["visit_start"]) > varispeed.TABLES_CAP
    b = set(_program("boundaries_0_1_n")["boundaries"].tolist())
    assert {0, 1, 9999, 10000} <= b


def _emulated_kernel(calls: list):
    """``kernels.tape_tables`` stood in for on the CPU: the twin's walk
    at the launch's capacity, written in the kernel's output layout."""
    def fake(packed, S, B, R, T, n, E, splice_on, s_init, ints, flts,
             coeffs, chunk, cap):
        calls.append(cap)
        x = packed.numpy()
        starts, ends = x[:S], x[S:2 * S]
        rev, bnd = x[2 * S:3 * S] != 0, x[4 * S:4 * S + B]
        speeds = x[4 * S + B:4 * S + B + R].view(np.float32)[x[3 * S:4 * S]]
        mod = varispeed._wow_flutter_device(T, ints, flts[:4], flts[4:6],
                                            "cpu")
        tabs, counts, overflow, final, walk = varispeed._plain_walk(
            T, n, mod, [int(v) for v in starts], [int(v) for v in ends],
            rev, [int(v) for v in bnd], varispeed._speed_rows(speeds), E,
            splice_on, s_init, chunk, cap)
        head = np.zeros(kernels.TAPE_TABLES_HEAD, np.int32)
        head[:4] = (*counts, overflow)
        head[4:14] = np.asarray(final, np.int64).view(np.int32)
        head[14:16] = walk["chunks_walked"], walk["chunks_jumped"]
        out = np.zeros(kernels.TAPE_TABLES_HEAD + 8 * cap, np.int32)
        packed_recs = np.concatenate([head] + [np.asarray(t, np.int32)
                                               for t in tabs])
        out[:packed_recs.size] = packed_recs
        return torch.from_numpy(out)
    return fake


@pytest.mark.parametrize("name", ["config1_smoke", "splice_off",
                                  "dense_markers_past_capacity"])
def test_the_card_path_unpacks_what_the_kernel_writes(monkeypatch, name):
    calls = []
    monkeypatch.setattr(kernels, "tape_tables", _emulated_kernel(calls))
    prog = _program(name)
    tables, tab, walk = varispeed.tape_tables_on_card(
        *_args(prog), prog["splice_env"], prog["consts"], "cpu")
    _assert_same(tables, _cxx(prog))
    twin = _plain(prog)[1]
    assert walk == twin
    assert len(calls) == walk["launches"]
    if name.startswith("dense"):        # ran again with room, pulled twice
        assert calls[0] == varispeed.TABLES_CAP < calls[1]
    for k in NAMES:
        assert tab[k].dtype == torch.int32
        assert np.array_equal(tab[k].numpy(), tables[k]), k
    assert torch.equal(tab["starts"], torch.as_tensor(prog["starts"]))
    assert torch.equal(tab["ends"], torch.as_tensor(prog["ends"]))
    assert torch.equal(tab["reverse"], torch.as_tensor(prog["reverse"]))
    assert torch.equal(tab["splice_env"],
                       torch.as_tensor(prog["splice_env"]))


def _spans():
    return [r.attrs for r in prof.records() if r.name == "tape.tables"]


def test_cpu_tapes_keep_the_cxx_walk(monkeypatch):
    monkeypatch.setattr(kernels, "tape_tables", None)
    prof.enable()
    prog = _program("config1_smoke")
    tables = tape.program_tables(prog)
    _assert_same(tables, _cxx(prog))
    tab = prog["_device_tables"]         # the C++ tables, copied with it
    assert tape.device_tables(prog) is tab
    for k in NAMES:
        assert tab[k].device.type == "cpu" and tab[k].dtype == torch.int32
        assert np.array_equal(tab[k].numpy(), tables[k]), k
    (attrs,) = _spans()
    assert attrs["on_card"] == 0 and attrs["hit"] is False
    assert attrs["chunks_walked"] == attrs["chunks_jumped"] == 0
    assert (attrs["visits"], attrs["runs"], attrs["triggers"]) == (7, 7, 4)


class _Launched(Exception):
    pass


def _launch_raises(*args, **kwargs):
    raise _Launched


@pytest.mark.parametrize("splice", [True, False])
def test_off_the_cpu_with_inertia_on_the_cxx_walk_stays(monkeypatch, splice):
    monkeypatch.setattr(kernels, "tape_tables", _launch_raises)
    n, T, p = PROGRAMS["splice_off"]()
    p.inertia_enabled, p.enable_splice_fx = True, splice
    prof.enable()
    prog = tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                   device="meta")
    _assert_same(tape.program_tables(prog), _cxx(prog))
    assert [a["on_card"] for a in _spans()] == [0]
    assert prog["_device_tables"]["visit_start"].device.type == "meta"


@pytest.mark.parametrize("section, speed", [
    (1, 200.0), (1, -129.0), (0, float("nan")), (2, float("inf")),
    (None, 130.0)])
def test_speeds_past_the_fixed_point_are_refused(section, speed):
    """The walks' increment rint(speed * mod * 2**22) is an int32: a
    program with a faster (or no finite) speed raises, on every device,
    before anything walks."""
    n, T, p = PROGRAMS["splice_off"]()
    if section is None:
        p.current_speed = speed
    else:
        p.section_speeds[section] = speed
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="at most 128"):
            tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                    device=device)
    p.section_speeds[1 if section is None else section] = tape.MAX_SPEED
    p.current_speed = -tape.MAX_SPEED
    prog = tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                   device="cpu")
    _assert_same(tape.program_tables(prog), _cxx(prog))


def test_off_the_cpu_with_inertia_off_the_kernel_walks(monkeypatch):
    monkeypatch.setattr(kernels, "tape_tables", _launch_raises)
    prog = _program("splice_off", device="meta")
    with pytest.raises(_Launched):
        tape.program_tables(prog)
    assert "_tables" not in prog


def test_a_program_that_carries_its_tables_walks_nothing(monkeypatch):
    monkeypatch.setattr(kernels, "tape_tables", _launch_raises)
    prog = _program("splice_off", device="meta")
    prog["_tables"] = tables = _cxx(prog)
    prof.enable()
    assert tape.program_tables(prog) is tables
    (attrs,) = _spans()
    assert attrs["hit"] is True and attrs["on_card"] == 0


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: tape_scan.cu is built with nvcc "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _on_card(prog, device, chunk=kernels.TAPE_SCAN_CHUNK):
    return varispeed.tape_tables_on_card(
        *_args(prog), prog["splice_env"], prog["consts"], device,
        chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_tables_bit_equal_to_the_cxx_walk_and_the_twin(cuda, name,
                                                              chunk):
    prog = _program(name)
    n0 = kernels.tape_tables.launches
    tables, tab, walk = _on_card(prog, cuda, chunk)
    torch.cuda.synchronize()
    _assert_same(tables, _cxx(prog))
    assert walk == _plain(prog, chunk)[1]
    assert kernels.tape_tables.launches == n0 + walk["launches"]
    for k in NAMES:
        assert tab[k].device == cuda
        assert np.array_equal(tab[k].cpu().numpy(), tables[k]), k


def _tweaks(count: int, seed: int):
    """Config 1 at full size under the cell's traffic
    (``chip_smoke.tables_draws``): (n, T, params)."""
    for p, T in chip_smoke.tables_draws(count, seed):
        yield int(SR * chip_smoke.TAPE_SECONDS), T, p


@pytest.mark.cuda
def test_kernel_tables_at_full_config1_over_traffic_draws(cuda):
    for n, T, p in _tweaks(6, 2026):
        prog = tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                       device="cpu")
        tables, _, walk = _on_card(prog, cuda)
        _assert_same(tables, _cxx(prog))
        assert walk["chunks_walked"] + walk["chunks_jumped"] == -(-T // 1024)
        assert walk["chunks_jumped"] > 0.99 * -(-T // 1024)


@pytest.mark.cuda
def test_device_engine_pcm16_same_as_with_the_cxx_tables(cuda):
    audio = torch.as_tensor(chip_smoke.bench_audio(SR, 180.0), device=cuda)
    for n, T, p in _tweaks(6, 11):
        tape._TAPE_PROG_CACHE.clear()
        got = tape.render_tape(audio, p, T, device=cuda, pcm16=True)
        prog = tape.build_tape_program(audio, p, T, device=cuda)
        prog["_tables"] = _cxx(prog)         # the C++ tables, uploaded
        want, _ = tape.tape_table_render(prog, out_i16=True)
        assert got.dtype == want.dtype == np.int16
        assert np.array_equal(got, want)
    tape._TAPE_PROG_CACHE.clear()


@pytest.mark.cuda
def test_the_tables_span_reports_the_card_walk(cuda):
    n, T, p = next(_tweaks(1, 5))
    prog = tape.build_tape_program(np.zeros(n, np.float32), p, T,
                                   device=cuda)
    prof.enable()
    tables = tape.program_tables(prog)
    tab = tape.device_tables(prog)
    (attrs,) = _spans()
    assert attrs["on_card"] == 1 and attrs["hit"] is False
    assert attrs["chunks_walked"] + attrs["chunks_jumped"] == -(-T // 1024)
    assert attrs["visits"] == len(tables["visit_start"])
    assert tab is prog["_device_tables"]
    assert tab["visit_start"].device == cuda

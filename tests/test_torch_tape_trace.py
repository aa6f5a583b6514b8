"""The rest of the port's tape engine held against the JAX package on the
CPU: the performance renderer, the segment engine and the scan engine.

Same inputs, made with numpy from a seed, through both packages:

- the host control path: the NumPy ``tape_tables`` copy (with its raw
  boundary ``hits``, from nonzero initial positions, with inertia) and
  both ``tape_trajectory``s (NumPy and the C++ binding) bit-equal to the
  JAX package's NumPy and C++ functions;
- ``lfo_phase_cycles``, ``wow_flutter_mod`` and
  ``wow_flutter_consts(phase0_cycles=)`` bit-equal; ``detect_beats``
  equal on ``tests/test_tape.py``'s clicks; the ``UndoStack`` round
  trip; ``apply_trace_op`` op by op; ``TapeTrace`` and its JSON;
- the trace renderer on every case of ``tests/test_tape_trace.py``:
  the segment programs and the splice pieces equal to JAX's, the render
  within -120 dBFS of JAX's ``render_tape_trace`` and of the oracle
  ``render_tape_np`` on the port's own segments, ``return_state`` equal,
  and an empty trace bit-equal to ``render_tape``;
- the segment engine and the scan engine's plain version within -120
  dBFS of JAX's, with equal final states (the scan at <= 4 000 frames:
  its plain version is a per-sample loop).

Each JAX reference is computed once per module (``jax_ref``): XLA
compiles a render per static configuration, and those compiles are most
of this file's time.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import tape as jt
from audio_suite_tpu.ops import varispeed as jv
from audio_suite_tpu.utils import native_rt as jnrt
from audio_suite_torch.models import tape as tt
from audio_suite_torch.ops import varispeed as tv
from audio_suite_torch.utils import io as t_io
from audio_suite_torch.utils import native_rt as tnrt
from oracles.tape_ref import render_tape_np

torch.set_num_threads(1)

SR = 8000                   # tests/test_tape_trace.py's rate
TOL_DBFS = -120.0           # the JAX package's own engine-parity bound
SCAN_FRAMES = 4000          # the scan's plain loop: keep it short


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _dbfs(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return 20.0 * np.log10(max(np.max(np.abs(got - ref)), 1e-300))


def _params(mod, **kw):
    return mod.TapeParams(**kw)


# ---------------------------------------------------------------------------
# The cases of tests/test_tape_trace.py, for either package
# ---------------------------------------------------------------------------

def _tape(n=SR * 2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 180 * t)
         + 0.2 * np.sin(2 * np.pi * 733 * t)
         + 0.05 * rng.standard_normal(n))
    return np.asarray(x, np.float32)


def _perf_trace(mod):
    """A dense performance touching every op family."""
    tr = mod.TapeTrace()
    tr.add(0.20, "set_speed", section=0, value=1.7)
    tr.add(0.45, "set_reverse", section=1, value=True)
    tr.add(0.70, "set_age", value=95)
    tr.add(0.90, "add_marker", sample=SR // 2)
    tr.add(1.10, "set_inertia", value=True)
    tr.add(1.15, "set_inertia_amount", value=80)
    tr.add(1.40, "set_splice", value=False)
    tr.add(1.55, "set_splice", value=True)
    tr.add(1.80, "seek", sample=100)
    tr.add(2.05, "set_anticlick_amount", value=90)
    tr.add(2.30, "remove_marker", sample=SR // 2)
    tr.add(2.60, "retime", target=1.2)
    return tr


def _splice_trace(mod):
    tr = mod.TapeTrace()
    tr.add(100 / SR, "set_splice", value=False)
    tr.add(160 / SR, "set_splice", value=True)
    return tr


def _speed_trace(mod):
    tr = mod.TapeTrace()
    tr.add(0.3, "set_speed", section=0, value=3.0)
    return tr


# name -> (tape, params kwargs, trace builder, frames)
CASES = {
    "parity": (_tape(), dict(sample_rate=SR, markers=[3000, 9000],
                             section_speeds=[1.0, 0.5, 2.0],
                             section_reverse=[False, False, True],
                             tape_age=40, inertia_enabled=False,
                             current_speed=1.0),
               _perf_trace, SR * 3),
    "splice_freeze": (_tape(n=SR), dict(sample_rate=SR, markers=[SR // 2],
                                        section_speeds=[1.0, 1.0],
                                        tape_age=0,
                                        anticlick_enabled=False),
                      _splice_trace, 600),
    "json": (_tape(n=SR), dict(sample_rate=SR, markers=[2000],
                               section_speeds=[1.3, 0.7]),
             _perf_trace, SR),
    "speed_carry": (_tape(n=SR), dict(sample_rate=SR, inertia_enabled=True,
                                      inertia_amount=70, current_speed=2.0,
                                      markers=[4000],
                                      section_speeds=[0.5, 1.0]),
                    _speed_trace, SR),
    "empty": (_tape(n=SR), dict(sample_rate=SR, markers=[2500],
                                section_speeds=[1.0, 1.25],
                                section_reverse=[False, True], tape_age=60),
              lambda mod: mod.TapeTrace(), SR),
}


class _JaxRefs:
    """JAX's renders, each computed once for the module."""

    def __init__(self):
        self._memo = {}

    def get(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def trace(self, name):
        audio, kw, tr, nf = CASES[name]
        return self.get(("trace", name), lambda: jt.render_tape_trace(
            audio, _params(jt, **kw), tr(jt), num_frames=nf,
            return_state=True))


@pytest.fixture(scope="module")
def jax_ref():
    return _JaxRefs()


def _port_trace(name, **kw):
    audio, pkw, tr, nf = CASES[name]
    return tt.render_tape_trace(audio, _params(tt, **pkw), tr(tt),
                                num_frames=nf, device="cpu", **kw)


def _state_equal(st_t, st_j):
    assert dataclasses.asdict(st_t["params"]) \
        == dataclasses.asdict(st_j["params"])
    assert (st_t["whole"], st_t["frac"]) == (st_j["whole"], st_j["frac"])
    assert np.float32(st_t["speed"]) == np.float32(st_j["speed"])


def _oracle(segs):
    """The NumPy oracle over segment programs with the carried position
    and splice state (tests/test_tape_trace.py:_oracle_trace_render)."""
    rem, sidx = 0, 0
    outs = []
    for s in segs:
        prog = dict(s, audio=np.asarray(s["audio"]))
        out, st = render_tape_np(
            prog, init={"whole": s["init_whole"], "frac": s["init_frac"],
                        "rem": rem, "sidx": sidx}, return_state=True)
        rem, sidx = st["rem"], st["sidx"]
        outs.append(out)
    return np.concatenate(outs)


# ---------------------------------------------------------------------------
# Host: the control tables and trajectories
# ---------------------------------------------------------------------------

def _host_case(name):
    """(n, mod_q, section program, consts, init) of a host case: the
    golden tape's sections with inertia from a carried speed, and a
    chopped tape with splice, anti-click and a reverse section, each from
    a position inside the tape."""
    n = 30011
    if name == "inertia":
        p = tt.TapeParams(sample_rate=SR, markers=[6000, 11000],
                          section_speeds=[1.0, 2.0, 0.5],
                          section_reverse=[False, True, False],
                          tape_age=70, inertia_enabled=True,
                          inertia_amount=50, current_speed=3.1)
        init, T = (7777, 1234567), 20000
    else:
        p = tt.TapeParams(sample_rate=SR, markers=[4000, 9000, 13000],
                          section_speeds=[0.7, 1.4, 2.2, 0.9],
                          section_reverse=[True, False, False, True],
                          tape_age=30, enable_splice_fx=True,
                          anticlick_enabled=True)
        init, T = (12999, 4194303), 18000
    prog = tt._section_program(p, n, p.current_speed)
    mod_q = tt.wow_flutter_mod(T, SR, p.tape_age,
                               phase0_cycles=tt.lfo_phase_cycles(SR, 4321))
    return n, mod_q, prog, init


_HOST_CASES = ["inertia", "splice"]


def _prog_args(prog):
    return (prog["starts"], prog["ends"], prog["speeds_q"], prog["reverse"],
            prog["boundaries"])


@pytest.mark.parametrize("name", _HOST_CASES)
@pytest.mark.parametrize("from_start", [True, False],
                         ids=["start", "inside"])
def test_tape_tables_np_bit_equal(name, from_start):
    n, mod_q, prog, init = _host_case(name)
    init = (0, 0) if from_start else init
    args = (n, mod_q) + _prog_args(prog) + (len(prog["splice_env"]),
                                            prog["consts"])
    got = tv.tape_tables(*args, init_whole=init[0], init_frac=init[1])
    want = jv.tape_tables(*args, init_whole=init[0], init_frac=init[1])
    assert got.keys() == want.keys()
    assert got["final"] == want["final"]
    for k, v in want.items():
        if k != "final":
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    if from_start:                   # the C++ tables (which carry no hits)
        assert len(got["hits"]) > 0
        c = tnrt.tape_tables(len(mod_q), n, tt.wow_flutter_consts(
            SR, 70 if name == "inertia" else 30,
            phase0_cycles=tt.lfo_phase_cycles(SR, 4321)),
            *_prog_args(prog), len(prog["splice_env"]), prog["consts"])
        assert c["final"] == got["final"]
        for k, v in c.items():
            if k != "final":
                assert np.array_equal(v, got[k]), k


@pytest.mark.parametrize("name", _HOST_CASES)
def test_tape_trajectory_bit_equal(name):
    n, mod_q, prog, init = _host_case(name)
    args = _prog_args(prog)
    env = prog["splice_env"]
    got_np = tv.tape_trajectory(n, mod_q, *args, len(env), prog["consts"],
                                init_whole=init[0], init_frac=init[1])
    want_np = jv.tape_trajectory(n, mod_q, *args, len(env), prog["consts"],
                                 init_whole=init[0], init_frac=init[1])
    got_c = tnrt.tape_trajectory(len(mod_q), n, mod_q, *args, env,
                                 prog["consts"], *init)
    want_c = jnrt.tape_trajectory(len(mod_q), n, mod_q, *args, env,
                                  prog["consts"], *init)
    for got in (got_np, got_c):
        for want in (want_np, want_c):
            assert got["final"] == want["final"]
            for k in ("idx0", "fr", "ga", "gs"):
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(_bits(got[k]) if k != "idx0"
                                      else got[k],
                                      _bits(want[k]) if k != "idx0"
                                      else want[k]), k
    assert (got_np["ga"] < 1).any() or (got_np["gs"] > 1).any()


def test_native_trajectory_checks_its_length():
    n, mod_q, prog, init = _host_case("splice")
    with pytest.raises(ValueError, match="mod values"):
        tnrt.tape_trajectory(len(mod_q) + 1, n, mod_q, *_prog_args(prog),
                             prog["splice_env"], prog["consts"], *init)


@pytest.mark.parametrize("sr", [8000, 44100, 48000, 192000])
def test_lfo_phase_cycles_bit_equal(sr):
    for off in (0, 1, 8000, 12345, 2 ** 24 + 3, 2 ** 31 + 7, 2 ** 32 + 5,
                10 ** 12 + 17):
        got = tt.lfo_phase_cycles(sr, off)
        want = jt.lfo_phase_cycles(sr, off)
        assert all(type(g) is np.float32 for g in got)
        assert _bits(got).tolist() == _bits(want).tolist(), off


@pytest.mark.parametrize("phases", [None, "cycles", "radians"])
def test_wow_flutter_mod_and_consts_bit_equal(phases):
    kw = {}
    if phases == "cycles":
        kw = dict(phase0_cycles=jt.lfo_phase_cycles(SR, 2 ** 31 + 99))
    elif phases == "radians":
        kw = dict(wow_phase0=1.25, flutter_phase0=-2.5)
    for age in (0, 40, 95, 100):
        got = tt.wow_flutter_mod(50000, SR, age, **kw)
        want = jt.wow_flutter_mod(50000, SR, age, **kw)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(_bits(got), _bits(want))
        for a, b in zip(tt.wow_flutter_consts(SR, age, **kw),
                        jt.wow_flutter_consts(SR, age, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("sensitivity", [0, 50, 100])
def test_detect_beats_equal(sensitivity):
    """tests/test_tape.py:113's clicks, and the same over noise."""
    sr = 48000
    x = np.zeros(sr * 2, np.float32)
    for k in range(1, 8):
        p = int(k * 0.25 * sr)
        x[p:p + 32] = 1.0
    noisy = x + 0.01 * np.random.default_rng(sensitivity).standard_normal(
        x.size).astype(np.float32)
    for sig in (x, noisy, x[:1000], np.zeros(5000, np.float32)):
        got = tt.detect_beats(sig, sr, sensitivity=sensitivity)
        assert got == jt.detect_beats(sig, sr, sensitivity=sensitivity)
    assert len(tt.detect_beats(x, sr, sensitivity)) >= 4


def test_undo_stack_round_trip():
    p = tt.TapeParams(markers=[100], section_speeds=[1.0, 2.0],
                      section_reverse=[False, True])
    assert p.snapshot() == jt.TapeParams(
        markers=[100], section_speeds=[1.0, 2.0],
        section_reverse=[False, True]).snapshot()
    assert tt.TapeParams.from_snapshot(p.snapshot()) == p
    undo = tt.UndoStack(depth=3)
    assert undo.pop() is None and len(undo) == 0
    snaps = []
    for k in range(5):
        q = tt.TapeParams(markers=[100 * (k + 1)], tape_age=k)
        snaps.append(q)
        undo.push(q)
    assert len(undo) == 3                     # the two oldest fell off
    for q in reversed(snaps[2:]):
        got = undo.pop()
        assert got == q and got is not q
    assert undo.pop() is None


def _op_sequence():
    """Events covering every op, clamps and no-ops included."""
    return [
        {"op": "set_speed", "section": 0, "value": 1.7},
        {"op": "set_speed", "section": 4, "value": 9.0},
        {"op": "set_reverse", "section": 6, "value": True},
        {"op": "add_marker", "sample": 3000},
        {"op": "add_marker", "sample": 3000},
        {"op": "add_marker", "sample": 0},
        {"op": "add_marker", "sample": 10 ** 9},
        {"op": "remove_marker", "sample": 1234},
        {"op": "remove_marker", "sample": 3000},
        {"op": "set_markers", "markers": [7000, 100, -5, 2 ** 40, 4000]},
        {"op": "set_age", "value": 140},
        {"op": "set_age", "value": 33.7},
        {"op": "set_splice", "value": 0},
        {"op": "set_anticlick", "value": False},
        {"op": "set_anticlick_amount", "value": -3},
        {"op": "set_inertia", "value": True},
        {"op": "set_inertia_amount", "value": 80.6},
        {"op": "retime", "target": 1.2},
        {"op": "retime", "target": 0.0},
        {"op": "seek", "sample": 100},
        {"op": "set_speed", "section": 1, "value": 0.01},
    ]


def test_apply_trace_op_matches_jax():
    pt = tt.TapeParams(sample_rate=SR, markers=[2000, 5000],
                       section_speeds=[1.0, 0.5], tape_age=40)
    pj = jt.TapeParams(**dataclasses.asdict(pt))
    for ev in _op_sequence():
        pt2 = tt.apply_trace_op(pt, ev, 16000)
        pj = jt.apply_trace_op(pj, ev, 16000)
        assert pt2 is not pt
        assert dataclasses.asdict(pt2) == dataclasses.asdict(pj), ev
        pt = pt2
    with pytest.raises(ValueError, match="unknown trace op"):
        tt.apply_trace_op(pt, {"op": "warp"}, 16000)


def test_trace_ops_and_events_match_jax(tmp_path):
    assert tt.TRACE_OPS == jt.TRACE_OPS
    for bad in (lambda m: m.TapeTrace().add(0.1, "warp"),
                lambda m: m.TapeTrace().add(0.2, "set_speed", value=1.0)):
        with pytest.raises(ValueError) as et:
            bad(tt)
        with pytest.raises(ValueError) as ej:
            bad(jt)
        assert str(et.value) == str(ej.value)
    tr = _perf_trace(tt)
    assert tr.events == _perf_trace(jt).events
    assert tr.to_json() == _perf_trace(jt).to_json()
    path = str(tmp_path / "perf.json")
    tr.save(path)
    assert tt.TapeTrace.load(path).events == tr.events
    assert jt.TapeTrace.load(path).events == tr.events


# ---------------------------------------------------------------------------
# The trace renderer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_programs_equal(name):
    audio, kw, tr, nf = CASES[name]
    segs_t = tt.build_trace_programs(audio, _params(tt, **kw), tr(tt), nf,
                                     device="cpu")
    segs_j = jt.build_trace_programs(audio, _params(jt, **kw), tr(jt), nf)
    assert len(segs_t) == len(segs_j) >= 1
    for st, sj in zip(segs_t, segs_j):
        for k in ("t0", "t1", "num_frames", "sample_rate", "tape_age",
                  "init_whole", "init_frac"):
            assert st[k] == sj[k], k
        for k in ("mod_q", "starts", "ends", "speeds_q", "reverse",
                  "boundaries", "splice_env", "hits"):
            assert st[k].dtype == sj[k].dtype, k
            assert np.array_equal(st[k], sj[k]), k
        for a, b in zip(st["mod_consts"], sj["mod_consts"]):
            assert np.array_equal(a, b)
        assert dataclasses.asdict(st["consts"]) \
            == dataclasses.asdict(sj["consts"])
        assert dataclasses.asdict(st["params"]) \
            == dataclasses.asdict(sj["params"])
        assert st["_tables"] is st["tables"]
        for k, v in sj["tables"].items():
            if k == "final":
                assert st["tables"][k] == v
            else:
                assert np.array_equal(st["tables"][k], v), k
        assert st["audio"] is segs_t[0]["audio"]      # one copy of the tape
    env_len = kw.get("splice_env_len", 256)
    assert tt._splice_pieces(segs_t, env_len) \
        == jt._splice_pieces(segs_j, env_len)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_render_matches_jax_and_oracle(name, jax_ref):
    audio, kw, tr, nf = CASES[name]
    y, st = _port_trace(name, return_state=True)
    yj, stj = jax_ref.trace(name)
    assert y.shape == (nf,) and y.dtype == np.float32
    dev = _dbfs(yj, y)
    segs = tt.build_trace_programs(audio, _params(tt, **kw), tr(tt), nf,
                                   device="cpu")
    dev_oracle = _dbfs(_oracle(segs), y)
    print(f"trace {name}: vs JAX {dev:.2f} dBFS, vs the oracle "
          f"{dev_oracle:.2f} dBFS")
    assert dev <= TOL_DBFS and dev_oracle <= TOL_DBFS
    _state_equal(st, stj)
    assert np.isfinite(y).all() and np.abs(y).max() > 0.05


def test_trace_splice_freeze_takes_the_piece_path(monkeypatch):
    """The splice-off gap pauses an envelope and the next segment resumes
    it mid-decay: a partial piece, rendered on the piece path, and the
    samples after the gap differ from a render without splice FX
    (tests/test_tape_trace.py:111-145)."""
    audio, kw, tr, nf = CASES["splice_freeze"]
    segs = tt.build_trace_programs(audio, _params(tt, **kw), tr(tt), nf,
                                   device="cpu")
    pieces = tt._splice_pieces(segs, 256)
    assert any(off > 0 for (_t, off, _ln) in pieces)
    calls = []
    real = tv.tape_device_render

    def spy(*a, **k):
        calls.append(k.get("with_pieces", False))
        return real(*a, **k)
    monkeypatch.setattr(tv, "tape_device_render", spy)
    got = _port_trace("splice_freeze")
    assert True in calls
    base = tt.render_tape_trace(
        audio, _params(tt, **dict(kw, enable_splice_fx=False)),
        tt.TapeTrace(), num_frames=nf, device="cpu")
    assert np.max(np.abs(got[160:240] - base[160:240])) > 0


def test_trace_json_round_trip_renders_the_same():
    tr = _perf_trace(tt)
    tr2 = tt.TapeTrace.from_json(tr.to_json())
    assert tr2.events == tr.events
    audio, kw, _, nf = CASES["json"]
    a = tt.render_tape_trace(audio, _params(tt, **kw), tr, num_frames=nf,
                             device="cpu")
    b = tt.render_tape_trace(audio, _params(tt, **kw), tr2, num_frames=nf,
                             device="cpu")
    np.testing.assert_array_equal(a, b)


def test_trace_record_reload_midtrace(tmp_path, jax_ref):
    """Record the first part of a performance, reload the recording as the
    new tape and perform on it (tests/test_tape_trace.py:167-192); each
    part within -120 dBFS of JAX's, the state carried equal."""
    audio = _tape(n=SR)
    kw = dict(sample_rate=SR, markers=[3000], section_speeds=[1.0, 1.5])

    def part_a(mod):
        tr = mod.TapeTrace()
        tr.add(0.25, "set_speed", section=1, value=0.5)
        return tr

    out_a, st = tt.render_tape_trace(audio, _params(tt, **kw), part_a(tt),
                                     num_frames=SR, return_state=True,
                                     device="cpu")
    out_aj, stj = jax_ref.get(("reload", "a"), lambda: jt.render_tape_trace(
        audio, _params(jt, **kw), part_a(jt), num_frames=SR,
        return_state=True))
    assert _dbfs(out_aj, out_a) <= TOL_DBFS
    _state_equal(st, stj)
    wav = str(tmp_path / "rec.wav")
    t_io.write_wav(wav, out_a, SR, subtype="PCM_16")
    tape2, sr2 = t_io.load_wav_mono(wav)
    assert sr2 == SR and len(tape2) == len(out_a)

    def part_b(mod):
        tr = mod.TapeTrace()
        tr.add(0.10, "set_reverse", section=0, value=True)
        return tr

    out_b = tt.render_tape_trace(tape2, tt.TapeParams(sample_rate=SR),
                                 part_b(tt), num_frames=SR // 2,
                                 device="cpu")
    out_bj = jax_ref.get(("reload", "b"), lambda: jt.render_tape_trace(
        tape2, jt.TapeParams(sample_rate=SR), part_b(jt),
        num_frames=SR // 2))
    assert out_b.shape == (SR // 2,)
    assert _dbfs(out_bj, out_b) <= TOL_DBFS
    assert np.isfinite(out_b).all() and np.max(np.abs(out_b)) > 0.01


def test_trace_speed_carry_is_engine_final(jax_ref):
    _, st = _port_trace("speed_carry", return_state=True)
    _, stj = jax_ref.trace("speed_carry")
    assert st["speed"] == stj["speed"]
    assert float(tt.fixq.quantize_f32_np(np.float32(st["speed"]))) \
        == st["speed"]


def test_trace_empty_is_plain_render(jax_ref):
    audio, kw, _, nf = CASES["empty"]
    a = tt.render_tape_trace(audio, _params(tt, **kw), tt.TapeTrace(),
                             num_frames=nf, device="cpu")
    b = tt.render_tape(audio, _params(tt, **kw), num_frames=nf,
                       device="cpu")
    np.testing.assert_array_equal(a, b)
    assert _dbfs(jax_ref.trace("empty")[0], a) <= TOL_DBFS


def test_trace_accepts_a_tape_already_on_the_device():
    audio, kw, tr, nf = CASES["json"]
    t_audio = torch.from_numpy(audio)
    segs = tt.build_trace_programs(t_audio, _params(tt, **kw), tr(tt), nf,
                                   device="cpu")
    assert all(s["audio"] is t_audio for s in segs)
    np.testing.assert_array_equal(
        tt.render_tape_trace(t_audio, _params(tt, **kw), tr(tt),
                             num_frames=nf, device="cpu"),
        _port_trace("json"))


def test_piece_path_needs_its_offsets_and_lengths():
    audio, kw, _, nf = CASES["empty"]
    prog = tt.build_tape_program(audio, _params(tt, **kw), nf, device="cpu")
    with pytest.raises(ValueError, match="splice_off"):
        tv.tape_device_render(prog["audio"], tt.device_tables(prog),
                              prog["consts"], nf, with_pieces=True)


# ---------------------------------------------------------------------------
# The segment and scan engines
# ---------------------------------------------------------------------------

def _engine_audio():
    """tests/test_tape.py:make_test_audio (48 kHz, 1.5 s)."""
    rng = np.random.default_rng(7)
    t = np.arange(int(48000 * 1.5)) / 48000
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _engine_params(mod, name, n):
    """tests/test_tape.py's engine cases."""
    if name == "full":
        return mod.TapeParams(
            markers=[n // 5, n // 2, (3 * n) // 4],
            section_speeds=[1.0, 2.7, 0.31, 3.9],
            section_reverse=[False, True, False, True],
            tape_age=85, enable_splice_fx=True, anticlick_enabled=True,
            anticlick_amount=70)
    if name == "inertia":
        return mod.TapeParams(
            markers=[n // 3, (2 * n) // 3],
            section_speeds=[0.5, 3.5, 1.0],
            section_reverse=[False, False, True],
            inertia_enabled=True, inertia_amount=80, current_speed=2.0,
            tape_age=30)
    if name == "inertia_strong":
        return mod.TapeParams(
            markers=[n // 2], section_speeds=[4.0, 0.25],
            section_reverse=[False, False], inertia_enabled=True,
            inertia_amount=100, current_speed=0.25, enable_splice_fx=True,
            anticlick_enabled=True)
    # a short tape that the scan wraps around within its frames, reversed
    # and with every gain on
    return mod.TapeParams(
        markers=[n // 3], section_speeds=[3.7, 2.9],
        section_reverse=[True, False], inertia_enabled=True,
        inertia_amount=20, current_speed=0.5, tape_age=100,
        enable_splice_fx=True, anticlick_enabled=True,
        boundary_smooth_len=40, splice_env_len=64)


_ENGINE_CASES = ["full", "inertia", "inertia_strong", "wrap"]


def _engine_programs(name):
    audio = _engine_audio()
    if name == "wrap":
        audio = audio[:1777]
    n = len(audio)
    frames = {"full": 70000, "inertia": 70000, "inertia_strong": 100000,
              "wrap": SCAN_FRAMES}[name]
    pj = _engine_params(jt, name, n)
    pt = _engine_params(tt, name, n)
    progj = jt.build_tape_program(audio, pj, frames)
    progt = tt.build_tape_program(audio, pt, frames, device="cpu")
    progt["mod_q"] = tt.wow_flutter_mod(frames, pt.sample_rate, pt.tape_age)
    return audio, progj, progt


def _sec_args(prog):
    return (prog["mod_q"], prog["starts"], prog["ends"], prog["speeds_q"],
            prog["reverse"], prog["boundaries"], prog["splice_env"],
            prog["consts"])


@pytest.mark.parametrize("name", _ENGINE_CASES)
def test_segment_engine_matches_jax(name):
    audio, progj, progt = _engine_programs(name)
    assert np.array_equal(progt["mod_q"], progj["mod_q"])
    got, fin_t = tv.tape_segment_render(progt["audio"], *_sec_args(progt))
    want, fin_j = jv.tape_segment_render(jnp.asarray(audio),
                                         *_sec_args(progj))
    assert got.dtype == torch.float32
    assert fin_t == fin_j
    dev = _dbfs(np.asarray(want), got.numpy())
    print(f"segment engine {name}: {dev:.2f} dBFS from JAX")
    assert dev <= TOL_DBFS
    np.testing.assert_array_equal(
        tt.render_tape(audio, _engine_params(tt, name, len(audio)),
                       progt["num_frames"], engine="segment", device="cpu"),
        got.numpy())


def _scan_state(st):
    return (int(st.whole), int(st.frac), float(np.float32(st.speed)),
            int(st.splice_rem), int(st.splice_idx))


@pytest.mark.parametrize("name", _ENGINE_CASES)
@pytest.mark.parametrize("carried", [False, True], ids=["start", "carried"])
def test_scan_engine_plain_matches_jax(name, carried):
    """The plain scan within -120 dBFS of JAX's ``tape_scan_render`` at
    SCAN_FRAMES frames, the final states equal, from the start of the tape
    and from a carried state inside an envelope."""
    audio, progj, progt = _engine_programs(name)
    T = SCAN_FRAMES
    ins = tt.scan_inputs(progt, progt["mod_q"])
    ins = (ins[0], ins[1][:T]) + ins[2:]
    jargs = [jnp.asarray(audio), jnp.asarray(progj["mod_q"][:T])] + [
        jnp.asarray(progj[k]) for k in ("starts", "ends", "speeds_q",
                                        "reverse", "boundaries",
                                        "splice_env")]
    st_t = st_j = None
    if carried:
        vals = (len(audio) // 2 + 3, 1234567, 1.75, 40, 216 % len(
            progt["splice_env"]))
        st_t = tv.TapeState(*(torch.tensor(v, dtype=torch.float32 if k == 2
                                           else torch.int32)
                              for k, v in enumerate(vals)))
        st_j = jv.TapeState(*(jnp.asarray(v, jnp.float32 if k == 2
                                          else jnp.int32)
                              for k, v in enumerate(vals)))
    got, fin_t = tv.tape_scan_render(*ins, progt["consts"], st_t)
    want, fin_j = jv.tape_scan_render(*jargs, progj["consts"], st_j)
    assert got.dtype == torch.float32 and got.shape == (T,)
    assert fin_t.whole.dtype == torch.int32
    assert fin_t.speed.dtype == torch.float32
    assert _scan_state(fin_t) == _scan_state(fin_j)
    dev = _dbfs(np.asarray(want), got.numpy())
    print(f"scan engine {name} ({'carried' if carried else 'start'}): "
          f"{dev:.2f} dBFS from JAX")
    assert dev <= TOL_DBFS


@pytest.mark.parametrize("name", _ENGINE_CASES)
def test_scan_engine_matches_segment_engine(name):
    """render_tape's scan and segment engines on the CPU agree, and the
    scan's final state is the segment engine's: the position, the speed
    and the envelope's remainder, and its index while one runs (after an
    envelope the scan keeps its index at E, where the host tables write
    0)."""
    audio, _, progt = _engine_programs(name)
    p = _engine_params(tt, name, len(audio))
    a = tt.render_tape(audio, p, SCAN_FRAMES, engine="scan", device="cpu")
    b = tt.render_tape(audio, p, SCAN_FRAMES, engine="segment",
                       device="cpu")
    assert _dbfs(b, a) <= TOL_DBFS
    prog = tt.build_tape_program(audio, p, SCAN_FRAMES, device="cpu")
    prog["mod_q"] = tt.wow_flutter_mod(SCAN_FRAMES, p.sample_rate,
                                       p.tape_age)
    _, fin_s = tv.tape_scan_render(*tt.scan_inputs(prog, prog["mod_q"]),
                                   prog["consts"])
    _, fin_g = tv.tape_segment_render(prog["audio"], *_sec_args(prog))
    fs = _scan_state(fin_s)
    assert fs[:4] == (fin_g["whole"], fin_g["frac"], fin_g["speed"],
                      fin_g["splice_rem"])
    if fs[3] > 0:
        assert fs[4] == fin_g["splice_idx"]


def test_render_tape_rejects_an_unknown_engine():
    audio, kw, _, nf = CASES["empty"]
    with pytest.raises(ValueError, match="engine"):
        tt.render_tape(audio, _params(tt, **kw), nf, engine="fast",
                       device="cpu")


def test_scan_engine_checks_its_tables():
    audio, _, progt = _engine_programs("wrap")
    ins = list(tt.scan_inputs(progt, progt["mod_q"]))
    bad = list(ins)
    bad[2] = bad[2][:0]                         # no section
    with pytest.raises(ValueError, match="length >= 1"):
        tv.tape_scan_render(*bad, progt["consts"])
    bad = list(ins)
    bad[4] = bad[4][:-1]                        # a speed short
    with pytest.raises(ValueError, match="length >= 1"):
        tv.tape_scan_render(*bad, progt["consts"])

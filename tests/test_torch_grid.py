"""The port's Grid Audio mixdown held against the JAX package on the CPU.

Same inputs, made with numpy from a seed, through both packages (the JAX
side jitted, as Tier-1 runs it; the port on ``device="cpu"``):

- envdet: ``exact_sq``, ``_box_sums_direct`` (windows 1, 2, 3, 7, 2 400
  and at least n), ``isqrt30`` and ``mod_speed_fix`` bit-equal to JAX's
  and to the port's NumPy twins, with a hypothesis case over signals with
  silence and near-ties of the max;
- fixq: ``pos_add`` bit-equal to JAX; ``segmented_pos_cumsum`` with tensor
  inits equal to it with int inits, and the tape and scrub renders
  unchanged by the tensor inits;
- positions: ``_track_positions`` bit-equal to JAX's, to
  ``placement_indices_np`` and to the C++ phase accumulator, for loop and
  non-loop (both break rules), resets, modulated and unit speed, negative
  starts (one deeper than the render);
- the mixdown: a project with wav, context and event cells, a two-deep
  mod chain and offsets, bit-equal to JAX's device and host engines in f32
  and PCM16, equal restarts, within -120 dBFS of ``oracles/grid_ref.py``;
  the ``grid``, ``grid_pydiv`` and ``grid_host`` goldens (their user cell
  is ``audio_suite_tpu/plugins/jax_cells.py``, loaded by path: user code
  that runs JAX; the port does not import it) and
  ``examples/grid_showcase.json``, bit-equal to JAX; bench config 5's grid
  half at its smoke size with ``jax`` and the JAX package blocked.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_suite_tpu.models import grid as jg
from audio_suite_tpu.ops import envdet as jenv
from audio_suite_tpu.ops import fixq as jfq
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from audio_suite_torch.models import grid as tg
from audio_suite_torch.models import scrub as ts
from audio_suite_torch.models import tape as tt
from audio_suite_torch.ops import envdet as tenv
from audio_suite_torch.ops import fixq as tfq
from audio_suite_torch.ops import varispeed as tvs
from audio_suite_torch.utils import io as t_io
from oracles.grid_ref import mixdown_np, render_track_to_master_np

import test_goldens as goldens
import test_grid
import test_torch_scrub
import test_torch_tape

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
ORACLE_DBFS = -120.0      # the bound tests/test_grid.py holds JAX to


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _signal(n, seed, silence=True):
    """Noise under a slow envelope, with a stretch of silence."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * (0.2 + 0.8 * np.abs(np.sin(
        np.arange(n) * 3.0 / n)))
    if silence:
        x[n // 3: n // 2] = 0.0
    return (0.5 * x).astype(np.float32)


# ---------------------------------------------------------------------------
# envdet
# ---------------------------------------------------------------------------

def test_exact_sq_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000), rng.uniform(-1e-3, 1e-3, 500),
        [0.0, -0.0, 1.0, -1.0, 1e-30, 3.4e18, 1e-41, np.float32(1.0 / 3)]]) \
        .astype(np.float32)
    got = tenv.exact_sq(_t(x)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, tenv.exact_sq_np(x))
    assert np.array_equal(got, np.asarray(jax.jit(jenv.exact_sq)(x)))


@pytest.mark.parametrize("win", [1, 2, 3, 7, 2400, 3000, 3500])
def test_box_sums_direct_bit_equal(win):
    n = 3000
    x2 = tenv.exact_sq_np(_signal(n, win))
    got = tenv._box_sums_direct(_t(x2), n, win, torch).numpy()
    want_np = tenv._box_sums_direct(x2, n, win, np)
    want_jax = jax.jit(lambda v: jenv._box_sums_direct(v, n, win, jnp))(x2)
    assert np.array_equal(got, want_np)
    assert np.array_equal(got, np.asarray(want_jax))
    assert np.array_equal(want_np, jenv._box_sums_direct(x2, n, win, np))


def test_isqrt30_exact():
    r = np.arange(1, 32769, dtype=np.int64)
    uq = np.concatenate([[0, 1, 2, 3, 1 << 30, (1 << 30) - 1],
                         r * r - 1, r * r, np.minimum(r * r + 1, 1 << 30),
                         np.random.default_rng(1).integers(0, 1 << 30,
                                                           20000)])
    uq = uq.astype(np.int32)
    got = tenv.isqrt30(_t(uq)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.floor(np.sqrt(uq.astype(np.float64)))
                          .astype(np.int32))
    assert np.array_equal(got, tenv.isqrt30_np(uq))
    assert np.array_equal(got, np.asarray(jax.jit(jenv.isqrt30)(uq)))


def _mod_speed_all(placed, win, a_q12, jit=True):
    """The port's chain against its NumPy twin and the JAX package's twin,
    and with ``jit`` against the jitted JAX chain (a compile per case)."""
    got = tenv.mod_speed_fix(_t(placed), win, a_q12).numpy()
    want_np = tenv.mod_speed_fix_np(placed, win, a_q12)
    assert got.dtype == np.int32
    assert np.array_equal(got, want_np)
    assert np.array_equal(want_np, jenv.mod_speed_fix_np(placed, win, a_q12))
    if jit:
        want_jax = jax.jit(lambda p: jenv.mod_speed_fix(p, win, a_q12))(
            placed)
        assert np.array_equal(got, np.asarray(want_jax))
    return got


@pytest.mark.parametrize("win,amount", [(1, 0.6), (240, 0.8), (2400, 0.6),
                                        (37, 1.5), (5000, 4.0), (80, 0.01)])
def test_mod_speed_fix_bit_equal(win, amount):
    inc = _mod_speed_all(_signal(4000, win), win, tenv.amount_q12(amount))
    assert tenv.amount_q12(amount) == jenv.amount_q12(amount)
    assert inc.min() >= 1 << 20 and inc.max() <= 4 << 22
    sp = tenv.speed_q_from_fix_np(inc)
    assert np.array_equal(sp, jenv.speed_q_from_fix_np(inc))


def test_mod_speed_fix_silence():
    inc = _mod_speed_all(np.zeros(1000, np.float32), 50, 2458)
    assert (inc == 1 << 22).all()


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 1500),
       win=st.integers(1, 400), a_q12=st.integers(1, 16384),
       silent=st.floats(0.0, 1.0), tie=st.booleans())
def test_mod_speed_fix_hypothesis(seed, n, win, a_q12, silent, tie):
    """Signals with silence and near-ties of the box-sum max: two bursts
    one ulp apart in level, far enough apart to make separate windows.
    Against the NumPy twins (the parametrized cases above hold the twins
    against the jitted JAX chain; a jit here would compile per example)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.float32(0.3)
    x[: int(silent * n)] = 0.0
    if tie and n >= 8:
        b = max(1, min(win, n // 4))
        x[:] = 0.0
        x[:b] = np.float32(0.5)
        x[-b:] = np.nextafter(np.float32(0.5), np.float32(1.0))
    _mod_speed_all(x, win, a_q12, jit=False)


# ---------------------------------------------------------------------------
# fixq
# ---------------------------------------------------------------------------

def test_pos_add_bit_equal():
    rng = np.random.default_rng(2)
    w = rng.integers(-(1 << 20), 1 << 20, 5000).astype(np.int32)
    f = rng.integers(0, tfq.POS_ONE, 5000).astype(np.int32)
    inc = rng.integers(-4 * tfq.POS_ONE, 4 * tfq.POS_ONE, 5000) \
        .astype(np.int32)
    got = tfq.pos_add(_t(w), _t(f), _t(inc))
    want = jax.jit(jfq.pos_add)(w, f, inc)
    want_np = tfq.pos_add_np(w, f, inc)
    for g, wj, wn in zip(got, want, want_np):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(wj))
        assert np.array_equal(g.numpy(), wn)
    assert (got[1].numpy() >= 0).all() and (got[1].numpy() < tfq.POS_ONE) \
        .all()


@pytest.mark.parametrize("init", [(0, 0), (3, 1234567), (-2, 5),
                                  (40000, tfq.POS_ONE - 1)])
def test_segmented_pos_cumsum_tensor_init(init):
    rng = np.random.default_rng(3)
    inc = _t(rng.integers(0, 4 * tfq.POS_ONE, 6000).astype(np.int32))
    reset = _t(rng.random(6000) < 1e-3)
    want = tfq.segmented_pos_cumsum(inc, reset, *init)
    for dtype in (torch.int32, torch.int64):
        w, f = (torch.tensor(v, dtype=dtype) for v in init)
        for args in ((w, f), (w, init[1]), (init[0], f)):
            got = tfq.segmented_pos_cumsum(inc, reset, *args)
            assert all(torch.equal(g, e) for g, e in zip(got, want))
    wn = tfq.segmented_pos_cumsum_np(inc.numpy(), reset.numpy(), *init)
    assert all(np.array_equal(g.numpy(), e) for g, e in zip(want, wn))


def _segmented_pos_cumsum_int_init(inc, reset, init_whole=0, init_frac=0):
    """``fixq.segmented_pos_cumsum`` as it was before it took tensor
    inits."""
    inc = inc.to(torch.int64)
    incl = torch.cumsum(inc, 0)
    seg = torch.cumsum(reset, 0)
    base = torch.zeros(inc.shape[0] + 1, dtype=torch.int64,
                       device=inc.device)
    base.scatter_(0, torch.where(reset, seg, 0),
                  torch.where(reset, incl - inc, 0))
    base[0] = -(int(init_whole) * tfq.POS_ONE + int(init_frac))
    val = incl - base[seg]
    return ((val >> tfq.POS_FRAC_BITS).to(torch.int32),
            (val & tfq.POS_MASK).to(torch.int32))


def test_tape_and_scrub_renders_unchanged_by_tensor_inits():
    audio, p, frames = test_torch_tape._config1(tt)
    s_audio, cfg, trace, _ = test_torch_scrub._config2(ts, scale=2.0 / 30.0)
    y_tape = tt.render_tape(audio, p, frames, device="cpu")
    y_scrub = ts.render_scrub(s_audio, cfg, trace, device="cpu")
    with mock.patch.object(tvs, "segmented_pos_cumsum",
                           _segmented_pos_cumsum_int_init), \
            mock.patch.object(tfq, "segmented_pos_cumsum",
                              _segmented_pos_cumsum_int_init):
        old_tape = tt.render_tape(audio, p, frames, device="cpu")
        old_scrub = ts.render_scrub(s_audio, cfg, trace, device="cpu")
    assert np.array_equal(y_tape, old_tape)
    assert np.array_equal(y_scrub, old_scrub)
    assert np.abs(y_tape).max() > 0.1 and np.abs(y_scrub).max() > 0.1


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

_N, _PAT = 5000, 700
_POS_CASES = {
    # name: (loop, speed kind, start_idx, resets)
    "loop_unit": (True, "unit", 0, ()),
    "nonloop_unit": (False, "unit", 0, ()),
    "nonloop_slow_breaks_before": (False, "slow", 0, ()),
    "nonloop_fast_breaks_after": (False, "fast", 130, ()),
    "loop_mod_resets": (True, "mod", 0, (640, 1777, 2930)),
    "nonloop_mod_resets": (False, "mod", 0, (90, 640, 2930)),
    "loop_mod_negative_start": (True, "mod", -400, (1200,)),
    "nonloop_mod_negative_start": (False, "mod", -300, ()),
    "loop_unit_negative_start": (True, "unit", -400, (1200,)),
    "nonloop_unit_negative_start": (False, "unit", -250, ()),
    "loop_unit_deep_negative": (True, "unit", -40000, ()),
    "loop_mod_deep_negative": (True, "mod", -40000, (3000,)),
    "nonloop_unit_late": (False, "unit", 4700, ()),
}


def _inc(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "unit":
        return np.full(_N, tfq.POS_ONE, np.int32)
    lo, hi = {"slow": (0.25, 0.9), "fast": (1.2, 4.0),
              "mod": (0.25, 4.0)}[kind]
    return np.rint(rng.uniform(lo, hi, _N) * tfq.POS_ONE).astype(np.int32)


@pytest.mark.parametrize("case", list(_POS_CASES))
def test_track_positions_bit_equal(case):
    loop, kind, start, resets = _POS_CASES[case]
    inc = _inc(kind, len(case))
    mod_src = -1 if kind == "unit" else 0
    mask = np.zeros(_N, bool)
    mask[list(resets)] = True
    tm_t = tg._TrackMeta(pat_n=_PAT, base=0, start_idx=start, loop=loop,
                         mod_src=mod_src, win=1, a_q12=0, gain=1.0)
    tm_j = jg._TrackMeta(pat_n=_PAT, base=0, start_idx=start, loop=loop,
                         mod_src=mod_src, win=1, a_q12=0, gain=1.0)
    i = np.arange(_N, dtype=np.int32)
    idx, valid = (v.numpy() for v in tg._track_positions(
        _t(i), _t(inc), _t(mask), tm_t, _N))
    j_idx, j_valid = jax.jit(lambda a, b, c: jg._track_positions(
        a, b, c, tm_j, _N))(i, inc, mask)
    assert np.array_equal(idx, np.asarray(j_idx))
    assert np.array_equal(valid, np.asarray(j_valid))

    speed = None if kind == "unit" else tenv.speed_q_from_fix_np(inc)
    for twin in (tg.placement_indices, tg.placement_indices_np):
        h_idx, h_valid = twin(_N, _PAT, 0.0, 1, loop, speed, set(resets),
                              start_idx=start)
        assert np.array_equal(valid, h_valid), twin.__name__
        assert np.array_equal(idx[valid], h_idx[valid]), twin.__name__
    assert valid.any()
    # the oracle's sequential loop reads the same samples
    pat = np.arange(1, _PAT + 1, dtype=np.float32)
    ref = np.zeros(_N, np.float32)
    render_track_to_master_np(ref, pat, _PAT, start, 1, loop, speed,
                              set(resets))
    assert np.array_equal(np.where(valid, pat[idx], 0.0), ref)


# ---------------------------------------------------------------------------
# mixdown
# ---------------------------------------------------------------------------

def _mixdown_project(tmp_path):
    """tests/test_grid.py:108's project with a two-deep mod chain, a
    modulated track that starts before the master and one that starts
    after it: wav, context and event cells, sync points and restarts."""
    sine, ctx, evt = (tmp_path / f"{k}.py" for k in ("sine", "ctx", "evt"))
    test_grid._write_sine_cell(sine)
    test_grid._write_ctx_cell(ctx)
    test_grid._write_event_cell(evt)
    wav = tmp_path / "loop.wav"
    rng = np.random.default_rng(9)
    t_io.write_wav(str(wav), (0.4 * rng.standard_normal(SR // 2))
                   .astype(np.float32), SR)
    C = tg.CellSource
    t0 = tg.Track(name="beat", mode="duration", duration_seconds=1.0,
                  uniform_n=4, loop_to_master=True,
                  cells=[C("py", str(evt)), C(), C("py", str(evt)), C()])
    t1 = tg.Track(name="tone", mode="duration", duration_seconds=2.0,
                  uniform_n=4, loop_to_master=True, gain_db=-3.0,
                  mod_source_index=0, mod_amount=0.8, mod_smoothing_ms=30.0,
                  sync_points_text="0.5, 1.25",
                  cells=[C("py", str(ctx)), C("wav", str(wav)), C(),
                         C("py", str(sine))])
    t2 = tg.Track(name="early", mode="duration", duration_seconds=0.6,
                  uniform_n=2, loop_to_master=False, gain_db=2.0,
                  start_offset_seconds=-0.05, mod_source_index=1,
                  mod_amount=1.5, mod_smoothing_ms=10.0,
                  cells=[C("py", str(ctx)), C("py", str(sine))])
    t3 = tg.Track(name="late", mode="tempo_bpm", bpm=120, measures=1,
                  start_offset_seconds=0.3, uniform_n=2,
                  cells=[C(), C("py", str(sine))])
    return tg.GridProject(tracks=[t0, t1, t2, t3],
                          master=tg.MasterClock("fixed_seconds", 2.5),
                          sample_rate=SR)


def _both(project):
    """The port's project and the JAX package's, from one dict."""
    return project, jg.project_from_dict(tg.project_to_dict(project))


def _assert_bit_equal_to_jax(pt, pj):
    """The port's device engine (f32, PCM16) against JAX's device and host
    engines; returns the port's f32 mix."""
    mix = tg.render_mixdown(pt, device="cpu")
    assert mix.dtype == np.float32
    assert np.array_equal(mix, jg.render_mixdown(pj))
    assert np.array_equal(mix, jg.render_mixdown(pj, engine="host"))
    assert np.array_equal(mix, tg.render_mixdown(pt, engine="host",
                                                 device="cpu"))
    if not pt.normalize:
        y16 = tg.render_mixdown(pt, pcm16=True, device="cpu")
        assert y16.dtype == np.int16
        assert np.array_equal(y16, jg.render_mixdown(pj, pcm16=True))
    return mix


def test_mixdown_bit_equal_to_jax_and_near_oracle(tmp_path):
    pt, pj = _both(_mixdown_project(tmp_path))
    mix = _assert_bit_equal_to_jax(pt, pj)
    n_total = int(round(2.5 * SR))
    assert mix.shape == (n_total,) and np.abs(mix).max() > 0.1

    restarts = tg.collect_restart_events(pt, 2.5)
    assert restarts == jg.collect_restart_events(pj, 2.5)
    assert any(restarts)
    n, rows = tg._build_mix_program(pt)
    n_j, rows_j = jg._build_mix_program(pj)
    assert n == n_j == n_total
    for r, rj in zip(rows, rows_j):
        assert r.keys() == rj.keys()
        for k in r:
            assert np.array_equal(r[k], rj[k]), k

    # the oracle: the reference's sequential loop over the same patterns
    # and speeds (tests/test_grid.py:147-183)
    pats, placements, gains, placed = [], [], [], []
    for row, t in zip(rows, pt.tracks):
        speed = None
        if row["mod_src"] >= 0:
            speed = tg.mod_speed_for_track(placed[row["mod_src"]],
                                           t.mod_smoothing_ms,
                                           t.mod_amount, SR)
        resets = set(int(r) for r in row["resets"])
        y = np.zeros(n_total, np.float32)
        render_track_to_master_np(y, row["pat"], len(row["pat"]),
                                  t.start_offset_seconds, SR,
                                  t.loop_to_master, speed, resets)
        placed.append(y * np.float32(row["gain"]))
        pats.append(row["pat"])
        placements.append(dict(start_offset_seconds=t.start_offset_seconds,
                               sr=SR, loop_to_master=t.loop_to_master,
                               speed=speed, resets=resets))
        gains.append(row["gain"])
    ref = mixdown_np(pats, placements, gains, n_total)
    assert max_dev_dbfs(mix, ref) <= ORACLE_DBFS
    # measured: bit-equal, since the oracle's float ops are the engine's
    # (a gain product per sample, then the f32 sum in track order)
    assert np.array_equal(mix, ref)

    # the placed tracks of return_tracks match the device mix
    mix_h, tracks = tg.render_mixdown(pt, return_tracks=True, device="cpu")
    assert np.array_equal(mix_h, mix) and len(tracks) == 4
    assert np.array_equal(tracks[2], placed[2])


def test_export_wav_and_project_io(tmp_path):
    pt, pj = _both(_mixdown_project(tmp_path))
    path = tmp_path / "prj.json"
    tg.save_project(pt, str(path))
    back = tg.load_project(str(path))
    assert tg.project_to_dict(back) == tg.project_to_dict(pt)
    assert tg.project_to_dict(back) == jg.project_to_dict(
        jg.load_project(str(path)))
    out = tmp_path / "mix.wav"
    mix = tg.export_wav(back, str(out), device="cpu")
    jg.export_wav(pj, str(tmp_path / "mix_j.wav"))
    with open(out, "rb") as a, open(tmp_path / "mix_j.wav", "rb") as b:
        assert a.read() == b.read()
    assert mix.shape == (int(round(2.5 * SR)),)


def _golden_projects():
    """tests/test_goldens.py:261-307's three grid projects (JAX side)."""
    base = goldens._grid_project(None)
    pydiv = goldens._grid_project(None)
    pydiv.tracks[0].division_mode = "python"
    pydiv.tracks[0].python_code = (
        "def divisions(total):\n"
        "    w = [1.0, 2.0, 1.0, 3.0, 1.0, 2.0]\n"
        "    s = sum(w)\n"
        "    return [total * x / s for x in w]\n")
    pydiv.tracks[0].ensure_cells(6)
    host = goldens._grid_project(None)
    host.tracks[1].start_offset_seconds = -0.35
    return {"grid": (base, "device"), "grid_pydiv": (pydiv, "device"),
            "grid_host": (host, "host")}


@pytest.mark.parametrize("name", ["grid", "grid_pydiv", "grid_host"])
def test_grid_goldens(name):
    pj, engine = _golden_projects()[name]
    pt = tg.project_from_dict(jg.project_to_dict(pj))
    got = tg.render_mixdown(pt, engine=engine, device="cpu")
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    goldens._compare(name, goldens._fingerprint(got), want)
    _assert_bit_equal_to_jax(pt, pj)


def test_showcase_bit_equal_to_jax():
    path = os.path.join(REPO, "examples", "grid_showcase.json")
    pt, pj = tg.load_project(path), jg.load_project(path)
    mix = _assert_bit_equal_to_jax(pt, pj)
    assert mix.shape == (12 * 44100,)
    assert float(np.abs(mix).max()) == pytest.approx(0.98, abs=1e-6)
    assert any(tg.collect_restart_events(pt, 12.0))


def test_program_memo_keys_on_the_device(tmp_path, monkeypatch):
    """The program memo holds one entry per device (the cells run on the
    render's device): a build on "cpu", then "cuda", then "cpu" again
    makes two builds, "cuda" and "cuda:0" share one entry, and a CPU
    render made after them is bit-equal to JAX's."""
    pt, pj = _both(_mixdown_project(tmp_path))
    built = []
    build = tg._build_mix_program

    def spy(project, device="cuda"):
        built.append(str(device))
        return build(project, "cpu")

    tg._PROGRAM_CACHE.clear()
    with monkeypatch.context() as m:
        m.setattr(tg, "_build_mix_program", spy)
        cpu = tg.build_mix_program_cached(pt, "cpu")
        card = tg.build_mix_program_cached(pt, "cuda")
        assert tg.build_mix_program_cached(pt, "cpu") is cpu
        assert tg.build_mix_program_cached(pt, "cuda:0") is card
        assert tg.build_mix_program_cached(pt, torch.device("cpu")) is cpu
    assert built == ["cpu", "cuda"] and cpu is not card
    assert len(tg._PROGRAM_CACHE) == 2
    _assert_bit_equal_to_jax(pt, pj)


def test_cells_see_each_render_device(tmp_path, monkeypatch):
    """A cell that records ``context["device"]``, built for two device
    strings, sees both: the second build is not served the first's
    cells."""
    log = tmp_path / "devices.txt"
    cell = tmp_path / "rec.py"
    cell.write_text(
        "import numpy as np\n"
        "def generate(sr, duration, context):\n"
        f"    with open({str(log)!r}, 'a') as f:\n"
        "        f.write(str(context['device']) + '\\n')\n"
        "    return np.full(int(round(sr * duration)), 0.25, np.float32)\n")
    t = tg.Track(name="rec", mode="duration", duration_seconds=1.0,
                 uniform_n=1, cells=[tg.CellSource("py", str(cell))])
    project = tg.GridProject(tracks=[t],
                             master=tg.MasterClock("fixed_seconds", 1.0),
                             sample_rate=SR)
    tg._PROGRAM_CACHE.clear()
    for device in ("cuda", "cpu", "cuda:0", "cpu"):
        tg.build_mix_program_cached(project, device)
    assert log.read_text().split() == ["cuda", "cpu"]


_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from chip_smoke import config5
from audio_suite_torch.models import grid
project = config5(4.0)
y16 = grid.render_mixdown(project, pcm16=True, device="cpu")
y = grid.render_mixdown(project, device="cpu")
assert y16.shape == (192000,) and y16.dtype == np.int16, y16.shape
assert np.array_equal(y16, np.clip(np.round(y * 32768.0), -32768, 32767))
assert int(np.abs(y16).max()) > 5000
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_config5_grid_renders_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKED.format(repo=REPO)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"

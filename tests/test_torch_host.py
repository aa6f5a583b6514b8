"""The port's own copies of the JAX package's host modules, held against
the originals on seeded inputs, and the rule that the port imports nothing
of the JAX package:

- ``events.schedulers.generate_event_times``, every process;
- ``utils.breakpoints``: parse and evaluate valid, empty and malformed lanes;
- ``utils.io`` / ``utils.wavcodec``: byte-identical WAV files, equal arrays
  from ``load_wav_mono``, the resamplers, ``fit_to_duration`` and the
  peak normalizers;
- ``utils.native_rt``: the port's g++ loader gives the JAX package's tape
  tables and grid placements, and raises when the build fails;
- ``plugins.host``: the same arity errors as the JAX package's, and its
  own path-keyed module cache;
- a static walk of ``audio_suite_torch/**/*.py`` (``plugins/`` included),
  ``chip_smoke.py`` and the A/B scripts ``oa_ab.py``, ``read_ab.py`` and
  ``f64_ab.py`` finds no import of ``audio_suite_tpu`` or ``jax``;
- every entry point defaults to ``device="cuda"``;
- the scrub's increments and Microsound's noise draws are the same with
  Python int seeds and streams kept on the host as they were when every
  argument was copied to the device.

(``events/rules.py``, another copy, is held in ``test_torch_rules.py``.)
"""
import ast
import glob
import os

import numpy as np
import pytest

from audio_suite_tpu.events import schedulers as j_sched
from audio_suite_tpu.models import tape as jt
from audio_suite_tpu.plugins import host as j_host
from audio_suite_tpu.utils import breakpoints as j_bp
from audio_suite_tpu.utils import io as j_io
from audio_suite_tpu.utils import native_rt as j_nrt
from audio_suite_torch.events import schedulers as t_sched
from audio_suite_torch.models import tape as tt
from audio_suite_torch.plugins import host as t_host
from audio_suite_torch.utils import breakpoints as t_bp
from audio_suite_torch.utils import io as t_io
from audio_suite_torch.utils import native_rt as t_nrt

import test_goldens as goldens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("process", ["Single", "Poisson", "Clustered",
                                     "Hawkes", "Unknown"])
@pytest.mark.parametrize("seed,rate", [(0, 60.0), (5, 7.5), (123, 0.0),
                                       (99, 250.0)])
def test_generate_event_times_matches_jax(process, seed, rate):
    kw = dict(cluster_size=4, cluster_spread_ms=10.0, hawkes_gain=0.8,
              hawkes_decay_s=0.1)
    got = t_sched.generate_event_times(process, 2.0, rate, seed, **kw)
    want = j_sched.generate_event_times(process, 2.0, rate, seed, **kw)
    assert got == want
    assert t_sched.generate_event_times(process, 1.5, rate, seed) \
        == j_sched.generate_event_times(process, 1.5, rate, seed)


_LANES = ["", None, "   ", "0:1", "0.5:2, 0:1, 1:3", "0:1,1:5,2:-3,4:0.25",
          "0:1, bad, 2:x, :, 3:4", "1:2:3, 2:4", "0.1:7, 0.1:9, 0.3:1",
          ",,, 5:5,"]


def _parse_both(lane):
    """Parse with both; a lane the original rejects must be rejected alike."""
    try:
        want = j_bp.parse_breakpoints(lane)
    except ValueError:
        with pytest.raises(ValueError):
            t_bp.parse_breakpoints(lane)
        return None
    got = t_bp.parse_breakpoints(lane)
    assert got == want
    return got


@pytest.mark.parametrize("lane", _LANES)
def test_parse_breakpoints_matches_jax(lane):
    _parse_both(lane)


@pytest.mark.parametrize("lane", _LANES)
def test_eval_breakpoints_matches_jax(lane):
    pts = _parse_both(lane)
    if pts is None:
        return
    ts = np.random.default_rng(len(lane or "")).uniform(-1.0, 5.0, 257)
    ts[:4] = [0.0, 0.1, 1.0, 2.0]                  # on the knots
    got = t_bp.eval_breakpoints_vec(pts, ts, default=0.75)
    want = j_bp.eval_breakpoints_vec(pts, ts, default=0.75)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [t_bp.eval_breakpoints(pts, t, 0.75) for t in ts[:16]] \
        == [j_bp.eval_breakpoints(pts, t, 0.75) for t in ts[:16]]


@pytest.mark.parametrize("subtype", ["FLOAT", "PCM_16", "PCM_24", "PCM_32",
                                     None])
@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_byte_identical_and_reads_back_equal(tmp_path, subtype,
                                                       channels):
    rng = np.random.default_rng(channels)
    x = rng.uniform(-1.1, 1.1, (1001, channels)).astype(np.float32)
    x[:3, 0] = [-1.0, 1.0, 0.0]
    x = x[:, 0] if channels == 1 else x
    a, b = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    t_io.write_wav(a, x, 44100, subtype=subtype)
    j_io.write_wav(b, x, 44100, subtype=subtype)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for always_2d in (False, True):
        got, sr = t_io.read_wav(a, always_2d=always_2d)
        want, sr_j = j_io.read_wav(a, always_2d=always_2d)
        assert sr == sr_j == 44100
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("sr_target", [None, 44100, 22050, 48000])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_mono_matches_jax(tmp_path, sr_target, channels):
    rng = np.random.default_rng(7 + channels)
    x = rng.uniform(-1, 1, (3000, channels)).astype(np.float32)
    path = str(tmp_path / "in.wav")
    j_io.write_wav(path, x, 44100, subtype="PCM_16")
    got, sr = t_io.load_wav_mono(path, sr_target)
    want, sr_j = j_io.load_wav_mono(path, sr_target)
    assert sr == sr_j and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("in_sr,out_sr,n", [(44100, 48000, 4410),
                                            (48000, 44100, 4800),
                                            (48000, 48000, 100),
                                            (8000, 192000, 333),
                                            (48000, 8000, 5), (44100, 48000, 0)])
def test_resamplers_match_jax(in_sr, out_sr, n):
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    for got, want in ((t_io.resample_to_rate(x, in_sr, out_sr),
                       j_io.resample_to_rate(x, in_sr, out_sr)),
                      (t_io.resample_linear(x, in_sr, out_sr),
                       j_io.resample_linear(x, in_sr, out_sr))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    st = np.stack([x, -x], axis=1)
    assert np.array_equal(t_io.to_mono(st), j_io.to_mono(st))
    assert np.array_equal(t_io.to_mono(x), j_io.to_mono(x))


@pytest.mark.parametrize("seed,n,sr,duration", [
    (0, 1000, 8000, 0.125), (1, 1000, 8000, 0.1), (2, 999, 8000, 0.2),
    (3, 50, 44100, 0.0), (4, 0, 48000, 0.01), (5, 4410, 44100, 0.1000001)])
def test_fit_to_duration_matches_jax(seed, n, sr, duration):
    x = np.random.default_rng(seed).uniform(-1.5, 1.5, n)
    for arr in (x, x.astype(np.float32)):
        got = t_io.fit_to_duration(arr, sr, duration)
        want = j_io.fit_to_duration(arr, sr, duration)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("scale", [0.0, 1e-13, 0.3, 0.98, 1.0, 7.5])
@pytest.mark.parametrize("peak", [0.98, 0.5])
def test_normalizers_match_jax(scale, peak):
    x = (np.random.default_rng(int(scale * 10)).uniform(-1, 1, 777)
         * scale).astype(np.float32)
    for fn in ("normalize_peak", "normalize_full"):
        for arr in (x, x.astype(np.float64), x[:0]):
            got = getattr(t_io, fn)(arr, peak)
            want = getattr(j_io, fn)(arr, peak)
            assert got.dtype == want.dtype and np.array_equal(got, want), fn


_CELLS = {
    "ok_gen": "def generate(sr, duration):\n    return [0.0] * 4\n",
    "ok_both": ("def generate(sr, duration, context):\n    return []\n"
                "def event(context):\n    return {}\n"),
    "ok_event": "def event(ctx):\n    return None\n",
    "gen_one_arg": "def generate(sr):\n    return []\n",
    "gen_four_args": "def generate(a, b, c, d):\n    return []\n",
    "event_two_args": ("def generate(sr, d):\n    return []\n"
                       "def event(a, b):\n    return None\n"),
    "neither": "x = 1\n",
}


@pytest.mark.parametrize("name", list(_CELLS))
def test_load_py_module_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.py"
    path.write_text(_CELLS[name])
    try:
        want = j_host.load_py_module(str(path))
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            t_host.load_py_module(str(path))
        assert str(got.value) == str(e)
        assert str(path) not in t_host._MODULE_CACHE
        return
    got = t_host.load_py_module(str(path))
    assert (got.generate is None) == (want.generate is None)
    assert (got.event is None) == (want.event is None)
    # a cache of its own, keyed on the path
    assert t_host.load_py_module(str(path)) is got
    assert got is not want and got.mod is not want.mod
    assert t_host._MODULE_CACHE is not j_host._MODULE_CACHE
    t_host.clear_module_cache()
    assert t_host.load_py_module(str(path)) is not got
    assert j_host.load_py_module(str(path)) is want


def _grid_speed(n, seed):
    rng = np.random.default_rng(seed)
    return np.rint(rng.uniform(0.25, 4.0, n) * (1 << 22)).astype(np.float32) \
        * np.float32(1.0 / (1 << 22))


# (pat_n, start_idx, loop, speed, resets, pre_phase)
_PLACEMENTS = {
    "loop": (700, 0, True, None, (), 0.0),
    "nonloop": (700, 0, False, None, (), 0.0),
    "loop_resets_speed": (500, 0, True, "speed", (640, 1777, 2930), 0.0),
    "nonloop_resets_speed": (500, 90, False, "speed", (640, 1777), 0.0),
    "negative_unit_pre_phase": (700, -400, True, None, (1200,), 400.0),
    "negative_speed_pre_phase": (700, -300, False, "speed", (), "sum"),
    "negative_no_pre_phase": (700, -300, True, "speed", (2000,), 0.0),
    "negative_nonloop_no_pre_phase": (700, -250, False, None, (), 0.0),
    "short_speed_array": (333, 10, True, "short", (4000,), 0.0),
}


@pytest.mark.parametrize("case", list(_PLACEMENTS))
def test_grid_placement_matches_jax(case):
    pat_n, start, loop, sp, resets, pre = _PLACEMENTS[case]
    n = 5000
    speed = {None: None, "speed": _grid_speed(n, len(case)),
             "short": _grid_speed(n // 2, 1)}[sp]
    if pre == "sum":
        pre = float(np.sum(speed[:-start].astype(np.float64)))
    got = t_nrt.grid_placement(n, pat_n, start, loop, speed, set(resets),
                               pre)
    want = j_nrt.grid_placement(n, pat_n, start, loop, speed, set(resets),
                                pre)
    assert want is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[1].any()


def test_grid_placement_rejects_an_empty_pattern():
    with pytest.raises(ValueError, match="pat_n 0"):
        t_nrt.grid_placement(100, 0, 0, True, None, set(), 0.0)


def _golden_tape(mod):
    p = mod.TapeParams(
        sample_rate=goldens.SR, markers=[4000, 9000, 13000],
        section_speeds=[0.7, 1.4, 2.2, 0.9],
        section_reverse=[True, False, False, True],
        tape_age=30.0, enable_splice_fx=True, anticlick_enabled=True,
        inertia_enabled=True, inertia_amount=40.0)
    return goldens._test_audio(), p, 18000


def test_port_loader_gives_the_jax_package_tables():
    audio, p, frames = _golden_tape(jt)
    prog = jt.build_tape_program(audio, p, frames)
    args = (frames, len(audio), prog["mod_consts"], prog["starts"],
            prog["ends"], prog["speeds_q"], prog["reverse"],
            prog["boundaries"], len(prog["splice_env"]), prog["consts"])
    got = t_nrt.tape_tables(*args)
    want = j_nrt.tape_tables(*args)
    assert got.keys() == want.keys() and got["final"] == want["final"]
    for k in got:
        if k != "final":
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    lib = t_nrt.get_lib()
    assert lib is t_nrt.get_lib()
    assert os.path.dirname(lib._name) == t_nrt.BUILD_DIR


def test_port_loader_raises_on_a_failed_build(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_nrt, "_SRC", str(bad))
    monkeypatch.setattr(t_nrt, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_nrt, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        t_nrt.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        t_nrt.grid_placement(100, 10, 0, True, None, set(), 0.0)


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "audio_suite_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                                     "oa_ab.py",
                                                     "read_ab.py",
                                                     "f64_ab.py")]


def test_import_walk_covers_every_subpackage():
    walked = {os.path.relpath(p, REPO) for p in _port_sources()}
    for sub in ("cli", "events", "kernels", "models", "ops", "parallel",
                "plugins", "utils"):
        assert os.path.join("audio_suite_torch", sub, "__init__.py") \
            in walked, sub
    assert os.path.join("audio_suite_torch", "plugins", "host.py") in walked
    assert os.path.join("audio_suite_torch", "models", "grid.py") in walked
    assert os.path.join("audio_suite_torch", "models", "forestfire.py") \
        in walked
    assert os.path.join("audio_suite_torch", "events", "rules.py") in walked
    for mod in ("batch", "ca", "distributed", "dryrun", "timeline"):
        assert os.path.join("audio_suite_torch", "parallel", f"{mod}.py") \
            in walked, mod


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("audio_suite_tpu", "jax", "jaxlib"), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


# every entry point of the port, old and new: (module, qualified name)
_ENTRY_POINTS = [
    ("microsound", "render"), ("microsound", "render_program"),
    ("microsound", "batch_render"),
    ("tape", "build_tape_program"), ("tape", "build_tape_program_cached"),
    ("tape", "render_tape"), ("tape", "render_to_wav"),
    ("tape", "render_tape_trace"), ("tape", "build_trace_programs"),
    ("patternlab", "render"), ("patternlab", "render_device"),
    ("patternlab", "render_preset"), ("patternlab", "prepared_to_device"),
    ("patternlab", "MegaDriveInspiredSynth"),
    ("scrub", "render_scrub"), ("scrub", "scrub_render_kernel"),
    ("scrub", "scrub_render_segments"), ("scrub", "device_program"),
    ("grid", "render_mixdown"), ("grid", "export_wav"),
    ("grid", "prepare_device_mix"), ("grid", "build_mix_program_cached"),
    ("grid", "collect_restart_events"), ("grid", "render_track_pattern"),
    ("forestfire", "ForestFireModel"), ("forestfire", "carry_from_state"),
]
# not entry points: a helper that moves arrays to the device it is given,
# and a record that holds its device
_DEVICE_HELPERS = {("microsound", "program_to_device"),
                   ("patternlab", "PreparedRender")}


def _models():
    import importlib
    return {m: importlib.import_module(f"audio_suite_torch.models.{m}")
            for m in ("microsound", "tape", "patternlab", "scrub", "grid",
                      "forestfire")}


@pytest.mark.parametrize("mod,name", _ENTRY_POINTS,
                         ids=lambda v: str(v))
def test_entry_point_defaults_to_the_card(mod, name):
    import inspect
    sig = inspect.signature(getattr(_models()[mod], name))
    assert sig.parameters["device"].default == "cuda"


def test_every_model_function_with_a_device_is_an_entry_point():
    import inspect
    for mod, m in _models().items():
        for name, obj in vars(m).items():
            if (name.startswith("_") or not callable(obj)
                    or getattr(obj, "__module__", None) != m.__name__):
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            if "device" in params:
                assert ((mod, name) in _ENTRY_POINTS
                        or (mod, name) in _DEVICE_HELPERS), (mod, name)


@pytest.mark.parametrize("mod", ["batch", "ca", "distributed", "dryrun",
                                 "timeline"])
def test_parallel_functions_with_a_device_default_to_the_card(mod):
    import importlib
    import inspect
    m = importlib.import_module(f"audio_suite_torch.parallel.{mod}")
    for name, obj in vars(m).items():
        if (name.startswith("_") or not callable(obj)
                or getattr(obj, "__module__", None) != m.__name__):
            continue
        params = inspect.signature(obj).parameters
        if "device" in params:
            assert params["device"].default == "cuda", (mod, name)


_JAX_BLOCKED_PARALLEL = """
import sys, tempfile
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from audio_suite_torch.models import forestfire as ff
from audio_suite_torch.models import microsound as ms
from audio_suite_torch.parallel import batch as pb, ca
params = ff.ModelParams(w=24, h=16)
carry = ff.init_state(params, seed=4)
carry["state"][6:10, 8:14] = ff.FIRE
mesh = pb.make_mesh(4, axis_names=("sp",), devices=["cpu"] * 4)
c2, stats = ca.simulate_sharded(params, carry, 2, mesh, seed=4)
m = ff.ForestFireModel(params, seed=4, device="cpu")
m._state = carry
assert np.array_equal(stats, m.simulate(2))
assert np.array_equal(c2["state"].numpy(), m._np["state"])
p = ms.MicrosoundParams.from_dict(dict(base_sr=8000, out_dur_s=0.2,
                                       max_grains=8, er_cloud_on=False))
with tempfile.TemporaryDirectory() as d:
    paths = ms.batch_render(p, d, seeds=[1, 2], manifest_path=d + "/m.json",
                            device="cpu")
    assert len(paths) == 2 and not pb.BatchManifest.load(
        d + "/m.json").pending()
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_sharded_ca_and_batch_render_with_jax_blocked():
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c",
                        _JAX_BLOCKED_PARALLEL.format(repo=REPO)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _pre_repair_normal(seed, idx, stream=0):
    """ops/noise.py:normal as it was before Python int seeds and streams
    stayed on the host: every argument went through ``torch.as_tensor``
    onto idx's device and each of the 12 uniforms hashed (seed, idx)
    anew."""
    import torch
    from audio_suite_torch.ops import noise as tn

    def as_u32(x):
        return torch.as_tensor(x, device=idx.device).to(torch.int64) \
            & tn._MASK32

    acc = None
    for k in range(12):
        h = tn._mix((tn._mul32(as_u32(seed), tn._GOLDEN)
                     + tn._mul32(as_u32(idx), tn._M1)
                     + tn._mul32(as_u32(stream * 12 + k + 1), tn._M2))
                    & tn._MASK32)
        u = (h >> 8).to(torch.float32) * tn._INV24
        acc = u if acc is None else acc + u
    return acc - 6.0


def test_scrub_and_microsound_noise_unchanged_by_the_host_seed_repair():
    from unittest import mock

    import torch
    from audio_suite_torch.models import scrub as ts
    from audio_suite_torch.ops import fixq as tfq
    from audio_suite_torch.ops import generators as tgen
    from audio_suite_torch.ops import noise as tn

    rng = np.random.default_rng(8)
    nb, bs = 23, 1024
    base = tfq.round_sig12_np(rng.uniform(-0.9, 0.9, nb).astype(np.float32))
    jsq = tfq.round_sig12_np(rng.uniform(0, 0.007, nb).astype(np.float32))
    c = ts._mod_consts(48000)
    args = (torch.from_numpy(base), torch.from_numpy(jsq), 1234, bs,
            (c["ints"], c["flts"]))
    n = torch.tensor([[700], [1000], [999]])
    seeds = torch.tensor([[5], [6], [0x7FFFFFFF]])
    k = torch.arange(513)
    got = (ts._inc_device(*args), tgen._tilted_noise(n, seeds, -3.0, 1024,
                                                     1024),
           tn.normal(seeds, k, tgen.STREAM_TILT_IM))
    with mock.patch.object(tn, "normal", _pre_repair_normal):
        want = (ts._inc_device(*args),
                tgen._tilted_noise(n, seeds, -3.0, 1024, 1024),
                tn.normal(seeds, k, tgen.STREAM_TILT_IM))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert np.array_equal(got[0].numpy(), ts._inc_np(base, jsq, 1234, bs, c))

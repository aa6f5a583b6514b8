"""The port's own copies of the JAX package's host modules, held against
the originals on seeded inputs, and the rule that the port imports nothing
of the JAX package:

- ``events.schedulers.generate_event_times``, every process;
- ``utils.breakpoints``: parse and evaluate valid, empty and malformed lanes;
- ``utils.io`` / ``utils.wavcodec``: byte-identical WAV files, equal arrays
  from ``load_wav_mono`` and the resamplers;
- ``utils.native_rt``: the port's g++ loader gives the JAX package's tape
  tables;
- a static walk of ``audio_suite_torch/**/*.py``, ``chip_smoke.py`` and
  the A/B scripts ``oa_ab.py`` and ``read_ab.py`` finds no import of
  ``audio_suite_tpu`` or ``jax``.
"""
import ast
import glob
import os

import numpy as np
import pytest

from audio_suite_tpu.events import schedulers as j_sched
from audio_suite_tpu.models import tape as jt
from audio_suite_tpu.utils import breakpoints as j_bp
from audio_suite_tpu.utils import io as j_io
from audio_suite_tpu.utils import native_rt as j_nrt
from audio_suite_torch.events import schedulers as t_sched
from audio_suite_torch.models import tape as tt
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


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "audio_suite_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                                     "oa_ab.py",
                                                     "read_ab.py")]


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
    ("tape", "build_tape_program"), ("tape", "build_tape_program_cached"),
    ("tape", "render_tape"), ("tape", "render_to_wav"),
    ("patternlab", "render"), ("patternlab", "render_device"),
    ("patternlab", "render_preset"), ("patternlab", "prepared_to_device"),
    ("patternlab", "MegaDriveInspiredSynth"),
    ("scrub", "render_scrub"), ("scrub", "scrub_render_kernel"),
    ("scrub", "scrub_render_segments"), ("scrub", "device_program"),
]
# not entry points: a helper that moves arrays to the device it is given,
# and a record that holds its device
_DEVICE_HELPERS = {("microsound", "program_to_device"),
                   ("patternlab", "PreparedRender")}


def _models():
    import importlib
    return {m: importlib.import_module(f"audio_suite_torch.models.{m}")
            for m in ("microsound", "tape", "patternlab", "scrub")}


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

"""The port's surfaces held against the JAX package on the CPU: the threefry
draws, the device grid cells, profiling and metrics, ``load_image_gray``
and Pattern Lab's Python Script generator.

- ``ops/threefry.py`` against ``jax.random`` (``jax_threefry_partitionable``
  on, checked first): ``PRNGKey``, ``split`` and ``bits`` bit-equal for
  several seeds and odd lengths, ``uniform`` and the ``bernoulli`` gates
  bit-equal, ``normal`` within 4 f32 ulps;
- ``plugins/torch_cells.py`` against ``plugins/jax_cells.py`` (jitted, as
  the grid runs it): ``sine``, ``arpeggio``, ``glitch_slices`` and
  ``generate`` for each ``cell_index % 3`` within -120 dBFS, with the
  count of samples that differ printed; the file loaded by path through
  the plugin host; the ``grid``, ``grid_pydiv`` and ``grid_host`` goldens
  (tests/test_goldens.py) with it as their cell, on the projects
  ``chip_smoke.torch_cells_project`` builds for the card;
- ``utils/metrics.py`` and ``utils/profiling.py``: the same numbers as
  JAX's, from arrays and from tensors; ``device_trace`` with a falsy
  directory does nothing;
- ``load_image_gray`` equal to JAX's on a PNG made with PIL;
- the Python Script generator on the three ``examples/patterns/*.py``
  (user code that imports the JAX package's ``NoteEvent``): events equal
  to JAX's, renders within -100 dBFS of the JAX render run op by op.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_torch.models import grid as tg
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.models import patternlab as tpl
from audio_suite_torch.ops import threefry
from audio_suite_torch.plugins import host as t_host
from audio_suite_torch.plugins import torch_cells as tc
from audio_suite_torch.utils import metrics as tmet
from audio_suite_torch.utils import profiling as tprof
from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.models import patternlab as jpl
from audio_suite_tpu.plugins import jax_cells as jc
from audio_suite_tpu.utils import metrics as jmet
from audio_suite_tpu.utils import profiling as jprof

import test_goldens as goldens
from chip_smoke import torch_cells_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_CELLS = os.path.join(REPO, "audio_suite_torch", "plugins",
                           "torch_cells.py")
SEEDS = (0, 1, 42, 7919, 2 ** 31 - 1, -3, 2 ** 32 - 1)
LENGTHS = (1, 3, 17, 1001, 4097)


def _key(seed):
    k = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    return int(k[0]), int(k[1])


def test_jax_draws_take_the_partitionable_paths():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == _key(seed)
    for num in (2, 3, 7):
        want = [tuple(int(v) for v in row)
                for row in np.asarray(jax.random.split(k, num))]
        assert threefry.split(threefry.prng_key(seed), num) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_bit_equal(seed):
    k, kt = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for n in LENGTHS:
        b = np.asarray(jax.random.bits(k, (n,))).astype(np.int64)
        assert np.array_equal(threefry.bits(kt, n, "cpu").numpy(), b)
        u = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
        ut = threefry.uniform(kt, n, "cpu").numpy()
        assert np.array_equal(ut.view(np.int32), u.view(np.int32))
        for p in (0.45, 0.5, 0.01):
            g = np.asarray(jax.random.bernoulli(k, p, (n,)))
            assert np.array_equal(threefry.bernoulli(kt, p, n, "cpu")
                                  .numpy(), g)
    b2 = np.asarray(jax.random.bits(k, (3, 5))).astype(np.int64)
    assert np.array_equal(threefry.bits(kt, (3, 5), "cpu").numpy(), b2)
    u2 = np.asarray(jax.random.uniform(k, (33,), jnp.float32, -2.5, 0.75))
    ut2 = threefry.uniform(kt, 33, "cpu", -2.5, 0.75).numpy()
    assert np.array_equal(ut2.view(np.int32), u2.view(np.int32))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulps(seed):
    k, kt = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for n in LENGTHS + (200_003,):
        want = np.asarray(jax.random.normal(k, (n,), jnp.float32))
        got = threefry.normal(kt, n, "cpu").numpy()
        d = _ulps(got, want)
        assert got.dtype == np.float32 and d.max() <= 4, (n, d.max())
        if n > 1000:
            print(f"seed {seed} n {n}: {int((d > 0).sum())} normals differ, "
                  f"max {int(d.max())} ulps")


def _dev_report(name, want, got):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    dbfs = tmet.max_dev_dbfs(want, got)
    print(f"{name}: {int((got != want).sum())} of {got.size} samples "
          f"differ, {dbfs:.1f} dBFS")
    assert dbfs <= -120.0
    assert float(np.abs(got).max()) > 0.01


@pytest.mark.parametrize("sr,dur", [(22050, 0.25), (48000, 0.7),
                                    (44100, 1.0)])
def test_cells_match_jax_cells(sr, dur):
    _dev_report(f"sine {sr}", jc.sine(sr, dur),
                tc.sine(sr, dur, device="cpu"))
    _dev_report(f"sine 330 Hz {sr}", jc.sine(sr, dur, freq=330.0, gain=0.2),
                tc.sine(sr, dur, freq=330.0, gain=0.2, device="cpu"))
    _dev_report(f"arpeggio {sr}", jc.arpeggio(sr, dur),
                tc.arpeggio(sr, dur, device="cpu"))
    _dev_report(f"glitch_slices {sr}", jc.glitch_slices(sr, dur, seed=5),
                tc.glitch_slices(sr, dur, seed=5, device="cpu"))
    for ci in range(6):
        ctx = {"cell_index": ci, "device": "cpu"}
        _dev_report(f"generate cell {ci} {sr}", jc.generate(sr, dur, ctx),
                    tc.generate(sr, dur, ctx))


def test_cells_load_by_path_through_the_plugin_host():
    mod = t_host.LoadedModule(TORCH_CELLS)
    ctx = {"cell_index": 4, "device": "cpu"}
    assert np.array_equal(mod.generate(22050, 0.5, ctx),
                          tc.generate(22050, 0.5, ctx))


@pytest.mark.parametrize("name", ["grid", "grid_pydiv", "grid_host"])
def test_grid_goldens_with_torch_cells(name):
    """chip_smoke.py's torch_cells projects, which phase 12 renders on the
    card, against tests/test_goldens.py's fingerprints."""
    project, engine = torch_cells_project(name)
    assert {c.path for t in project.tracks for c in t.cells
            if c.kind == "py"} == {TORCH_CELLS}
    got = tg.render_mixdown(project, engine=engine, device="cpu")
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    goldens._compare(name, goldens._fingerprint(got), want)


def test_metrics_and_meta_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(1000).astype(np.float32) * 0.3
    b = a + rng.standard_normal(1000).astype(np.float32) * 1e-5
    assert tmet.max_dev_dbfs(a, b) == jmet.max_dev_dbfs(a, b)
    assert tmet.max_dev_dbfs(a, a) == jmet.max_dev_dbfs(a, a) == -200.0
    with pytest.raises(ValueError):
        tmet.max_dev_dbfs(a, b[:10])
    assert tmet.rtf(4.0, 0.5) == jmet.rtf(4.0, 0.5)
    assert tmet.rtf(4.0, 0.0) == jmet.rtf(4.0, 0.0)
    stereo = np.stack([a, -a], axis=1)
    for x in (a, stereo, np.zeros(0, np.float32), np.zeros(5, np.float32)):
        want_p, want_m = jprof.peak_dbfs(x), jprof.render_meta(x, 48000,
                                                               0.25)
        for got in (x, torch.from_numpy(x)):
            assert tprof.peak_dbfs(got) == want_p
            assert tprof.render_meta(got, 48000, 0.25) == want_m
    assert tprof.render_meta(a, 48000, 0.0) == jprof.render_meta(a, 48000,
                                                                  0.0)


def test_stage_timer_and_falsy_trace():
    timer = tprof.StageTimer()
    for _ in range(2):
        with timer.stage("build"):
            pass
    with timer.stage("render"):
        pass
    assert list(timer.report()) == ["build", "render"]
    with tprof.device_trace(None, "cpu"), tprof.device_trace("", "cpu"):
        with tprof.annotate("noop"):
            pass


def test_load_image_gray_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(rgb, "RGB").save(path)
    got, want = tms.load_image_gray(path), jms.load_image_gray(path)
    assert got.dtype == np.float64 and got.shape == (23, 37)
    assert np.array_equal(got, want)


_SCRIPTS = sorted(f for f in os.listdir(os.path.join(REPO, "examples",
                                                      "patterns"))
                  if f.endswith(".py"))


@pytest.mark.parametrize("script", _SCRIPTS)
def test_python_script_generator_matches_jax(script):
    path = os.path.join(REPO, "examples", "patterns", script)
    kw = dict(sample_rate=16000, seconds=0.6, bpm=120.0, seed=3)
    ev_t = tpl.generate("Python Script", tpl.RenderConfig(**kw),
                        script_path=path)
    ev_j = jpl.generate("Python Script", jpl.RenderConfig(**kw),
                        script_path=path)
    assert ev_t and [dataclasses.astuple(e) for e in ev_t] == \
        [dataclasses.astuple(e) for e in ev_j]
    cfg_j = jpl.RenderConfig(**kw)
    synth = jpl.MegaDriveInspiredSynth(cfg_j.sample_rate, seed=cfg_j.seed)
    prep = synth.prepare(jpl.apply_time_ops(ev_j, cfg_j), cfg_j.seconds)
    with jax.disable_jit():
        want = np.asarray(synth.render_prepared(prep, master_gain=0.9))
    got, used = tpl.render(ev_t, tpl.RenderConfig(**kw), device="cpu")
    assert len(used) == len(ev_t) and got.shape == want.shape
    dbfs = tmet.max_dev_dbfs(want, got)
    print(f"{script}: {len(ev_t)} events, {dbfs:.1f} dBFS from the JAX "
          f"render run op by op")
    assert dbfs <= -100.0 and float(np.abs(got).max()) > 0.05

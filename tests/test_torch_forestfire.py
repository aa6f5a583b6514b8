"""The port's Forest Fire CA held against the JAX package on the CPU.

Same inputs (params, seeds and brush edits; the port starts from the JAX
model's state through ``carry_from_state``) through the JAX package (its
jitted ``simulate``), its NumPy oracle ``oracles/forestfire_ref.simulate_np``
and the port on ``device="cpu"``; every comparison is bit-exact:

- noise: ``uniform_pair``, ``normal_ih4``, ``uniform``, ``normal`` and the
  key-based hash against JAX and the NumPy twins, at indices near 2**32 - 1
  and streams past 2**32; int and tensor seeds and streams alike;
- ``init_state`` (sizes down to 2 x 2, and the ValueError below),
  ``quantized_consts``, ``terrain_static`` and ``torch.gradient`` on config
  5's elevation;
- ``simulate`` at ``SMALL`` (tests/test_forestfire.py) in both noise modes,
  resumed runs, a run where ``EMBER_CAP`` binds, brush edits before and
  after a run, ``render_rgb``, ``reset``;
- the ``forestfire_stats``, ``forestfire_rgb`` and ``forestfire_windy``
  goldens through ``tests/test_goldens.py``'s own fixtures;
- a fuzz over small shapes and params in both modes against the oracle;
- config 5 at its smoke size end to end with the JAX package blocked.

The oracle's ``fast_noise`` branch computes the fused draws but its step
then reads the single-site draws, so the oracle runs the default stream
family in both modes (``test_oracle_fast_branch_is_the_default_one``).  In
fast mode the port is held against JAX and against the oracle with the
fused draws put in at its draw sites (``_fast_draws``).
"""
import dataclasses
import os
import subprocess
import sys
import types
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_suite_tpu.models
import oracles.forestfire_ref as ref
from audio_suite_tpu.models import forestfire as jff
from audio_suite_tpu.ops import noise as jn
from audio_suite_torch.models import forestfire as tff
from audio_suite_torch.ops import noise as tn

import test_goldens as goldens

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(w=64, h=48, rain_chance=0.05, lightning_rate=1e-4)
PLANES = ("state", "fuel", "moisture", "age")


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

_IDX = np.concatenate([np.arange(300), 0xFFFFFFFF - np.arange(40),
                       np.random.default_rng(0).integers(0, 1 << 32, 200)]) \
    .astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("draw", ["uniform", "uniform_pair", "normal_ih4",
                                  "normal", "hash_u32"])
@pytest.mark.parametrize("seed,stream", [(0, 0), (3, 17), (0xFFFFFFFF, 5),
                                         (12345, 0xFFFFFFF0),
                                         (7, (1 << 20) + 11)])
def test_noise_draws_match_jax_and_numpy(draw, seed, stream):
    want = getattr(jn, draw)(jnp.uint32(seed), jnp.asarray(_IDX),
                             jnp.uint32(stream))
    want = want if isinstance(want, tuple) else (want,)
    got = getattr(tn, draw)(seed, _t(_IDX), stream)
    got = got if isinstance(got, tuple) else (got,)
    # the key-based form, and a stream past 2**32 (it wraps)
    keyed = getattr(tn, draw + "_key" if draw != "hash_u32" else "hash_key")(
        tn.cell_key(seed, _t(_IDX)), stream + (1 << 32))
    keyed = keyed if isinstance(keyed, tuple) else (keyed,)
    np_fn = getattr(tn, draw + "_np", None)
    twin = np_fn(np.uint32(seed), _IDX, np.uint32(stream)) if np_fn else None
    twin = twin if isinstance(twin, tuple) or twin is None else (twin,)
    for i, w in enumerate(want):
        w = np.asarray(w)
        if draw == "hash_u32":
            w = w.astype(np.int64)
        assert np.array_equal(got[i].numpy(), w), draw
        assert np.array_equal(keyed[i].numpy(), w), draw
        if twin is not None:
            assert np.array_equal(twin[i], w), draw


def test_normal_stream_wraps_as_uint32():
    """``stream * 12 + k + 1`` past 2**32 wraps as JAX's uint32 does."""
    stream = 0x20000001                    # * 12 passes 2**32
    want = jn.normal(jnp.uint32(9), jnp.asarray(_IDX), jnp.uint32(stream))
    got = tn.normal(9, _t(_IDX), stream)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tn.normal(9, _t(_IDX), torch.tensor(stream)).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("seed", [5, -3, np.uint32(77), 0xFFFFFFFF + 9])
def test_int_and_tensor_seeds_and_streams_agree(seed):
    idx = _t(_IDX[:64])
    s32 = int(seed) & 0xFFFFFFFF
    want = tn.hash_u32_np(np.uint32(s32), _IDX[:64], np.uint32(s32 ^ 0x55))
    for sd in (seed, torch.tensor(int(seed)), torch.full((64,), int(seed))):
        for st in (s32 ^ 0x55, torch.tensor(s32 ^ 0x55)):
            got = tn.hash_u32(sd, idx, st)
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), want.astype(np.int64))
    # a [E, 1] tensor seed broadcasts against the index grid (Microsound)
    seeds = torch.tensor([[1], [2], [3]])
    got = tn.uniform(seeds, idx, 5)
    want = jn.uniform_np(np.uint32([[1], [2], [3]]), _IDX[:64], np.uint32(5))
    assert got.shape == (3, 64) and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# host pieces: init, constants, terrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,w,h", [(1, 220, 160), (3, 64, 48), (7, 2, 2),
                                      (11, 2, 9), (13, 17, 3)])
def test_init_state_matches_jax(seed, w, h):
    jp = jff.ModelParams(w=w, h=h)
    want = jff.init_state(jp, seed)
    got = tff.init_state(tff.ModelParams(w=w, h=h), seed)
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("w,h", [(1, 5), (5, 1), (1, 1)])
def test_grid_below_2x2_raises(w, h):
    with pytest.raises(ValueError, match="at least 2x2"):
        jff.ForestFireModel(jff.ModelParams(w=w, h=h))
    with pytest.raises(ValueError, match="at least 2x2"):
        tff.ForestFireModel(tff.ModelParams(w=w, h=h), device="cpu")


_PARAMS = [dict(), dict(wind_dir_deg=190.0, wind_strength=1.4),
           dict(slope_strength=0.9, moisture_relax=0.03, wind_dir_deg=-70.0),
           dict(w=24, h=2, wind_strength=0.0)]


@pytest.mark.parametrize("kw", _PARAMS, ids=range(len(_PARAMS)))
def test_consts_and_terrain_match_jax(kw):
    jp = jff.ModelParams(**kw)
    tp = tff.ModelParams(**dataclasses.asdict(jp))
    assert tff.quantized_consts(tp) == jff.quantized_consts(jp)
    assert tp.wind_vec() == jp.wind_vec()
    assert tp.static_key() == jp.static_key()
    elev = jff.init_state(jp, 2)["elev"]
    want = jff.terrain_static(jp, jnp.asarray(elev))
    got = tff.terrain_static(tp, torch.from_numpy(elev))
    for k in want:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_gradient_matches_numpy_and_jax_on_config5_elevation():
    elev = tff.init_state(tff.ModelParams(), 2)["elev"]
    got = torch.gradient(torch.from_numpy(elev))
    for g, n, j in zip(got, np.gradient(elev), jnp.gradient(elev)):
        assert np.array_equal(g.numpy(), n.astype(np.float32))
        assert np.array_equal(g.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# the trajectory
# ---------------------------------------------------------------------------

_PAIRS = {tff._S_SPREAD: (tff._S_SPREAD, 0), tff._S_EMIT: (tff._S_SPREAD, 1),
          tff._S_IGNITE: (tff._S_IGNITE, 0), tff._S_DIST: (tff._S_IGNITE, 1),
          tff._S_GROW_E: (tff._S_GROW_E, 0), tff._S_GROW_A: (tff._S_GROW_E, 1),
          tff._S_FUEL_E: (tff._S_FUEL_E, 0), tff._S_FUEL_A: (tff._S_FUEL_E, 1)}


def _fast_uniform_np(seed, idx, stream):
    """A single-site draw of the oracle, as fast_noise defines it: each pair
    of sites shares one 16-bit ``uniform_pair`` at the first site's stream
    (hi half, lo half); lightning and rain keep their 24-bit draw."""
    site = int(stream) % tff._SITES
    if site not in _PAIRS:
        return jn.uniform_np(seed, idx, stream)
    first, half = _PAIRS[site]
    return jn.uniform_pair_np(seed, idx,
                              np.uint32(int(stream) - site + first))[half]


# the oracle's noise module with the fused draws at its draw sites; its
# jitter normals become Irwin-Hall(4) at the same streams
_fast_draws = types.SimpleNamespace(
    uniform_np=_fast_uniform_np, normal_np=jn.normal_ih4_np,
    uniform_pair_np=jn.uniform_pair_np, normal_ih4_np=jn.normal_ih4_np)


def _oracle(carry, n_steps, params, seed):
    if params.fast_noise:
        with mock.patch.object(ref, "noise", _fast_draws):
            return ref.simulate_np(carry, n_steps, params, seed)
    return ref.simulate_np(carry, n_steps, params, seed)


def _pair(kw, seed, ignite=None):
    """A JAX model and a port model (CPU) from one state: the port starts
    from the JAX model's state dict, brush edits included."""
    jp = jff.ModelParams(**kw)
    jm = jff.ForestFireModel(jp, seed=seed)
    if ignite is not None:
        jm.ignite_at(*ignite)
    tm = tff.ForestFireModel(tff.ModelParams(**dataclasses.asdict(jp)),
                             seed=seed, device="cpu")
    tm._state = tff.carry_from_state(jm._np, device="cpu")
    start = {k: np.copy(v) for k, v in jm._np.items()}
    return jm, tm, start


def _assert_planes(tm, carry):
    for k in PLANES:
        got, want = tm._np[k], np.asarray(carry[k])
        assert got.dtype == want.dtype, k
        assert np.array_equal(got, want), k


def test_oracle_fast_branch_is_the_default_one():
    jp = jff.ModelParams(**SMALL, fast_noise=True)
    st = jff.init_state(jp, 3)
    _, fast = ref.simulate_np(st, 20, jp, 3)
    _, default = ref.simulate_np(st, 20, dataclasses.replace(
        jp, fast_noise=False), 3)
    _, fused = _oracle(st, 20, jp, 3)
    assert np.array_equal(fast, default)
    assert not np.array_equal(fused, default)


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast_noise"])
def test_simulate_matches_jax_and_oracle(fast):
    jm, tm, start = _pair(dict(SMALL, fast_noise=fast), 3, (30, 20, 3))
    got = tm.simulate(80)
    want = jm.simulate(80)
    carry, oracle = _oracle(start, 80, jm.params, 3)
    assert got.dtype == np.int32 and got.shape == (80, 8)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, oracle)
    assert got[:, 2].max() > 0 and got[:, 5].sum() > 0
    _assert_planes(tm, carry)
    for k in PLANES:
        assert np.array_equal(tm._np[k], np.asarray(jm._np[k])), k
    assert int(tm._np["t"]) == int(jm._np["t"]) == 80
    assert tm.get_stats() == jm.get_stats()


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast_noise"])
def test_resume_continuity(fast):
    """Two simulate() calls equal one long call (the step counter threads
    through the noise streams), and match the oracle."""
    kw = dict(SMALL, fast_noise=fast)
    a = tff.ForestFireModel(tff.ModelParams(**kw), seed=7, device="cpu")
    a.ignite_at(10, 10, radius=2)
    start = {k: np.copy(v) for k, v in a._np.items()}
    s = np.concatenate([a.simulate(30), a.simulate(30)])
    b = tff.ForestFireModel(tff.ModelParams(**kw), seed=7, device="cpu")
    b.ignite_at(10, 10, radius=2)
    assert np.array_equal(b.simulate(60), s)
    carry, oracle = _oracle(start, 60, jff.ModelParams(**kw), 7)
    assert np.array_equal(s, oracle)
    _assert_planes(a, carry)
    _assert_planes(b, carry)


def test_ember_cap_binds_and_stays_bit_exact():
    kw = dict(w=64, h=48, ember_rate=1.0, rain_chance=0.0)
    jm, tm, start = _pair(kw, 4, (32, 24, 30))
    with pytest.warns(RuntimeWarning, match="EMBER_CAP"):
        got = tm.simulate(12)
    with pytest.warns(RuntimeWarning, match="EMBER_CAP"):
        want = jm.simulate(12)
    carry, oracle = _oracle(start, 12, jm.params, 4)
    assert got[:, 6].max() > tff.EMBER_CAP
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, oracle)
    _assert_planes(tm, carry)


def test_brush_edits_render_and_reset():
    kw = dict(SMALL, wind_dir_deg=120.0)
    jm, tm, _ = _pair(kw, 2, None)
    for m in (jm, tm):
        m.clear_at(5, 5, radius=3)
        m.set_tree_at(60, 40, radius=4)      # wraps around the edges
        m.ignite_at(20, 30, radius=6)
    for m in (jm, tm):
        m.simulate(25)
        m.set_tree_at(5, 5, radius=2)
        m.ignite_at(6, 6, radius=1)
        m.clear_at(1, 1, radius=1)
    got, want = tm.simulate(20), jm.simulate(20)
    assert np.array_equal(got, np.asarray(want))
    for k in PLANES:
        assert np.array_equal(tm._np[k], np.asarray(jm._np[k])), k
    assert tm.get_stats() == jm.get_stats()
    for overlay in (False, True):
        jm.params.show_moisture_overlay = overlay
        tm.params.show_moisture_overlay = overlay
        a, b = tm.render_rgb(), jm.render_rgb()
        assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()
    tm.reset()
    jm.reset()
    for k in ("state", "fuel", "moisture", "elev", "age"):
        assert np.array_equal(tm._np[k], jm._np[k]), k
    assert tm.get_stats() == jm.get_stats()
    tm.step()
    assert tm.get_stats()["t"] == 1


def _port_ff():
    """The port in the JAX module's place for test_goldens' fixtures, which
    import ``forestfire`` from ``audio_suite_tpu.models``; counts models."""
    made = []

    def model(*a, **k):
        made.append(1)
        return tff.ForestFireModel(*a, device="cpu", **k)

    return types.SimpleNamespace(ModelParams=tff.ModelParams,
                                 ForestFireModel=model), made


@pytest.mark.parametrize("name", ["forestfire_stats", "forestfire_rgb",
                                  "forestfire_windy"])
def test_forest_goldens(name):
    import json
    shim, made = _port_ff()
    with mock.patch.object(audio_suite_tpu.models, "forestfire", shim):
        got = goldens.FIXTURES[name]()
    assert made
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    if not isinstance(want, list):
        got = goldens._fingerprint(got)
    goldens._compare(name, got, want)


def _fuzz_cases(n=8):
    rng = np.random.default_rng(2024)
    cases = []
    for i in range(n):
        w, h = (int(v) for v in rng.integers(2, 26, 2))
        kw = dict(w=w, h=h, p_tree_init=float(rng.uniform(0.3, 0.95)),
                  base_spread=float(rng.uniform(0.1, 0.9)),
                  ember_rate=float(rng.choice([0.0, 0.035, 0.3, 1.0])),
                  ember_max_dist=int(rng.integers(1, 30)),
                  lightning_rate=float(rng.choice([3e-6, 1e-3, 0.05])),
                  rain_chance=float(rng.uniform(0.0, 0.3)),
                  wind_dir_deg=float(rng.uniform(-360, 360)),
                  wind_strength=float(rng.uniform(0.0, 2.0)),
                  slope_strength=float(rng.uniform(0.0, 1.0)),
                  regrow_rate=float(rng.uniform(0.0, 0.1)),
                  fast_noise=bool(i % 2))
        ign = (int(rng.integers(0, w)), int(rng.integers(0, h)),
               int(rng.integers(0, 6)))
        cases.append((kw, int(rng.integers(0, 1 << 31)), ign))
    return cases


@pytest.mark.parametrize("kw,seed,ign", _fuzz_cases(),
                         ids=lambda v: f"{v['w']}x{v['h']}"
                         f"{'-fast' if v['fast_noise'] else ''}"
                         if isinstance(v, dict) else None)
def test_fuzz_against_oracle(kw, seed, ign):
    m = tff.ForestFireModel(tff.ModelParams(**kw), seed=seed, device="cpu")
    m.ignite_at(*ign)
    start = {k: np.copy(v) for k, v in m._np.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = m.simulate(25)
    carry, oracle = _oracle(start, 25, jff.ModelParams(**kw), seed)
    assert np.array_equal(got, oracle)
    _assert_planes(m, carry)


def test_stats_rows_to_dicts_matches_jax():
    s = np.arange(24, dtype=np.int32).reshape(3, 8)
    assert tff.stats_rows_to_dicts(s) == jff.stats_rows_to_dicts(s)
    assert tff.STAT_KEYS == jff.STAT_KEYS


_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from chip_smoke import config5, config5_fire
from audio_suite_torch.models import forestfire as ff, grid
y16 = grid.render_mixdown(config5(4.0), pcm16=True, device="cpu")
model, eng, rec = config5_fire("cpu")
stats = model.simulate(120)              # bench.py:534 at _SMOKE: 4 s at 30 Hz
eng.run_stream(ff.stats_rows_to_dicts(stats), rec.send)
assert y16.shape == (192000,) and y16.dtype == np.int16
assert stats.shape == (120, 8) and stats.dtype == np.int32
assert (stats[:, 1:5].sum(axis=1) == 220 * 160).all()
assert stats[:, 2].max() > 50 and len(rec.packets) >= 1
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("ok", ",".join(str(int(v)) for v in stats.sum(axis=0)),
      b"".join(rec.packets).hex())
"""


def test_config5_end_to_end_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKED.format(repo=REPO)],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    ok, sums, packets = r.stdout.split()
    assert ok == "ok"
    # the JAX package's run of the same model and rule
    from audio_suite_tpu.events import rules as R
    jm = jff.ForestFireModel(jff.ModelParams(), seed=2)
    jm.ignite_at(110, 80, radius=4)
    stats = jm.simulate(120)
    eng = R.WatchEngine(now_fn=lambda: 0.0)
    eng.set_rules([R.ThresholdRule(metric_key="burning", op=">",
                                   threshold=50, edge="rising",
                                   cooldown_s=0.0)])
    rec = R.OSCRecorder()
    eng.run_stream(jff.stats_rows_to_dicts(stats), rec.send)
    assert sums == ",".join(str(int(v)) for v in np.asarray(stats).sum(0))
    assert bytes.fromhex(packets) == b"".join(rec.packets)

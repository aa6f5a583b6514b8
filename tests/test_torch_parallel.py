"""The port's parallel layer held against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's meshes hold ``["cpu"] * 8`` (one device filling every mesh
position, as the virtual devices do).  Inputs are made from seeds with
NumPy:

- ``make_mesh``: 1-D and 2-D shapes (the JAX factoring), and the errors
  when more devices are asked for than exist;
- ``batch_render`` of ``tests/test_parallel.py``'s kernel sharded over 8
  shards: equal to the unsharded run, within 1e-6 of JAX's;
- ``sharded_sum`` within 1e-5 of JAX's; the ordered collectives;
- ``BatchManifest``: byte-identical JSON to JAX's for one create / mark /
  reopen sequence;
- Microsound ``batch_render`` at ``tests/test_parallel.py``'s small
  params: the manifest byte-identical to JAX's, resume without a render,
  a failed job isolated and then re-rendered alone, each WAV equal to the
  port's single ``render`` and within -100 dBFS of JAX's batch output;
- ``sharded_fir_conv`` at K 129, 4096, 9000 on 8 shards within 1e-5
  relative of JAX's and of the port's reference;
- ``simulate_sharded`` at ``ModelParams()``, seed 2, 40 steps on 8 shards:
  bit-identical to JAX's ``parallel.ca.simulate_sharded``, the port's
  dense ``simulate`` and ``oracles/forestfire_ref.py``, with embers that
  fly; and the ValueError for a grid that does not divide;
- ``dryrun_multichip(8, devices=["cpu"] * 8)``: every engine's sharded
  render within the JAX file's threshold of its single-device render.
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles.forestfire_ref as ref
from audio_suite_tpu.models import forestfire as jff
from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.parallel import batch as jpb
from audio_suite_tpu.parallel import ca as jca
from audio_suite_tpu.parallel import timeline as jtl
from audio_suite_torch.models import forestfire as tff
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.parallel import batch as pb
from audio_suite_torch.parallel import ca
from audio_suite_torch.parallel import dryrun
from audio_suite_torch.parallel import timeline as tl
from audio_suite_torch.utils import io as tio

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
TOL_DBFS = -100.0


def _dbfs(got, want) -> float:
    e = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
    peak = max(1e-12, float(np.max(np.abs(want))))
    return -200.0 if e == 0.0 else 20.0 * np.log10(e / peak)


def _jax_mesh(axis_names=("dp",)):
    if len(jax.devices()) < 8:
        pytest.skip(f"need 8 virtual devices, have {len(jax.devices())}")
    return jpb.make_mesh(8, axis_names=axis_names)


# ---------------------------------------------------------------------------
# meshes, batch_render, sharded_sum, the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [("dp",), ("dp", "ev"), ("sp",)])
def test_mesh_shapes_match_jax(axes):
    m = pb.make_mesh(8, axis_names=axes, devices=CPU8)
    jm = _jax_mesh(axes)
    assert m.devices.shape == jm.devices.shape
    assert m.axis_names == tuple(jm.axis_names)
    assert m.shape == dict(jm.shape)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert len(m.axis_devices(axes[-1])) == m.devices.shape[-1]


def test_make_mesh_raises_past_the_devices_there_are():
    with pytest.raises(ValueError, match="cards"):
        pb.make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="given"):
        pb.make_mesh(9, devices=CPU8)
    assert pb.make_mesh(4, devices=CPU8).devices.shape == (4,)


def _t_kernel(sg):
    seed, gain = sg[0], sg[1]
    i = torch.arange(512, dtype=torch.float32)
    return gain * torch.sin(i * (seed + 1.0) * 0.001)


def _j_kernel(sg):
    seed, gain = sg[0], sg[1]
    i = jnp.arange(512, dtype=jnp.float32)
    return gain * jnp.sin(i * (seed + 1.0) * 0.001)


def test_batch_render_sharded_matches_single_and_jax():
    args = np.stack([np.arange(16, dtype=np.float32),
                     np.linspace(0.1, 1.0, 16, dtype=np.float32)], axis=1)
    mesh = pb.make_mesh(8, devices=CPU8)
    sharded = pb.batch_render(_t_kernel, args, mesh=mesh)
    single = pb.batch_render(_t_kernel, args, device="cpu")
    assert sharded.shape == (16, 512) and sharded.dtype == np.float32
    np.testing.assert_array_equal(sharded, single)
    want = jpb.batch_render(_j_kernel, jnp.asarray(args), mesh=_jax_mesh())
    assert np.max(np.abs(sharded - want)) <= 1e-6


def test_batch_render_trees_and_indivisible_batches():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal((8, 1)).astype(np.float32)
    mesh = pb.make_mesh(4, devices=CPU8)
    out = pb.batch_render(lambda x, y: {"s": x * y, "m": x.sum()}, (a, b),
                          mesh=mesh)
    np.testing.assert_array_equal(out["s"], a * b)
    np.testing.assert_allclose(out["m"], a.sum(axis=1), rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        pb.batch_render(lambda x: x, a[:6], mesh=mesh)


def test_sharded_sum_matches_jax():
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((8, 1024)).astype(np.float32)
    got = pb.sharded_sum(parts, pb.make_mesh(8, devices=CPU8)).numpy()
    want = np.asarray(jpb.sharded_sum(jnp.asarray(parts), _jax_mesh()))
    assert np.max(np.abs(got - want)) <= 1e-5
    assert np.max(np.abs(got - parts.sum(axis=0))) <= 1e-5
    # the psum adds in shard order
    blocks = [torch.from_numpy(p) for p in parts]
    seq = blocks[0]
    for x in blocks[1:]:
        seq = seq + x
    for s in pb.psum(blocks):
        assert torch.equal(s, seq)


def test_ppermute_and_all_gather():
    blocks = [torch.full((2,), float(i)) for i in range(4)]
    got = pb.ppermute(blocks, [(0, 1), (1, 2), (2, 3)])
    assert [float(g[0]) for g in got] == [0.0, 0.0, 1.0, 2.0]
    got = pb.ppermute(blocks, [(j, (j - 1) % 4) for j in range(4)])
    assert [float(g[0]) for g in got] == [1.0, 2.0, 3.0, 0.0]
    for g in pb.all_gather(blocks):
        assert g.tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]


def test_batch_manifest_json_byte_identical_to_jax(tmp_path):
    paths = {}
    for name, mod in (("jax", jpb), ("port", pb)):
        path = str(tmp_path / f"{name}.json")
        m = mod.BatchManifest.open_or_create(path, ["a", "b", "c"])
        assert sorted(m.pending()) == ["a", "b", "c"]
        m.mark("a", "done", rtf=12.0)
        m.mark("b", "failed", error="boom")
        assert sorted(mod.BatchManifest.load(path).pending()) == ["b", "c"]
        m3 = mod.BatchManifest.open_or_create(path, ["a", "b", "c", "d"])
        assert sorted(m3.pending()) == ["b", "c", "d"]
        assert m3.jobs["a"]["rtf"] == 12.0
        m3.mark("d", "done", events=7)
        paths[name] = path
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# Microsound batch_render (tests/test_parallel.py:90-170's params)
# ---------------------------------------------------------------------------

_MANIFEST_PARAMS = dict(
    base_sr=8000, out_dur_s=0.2, gen_mode="Gaussian click",
    grains_per_sec=20.0, max_grains=8, er_cloud_on=False,
    stereo_on=False, bp_density="")
_PIPELINE_PARAMS = dict(
    base_sr=8000, out_dur_s=0.4, time_unfold=3.0, micro_ms=2.0,
    gen_mode="Gaussian click", grains_per_sec=25.0, max_grains=24,
    bandlimit_on=True, bandlimit_out_hz=3000.0, er_cloud_on=False,
    stereo_on=True, bp_density="", bp_unfold="", bp_cutoff="",
    bp_stretch="", seed=3)


def _single(d, seed, stretch=None):
    p = tms.MicrosoundParams.from_dict(dict(d, seed=seed))
    if stretch is not None:
        p.partial_stretch = float(stretch)
    y, _ = tms.render(p, device="cpu")
    return y.numpy()


def test_microsound_batch_manifest_and_resume_match_jax(tmp_path):
    seeds, stretches = [1, 2], [1.0, 1.5]
    man_t, man_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    paths = tms.batch_render(tms.MicrosoundParams.from_dict(_MANIFEST_PARAMS),
                             str(tmp_path / "t"), seeds=seeds,
                             stretches=stretches, manifest_path=man_t,
                             device="cpu")
    jpaths = jms.batch_render(jms.MicrosoundParams.from_dict(_MANIFEST_PARAMS),
                              str(tmp_path / "j"), seeds=seeds,
                              stretches=stretches, manifest_path=man_j)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths]
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
    with open(man_t, "rb") as f, open(man_j, "rb") as g:
        assert f.read() == g.read()
    assert not pb.BatchManifest.load(man_t).pending()
    jobs = [(s, st) for s in seeds for st in stretches]
    for (s, st), path, jpath in zip(jobs, paths, jpaths):
        got, sr = tio.read_wav(path)
        want, _ = tio.read_wav(jpath)
        assert sr == 8000
        assert _dbfs(got, want) <= TOL_DBFS, path
        np.testing.assert_array_equal(got, _single(_MANIFEST_PARAMS, s, st))
    # resume: every job done, nothing rendered, the same paths back
    with mock.patch.object(tms, "render", wraps=tms.render) as r:
        again = tms.batch_render(
            tms.MicrosoundParams.from_dict(_MANIFEST_PARAMS),
            str(tmp_path / "t"), seeds=seeds, stretches=stretches,
            manifest_path=man_t, device="cpu")
    assert again == paths and r.call_count == 0


@pytest.mark.parametrize("done", [(1,), (1, 3), (0, 2, 4)])
def test_microsound_batch_partial_resume_matches_jax(tmp_path, done):
    """A manifest with some jobs done: the same paths in the same order
    as the JAX package's batch, and the same manifest after."""
    import json
    d = dict(_MANIFEST_PARAMS, out_dur_s=0.1, max_grains=4)
    seeds = [1, 2, 3, 4, 5]
    ids = [f"seed{s}_unfold25_stretch1" for s in seeds]
    got = {}
    for name, mod, kw in (("t", tms, {"device": "cpu"}), ("j", jms, {})):
        out = tmp_path / name
        out.mkdir()
        with open(out / "m.json", "w") as f:
            json.dump({j: {"status": "done" if k in done else "pending"}
                       for k, j in enumerate(ids)}, f)
        paths = mod.batch_render(mod.MicrosoundParams.from_dict(d), str(out),
                                 seeds=seeds, manifest_path=str(out / "m.json"),
                                 **kw)
        with open(out / "m.json", "rb") as f:
            got[name] = ([os.path.basename(q) for q in paths], f.read())
    assert got["t"] == got["j"]
    assert len(got["t"][0]) == len(seeds)


def test_microsound_batch_isolates_a_failed_job(tmp_path):
    out, man = str(tmp_path / "out"), str(tmp_path / "m.json")
    p = tms.MicrosoundParams.from_dict(_MANIFEST_PARAMS)
    bad = os.path.join(out, "seed2_unfold25_stretch1.wav")
    os.makedirs(bad)                  # the WAV cannot be written there
    paths = tms.batch_render(p, out, seeds=[1, 2, 3], manifest_path=man,
                             device="cpu")
    m = pb.BatchManifest.load(man)
    assert m.pending() == ["seed2_unfold25_stretch1"]
    assert m.jobs["seed2_unfold25_stretch1"]["status"] == "failed"
    assert "IsADirectoryError" in m.jobs["seed2_unfold25_stretch1"]["error"]
    assert [os.path.basename(q) for q in paths] == [
        "seed1_unfold25_stretch1.wav", "seed3_unfold25_stretch1.wav"]
    # resume once the fault is gone: only the failed job renders again
    os.rmdir(bad)
    with mock.patch.object(tms, "render", wraps=tms.render) as r:
        paths = tms.batch_render(p, out, seeds=[1, 2, 3], manifest_path=man,
                                 device="cpu")
    assert r.call_count == 1 and not pb.BatchManifest.load(man).pending()
    got, _ = tio.read_wav(bad)
    np.testing.assert_array_equal(got, _single(_MANIFEST_PARAMS, 2))
    assert len(paths) == 3
    # without a manifest the failure raises
    os.remove(bad)
    os.makedirs(bad)
    with pytest.raises(IsADirectoryError):
        tms.batch_render(p, str(tmp_path / "out"), seeds=[2], device="cpu")


def test_microsound_batch_pipelined_matches_single_and_jax(tmp_path):
    p = tms.MicrosoundParams.from_dict(_PIPELINE_PARAMS)
    paths = tms.batch_render(p, str(tmp_path / "t"), seeds=[3, 4, 5],
                             device="cpu")
    jpaths = jms.batch_render(jms.MicrosoundParams.from_dict(_PIPELINE_PARAMS),
                              str(tmp_path / "j"), seeds=[3, 4, 5])
    assert len(paths) == 3
    for seed, path, jpath in zip([3, 4, 5], paths, jpaths):
        got, sr = tio.read_wav(path)
        assert sr == 8000 and got.shape == (3200, 2)
        np.testing.assert_array_equal(got, _single(_PIPELINE_PARAMS, seed))
        assert _dbfs(got, tio.read_wav(jpath)[0]) <= TOL_DBFS, seed


# ---------------------------------------------------------------------------
# timeline: sharded FIR convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [129, 4096, 9000])  # sub-block, block, 3 hops
def test_sharded_fir_conv_matches_jax_and_reference(K):
    rng = np.random.default_rng(K)
    N = 8 * 4096
    x = rng.standard_normal(N).astype(np.float32)
    kernel = (rng.standard_normal(K)
              * np.exp(-np.arange(K) / (K / 6))).astype(np.float32)
    got = tl.sharded_fir_conv(x, kernel, pb.make_mesh(8, devices=CPU8))
    assert got.shape == (N,) and got.dtype == torch.float32
    got = got.numpy()
    want_j = np.asarray(jtl.sharded_fir_conv(x, kernel, _jax_mesh()))
    want_t = tl.sharded_conv_reference(x, kernel, device="cpu").numpy()
    for want in (want_j, want_t):
        scale = max(1e-9, float(np.max(np.abs(want))))
        assert np.max(np.abs(got - want)) / scale < 1e-5, K


def test_sharded_fir_conv_rejects_an_indivisible_signal():
    with pytest.raises(ValueError, match="divide"):
        tl.sharded_fir_conv(np.zeros(1001, np.float32),
                            np.ones(5, np.float32),
                            pb.make_mesh(8, devices=CPU8))


# ---------------------------------------------------------------------------
# ca: the row-sharded Forest Fire CA
# ---------------------------------------------------------------------------

def test_ca_sharded_bit_identical_to_jax_dense_and_oracle():
    params = tff.ModelParams()             # 220 x 160: 20 rows a shard
    jp = jff.ModelParams()
    jmodel = jff.ForestFireModel(jp, seed=2)
    jmodel.ignite_at(110, 80, radius=4)
    carry0 = {k: np.array(v) for k, v in jmodel._np.items()}

    carry_t, stats_t = ca.simulate_sharded(
        params, carry0, 40, pb.make_mesh(8, axis_names=("sp",),
                                         devices=CPU8), seed=2)
    carry_j, stats_j = jca.simulate_sharded(
        jp, carry0, 40, _jax_mesh(("sp",)), seed=2)
    dense = tff.ForestFireModel(params, seed=2, device="cpu")
    dense._state = {k: np.array(v) for k, v in carry0.items()}
    stats_d = dense.simulate(40)
    carry_o, stats_o = ref.simulate_np(
        {k: np.array(v) for k, v in carry0.items()}, 40, jp, 2)

    assert stats_t.dtype == np.int32 and stats_t.shape == (40, 8)
    for other in (stats_j, stats_d, stats_o):
        np.testing.assert_array_equal(stats_t, np.asarray(other, np.int32))
    for k in ("state", "fuel", "moisture", "age"):
        got = carry_t[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(carry_j[k]), k)
        np.testing.assert_array_equal(got, dense._np[k], k)
        np.testing.assert_array_equal(got, np.asarray(carry_o[k]), k)
    assert carry_t["t"] == int(np.asarray(carry_j["t"])) == 40
    # embers flew and the fire spread across shard rows during the window
    assert stats_t[:, 6].sum() > 0
    assert stats_t[-1, 2] > stats_t[0, 2]
    state = carry_t["state"].numpy()
    burnt = (state != carry0["state"]) & ((state == tff.FIRE)
                                           | (state == tff.ASH))
    assert len({int(r) // 20 for r in np.nonzero(burnt.any(axis=1))[0]}) > 2


def test_ca_sharding_rejects_an_indivisible_grid():
    mesh = pb.make_mesh(8, axis_names=("sp",), devices=CPU8)
    with pytest.raises(ValueError, match="divide"):
        ca.sharded_sim_fn(tff.ModelParams(h=150), 1, 4, mesh)
    with pytest.raises(ValueError, match="divide"):
        ca.simulate_sharded(tff.ModelParams(w=8, h=12),
                            tff.init_state(tff.ModelParams(w=8, h=12)), 1,
                            mesh, seed=1)


def test_ca_shard_error_stops_every_shard():
    """A shard that raises breaks the barrier: the others stop at their
    next collective and the first error comes out."""
    params = tff.ModelParams(w=16, h=16)
    carry = tff.init_state(params, seed=1)
    mesh = pb.make_mesh(4, axis_names=("sp",), devices=CPU8)
    real = ca.ShardSpatial.ember_arrivals

    def flaky(self, *a):
        if self.index == 2:
            raise RuntimeError("shard 2 failed")
        return real(self, *a)

    with mock.patch.object(ca.ShardSpatial, "ember_arrivals", flaky):
        with pytest.raises(RuntimeError, match="shard 2 failed"):
            ca.simulate_sharded(params, carry, 3, mesh, seed=1)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_8_cpu_shards():
    res = dryrun.dryrun_multichip(8, devices=CPU8)
    assert set(res) == {"microsound", "tape", "scrub", "patternlab", "grid",
                        "timeline", "forestfire_ca"}
    assert all(v.startswith("ok") for v in res.values()), res

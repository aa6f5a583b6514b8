"""The port's public helpers that mirror the JAX package's, each held
bit-equal to its JAX original on seeded NumPy inputs, on the CPU:

- ``ops/fixq.py``: ``to_fix`` / ``to_fix_np`` (ties at half a unit
  included), ``inc_fix`` / ``inc_fix_np``, ``fix_to_f32`` and the
  sequential oracle ``segmented_pos_cumsum_np``;
- ``ops/noise.py``: ``uniform_signed`` / ``uniform_signed_np``;
- ``utils/music.py``: ``quantize_to_bits_np``, the f64 reference
  quantizer;
- ``models/microsound.py``: ``build_program_seq``, the scalar per-event
  twin, array for array against JAX's twin and the port's vectorized
  ``build_program`` (the cases of ``tests/test_microsound.py:340-378``);
- ``parallel/distributed.py``: ``put_global_batch`` on a one-process CPU
  mesh against JAX's on conftest's eight virtual devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.ops import fixq as jfq
from audio_suite_tpu.ops import noise as jnoise
from audio_suite_tpu.parallel import distributed as jdist
from audio_suite_tpu.utils import music as jmusic
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.ops import fixq as tfq
from audio_suite_torch.ops import noise as tnoise
from audio_suite_torch.parallel import distributed as tdist
from audio_suite_torch.utils import music as tmusic

import test_microsound

N = 1 << 16


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _fix_inputs(seed):
    """Values within to_fix's int32 range (|x| < 512), with exact ties at
    half a fixed-point unit and signed zeros."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-511.0, 511.0, N).astype(np.float32)
    k = rng.integers(-2 ** 20, 2 ** 20, 64)
    x[:64] = ((k + 0.5) / tfq.POS_ONE).astype(np.float32)
    x[64:66] = [0.0, -0.0]
    return x


@pytest.mark.parametrize("seed", [1, 2])
def test_to_fix_bit_equal(seed):
    x = _fix_inputs(seed)
    got = tfq.to_fix(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(jax.jit(jfq.to_fix)(x))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tfq.to_fix_np(x), jfq.to_fix_np(x))
    assert np.array_equal(tfq.to_fix_np(x), want)
    # a host value with an explicit device
    assert np.array_equal(tfq.to_fix(x, device="cpu").numpy(), want)
    with pytest.raises(TypeError):
        tfq.to_fix(x)


@pytest.mark.parametrize("speed", [1.0, -0.37, 3.999, 0.25])
def test_inc_fix_bit_equal(speed):
    rng = np.random.default_rng(int(abs(speed) * 1000))
    speed_q = jfq.quantize_f32_np(np.float32(speed))
    mod_q = jfq.quantize_f32_np(rng.uniform(0.9, 1.1, N).astype(np.float32))
    want = np.asarray(jax.jit(jfq.inc_fix)(speed_q, mod_q))
    got = tfq.inc_fix(torch.tensor(speed_q), torch.from_numpy(mod_q))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tfq.inc_fix(speed_q, mod_q, device="cpu").numpy(),
                          want)
    assert np.array_equal(tfq.inc_fix_np(speed_q, mod_q), want)
    assert np.array_equal(tfq.inc_fix_np(speed_q, mod_q),
                          jfq.inc_fix_np(speed_q, mod_q))


def test_fix_to_f32_bit_equal():
    rng = np.random.default_rng(5)
    whole = rng.integers(-2 ** 24, 2 ** 24, N).astype(np.int32)
    whole[:8] = [0, -1, 1, 2 ** 23, -2 ** 23, 2 ** 30, -2 ** 31, 2 ** 31 - 1]
    frac = rng.integers(0, tfq.POS_ONE, N).astype(np.int32)
    want = np.asarray(jax.jit(jfq.fix_to_f32)(whole, frac))
    got = tfq.fix_to_f32(torch.from_numpy(whole), torch.from_numpy(frac))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert np.array_equal(_bits(tfq.fix_to_f32(whole, frac,
                                               device="cpu").numpy()),
                          _bits(want))


@pytest.mark.parametrize("init", [(0, 0), (7, 4194303), (-3, 12)])
def test_segmented_pos_cumsum_np_bit_equal(init):
    rng = np.random.default_rng(init[0] + 10)
    n = 20000
    inc = rng.integers(-2 * tfq.POS_ONE, 4 * tfq.POS_ONE, n).astype(np.int32)
    reset = rng.random(n) < 2e-3
    reset[0] = init == (0, 0)
    got = tfq.segmented_pos_cumsum_np(inc, reset, *init)
    want = jfq.segmented_pos_cumsum_np(inc, reset, *init)
    dev = tfq.segmented_pos_cumsum(torch.from_numpy(inc),
                                   torch.from_numpy(reset), *init)
    for g, w, d in zip(got, want, dev):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g, w)
        assert np.array_equal(g, d.numpy())


@pytest.mark.parametrize("seed,stream", [(0, 0), (12345, 3),
                                         (2 ** 32 - 1, 7)])
def test_uniform_signed_bit_equal(seed, stream):
    idx = np.arange(N, dtype=np.int64) * 7 + 11
    want = np.asarray(jax.jit(jnoise.uniform_signed, static_argnums=2)(
        np.uint32(seed), idx.astype(np.uint32), stream))
    got = tnoise.uniform_signed(seed, torch.from_numpy(idx), stream)
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    got_np = tnoise.uniform_signed_np(seed, idx.astype(np.uint32), stream)
    assert np.array_equal(_bits(got_np), _bits(want))
    assert np.array_equal(_bits(got_np), _bits(jnoise.uniform_signed_np(
        seed, idx.astype(np.uint32), stream)))
    assert got_np.min() >= -1.0 and got_np.max() < 1.0


@pytest.mark.parametrize("bits", [2, 4, 8, 14, 16])
def test_quantize_to_bits_np_bit_equal(bits):
    rng = np.random.default_rng(bits)
    x = rng.uniform(-1.3, 1.3, N).astype(np.float32)
    x[:4] = [-1.0, 1.0, 0.0, -0.0]
    got = tmusic.quantize_to_bits_np(x, bits)
    want = jmusic.quantize_to_bits_np(x, bits)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    # f64 on the way: it differs from the f32 twin at some bit depths
    assert np.abs(got - tmusic.quantize_to_bits_f32_np(x, bits)).max() \
        <= 2.0 ** -23


def _seq_cases():
    cases = [dict(gen_mode=m) for m in jms.GEN_MODES]
    cases += [
        dict(gen_mode="Gaussian click", bp_density="0:18, 0.2:40, 0.4:14",
             bp_unfold="0:2, 0.3:8", bp_cutoff="0:3000, 0.4:800",
             bp_stretch="0:1.0, 0.2:2.5"),
        dict(gen_mode="Resonant strike", res_bank_on=True, wg_on=True),
        dict(gen_mode="Noise burst", grain_offset_on=False),
        dict(gen_mode="Noise burst", grain_offset_max_ms=0.0),
        dict(gen_mode="Dust impulses", event_process="Clustered"),
        dict(gen_mode="Crackle / corona", event_process="Hawkes"),
        dict(gen_mode="Noise burst", event_process="Single"),
        dict(gen_mode="Noise burst", out_dur_s=0.05),
        dict(gen_mode="IR fragment", no_ir=True),
    ]
    return cases


def _assert_same_program(a, b, case):
    assert set(a) == set(b), case
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (case, k)
            assert np.array_equal(a[k], b[k]), (case, k)
        else:
            assert a[k] == b[k], (case, k)


@pytest.mark.parametrize("case", _seq_cases(),
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_build_program_seq_matches_jax(case):
    """tests/test_microsound.py:340-378's cases: the port's scalar twin
    equals JAX's twin array for array, and the port's vectorized
    build_program."""
    case = dict(case)
    no_ir = case.pop("no_ir", False)
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(4096)
          * np.exp(-np.arange(4096) / 800.0)).astype(np.float32)
    img = rng.uniform(0, 255, (32, 200)).astype(np.uint8)
    pj = test_microsound.small_params(**case)
    pt = tms.MicrosoundParams.from_dict(pj.to_dict())
    kw = {}
    if case["gen_mode"] == "IR fragment" and not no_ir:
        kw["ir_audio"] = ir
    if case["gen_mode"] == "Image scanline":
        kw["img_gray"] = img
    got = tms.build_program_seq(pt, **kw)
    _assert_same_program(got, jms.build_program_seq(pj, **kw), case)
    _assert_same_program(got, tms.build_program(pt, **kw), case)


def test_put_global_batch_matches_jax():
    """A one-process mesh of eight devices: each device's block of the
    port's batch equals the shard JAX places on the matching device."""
    jmesh = jdist.make_global_mesh()
    n = jmesh.devices.size
    assert jmesh.devices.shape == (1, n) and n >= 2
    rng = np.random.default_rng(3)
    tree = (rng.standard_normal((4 * n, 5)).astype(np.float32),
            np.arange(4 * n, dtype=np.int32))
    jtree = jdist.put_global_batch(jmesh, tree)
    tmesh = tdist.make_global_mesh(devices=["cpu"] * n)
    blocks = tdist.put_global_batch(tmesh, tree)
    assert len(blocks) == n
    order = {d: i for i, d in enumerate(jmesh.devices.reshape(-1))}
    for leaf, (jx, want) in enumerate(zip(jtree, tree)):
        assert np.array_equal(np.asarray(jx), want)
        shards = sorted(jx.addressable_shards, key=lambda s: order[s.device])
        for i, sh in enumerate(shards):
            got = blocks[i][leaf]
            assert got.device.type == "cpu"
            assert np.array_equal(got.numpy(), np.asarray(sh.data))
    with pytest.raises(ValueError):
        tdist.put_global_batch(tmesh, (np.zeros(n + 1, np.float32),))


def test_put_global_batch_feeds_the_batch_render():
    """distributed_batch_render takes its blocks from put_global_batch:
    the one-process render equals the job run one by one."""
    mesh = tdist.make_global_mesh(devices=["cpu"] * 4)
    amps = np.linspace(0.1, 1.0, 8).astype(np.float32)

    def job(a):
        return a * torch.arange(16, dtype=torch.float32, device=a.device)

    got = tdist.distributed_batch_render(job, (amps,), mesh)
    want = amps[:, None] * np.arange(16, dtype=np.float32)
    assert np.array_equal(got, want)
    jgot = jdist.distributed_batch_render(
        lambda a: a * jnp.arange(16, dtype=jnp.float32), (amps,))
    assert np.array_equal(got, jgot)

"""The port's ops held against the JAX package's, on identical inputs made
from a seed with NumPy.

Bit-exact: the counter noise (against JAX and the NumPy twins), the plain
overlap-add (against ``pallas_oa.overlap_add_dus``, the path JAX takes off
the TPU) and the host tables.  Float ops that pass through an FFT or a
transcendental: at most -100 dB relative to the reference's peak — the
two frameworks' FFTs and pow/exp/cos round differently in the last ulp.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_suite_tpu.ops import envelopes as j_env
from audio_suite_tpu.ops import generators as j_gen
from audio_suite_tpu.ops import noise as j_noise
from audio_suite_tpu.ops import pallas_oa as j_oa
from audio_suite_tpu.ops import space as j_space
from audio_suite_tpu.ops import spectral as j_spec
from audio_suite_torch.ops import envelopes, exact_dft, generators, noise
from audio_suite_torch.ops import overlap_add as oa
from audio_suite_torch.ops import space, spectral

torch.set_num_threads(1)

TOL_DB = -100.0


def _dev_db(ref, got):
    """max |got - ref| in dB relative to the reference's peak."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    dev = np.max(np.abs(got - ref))
    return 20.0 * np.log10(max(dev, 1e-300) / np.max(np.abs(ref)))


# ---------------------------------------------------------------- noise

# indices spread over the whole uint32 range: 2**20 of them
_IDX = (np.arange(1 << 20, dtype=np.uint64) * np.uint64(4093)
        + np.uint64(0xFFF00000)) % np.uint64(1 << 32)


@pytest.mark.parametrize("seed,stream", [(0, 0), (5, 5), (12345, 3),
                                         (2 ** 31 - 1, 0)])
def test_noise_bit_exact(seed, stream):
    idx_u32 = _IDX.astype(np.uint32)
    idx_t = torch.tensor(_IDX.astype(np.int64))
    h = noise.hash_u32(seed, idx_t, stream).numpy()
    assert h.min() >= 0 and h.max() < 2 ** 32
    h_np = j_noise.hash_u32_np(np.uint32(seed), idx_u32, stream)
    h_jax = np.asarray(j_noise.hash_u32(seed, jnp.asarray(idx_u32), stream))
    np.testing.assert_array_equal(h, h_np.astype(np.int64))
    np.testing.assert_array_equal(h, h_jax.astype(np.int64))

    u = noise.uniform(seed, idx_t, stream).numpy()
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, j_noise.uniform_np(np.uint32(seed),
                                                        idx_u32, stream))
    np.testing.assert_array_equal(u, np.asarray(j_noise.uniform(
        seed, jnp.asarray(idx_u32), stream)))

    g = noise.normal(seed, idx_t, stream).numpy()
    assert g.dtype == np.float32
    np.testing.assert_array_equal(g, j_noise.normal_np(np.uint32(seed),
                                                       idx_u32, stream))
    np.testing.assert_array_equal(g, np.asarray(j_noise.normal(
        seed, jnp.asarray(idx_u32), stream)))


def test_noise_broadcasts_per_event_seeds():
    """[E, 1] seeds against [nf] bins, as the grain spectrum draw uses."""
    seeds = np.array([5, 6, 700, 2 ** 30], np.int32)
    k = np.arange(4801, dtype=np.int32)
    got = noise.normal(torch.tensor(seeds)[:, None], torch.tensor(k), 5)
    want = j_noise.normal(jnp.asarray(seeds)[:, None], jnp.asarray(k), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- overlap-add

def _oa_case(seed, E, Lw, N):
    """Windows, unsorted starts (some needing the clamp) and a non-zero
    base buffer."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((E, Lw)).astype(np.float32)
    starts = rng.integers(-Lw // 2, N - Lw // 2, size=E).astype(np.int32)
    starts[:3] = [-17, N - Lw + 5, N + 3]        # below 0 and past N - Lw
    base = rng.standard_normal(N).astype(np.float32)
    return vals, starts, base


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_add_plain_bit_exact_vs_dus(seed):
    # the smoke render's OA shapes: 24 windows of 5 120 into 57 344
    vals, starts, base = _oa_case(seed, 24, 5120, 57344)
    assert np.any(np.diff(starts) < 0)
    want = np.asarray(j_oa.overlap_add_dus(jnp.asarray(base),
                                           jnp.asarray(vals),
                                           jnp.asarray(starts)))
    got = oa.overlap_add_plain(torch.tensor(base), torch.tensor(vals),
                               torch.tensor(starts))
    np.testing.assert_array_equal(got.numpy(), want)
    # the device dispatch takes the plain version for CPU tensors, in place
    out = torch.tensor(base)
    assert oa.overlap_add(out, torch.tensor(vals),
                          torch.tensor(starts)) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_overlap_add_rejects_bad_input():
    out = torch.zeros(100)
    with pytest.raises(ValueError):
        oa.overlap_add(out, torch.zeros(2, 200), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        oa.overlap_add(out, torch.zeros(2, 10), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        oa.overlap_add(out, torch.zeros(2, 10, dtype=torch.float64),
                       torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("out_n,L", [(24000, 8192), (768000, 32768),
                                     (3200, 64)])
def test_ring_out_len_matches(out_n, L):
    assert oa.ring_out_len(out_n, L) == j_oa.ring_out_len(out_n, L)


# ---------------------------------------------------------------- exact DFT

@pytest.mark.parametrize("n", [4800, 4801, 64])
def test_irfft_n_discards_hermitian_edge_imaginary(n):
    rng = np.random.default_rng(n)
    nf = n // 2 + 1
    Z = (rng.standard_normal(nf) + 1j * rng.standard_normal(nf)) \
        .astype(np.complex64)
    got = exact_dft.irfft_n(torch.tensor(Z), n, out_len=n + 100).numpy()
    want = np.fft.irfft(Z.astype(np.complex128), n=n)
    assert np.all(got[n:] == 0.0)
    assert _dev_db(want, got[:n]) <= TOL_DB


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize("n,L", [(4800, 8192), (384, 512)])
def test_gen_basic_noise_burst(n, L):
    seeds = np.array([5, 6, 7, 91], np.int32)
    gen_sr = np.float32(n * 1000.0)                  # micro_ms = 1.0
    inv = np.float32(1.0) / gen_sr
    i = np.arange(L, dtype=np.int32)

    def one(s):
        return j_gen.gen_basic(jnp.asarray(i), jnp.int32(n), s, gen_sr, inv,
                               1.0, 2, jnp.zeros(1, jnp.int32),
                               jnp.zeros(1, jnp.float32), jnp.int32(0),
                               jnp.int32(8), -3.0, 4200.0, 12.0,
                               dust_kmax=8, n_fft=n)

    want = np.asarray(jax.vmap(one)(jnp.asarray(seeds)))
    E = len(seeds)
    got = generators.gen_basic(torch.arange(L), torch.full((E,), n),
                               torch.tensor(seeds), torch.full((E,), inv),
                               1.0, generators.NOISE_BURST, -3.0, n).numpy()
    assert np.all(got[:, n:] == 0.0)
    assert _dev_db(want, got) <= TOL_DB


def test_gen_basic_other_modes_raise():
    """The gen_basic modes other than "Noise burst", which raised before
    the whole of Microsound was ported (the name is kept): Gaussian click,
    skewed transient and resonant strike against JAX's gen_basic (dust
    impulses need host draws: tests/test_torch_microsound_modes.py)."""
    n, L = 384, 512
    seeds = np.array([5, 6, 7], np.int32)
    gen_sr = np.float32(n * 1000.0 / 4.0)             # micro_ms = 4.0
    inv = np.float32(1.0) / gen_sr
    i = np.arange(L, dtype=np.int32)
    for mode in (0, 3, 4):
        def one(s):
            return j_gen.gen_basic(jnp.asarray(i), jnp.int32(n), s, gen_sr,
                                   inv, 4.0, mode, jnp.zeros(1, jnp.int32),
                                   jnp.zeros(1, jnp.float32), jnp.int32(0),
                                   jnp.int32(8), -3.0, 4200.0, 12.0,
                                   dust_kmax=8, n_fft=n)

        want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(seeds)))
        got = generators.gen_basic(torch.arange(L), torch.full((3,), n),
                                   torch.tensor(seeds), torch.full((3,), inv),
                                   4.0, mode, -3.0, n).numpy()
        assert np.all(got[:, n:] == 0.0)
        assert _dev_db(want, got) <= TOL_DB, mode


# ---------------------------------------------------------------- spectral

def _grain_bank(E, L, n, seed=3):
    x = np.random.default_rng(seed).standard_normal((E, L)).astype(np.float32)
    x[:, n:] = 0.0
    return x


@pytest.mark.parametrize("factor,shared_gain", [(4.0, True), (4.0, False),
                                                (1.0, True), (0.5, False)])
def test_lowpass_stretch_fused_shared(factor, shared_gain):
    E, L, n = 5, 8192, 4800
    x = _grain_bank(E, L, n)
    sr_v = np.full(E, 4.8e6, np.float32)
    cut_v = np.full(E, 1.8e6, np.float32)
    if not shared_gain:
        sr_v = sr_v * np.linspace(0.5, 1.0, E).astype(np.float32)
        cut_v = cut_v * np.linspace(0.3, 1.2, E).astype(np.float32)
    want = np.asarray(j_spec.lowpass_stretch_fused_shared(
        jnp.asarray(x), sr_v, cut_v, np.float32(factor), roll=2.5e5,
        max_scale=max(0.25, 1.0 / factor), shared_gain=shared_gain,
        n_fft=n))
    got = spectral.lowpass_stretch_fused_shared(
        torch.tensor(x), torch.tensor(sr_v), torch.tensor(cut_v),
        torch.tensor(np.float32(factor)), roll=2.5e5,
        shared_gain=shared_gain, n_fft=n).numpy()
    assert np.all(got[:, n:] == 0.0)
    assert _dev_db(want, got) <= TOL_DB


@pytest.mark.parametrize("factor,roll", [(1.5, 2500.0), (0.7, 0.0)])
def test_lowpass_stretch_fused_single_event(factor, roll):
    x = _grain_bank(1, 512, 384)[0]
    want = np.asarray(j_spec.lowpass_stretch_fused(
        jnp.asarray(x), 16000.0, 6000.0, factor, roll=roll, n_fft=384))
    got = spectral.lowpass_stretch_fused(torch.tensor(x), 16000.0, 6000.0,
                                         factor, roll=roll, n_fft=384)
    assert _dev_db(want, got.numpy()) <= TOL_DB


def test_lowpass_fft():
    x = _grain_bank(3, 2048, 1500)
    want = np.asarray(j_spec.lowpass_fft(jnp.asarray(x), 48000.0, 9000.0,
                                         roll=1500.0, n_fft=1500))
    got = spectral.lowpass_fft(torch.tensor(x), 48000.0, 9000.0,
                               roll=1500.0, n_fft=1500).numpy()
    assert _dev_db(want, got) <= TOL_DB


# ---------------------------------------------------------------- space

def test_er_tap_kernel_and_diffusion_taps_equal():
    np.testing.assert_array_equal(space.er_tap_kernel(320, 45.0, 48000, 5),
                                  j_space.er_tap_kernel(320, 45.0, 48000, 5))
    for phi in (0.585, 0.0, 0.9):
        assert space._diffusion_taps(phi) == j_space._diffusion_taps(phi)


@pytest.mark.parametrize("taps,max_ms,sr", [
    (320, 45.0, 192000),       # config 3: the benchmark's Microsound cells
    (24, 0.31, 8000),          # offsets of 0 (dropped) and stacked taps
    (4000, 2.0, 48000),        # many taps a tap slot: the order of the adds
    (1, 120.0, 384000)])
def test_er_tap_kernel_equal_on_many_seeds(taps, max_ms, sr):
    """The port's vectorized tap sum against the JAX package's loop."""
    for seed in np.random.default_rng(taps).integers(0, 2 ** 31, 40):
        want = j_space.er_tap_kernel(taps, max_ms, sr, int(seed))
        got = space.er_tap_kernel(taps, max_ms, sr, int(seed))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("N,K", [(24000, 10353), (3200, 122), (5000, 1)])
def test_fft_convolve_causal(N, K):
    rng = np.random.default_rng(N + K)
    x = rng.standard_normal(N).astype(np.float32)
    k = (rng.standard_normal(K) * np.exp(-np.arange(K) / 300.0)) \
        .astype(np.float32)
    want = np.asarray(j_space.fft_convolve_causal(jnp.asarray(x),
                                                  jnp.asarray(k)))
    got = space.fft_convolve_causal(torch.tensor(x), torch.tensor(k)).numpy()
    assert _dev_db(want, got) <= TOL_DB


@pytest.mark.parametrize("n,width", [(24000, 0.65), (3200, 1.0), (40, 0.5)])
def test_spectral_diffusion_stereo(n, width):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = np.asarray(j_space.spectral_diffusion_stereo(jnp.asarray(x),
                                                        48000, width))
    got = space.spectral_diffusion_stereo(torch.tensor(x), 48000,
                                          width).numpy()
    assert got.shape == (n, 2)
    assert _dev_db(want, got) <= TOL_DB


@pytest.mark.parametrize("n,sr,a,d,s,r,curve", [
    (24000, 48000, 20.0, 250.0, 0.65, 1800.0, 1.8),
    (768000, 192000, 20.0, 250.0, 0.65, 1800.0, 1.8),
    (3200, 8000, 0.0, 30.0, 1.3, 0.0, 0.5),
    (500, 8000, 200.0, 0.0, 0.2, 10.0, 3.0),
])
def test_make_adsr(n, sr, a, d, s, r, curve):
    want = np.asarray(j_env.make_adsr(n, sr, a, d, s, r, curve))
    got = envelopes.make_adsr(n, sr, a, d, s, r, curve).numpy()
    assert got.dtype == np.float32
    assert _dev_db(want, got) <= TOL_DB


@pytest.mark.parametrize("drive,peak", [(1.0, 0.98), (2.5, 0.5), (0.0, 1.0)])
def test_soft_clip_and_normalize(drive, peak):
    x = (np.random.default_rng(7).standard_normal((4000, 2)) * 0.7) \
        .astype(np.float32)
    want = np.asarray(j_space.normalize(
        j_space.soft_clip(jnp.asarray(x), drive), peak))
    got = space.normalize(space.soft_clip(torch.tensor(x), drive),
                          peak).numpy()
    assert _dev_db(want, got) <= TOL_DB
    silent = space.normalize(torch.zeros(8, 2), peak)
    assert torch.equal(silent, torch.zeros(8, 2))

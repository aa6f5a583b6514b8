"""The port's Microsound grain chain held against the JAX package.

- each spectral function against JAX's, vmapped over a grain bank, with
  the transform at the exact grain length and at the padded length, at
  -100 dB of the reference's peak (pocketfft / MKL against XLA's FFT, and
  exp / cos / log in the last ulp);
- ``grain_chain_exact`` with each stage alone and all together, and the
  partial lock on a grain with fewer non-zero bins than ``pl_top_n``;
- the fixtures of tests/test_microsound.py:100-182 (warps, partial lock,
  resonator and waveguide, multi-band unfold, feedback and imprint,
  breakpoint lanes, chunked against unchunked, IR and Hawkes, Single and
  Clustered), each rendered within -100 dBFS of JAX's ``render``, and in
  PCM16 within 1 LSB;
- the ``microsound_chaos`` and ``microsound_cepstral`` golden fingerprints
  of tests/test_goldens.py on the port;
- ``save_preset`` / ``load_preset`` round trips with JAX's, and
  ``meta["micro_last"]`` against JAX's.

The padded-length chain with the cepstral warp on (mixed grain lengths
and ``cep_warp_on``) is not held at -100 dBFS: it reads the phase of the
lowpass's stop band after an irfft / rfft round trip, which is FFT
round-off and differs between backends (ROADMAP.md §3).  Its test is a
witness of that instead: jitted JAX and JAX run op by op disagree there
as far as the port disagrees with either.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.ops import spectral as j_spec
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.ops import spectral

from test_goldens import GOLDEN_PATH, SR, _compare, _fingerprint
from test_torch_microsound_modes import _dbfs, _dev_db, _params

torch.set_num_threads(1)

TOL_DB = -100.0

def _bank(E, L, n, seed=3, cutoff_bins=None):
    """A bank of E random grains of true length n in L samples; with
    ``cutoff_bins`` lowpassed to that many bins at length n."""
    x = np.random.default_rng(seed).standard_normal((E, L))
    if cutoff_bins is not None:
        X = np.fft.rfft(x[:, :n], axis=-1)
        X[:, cutoff_bins:] = 0.0
        x[:, :n] = np.fft.irfft(X, n=n, axis=-1)
    x[:, n:] = 0.0
    return x.astype(np.float32)


_SR = np.array([16000.0, 24000.0, 12000.0, 16000.0], np.float32)
_STRETCH = np.array([1.7, 0.6, 1.0, 2.5], np.float32)


def _vmap_jax(fn, x, *per_event):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(x),
                                           *map(jnp.asarray, per_event)))


# ---------------------------------------------------------------- spectral

@pytest.mark.parametrize("n_fft", [200, None])
def test_bandpass_fft(n_fft):
    x = _bank(4, 256, 200)
    for lo, hi, roll in [(500.0, 3000.0, 300.0), (0.0, 2000.0, 0.0),
                         (1000.0, 20000.0, 500.0), (0.0, -5.0, 200.0)]:
        want = _vmap_jax(lambda r, s: j_spec.bandpass_fft(
            r, s, lo, hi, roll=roll, n_fft=n_fft), x, _SR)
        got = spectral.bandpass_fft(torch.tensor(x), torch.tensor(_SR)[:, None],
                                    lo, hi, roll=roll, n_fft=n_fft).numpy()
        if hi <= 0:
            assert np.all(got == 0.0) and np.all(want == 0.0)
        else:
            assert _dev_db(want, got) <= TOL_DB, (lo, hi, roll)


@pytest.mark.parametrize("n_fft", [200, None])
@pytest.mark.parametrize("power", [1.25, 0.7])
def test_fft_warp_power(n_fft, power):
    x = _bank(4, 256, 200)
    want = _vmap_jax(lambda r: j_spec.fft_warp_power(r, power, n_fft=n_fft),
                     x)
    got = spectral.fft_warp_power(torch.tensor(x), power, n_fft=n_fft)
    assert _dev_db(want, got.numpy()) <= TOL_DB


@pytest.mark.parametrize("n_fft", [200, None])
@pytest.mark.parametrize("factor", [1.2, 0.8])
def test_cepstral_warp(n_fft, factor):
    x = _bank(4, 256, 200)
    want = _vmap_jax(lambda r: j_spec.cepstral_warp(r, factor, n_fft=n_fft),
                     x)
    got = spectral.cepstral_warp(torch.tensor(x), factor, n_fft=n_fft)
    assert _dev_db(want, got.numpy()) <= TOL_DB


@pytest.mark.parametrize("n_fft", [200, None])
def test_fft_partial_stretch_and_fused(n_fft):
    x = _bank(4, 256, 200)
    want = _vmap_jax(lambda r, f: j_spec.fft_partial_stretch(r, f,
                                                             n_fft=n_fft),
                     x, _STRETCH)
    got = spectral.fft_partial_stretch(torch.tensor(x),
                                       torch.tensor(_STRETCH)[:, None],
                                       n_fft=n_fft).numpy()
    np.testing.assert_array_equal(got[2], x[2])      # factor 1: the input
    assert _dev_db(want, got) <= TOL_DB
    cut = np.array([3000.0, 5000.0, 2000.0, 7000.0], np.float32)
    want = _vmap_jax(lambda r, s, c, f: j_spec.lowpass_stretch_fused(
        r, s, c, f, roll=500.0, n_fft=n_fft), x, _SR, cut, _STRETCH)
    got = spectral.lowpass_stretch_fused(
        torch.tensor(x), torch.tensor(_SR)[:, None], torch.tensor(cut)[:, None],
        torch.tensor(_STRETCH)[:, None], roll=500.0, n_fft=n_fft).numpy()
    assert _dev_db(want, got) <= TOL_DB


@pytest.mark.parametrize("n_fft", [200, None])
@pytest.mark.parametrize("top_n,neigh", [(24, 4), (12, 3)])
def test_partial_lock_stretch(n_fft, top_n, neigh):
    """Factors below 1 send several peaks to one bin: the spreads add in
    JAX's order through ordered_scatter_add."""
    x = _bank(4, 256, 200)
    f = np.array([0.3, 1.7, 1.0, 0.55], np.float32)
    want = _vmap_jax(lambda r, ff: j_spec.partial_lock_stretch(
        r, ff, top_n=top_n, neighborhood=neigh, n_fft=n_fft), x, f)
    for passes in (None, spectral.lock_passes(float(f.min()), top_n)):
        got = spectral.partial_lock_stretch(
            torch.tensor(x), torch.tensor(f)[:, None], top_n=top_n,
            neighborhood=neigh, n_fft=n_fft, passes=passes).numpy()
        np.testing.assert_array_equal(got[2], x[2])
        assert _dev_db(want, got) <= TOL_DB


def test_lock_with_fewer_nonzero_bins_than_top_n():
    """The exact chain's hard lowpass (roll 0) at 1 250 Hz of 16 kHz leaves
    bins 1-10 non-zero and every bin above them an exact zero: top_n 24
    picks 14 tied zero bins.  torch.topk and lax.top_k may pick other ones;
    a peak whose X is 0 adds nothing to any bin."""
    x = _bank(3, 128, 128)
    f = np.array([1.5, 0.7, 2.0], np.float32)
    want = _vmap_jax(lambda r, ff: j_spec.grain_chain_exact(
        r, 16000.0, 128, cutoff=1250.0, roll=0.0, lock=(24, 4), stretch=ff),
        x, f)
    got = spectral.grain_chain_exact(torch.tensor(x), 16000.0, 128,
                                     cutoff=1250.0, roll=0.0, lock=(24, 4),
                                     stretch=torch.tensor(f)[:, None])
    X = torch.fft.rfft(torch.tensor(x), dim=-1) \
        * spectral._lowpass_gain(128, 16000.0, 1250.0, 0.0)
    assert int((X[0].abs() > 0).sum()) == 11 < 24
    assert _dev_db(want, got.numpy()) <= TOL_DB


def test_lerp_uniform_and_interp_spectrum():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((3, 40)).astype(np.float32)
    Z = (rng.standard_normal((3, 40))
         + 1j * rng.standard_normal((3, 40))).astype(np.complex64)
    pos = rng.uniform(-3.0, 43.0, (3, 55)).astype(np.float32)
    pos[:, :3] = [0.0, 39.0, 38.5]
    # jitted XLA may contract the lerp's multiply-add: an ulp apart
    want = _vmap_jax(j_spec._lerp_uniform, y, pos)
    got = spectral._lerp_uniform(torch.tensor(y), torch.tensor(pos))
    assert np.all(got.numpy()[pos < 0] == 0.0)
    assert _dev_db(want, got.numpy()) <= -130.0
    want = _vmap_jax(j_spec._interp_spectrum, Z, pos)
    got = spectral._interp_spectrum(torch.tensor(Z), torch.tensor(pos))
    assert _dev_db(want.view(np.float32),
                   got.numpy().view(np.float32)) <= -130.0


@pytest.mark.parametrize("n_fft", [200, None])
def test_multiband_unfold(n_fft):
    x = _bank(4, 256, 200)
    bands = ((0.0, 500.0), (500.0, 1500.0), (1500.0, 3500.0))
    unfolds = (3.0, 2.0, 1.5)
    want = _vmap_jax(lambda r, s: j_spec.multiband_unfold(
        r, s, bands, unfolds, roll_hz=200.0, n_fft=n_fft), x, _SR)
    got = spectral.multiband_unfold(torch.tensor(x),
                                    torch.tensor(_SR)[:, None], bands,
                                    unfolds, roll_hz=200.0, n_fft=n_fft)
    assert _dev_db(want, got.numpy()) <= TOL_DB


@pytest.mark.parametrize("n", [1500, 9000])
def test_stft_mag_db(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = np.asarray(j_spec.stft_mag_db(x, 8000, win=2048, hop=256))
    got = spectral.stft_mag_db(x, 8000, win=2048, hop=256).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-3       # dB


def test_spectral_imprint_scan():
    """JAX evaluates the EMA as an associative scan, the port in event
    order: the products round in another order (f32, ~1e-7 relative)."""
    mags = np.abs(np.random.default_rng(6).standard_normal((9, 33))) \
        .astype(np.float32)
    want = np.asarray(j_spec.spectral_imprint_scan(jnp.asarray(mags), 0.35,
                                                   0.92))
    got = spectral.spectral_imprint_scan(torch.tensor(mags), 0.35, 0.92)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)


_STAGES = {
    "lowpass": dict(cutoff=True),
    "warp": dict(warp_power=1.4),
    "cepstral": dict(cep_factor=1.3),
    "lock": dict(lock=(12, 3)),
    "stretch": dict(stretch=True),
    "all_lock": dict(cutoff=True, warp_power=1.4, cep_factor=1.3,
                     lock=(12, 3)),
    "all_stretch": dict(cutoff=True, warp_power=1.4, cep_factor=1.3,
                        stretch=True),
}


@pytest.mark.parametrize("stage", list(_STAGES))
def test_grain_chain_exact_stages(stage):
    kw = dict(_STAGES[stage])
    n = 200
    x = _bank(4, 256, n)
    cut = np.array([3000.0, 5000.0, 2000.0, 7000.0], np.float32)
    lock = kw.get("lock")
    use_cut = kw.get("cutoff", False)
    use_stretch = kw.get("stretch", False) or lock is not None

    def jfn(r, s, c, f):
        return j_spec.grain_chain_exact(
            r, s, n, cutoff=c if use_cut else None, roll=500.0,
            warp_power=kw.get("warp_power"), cep_factor=kw.get("cep_factor"),
            lock=lock, stretch=f if use_stretch else None)

    want = _vmap_jax(jfn, x, _SR, cut, _STRETCH)
    got = spectral.grain_chain_exact(
        torch.tensor(x), torch.tensor(_SR)[:, None], n,
        cutoff=torch.tensor(cut)[:, None] if use_cut else None, roll=500.0,
        warp_power=kw.get("warp_power"), cep_factor=kw.get("cep_factor"),
        lock=lock,
        stretch=torch.tensor(_STRETCH)[:, None] if use_stretch else None)
    assert _dev_db(want, got.numpy()) <= TOL_DB, stage


# ---------------------------------------------------------------- renders

_IR_HAWKES = (np.random.default_rng(11).standard_normal(512)
              * np.exp(-np.arange(512) / 64.0)).astype(np.float32)

_FIXTURES = {        # tests/test_microsound.py:100-182
    "warp_chain": dict(gen_mode="Noise burst", nl_warp_on=True,
                       nl_warp_power=1.4, cep_warp_on=True, cep_factor=1.3,
                       partial_stretch=1.7),
    "partial_lock": dict(gen_mode="Resonant strike", ring_hz=700.0,
                         partial_lock_on=True, partial_stretch=2.0,
                         pl_top_n=12, pl_neigh=3),
    "resonator_waveguide": dict(gen_mode="Gaussian click", res_bank_on=True,
                                res_modes=8, res_fmin=100.0, res_fmax=2500.0,
                                res_decay_ms=20.0, wg_on=True, wg_lines=2,
                                wg_max_ms=2.0, wg_fb=0.6,
                                grains_per_sec=10.0, out_dur_s=0.25),
    "multiband": dict(gen_mode="Noise burst",
                      unfold_mode="Multi-band unfold", mb_b1=500.0,
                      mb_b2=1500.0, mb_b3=3500.0, mb_u1=3.0, mb_u2=2.0,
                      mb_u3=1.5, mb_roll=200.0, time_unfold=3.0),
    "feedback_imprint": dict(gen_mode="Noise burst", event_feedback_on=True,
                             event_feedback_amt=0.4,
                             spectral_imprint_on=True,
                             spectral_imprint_amt=0.35,
                             spectral_imprint_smooth=0.9),
    "breakpoint_lanes": dict(gen_mode="Noise burst",
                             bp_density="0:10, 0.2:60, 0.4:20",
                             bp_unfold="0:1.5, 0.4:3",
                             bp_cutoff="0:2000, 0.4:3500",
                             bp_stretch="0:0.8, 0.4:1.6"),
    "ir_hawkes": dict(gen_mode="Gaussian click", event_process="Hawkes",
                      hawkes_gain=0.8, space_ir_on=True,
                      space_ir_max_samps=512),
    "single": dict(gen_mode="Noise burst", event_process="Single"),
    "clustered": dict(gen_mode="Noise burst", event_process="Clustered"),
    # beyond the fixtures: the padded-L lock and mixed lengths with the
    # physical models, and no bandlimit
    "lock_mixed": dict(gen_mode="Resonant strike", ring_hz=700.0,
                       partial_lock_on=True, bp_stretch="0:0.6, 0.4:1.6",
                       bp_unfold="0:1.5, 0.4:3"),
    "mixed_models": dict(gen_mode="Micro-chaos", res_bank_on=True,
                         wg_on=True, wg_lines=3, bp_unfold="0:2, 0.4:3",
                         micro_ms=12.0, grains_per_sec=15.0,
                         bandlimit_on=False),
}


@pytest.mark.parametrize("name", list(_FIXTURES))
def test_fixture_render_matches_jax(name):
    pj, pt = _params(**_FIXTURES[name])
    ir = _IR_HAWKES if name == "ir_hawkes" else None
    want, wmeta = jms.render(pj, ir_audio=ir)
    got, meta = tms.render(pt, ir_audio=ir, device="cpu")
    assert meta["events"] == wmeta["events"] >= 1
    assert np.max(np.abs(want)) > 0.5
    assert _dbfs(want, got.numpy()) <= TOL_DB, name


@pytest.mark.parametrize("seed", [4242, 7, 99])
def test_padded_cepstral_reads_fft_round_off(seed):
    """Mixed grain lengths with the cepstral warp: the reference's own two
    evaluations, jitted and op by op, are further apart than -40 dBFS, and
    the port is no further from the nearer of them than they are from
    each other, within a factor of 2 (6.02 dB).  Without the warp the same
    lanes hold at -100 dBFS (the ``breakpoint_lanes`` fixture)."""
    pj, pt = _params(gen_mode="Noise burst", cep_warp_on=True,
                     cep_factor=1.3, bp_unfold="0:1.5, 0.4:3",
                     bp_stretch="0:0.8, 0.4:1.6", seed=seed, out_dur_s=0.2,
                     max_grains=12)
    jitted, _ = jms.render(pj)
    with jax.disable_jit():
        eager, _ = jms.render(pj)
    got, meta = tms.render(pt, device="cpu")
    assert meta["events"] >= 4
    got = got.numpy()
    spread = _dbfs(jitted, eager)
    assert spread > -40.0
    assert min(_dbfs(jitted, got), _dbfs(eager, got)) <= spread + 6.02


@pytest.mark.parametrize("event_chunk", [3, 4])
def test_chunked_render_matches_unchunked(event_chunk):
    """tests/test_microsound.py:156 with the imprint on as well: the
    feedback / imprint carry crosses the chunks."""
    pj, pt = _params(gen_mode="Gaussian click", event_feedback_on=True,
                     event_feedback_amt=0.3, spectral_imprint_on=True)
    whole, _ = tms.render(pt, device="cpu")
    chunked, meta = tms.render(pt, device="cpu", event_chunk=event_chunk)
    assert meta["events"] > 2 * event_chunk
    assert _dbfs(whole.numpy(), chunked.numpy()) <= TOL_DB
    want, _ = jms.render(pj, event_chunk=event_chunk)
    assert _dbfs(want, chunked.numpy()) <= TOL_DB


@pytest.mark.parametrize("name", ["warp_chain", "feedback_imprint",
                                  "breakpoint_lanes"])
def test_pcm16_within_one_lsb(name):
    pj, pt = _params(**_FIXTURES[name])
    want, _ = jms.render(pj, pcm16=True)
    got, _ = tms.render(pt, device="cpu", pcm16=True)
    assert got.dtype == torch.int16
    lsb = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert lsb.max() <= 1
    assert np.abs(want).max() > 1000


# the golden fixtures' parameters (tests/test_goldens.py:203-229)
_GOLDENS = {
    "microsound_chaos": dict(
        base_sr=SR, out_dur_s=0.4, time_unfold=3.0, micro_ms=8.0,
        gen_mode="Micro-chaos", chaos_r=3.92, chaos_gate=0.35,
        grains_per_sec=15.0, max_grains=12, nl_warp_on=True,
        nl_warp_power=1.25, bandlimit_on=True, bandlimit_out_hz=3000.0,
        bandlimit_roll_hz=500.0, seed=41, er_cloud_on=False, bp_density="",
        bp_unfold="", bp_cutoff="", bp_stretch=""),
    "microsound_cepstral": dict(
        base_sr=SR, out_dur_s=0.4, time_unfold=2.5, micro_ms=6.0,
        gen_mode="Crackle / corona", crackle_density=150.0, cep_warp_on=True,
        cep_factor=1.2, grains_per_sec=20.0, max_grains=12, stereo_on=True,
        stereo_width=0.65, seed=17, er_cloud_on=False, bp_density="",
        bp_unfold="", bp_cutoff="", bp_stretch=""),
}


@pytest.mark.parametrize("key", list(_GOLDENS))
def test_golden_fingerprint(key):
    y, _ = tms.render(tms.MicrosoundParams.from_dict(_GOLDENS[key]),
                      device="cpu")
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[key]
    _compare(key, _fingerprint(y.numpy()), want)


def test_presets_round_trip(tmp_path):
    d = dict(_FIXTURES["resonator_waveguide"], seed=7, sat_drive=1.5)
    pt = tms.MicrosoundParams.from_dict(d)
    tms.save_preset(pt, str(tmp_path / "port.json"))
    pj = jms.load_preset(str(tmp_path / "port.json"))
    assert pj.to_dict() == pt.to_dict()
    jms.save_preset(pj, str(tmp_path / "jax.json"))
    assert (tmp_path / "jax.json").read_text() \
        == (tmp_path / "port.json").read_text()
    assert tms.load_preset(str(tmp_path / "jax.json")).to_dict() \
        == pt.to_dict()
    (tmp_path / "partial.json").write_text(json.dumps(
        {"gen_mode": "Micro-chaos", "wg_lines": 3.0, "unknown": 1}))
    assert tms.load_preset(str(tmp_path / "partial.json")).to_dict() \
        == jms.load_preset(str(tmp_path / "partial.json")).to_dict()


@pytest.mark.parametrize("mode,event_chunk", [
    ("Gaussian click", None), ("Micro-chaos", None), ("Dust impulses", 4),
    ("Crackle / corona", None)])
def test_micro_last_matches_jax(mode, event_chunk):
    pj, pt = _params(gen_mode=mode, micro_ms=8.0, grains_per_sec=20.0)
    _, wmeta = jms.render(pj, want_micro_last=True, event_chunk=event_chunk)
    _, meta = tms.render(pt, device="cpu", want_micro_last=True,
                         event_chunk=event_chunk)
    want = wmeta["micro_last"]
    got = meta["micro_last"].numpy()
    assert got.shape == want.shape
    assert _dev_db(want, got) <= TOL_DB
    # grain_last: the chunk's last grain, a padding event's (all zero)
    # when the chunk is padded
    gl_want = np.asarray(wmeta["grain_last"])
    gl = meta["grain_last"].numpy()
    assert gl.shape == gl_want.shape
    if np.any(gl_want):
        assert _dev_db(gl_want, gl) <= TOL_DB
    else:
        assert not np.any(gl)

"""The shipped Microsound presets (``examples/presets/*.json``) rendered
by the port and by the JAX package, both on the CPU, shrunk as
``tests/test_examples.py:142-144`` shrinks them (16 kHz, 0.5 s, at most
48 grains and 64 ER taps), with the first ``examples/irs/`` WAV wherever a
preset has ``space_ir_on``:

- ``chaos_bloom``, ``corona_tide``, ``ember_strike``, ``glass_rain``,
  ``grain_surf`` and ``shard_echoes`` within -100 dBFS of JAX's render;
- ``bell_imprint`` and ``friction_forest`` with ``res_bank_on`` off, and
  ``wavelet_mist`` with ``cep_warp_on`` off, within -100 dBFS;
- with those options on, the three read the phase or sign of FFT
  round-off (ROADMAP.md section 3): JAX's jitted render and its
  ``jax.disable_jit`` render are themselves further apart than -40 dBFS,
  and the port is no further from the nearer of the two than they are
  from each other, within a factor of 2 (6.02 dB), as
  ``test_padded_cepstral_reads_fft_round_off`` holds the padded chain.

``friction_forest``'s op-by-op render would take ~5 minutes here: JAX's
scan under ``disable_jit`` compiles each step's slice, ~70 ms a step over
4 096 steps.  Its divergence comes from the stick-slip scan alone (with
that scan jitted, the op-by-op render is -118.4 dBFS from the jitted one:
the jitted scan contracts its multiply-adds, ROADMAP.md section 3, and
the resonator's ``sign(x)`` carries the last bit to full scale).  So its
op-by-op render is the jitted render with the scan's output evaluated
one f32 operation at a time (``_stick_slip_op_by_op``: JAX's step,
``generators.py:194-206``, in NumPy f32, each operation rounded once as
``disable_jit`` runs it, from the bit-exact ``noise.normal_np`` draws).
Measured once both ways: 4.50 dBFS between the jitted and the op-by-op
render, and the port 5.18 dBFS from the op-by-op one, with the full
``disable_jit`` render and with this one alike.
"""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.ops import generators as jgen
from audio_suite_tpu.ops import noise as jnoise
from audio_suite_tpu.utils import wavcodec
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from audio_suite_torch.models import microsound as tms

torch.set_num_threads(1)

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "examples")
IRS = sorted(glob.glob(os.path.join(EX, "irs", "*.wav")))
TOL_DB = -100.0
HOLD = ("chaos_bloom", "corona_tide", "ember_strike", "glass_rain",
        "grain_surf", "shard_echoes")
# the option through which each preset reads FFT round-off
ROUND_OFF = {"bell_imprint": "res_bank_on", "friction_forest": "res_bank_on",
             "wavelet_mist": "cep_warp_on"}


def test_every_preset_is_covered():
    names = {os.path.basename(p)[:-5]
             for p in glob.glob(os.path.join(EX, "presets", "*.json"))}
    assert names == set(HOLD) | set(ROUND_OFF)


def _preset(name, **overrides):
    """The preset shrunk as tests/test_examples.py:142-144 does: the JAX
    package's params, the port's, and the IR it asks for."""
    with open(os.path.join(EX, "presets", f"{name}.json")) as f:
        d = json.load(f)
    d.update(base_sr=16000, out_dur_s=0.5, max_grains=48,
             er_taps=min(64, int(d.get("er_taps", 64))), **overrides)
    ir = None
    if d.get("space_ir_on"):
        ir, sr = wavcodec.read_wav(IRS[0])
        assert sr == 48000
    return (jms.MicrosoundParams.from_dict(d),
            tms.MicrosoundParams.from_dict(d), ir)


def _both(name, **overrides):
    pj, pt, ir = _preset(name, **overrides)
    want, meta_j = jms.render(pj, ir_audio=ir)
    got, meta_t = tms.render(pt, ir_audio=ir, device="cpu")
    assert meta_t["events"] == meta_j["events"] > 0
    got = got.numpy()
    assert got.shape == want.shape and got.shape[1] == 2
    assert np.isfinite(got).all() and float(np.abs(got).max()) > 0.01
    return want, got


@pytest.mark.parametrize("name", HOLD)
def test_preset_matches_jax(name):
    want, got = _both(name)
    assert max_dev_dbfs(want, got) <= TOL_DB


@pytest.mark.parametrize("name", sorted(ROUND_OFF))
def test_preset_without_its_round_off_reader_matches_jax(name):
    want, got = _both(name, **{ROUND_OFF[name]: False})
    assert max_dev_dbfs(want, got) <= TOL_DB


def _stick_slip_op_by_op(pj, prog):
    """JAX's ``gen_stick_slip`` whose scan output is evaluated one f32
    operation at a time for every event of ``prog`` (an [E, L] table by
    seed); the hann window and the mask stay JAX's."""
    f32 = np.float32
    thr, build, decay, nz = (f32(v) for v in (pj.ss_threshold, pj.ss_build,
                                              pj.ss_decay, pj.ss_noise))
    seeds = prog["seed"].astype(np.int64)
    L = int(prog["L"])
    i = np.arange(L, dtype=np.uint32)[None, :]
    bn = jnoise.normal_np(seeds[:, None].astype(np.uint32), i,
                          jgen.STREAM_BUILD)
    on = jnoise.normal_np(seeds[:, None].astype(np.uint32), i,
                          jgen.STREAM_OUT)
    sticking = np.ones(len(seeds), bool)
    force = np.zeros(len(seeds), f32)
    xs = np.zeros((len(seeds), L), f32)
    for t in range(L):
        force_stick = force + build * (bn[:, t] * nz + f32(0.2))
        new_sticking_s = np.abs(force_stick) <= thr
        out_slip = force + f32(0.25) * on[:, t]
        force_slip = force * decay
        back_to_stick = np.abs(force_slip) < f32(0.02)
        force_slip = np.where(back_to_stick, f32(0.0), force_slip)
        xs[:, t] = np.where(sticking, f32(0.0), out_slip)
        force = np.where(sticking, force_stick, force_slip)
        sticking = np.where(sticking, new_sticking_s, back_to_stick)
    s0 = int(seeds.min())
    table = np.zeros((int(seeds.max()) - s0 + 1, L), f32)
    table[seeds - s0] = xs
    table = jax.numpy.asarray(table)

    def gen(i, n, seed, threshold, build, decay, noise_amt):
        assert i.shape == (L,)
        x = table[jax.numpy.clip(seed - s0, 0, table.shape[0] - 1)]
        x = x * jgen.hann_t(i, n)
        return jax.numpy.where(i < n, x, 0.0)
    return gen


def _clear_jit_memo():
    jms._fused_fn.cache_clear()
    jms._chunk_fn.cache_clear()


@pytest.mark.parametrize("name", sorted(ROUND_OFF))
def test_preset_round_off_divergence_is_the_references_own(name,
                                                           monkeypatch):
    pj, pt, ir = _preset(name)
    assert getattr(pt, ROUND_OFF[name])
    jitted, _ = jms.render(pj, ir_audio=ir)
    if name == "friction_forest":
        gen = _stick_slip_op_by_op(pj, jms.build_program(pj, ir_audio=ir))
        # the jitted chain is memoized on its config: trace it anew with
        # the patched scan, and drop that trace afterwards
        with monkeypatch.context() as m:
            m.setattr(jgen, "gen_stick_slip", gen)
            _clear_jit_memo()
            eager, _ = jms.render(pj, ir_audio=ir)
        _clear_jit_memo()
    else:
        with jax.disable_jit():
            eager, _ = jms.render(pj, ir_audio=ir)
    got, _ = tms.render(pt, ir_audio=ir, device="cpu")
    got = got.numpy()
    spread = max_dev_dbfs(jitted, eager)
    print(f"{name}: jitted vs op by op {spread:.2f} dBFS; port vs jitted "
          f"{max_dev_dbfs(jitted, got):.2f}, vs op by op "
          f"{max_dev_dbfs(eager, got):.2f}")
    assert spread > -40.0
    assert min(max_dev_dbfs(jitted, got), max_dev_dbfs(eager, got)) \
        <= spread + 6.02

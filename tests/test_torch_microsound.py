"""The port's Microsound slice held against the JAX package.

- the host event program (build_program), array for array;
- the bench's high-rate transient-field configuration (bench.py:343-354)
  at its smoke size: float render within -100 dBFS of the JAX render and
  PCM16 within 1 LSB, with the JAX package's own program fed to the port
  through ``program_to_device``;
- the ``microsound`` golden fingerprint of tests/test_goldens.py;
- the paths that raised before the rest of Microsound was ported, each
  within -100 dBFS of JAX's render;
- the package imports and renders with jax and the JAX package blocked,
  the bench's configuration and a non-default mode (Micro-chaos through
  the power warp, whose scan is a plain loop here).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_suite_tpu.models import microsound as jms
from audio_suite_torch.models import microsound as tms

from test_goldens import GOLDEN_PATH, _compare, _fingerprint

torch.set_num_threads(1)

TOL_DBFS = -100.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config3(sr=48000, seconds=0.5, max_grains=24):
    """bench.py:343-354 (its _SMOKE size by default) and its seeded IR."""
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192) * np.exp(-np.arange(8192) / 800.0)) \
        .astype(np.float32)
    d = dict(base_sr=sr, out_dur_s=seconds, time_unfold=100.0,
             gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
             max_grains=max_grains, partial_stretch=4.0, bandlimit_on=True,
             bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
             er_cloud_on=True, space_ir_on=True, stereo_on=True,
             bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="",
             seed=5)
    return d, ir


# the golden fixture's parameters (tests/test_goldens.py:186-200)
_GOLDEN = dict(base_sr=8000, out_dur_s=0.4, time_unfold=2.0, micro_ms=4.0,
               gen_mode="Noise burst", grains_per_sec=25.0, max_grains=16,
               partial_stretch=1.5, er_taps=32, er_max_ms=15.0, seed=99,
               env_a=20.0, env_s=0.65, bp_density="", bp_unfold="",
               bp_cutoff="", bp_stretch="")


def _dbfs(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return 20.0 * np.log10(max(np.max(np.abs(got - ref)), 1e-300))


@pytest.mark.parametrize("params", [
    _config3()[0],
    _config3(sr=192000, seconds=4.0, max_grains=400)[0],
    _GOLDEN,
    {},                                              # factory defaults
    dict(event_process="Clustered", bp_unfold="0:10, 4:60",
         bp_stretch="0:0.5, 8:2", gen_mode="Gaussian click"),
    dict(event_process="Hawkes", grain_offset_on=False, out_dur_s=2.0,
         bp_cutoff="0:4000, 2:16000"),
    dict(event_process="Single", out_dur_s=1.0),
])
def test_build_program_equal(params):
    pj = jms.MicrosoundParams.from_dict(params)
    pt = tms.MicrosoundParams.from_dict(params)
    assert pt.to_dict() == pj.to_dict()
    want = jms.build_program(pj)
    got = tms.build_program(pt)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_chunks_and_chain_cfg_match():
    d, ir = _config3(sr=192000, seconds=4.0, max_grains=400)
    p = jms.MicrosoundParams.from_dict(d)
    prog = jms.build_program(p, ir_audio=ir)
    ec = tms._event_chunk(prog["E"], prog["L"])
    assert (prog["E"], ec, prog["L"]) == (270, 288, 32768)
    jchunks, _ = jms._chunk_events(prog, ec)
    tchunks = tms._chunk_events(prog, ec)
    assert len(tchunks) == len(jchunks) == 1
    for k, v in tchunks[0].items():
        np.testing.assert_array_equal(v, jchunks[0][k], err_msg=k)
    assert np.any(np.diff(tchunks[0]["oa_start"]) < 0)   # unsorted starts
    jcfg = jms.chain_cfg(p, prog, ec)
    tcfg = tms.chain_cfg(tms.MicrosoundParams.from_dict(d), prog)
    for f in ("L", "n_fft", "oa_win", "shared_gain"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.n_fft, tcfg.oa_win) == (19200, 19456)
    for a, b in zip(tms._space_kernels(p, ir), jms._space_kernels(p, ir)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("event_chunk", [None, 8])
def test_config3_smoke_render_matches_jax(event_chunk):
    d, ir = _config3()
    pj = jms.MicrosoundParams.from_dict(d)
    pt = tms.MicrosoundParams.from_dict(d)
    # the JAX package's program and space kernels, fed to the port
    prog = jms.build_program(pj, ir_audio=ir)
    kern = jms._space_kernels(pj, ir)
    want, _ = jms.render(pj, ir_audio=ir, event_chunk=event_chunk)
    got, meta = tms.render_program(pt, prog, kern, device="cpu",
                                   event_chunk=event_chunk)
    assert got.shape == (24000, 2) and got.dtype == torch.float32
    assert meta["events"] == prog["E"] == 24
    assert _dbfs(want, got.numpy()) <= TOL_DBFS

    want16, _ = jms.render(pj, ir_audio=ir, event_chunk=event_chunk,
                           pcm16=True)
    got16, _ = tms.render(pt, ir_audio=ir, device="cpu",
                          event_chunk=event_chunk, pcm16=True)
    assert got16.dtype == torch.int16 and got16.shape == (24000, 2)
    lsb = np.abs(got16.numpy().astype(np.int32) - want16.astype(np.int32))
    assert lsb.max() <= 1
    assert np.abs(want16).max() > 1000                  # not silence


def test_empty_program_renders_fx_of_silence():
    d = dict(_GOLDEN, max_grains=0)
    pj = jms.MicrosoundParams.from_dict(d)
    pt = tms.MicrosoundParams.from_dict(d)
    want, _ = jms.render(pj)
    got, meta = tms.render(pt, device="cpu")
    assert meta["events"] == 0 and meta["grain_last"] is None
    np.testing.assert_array_equal(got.numpy(), want)


def test_golden_fingerprint():
    mp = tms.MicrosoundParams.from_dict(_GOLDEN)
    y, _ = tms.render(mp, device="cpu")
    with open(GOLDEN_PATH) as f:
        want = json.load(f)["microsound"]
    _compare("microsound", _fingerprint(y.numpy()), want)


@pytest.mark.parametrize("change,where", [
    (dict(gen_mode="Gaussian click"), "chain"),
    (dict(gen_mode="Dust impulses"), "build"),
    (dict(res_bank_on=True), "build"),
    (dict(event_feedback_on=True), "chain"),
    (dict(spectral_imprint_on=True), "chain"),
    (dict(nl_warp_on=True), "chain"),
    (dict(unfold_mode="Multiband unfold"), "chain"),
    (dict(bandlimit_on=False), "chain"),
    (dict(bp_stretch="0:1, 0.4:3"), "chain"),
    (dict(bp_unfold="0:2, 0.4:9"), "chain"),
])
def test_unported_paths_raise(change, where):
    """The paths that raised NotImplementedError before the whole of
    Microsound was ported (the name is kept): each now renders within
    -100 dBFS of JAX's render, and where it adds auxiliary draws ("build")
    its program is JAX's array for array."""
    d = dict(_GOLDEN, **change)
    pj = jms.MicrosoundParams.from_dict(d)
    pt = tms.MicrosoundParams.from_dict(d)
    if where == "build":
        want = jms.build_program(pj)
        got = tms.build_program(pt)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    want, _ = jms.render(pj)
    got, meta = tms.render(pt, device="cpu")
    assert meta["events"] > 2
    assert _dbfs(want, got.numpy()) <= TOL_DBFS


_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from audio_suite_torch.models import microsound as ms
p = ms.MicrosoundParams.from_dict({params!r})
y, meta = ms.render(p, ir_audio=np.asarray({ir!r}, np.float32),
                    device="cpu", pcm16=True)
assert y.shape == (24000, 2) and y.dtype == torch.int16, y.shape
assert int(y.abs().max()) > 1000
p2 = ms.MicrosoundParams.from_dict(dict({params!r}, gen_mode="Micro-chaos",
                                      nl_warp_on=True, micro_ms=8.0,
                                      space_ir_on=False, max_grains=8))
y2, meta2 = ms.render(p2, device="cpu")
assert meta2["events"] == 8 and bool(torch.isfinite(y2).all())
assert float(y2.abs().max()) > 0.5
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_imports_and_renders_with_jax_blocked():
    d, ir = _config3()
    code = _JAX_BLOCKED.format(repo=REPO, params=d, ir=ir[:64].tolist())
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"

"""The port's tape slice held against the JAX package on the CPU.

Same inputs, made with numpy from a seed, through both packages:

- the determinism twins (``sin_cycles``, ``phase_cycles``,
  ``quantize_f32``, ``round_sig12``) and ``segmented_pos_cumsum``:
  bit-exact over 2**20 inputs, against the JAX function (called eagerly,
  one XLA op at a time) and its ``_np`` twin;
- the wow/flutter curve: bit-exact against the JAX device twin (jitted,
  as the JAX render runs it) and ``models.tape.wow_flutter_mod``;
- the control tables: array for array equal to the C++ and NumPy tables;
- the positions: ``idx0`` and ``fr`` bit-equal to the JAX trajectory,
  the gain within 1 ulp of its ``ga * gs``;
- the read: bit-equal to NumPy's float32 evaluation of the formula, and
  within one rounding step of JAX's ``tape_gather_render`` (XLA's CPU
  backend contracts that lerp into a fused multiply-add);
- bench config 1 at its smoke size: the float render within -120 dBFS of
  JAX's ``tape_table_render`` and PCM16 within 1 LSB;
- the ``tape``, ``tape_splicefx``, ``tape_sinc`` and ``tape_trace``
  golden fingerprints (the sinc render within -100 dBFS of JAX, PCM16
  within 1 LSB), and each of the trace golden's two mutations fails it;
- a failed build of the C++ runtime raises, and the package renders with
  jax and the JAX package blocked.

(The trace renderer and the segment and scan engines are held against
JAX in ``test_torch_tape_trace.py``.)
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import tape as jt
from audio_suite_tpu.ops import detmath as jdm
from audio_suite_tpu.ops import fixq as jfq
from audio_suite_tpu.ops import varispeed as jv
from audio_suite_tpu.utils import io as audio_io
from audio_suite_tpu.utils import native_rt as jnrt
from audio_suite_torch.models import tape as tt
from audio_suite_torch.ops import detmath as tdm
from audio_suite_torch.ops import fixq as tfq
from audio_suite_torch.ops import lerp_read as tlr
from audio_suite_torch.ops import varispeed as tv
from audio_suite_torch.utils import native_rt as tnrt

import test_goldens as goldens

torch.set_num_threads(1)

N = 1 << 20                 # inputs per twin
TOL_DBFS = -120.0           # the JAX package's own engine-parity bound
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _dbfs(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return 20.0 * np.log10(max(np.max(np.abs(got - ref)), 1e-300))


# ---------------------------------------------------------------------------
# Configurations: bench config 1 (bench.py:157-265) and the two tape goldens
# (tests/test_goldens.py:108-127)
# ---------------------------------------------------------------------------

def _bench_audio(sr, seconds, seed=7):
    """bench.py:_test_audio."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _config1(mod, seconds=4.0):
    """Bench config 1 at its smoke size, with ``mod``'s TapeParams:
    (audio, params, frames)."""
    sr = 48000
    audio = _bench_audio(sr, seconds)
    n = len(audio)
    p = mod.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.12, 0.3, 0.45,
                                                      0.6, 0.8)],
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60, enable_splice_fx=True, anticlick_enabled=True)
    p.section_speeds = mod.fit_to_target_time(p, n, seconds)
    return audio, p, mod.section_render_length(p, n)


def _golden_tape(mod):
    p = mod.TapeParams(
        sample_rate=goldens.SR, markers=[6000, 11000],
        section_speeds=[1.0, 2.0, 0.5], section_reverse=[False, True, False],
        tape_age=70.0, inertia_enabled=True, inertia_amount=50.0)
    return goldens._test_audio(), p, 20000


def _golden_splicefx(mod):
    p = mod.TapeParams(
        sample_rate=goldens.SR, markers=[4000, 9000, 13000],
        section_speeds=[0.7, 1.4, 2.2, 0.9],
        section_reverse=[True, False, False, True],
        tape_age=30.0, enable_splice_fx=True, anticlick_enabled=True)
    return goldens._test_audio(), p, 18000


def _golden_sinc(mod):
    p = mod.TapeParams(sample_rate=goldens.SR, markers=[7000],
                       section_speeds=[1.3, 0.6],
                       section_reverse=[False, True], tape_age=55.0)
    return goldens._test_audio(), p, 16000


def _golden_trace(mod, mut=None):
    """tests/test_goldens.py:130-144, a performance; ``mut`` perturbs one
    of its stages by the golden test's 1e-3 (``goldens._m``)."""
    sr = goldens.SR
    tr = mod.TapeTrace()
    tr.add(0.20, "set_speed", section=0,
           value=goldens._m(mut, "trace_speed", 1.7))
    tr.add(0.45, "set_reverse", section=1, value=True)
    tr.add(0.70, "set_age", value=95)
    tr.add(0.90, "add_marker", sample=sr // 2)
    tr.add(1.10, "set_inertia", value=True)
    tr.add(1.40, "seek", sample=100)
    tr.add(1.60, "retime", target=goldens._m(mut, "retime", 1.2))
    p = mod.TapeParams(sample_rate=sr, markers=[5000, 10000],
                       section_speeds=[1.0, 0.5, 2.0],
                       section_reverse=[False, False, True],
                       tape_age=40, current_speed=1.0)
    return goldens._test_audio(), p, tr, sr * 2


CONFIGS = {"config1_smoke": _config1, "tape": _golden_tape,
           "tape_splicefx": _golden_splicefx}
# golden fixture -> (configuration, interp, dBFS bound against JAX): the
# sinc read's weights go through sin, whose ulps differ between XLA and
# PyTorch, so it is held to the JAX package's sinc-twin level
GOLDENS = {"tape": (_golden_tape, "linear", TOL_DBFS),
           "tape_splicefx": (_golden_splicefx, "linear", TOL_DBFS),
           "tape_sinc": (_golden_sinc, "sinc", -100.0),
           "tape_trace": (_golden_trace, "linear", TOL_DBFS)}


def _golden_render(mod, name, mut=None, **kw):
    """The golden fixture's render through ``mod`` (``kw``: the port's
    device)."""
    config, interp, _ = GOLDENS[name]
    if name == "tape_trace":
        audio, p, tr, frames = _golden_trace(mod, mut)
        return mod.render_tape_trace(audio, p, tr, num_frames=frames, **kw)
    return mod.render_tape(*config(mod), interp=interp, **kw)


def _programs(name):
    """The JAX program (host mod curve included) and the port's, both of
    the same configuration."""
    audio, pj, frames = CONFIGS[name](jt)
    _, pt, frames_t = CONFIGS[name](tt)
    assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
    assert frames == frames_t
    progj = jt.build_tape_program(audio, pj, frames)
    progt = tt.build_tape_program(audio, pt, frames, device="cpu")
    return audio, progj, progt


# ---------------------------------------------------------------------------
# Determinism twins
# ---------------------------------------------------------------------------

def test_sin_cycles_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-4096, 4096, N // 2), rng.uniform(-2, 2, N // 2 - 8),
        [0.0, 0.125, 0.25, 0.375, -0.125, 0.5, 1.0, 2 ** 21]]) \
        .astype(np.float32)
    got = _bits(tdm.sin_cycles(torch.from_numpy(x)).numpy())
    assert np.array_equal(got, _bits(tdm.sin_cycles_np(x)))
    assert np.array_equal(got, _bits(jdm.sin_cycles_np(x)))
    assert np.array_equal(got, _bits(jdm.sin_cycles(x)))


@pytest.mark.parametrize("ratio,sr", [((2, 5), 48000), ((7, 1), 48000),
                                      ((2, 5), 8000), ((7, 1), 192000)])
def test_phase_cycles_bit_exact(ratio, sr):
    num, m, inv = jdm.phase_ratio(*ratio, sr)
    assert tuple(tdm.phase_ratio(*ratio, sr)) == (num, m, inv)
    rng = np.random.default_rng(sr + ratio[0])
    i = np.concatenate([np.arange(N // 2, dtype=np.uint32),
                        rng.integers(0, 2 ** 32, N // 2, dtype=np.uint32)])
    got = tdm.phase_cycles(torch.from_numpy(i.astype(np.int64)), num, m,
                           inv).numpy()
    assert np.array_equal(_bits(got), _bits(tdm.phase_cycles_np(i, num, m,
                                                                 inv)))
    assert np.array_equal(_bits(got), _bits(jdm.phase_cycles_np(i, num, m,
                                                                 inv)))
    assert np.array_equal(_bits(got), _bits(jdm.phase_cycles(i, num, m,
                                                             inv)))


def test_quantize_f32_bit_exact():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-8, 8, N - 4),
                        [0.5 / 2 ** 22, 1.5 / 2 ** 22, -2.5 / 2 ** 22,
                         3.0]]).astype(np.float32)
    got = _bits(tfq.quantize_f32(torch.from_numpy(x)).numpy())
    assert np.array_equal(got, _bits(tfq.quantize_f32_np(x)))
    assert np.array_equal(got, _bits(jfq.quantize_f32_np(x)))
    assert np.array_equal(got, _bits(jfq.quantize_f32(x)))


def test_round_sig12_bit_exact():
    rng = np.random.default_rng(2)
    # every bit pattern class: random finite floats, NaN / inf patterns
    # and the ones whose rounding carries into the exponent
    b = rng.integers(-2 ** 31, 2 ** 31, N, dtype=np.int64).astype(np.int32)
    b[:4] = [0x7F7FF800, 0x7F800000, 0x7FC00000, 0x3FFFFFFF]
    x = b.view(np.float32)
    got = tfq.round_sig12(torch.from_numpy(x)).numpy().view(np.int32)
    assert np.array_equal(got, tfq.round_sig12_np(x).view(np.int32))
    assert np.array_equal(got, jfq.round_sig12_np(x).view(np.int32))
    assert np.array_equal(got, np.asarray(jfq.round_sig12(x)).view(np.int32))


def test_split_pos_np_matches():
    for v in (0.0, 1.5, 12345.999999999, 2.0 ** 30 + 0.25, 7.0 - 1e-9):
        assert tfq.split_pos_np(v) == jfq.split_pos_np(v)


@pytest.mark.parametrize("n,init", [(N, (3, 1234567)), (100003, (0, 0)),
                                    (4096, (-2, 5))])
def test_segmented_pos_cumsum_bit_exact(n, init):
    rng = np.random.default_rng(n)
    inc = rng.integers(0, 4 * tfq.POS_ONE, n).astype(np.int32)
    reset = rng.random(n) < 1e-3
    reset[n // 2] = True
    reset[0] = n == 4096                  # a reset on the first element
    got = tfq.segmented_pos_cumsum(torch.from_numpy(inc),
                                   torch.from_numpy(reset), *init)
    want_np = jfq.segmented_pos_cumsum_np(inc, reset, *init)
    want_jax = jfq.segmented_pos_cumsum(inc, reset, *init)
    for g, wn, wj in zip(got, want_np, want_jax):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), wn)
        assert np.array_equal(g.numpy(), np.asarray(wj))


@pytest.mark.parametrize("sr,age", [(48000, 60), (8000, 70.0), (8000, 30.0),
                                    (44100, 100)])
def test_wow_flutter_bit_exact(sr, age):
    T = N
    ints, flts, ph0 = tt.wow_flutter_consts(sr, age)
    for a, b in zip((ints, flts, ph0), jt.wow_flutter_consts(sr, age)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = tv._wow_flutter_device(T, ints, flts, ph0, "cpu").numpy()
    want_host = jt.wow_flutter_mod(T, sr, age)
    want_dev = jax.jit(jv._wow_flutter_device, static_argnums=0)(
        T, jnp.asarray(ints), jnp.asarray(flts), jnp.asarray(ph0))
    assert np.array_equal(_bits(got), _bits(want_host))
    assert np.array_equal(_bits(got), _bits(want_dev))


# ---------------------------------------------------------------------------
# Host tables and device positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tape_tables_equal(name):
    _, progj, progt = _programs(name)
    T, n = progt["num_frames"], int(progt["audio"].shape[0])
    for k in ("starts", "ends", "speeds_q", "reverse", "boundaries",
              "splice_env"):
        assert np.array_equal(progt[k], progj[k]), k
        assert progt[k].dtype == progj[k].dtype, k
    assert progt["consts"].__dict__ == progj["consts"].__dict__
    got = tt.program_tables(progt)
    args = (progj["starts"], progj["ends"], progj["speeds_q"],
            progj["reverse"], progj["boundaries"], len(progj["splice_env"]),
            progj["consts"])
    want_c = jnrt.tape_tables(T, n, progj["mod_consts"], *args)
    want_np = jv.tape_tables(n, progj["mod_q"], *args)
    assert got["final"] == want_c["final"] == want_np["final"]
    for k, v in want_c.items():
        if k == "final":
            continue
        assert got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k
        assert np.array_equal(got[k], want_np[k]), k
    if name == "config1_smoke":
        assert [len(got[k]) for k in ("visit_start", "run_start",
                                      "triggers")] == [7, 7, 4]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tape_positions_match_trajectory(name):
    audio, progj, progt = _programs(name)
    T, n = progt["num_frames"], len(audio)
    idx0, fr, gain = tv.tape_positions(tt.device_tables(progt),
                                       progt["consts"], n, T)
    traj = jv.tape_trajectory(
        n, progj["mod_q"], progj["starts"], progj["ends"],
        progj["speeds_q"], progj["reverse"], progj["boundaries"],
        len(progj["splice_env"]), progj["consts"])
    assert idx0.dtype == torch.int32 and fr.dtype == torch.float32
    assert np.array_equal(idx0.numpy(), traj["idx0"])
    assert np.array_equal(_bits(fr.numpy()), _bits(traj["fr"]))
    # gain: within 1 ulp of the trajectory's anti-click x splice gain
    ref = traj["ga"] * traj["gs"]
    ulps = np.abs(_bits(gain.numpy()).astype(np.int64)
                  - _bits(ref).astype(np.int64))
    assert ulps.max() <= 1
    assert (ref != 1.0).any()                       # gains do act


# ---------------------------------------------------------------------------
# The read
# ---------------------------------------------------------------------------

def _read_case(seed):
    """Tape-shaped positions (the config-1 smoke trajectory: wraps,
    reverse sections) followed by random ones and the edge cases
    idx0 = n - 1, idx0 = 0 and negative fractions."""
    audio, progj, _ = _programs("config1_smoke")
    n = len(audio)
    traj = jv.tape_trajectory(
        n, progj["mod_q"], progj["starts"], progj["ends"],
        progj["speeds_q"], progj["reverse"], progj["boundaries"],
        len(progj["splice_env"]), progj["consts"])
    rng = np.random.default_rng(seed)
    k = N - len(traj["idx0"])
    idx0 = np.concatenate([traj["idx0"],
                           rng.integers(0, n, k).astype(np.int32)])
    fr = np.concatenate([traj["fr"],
                         rng.random(k, dtype=np.float32)])
    idx0[-8:] = [n - 1, n - 1, 0, 0, 5, 17, n - 2, 3]
    fr[-8:] = [0.0, 0.75, 0.0, -0.25, -0.999, -1e-6, 0.5, 1.0 - 2 ** -22]
    return audio, idx0.astype(np.int32), fr.astype(np.float32)


def test_lerp_read_plain_bit_equal_to_numpy():
    audio, idx0, fr = _read_case(3)
    got = tlr.lerp_read_plain(torch.from_numpy(audio),
                              torch.from_numpy(idx0),
                              torch.from_numpy(fr)).numpy()
    n = len(audio)
    i0 = np.clip(idx0, 0, n - 1)
    i1 = np.minimum(i0 + 1, n - 1)
    want = (np.float32(1.0) - fr) * audio[i0] + fr * audio[i1]
    assert want.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    # the dispatcher takes the plain version for CPU tensors
    again = tlr.lerp_read(torch.from_numpy(audio), torch.from_numpy(idx0),
                          torch.from_numpy(fr)).numpy()
    assert np.array_equal(_bits(again), _bits(got))


def test_lerp_read_plain_within_a_rounding_step_of_jax():
    """XLA's CPU backend evaluates tape_gather_render's lerp as
    fma(1 - fr, x0, fr * x1): it skips the rounding of the first product.
    Tolerance per sample: one ulp of that product plus one ulp of the
    result."""
    audio, idx0, fr = _read_case(4)
    got = tlr.lerp_read_plain(torch.from_numpy(audio),
                              torch.from_numpy(idx0),
                              torch.from_numpy(fr)).numpy()
    want = np.asarray(jv.tape_gather_render(audio, idx0, fr,
                                            np.ones(len(fr), np.float32)))
    p0 = (np.float32(1.0) - fr) * audio[idx0]
    tol = np.spacing(np.abs(p0)) + np.spacing(np.abs(got))
    dev = np.abs(want.astype(np.float64) - np.clip(got, -1.0, 1.0))
    assert (dev <= tol).all()
    print(f"lerp_read_plain vs JAX: {np.mean(dev > 0):.1%} of samples one "
          f"rounding step apart, max {dev.max():.3g}")


def test_lerp_read_rejects_what_it_does_not_take():
    a = torch.zeros(8)
    i = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4)
    with pytest.raises(TypeError):
        tlr.lerp_read(a, i.long(), f)
    with pytest.raises(TypeError):
        tlr.lerp_read(a.double(), i, f)
    with pytest.raises(ValueError):
        tlr.lerp_read(a, i, f[:3])
    with pytest.raises(ValueError):
        tlr.lerp_read(a[:0], i, f)


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------

def test_config1_smoke_render_matches_jax():
    audio, pj, frames = _config1(jt)
    _, pt, _ = _config1(tt)
    assert frames == 194338
    progj = jt.build_tape_program(audio, pj, frames, with_mod=False)
    progt = tt.build_tape_program_cached(audio, pt, frames, device="cpu")
    want, fin_j = jt.tape_table_render(progj)
    got, fin_t = tt.tape_table_render(progt)
    assert got.shape == (frames,) and got.dtype == np.float32
    assert fin_t == fin_j
    dev = _dbfs(want, got)
    print(f"config-1 smoke render vs JAX: {dev:.2f} dBFS")
    assert dev <= TOL_DBFS
    assert np.abs(got).max() > 0.5

    want16, _ = jt.tape_table_render(progj, out_i16=True)
    got16, _ = tt.tape_table_render(progt, out_i16=True)
    assert got16.dtype == np.int16 and got16.shape == (frames,)
    assert np.abs(got16.astype(np.int32) - want16.astype(np.int32)).max() <= 1

    st, _ = tt.tape_table_render(progt, out_i16=True, stereo=True)
    assert st.shape == (frames, 2)
    assert np.array_equal(st[:, 0], got16) and np.array_equal(st[:, 1],
                                                              got16)
    dv, _ = tt.tape_table_render(progt, device_out=True)
    assert isinstance(dv, torch.Tensor) and np.array_equal(dv.numpy(), got)
    # the cached program serves the same render
    assert tt.build_tape_program_cached(audio, pt, frames,
                                        device="cpu") is progt
    assert np.array_equal(tt.render_tape(audio, pt, device="cpu"), got)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_fingerprint(name):
    tol = GOLDENS[name][2]
    y = _golden_render(tt, name, device="cpu")
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    goldens._compare(name, goldens._fingerprint(y), want)
    ref = _golden_render(jt, name)
    dev = _dbfs(ref, y)
    print(f"{name} render vs JAX: {dev:.2f} dBFS")
    assert dev <= tol


@pytest.mark.parametrize("stage", ["trace_speed", "retime"])
def test_trace_golden_mutation_fails_it(stage):
    """tests/test_goldens.py's mutation check on the port: a 1e-3
    perturbation of either traced stage fails the ``tape_trace`` golden."""
    assert ("tape_trace", stage) in goldens.MUTATIONS
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)["tape_trace"]
    y = _golden_render(tt, "tape_trace", mut=stage, device="cpu")
    assert not goldens._matches(goldens._fingerprint(y), want)


def test_sinc_render_pcm16_matches_jax():
    """The sinc read through ``tape_table_render``: PCM16 within 1 LSB of
    JAX, and the fraction's quantization round trip in place (the read
    takes ``rint(fr * 2**22)``, not ``fr``)."""
    audio, pt, frames = _golden_sinc(tt)
    _, pj, _ = _golden_sinc(jt)
    progt = tt.build_tape_program(audio, pt, frames, device="cpu")
    progj = jt.build_tape_program(audio, pj, frames)
    got16, fin_t = tt.tape_table_render(progt, out_i16=True, interp="sinc")
    want16, fin_j = jt.tape_table_render(progj, out_i16=True,
                                         interp="sinc")
    assert fin_t == fin_j and got16.dtype == np.int16
    assert np.abs(got16.astype(np.int32) - want16.astype(np.int32)).max() \
        <= 1
    lin, _ = tt.tape_table_render(progt)
    sinc, _ = tt.tape_table_render(progt, interp="sinc")
    assert 0.0 < np.abs(sinc - lin).max() < 0.1


def test_render_to_wav_matches_jax(tmp_path):
    audio, pt, frames = _golden_splicefx(tt)
    _, pj, _ = _golden_splicefx(jt)
    src = str(tmp_path / "in.wav")
    audio_io.write_wav(src, audio, goldens.SR, subtype="FLOAT")
    yt = tt.render_to_wav(src, str(tmp_path / "t.wav"), pt, frames,
                          device="cpu")
    yj = jt.render_to_wav(src, str(tmp_path / "j.wav"), pj, frames)
    assert _dbfs(yj, yt) <= TOL_DBFS
    wt, sr = audio_io.read_wav(str(tmp_path / "t.wav"))
    wj, _ = audio_io.read_wav(str(tmp_path / "j.wav"))
    assert sr == goldens.SR and wt.shape == wj.shape == (frames,)
    assert np.abs(wt - wj).max() <= 1.0 / 32768 + 1e-9


def test_missing_native_library_raises(monkeypatch, tmp_path):
    audio, p, frames = _golden_tape(tt)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnrt, "_SRC", str(bad))
    monkeypatch.setattr(tnrt, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnrt, "_lib", None)
    prog = tt.build_tape_program(audio, p, frames, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        tt.tape_table_render(prog)


_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from audio_suite_torch.models import tape
sr, seconds = 48000, 4.0
rng = np.random.default_rng(7)
t = np.arange(int(sr * seconds)) / sr
x = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
     + 0.1 * rng.standard_normal(t.size))
audio = (x / np.max(np.abs(x))).astype(np.float32)
n = len(audio)
p = tape.TapeParams(sample_rate=sr,
                    markers=[int(n * f) for f in (0.12, 0.3, 0.45, 0.6, 0.8)],
                    section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
                    section_reverse=[False, True, False, True, False, False],
                    tape_age=60)
p.section_speeds = tape.fit_to_target_time(p, n, seconds)
frames = tape.section_render_length(p, n)
prog = tape.build_tape_program(audio, p, frames, device="cpu")
y, _ = tape.tape_table_render(prog, out_i16=True, stereo=True)
assert y.shape == (194338, 2) and y.dtype == np.int16, y.shape
assert int(np.abs(y).max()) > 10000
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_imports_and_renders_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKED.format(repo=REPO)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"

"""The port's scrub engine held against the JAX package on the CPU.

Same inputs, made with numpy from a seed, through both packages (the JAX
side jitted, as Tier-1 runs it):

- the host half: ``scripted_gesture_trace`` and ``build_scrub_program``
  field by field on the golden traces and on bench config 2 (full size,
  host only: T 1 439 744, one head segment), ``noise.normal_np`` and the
  increment twin ``_inc_np``;
- the device half: ``_inc_device`` and ``_positions`` bit-exact against
  JAX's (and ``_inc_np``);
- the reads: ``gather_linear_wrap`` bit-equal to its NumPy twin and within
  one rounding step of JAX (XLA's CPU backend contracts the lerp into a
  fused multiply-add); ``heads_read_plain`` in form A (heads summed, one
  lerp) and form B (one lerp per head) bit-equal to NumPy's float32
  evaluation and within one rounding step of ``_read_blockwise_heads`` and
  of the per-head ``gather_linear_wrap``; the fused ``scrub_read_plain``
  (read, envelope, PCM16 from a sample ``t0`` on) bit-equal to
  ``_finish(heads_read_plain(...))`` in both forms and outputs, across the
  wrap at n, envelope zeros, clipping and half-LSB ties; the sinc twins
  within 1e-5;
- the renders: bench config 2 at its smoke size and a variant with its
  drags and jump scaled into the smoke's 2 s, within -120 dBFS of JAX with
  PCM16 within 1 LSB; every other ``render_scrub`` path (form B by
  fractional head offsets and by a short tape, live head control with
  fractional layouts, ``tape_pos0``, stereo, ``device_out``); the
  ``scrub``, ``scrub_keys`` and ``scrub_sinc`` golden fingerprints; one
  render with ``jax`` and the JAX package blocked.
"""
import dataclasses
import json
import os
import subprocess
import sys
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import scrub as js
from audio_suite_tpu.ops import fixq as jfq
from audio_suite_tpu.ops import noise as jnz
from audio_suite_torch.models import scrub as ts
from audio_suite_torch.ops import fixq as tfq
from audio_suite_torch.ops import lerp_read as tlr
from audio_suite_torch.ops import noise as tnz

import test_goldens as goldens

torch.set_num_threads(1)

N = 1 << 20
TOL_DBFS = -120.0           # the JAX package's own engine-parity bound
SINC_DBFS = -100.0          # sinc weights go through sin: ulps differ
SINC_TOL = 1e-5             # the JAX package's sinc-twin tolerance
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2_DRAGS = [(2.0, 8.0, 3.0), (10.0, -14.0, 4.0), (20.0, 4.0, 5.0)]
C2_JUMPS = [(15.0, 1000.0)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _dbfs(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return 20.0 * np.log10(max(np.max(np.abs(got - ref)), 1e-300))


def _bench_audio(sr, seconds, seed=7):
    """bench.py:_test_audio."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    return (x / np.max(np.abs(x))).astype(np.float32)


# ---------------------------------------------------------------------------
# Configurations: (audio, cfg, trace, render kwargs) built with ``mod``'s
# classes.  Bench config 2 (bench.py:268-292) and the three scrub goldens
# (tests/test_goldens.py:156-183), then one case per remaining path.
# ---------------------------------------------------------------------------

def _config2(mod, seconds=2.0, audio_seconds=2.0, scale=1.0):
    """Bench config 2: ``seconds`` 30 with 10 s of tape is its full size,
    2 / 2 its smoke size; ``scale`` moves its drags and jump in time (the
    smoke's 2 s never reach them)."""
    sr = 48000
    blocks = int(seconds * sr / mod.BLOCK_SIZE)
    cfg = mod.ScrubConfig(sample_rate=sr, head_count=3)
    trace = mod.scripted_gesture_trace(
        blocks, sr, drag_events=[(t * scale, dx, d * scale)
                                 for t, dx, d in C2_DRAGS],
        base_speed=0.5, jumps=[(t * scale, x) for t, x in C2_JUMPS])
    return _bench_audio(sr, audio_seconds), cfg, trace, {}


def _golden_scrub(mod):
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=5, head_count=3)
    trace = mod.scripted_gesture_trace(
        30, goldens.SR, drag_events=[(0.5, 5.0, 0.5)], base_speed=0.5,
        jumps=[(2.0, 4000.0)])
    return goldens._test_audio(), cfg, trace, {}


def _golden_keys(mod):
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=5, head_count=3)
    trace = mod.scripted_gesture_trace(
        40, goldens.SR, drag_events=[(0.3, 4.0, 0.4)], base_speed=0.5,
        jumps=[(0.9, 3000.0)],
        key_events=[(0.2, "2"), (0.4, "Z"), (0.6, "1"), (0.8, "V"),
                    (1.0, "3"), (1.2, "Down")])
    return goldens._test_audio(), cfg, trace, {"tape_pos0": 2000.0}


def _golden_sinc(mod):
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=11, head_count=1)
    trace = mod.scripted_gesture_trace(
        30, goldens.SR, drag_events=[(0.4, -6.0, 0.6)], base_speed=0.8)
    return goldens._test_audio(), cfg, trace, {"interp": "sinc"}


def _fractional_heads(mod):
    """Form B in the single-layout render: a fractional head offset."""
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=3, head_count=3,
                          head_offsets=(-1500.25, 0.5, 1999.75))
    trace = mod.scripted_gesture_trace(
        24, goldens.SR, drag_events=[(0.3, -9.0, 0.5)], base_speed=0.4,
        jumps=[(1.5, 100.5)])
    return goldens._test_audio(), cfg, trace, {"pcm16": True}


def _short_tape(mod):
    """Form B by the blockwise condition: a tape of 700 samples, shorter
    than 2 * span * 128 + 32 at this speed, read around its wrap."""
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=8, head_count=2,
                          dropouts=False)
    trace = mod.scripted_gesture_trace(
        12, goldens.SR, drag_events=[(0.2, 12.0, 0.6)], base_speed=-0.5)
    return goldens._test_audio()[:700], cfg, trace, {"stereo": True}


def _keys_fractional(mod):
    """Live head control whose layouts are fractional (form B), integer
    (form A) and single-head, with stereo PCM16 out."""
    cfg = mod.ScrubConfig(sample_rate=goldens.SR, seed=21, head_count=2,
                          head_offsets=(-700.5, 0.0, 650.0))
    trace = mod.scripted_gesture_trace(
        36, goldens.SR, drag_events=[(0.5, -5.0, 0.7)], base_speed=0.6,
        jumps=[(2.5, 9000.0)],
        key_events=[(0.3, "R"), (1.0, "1"), (1.6, "N"), (1.6, "3"),
                    (2.2, "2"), (2.2, "Z"), (3.0, "Up")],
        head_count=2, head_offsets=(-700.5, 0.0, 650.0))
    return goldens._test_audio(), cfg, trace, {"stereo": True,
                                                "pcm16": True,
                                                "tape_pos0": 15999.5}


CONFIGS = {
    "config2_smoke": _config2,
    "config2_scaled": partial(_config2, scale=2.0 / 30.0),
    "scrub": _golden_scrub,
    "scrub_keys": _golden_keys,
    "scrub_sinc": _golden_sinc,
    "fractional_heads": _fractional_heads,
    "short_tape": _short_tape,
    "keys_fractional": _keys_fractional,
}
GOLDENS = ("scrub", "scrub_keys", "scrub_sinc")


def _pair(name):
    """The configuration through both packages: (audio, cfg, trace, kw)
    for JAX and for the port; the dataclasses hold equal fields."""
    a = CONFIGS[name](js)
    b = CONFIGS[name](ts)
    assert dataclasses.asdict(a[1]) == dataclasses.asdict(b[1])
    return a, b


def _programs(name, with_inc=False):
    (audio, cj, trj, kw), (_, ct, trt, _) = _pair(name)
    pos0 = kw.get("tape_pos0", 0.0)
    return (audio, js.build_scrub_program(audio, cj, trj, pos0, with_inc),
            ts.build_scrub_program(audio, ct, trt, pos0, with_inc))


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scripted_gesture_trace_matches_jax(name):
    (_, _, trj, _), (_, _, trt, _) = _pair(name)
    for f in ("base_speed", "gesture_speed", "jump", "head_count",
              "head_offsets"):
        a, b = getattr(trj, f), getattr(trt, f)
        if a is None:
            assert b is None, f
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), f
    assert trt.num_blocks == trj.num_blocks


def _assert_programs_equal(pj, pt):
    assert pj.keys() == pt.keys()
    for k, v in pj.items():
        if k == "head_segments":
            assert len(pt[k]) == len(v)
            for sj, st in zip(v, pt[k]):
                assert sj.keys() == st.keys()
                for kk in sj:
                    assert np.array_equal(sj[kk], st[kk]), (k, kk)
                    assert np.asarray(sj[kk]).dtype \
                        == np.asarray(st[kk]).dtype, (k, kk)
        elif k == "mod_consts":
            for a, b in zip(v, pt[k]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        elif v is None:
            assert pt[k] is None, k
        else:
            assert np.asarray(v).dtype == np.asarray(pt[k]).dtype, k
            assert np.array_equal(v, pt[k]), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_scrub_program_matches_jax(name):
    _, pj, pt = _programs(name, with_inc=True)
    _assert_programs_equal(pj, pt)
    assert ts.span_bound_blocks(pt["base_inc_q"], pt["js_q"]) \
        == js.span_bound_blocks(pj["base_inc_q"], pj["js_q"])


def test_config2_full_program_matches_jax():
    """Bench config 2 at full size (bench.py:278-292), host only: 30 s of
    render over a 10 s tape; the span bound rounds to 1, so the render
    reads in form A with one head layout."""
    (audio, cj, trj, _), (_, ct, trt, _) = (
        _config2(js, 30.0, 10.0), _config2(ts, 30.0, 10.0))
    assert len(audio) == 480000
    pj = js.build_scrub_program(audio, cj, trj)
    pt = ts.build_scrub_program(audio, ct, trt)
    _assert_programs_equal(pj, pt)
    assert pt["num_frames"] == 1439744
    span = ts.program_span(pt)
    jspan = js.span_bound_blocks(pj["base_inc_q"], pj["js_q"])
    assert span == 1 << (jspan - 1).bit_length() == 1
    assert len(pt["head_segments"]) == 1
    assert ts.reads_summed(pt["num_frames"], len(audio), span,
                           pt["head_off_frac"])
    assert (pt["env_blocks"] < 1).any() and pt["jump_flags"].sum() == 1


def test_build_scrub_program_cached_is_memoized():
    audio, cfg, trace, _ = _golden_scrub(ts)
    p = ts.build_scrub_program_cached(audio, cfg, trace)
    assert ts.build_scrub_program_cached(audio, cfg, trace) is p
    assert ts.build_scrub_program_cached(audio.copy(), cfg, trace) is not p
    other = dataclasses.replace(cfg, seed=6)
    assert ts.build_scrub_program_cached(audio, other, trace) is not p


def test_normal_np_bit_exact():
    rng = np.random.default_rng(9)
    i = np.concatenate([np.arange(N // 2, dtype=np.uint32),
                        rng.integers(0, 2 ** 32, N // 2, dtype=np.uint32)])
    got = tnz.normal_np(np.uint32(1234), i, np.uint32(7))
    assert np.array_equal(_bits(got),
                          _bits(jnz.normal_np(np.uint32(1234), i,
                                              np.uint32(7))))
    dev = tnz.normal(1234, torch.from_numpy(i.astype(np.int64)), 7).numpy()
    assert np.array_equal(_bits(got), _bits(dev))


# ---------------------------------------------------------------------------
# Device half: increments and positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sr,nb,bs", [(44100, 37, 1024), (48000, 1024, 1024),
                                      (8000, 41, 1000)])
def test_inc_device_bit_exact(sr, nb, bs):
    rng = np.random.default_rng(sr + nb)
    base = tfq.round_sig12_np(rng.uniform(-0.9, 0.9, nb).astype(np.float32))
    base[:2] = [0.0, -0.83325195]
    jsq = tfq.round_sig12_np(rng.uniform(0, 0.007, nb).astype(np.float32))
    c = ts._mod_consts(sr)
    cj = js._mod_consts(sr)
    for k in ("ints", "flts"):
        assert c[k].dtype == cj[k].dtype and np.array_equal(c[k], cj[k])
    got = ts._inc_device(torch.from_numpy(base), torch.from_numpy(jsq), 42,
                         bs, (c["ints"], c["flts"]))
    assert got.dtype == torch.int32 and got.shape == (nb * bs,)
    want = np.asarray(jax.jit(
        lambda: js._inc_device(jnp.asarray(base), jnp.asarray(jsq),
                               np.uint32(42), bs,
                               (jnp.asarray(cj["ints"]),
                                jnp.asarray(cj["flts"]))))())
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ts._inc_np(base, jsq, 42, bs, c), want)
    assert np.array_equal(js._inc_np(base, jsq, 42, bs, cj), want)


def _jax_positions(pj):
    f = jax.jit(partial(js._positions, block_size=int(pj["block_size"])))
    return f(pj["base_inc_q"], pj["js_q"], np.uint32(pj["seed"]),
             tuple(jnp.asarray(a) for a in pj["mod_consts"]),
             pj["jump_flags"], pj["seg_bases_whole"], pj["seg_bases_frac"])


def _port_positions(pt):
    dp = ts.device_program(pt, "cpu")
    return ts._positions(dp["base_inc_q"], dp["js_q"], pt["seed"],
                         pt["mod_consts"], dp["jump_flags"],
                         dp["seg_bases_whole"], dp["seg_bases_frac"],
                         int(pt["block_size"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_positions_bit_exact(name):
    _, pj, pt = _programs(name, with_inc=True)
    w, f = _port_positions(pt)
    wj, fj = _jax_positions(pj)
    assert w.dtype == f.dtype == torch.int32
    assert np.array_equal(w.numpy(), np.asarray(wj))
    assert np.array_equal(f.numpy(), np.asarray(fj))
    assert int(f.min()) >= 0 and int(f.max()) < tfq.POS_ONE
    # the oracle's sequential sum of the NumPy increment twin
    inc = np.concatenate([[0], pt["inc_fix"][:-1]]).astype(np.int32)
    inc[pt["reset"]] = 0
    ow, of = jfq.segmented_pos_cumsum_np(inc, pt["reset"])
    seg = np.cumsum(pt["reset"])
    fs = of.astype(np.int64) + pt["seg_bases_frac"][seg]
    ws = ow.astype(np.int64) + pt["seg_bases_whole"][seg] + (fs >> 22)
    assert np.array_equal(w.numpy(), ws)
    assert np.array_equal(f.numpy(), fs & (tfq.POS_ONE - 1))


# ---------------------------------------------------------------------------
# The reads
# ---------------------------------------------------------------------------

def _read_case(seed, n=16000, T=1 << 16):
    """Scrub-shaped positions (the scaled config-2 trajectory: forward and
    reverse drags, a jump) followed by random wrapped ones, some negative
    and some past n."""
    audio = goldens._test_audio()[:n] * np.float32(0.9)
    _, _, pt = _programs("config2_scaled")
    w, f = _port_positions(pt)
    k = T - 8192
    rng = np.random.default_rng(seed)
    whole = np.concatenate([w.numpy()[:k],
                            rng.integers(-3 * n, 3 * n, T - k)])
    frac = np.concatenate([f.numpy()[:k],
                           rng.integers(0, tfq.POS_ONE, T - k)])
    whole[-4:] = [-1, n - 1, -n, 2 * n - 1]
    frac[-4:] = [0, tfq.POS_ONE - 1, 1, 0]
    return audio, whole.astype(np.int32), frac.astype(np.int32)


def _lerp_tol(p0, got):
    """One rounding step: an ulp of the product XLA keeps unrounded inside
    its fused multiply-add, plus an ulp of the result."""
    return np.spacing(np.abs(p0)) + np.spacing(np.abs(got))


def test_gather_linear_wrap_bit_equal_to_np_and_near_jax():
    audio, whole, frac = _read_case(1)
    got = tfq.gather_linear_wrap(torch.from_numpy(audio),
                                 torch.from_numpy(whole),
                                 torch.from_numpy(frac)).numpy()
    want = tfq.gather_linear_wrap_np(audio, whole, frac)
    assert want.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got),
                          _bits(jfq.gather_linear_wrap_np(audio, whole,
                                                          frac)))
    ref = np.asarray(jax.jit(jfq.gather_linear_wrap)(audio, whole, frac))
    fr = frac.astype(np.float32) * tfq.POS_INV_F
    p0 = (np.float32(1.0) - fr) * audio[np.mod(whole, len(audio))]
    dev = np.abs(ref.astype(np.float64) - got)
    assert (dev <= _lerp_tol(p0, got)).all()
    print(f"gather_linear_wrap vs JAX: {np.mean(dev > 0):.1%} of samples "
          "one rounding step apart")


OFFSETS = [(-2000,), (0, 7), (-2000, 0, 2000), (-16001, 3, 31999)]


@pytest.mark.parametrize("offs", OFFSETS, ids=str)
def test_heads_read_summed_matches_blockwise_read(offs):
    """Form A against the JAX package's ``_read_blockwise_heads`` (the
    render's own read for integer offsets), with the gain 1."""
    audio, whole, frac = _read_case(2)
    T = 1 << 15                       # the trajectory part: span bound 1
    whole, frac = whole[:T], frac[:T]
    n = len(audio)
    got = tlr.heads_read_plain(torch.from_numpy(audio),
                               torch.from_numpy(whole),
                               torch.from_numpy(frac), list(offs),
                               [0] * len(offs), 1.0, True).numpy()
    x0 = np.zeros(T, np.float32)
    x1 = np.zeros(T, np.float32)
    for o in offs:
        p = np.mod(whole.astype(np.int64) + o, n)
        x0 = x0 + audio[p]
        x1 = x1 + audio[np.mod(p + 1, n)]
    f = frac.astype(np.float32) * tfq.POS_INV_F
    want = x0 * (np.float32(1.0) - f) + x1 * f
    assert want.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    ref = np.asarray(jax.jit(js._read_blockwise_heads,
                             static_argnums=(3, 4))(
        audio, whole, frac, tuple(offs), 1))
    dev = np.abs(ref.astype(np.float64) - got)
    assert (dev <= _lerp_tol(x0 * (np.float32(1.0) - f), got)).all()


def _jax_per_head(audio, whole, frac, ow, of):
    def fn(audio, whole, frac):
        buf = jnp.zeros(whole.shape, jnp.float32)
        for w_h, f_h in zip(ow, of):
            f2 = frac + f_h
            c2 = f2 >> jfq.POS_FRAC_BITS
            w2 = whole + w_h + c2
            f2 = f2 - (c2 << jfq.POS_FRAC_BITS)
            buf = buf + jfq.gather_linear_wrap(audio, w2, f2)
        return buf
    return np.asarray(jax.jit(fn)(audio, whole, frac))


@pytest.mark.parametrize("offs", OFFSETS + [(-1500.25, 0.5, 1999.75)],
                         ids=str)
def test_heads_read_per_head_matches_gather_linear_wrap(offs):
    """Form B against the JAX package's per-head ``gather_linear_wrap``
    sum (its render's read for fractional offsets and short tapes), with
    the config's gain."""
    audio, whole, frac = _read_case(3)
    split = [tfq.split_pos_np(o) for o in offs]
    ow, of = [s[0] for s in split], [s[1] for s in split]
    gain = float(np.float32(0.8 / len(offs)))
    got = tlr.heads_read_plain(torch.from_numpy(audio),
                               torch.from_numpy(whole),
                               torch.from_numpy(frac), ow, of, gain,
                               False).numpy()
    buf = np.zeros(len(whole), np.float32)
    tol = np.zeros(len(whole))
    for w_h, f_h in zip(ow, of):
        f2 = frac + f_h
        c2 = f2 >> tfq.POS_FRAC_BITS
        w2 = whole + w_h + c2
        f2 = f2 - (c2 << tfq.POS_FRAC_BITS)
        y = tfq.gather_linear_wrap_np(audio, w2, f2)
        fr = f2.astype(np.float32) * tfq.POS_INV_F
        tol += _lerp_tol((np.float32(1.0) - fr)
                         * audio[np.mod(w2, len(audio))], y)
        buf = buf + y
        tol += np.spacing(np.abs(buf))
    want = buf * np.float32(gain)
    assert np.array_equal(_bits(got), _bits(want))
    ref = _jax_per_head(audio, whole, frac, ow, of) * np.float32(gain)
    dev = np.abs(ref.astype(np.float64) - got)
    assert (dev <= tol * gain + np.spacing(np.abs(got))).all()
    # the fused read's dispatcher takes the plain version for CPU tensors;
    # under a unit envelope its f32 output is this read
    out = torch.empty(len(whole), dtype=torch.float32)
    again = tlr.scrub_read(torch.from_numpy(audio), torch.from_numpy(whole),
                           torch.from_numpy(frac), ow, of, gain, False,
                           torch.ones(len(whole)), 1, out).numpy()
    assert np.array_equal(_bits(again), _bits(got))


def test_heads_read_rejects_what_it_does_not_take():
    a = torch.zeros(8)
    w = torch.zeros(4, dtype=torch.int32)
    env, out = torch.ones(2), torch.zeros(4)

    def read(a=a, w=w, f=w, ow=(0,), of=(0,), summed=True, env=env, bs=2,
             out=out, t0=0, t1=None):
        return tlr.scrub_read(a, w, f, list(ow), list(of), 1.0, summed, env,
                              bs, out, t0, t1)

    with pytest.raises(TypeError):
        read(w=w.long(), f=w.long())
    with pytest.raises(ValueError):
        read(f=w[:3])
    with pytest.raises(ValueError):
        read(ow=(0, 1), summed=False)
    with pytest.raises(ValueError):
        read(of=(5,))                                   # fractional, A
    with pytest.raises(ValueError):
        read(a=a[:0])
    with pytest.raises(TypeError):
        read(out=out.double())
    with pytest.raises(ValueError):
        read(out=out[:3])
    with pytest.raises(ValueError):
        read(env=env[:1])                   # 2 samples a block, 4 samples
    with pytest.raises(ValueError):
        read(t0=3, t1=2)
    assert torch.equal(read(t0=1, t1=1), torch.zeros(4))   # nothing read


FUSED_HEADS = [(True, (-2000,), (0,)), (True, (-2000, 2000), (0, 0)),
               (True, (-2000, 0, 2000), (0, 0, 0)),
               (True, (-16001, 3, 31999), (0, 0, 0)),
               (False, (-1501,), (3145728,)),
               (False, (-700, 650), (2097152, 0)),
               (False, (-1501, 0, 1999), (3145728, 2097152, 1048576))]


def _fused_env(T, bs, seed):
    """A dropout-style envelope with zeros, fractions and gains above 1
    (so that the read clips at +-1)."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.float32([0.0, 0.65, 1.0, 0.3, 1.7, 2.5]),
                      -(-T // bs)).astype(np.float32)


def _fused_pair(audio, whole, frac, ow, of, gain, summed, env, bs, dtype,
                t0, t1):
    """(want, got): ``_finish(heads_read_plain(...))`` over the whole
    positions, cut to [t0, t1), and ``scrub_read_plain`` into a buffer
    holding a sentinel outside [t0, t1)."""
    a, w, f = (torch.from_numpy(x) for x in (audio, whole, frac))
    env_t = torch.from_numpy(env)
    want = ts._finish(tlr.heads_read_plain(a, w, f, list(ow), list(of), gain,
                                           summed),
                      env_t, bs, dtype == torch.int16)
    out = torch.full((len(whole),), 7, dtype=dtype)
    got = tlr.scrub_read_plain(a, w, f, list(ow), list(of), gain, summed,
                               env_t, bs, out, t0, t1)
    assert got is out and got.dtype == dtype
    assert (got[:t0] == 7).all() and (got[t1:] == 7).all()
    return want[t0:t1], got[t0:t1]


@pytest.mark.parametrize("t0,t1,bs", [(0, 1 << 16, 1024),
                                      (5120, 60001, 1000)],
                         ids=["whole", "segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16],
                         ids=["f32", "pcm16"])
@pytest.mark.parametrize("summed,ow,of", FUSED_HEADS, ids=str)
def test_scrub_read_plain_bit_equal_to_finish_of_heads_read(summed, ow, of,
                                                           dtype, t0, t1,
                                                           bs):
    """The fused plain read, envelope and PCM16 from a sample t0 on are
    ``_finish`` of the plain read: forms A and B with one to three heads,
    negative offsets and offsets past n, positions across the wrap at n
    (``_read_case``), an envelope with zeros and fractions, clipping."""
    audio, whole, frac = _read_case(6)
    T = len(whole) // bs * bs                  # a render's whole blocks
    whole, frac = whole[:T], frac[:T]
    gain = float(np.float32(1.25))            # with the envelope's 2.5: clips
    env = _fused_env(len(whole), bs, len(ow) + bs)
    want, got = _fused_pair(audio, whole, frac, ow, of, gain, summed, env,
                            bs, dtype, t0, t1)
    assert torch.equal(got, want)
    if dtype == torch.int16:                 # some samples clip, some are 0
        assert int((got == 32767).sum() + (got == -32768).sum()) > 0
        assert int((got == 0).sum()) > 0


@pytest.mark.parametrize("summed", [True, False], ids=["A", "B"])
def test_scrub_read_plain_pcm16_rounds_half_lsb_ties_to_even(summed):
    """Samples that land exactly on half an LSB (y * 32768 = k + 1/2) round
    to the even k, as ``torch.round`` and the JAX package's ``jnp.round``
    do, in the fused read as in ``_finish``."""
    k = np.arange(-40, 40)
    n = len(k) + 2
    audio = np.zeros(n, np.float32)
    audio[1:-1] = (k + 0.5) / 32768.0              # exact in f32
    whole = np.arange(1, n - 1, dtype=np.int32)
    frac = np.zeros(len(whole), np.int32)
    env = np.ones(1, np.float32)
    want, got = _fused_pair(audio, whole, frac, (0,), (0,), 1.0, summed, env,
                            len(whole), torch.int16, 0, len(whole))
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), np.rint(k + 0.5).astype(np.int16))
    assert not np.array_equal(got.numpy(), np.floor(k + 1.0))


def test_scrub_read_plain_matches_jax_tail():
    """The fused plain read of config 2's smoke positions against the JAX
    package's render tail (``buf * head_gain``, ``* repeat(env_blocks)``,
    ``clip(round(y * 32768))``) on the same positions, with JAX's blockwise
    read as ``buf``: float within a rounding step of the read, PCM16
    within 1 LSB."""
    audio, pj, pt = _programs("config2_smoke")
    w, f = _port_positions(pt)
    seg = pt["head_segments"][0]
    ow, gain = [int(v) for v in seg["off_whole"]], float(seg["gain"])
    T, bs = len(w), int(pt["block_size"])
    assert ts.reads_summed(T, len(audio), ts.program_span(pt),
                           seg["off_frac"])
    buf = jax.jit(js._read_blockwise_heads, static_argnums=(3, 4))(
        audio, w.numpy(), f.numpy(), tuple(ow), 1)
    y = buf * jnp.float32(gain) * jnp.repeat(jnp.asarray(pj["env_blocks"]),
                                             bs)
    want16 = np.asarray(jnp.clip(jnp.round(y * 32768.0), -32768.0, 32767.0)
                        .astype(jnp.int16))
    env = torch.from_numpy(pt["env_blocks"])
    got = tlr.scrub_read_plain(torch.from_numpy(audio), w, f, ow, [0] * 3,
                               gain, True, env, bs,
                               torch.empty(T, dtype=torch.float32))
    got16 = tlr.scrub_read_plain(torch.from_numpy(audio), w, f, ow, [0] * 3,
                                 gain, True, env, bs,
                                 torch.empty(T, dtype=torch.int16))
    dev = _dbfs(np.asarray(y), got.numpy())
    print(f"fused plain read vs JAX's tail: {dev:.2f} dBFS")
    assert dev <= TOL_DBFS
    assert np.abs(got16.numpy().astype(np.int32)
                  - want16.astype(np.int32)).max() <= 1


def test_sinc_wrap_twins():
    audio, whole, frac = _read_case(4, T=1 << 14)
    got = tfq.gather_sinc_wrap(torch.from_numpy(audio),
                               torch.from_numpy(whole),
                               torch.from_numpy(frac)).numpy()
    want_np = tfq.gather_sinc_wrap_np(audio, whole, frac)
    assert np.array_equal(_bits(want_np),
                          _bits(jfq.gather_sinc_wrap_np(audio, whole, frac)))
    want_jax = np.asarray(jax.jit(jfq.gather_sinc_wrap)(audio, whole, frac))
    assert got.dtype == np.float32
    assert np.abs(got - want_np).max() <= SINC_TOL
    assert np.abs(got - want_jax).max() <= SINC_TOL
    # frac 0 reads the sample itself (the other taps' weights are sin's
    # residue at whole multiples of pi)
    z = tfq.gather_sinc_wrap(torch.from_numpy(audio),
                             torch.from_numpy(whole),
                             torch.zeros(len(whole), dtype=torch.int32))
    assert np.abs(z.numpy() - audio[np.mod(whole, len(audio))]).max() \
        <= SINC_TOL


def test_sinc_clip_matches_jax():
    audio = goldens._test_audio()[:5000]
    rng = np.random.default_rng(5)
    whole = rng.integers(0, len(audio), 1 << 14).astype(np.int32)
    whole[:6] = [0, 1, 3, len(audio) - 1, len(audio) - 4, 7]
    frac = rng.integers(0, tfq.POS_ONE, len(whole)).astype(np.int32)
    frac[:3] = [-(1 << 20), 0, tfq.POS_ONE - 1]       # the reverse edge case
    got = tfq.gather_sinc_clip(torch.from_numpy(audio),
                               torch.from_numpy(whole),
                               torch.from_numpy(frac)).numpy()
    want = np.asarray(jax.jit(jfq.gather_sinc_clip)(audio, whole, frac))
    assert np.abs(got - want).max() <= SINC_TOL


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

def _renders(name, **over):
    (audio, cj, trj, kw), (_, ct, trt, _) = _pair(name)
    kw = {**kw, **over}
    want = js.render_scrub(audio, cj, trj, **kw)
    got = ts.render_scrub(audio, ct, trt, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("name", ["config2_smoke", "config2_scaled",
                                  "fractional_heads", "short_tape",
                                  "keys_fractional"])
def test_render_matches_jax(name):
    want, got = _renders(name, pcm16=False, stereo=False)
    T = CONFIGS[name](ts)[2].num_blocks * ts.BLOCK_SIZE
    assert got.shape == (T,) and got.dtype == np.float32
    dev = _dbfs(want, got)
    print(f"{name} render vs JAX: {dev:.2f} dBFS")
    assert dev <= TOL_DBFS
    assert np.abs(got).max() > 0.1
    want16, got16 = _renders(name, pcm16=True, stereo=False)
    assert got16.dtype == np.int16 and got16.shape == (T,)
    assert np.abs(got16.astype(np.int32) - want16.astype(np.int32)).max() \
        <= 1


def test_render_options_and_segments():
    """Stereo carries the mono render's samples; ``device_out`` returns
    the tensor; the live-control render reads one layout per segment."""
    audio, cfg, trace, kw = _keys_fractional(ts)
    prog = ts.build_scrub_program_cached(audio, cfg, trace, kw["tape_pos0"])
    assert len(prog["head_segments"]) == 5
    assert [len(s["off_whole"]) for s in prog["head_segments"]] \
        == [2, 2, 1, 3, 2]
    assert [bool(np.any(s["off_frac"])) for s in prog["head_segments"]] \
        == [True, False, False, False, False]
    st = ts.render_scrub(audio, cfg, trace, device="cpu", **kw)
    mono = ts.render_scrub(audio, cfg, trace, device="cpu",
                           tape_pos0=kw["tape_pos0"], pcm16=True)
    assert st.shape == (len(mono), 2) and st.dtype == np.int16
    assert np.array_equal(st[:, 0], mono) and np.array_equal(st[:, 1], mono)
    dv = ts.render_scrub(audio, cfg, trace, device="cpu", device_out=True,
                         tape_pos0=kw["tape_pos0"], pcm16=True)
    assert isinstance(dv, torch.Tensor) and np.array_equal(dv.numpy(), mono)
    # tape_pos0 moves the start: the first sample reads there
    y0 = ts.render_scrub(audio, cfg, trace, device="cpu", tape_pos0=0.0)
    y1 = ts.render_scrub(audio, cfg, trace, device="cpu", tape_pos0=1234.0)
    assert not np.array_equal(y0, y1)


@pytest.mark.parametrize("name,forms", [
    ("config2_smoke", ["A"]), ("config2_scaled", ["A"]), ("scrub", ["A"]),
    ("fractional_heads", ["B"]), ("short_tape", ["B"]),
    ("keys_fractional", ["B", "A", "A", "A", "A"]),
    ("scrub_keys", ["A"] * 6)])
def test_read_form_follows_the_jax_branch(name, forms):
    """Form A exactly where the JAX package takes its blockwise read with
    integer offsets (scrub.py:611, :683), one read per head layout."""
    audio, cfg, trace, kw = CONFIGS[name](ts)
    seen = []

    def spy(*args):
        seen.append("A" if args[6] else "B")
        return tlr.scrub_read(*args)

    with mock.patch.object(ts, "scrub_read", spy):
        ts.render_scrub(audio, cfg, trace, device="cpu", **kw)
    assert seen == forms


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_fingerprint(name):
    audio, cfg, trace, kw = CONFIGS[name](ts)
    y = ts.render_scrub(audio, cfg, trace, device="cpu", **kw)
    with open(goldens.GOLDEN_PATH) as f:
        want = json.load(f)[name]
    goldens._compare(name, goldens._fingerprint(y), want)
    ref = goldens.FIXTURES[name]()
    dev = _dbfs(ref, y)
    print(f"{name} render vs JAX: {dev:.2f} dBFS")
    assert dev <= (SINC_DBFS if kw.get("interp") == "sinc" else TOL_DBFS)


def test_render_segments_and_kernel_match_render_scrub():
    """The two public renders, called directly on a program, give
    ``render_scrub``'s samples."""
    audio, cfg, trace, kw = _golden_keys(ts)
    prog = ts.build_scrub_program(audio, cfg, trace, kw["tape_pos0"])
    span = ts.program_span(prog)
    y = ts.scrub_render_segments(prog, span, device="cpu")
    assert np.array_equal(y.numpy(), ts.render_scrub(audio, cfg, trace,
                                                     device="cpu", **kw))
    audio, cfg, trace, _ = _golden_scrub(ts)
    p = ts.build_scrub_program(audio, cfg, trace)
    y = ts.scrub_render_kernel(
        p["audio"], p["base_inc_q"], p["js_q"], p["seed"], p["mod_consts"],
        p["jump_flags"], p["seg_bases_whole"], p["seg_bases_frac"],
        p["env_blocks"], p["head_off_whole"], p["head_off_frac"],
        p["head_gain"], p["block_size"], ts.program_span(p), stereo=True,
        device="cpu")
    mono = ts.render_scrub(audio, cfg, trace, device="cpu")
    assert y.shape == (len(mono), 2)
    assert np.array_equal(y[:, 1].numpy(), mono)


_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from audio_suite_torch.models import scrub
sr = 48000
rng = np.random.default_rng(7)
t = np.arange(2 * sr) / sr
x = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
     + 0.1 * rng.standard_normal(t.size))
audio = (x / np.max(np.abs(x))).astype(np.float32)
cfg = scrub.ScrubConfig(sample_rate=sr, head_count=3)
trace = scrub.scripted_gesture_trace(
    93, sr, drag_events=[(0.1, 8.0, 0.2), (0.7, -14.0, 0.3)],
    base_speed=0.5, jumps=[(1.0, 1000.0)])
y = scrub.render_scrub(audio, cfg, trace, pcm16=True, device="cpu")
assert y.shape == (95232,) and y.dtype == np.int16, y.shape
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

"""The port's twin of ``tests/test_fuzz.py``: the same seeded random
configurations (``tests/test_fuzz.py:19-116``) through the port and the
JAX package, both on the CPU, held at PERF.md section 2's gates, one case
a seed:

- Microsound, seeds 1-8: within -100 dBFS;
- tape, seeds 11-14, on each of the three engines (device, segment,
  scan): within -120 dBFS;
- scrub, seeds 21-23, with the linear and the sinc read: within -120
  dBFS;
- Pattern Lab, seeds 31-36: within -60 dBFS of JAX's jitted render (its
  DAC steps flip where XLA contracts, ROADMAP.md section 3).

Each port render also meets ``test_fuzz.py``'s own checks: its shape,
finite samples, the peak within full scale.
"""
import numpy as np
import pytest
import torch

from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.models import patternlab as jpl
from audio_suite_tpu.models import scrub as jscrub
from audio_suite_tpu.models import tape as jtape
from audio_suite_tpu.utils.metrics import max_dev_dbfs
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.models import patternlab as tpl
from audio_suite_torch.models import scrub as tscrub
from audio_suite_torch.models import tape as ttape

torch.set_num_threads(1)


def _finite(x):
    return bool(np.all(np.isfinite(np.asarray(x))))


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_microsound_fuzz_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mode = jms.GEN_MODES[int(rng.integers(0, len(jms.GEN_MODES)))]
    d = dict(
        gen_mode=mode,
        base_sr=int(rng.choice([8000, 16000, 44100])),
        out_dur_s=float(rng.uniform(0.05, 0.6)),
        time_unfold=float(rng.uniform(1.0, 30.0)),
        micro_ms=float(rng.uniform(0.2, 8.0)),
        grains_per_sec=float(rng.uniform(0.0, 60.0)),
        max_grains=int(rng.integers(1, 48)),
        partial_stretch=float(rng.uniform(0.25, 4.0)),
        partial_lock_on=bool(rng.integers(0, 2)),
        nl_warp_on=bool(rng.integers(0, 2)),
        cep_warp_on=bool(rng.integers(0, 2)),
        nl_warp_power=float(rng.uniform(0.5, 2.5)),
        cep_factor=float(rng.uniform(0.5, 2.0)),
        bandlimit_on=bool(rng.integers(0, 2)),
        res_bank_on=bool(rng.integers(0, 2)),
        wg_on=bool(rng.integers(0, 2)),
        event_feedback_on=bool(rng.integers(0, 2)),
        spectral_imprint_on=bool(rng.integers(0, 2)),
        er_cloud_on=bool(rng.integers(0, 2)), er_taps=32, er_max_ms=10.0,
        stereo_on=bool(rng.integers(0, 2)),
        grain_offset_on=bool(rng.integers(0, 2)),
        event_process=str(rng.choice(
            ["Poisson", "Single", "Clustered", "Hawkes"])),
        unfold_mode=str(rng.choice(
            ["Classic reinterpret", "Multiband"])),
        seed=int(rng.integers(0, 99999)))
    pj = jms.MicrosoundParams.from_dict(d)
    pt = tms.MicrosoundParams.from_dict(d)
    want, _ = jms.render(pj)
    got, meta = tms.render(pt, device="cpu")
    got = got.numpy()
    assert got.shape == (int(max(1, round(pt.out_dur_s * pt.base_sr))), 2)
    assert _finite(got)
    assert float(np.max(np.abs(got))) <= 1.0 + 1e-5
    assert max_dev_dbfs(want, got) <= -100.0, (mode, meta["events"])


def _tape_case(seed):
    """tests/test_fuzz.py:53-73's configuration for ``seed``."""
    rng = np.random.default_rng(seed)
    sr = 8000
    n = int(rng.integers(2000, 30000))
    audio = (rng.standard_normal(n) * 0.4).astype(np.float32)
    n_marks = int(rng.integers(0, 5))
    markers = sorted(int(v) for v in rng.integers(1, max(2, n - 1),
                                                  n_marks))
    k = len(markers) + 1
    kw = dict(
        sample_rate=sr, markers=markers,
        section_speeds=[float(rng.uniform(-4.0, 4.0)) or 1.0
                        for _ in range(k)],
        section_reverse=[bool(rng.integers(0, 2)) for _ in range(k)],
        tape_age=int(rng.integers(0, 101)),
        inertia_enabled=bool(rng.integers(0, 2)),
        inertia_amount=int(rng.integers(0, 101)),
        enable_splice_fx=bool(rng.integers(0, 2)),
        anticlick_enabled=bool(rng.integers(0, 2)))
    frames = int(rng.integers(500, 20000))
    return audio, kw, frames


@pytest.mark.parametrize("engine", ["device", "segment", "scan"])
@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_tape_fuzz_matches_jax(seed, engine):
    audio, kw, frames = _tape_case(seed)
    want = jtape.render_tape(audio, jtape.TapeParams(**kw), frames,
                             engine=engine)
    got = ttape.render_tape(audio, ttape.TapeParams(**kw), frames,
                            engine=engine, device="cpu")
    assert got.shape == (frames,) and _finite(got)
    assert max_dev_dbfs(want, got) <= -120.0


@pytest.mark.parametrize("interp", ["linear", "sinc"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_scrub_fuzz_matches_jax(seed, interp):
    rng = np.random.default_rng(seed)
    sr = 8000
    audio = (rng.standard_normal(int(rng.integers(3000, 20000)))
             * 0.4).astype(np.float32)
    heads = int(rng.integers(1, 4))
    blocks = int(rng.integers(5, 60))
    drag = (float(rng.uniform(0, 0.5)), float(rng.uniform(-6, 6)),
            float(rng.uniform(0.05, 0.5)))
    base_speed = float(rng.uniform(-2, 2))
    jump = (float(rng.uniform(0, 0.5)), float(rng.uniform(0, len(audio))))
    out = {}
    for tag, m in (("jax", jscrub), ("torch", tscrub)):
        cfg = m.ScrubConfig(sample_rate=sr, seed=seed, head_count=heads)
        trace = m.scripted_gesture_trace(blocks, sr, drag_events=[drag],
                                         base_speed=base_speed,
                                         jumps=[jump])
        kw = {"device": "cpu"} if tag == "torch" else {}
        out[tag] = m.render_scrub(audio, cfg, trace, interp=interp, **kw)
    got = out["torch"]
    assert got.shape == (blocks * tscrub.BLOCK_SIZE,) and _finite(got)
    assert max_dev_dbfs(out["jax"], got) <= -120.0


@pytest.mark.parametrize("seed", [31, 32, 33, 34, 35, 36])
def test_patternlab_fuzz_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(sample_rate=22050, seconds=float(rng.uniform(0.3, 1.5)),
              bpm=int(rng.integers(60, 200)), seed=seed)
    gen = str(rng.choice([g for g in jpl.list_generators()
                          if g != "Python Script"]))
    rc_j, rc_t = jpl.RenderConfig(**kw), tpl.RenderConfig(**kw)
    want, _ = jpl.render(jpl.generate(gen, rc_j), rc_j)
    got, _ = tpl.render(tpl.generate(gen, rc_t), rc_t, device="cpu")
    assert _finite(got)
    assert float(np.max(np.abs(got))) <= 1.0 + 1e-5
    assert max_dev_dbfs(want, got) <= -60.0, gen

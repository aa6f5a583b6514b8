"""The port's Pattern Lab render held against the JAX package on the long
configuration of tests/test_patternlab.py:151-170: 62 s at 44.1 kHz, 3 072
notes from eight seeded Glass Cells + Fibonacci Gate passes.  FM feedback
amplifies error at length, so the port is held to the jitted JAX render
here too, with the bound of tests/test_torch_patternlab.py (its module
docstring says why a render is held at -60 dBFS with sparse DAC-step
flips).  A file of its own, so a distributing test runner gives it its own
worker.
"""
import numpy as np
import torch

from audio_suite_tpu.models import patternlab as jpl
from audio_suite_torch.models import patternlab as tpl

from test_torch_patternlab import _assert_render_close

torch.set_num_threads(1)

SR = 44100


def _long_events(mod):
    cfg = mod.RenderConfig(sample_rate=SR, seconds=62.0, bpm=140.0, seed=5)
    events = []
    for k in range(8):
        c2 = mod.RenderConfig(sample_rate=SR, seconds=62.0, bpm=140.0,
                              seed=5 + k)
        evs = (mod.generate("Glass Cells", c2)
               + mod.generate("Fibonacci Gate", c2))
        for e in evs:
            e.t0 += k * 7.75
        events.extend(evs)
    return events, cfg


def test_long_render_matches_jax():
    ev_j, cfg_j = _long_events(jpl)
    ev_t, cfg_t = _long_events(tpl)
    assert len(ev_t) == len(ev_j) == 3072
    want, _ = jpl.render(ev_j, cfg_j)
    got, _ = tpl.render(ev_t, cfg_t, device="cpu")
    assert got.shape == want.shape == (62 * SR,)
    assert np.max(np.abs(got)) > 0.01
    _assert_render_close(want, got, SR, "long, 62 s")

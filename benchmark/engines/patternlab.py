"""Pattern Lab through the port's public entry.

A request is a ``RenderConfig`` dict: the configuration's settings with
the traffic's fields over them.  The window calls ``patternlab.generate``
for each of the configuration's generators, merges their events, then
``patternlab.render(events, cfg, pcm16=True, device=...)``, which returns
the mono int16 PCM on the host.  A new events list each request misses the
render memo, as a user's Render after a change does.  The traced run does
what ``render`` does on that miss, in the benchmark's spans: the host
pre-pass (generators, time ops, ``MegaDriveInspiredSynth.prepare``), then
``render_prepared(..., device_out=True, pcm16=True)`` and the pull.

``FAULTS``: the check's tests break the overlap-add (its buffer handed
back; half the notes) and alter a sample of ``_render_dispatch``'s PCM.
``PROGRAM_SPANS``: ``render``'s spans (``models/patternlab.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark import faults

FAULTS = {"state_unchanged": faults.overlap_add_unchanged,
          "half_batch": faults.overlap_add_half,
          "answer_altered": faults.sample_altered(
              "audio_suite_torch.models.patternlab", "_render_dispatch")}
PROGRAM_SPANS = {
    "root": "patternlab.render",
    "last": "patternlab.master",
    "wraps": {"host_prepare": ["patternlab.generate", "patternlab.time_ops",
                               "patternlab.pack", "patternlab.upload"],
              "dispatch": ["patternlab.bank", "patternlab.master"]},
    "upload": "patternlab.upload",
}


def setup(config: dict, seed: int, device: str):
    import torch
    from audio_suite_torch.models import patternlab as pl
    return SimpleNamespace(pl=pl, torch=torch, device=device,
                           settings=dict(config["render_config"]),
                           generators=list(config["generators"]))


def request(state, fields: dict) -> dict:
    c = {**state.settings, **fields}
    return {"settings": c, "cfg": state.pl.RenderConfig(**c)}


def _events(state, cfg):
    events = []
    for name in state.generators:
        events.extend(state.pl.generate(name, cfg))
    return events


def render(state, req) -> np.ndarray:
    cfg = req["cfg"]
    y, _ = state.pl.render(_events(state, cfg), cfg, pcm16=True,
                           device=state.device)
    return y


def render_traced(state, req, span) -> np.ndarray:
    pl, cfg = state.pl, req["cfg"]
    with span("host_prepare"):
        ev = pl.apply_time_ops(_events(state, cfg), cfg)
        synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=cfg.seed,
                                          device=state.device)
        prep = synth.prepare(ev, cfg.seconds)
    with span("dispatch"):
        y = synth.render_prepared(prep, master_gain=cfg.master_gain,
                                  device_out=True, pcm16=True)
    with span("device_wait"):
        if state.device.startswith("cuda"):
            state.torch.cuda.synchronize()
    with span("pull"):
        return y.cpu().numpy()


def audio_seconds(state, req) -> float:
    return float(req["settings"]["seconds"])


def release(state):
    """The render memo keeps the last programs on the card; drop them."""
    state.pl._RENDER_CACHE.clear()


def reference(state, req, q=None) -> np.ndarray:
    from benchmark.reference import patternlab as ref
    kw = {} if q is None else {"q": q}
    return ref.render(req["settings"], state.generators, **kw)

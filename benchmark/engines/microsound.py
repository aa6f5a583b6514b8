"""Microsound through the port's public entry.

A request is a full ``MicrosoundParams`` dict: the configuration's
parameters with the traffic's fields over them.  The window calls
``microsound.render(params, ir_audio=ir, pcm16=True, device=...)`` and
pulls the int16 stereo PCM to the host.  The traced run calls the two
halves of ``render`` (``build_program``, then the space kernels and
``render_program``) inside the benchmark's spans.  The IR is made from
the run's seed as bench config 3 makes its own: an 8 192-tap decaying
Gaussian noise.

``FAULTS``: the check's tests break the overlap-add (its buffer handed
back; half the grains) and alter a sample of ``fx_body``'s PCM.
``PROGRAM_SPANS``: ``render``'s spans (``models/microsound.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark import faults
from benchmark.generator import seed_words

FAULTS = {"state_unchanged": faults.overlap_add_unchanged,
          "half_batch": faults.overlap_add_half,
          "answer_altered": faults.sample_altered(
              "audio_suite_torch.models.microsound", "fx_body")}
PROGRAM_SPANS = {
    "root": "microsound.render",
    "last": "microsound.fx",
    "wraps": {"host_build": ["microsound.build"],
              "space_kernels": ["microsound.space_kernels"],
              "dispatch": ["microsound.upload", "microsound.chain",
                           "microsound.fx"]},
    "upload": "microsound.upload",
}


def setup(config: dict, seed: int, device: str):
    import torch
    from audio_suite_torch.models import microsound as ms
    ir_cfg = config["ir"]
    rng = np.random.default_rng(seed_words(seed) + [ir_cfg["stream"]])
    n = int(ir_cfg["taps"])
    ir = (rng.standard_normal(n) * np.exp(-np.arange(n) / ir_cfg["decay"])
          ).astype(np.float32)
    return SimpleNamespace(ms=ms, torch=torch, device=device, ir=ir,
                           params=dict(config["params"]))


def request(state, fields: dict) -> dict:
    p = {**state.params, **fields}
    return {"params": p, "obj": state.ms.MicrosoundParams.from_dict(p)}


def render(state, req) -> np.ndarray:
    y, _ = state.ms.render(req["obj"], ir_audio=state.ir, pcm16=True,
                           device=state.device)
    return y.cpu().numpy()


def render_traced(state, req, span) -> np.ndarray:
    ms, p = state.ms, req["obj"]
    with span("host_build"):
        prog = ms.build_program(p, ir_audio=state.ir)
    with span("space_kernels"):
        kernels = ms._space_kernels(p, state.ir)
    with span("dispatch"):
        y, _ = ms.render_program(p, prog, kernels, device=state.device,
                                 pcm16=True)
    with span("device_wait"):
        if state.device.startswith("cuda"):
            state.torch.cuda.synchronize()
    with span("pull"):
        return y.cpu().numpy()


def audio_seconds(state, req) -> float:
    return float(req["params"]["out_dur_s"])


def release(state):
    """Nothing of the program's stays on the card between renders."""


def reference(state, req, q=None) -> np.ndarray:
    from benchmark.reference import microsound as ref
    kw = {} if q is None else {"q": q}
    return ref.render(req["params"], state.ir, **kw)

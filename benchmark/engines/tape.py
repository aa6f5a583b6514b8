"""TapeTUC through the port's public entry.

A request is a ``TapeParams``: the configuration's parameters, whose
section speeds set-up fitted once to the tape's length, with the
traffic's ``factor`` on the speed of its ``section``, then Fit to Target
Time to its ``target_seconds`` (``tape.fit_to_target_time``,
Tape…py:665-705), as a user nudges one section's speed and re-fits the
chop to its length.  Every request's speeds differ, so each render misses
the program memo and pays the host's C++ table walk.  The window calls
``tape.render_tape(tape, params, pcm16=True, device=...)``, which returns
the mono int16 PCM made on the card.  The tape is made from the run's
seed as bench config 1 makes its own (two sines and white noise,
normalised) and goes to the card once in set-up, as the app loads a WAV
once and renders it many times.  The traced run does what ``render_tape``
does, in the benchmark's spans: the program's build, tables and upload,
then its two device stages (``varispeed.tape_device_render``) and the
pull.

``FAULTS``: the check's tests break the linear read (the tape handed back
unread; half the samples left out) and alter a sample of
``tape_device_render``'s PCM.  ``PROGRAM_SPANS``: ``render_tape``'s spans
(``models/tape.py``, ``ops/varispeed.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark import faults
from benchmark.generator import seed_words


def _read_unchanged(monkeypatch):
    """The read hands back the tape's first T samples (wrapping), unread."""
    import torch
    from audio_suite_torch.ops import varispeed

    def unread(audio, idx0, fr):
        t = torch.arange(idx0.shape[0], device=audio.device)
        return audio[t % audio.shape[0]]
    monkeypatch.setattr(varispeed, "lerp_read", unread)


def _read_half(monkeypatch):
    """Half the samples left out of the read (the second half reads 0)."""
    from audio_suite_torch.ops import varispeed
    orig = varispeed.lerp_read

    def half(audio, idx0, fr):
        h = idx0.shape[0] // 2
        out = audio.new_zeros(idx0.shape[0])
        out[:h] = orig(audio, idx0[:h], fr[:h])
        return out
    monkeypatch.setattr(varispeed, "lerp_read", half)


FAULTS = {"state_unchanged": _read_unchanged,
          "half_batch": _read_half,
          "answer_altered": faults.sample_altered(
              "audio_suite_torch.ops.varispeed", "tape_device_render")}
PROGRAM_SPANS = {
    "root": "tape.render",
    "last": "tape.read",
    "wraps": {"host_prepare": ["tape.build", "tape.tables", "tape.upload"],
              "dispatch": ["tape.positions", "tape.read"]},
    "upload": "tape.upload",
}


def setup(config: dict, seed: int, device: str):
    import torch
    from audio_suite_torch.models import tape
    from audio_suite_torch.ops import varispeed
    tc = config["tape"]
    sr = int(tc["sample_rate"])
    n = int(sr * tc["seconds"])
    rng = np.random.default_rng(seed_words(seed) + [tc["stream"]])
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(n))
    host = (x / np.max(np.abs(x))).astype(np.float32)
    base = tape.TapeParams(markers=[int(n * f) for f in
                                    tc["marker_fractions"]],
                           **config["params"])
    base.section_speeds = tape.fit_to_target_time(base, n, tc["seconds"])
    return SimpleNamespace(tape=tape, varispeed=varispeed, torch=torch,
                           device=device, host=host, n=n, base=base,
                           audio=torch.as_tensor(host, device=device))


def request(state, fields: dict) -> dict:
    tp = state.tape
    p = tp.TapeParams.from_snapshot(state.base.snapshot())
    p.section_speeds[int(fields["section"])] *= float(fields["factor"])
    p.section_speeds = tp.fit_to_target_time(p, state.n,
                                             float(fields["target_seconds"]))
    return {"params": p, "fields": p.snapshot(),
            "frames": tp.section_render_length(p, state.n)}


def render(state, req) -> np.ndarray:
    return state.tape.render_tape(state.audio, req["params"], pcm16=True,
                                  device=state.device)


def render_traced(state, req, span) -> np.ndarray:
    tp = state.tape
    with span("host_prepare"):
        prog = tp.build_tape_program_cached(state.audio, req["params"],
                                            req["frames"],
                                            device=state.device)
        tp.program_tables(prog)
        tab = tp.device_tables(prog)
    with span("dispatch"):
        y = state.varispeed.tape_device_render(
            prog["audio"], tab, prog["consts"], prog["num_frames"],
            out_i16=True)
    with span("device_wait"):
        if state.device.startswith("cuda"):
            state.torch.cuda.synchronize()
    with span("pull"):
        return y.cpu().numpy()


def audio_seconds(state, req) -> float:
    return req["frames"] / float(req["params"].sample_rate)


def release(state):
    """The program memo keeps the last programs' tables on the card; drop
    them."""
    state.tape._TAPE_PROG_CACHE.clear()


def reference(state, req, q=None) -> np.ndarray:
    from benchmark.reference import tape as ref
    kw = {} if q is None else {"q": q}
    return ref.render(req["fields"], state.host, **kw)

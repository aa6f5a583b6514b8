"""Faults that the check's tests plant in the program's timed path.

A fault is a function of pytest's ``monkeypatch`` that breaks the port
underneath a run; the run has to come out not correct.  Each engine names
one of every kind in ``KINDS`` in ``engines/<engine>.py:FAULTS``, planted
where its own render does that work, from the helpers here or its own.
The harness never plants one.
"""
from __future__ import annotations

import importlib

KINDS = ("state_unchanged",     # a stage hands its input back
         "half_batch",          # half the batch left out
         "answer_altered")      # one PCM sample altered where produced


def overlap_add_unchanged(monkeypatch):
    """The overlap-add step hands its buffer back unchanged."""
    from audio_suite_torch.ops import overlap_add as oa
    monkeypatch.setattr(oa, "overlap_add", lambda out, vals, starts: out)


def overlap_add_half(monkeypatch):
    """Half the windows (grains or notes) left out of the overlap-add."""
    from audio_suite_torch.ops import overlap_add as oa
    orig = oa.overlap_add
    monkeypatch.setattr(oa, "overlap_add", lambda out, vals, starts: orig(
        out, vals[: vals.shape[0] // 2], starts[: starts.shape[0] // 2]))


def sample_altered(module: str, attr: str):
    """The fault that alters one sample of the tensor ``module.attr``
    returns, by 1 000 steps."""
    def plant(monkeypatch):
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)

        def altered(*a, **k):
            y = fn(*a, **k).clone()
            y.view(-1)[y.numel() // 3] += 1000
            return y
        monkeypatch.setattr(mod, attr, altered)
    return plant

"""Microsound's progress callback (``render(..., progress=)``) against the
JAX package's on the CPU: the same ``(pct, msg)`` list for a render of one
chunk, of several (an explicit ``event_chunk`` on both sides: JAX's
default chunks by sixteenth-octave buckets) and of no event; the
callback changes neither the audio nor the ops the render runs (every
aten op of the render logged with and without it: no extra op, no
``.item()``), and ``render_program`` passes it through."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audio_suite_tpu.models import microsound as jms
from audio_suite_torch.models import microsound as tms

import test_microsound

torch.set_num_threads(1)


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched while active, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _params(**kw):
    pj = test_microsound.small_params(**kw)
    return pj, tms.MicrosoundParams.from_dict(pj.to_dict())


def _calls():
    seen = []
    return seen, lambda pct, msg: seen.append((pct, msg))


@pytest.mark.parametrize("chunk,n_chunks", [(3, None), (4, None), (16, 1)])
def test_progress_matches_jax(chunk, n_chunks):
    pj, pt = _params(gen_mode="Gaussian click")
    want, cb = _calls()
    jms.render(pj, event_chunk=chunk, progress=cb)
    got, cb = _calls()
    _, meta = tms.render(pt, device="cpu", event_chunk=chunk, progress=cb)
    assert got == want
    chunks = -(-meta["events"] // chunk)
    assert chunks == (n_chunks or chunks) and (n_chunks or chunks >= 3)
    assert got[-1] == (100, "Done.")
    assert len(got) == (1 if chunks == 1 else chunks + 1)
    if chunks > 1:
        assert got[-2] == (75, f"Events chunk {chunks}/{chunks}")


def test_progress_without_events_matches_jax():
    pj, pt = _params(gen_mode="Noise burst", max_grains=0)
    want, cb = _calls()
    jms.render(pj, progress=cb)
    got, cb = _calls()
    _, meta = tms.render(pt, device="cpu", progress=cb)
    assert meta["events"] == 0
    assert got == want == [(100, "Done.")]


@pytest.mark.parametrize("chunk", [4, None])
def test_progress_adds_no_op(chunk):
    """The same aten ops, in the same order, and the same samples with
    the callback as without it (feedback and imprint on: the carry
    crosses the chunks)."""
    _, pt = _params(gen_mode="Gaussian click", event_feedback_on=True,
                    event_feedback_amt=0.3, spectral_imprint_on=True)
    runs = {}
    for tag, cb in (("off", None), ("on", lambda pct, msg: None)):
        with _OpLog() as log:
            y, _ = tms.render(pt, device="cpu", event_chunk=chunk,
                              progress=cb)
        runs[tag] = (y, log.ops)
    (y0, ops0), (y1, ops1) = runs["off"], runs["on"]
    assert torch.equal(y0, y1)
    assert ops1 == ops0 and len(ops0) > 100
    assert not any("_local_scalar_dense" in op for op in ops0[-50:])


def test_render_program_passes_progress():
    _, pt = _params(gen_mode="Gaussian click")
    prog = tms.build_program(pt)
    got, cb = _calls()
    tms.render_program(pt, prog, tms._space_kernels(pt, None, device="cpu"),
                       device="cpu", event_chunk=4, progress=cb)
    n = -(-prog["E"] // 4)
    assert got == [(int(5 + 70 * (ci + 1) / n), f"Events chunk {ci + 1}/{n}")
                   for ci in range(n)] + [(100, "Done.")]
    assert np.all(np.diff([p for p, _ in got]) >= 0)

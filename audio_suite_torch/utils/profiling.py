"""Render observability — the port of audio_suite_tpu/utils/profiling.py:
per-render meta (peak dBFS, realtime factor, duration), a stage timer,
device traces on ``torch.profiler`` — and the port's tracer, spans at the
stages of a render.

The framework's first-class metric is audio-seconds rendered per wall
second (BASELINE.md), so every CLI render reports it.  ``peak_dbfs`` and
``render_meta`` take a NumPy array or a tensor on any device; a tensor is
pulled to the host once.

The tracer.  ``with span("<engine>.<stage>", **attrs):`` marks a stage.
Off, the default, a span is one test of a module flag and a shared null
context: it records nothing and makes no torch call.  On (``enable()``,
or inside ``device_trace``), each span keeps a ``Span`` record: its name
and attributes, its start and end on the Unix-epoch clock
(``time.time_ns``, the clock ``torch.profiler`` stamps its events with),
its parent, and a request id shared by every span under one root (a span
opened with no span open is a root).  Under a running ``torch.profiler``
a span is also a ``record_function`` range of its name, so a trace shows
each stage beside the kernels it launched.  A device stage
(``device=`` the stage's device) on a CUDA device records a timing event
on the current stream at each end; the pair is read once it has
completed, at a later device stage's end or in ``records()``, so tracing
adds no synchronization to a render.  While tracing is on, every
host-device synchronization torch makes is counted against the innermost
open span: torch's sync debug mode is set to warn, and its warnings are
counted, not shown.  Records are kept in memory, the newest
``CAPACITY``; older ones are dropped and counted (``dropped()``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch


def _host(audio) -> np.ndarray:
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)


def peak_dbfs(audio) -> float:
    audio = _host(audio)
    m = float(np.max(np.abs(audio))) if audio.size else 0.0
    if m <= 0:
        return float("-inf")
    return 20.0 * float(np.log10(m))


def render_meta(audio, sample_rate: int, wall_seconds: float) -> dict:
    audio = _host(audio)
    dur = audio.shape[0] / float(sample_rate)
    return {
        "seconds": round(dur, 6),
        "sample_rate": int(sample_rate),
        "peak_dbfs": round(peak_dbfs(audio), 2),
        "wall_s": round(wall_seconds, 4),
        "rtf": round(dur / wall_seconds, 2) if wall_seconds > 0 else None,
    }


class StageTimer:
    """Named wall-clock stages; `report()` gives an ordered dict."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> dict:
        return {k: round(v, 4) for k, v in self.stages.items()}


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

CAPACITY = 1 << 18            # records kept; older ones are dropped
SYNC_WARNING = "called a synchronizing CUDA operation"   # torch's text

_on = False
_store: deque = deque(maxlen=CAPACITY)
_pending: deque = deque()     # device stages whose events are unread
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()    # each thread's stack of open spans
_saved = None   # (warnings context, sync debug mode or None, showwarning)


class _Null:
    """The span of a tracer that is off: enters and leaves, keeps nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def set(self, **attrs):
        pass


_NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """A stage's record.  ``start_ns`` / ``end_ns``: Unix-epoch ns;
    ``parent``: the enclosing span's ``id`` (None for a root);
    ``request``: the root's ``id``; ``syncs``: host-device
    synchronizations while it was the innermost open span;
    ``stream_ms``: a device stage's time on its CUDA stream from its
    first event to its last (None elsewhere, and until read)."""
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns",
                 "end_ns", "syncs", "stream_ms", "_events", "_stream",
                 "_range")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.syncs, self.stream_ms = 0, None
        self._events = self._stream = self._range = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def set(self, **attrs):
        """Add attributes known only inside the stage."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.request = top.request if top is not None else self.id
        self.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._events is not None:
            self._events[0].record(self._stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end_ns = time.time_ns()
        _keep(self)
        return False


def span(name: str, device=None, **attrs):
    """A context manager for one stage named ``<engine>.<stage>``;
    ``device``, where given, makes it a device stage on that device.  Its
    ``set(**attrs)`` adds attributes inside the stage."""
    if not _on:
        return _NULL
    return Span(name, device, attrs)


def _keep(sp: Span):
    global _dropped
    with _lock:
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(sp)
        if sp._events is not None:
            _pending.append(sp)
    if sp._events is not None:
        _read_events(wait=False)


def _read_events(wait: bool):
    """Read the pending device stages' event pairs in the order they
    closed: those completed, or with ``wait`` all of them."""
    with _lock:
        while _pending:
            sp = _pending[0]
            start, end = sp._events
            if wait:
                end.synchronize()
            elif not end.query():
                break
            sp.stream_ms = start.elapsed_time(end)
            sp._events = sp._stream = None
            _pending.popleft()


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    """Counts torch's sync warnings against the innermost open span; other
    warnings go on to the hook that was in place."""
    if str(message).startswith(SYNC_WARNING):
        stack = _stack()
        if stack:
            stack[-1].syncs += 1
        return
    _saved[2](message, category, filename, lineno, file, line)


def enable():
    """Turn the tracer on (no-op when on): spans record, and torch's
    host-device synchronizations are counted."""
    global _on, _saved
    if _on:
        return
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING,
                            category=UserWarning)
    mode = torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_available() else None
    _saved = (ctx, mode, warnings.showwarning)
    warnings.showwarning = _showwarning
    if mode is not None:
        torch.cuda.set_sync_debug_mode("warn")
    _on = True


def disable():
    """Turn the tracer off; the warning hooks and torch's sync debug mode
    are as they were before ``enable()``.  Records stay."""
    global _on, _saved
    if not _on:
        return
    _on = False
    ctx, mode, _ = _saved
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    ctx.__exit__(None, None, None)
    _saved = None


def enabled() -> bool:
    return _on


def records() -> list[Span]:
    """The kept records, in the order their spans closed, with every
    device stage's ``stream_ms`` read (waiting for its events)."""
    _read_events(wait=True)
    with _lock:
        return list(_store)


def dropped() -> int:
    """Records dropped from the full store since the last ``reset()``."""
    return _dropped


def reset():
    """Forget every record and the drop count."""
    global _dropped
    with _lock:
        _store.clear()
        _pending.clear()
        _dropped = 0


@contextmanager
def device_trace(trace_dir: str | None, device=None):
    """Trace the enclosed region with ``torch.profiler`` and write it as a
    Chrome / Perfetto trace JSON, ``trace_<pid>_<ns>.json`` under
    ``trace_dir``: host activity always, the card's kernels too when
    ``device`` is a CUDA device, and the tracer on for the region, so each
    span is a range.  No-op when trace_dir is falsy, so callers can thread
    a CLI flag straight through.  The profiler synchronizes the card when
    it stops, at the region's end, and nowhere inside it; traced runs
    carry its overhead and are not timings."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was_on = _on
    enable()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        if not was_on:
            disable()
        prof.export_chrome_trace(os.path.join(
            str(trace_dir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A ``torch.profiler.record_function`` range: labels a host region so
    it shows on the captured timeline beside the device's kernels."""
    return torch.profiler.record_function(name)

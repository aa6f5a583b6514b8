"""The traced run's instruments, all in the benchmark's own files: host
spans around the program's public calls, recorders of a kernel wrapper's
arguments, and the reduction of a ``torch.profiler`` slice of renders to
device operations, busy time and idle gaps.

A span is named by the engine (``host_build``, ``dispatch``, ``pull``...);
inside the profiled slice it is also a ``record_function`` range
``bench.<name>``, which labels the device's idle gaps by what the host was
doing.  Nothing here is imported by the untraced run's window.
"""
from __future__ import annotations

import importlib
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

PREFIX = "bench."


class Spans:
    """Host seconds of each named span; ranges for the profiler while
    ``annotate`` is on."""

    def __init__(self):
        self.s = defaultdict(list)
        self.annotate = False

    @contextmanager
    def __call__(self, name: str):
        rf = None
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name].append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def mean_ms(self, name: str):
        v = self.s.get(name)
        return 1e3 * sum(v) / len(v) if v else None


class Recorder:
    """While ``on``, records ``shape(*args)`` of each call of the program's
    ``module.attr`` (a kernel's launch wrapper); installed only around the
    profiled slice, and removed after it."""

    def __init__(self, module: str, attr: str, shape):
        self.module, self.attr, self.shape = module, attr, shape
        self.calls, self.on, self._orig = [], False, None

    def install(self):
        mod = importlib.import_module(self.module)
        self._orig = orig = getattr(mod, self.attr)

        def wrapped(*args, **kwargs):
            if self.on:
                self.calls.append(self.shape(*args, **kwargs))
            return orig(*args, **kwargs)
        # the wrapper carries the function's attributes (a launch counter
        # that the function updates through its module's name) while it
        # stands in, and hands them back
        wrapped.__dict__.update(orig.__dict__)
        setattr(mod, self.attr, wrapped)
        self._wrapped = wrapped

    def remove(self):
        if self._orig is not None:
            self._orig.__dict__.update(self._wrapped.__dict__)
            setattr(importlib.import_module(self.module), self.attr,
                    self._orig)
            self._orig = None


@dataclass
class Slice:
    """A profiled slice of ``renders`` renders.  Times in seconds from the
    slice's start; ``window_s`` runs from the first render's start to the
    last one's end (each ends with its PCM on the host)."""
    renders: int
    window_s: float
    device_ops: list            # (name, start, end), kernels, copies, sets
    annotations: list           # (span name, start, end), host side
    records: dict = field(default_factory=dict)   # recorder key -> calls

    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device_ops], 0.0,
                       self.window_s)

    def ops_named(self, part: str) -> list:
        return [op for op in self.device_ops if part in op[0]]


def union_s(spans, lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + (cur_b - cur_a if cur_b is not None else 0.0)


def idle_gaps(sl: Slice) -> list:
    """The window's stretches with no device operation, each (label,
    seconds): the innermost span the host was in at the gap's middle."""
    gaps, t = [], 0.0
    for _, a, b in sorted(sl.device_ops, key=lambda op: op[1]):
        if a > t:
            gaps.append((t, min(a, sl.window_s)))
        t = max(t, b)
    if t < sl.window_s:
        gaps.append((t, sl.window_s))
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for n, s, e in sl.annotations if s <= mid <= e]
        out.append((min(inside)[1] if inside else "none", b - a))
    return out


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each summed over the slice, in seconds."""
    ops, idle = defaultdict(float), defaultdict(float)
    for name, a, b in sl.device_ops:
        ops[name[:160]] += b - a
    for label, s in idle_gaps(sl):
        idle[label] += s
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def kineto_events(prof):
    """(name, on_device, start_ns, end_ns) of every event the profiler
    kept.  Device events are kernels, copies and sets; the GPU-side copies
    of user annotations are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = e.device_type() == DeviceType.CUDA
        if dev and (name.startswith(PREFIX) or e.is_user_annotation()):
            continue
        out.append((name, dev, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def reduce_events(events, records: dict | None = None) -> Slice | None:
    """A Slice from profiler events: the window is the span of the
    ``bench.render`` ranges; the operations and host spans inside it."""
    renders = [(a, b) for n, dev, a, b in events
               if not dev and n == PREFIX + "render"]
    if not renders:
        return None
    w0 = min(a for a, _ in renders)
    w1 = max(b for _, b in renders)
    sec = lambda t: (t - w0) * 1e-9
    ops = [(n, sec(a), sec(b)) for n, dev, a, b in events
           if dev and w0 <= a < w1]
    notes = [(n[len(PREFIX):], sec(a), sec(b)) for n, dev, a, b in events
             if not dev and n.startswith(PREFIX) and a < w1 and b > w0]
    return Slice(renders=len(renders), window_s=sec(w1), device_ops=ops,
                 annotations=notes, records=dict(records or {}))

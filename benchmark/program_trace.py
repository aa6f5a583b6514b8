"""The program's own spans, for the traced run's per-layer metrics.

Importing this module turns the port's tracer on
(``audio_suite_torch/utils/profiling.py``).  Only per-layer metric modules
import it, and the harness loads those only in ``--trace 1`` runs, so the
measured runs keep the tracer off.  A checkout whose program has no tracer
gives no records, and every reader here returns None.

- ``host_ms``, ``stream_ms``: the median per call of a span's host
  milliseconds, or of its CUDA stream milliseconds (a device stage's
  first event to its last), over every render of the run;
- ``syncs_per_render``: the median per render of the host-device
  synchronizations counted inside the program's spans;
- ``origin``: where the tracer's clock (Unix-epoch ns, the profiler's)
  puts the profiled slice's zero, from the benchmark's spans that wrap
  program spans (``wiring().wraps``);
- ``label_gaps``, ``idle_ms``: the slice's idle gaps, each labelled by the
  innermost program span open at its middle, and the idle a render under
  one span.

Which spans are roots, close a render, sit inside a benchmark span or
upload a program, each engine declares in ``engines/<engine>.py:
PROGRAM_SPANS``; ``wiring`` merges the declarations of every engine, so
an engine's file brings its own.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import NamedTuple

from audio_suite_torch.utils import profiling as _prof
from benchmark import spec

TRACER = all(hasattr(_prof, f) for f in ("enable", "records", "span"))
if TRACER:
    _prof.enable()

MAX_WIDTH_NS = 100_000      # the widest origin interval taken: 0.1 ms


class Wiring(NamedTuple):
    """The program spans the readers give a role, over every engine."""
    roots: tuple      # the entries' root spans
    last: tuple       # each traced path's last device stage
    wraps: dict       # benchmark span -> the program spans inside it
    uploads: tuple    # the spans that copy a host program to the card


def wiring() -> Wiring:
    """Every engine's ``PROGRAM_SPANS`` (``root``, ``last``, ``wraps``,
    ``upload``, each optional), merged; an engine whose program has no
    spans declares none.  A program span that two benchmark spans claim
    is refused."""
    roots, last, uploads, wraps, home = [], [], [], {}, {}
    for name in spec.names("engines"):
        decl = getattr(spec.load_module("engines", name), "PROGRAM_SPANS",
                       {})
        for key, acc in (("root", roots), ("last", last),
                         ("upload", uploads)):
            if key in decl:
                acc.append(decl[key])
        for bench, progs in decl.get("wraps", {}).items():
            for p in progs:
                if home.setdefault(p, bench) != bench:
                    raise ValueError(f"{name}: {p!r} is inside both "
                                     f"{home[p]!r} and {bench!r}")
            wraps[bench] = wraps.get(bench, ()) + tuple(progs)
    return Wiring(tuple(roots), tuple(last), wraps, tuple(uploads))


def records() -> list:
    """The tracer's records (none without a tracer)."""
    return _prof.records() if TRACER else []


def _median(values):
    return statistics.median(values) if values else None


def host_ms(name: str, recs=None):
    """Median host ms a call of span ``name``."""
    recs = records() if recs is None else recs
    return _median([(r.end_ns - r.start_ns) / 1e6 for r in recs
                    if r.name == name])


def total_ms(name: str, recs=None):
    """Host ms of every call of span ``name``, summed (None if none)."""
    recs = records() if recs is None else recs
    v = [(r.end_ns - r.start_ns) / 1e6 for r in recs if r.name == name]
    return sum(v) if v else None


def stream_ms(name: str, recs=None):
    """Median stream ms a call of device stage ``name``."""
    recs = records() if recs is None else recs
    return _median([r.stream_ms for r in recs
                    if r.name == name and r.stream_ms is not None])


def renders(recs) -> list[list]:
    """The records grouped by render: a root with the spans under it, or
    the top-level spans up to and including a traced path's last stage
    (``wiring().last``)."""
    by_request = defaultdict(list)
    for r in recs:
        by_request[r.request].append(r)
    w = wiring()
    closing = set(w.roots + w.last)
    out, cur = [], []
    for top in sorted((r for r in recs if r.parent is None),
                      key=lambda r: r.start_ns):
        cur.extend(by_request[top.request])
        if top.name in closing:
            out.append(cur)
            cur = []
    return out


def syncs_per_render(recs=None):
    """Median over renders of the syncs counted in a render's spans."""
    recs = records() if recs is None else recs
    return _median([sum(r.syncs for r in g) for g in renders(recs)])


def origin(sl, recs):
    """(origin, width): the epoch ns of the slice's zero (an int), so that
    slice seconds are (t - origin) * 1e-9, and the width in ns of the
    interval of origins that puts every program span of the slice inside
    the benchmark span wrapping it.  None where no origin does, or where
    the interval is wider than ``MAX_WIDTH_NS``."""
    if sl is None:
        return None
    wraps = wiring().wraps
    home_of = {p: b for b, ps in wraps.items() for p in ps}
    bench = [(n, a, b) for n, a, b in sl.annotations if n in wraps]
    prog = sorted((r for r in recs if r.name in home_of),
                  key=lambda r: r.end_ns)
    if not bench or not prog:
        return None
    # ns from the last program span's end, whose epoch value a float
    # would round; it ends in the last wrapping span, which gives a first
    # origin, within the two ends' slack, that pairs each span with the
    # benchmark span around its middle
    base = prog[-1].end_ns
    guess = -max(b for _, _, b in bench) * 1e9
    lo, hi = -float("inf"), float("inf")
    for r in prog:
        s, e = r.start_ns - base, r.end_ns - base
        mid = (0.5 * (s + e) - guess) * 1e-9
        if not 0.0 <= mid <= sl.window_s:
            continue
        home = [(a, b) for n, a, b in bench
                if n == home_of[r.name] and a <= mid <= b]
        if len(home) != 1:
            return None
        a, b = home[0]
        lo = max(lo, e - b * 1e9)
        hi = min(hi, s - a * 1e9)
    if not lo <= hi or hi - lo > MAX_WIDTH_NS:
        return None
    return base + round(0.5 * (lo + hi)), hi - lo


def _gaps(sl) -> list:
    """The slice's stretches with no device operation, (start, end) in
    seconds, as ``tracing.idle_gaps`` finds them."""
    gaps, t = [], 0.0
    for _, a, b in sorted(sl.device_ops, key=lambda op: op[1]):
        if a > t:
            gaps.append((t, min(a, sl.window_s)))
        t = max(t, b)
    if t < sl.window_s:
        gaps.append((t, sl.window_s))
    return gaps


def label_gaps(sl, recs, org: int) -> list:
    """Each idle gap of the slice as (record, start, end): the record of
    the innermost program span open at the gap's middle, or None."""
    at = lambda t: (t - org) * 1e-9
    spans = sorted((r for r in recs
                    if at(r.end_ns) >= 0 and at(r.start_ns) <= sl.window_s),
                   key=lambda r: (r.start_ns, -r.end_ns))
    out, open_, k = [], [], 0
    for a, b in _gaps(sl):
        mid = 0.5 * (a + b)
        while k < len(spans) and at(spans[k].start_ns) <= mid:
            while open_ and at(open_[-1].end_ns) < at(spans[k].start_ns):
                open_.pop()
            open_.append(spans[k])
            k += 1
        while open_ and at(open_[-1].end_ns) < mid:
            open_.pop()
        out.append((open_[-1] if open_ else None, a, b))
    return out


def idle_ms(sl, name: str, recs=None):
    """Median over the slice's calls of span ``name`` of the idle ms
    whose gaps' middles lie under the call, at any depth."""
    recs = records() if recs is None else recs
    found = origin(sl, recs)
    if found is None:
        return None
    org = found[0]
    by_id = {r.id: r for r in recs}
    idle = defaultdict(float)
    for r, a, b in label_gaps(sl, recs, org):
        while r is not None and r.name != name:
            r = by_id.get(r.parent)
        if r is not None:
            idle[r.id] += b - a
    calls = [r for r in recs if r.name == name
             and r.start_ns >= org and (r.end_ns - org) * 1e-9 <= sl.window_s]
    return _median([1e3 * idle[r.id] for r in calls])

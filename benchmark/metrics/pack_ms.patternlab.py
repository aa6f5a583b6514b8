"""pack_ms.patternlab (ms): the median host time a render of the
program's ``patternlab.pack`` span
(``MegaDriveInspiredSynth.prepare_np``: the note batch's clamps, buckets
and the four packs), from the port's tracer."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("patternlab.pack")

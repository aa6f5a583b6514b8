"""upload_ms (ms): the median host time a render of the program's copy of
its host program to the card: the span each engine declares as its
``upload`` (``engines/<engine>.py:PROGRAM_SPANS``; Microsound's
``microsound.upload``, ``render_program``'s ``program_to_device`` of the
chunks and the space kernels; Pattern Lab's ``patternlab.upload``,
``prepared_to_device`` of the four packs), from the port's tracer.  A run
records one engine's spans, so the first declared span with calls is
its engine's."""
from benchmark import program_trace


def read(run):
    for name in program_trace.wiring().uploads:
        v = program_trace.host_ms(name)
        if v is not None:
            return v
    return None

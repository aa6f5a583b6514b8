"""upload_ms (ms): the median host time a render of the program's copy of
its host program to the card: the ``microsound.upload`` span
(``render_program``: the chunks' and the space kernels'
``program_to_device``) or the ``patternlab.upload`` span
(``prepared_to_device`` of the four packs), from the port's tracer."""
from benchmark import program_trace


def read(run):
    for name in ("microsound.upload", "patternlab.upload"):
        v = program_trace.host_ms(name)
        if v is not None:
            return v
    return None

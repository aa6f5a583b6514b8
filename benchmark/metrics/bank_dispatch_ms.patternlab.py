"""bank_dispatch_ms.patternlab (ms): the median host time a render of the
program's ``patternlab.bank`` span (``_render_dispatch``'s loop over the
bucket spec: the FM and PSG banks, tail masks and overlap-adds), from the
port's tracer: the host's time to launch the voice bank."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("patternlab.bank")

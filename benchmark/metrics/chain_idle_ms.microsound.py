"""chain_idle_ms.microsound (ms): the device's idle time a render of the
profiled slice whose gaps' middles lie under the program's
``microsound.chain`` span, the median over the slice's renders; the
tracer's spans put on the slice's clock by ``program_trace.origin``."""
from benchmark import program_trace


def read(run):
    return program_trace.idle_ms(run.slice, "microsound.chain")

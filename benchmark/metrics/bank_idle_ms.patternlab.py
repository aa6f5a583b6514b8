"""bank_idle_ms.patternlab (ms): the device's idle time a render of the
profiled slice whose gaps' middles lie under the program's
``patternlab.bank`` span (its ``fm_bank`` / ``psg_bank`` spans included),
the median over the slice's renders."""
from benchmark import program_trace


def read(run):
    return program_trace.idle_ms(run.slice, "patternlab.bank")

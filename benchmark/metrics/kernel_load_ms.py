"""kernel_load_ms (ms): the host time of every ``kernels.load`` span of
the run, summed: each hand-written kernel library's first load in the
process (``kernels/__init__.py:_lib``), its nvcc build included where the
library was not built yet.  0 where the tracer recorded spans but no
load (every library was loaded before the tracer was on)."""
from benchmark import program_trace


def read(run):
    recs = program_trace.records()
    if not recs:
        return None
    return program_trace.total_ms("kernels.load", recs) or 0.0

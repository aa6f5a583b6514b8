"""positions_dispatch_ms.tape (ms): the median host time a render of the
program's ``tape.positions`` span (``ops/varispeed.py:tape_positions``:
the wow/flutter curve, the speed runs, the segmented position sum, the
read index and the anti-click x splice gain, eager ops over every output
sample), from the port's tracer: the host's time to launch the position
chain."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("tape.positions")

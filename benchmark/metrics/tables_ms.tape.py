"""tables_ms.tape (ms): the median host time a render of the program's
``tape.tables`` span (``models/tape.py:program_tables``: the C++ walk of
every output sample through the wow/flutter curve and the section
crossings, ``native_rt.tape_tables``, that builds the visit, speed-run and
splice-trigger tables; a render whose speeds changed misses the program
memo and pays it), from the port's tracer."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("tape.tables")

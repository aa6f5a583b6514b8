"""syncs_per_render (count): the host-device synchronizations torch made
inside the program's spans, summed over a render's spans, the median over
the traced run's renders (the tracer counts torch's sync debug warnings
against the innermost open span)."""
from benchmark import program_trace


def read(run):
    return program_trace.syncs_per_render()

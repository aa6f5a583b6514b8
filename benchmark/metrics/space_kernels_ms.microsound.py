"""space_kernels_ms.microsound (ms): the median host time a render of the
program's ``microsound.space_kernels`` span
(``models/microsound.py:_space_kernels``: the ER taps and the f64 ER ⊛ IR
``np.convolve``, or a memo hit), from the port's tracer in the traced
run."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("microsound.space_kernels")

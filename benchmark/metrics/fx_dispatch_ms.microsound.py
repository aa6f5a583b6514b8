"""fx_dispatch_ms.microsound (ms): the median host time a render of the
program's ``microsound.fx`` span (``fx_body``: ADSR, the f64 FFT
convolution, the diffusion, soft clip, normalize, PCM16), from the port's
tracer."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("microsound.fx")

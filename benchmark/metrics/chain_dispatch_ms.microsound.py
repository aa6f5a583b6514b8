"""chain_dispatch_ms.microsound (ms): the median host time a render of the
program's ``microsound.chain`` span (``render_device``'s chunk loop:
``chunk_body``'s grain chain and its overlap-add), from the port's tracer:
the host's time to launch the chain."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("microsound.chain")

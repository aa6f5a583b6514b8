"""chain_stream_ms.microsound (ms): the median time a render the card's
stream took from the ``microsound.chain`` span's first CUDA event to its
last.  Where the host is slower than the card this is about the span's
host time; where the card lags, about the chain's device time.  It is not
busy time."""
from benchmark import program_trace


def read(run):
    return program_trace.stream_ms("microsound.chain")

"""read_stream_ms.tape (ms): the median time a render the card's stream
took from the ``tape.read`` span's first CUDA event to its last (the
linear read through ``lerp_read.cu``, the gain, the clip and PCM16; the
host's time where it is slower than the card, the device's where the card
lags; not busy time)."""
from benchmark import program_trace


def read(run):
    return program_trace.stream_ms("tape.read")

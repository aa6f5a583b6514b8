"""overlap_add_roofline (%): the overlap-add kernel (``overlap_add.cu``)'s
share of its bound in the profiled slice: each launch's bytes (its windows
and starts read once, its buffer read and written once), from the (E, Lw,
N) its launch wrapper was called with, over the memory rate."""
from benchmark import roofline

RECORD = ("audio_suite_torch.kernels", "overlap_add",
          lambda out, vals, starts: (int(vals.shape[0]), int(vals.shape[1]),
                                     int(out.shape[0])))


def read(run):
    return roofline.share(run, RECORD, "overlap_add_kernel", lambda E, Lw, N:
                          (roofline.overlap_add_bytes(E, Lw, N), 0))

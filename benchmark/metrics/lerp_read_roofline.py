"""lerp_read_roofline (%): the tape's linear read
(``lerp_read.cu:lerp_read_kernel``)'s share of its bound in the profiled
slice: each launch's bytes over the memory rate, from the (n, T) its
launch wrapper was called with.  The bytes: the int32 index and the f32
fraction of each of the T output samples read once, the tape's n f32 taps
read once, the T f32 samples written; at bench config 1 (n 8 640 000,
T 8 745 204) 139.50 MB, ``chip_smoke.py``'s count.  The kernel computes
4 f32 operations a sample (a subtract, two multiplies, an add); the
bytes govern."""
from benchmark import roofline

RECORD = ("audio_suite_torch.kernels", "lerp_read",
          lambda audio, idx0, fr: (int(audio.shape[0]), int(idx0.shape[0])))


def lerp_read_bytes(n: int, T: int) -> int:
    return 4 * n + 12 * T


def read(run):
    return roofline.share(run, RECORD, "lerp_read_kernel", lambda n, T: (
        lerp_read_bytes(n, T), 4 * T))

"""stick_slip_roofline (%): the stick-slip kernel that draws its own noise
(``grain_scan.cu:stick_slip_kernel<true>``)'s share of its bound in the
profiled slice: the larger of its bytes (seeds read, rows written) over
the memory rate and its f32 operations over the f32 rate, from the (E, L)
its launch wrapper was called with."""
from benchmark import roofline

RECORD = ("audio_suite_torch.kernels", "stick_slip_noise_scan",
          lambda seed, L, *a, **k: (int(seed.shape[0]), int(L)))


def read(run):
    return roofline.share(run, RECORD, "stick_slip_kernel", lambda E, L: (
        roofline.stick_slip_bytes(E, L), roofline.stick_slip_flops(E, L)))

"""device_busy_ms (ms): the union of the device operations' intervals in
the profiled slice, per render."""


def read(run):
    sl = run.slice
    return 1e3 * sl.busy_s() / sl.renders if sl and sl.device_ops else None

"""device_idle_pct (%): the share of the profiled slice's wall in which no
device operation ran."""


def read(run):
    sl = run.slice
    if not sl or not sl.device_ops or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)

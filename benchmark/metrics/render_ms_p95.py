"""render_ms_p95 (ms): the 95th percentile, by nearest rank, of every
render's latency in the window: from the request's issue to its PCM on the
host.  A render that failed counts with the time it took to fail."""
import math


def read(run):
    lat = sorted(run.window.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

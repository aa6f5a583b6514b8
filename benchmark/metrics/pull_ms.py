"""pull_ms (ms): the mean host time a render of the PCM16 copy to the
host (``.cpu()``), from the span around it in the traced window; the
device has finished the render before the span opens."""


def read(run):
    return run.spans.mean_ms("pull") if run.spans else None

"""host_build_ms.microsound (ms): the mean host time of
``microsound.build_program`` a render, from the span around it in the
traced window."""


def read(run):
    return run.spans.mean_ms("host_build") if run.spans else None

"""host_prepare_ms.patternlab (ms): the mean host time a render of the
pre-pass that ``patternlab.render`` runs on a memo miss (the generators,
``apply_time_ops``, ``MegaDriveInspiredSynth.prepare`` with its upload),
from the span around it in the traced window."""


def read(run):
    return run.spans.mean_ms("host_prepare") if run.spans else None

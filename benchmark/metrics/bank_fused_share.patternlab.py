"""bank_fused_share.patternlab (share): of the voice-bank buckets the
run's renders rendered, the share that ran as one launch of the
hand-written kernel (``kernels/voice_bank.cu``) and not op by op: the
``fused`` and ``eager`` bucket counts of the program's ``patternlab.bank``
spans, summed.  None where no bank span carries them (a program without
the fused bank, or no tracer)."""
from benchmark import program_trace


def share(recs):
    fused = eager = 0
    for r in recs:
        if r.name == "patternlab.bank" and "fused" in r.attrs:
            fused += r.attrs["fused"]
            eager += r.attrs["eager"]
    return fused / (fused + eager) if fused + eager else None


def read(run):
    return share(program_trace.records())

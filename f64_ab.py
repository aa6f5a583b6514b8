#!/usr/bin/env python3
"""What each f64 stage of the port's Microsound render costs on one NVIDIA
GPU, and which renders need it, in one process.

    python3 f64_ab.py [CASE ...]

The port evaluates three stages of the render in f64 and rounds once to
f32, so that the card's render agrees with its CPU render:

- ``transforms``: ``ops/exact_dft.py`` (``rfft_n``, ``irfft_n``), every FFT
  of the grain chain;
- ``transcendentals``: ``ops/detmath.py:rounded`` (exp, cos, log, pow,
  tanh, magnitude, angle, polar);
- ``fx``: ``ops/space.py:fft_convolve_causal``, the ER and IR convolution.

A variant puts one stage back in f32 (``f32 <stage>``), or all three
(``f32``), for the whole process, on the card and the CPU alike, by
replacing the module's function; ``f64`` is the port as it ships.  The
cases are bench config 3 at full size (``chip_smoke.config3``) and
``chip_smoke.py``'s phase-9 renders (``chip_smoke.ms_cases``), or those
named on the command line (``config3``, ``a:Image scanline``, ...).

For each variant and case: the card's float render against the port's CPU
render (dBFS; the gate is -100), and, with the variants in turns (in
order, then reversed), the device events and busy ms of one render (one
``torch.profiler`` window over two renders).  Prints a line per variant
and case, the card's name and power limit, and one JSON line, also
written to ``chiprun_out/f64_ab.json``.  Imports nothing of JAX or of the
JAX package.
"""
import json
import os
import statistics
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs

PROFILED = 2          # renders in each profiler window


def f32_rfft_n(x, n):
    n = int(n)
    return torch.fft.rfft(x[..., :n], n=n)


def f32_irfft_n(Z, n, out_len=None):
    n = int(n)
    Zr = torch.view_as_real(Z).clone()
    Zr[..., 0, 1] = 0.0
    if n % 2 == 0:
        Zr[..., n // 2, 1] = 0.0
    y = torch.fft.irfft(torch.view_as_complex(Zr), n=n)
    if Z.dtype != torch.complex128:
        y = y.to(torch.float32)
    if out_len is not None and out_len > n:
        y = F.pad(y, (0, out_len - n))
    return y


def f32_rounded(fn, *args):
    return fn(*args)


def f32_fft_convolve_causal(x, kernel, block=1 << 17):
    """``space.fft_convolve_causal`` with its transforms in f32."""
    x = x.to(torch.float32)
    kernel = kernel.to(torch.float32)
    N, K = x.shape[0], kernel.shape[0]
    if K == 0:
        return torch.zeros_like(x)
    nfft = 1
    while nfft < max(2 * (K - 1), min(2 * block, 2 * N, 1 << 16), 16):
        nfft *= 2
    hop = nfft // 2
    nblocks = (N + hop - 1) // hop
    frames = F.pad(x, (0, nblocks * hop - N)).reshape(nblocks, hop)
    Kf = f32_rfft_n(F.pad(kernel, (0, nfft - K)), nfft)
    Y = f32_irfft_n(f32_rfft_n(F.pad(frames, (0, nfft - hop)), nfft) * Kf,
                    nfft)
    h2 = F.pad(Y[:-1, hop:], (0, 0, 1, 0))
    return (Y[:, :hop] + h2).reshape(-1)[:N]


def stages():
    """stage -> [(module, attribute, its f32 replacement)]."""
    from audio_suite_torch.ops import detmath, exact_dft, space
    return {
        "transforms": [(exact_dft, "rfft_n", f32_rfft_n),
                       (exact_dft, "irfft_n", f32_irfft_n)],
        "transcendentals": [(detmath, "rounded", f32_rounded)],
        "fx": [(space, "fft_convolve_causal", f32_fft_convolve_causal)]}


class Variant:
    """A context that puts the named stages in f32."""

    def __init__(self, names):
        self.swaps = [s for name in names for s in stages()[name]]

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.swaps]
        for m, a, f in self.swaps:
            setattr(m, a, f)

    def __exit__(self, *exc):
        for m, a, f in self.saved:
            setattr(m, a, f)


VARIANTS = {"f64": (), "f32 transforms": ("transforms",),
            "f32 transcendentals": ("transcendentals",),
            "f32 fx": ("fx",), "f32": ("transforms", "transcendentals", "fx")}


def main() -> int:
    if not torch.cuda.is_available():
        print("f64_ab: no CUDA device", file=sys.stderr)
        return 1
    from audio_suite_torch import kernels
    from audio_suite_torch.models import microsound as ms
    for k in cs.KERNELS:
        kernels.build(k)
    dev = torch.device("cuda", 0)
    card = f"[{cs.smi('name,power.limit')}]"
    p3, ir = cs.config3(full=True)
    cases = [("config3", p3.to_dict(), {"ir_audio": ir})] + cs.ms_cases()
    if sys.argv[1:]:
        cases = [c for c in cases if c[0] in sys.argv[1:]]
    rows = {v: {} for v in VARIANTS}
    for v, names in VARIANTS.items():
        with Variant(names):
            for label, d, kw in cases:
                p = ms.MicrosoundParams.from_dict(d)
                y, _ = ms.render(p, device=dev, **kw)
                cpu, _ = ms.render(p, device="cpu", **kw)
                rows[v][label] = {"dbfs": cs.dbfs(y, cpu), "busy_ms": [],
                                  "events": []}
    order = list(VARIANTS)
    for v in order + order[::-1]:
        with Variant(VARIANTS[v]):
            for label, d, kw in cases:
                p = ms.MicrosoundParams.from_dict(d)
                prof = cs.profile_renders(
                    lambda: ms.render(p, device=dev, **kw), PROFILED)
                if not prof:
                    raise AssertionError("the profiler saw no device event")
                rows[v][label]["busy_ms"].append(prof["busy_ms_per_render"])
                rows[v][label]["events"].append(prof["events_per_render"])
    for label, _, _ in cases:
        base = statistics.mean(rows["f64"][label]["busy_ms"])
        for v in VARIANTS:
            r = rows[v][label]
            busy = statistics.mean(r["busy_ms"])
            print(f"{label} | {v}: card vs CPU {r['dbfs']:.2f} dBFS"
                  f"{'' if r['dbfs'] <= -100.0 else ' (misses -100)'}; "
                  f"{statistics.mean(r['events']):.1f} device events, busy "
                  f"{busy:.3f} ms ({busy / base - 1:+.1%} against f64; "
                  f"in turns {', '.join(f'{b:.3f}' for b in r['busy_ms'])})"
                  f" {card}", flush=True)
    out = json.dumps({"card": card, "variants": rows})
    os.makedirs(os.path.join(cs.REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.REPO, "chiprun_out", "f64_ab.json"), "w") as f:
        f.write(out + "\n")
    print(card[1:-1])
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of audio_suite_torch on a CUDA card, one cell a run:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, their metrics and bounds are in
BENCHMARK.json; each cell's parts are files under this folder, found by
name (``spec.py``).  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number the check
compared with its limit, as the last lines of standard error do.

Exits non-zero with no result when there is no CUDA card or fewer than the
cell asks for, and when the process loaded JAX or the JAX package.
"""
import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout; few host
# threads, so the host side of a run is steady
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where there is
    none): the interpreter's start counts towards set-up."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = _T_IMPORT - process_age_s()
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(bench, cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda", t_start)
    return harness.emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())

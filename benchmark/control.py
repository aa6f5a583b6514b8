"""The control of a cell's check: the plain reference put in the program's
place and computed a precision lower (every stage rounded to bfloat16,
the step below the float32 the renders state), held to the full reference
by the same number the runs compare.  It has to fail the limit.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] \
        [--renders 2]

draws each seed's first window requests as a run of the cell does, and
prints, per request, the control's and the reference's widest PCM gap in
steps beside the configuration's limit; one JSON line at the end.  The
benchmark's own runs never run it; the tests run ``readings`` at their
small sizes.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

def smoke(config: dict, mix: dict) -> tuple[dict, dict]:
    """A cell's configuration and mix at the small sizes its configuration
    names under ``smoke``: ``config`` and ``mix`` entries, each a dict of
    the groups it updates; the warm-up cut to two requests."""
    config = json.loads(json.dumps(config))
    mix = json.loads(json.dumps(mix))
    for target, groups in (("config", config), ("mix", mix)):
        for key, vals in config.get("smoke", {}).get(target, {}).items():
            groups.setdefault(key, {}).update(vals)
    mix["warmup"] = min(int(mix.get("warmup", 0)), 2)
    return config, mix


def readings(cell_name: str, seeds, renders: int, size: str = "full"):
    """[(seed, k, control gap, limit)] for each seed's first requests."""
    from benchmark import harness, spec
    from benchmark.reference.numerics import bf16
    from benchmark.generator import Traffic
    cell = spec.cell(spec.load_benchmark(ROOT), cell_name)
    config = spec.load_json("configs", cell["config"])
    mix = spec.load_json("traffic", cell["traffic"])
    if size == "smoke":
        config, mix = smoke(config, mix)
    engine = spec.load_module("engines", config["engine"])
    limit = config["check"]["pcm_max_lsb"]
    out = []
    for seed in seeds:
        traffic = Traffic(mix, seed)
        state = engine.setup(config, seed, "cpu")
        for k in range(renders):
            req = engine.request(state, traffic.request(k))
            gap = harness.max_lsb(engine.reference(state, req, q=bf16),
                                  engine.reference(state, req))
            out.append((seed, k, gap, limit))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--renders", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    rows = readings(args.workload, args.seeds, args.renders)
    for seed, k, gap, limit in rows:
        print(f"{args.workload} seed {seed} request {k}: control "
              f"pcm_max_lsb {gap} (limit {limit})", flush=True)
    print(json.dumps({"workload": args.workload,
                      "control_pcm_max_lsb": [r[2] for r in rows],
                      "limit": rows[0][3] if rows else None,
                      "fails": all(r[2] > r[3] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  The
parts live in files of their own under this folder, and are found by
those names alone, so a new cell needs new files and new entries, never
an edit:

- ``configs/<config>.json``: the parameters, and the ``engine`` that
  issues them;
- ``traffic/<traffic>.json``: the mix, read by ``generator.Traffic``;
- ``engines/<engine>.py``: how one request goes through the program,
  the faults the check's tests plant in it (``FAULTS``) and the program's
  spans it runs (``PROGRAM_SPANS``);
- ``metrics/<metric>.py``: one metric's reader, ``read(run)``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _part(kind: str, name: str, ext: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return path


def load_benchmark(root: Path | None = None) -> dict:
    """BENCHMARK.json at the root of the checkout (this folder's parent)."""
    path = (root or HERE.parent) / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(_part(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """engines/<name>.py or metrics/<name>.py as a fresh module (a dotted
    metric name is a file name, not a package path)."""
    path = _part(kind, name, ".py")
    mod_name = f"benchmark.{kind}." + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list[str]:
    """The names of every module of a kind (``engines/*.py``), sorted."""
    return sorted(p.stem for p in (HERE / kind).glob("*.py"))


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    without tracing, its per-layer metrics with it.  A metric without a
    ``workloads`` key is reported wherever the end-to-end metric it moves
    (or, for an end-to-end metric, it) is."""
    def applies(m: dict) -> bool:
        return cell_name in m.get("workloads", [cell_name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if applies(m) and ("workloads" in m or m["moves"] in names)]

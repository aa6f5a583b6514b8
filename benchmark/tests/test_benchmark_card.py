"""The harness end to end on a CUDA card, at the tests' small sizes: a
sound run of each cell is correct, and a traced one reads its per-layer
metrics from the profiled slice.  Skipped where there is no card."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, harness, spec  # noqa: E402

BENCH = spec.load_benchmark(ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_a_small_run_on_the_card(card, cell_name, trace):
    cell = spec.cell(BENCH, cell_name)
    config, mix = control.smoke(spec.load_json("configs", cell["config"]),
                                spec.load_json("traffic", cell["traffic"]))
    result, _ = harness.run_cell(BENCH, cell, 2 ** 31 + 99, 1.0, trace,
                                 card, time.perf_counter(), config=config,
                                 mix=mix)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics_for(BENCH, cell_name, trace)}
    assert set(result["metrics"]) == want
    if trace:
        dev = result["device"]
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert result["breakdown"]["device_ops"]
        for name, v in result["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < v["value"] <= 105, (name, v)

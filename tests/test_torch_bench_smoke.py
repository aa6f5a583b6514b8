"""The port's harness (``audio_suite_torch/bench.py``), the twin of
``tests/test_bench_smoke.py``: the whole harness at bench.py's
BENCH_SMOKE sizes (``--smoke --device cpu``), in a process where ``jax``
and the JAX package cannot be imported, must exit 0 and print one JSON
line with every key bench.py's line has, no "failures", and every
realtime factor finite and > 0.  A configuration that raises is reported
under "failures" while the others run, and the process then exits
non-zero; ``--device cuda`` with no card refuses to run."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_suite_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["audio_suite_tpu"] = None   # and so does the JAX package
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from audio_suite_torch import bench
code = bench.main(["--smoke", "--device", "cpu"])
assert not any(m.split(".")[0] in ("jax", "audio_suite_tpu")
               for m in sys.modules if sys.modules[m] is not None)
sys.exit(code)
"""

COMPUTE_KEYS = ("rtf_tape_compute", "rtf_scrub_compute",
                "rtf_microsound_compute", "rtf_microsound_48k_compute",
                "rtf_patternlab_compute", "rtf_grid_compute",
                "rtf_tape_param_tweak")


def test_bench_harness_smoke():
    r = subprocess.run([sys.executable, "-c", _RUN.format(repo=REPO)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert "failures" not in rep, rep.get("failures")
    assert rep["metric"] == "rtf_geomean" and rep["value"] > 0
    assert rep["unit"] == "audio_sec/sec/chip"
    assert rep["vs_baseline"] == pytest.approx(rep["value"] / 1000.0,
                                               abs=1e-4)
    for cfg in bench.CONFIGS:
        assert rep[f"rtf_{cfg}"] > 0, cfg
    for k in COMPUTE_KEYS + ("null_loop_latency_ms", "d2h_MBps",
                             "patternlab_prepare_ms"):
        assert k in rep and np.isfinite(rep[k]), k
    for k, v in rep.items():
        if k.startswith("rtf_"):
            assert np.isfinite(v) and v > 0, k
    for engine in ("tape", "scrub", "microsound", "patternlab", "grid"):
        d = rep[f"decomp_{engine}"]
        for k in ("e2e_ms", "kernel_ms", "build_ms", "pull_ms",
                  "residual_ms", "host_nonlink_ms"):
            assert np.isfinite(d[k]), (engine, k)
    assert rep["decomp_grid"]["ca_ms"] > 0
    assert rep["microsound_oa"] == "plain"
    assert rep["device"] == "cpu"


def test_a_failing_config_is_reported_and_exits_nonzero(monkeypatch,
                                                         capsys):
    def ok(clock, extras, smoke):
        assert clock.device == torch.device("cpu") and smoke
        return 2.0

    def boom(clock, extras, smoke):
        raise RuntimeError("no tape")

    monkeypatch.setattr(bench, "BENCHES", {**{k: ok for k in bench.CONFIGS},
                                           "tape": boom})
    assert bench.main(["--smoke", "--device", "cpu"]) == 1
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["failures"] == {"tape": "RuntimeError: no tape"}
    assert "rtf_tape" not in rep and rep["rtf_scrub"] == 2.0
    assert rep["value"] == 2.0


def test_cuda_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    with pytest.raises(SystemExit) as e:
        bench.main(["--smoke"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def test_clock_protocol_on_the_cpu():
    """time_device grows K until the loop is 4x the null loop, and the
    amortized time is positive; time_best checks the outputs."""
    clock = bench.Clock("cpu")
    calls = []
    t = clock.time_device(lambda: calls.append(1))
    assert t > 0 and len(calls) >= 1 + 3 * 5
    with pytest.raises(FloatingPointError):
        clock.time_best(lambda: None, check={"y": np.array([np.nan])})

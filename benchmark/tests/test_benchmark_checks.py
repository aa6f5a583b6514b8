"""The check that decides ``correct``, on the CPU at the tests' small
sizes: the plain references agree with the port, the control (the
reference at bfloat16) fails the limit, and a run whose timed path is
broken underneath comes out not correct, once for each fault its
engine names (``engines/<engine>.py:FAULTS``, one of each kind)."""
import ast
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, faults, harness, spec  # noqa: E402
from benchmark.reference import microsound as ref_ms  # noqa: E402
from benchmark.reference import numerics  # noqa: E402
from benchmark.reference import patternlab as ref_pl  # noqa: E402
from benchmark.generator import Traffic  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 4242


def _small(cell_name):
    cell = spec.cell(BENCH, cell_name)
    config, mix = control.smoke(spec.load_json("configs", cell["config"]),
                                spec.load_json("traffic", cell["traffic"]))
    return cell, config, mix


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_agrees_with_the_port(cell_name):
    cell, config, mix = _small(cell_name)
    engine = spec.load_module("engines", config["engine"])
    state = engine.setup(config, SEED, "cpu")
    for k in range(2):
        req = engine.request(state, Traffic(mix, SEED).request(k))
        got = engine.render(state, req)
        gap = harness.max_lsb(got, engine.reference(state, req))
        assert gap <= 1 <= config["check"]["pcm_max_lsb"], gap


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_limit(cell_name):
    rows = control.readings(cell_name, [SEED, 7], renders=1, size="smoke")
    assert all(gap > limit for _, _, gap, limit in rows), rows


def test_references_import_nothing_of_either_package():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "audio_suite_torch", "audio_suite_tpu", "jax",
                    "jaxlib", "torch", "benchmark"), (path.name, n)


def test_lfsr_orbit_matches_the_sequential_register():
    for seed in (0, 1, 77, 12345, 0x7FFF, 2 ** 31 + 3):
        s, want = seed & 0x7FFF, []
        for _ in range(600):
            bit = (s ^ (s >> 1)) & 1
            s = (s >> 1) | (bit << 14)
            want.append(1.0 if s & 1 else -1.0)
        assert np.array_equal(ref_pl.lfsr_noise(600, seed), want)


def test_stick_slip_reference_is_the_once_rounded_f32_loop():
    from audio_suite_torch.ops import generators
    p = spec.load_json("configs", "microsound-c3")["params"]
    seeds = np.asarray([5, 2 ** 31 + 17, 99991])
    n = 3000
    want = generators.stick_slip_noise_scan_plain(
        torch.tensor(seeds.astype(np.int64).astype(np.uint32)
                     .astype(np.int64)), n, p["ss_threshold"], p["ss_build"],
        p["ss_decay"], p["ss_noise"]).numpy()
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    ok = hann > 1e-3
    got = ref_ms._stick_slip(p, seeds, n)[:, ok] / hann[ok]
    assert np.allclose(got, want[:, ok], rtol=1e-12, atol=1e-30)
    assert (want != 0).any(axis=1).all()


def test_bf16_rounds_to_eight_bits():
    x = np.asarray([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -3.14159, 0.0])
    got = numerics.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0      # a tie rounds to even
    assert got[2] == 1.0 + 2 ** -7
    assert abs(got[3] + 3.140625) < 1e-12 and got[4] == 0.0
    assert numerics.pcm16(np.asarray([1.0, -1.0, 0.5 / 32768])).tolist() \
        == [32767, -32768, 0]


# --- faults planted in the timed path underneath a run: each engine names
# its own (engines/<engine>.py:FAULTS)

def _engine(cell_name):
    config = spec.load_json("configs", spec.cell(BENCH, cell_name)["config"])
    return spec.load_module("engines", config["engine"])


ENGINES = sorted({spec.load_json("configs", c["name"])["engine"]
                  for c in BENCH["configs"]})
CASES = [pytest.param(c, f, id=f"{c}-{f}") for c in CELLS
         for f in sorted(_engine(c).FAULTS)]


@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_in_use_names_each_kind_of_fault(engine):
    assert sorted(spec.load_module("engines", engine).FAULTS) \
        == sorted(faults.KINDS)


def _run(cell_name):
    cell, config, mix = _small(cell_name)
    result, lines = harness.run_cell(BENCH, cell, SEED, 0.5, False, "cpu",
                                     time.perf_counter(), config=config,
                                     mix=mix)
    assert result["attempted"] >= 1 and lines[-1].startswith("check ")
    return result


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    r = _run(cell_name)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {
        m["name"] for m in spec.metrics_for(BENCH, cell_name, False)}


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    _engine(cell_name).FAULTS[fault](monkeypatch)
    r = _run(cell_name)
    assert r["correct"] is False, (fault, r["checks"])
    assert r["checks"]["pcm_max_lsb"]["value"] > \
        r["checks"]["pcm_max_lsb"]["limit"]

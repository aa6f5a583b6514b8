"""The tape's benchmark cell on the CPU, at the smoke size of its
configuration (``benchmark/configs/tape-c1.json``: bench config 1's six
sections, two reversed, splice, anti-click, age 60, on a 4 s tape re-fitted
to 4 s after each speed change):

- the port's ``render_tape(pcm16=True)`` within the configuration's
  ``pcm_max_lsb`` of the plain NumPy reference
  (``benchmark/reference/tape.py``), over seeds and tweak draws, and the
  reference's wow/flutter curve and render length equal to the port's;
- the control, the reference in bfloat16, fails that limit;
- ``pcm16=True`` is the f32 render quantized to PCM16, bit for bit;
- a traced render is one ``tape.render`` root over its six stages, in
  order, with the table counters set; off, it leaves no record.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from audio_suite_torch.models import tape
from audio_suite_torch.utils import profiling as prof

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, spec  # noqa: E402
from benchmark.generator import Traffic  # noqa: E402
from benchmark.reference import tape as ref  # noqa: E402
from benchmark.reference.numerics import bf16  # noqa: E402

CONFIG, MIX = control.smoke(spec.load_json("configs", "tape-c1"),
                            spec.load_json("traffic", "speed-tweak-180s"))
LIMIT = CONFIG["check"]["pcm_max_lsb"]
SEEDS = [2 ** 31 + 77, 5, 123_456_789]
CASES = [(s, k) for s in SEEDS for k in (0, 1)]
STAGES = ["tape.build", "tape.tables", "tape.upload", "tape.positions",
          "tape.read", "tape.pull"]


@pytest.fixture(autouse=True)
def tracer_off():
    prof.disable()
    prof.reset()
    yield
    prof.disable()
    prof.reset()


def _request(seed, k):
    """(engine state, request k of the cell's traffic) on the CPU."""
    engine = spec.load_module("engines", "tape")
    state = engine.setup(CONFIG, seed, "cpu")
    return state, engine.request(state, Traffic(MIX, seed).request(k))


def _gap(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    return int(np.abs(a.astype(np.int64) - b).max())


def test_the_smoke_size_keeps_config_1s_shape():
    state, req = _request(SEEDS[0], 0)
    p = req["params"]
    assert state.n == 4 * 48000 and len(p.markers) == 5
    assert p.section_reverse == [False, True, False, True, False, False]
    assert p.enable_splice_fx and p.anticlick_enabled
    assert p.tape_age == 60 and not p.inertia_enabled
    assert 4.0 <= req["frames"] / 48000 <= 4.05


@pytest.mark.parametrize("seed,k", CASES)
def test_port_is_within_the_limit_of_the_reference(seed, k):
    state, req = _request(seed, k)
    got = tape.render_tape(state.audio, req["params"], pcm16=True,
                           device="cpu")
    want = ref.render(req["fields"], state.host)
    assert got.shape == (req["frames"],)
    # float64 against f32 audio math: at most a rounding step apart
    assert _gap(got, want) <= 1 <= LIMIT
    assert np.abs(want.astype(np.int32)).max() > 20000


@pytest.mark.parametrize("seed,k", CASES)
def test_reference_curve_and_length_are_the_ports(seed, k):
    state, req = _request(seed, k)
    p = req["params"]
    assert ref.frames(req["fields"], state.n) == req["frames"]
    assert np.array_equal(
        ref.wow_flutter(req["frames"], p.sample_rate, p.tape_age),
        tape.wow_flutter_mod(req["frames"], p.sample_rate, p.tape_age))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bf16_control_fails_the_limit(seed):
    state, req = _request(seed, 0)
    assert _gap(ref.render(req["fields"], state.host, q=bf16),
                ref.render(req["fields"], state.host)) > LIMIT


@pytest.mark.parametrize("interp", ["linear", "sinc"])
def test_pcm16_is_the_f32_render_quantized(interp):
    state, req = _request(SEEDS[1], 0)
    y = tape.render_tape(state.audio, req["params"], device="cpu",
                         interp=interp)
    y16 = tape.render_tape(state.audio, req["params"], device="cpu",
                           interp=interp, pcm16=True)
    want = np.clip(np.rint(y.astype(np.float64) * 32768.0), -32768,
                   32767).astype(np.int16)
    assert y.dtype == np.float32 and np.array_equal(y16, want)
    with pytest.raises(ValueError, match="pcm16"):
        tape.render_tape(state.audio, req["params"], device="cpu",
                         engine="segment", pcm16=True)


def test_a_traced_render_is_a_root_over_its_six_stages():
    state, req = _request(SEEDS[2], 1)
    off = tape.render_tape(state.audio, req["params"], pcm16=True,
                           device="cpu")
    assert prof.records() == []
    tape._TAPE_PROG_CACHE.clear()
    prof.enable()
    for _ in range(2):                         # a miss, then the memo
        on = tape.render_tape(state.audio, req["params"], pcm16=True,
                              device="cpu")
        assert np.array_equal(on, off)
    prof.disable()
    recs = prof.records()
    roots = [r for r in recs if r.name == "tape.render"]
    assert [r.attrs for r in roots] == [
        {"frames": req["frames"], "memo_hit": False},
        {"frames": req["frames"], "memo_hit": True}]
    tables = tape.program_tables(tape.build_tape_program_cached(
        state.audio, req["params"], req["frames"], device="cpu"))
    for root, hit in zip(roots, (False, True)):
        assert root.parent is None and root.request == root.id
        kids = sorted((r for r in recs if r.request == root.id
                       and r is not root), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == STAGES
        assert all(r.parent == root.id and root.start_ns <= r.start_ns
                   <= r.end_ns <= root.end_ns for r in kids)
        assert kids[0].attrs == {"hit": hit}
        assert kids[1].attrs == {
            "hit": hit, "visits": len(tables["visit_start"]),
            "runs": len(tables["run_start"]),
            "triggers": len(tables["triggers"])}
        assert kids[1].attrs["visits"] >= 6 and kids[1].attrs["triggers"]

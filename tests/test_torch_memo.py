"""The engines' memos (``audio_suite_torch/utils/memo.py:Memo``) on the CPU:
the bound and its least-recently-used order, objects pinned by identity,
"cuda" and "cuda:0" as one key (``canonical_device`` needs no card), and
each of the six memos of the models serving a second identical request,
with ``hit`` / ``memo_hit`` on its span where the engine has one.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from audio_suite_torch.models import grid
from audio_suite_torch.models import microsound as ms
from audio_suite_torch.models import patternlab as pl
from audio_suite_torch.models import scrub, tape
from audio_suite_torch.utils import profiling as prof
from audio_suite_torch.utils.memo import Memo

SR = 8000


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    prof.disable()
    prof.reset()


def _span_attr(name: str, attr: str) -> list:
    return [r.attrs[attr] for r in prof.records() if r.name == name]


def _bound_and_order(tmp_path):
    m, built = Memo(2), []

    def get(k):
        return m.get(k, lambda: built.append(k) or k.upper())

    assert get("a") == ("A", False) and get("b") == ("B", False)
    assert get("a") == ("A", True)          # a is now the most recent
    assert get("c") == ("C", False)         # evicts b, the least recent
    assert len(m) == 2
    assert get("a") == ("A", True) and get("b") == ("B", False)
    assert built == ["a", "b", "c", "b"] and len(m) == 2
    m.clear()
    assert len(m) == 0 and get("a") == ("A", False)


def _pinned_by_identity(tmp_path):
    class Tape(list):
        pass

    m = Memo(4)
    a, b = Tape([1.0]), Tape([1.0])             # equal, not the same
    first, hit = m.get("k", lambda: object(), pins=(a,))
    assert not hit and m.get("k", lambda: object(), pins=(a,)) == (first,
                                                                    True)
    other, hit = m.get("k", lambda: object(), pins=(b,))
    assert not hit and other is not first
    # the entry holds what it pins, so its id names it while it stands
    ref = weakref.ref(a)
    del a
    gc.collect()
    assert ref() is not None
    m.clear()
    gc.collect()
    assert ref() is None


def _cuda_and_cuda0_one_key(tmp_path):
    m, built = Memo(4), []

    def get(device):
        return m.get("prog", lambda: built.append(str(device)) or len(built),
                     device=device)

    assert get("cuda") == (1, False)
    assert get("cuda:0") == (1, True)
    assert get(torch.device("cuda", 0)) == (1, True)
    assert get("cpu") == (2, False)
    assert get(torch.device("cpu")) == (2, True)
    assert get(None) == (3, False)              # a host memo: no device
    assert built == ["cuda", "cpu", "None"] and len(m) == 3


def _microsound_space(tmp_path):
    ms._SPACE_KERNEL_CACHE.clear()
    p = ms.MicrosoundParams(base_sr=SR, seed=21, space_ir_on=True)
    ir = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    prof.enable()
    first = ms._space_kernels(p, ir, device="cpu")
    assert ms._space_kernels(p, ir, device=torch.device("cpu")) is first
    assert _span_attr("microsound.space_kernels", "hit") == [False, True]


def _patternlab_render(tmp_path):
    pl._RENDER_CACHE.clear()
    cfg = pl.RenderConfig(sample_rate=SR, seconds=0.25, seed=9)
    events = pl.generate("Glass Cells", cfg)
    prof.enable()
    y0, _ = pl.render(events, cfg, device="cpu")
    y1, _ = pl.render(events, cfg, device="cpu")
    # regenerated: equal events in a new list, which the memo must not
    # take for the first
    y2, _ = pl.render(pl.generate("Glass Cells", cfg), cfg, device="cpu")
    assert np.array_equal(y0, y1) and np.array_equal(y0, y2)
    assert _span_attr("patternlab.render", "memo_hit") == [False, True,
                                                           False]


def _tape_program(tmp_path):
    tape._TAPE_PROG_CACHE.clear()
    audio = np.sin(np.arange(SR, dtype=np.float32) * 0.01)
    p = tape.TapeParams(sample_rate=SR, markers=[SR // 2],
                        section_speeds=[1.0, 2.0],
                        section_reverse=[False, True])
    prof.enable()
    first = tape.build_tape_program_cached(audio, p, SR, device="cpu")
    assert tape.build_tape_program_cached(audio, p, SR,
                                          device="cpu") is first
    assert _span_attr("tape.build", "hit") == [False, True]


def _scrub_program(tmp_path):
    scrub._SCRUB_PROG_CACHE.clear()
    audio = np.sin(np.arange(SR, dtype=np.float32) * 0.01)
    cfg = scrub.ScrubConfig(sample_rate=SR, head_count=3)
    trace = scrub.scripted_gesture_trace(8, SR, base_speed=0.5)
    first = scrub.build_scrub_program_cached(audio, cfg, trace)
    assert scrub.build_scrub_program_cached(audio, cfg, trace) is first
    assert len(scrub._SCRUB_PROG_CACHE) == 1
    dp = scrub.device_program(first, "cpu")
    assert scrub.device_program(first, torch.device("cpu")) is dp


def _grid_bank(tmp_path):
    grid._BANK_CACHE.clear()
    flat = np.arange(64, dtype=np.float32)
    first = grid._bank_device_cached(flat, "cpu")
    assert grid._bank_device_cached(flat.copy(), torch.device("cpu")) \
        is first
    assert len(grid._BANK_CACHE) == 1


def _grid_program(tmp_path):
    cell = tmp_path / "flat.py"
    cell.write_text(
        "import numpy as np\n"
        "def generate(sr, duration, context):\n"
        "    return np.full(int(round(sr * duration)), 0.25, np.float32)\n")
    t = grid.Track(name="flat", mode="duration", duration_seconds=0.5,
                   uniform_n=1, cells=[grid.CellSource("py", str(cell))])
    project = grid.GridProject(tracks=[t],
                               master=grid.MasterClock("fixed_seconds", 0.5),
                               sample_rate=SR)
    grid._PROGRAM_CACHE.clear()
    first = grid.build_mix_program_cached(project, "cpu")
    assert grid.build_mix_program_cached(project, torch.device("cpu")) \
        is first
    assert len(grid._PROGRAM_CACHE) == 1


CASES = {f.__name__.lstrip("_"): f for f in (
    _bound_and_order, _pinned_by_identity, _cuda_and_cuda0_one_key,
    _microsound_space, _patternlab_render, _tape_program, _scrub_program,
    _grid_bank, _grid_program)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_memo(case, tmp_path):
    CASES[case](tmp_path)

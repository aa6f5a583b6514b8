"""The port's CUDA kernels held against their plain PyTorch versions on the
card.  Imports no jax, so it runs where only PyTorch with CUDA and nvcc
are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Without a CUDA device every test skips.
"""
import numpy as np
import pytest
import torch

from audio_suite_torch import kernels
from audio_suite_torch.models import microsound as ms
from audio_suite_torch.models import tape
from audio_suite_torch.ops import lerp_read as lr
from audio_suite_torch.ops import overlap_add as oa
from audio_suite_torch.ops import varispeed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and have no CPU mode")
    return torch.device("cuda")


def _oa_case(seed, E, Lw, N):
    """Windows, unsorted starts (some needing the clamp) and a non-zero
    base buffer."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((E, Lw)).astype(np.float32)
    starts = rng.integers(-Lw // 2, N - Lw // 2, size=E).astype(np.int32)
    starts[:3] = [-17, N - Lw + 5, N + 3]        # below 0 and past N - Lw
    base = rng.standard_normal(N).astype(np.float32)
    return torch.tensor(vals), torch.tensor(starts), torch.tensor(base)


@pytest.mark.parametrize("E,Lw,N", [
    (288, 19456, 851968),      # the full-size render's OA shapes
    (24, 5120, 57344),         # the smoke render's
    (5000, 1024, 1 << 20),     # more events than one shared-memory stage
    (300, 777, 100003),        # ragged window and buffer lengths
])
def test_overlap_add_kernel_bit_equal_to_plain(cuda, E, Lw, N):
    vals, starts, base = _oa_case(E + N, E, Lw, N)
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    v, s = vals.to(cuda), starts.to(cuda)
    plain = oa.overlap_add_plain(base.to(cuda), v, s)
    n0 = kernels.overlap_add.launches
    got = oa.overlap_add(base.to(cuda), v, s)
    torch.cuda.synchronize()
    assert kernels.overlap_add.launches == n0 + 1
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), want)


def _oa_edge_starts(case, rng, E, Lw, N):
    if case == "stack":              # half the events at one start, as the
        s = rng.integers(0, N - Lw, E)   # render's padding events are
        s[E // 2:] = N - Lw
        return s
    if case == "over64":             # every tile covered by > 64 events
        return rng.integers(0, N - Lw, E)
    if case == "descending":
        return np.sort(rng.integers(-Lw, N, E))[::-1]
    if case == "clamped":            # every start past N - Lw
        return rng.integers(N - Lw + 1, N + Lw, E)
    raise ValueError(case)


@pytest.mark.parametrize("case,E,Lw,N", [
    ("stack", 96, 4096, 65536),
    ("over64", 400, 8192, 32768),
    ("descending", 200, 2048, 131072),
    ("clamped", 50, 3000, 40000),
])
def test_overlap_add_kernel_bit_equal_to_plain_edge_cases(cuda, case, E, Lw,
                                                          N):
    rng = np.random.default_rng(len(case) + E)
    vals = torch.tensor(rng.standard_normal((E, Lw)).astype(np.float32))
    starts = torch.tensor(_oa_edge_starts(case, rng, E, Lw, N)
                          .astype(np.int32))
    base = torch.tensor(rng.standard_normal(N).astype(np.float32))
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    got = oa.overlap_add(base.to(cuda), vals.to(cuda), starts.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_overlap_add_kernel_rejects_what_it_does_not_take(cuda):
    vals, starts, base = _oa_case(0, 8, 256, 4096)
    out = base.to(cuda)
    with pytest.raises(TypeError):
        oa.overlap_add(out, vals.to(cuda), starts.to(cuda).long())
    with pytest.raises(ValueError):
        oa.overlap_add(out, vals.to(cuda).t().contiguous().t(),
                       starts.to(cuda))
    with pytest.raises(ValueError):
        oa.overlap_add(out, vals, starts)            # windows on the CPU
    n0 = kernels.overlap_add.launches
    oa.overlap_add(out, vals[:0].to(cuda), starts[:0].to(cuda))
    assert kernels.overlap_add.launches == n0
    assert torch.equal(out.cpu(), base)


def test_smoke_render_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    ir = (rng.standard_normal(8192) * np.exp(-np.arange(8192) / 800.0)) \
        .astype(np.float32)
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=48000, out_dur_s=0.5, time_unfold=100.0,
        gen_mode="Noise burst", micro_ms=1.0, grains_per_sec=60.0,
        max_grains=24, partial_stretch=4.0, bandlimit_on=True,
        bandlimit_out_hz=18000.0, bandlimit_roll_hz=2500.0,
        er_cloud_on=True, space_ir_on=True, stereo_on=True,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="", seed=5))
    want, _ = ms.render(p, ir_audio=ir, device="cpu")
    n0 = kernels.overlap_add.launches
    got, _ = ms.render(p, ir_audio=ir, device=cuda)
    torch.cuda.synchronize()
    assert kernels.overlap_add.launches == n0 + 1
    dev = (got.cpu().double() - want.double()).abs().max().item()
    assert 20 * np.log10(max(dev, 1e-300)) <= -100.0


def _smoke_tape(device):
    """Bench config 1 (bench.py:157-265) at its smoke size: the program on
    ``device``."""
    sr, seconds = 48000, 4.0
    rng = np.random.default_rng(7)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    audio = (x / np.max(np.abs(x))).astype(np.float32)
    n = len(audio)
    p = tape.TapeParams(
        sample_rate=sr, markers=[int(n * f) for f in (0.12, 0.3, 0.45,
                                                      0.6, 0.8)],
        section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
        section_reverse=[False, True, False, True, False, False],
        tape_age=60)
    p.section_speeds = tape.fit_to_target_time(p, n, seconds)
    frames = tape.section_render_length(p, n)
    return tape.build_tape_program(audio, p, frames, device=device)


def _lr_random(seed, n, T):
    """Random positions (some outside [0, n) for the clamp) and fractions
    (some negative, the reverse read's edge case)."""
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-1, 1, n).astype(np.float32)
    idx0 = rng.integers(-3, n + 3, T).astype(np.int32)
    fr = rng.uniform(-1, 1, T).astype(np.float32)
    idx0[:4] = [n - 1, 0, -1, n]
    return torch.tensor(audio), torch.tensor(idx0), torch.tensor(fr)


@pytest.mark.parametrize("n,T", [(192000, 194338), (1000, 1 << 20),
                                 (7, 1000), (1, 33)])
def test_lerp_read_kernel_bit_equal_to_plain_random(cuda, n, T):
    audio, idx0, fr = _lr_random(n + T, n, T)
    want = lr.lerp_read_plain(audio, idx0, fr)
    a, i, f = audio.to(cuda), idx0.to(cuda), fr.to(cuda)
    plain = lr.lerp_read_plain(a, i, f)
    n0 = kernels.lerp_read.launches
    got = lr.lerp_read(a, i, f)
    torch.cuda.synchronize()
    assert kernels.lerp_read.launches == n0 + 1
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), want)


def test_lerp_read_kernel_bit_equal_to_plain_tape_positions(cuda):
    prog = _smoke_tape(cuda)
    idx0, fr, _ = varispeed.tape_positions(
        tape.device_tables(prog), prog["consts"], prog["audio"].shape[0],
        prog["num_frames"])
    plain = lr.lerp_read_plain(prog["audio"], idx0, fr)
    got = lr.lerp_read(prog["audio"], idx0, fr)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)


def test_lerp_read_kernel_rejects_what_it_does_not_take(cuda):
    audio, idx0, fr = _lr_random(0, 100, 64)
    a, i, f = audio.to(cuda), idx0.to(cuda), fr.to(cuda)
    n0 = kernels.lerp_read.launches
    with pytest.raises(TypeError):
        kernels.lerp_read(a, i.long(), f)
    with pytest.raises(TypeError):
        kernels.lerp_read(a, i, f.double())
    with pytest.raises(ValueError):
        kernels.lerp_read(a, i[::2], f[::2])          # not contiguous
    with pytest.raises(ValueError):
        kernels.lerp_read(audio, i, f)                # audio on the CPU
    with pytest.raises(ValueError):
        lr.lerp_read(a, i, f[:10])
    assert kernels.lerp_read.launches == n0


def test_tape_smoke_render_on_cuda_matches_cpu(cuda):
    want, _ = tape.tape_table_render(_smoke_tape("cpu"))
    n0 = kernels.lerp_read.launches
    got, _ = tape.tape_table_render(_smoke_tape(cuda))
    assert kernels.lerp_read.launches == n0 + 1
    dev = np.abs(got.astype(np.float64) - want).max()
    assert 20 * np.log10(max(dev, 1e-300)) <= -120.0

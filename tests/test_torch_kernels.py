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
from audio_suite_torch.models import patternlab as pl
from audio_suite_torch.models import scrub
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


def _config4_buckets():
    """Bench config 4 at full size (bench.py:430-447): the render's
    overlap-add buffer length and, per bucket, (E, Lw, starts)."""
    cfg = pl.RenderConfig(sample_rate=44100, seconds=8.0, bpm=128, seed=9)
    events = [e for g in pl.list_generators() if g != "Python Script"
              for e in pl.generate(g, cfg)]
    synth = pl.MegaDriveInspiredSynth(44100, seed=9, device="cpu")
    n_total, spec, packs = synth.prepare_np(pl.apply_time_ops(events, cfg),
                                            cfg.seconds)
    buckets, off = [], {"fmi": 0, "pgi": 0}
    for (is_psg, L, _alg, _vib, count) in spec:
        k = "pgi" if is_psg else "fmi"
        buckets.append((count, L, packs[k][off[k]: off[k] + count, 1]))
        off[k] += count
    return n_total + max(L for (_p, L, _a, _v, _c) in spec), buckets


@pytest.mark.parametrize("bucket", range(14))
def test_overlap_add_kernel_bit_equal_to_plain_config4(cuda, bucket):
    """Every bucket of the full-size config-4 render, with its own starts:
    E from 1 to 73, Lw from 2 048 to 32 768, N 385 568."""
    N, buckets = _config4_buckets()
    assert N == 385568 and len(buckets) == 14
    E, Lw, starts = buckets[bucket]
    rng = np.random.default_rng(bucket)
    vals = torch.tensor(rng.standard_normal((E, Lw)).astype(np.float32))
    base = torch.tensor(rng.standard_normal(N).astype(np.float32))
    starts = torch.tensor(starts)
    want = oa.overlap_add_plain(base.clone(), vals, starts)
    n0 = kernels.overlap_add.launches
    got = oa.overlap_add(base.to(cuda), vals.to(cuda), starts.to(cuda))
    torch.cuda.synchronize()
    assert kernels.overlap_add.launches == n0 + 1
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


def _hr_case(seed, n, T):
    """Near-monotone wrapped positions (steps of -2..2 samples, a jump)
    that start below 0 and run past n, with random fractions."""
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-1, 1, n).astype(np.float32)
    steps = rng.integers(-2 * (1 << 22), 2 * (1 << 22), T)
    pos = -3 * (1 << 22) * 1000 + np.cumsum(steps)
    pos[T // 2:] += 7 * n * (1 << 22)                 # a jump past n
    whole = (pos >> 22).astype(np.int32)
    frac = (pos & ((1 << 22) - 1)).astype(np.int32)
    return (torch.tensor(audio), torch.tensor(whole), torch.tensor(frac))


def _env(T, bs, seed):
    """A block envelope with zeros, fractions and gains that clip."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.choice(np.float32([0.0, 0.65, 1.0, 0.3, 1.7, 3.0]),
                                   -(-T // bs)))


def _on_card(x, cuda, skip):
    """``x`` on the card, its rows starting ``skip`` elements into their
    storage (1: off the 16-byte grid)."""
    return torch.cat([x.new_zeros(skip), x]).to(cuda)[skip:]


def _fused_check(cuda, audio, whole, frac, ow, of, gain, summed, env, bs,
                 t0=0, t1=None, segs=None, skip=0):
    """The fused kernel against its plain version on the card and on the
    CPU, and against ``_finish(heads_read_plain(...))``, in f32 and PCM16:
    one launch per segment (default: [t0, t1)), each writing only its
    samples of one buffer."""
    T = whole.shape[0]
    segs = segs or [(t0, T if t1 is None else t1, ow, of, summed)]
    a, e = audio.to(cuda), env.to(cuda)
    w, f = _on_card(whole, cuda, skip), _on_card(frac, cuda, skip)
    for dtype in (torch.float32, torch.int16):
        got = _on_card(torch.full((T,), 7, dtype=dtype), cuda, skip)
        plain = got.clone()
        want = torch.full((T,), 7, dtype=dtype)
        n0 = kernels.scrub_read.launches
        for s0, s1, o_w, o_f, summ in segs:
            lr.scrub_read(a, w, f, o_w, o_f, gain, summ, e, bs, got, s0, s1)
            lr.scrub_read_plain(a, w, f, o_w, o_f, gain, summ, e, bs, plain,
                                s0, s1)
            lr.scrub_read(audio, whole, frac, o_w, o_f, gain, summ, env, bs,
                          want, s0, s1)
            buf = lr.heads_read_plain(audio, whole, frac, o_w, o_f, gain,
                                      summ)
            buf = torch.cat([buf, buf.new_zeros(env.shape[0] * bs - T)])
            ref = scrub._finish(buf, env, bs, dtype == torch.int16)
            assert torch.equal(want[s0:s1], ref[s0:s1])
        torch.cuda.synchronize()
        assert kernels.scrub_read.launches == n0 + len(segs)
        assert torch.equal(got, plain)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("summed", [True, False], ids=["A", "B"])
@pytest.mark.parametrize("n,T,ow,of", [
    (480000, 1439744, [-2000, 0, 2000], [0, 0, 0]),   # config 2's layout
    (16000, 1 << 16, [-2000, 2000], [0, 0]),
    (16000, 1 << 16, [0], [0]),
    (700, 12288, [-16001, 3, 31999], [0, 0, 0]),      # offsets past n
    (16000, 40960, [-1501, 0, 1999], [3145728, 2097152, 1048576]),
])
def test_heads_read_kernel_bit_equal_to_plain(cuda, summed, n, T, ow, of):
    """The fused scrub read (the multi-head read, then the envelope and
    PCM16) at config 2's layout and around it."""
    if summed and any(of):
        of = [0] * len(of)
    audio, whole, frac = _hr_case(n + T + len(ow), n, T)
    gain = float(np.float32(0.8 / len(ow)))
    _fused_check(cuda, audio, whole, frac, ow, of, gain, summed,
                 _env(T, 1024, T), 1024)


def test_heads_read_kernel_on_segment_slices(cuda):
    """The live-control render's launches: one per segment, each into its
    own samples of one buffer, in both forms."""
    audio, whole, frac = _hr_case(5, 16000, 40960)
    _fused_check(cuda, audio, whole, frac, None, None, 0.4, None,
                 _env(40960, 1024, 5), 1024, segs=[
                     (0, 2048, [-700, 650], [2097152, 0], False),
                     (2048, 7168, [-2000, 2000], [0, 0], True),
                     (7168, 12288, [0], [0], True),
                     (12288, 40960, [-2200, 0, 2200], [0] * 3, True)])


@pytest.mark.parametrize("summed", [True, False], ids=["A", "B"])
@pytest.mark.parametrize("T,t0,t1,bs", [
    (1, 0, 1, 1024), (7, 0, 7, 1024), (100, 3, 97, 1024),
    (2047, 0, 2047, 1024), (2049, 0, 2049, 1000), (6000, 13, 5990, 64),
    (70001, 2051, 70001, 1000),
])
def test_scrub_read_kernel_ragged_tails(cuda, summed, T, t0, t1, bs):
    """Launches that cover less than one tile, or end in a ragged tile and
    start off the 8-sample grid, with small and odd envelope blocks."""
    audio, whole, frac = _hr_case(T, 5000, T)
    of = [0, 0] if summed else [1048576, 3145728]
    _fused_check(cuda, audio, whole, frac, [-1200, 1300], of, 0.4, summed,
                 _env(T, bs, T + 1), bs, t0, t1)


def _tile_case(kind, n=30000, T=8192):
    """Positions that advance ~0.8 a sample, with, inside the block of
    samples 1024 .. 2048: a jump ("jump") or the wrap at n ("wrap"); or
    random positions in [-n, 3n) ("random": outside [0, 2n), the 32-bit
    mod), or a speed of 3 samples a sample ("fast")."""
    rng = np.random.default_rng(len(kind))
    step = {"fast": 3 << 22}.get(kind, 3355443)        # ~0.8 sample
    pos = np.arange(T, dtype=np.int64) * step + 1000 * (1 << 22)
    if kind == "jump":
        pos[1500:] += 11000 * (1 << 22)
    if kind == "wrap":
        pos += (n - 500 - int(pos[1000] >> 22)) * (1 << 22)
    if kind == "random":
        pos = rng.integers(-n << 22, 3 * n << 22, T)
    whole = (pos >> 22).astype(np.int32)
    frac = (pos & ((1 << 22) - 1)).astype(np.int32)
    audio = rng.uniform(-1, 1, n).astype(np.float32)
    return torch.tensor(audio), torch.tensor(whole), torch.tensor(frac)


@pytest.mark.parametrize("summed", [True, False], ids=["A", "B"])
@pytest.mark.parametrize("kind", ["jump", "wrap", "random", "fast"])
def test_scrub_read_kernel_position_layouts(cuda, kind, summed):
    """A jump or the wrap at n inside one block of samples, positions
    spread below 0 and past 2n (the kernel's 32-bit mod), a fast speed:
    the same samples as the plain version."""
    audio, whole, frac = _tile_case(kind)
    of = [0, 0, 0] if summed else [2097152, 0, 4194303]
    _fused_check(cuda, audio, whole, frac, [-2000, 0, 2000], of, 0.3,
                 summed, _env(whole.shape[0], 1024, 3), 1024)


def test_scrub_read_kernel_carries_and_misaligned_rows(cuda):
    """Form B with fractions outside [0, 2**22) (carries other than 0 or
    1: the 64-bit fallback) and rows that start off a 16-byte boundary."""
    audio, whole, frac = _hr_case(9, 3000, 9000)
    rng = np.random.default_rng(9)
    frac = torch.tensor(rng.integers(-(1 << 28), 1 << 28, 9000)
                        .astype(np.int32))
    _fused_check(cuda, audio, whole, frac, [-2000, 7, 1999],
                 [4194303, 1 << 21, 0], 0.3, False, _env(9000, 512, 9), 512)
    _fused_check(cuda, audio, whole, frac, [-2000, 7], [0, 0], 0.3, True,
                 _env(9000, 512, 10), 512, 5, 8990, skip=1)


def test_heads_read_kernel_rejects_what_it_does_not_take(cuda):
    audio, whole, frac = _hr_case(0, 100, 64)
    a, w, f = audio.to(cuda), whole.to(cuda), frac.to(cuda)
    env = torch.ones(1, device=cuda)
    out = torch.empty(64, device=cuda)
    n0 = kernels.scrub_read.launches

    def read(a=a, w=w, f=f, ow=(0,), of=(0,), summed=True, env=env,
             out=out, t0=0, t1=64):
        kernels.scrub_read(a, w, f, list(ow), list(of), 1.0, summed, env, 64,
                           out, t0, t1)

    with pytest.raises(TypeError):
        read(w=w.long())
    with pytest.raises(ValueError):
        read(w=w[::2], f=f[::2], out=out[::2])
    with pytest.raises(ValueError):
        read(ow=(0, 1, 2, 3), of=(0,) * 4, summed=False)
    with pytest.raises(ValueError):
        read(of=(7,))
    with pytest.raises(ValueError):
        read(a=audio)
    with pytest.raises(TypeError):
        read(out=out.double())
    with pytest.raises(ValueError):
        read(t1=65)
    with pytest.raises(ValueError):
        read(env=env[:0])
    assert kernels.scrub_read.launches == n0


def _smoke_scrub():
    """Bench config 2 (bench.py:268-292) at its smoke size, its drags and
    jump scaled into the 2 s: (audio, cfg, trace)."""
    sr, k = 48000, 2.0 / 30.0
    rng = np.random.default_rng(7)
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.3 * np.sin(2 * np.pi * 933 * t + 0.5)
         + 0.1 * rng.standard_normal(t.size))
    audio = (x / np.max(np.abs(x))).astype(np.float32)
    cfg = scrub.ScrubConfig(sample_rate=sr, head_count=3)
    trace = scrub.scripted_gesture_trace(
        int(2 * sr / scrub.BLOCK_SIZE), sr,
        drag_events=[(2 * k, 8.0, 3 * k), (10 * k, -14.0, 4 * k),
                     (20 * k, 4.0, 5 * k)],
        base_speed=0.5, jumps=[(15 * k, 1000.0)])
    return audio, cfg, trace


def test_scrub_smoke_render_on_cuda_matches_cpu(cuda):
    audio, cfg, trace = _smoke_scrub()
    want = scrub.render_scrub(audio, cfg, trace, device="cpu")
    n0 = kernels.scrub_read.launches
    got = scrub.render_scrub(audio, cfg, trace, device=cuda)
    assert kernels.scrub_read.launches == n0 + 1
    dev = np.abs(got.astype(np.float64) - want).max()
    assert 20 * np.log10(max(dev, 1e-300)) <= -120.0
    want16 = scrub.render_scrub(audio, cfg, trace, pcm16=True, device="cpu")
    got16 = scrub.render_scrub(audio, cfg, trace, pcm16=True, device=cuda)
    assert np.abs(got16.astype(np.int32) - want16).max() <= 1


def test_scrub_live_control_render_launches_once_per_segment(cuda):
    """The ``scrub_keys`` golden (key events: 6 head layouts) on the card:
    one fused launch per control segment, within -120 dBFS of the CPU
    render, PCM16 within 1 LSB."""
    sr = 8000
    t = np.arange(sr * 2) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)
             + 0.25 * np.sin(2 * np.pi * 933 * t)).astype(np.float32)
    cfg = scrub.ScrubConfig(sample_rate=sr, seed=5, head_count=3)
    trace = scrub.scripted_gesture_trace(
        40, sr, drag_events=[(0.3, 4.0, 0.4)], base_speed=0.5,
        jumps=[(0.9, 3000.0)],
        key_events=[(0.2, "2"), (0.4, "Z"), (0.6, "1"), (0.8, "V"),
                    (1.0, "3"), (1.2, "Down")])
    segs = len(scrub.build_scrub_program(audio, cfg, trace, 2000.0)
               ["head_segments"])
    assert segs == 6
    for pcm16 in (False, True):
        want = scrub.render_scrub(audio, cfg, trace, 2000.0, pcm16=pcm16,
                                  device="cpu")
        n0 = kernels.scrub_read.launches
        got = scrub.render_scrub(audio, cfg, trace, 2000.0, pcm16=pcm16,
                                 device=cuda)
        assert kernels.scrub_read.launches == n0 + segs
        dev = np.abs(got.astype(np.float64) - want).max()
        if pcm16:
            assert dev <= 1
        else:
            assert 20 * np.log10(max(dev, 1e-300)) <= -120.0


def test_patternlab_smoke_render_on_cuda_matches_cpu(cuda):
    """Bench config 4 at its smoke size (2 s): one kernel launch per
    bucket, and the card's render within -100 dBFS of the CPU's."""
    cfg = pl.RenderConfig(sample_rate=44100, seconds=2.0, bpm=128, seed=9)
    events = [e for g in pl.list_generators() if g != "Python Script"
              for e in pl.generate(g, cfg)]
    want, _ = pl.render(events, cfg, device="cpu")
    synth = pl.MegaDriveInspiredSynth(44100, seed=9, device=cuda)
    prep = synth.prepare(pl.apply_time_ops(events, cfg), cfg.seconds)
    n0 = kernels.overlap_add.launches
    got = synth.render_prepared(prep, master_gain=cfg.master_gain)
    assert kernels.overlap_add.launches == n0 + len(prep.spec)
    dev = np.abs(got.astype(np.float64) - want).max()
    assert 20 * np.log10(max(dev, 1e-300)) <= -100.0


# ---------------------------------------------------------------- grain_scan

def _scan_noise(E, L, seed0=12345):
    """Each event's stick-slip noise rows and micro-chaos gates, as the
    generators draw them (seeds seed0 + e)."""
    from audio_suite_torch.ops import generators, noise
    seeds = torch.arange(seed0, seed0 + E, dtype=torch.int32)[:, None]
    i = torch.arange(L)
    return (noise.normal(seeds, i, generators.STREAM_BUILD),
            noise.normal(seeds, i, generators.STREAM_OUT),
            noise.uniform(seeds, i, generators.STREAM_GATE),
            generators.chaos_y0(seeds[:, 0]))


_SCAN_SHAPES = [(156, 2048), (37, 1000), (1, 130), (288, 4096),
                (288, 32768), (1, 1), (5, 1), (289, 700)]


@pytest.mark.parametrize("E,L", _SCAN_SHAPES)
def test_stick_slip_and_chaos_kernels_bit_equal_to_plain(cuda, E, L):
    """The factory sizes (156 events of 2 048), a ragged warp and tile,
    one event, a config-3 event count, config 3's width, one step, and
    289 events (3 a block on 132 SMs: a last block of one).  The
    stick-slip kernel's half is ``test_stick_slip_noise_kernel_bit_equal_
    to_plain`` at the same shapes: the kernel takes no rows."""
    from audio_suite_torch.ops import generators
    _, _, gates, y0 = _scan_noise(E, L)
    want = generators.chaos_scan_plain(gates, y0, 3.92, 0.35)
    n0 = kernels.chaos_scan.launches
    got = generators.chaos_scan(gates.to(cuda), y0.to(cuda), 3.92, 0.35)
    torch.cuda.synchronize()
    assert kernels.chaos_scan.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


def _ss_seeds(E: int) -> torch.Tensor:
    """Seeds 12345 + e, with 0, 2**31 - 1 and negative int32 seeds among
    them where E allows."""
    seeds = torch.arange(12345, 12345 + E, dtype=torch.int32)
    special = torch.tensor([0, 2**31 - 1, -1, -(2**31), -5],
                           dtype=torch.int32)
    seeds[1:1 + min(E - 1, 5)] = special[:max(0, min(E - 1, 5))]
    return seeds


@pytest.mark.parametrize("E,L", _SCAN_SHAPES)
def test_stick_slip_noise_kernel_bit_equal_to_plain(cuda, E, L):
    """The stick-slip kernel drawing its own noise rows, one launch a
    call, against its plain version (the two ``noise.normal`` draws and
    the plain loop)."""
    from audio_suite_torch.ops import generators
    seeds = _ss_seeds(E)
    args = (0.9, 0.06, 0.75, 0.08)
    want = generators.stick_slip_noise_scan_plain(seeds, L, *args)
    n0 = kernels.stick_slip_noise_scan.launches
    got = generators.stick_slip_noise_scan(seeds.to(cuda), L, *args)
    torch.cuda.synchronize()
    assert kernels.stick_slip_noise_scan.launches == n0 + 1
    assert L < 8 or torch.count_nonzero(want) > 0
    assert torch.equal(got.cpu(), want)


def _same_bits_or_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN where want is NaN (whatever its payload), every other bit equal."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("thr,build,decay,nz", [
    (0.9, 0.06, 0.75, 0.08),         # the render's
    (0.05, 0.5, -0.75, 1.0),         # a negative decay, short sticks
    (0.9, 0.06, 0.0, 0.08),          # decay 0: every slip ends at once
    (0.0, 0.06, 1.0, 0.08),          # thr 0, decay 1: slips end on no decay
    (float("inf"), 0.06, 0.75, 0.08),
])
def test_stick_slip_kernels_on_special_values(cuda, thr, build, decay, nz):
    """Where the kernel's chain departs from the plain loop's form (its
    back test is |force| < a limit from the decay, by the sign of a
    difference): decays of 0, 1 and below 0, a threshold of 0 and of
    +inf, over the noise the kernel draws (finite rows: no row of +-inf,
    NaN or -0 reaches it).  NaN where the plain loop gives NaN, every
    other bit equal."""
    from audio_suite_torch.ops import generators
    args = (thr, build, decay, nz)
    seeds = _ss_seeds(9)
    want = generators.stick_slip_noise_scan_plain(seeds, 600, *args)
    got = generators.stick_slip_noise_scan(seeds.to(cuda), 600, *args)
    torch.cuda.synchronize()
    assert _same_bits_or_nan(got.cpu(), want)


@pytest.mark.parametrize("E,L,lines,dlo,dhi", [
    (156, 2048, 8, 480, 9600),     # the factory delays: most past L
    (40, 500, 3, 0, 12),           # short delays, d 0 and 1 among them
    (33, 300, 2, 250, 350),        # around L
    (288, 32768, 2, 32768, 65536),  # config 3's width, d >= L: pointwise
    (3, 70000, 3, 5000, 90000),    # a row too long for shared memory
    (16, 1000, 3, 0, 1200),        # mixed d over -0 and negative gains
])
def test_waveguide_kernel_bit_equal_to_plain(cuda, E, L, lines, dlo, dhi):
    """Bit for bit, signed zeros included: rows of +0 and -0 samples, one
    event's gains negative, and a row of d 0 and gain 0."""
    from audio_suite_torch.ops import generators
    rng = np.random.default_rng(E + L)
    x = torch.tensor(rng.standard_normal((E, L)).astype(np.float32))
    d = torch.tensor(rng.integers(dlo, dhi + 1, (E, lines)).astype(np.int32))
    g = torch.tensor((0.7 * rng.uniform(0.6, 0.98, (E, lines)))
                     .astype(np.float32))
    m = torch.tensor(rng.uniform(0.15, 0.45, (E, lines)).astype(np.float32))
    x[0, ::3] = 0.0
    x[1 % E, ::2] = -0.0
    g[E // 2] = -g[E // 2]
    g[-1] = 0.0
    d[-1] = 0
    want = generators.waveguide_scan_plain(x, d, g, m)
    n0 = kernels.waveguide_scan.launches
    got = generators.waveguide_scan(x.to(cuda), d.to(cuda), g.to(cuda),
                                    m.to(cuda))
    torch.cuda.synchronize()
    assert kernels.waveguide_scan.launches == n0 + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_grain_scan_kernels_reject_what_they_do_not_take(cuda):
    bn, on, gates, y0 = _scan_noise(4, 64)
    with pytest.raises(ValueError):           # the starts on the CPU
        kernels.chaos_scan(gates.to(cuda), y0, 3.9, 0.3)
    with pytest.raises(TypeError):
        kernels.chaos_scan(gates.to(cuda).double(), y0.to(cuda), 3.9, 0.3)
    with pytest.raises(ValueError):
        kernels.chaos_scan(gates.to(cuda), y0[:3].to(cuda), 3.9, 0.3)
    with pytest.raises(TypeError):
        kernels.waveguide_scan(bn.to(cuda), torch.ones(4, 2, device=cuda),
                               torch.ones(4, 2, device=cuda),
                               torch.ones(4, 2, device=cuda))
    seeds = _ss_seeds(4)
    n0 = kernels.stick_slip_noise_scan.launches
    with pytest.raises(ValueError):           # a seed tensor on the CPU
        kernels.stick_slip_noise_scan(seeds, 64, 0.9, 0.06, 0.75, 0.08,
                                      (2, 3))
    with pytest.raises(ValueError):           # no step
        kernels.stick_slip_noise_scan(seeds.to(cuda), 0, 0.9, 0.06, 0.75,
                                      0.08, (2, 3))
    with pytest.raises(TypeError):
        kernels.stick_slip_noise_scan(seeds.to(cuda).long(), 64, 0.9, 0.06,
                                      0.75, 0.08, (2, 3))
    assert kernels.stick_slip_noise_scan.launches == n0


@pytest.mark.parametrize("mode", ["Stick–slip friction", "Micro-chaos"])
def test_scan_mode_renders_on_cuda_match_cpu(cuda, mode, monkeypatch):
    """Factory settings but 1 s, with the waveguide on: every grain_scan
    entry point of the render launches once per chunk.  Stick-slip draws
    its two noise rows in its kernel: no ``noise.normal`` call of their
    streams."""
    from audio_suite_torch.ops import generators, noise
    p = ms.MicrosoundParams.from_dict(dict(gen_mode=mode, out_dur_s=1.0,
                                           wg_on=True))
    want, _ = ms.render(p, device="cpu")
    scans = ("stick_slip_noise_scan", "chaos_scan", "waveguide_scan")
    n0 = {k: getattr(kernels, k).launches for k in scans}
    draws = []
    normal = noise.normal

    def spy(seed, idx, stream=0):
        if stream in (generators.STREAM_BUILD, generators.STREAM_OUT):
            draws.append(stream)
        return normal(seed, idx, stream)

    monkeypatch.setattr(noise, "normal", spy)
    got, meta = ms.render(p, device=cuda)
    torch.cuda.synchronize()
    scan = "stick_slip_noise_scan" if mode.startswith("Stick") \
        else "chaos_scan"
    assert getattr(kernels, scan).launches == n0[scan] + 1
    assert kernels.waveguide_scan.launches == n0["waveguide_scan"] + 1
    assert draws == []
    dev = (got.cpu().double() - want.double()).abs().max().item()
    assert 20 * np.log10(max(dev, 1e-300)) <= -100.0


# ---------------------------------------------------------------------------
# tape_scan.cu: the tape's scan engine
# ---------------------------------------------------------------------------

def _scan_case(kind, device):
    """A scan program on ``device`` (``tape.scan_inputs`` and the consts):
    bench config 1's smoke tape with inertia on or off; the splice and
    anti-click gains off; or a 1 777-sample tape that the render wraps
    around many times without a seek, reversed and with every gain on."""
    prog = _smoke_tape("cpu")
    audio = prog["audio"].numpy()
    n = len(audio)
    if kind == "wrap":
        audio = audio[:1777]
        n = len(audio)
        p = tape.TapeParams(
            sample_rate=48000, markers=[n // 3], section_speeds=[3.7, 2.9],
            section_reverse=[True, False], inertia_enabled=True,
            inertia_amount=20, current_speed=0.5, tape_age=100,
            boundary_smooth_len=40, splice_env_len=64)
    else:
        p = tape.TapeParams(
            sample_rate=48000,
            markers=[int(n * f) for f in (0.12, 0.3, 0.45, 0.6, 0.8)],
            section_speeds=[1.0, 2.0, 0.5, 4.0, 0.25, 1.5],
            section_reverse=[False, True, False, True, False, False],
            tape_age=60, inertia_enabled=kind == "inertia",
            inertia_amount=70, current_speed=2.5,
            enable_splice_fx=kind != "no gains",
            anticlick_enabled=kind != "no gains")
    prog = tape.build_tape_program(audio, p, 4000, device=device)
    mod_q = tape.wow_flutter_mod(4000, p.sample_rate, p.tape_age)
    return tape.scan_inputs(prog, mod_q), prog["consts"]


def _scan_words(st):
    return [int(v.view(torch.int32)) if v.dtype == torch.float32 else int(v)
            for v in st]


def _scan_at(ins, consts, state, chunk):
    """The scan engine on the card at ``chunk`` steps a chunk: through
    ``tape_scan_render`` at the default, else its wrapper's keyword."""
    if chunk == kernels.TAPE_SCAN_CHUNK:
        return varispeed.tape_scan_render(*ins, consts, state)
    out, fin = kernels.tape_scan(
        *ins, varispeed.scan_state_words(state, consts, ins[0].device),
        anticlick_on=consts.anticlick_on, smooth_len=consts.smooth_len,
        strength=consts.anticlick_strength, splice_on=consts.splice_on,
        inertia_on=consts.inertia_on, alpha_q=consts.alpha_q, chunk=chunk)
    return out, varispeed.scan_state(fin)


@pytest.mark.parametrize("chunk", [256, 1024, 4096])
@pytest.mark.parametrize("kind", ["inertia", "no inertia", "no gains",
                                  "wrap"])
@pytest.mark.parametrize("carried", [False, True], ids=["start", "carried"])
def test_tape_scan_kernel_bit_equal_to_plain(cuda, kind, carried, chunk):
    ins, consts = _scan_case(kind, cuda)
    state = None
    if carried:                  # inside the tape and inside an envelope
        state = varispeed.TapeState(*(
            torch.tensor(v, dtype=torch.float32 if k == 2 else torch.int32,
                         device=cuda)
            for k, v in enumerate((ins[0].shape[0] * 2 + 5, 4194303, 1.25,
                                   17, 3))))
    want, st_w = varispeed.tape_scan_render_plain(*ins, consts, state)
    n0 = kernels.tape_scan.launches
    got, st_g = _scan_at(ins, consts, state, chunk)
    torch.cuda.synchronize()
    assert kernels.tape_scan.launches == n0 + 1
    assert torch.equal(got, want)
    assert _scan_words(st_g) == _scan_words(st_w)
    assert got.abs().max().item() > 0.1


def _scan_against_model(cuda, case, chunk):
    """The kernel on one of tests/test_torch_tape_scan_chunks.py's cases
    at ``chunk``: bit-equal to the plain loop (samples and the five state
    words), and its chunk records (start states, jumped or walked) and
    walked count equal to the CPU model's."""
    import test_torch_tape_scan_chunks as model
    ins, consts, state = model._case(case, chunk)
    st = None if state is None else model.scan_state(state)
    want, st_w = varispeed.tape_scan_render_plain(*ins, consts, st)
    _, _, recs = model.render_chunked(ins, consts, chunk, state)
    dins = tuple(t.to(cuda) for t in ins)
    out, fin, rec, nwalked = kernels.tape_scan(
        *dins, varispeed.scan_state_words(st, consts, cuda),
        anticlick_on=consts.anticlick_on, smooth_len=consts.smooth_len,
        strength=consts.anticlick_strength, splice_on=consts.splice_on,
        inertia_on=consts.inertia_on, alpha_q=consts.alpha_q, chunk=chunk,
        return_records=True)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    assert _scan_words(varispeed.scan_state(fin.cpu())) == \
        _scan_words(st_w)
    assert np.array_equal(rec.cpu().numpy(), model.record_words(recs))
    assert int(nwalked[0]) == sum(k == "walked" for k, _ in recs)


@pytest.mark.parametrize("chunk", [32, 256])
@pytest.mark.parametrize("edge", ["first", "last"])
def test_tape_scan_kernel_crossing_on_a_chunk_edge(cuda, chunk, edge):
    """The section crossing (and its splice trigger) on a chunk's first or
    last step."""
    _scan_against_model(cuda, f"crossing on a chunk's {edge} step", chunk)


@pytest.mark.parametrize("chunk", [32, 1024])
@pytest.mark.parametrize("case", [
    "boundary hit on a chunk's first step", "wrap",
    "envelope across three chunks", "envelope ending on its index",
    "smoke", "carried", "inertia", "speed 0", "reversed read in (-1, 0)",
    "negative speed"])
def test_tape_scan_kernel_matches_chunked_model(cuda, case, chunk):
    """Every other case of the CPU model's tests on the card."""
    _scan_against_model(cuda, case, chunk)


def test_tape_scan_kernel_on_one_sample_and_none(cuda):
    ins, consts = _scan_case("inertia", cuda)
    for T in (0, 1, 31, 33):
        part = (ins[0], ins[1][:T].contiguous()) + ins[2:]
        want, st_w = varispeed.tape_scan_render_plain(*part, consts)
        got, st_g = varispeed.tape_scan_render(*part, consts)
        torch.cuda.synchronize()
        assert got.shape == (T,) and torch.equal(got, want)
        assert [float(v) for v in st_g] == [float(v) for v in st_w]


def test_tape_scan_kernel_rejects_what_it_does_not_take(cuda):
    ins, consts = _scan_case("inertia", cuda)
    kw = dict(anticlick_on=True, smooth_len=400, strength=0.55,
              splice_on=True, inertia_on=True, alpha_q=0.01)
    st = torch.zeros(5, dtype=torch.int32, device=cuda)
    n0 = kernels.tape_scan.launches
    bad = list(ins)
    bad[0] = ins[0].cpu()                                # audio on the CPU
    with pytest.raises(ValueError):
        kernels.tape_scan(*bad, st, **kw)
    bad = list(ins)
    bad[1] = ins[1].double()
    with pytest.raises(TypeError):
        kernels.tape_scan(*bad, st, **kw)
    bad = list(ins)
    bad[5] = ins[5].to(torch.uint8)                      # reverse not bool
    with pytest.raises(TypeError):
        kernels.tape_scan(*bad, st, **kw)
    bad = list(ins)
    bad[3] = ins[3][:-1]                                 # ends short
    with pytest.raises(ValueError):
        kernels.tape_scan(*bad, st, **kw)
    with pytest.raises(ValueError):
        kernels.tape_scan(*ins, st[:4], **kw)
    for chunk in (16, 100, 8192):                        # chunk lengths
        with pytest.raises(ValueError):
            kernels.tape_scan(*ins, st, chunk=chunk, **kw)
    big = torch.arange(4000, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                      # past shared memory
        kernels.tape_scan(ins[0], ins[1], big, big, big.float(),
                          torch.zeros(4000, dtype=torch.bool, device=cuda),
                          ins[6], ins[7], st, **kw)
    assert kernels.tape_scan.launches == n0


def test_tape_engines_on_cuda_match_cpu(cuda):
    """The trace renderer (one lerp_read a segment), the segment engine
    (one) and the scan engine (one tape_scan) on the card, each within
    -120 dBFS of the same render on the CPU."""
    sr = 8000
    rng = np.random.default_rng(3)
    t = np.arange(2 * sr) / sr
    audio = (0.5 * np.sin(2 * np.pi * 180 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    p = tape.TapeParams(sample_rate=sr, markers=[3000, 9000],
                        section_speeds=[1.0, 0.5, 2.0],
                        section_reverse=[False, False, True], tape_age=40)
    tr = tape.TapeTrace()
    tr.add(0.2, "set_speed", section=0, value=1.7)
    tr.add(0.5, "set_inertia", value=True)
    tr.add(0.9, "set_splice", value=False)
    tr.add(1.0, "set_splice", value=True)
    tr.add(1.3, "seek", sample=100)
    n0 = kernels.lerp_read.launches
    got = tape.render_tape_trace(audio, p, tr, 3 * sr, device=cuda)
    assert kernels.lerp_read.launches == n0 + 6
    want = tape.render_tape_trace(audio, p, tr, 3 * sr, device="cpu")
    assert 20 * np.log10(max(np.abs(got.astype(np.float64) - want).max(),
                             1e-300)) <= -120.0
    for engine, kern in (("segment", kernels.lerp_read),
                         ("scan", kernels.tape_scan)):
        n0 = kern.launches
        got = tape.render_tape(audio, p, 3000, device=cuda, engine=engine)
        assert kern.launches == n0 + 1
        want = tape.render_tape(audio, p, 3000, device="cpu", engine=engine)
        assert 20 * np.log10(max(np.abs(got.astype(np.float64)
                                        - want).max(), 1e-300)) <= -120.0


def test_microsound_batch_render_on_cuda_equals_single_renders(cuda,
                                                               tmp_path):
    """The pipelined batch (each job's pull on a side stream into pinned
    memory) writes exactly the card's single renders, one overlap-add
    launch a job, and resumes without one."""
    from audio_suite_torch.utils import io as audio_io
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
    man = str(tmp_path / "m.json")
    n0 = kernels.overlap_add.launches
    paths = ms.batch_render(p, str(tmp_path), seeds=[5, 6],
                            stretches=[4.0, 2.0], ir_audio=ir,
                            manifest_path=man, device=cuda)
    assert kernels.overlap_add.launches == n0 + 4 and len(paths) == 4
    for (s, st), path in zip([(5, 4.0), (5, 2.0), (6, 4.0), (6, 2.0)],
                             paths):
        q = ms.MicrosoundParams.from_dict(dict(p.to_dict(), seed=s,
                                               partial_stretch=st))
        want, _ = ms.render(q, ir_audio=ir, device=cuda)
        got, _ = audio_io.read_wav(path)
        np.testing.assert_array_equal(got, want.cpu().numpy())
    n0 = kernels.overlap_add.launches
    assert ms.batch_render(p, str(tmp_path), seeds=[5, 6],
                           stretches=[4.0, 2.0], ir_audio=ir,
                           manifest_path=man, device=cuda) == paths
    assert kernels.overlap_add.launches == n0


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_ca_on_one_card_equals_dense(cuda, shards):
    """parallel/ca.py on a mesh of one card repeated: bit-identical to the
    dense engine on the card at config 5's CA size."""
    from audio_suite_torch.models import forestfire as ff
    from audio_suite_torch.parallel import batch as pb
    from audio_suite_torch.parallel import ca
    params = ff.ModelParams()
    model = ff.ForestFireModel(params, seed=2, device=cuda)
    model.ignite_at(110, 80, radius=4)
    carry0 = {k: np.array(v) for k, v in model._np.items()}
    mesh = pb.make_mesh(shards, axis_names=("sp",), devices=[cuda] * shards)
    carry, stats = ca.simulate_sharded(params, carry0, 40, mesh, seed=2)
    np.testing.assert_array_equal(stats, model.simulate(40))
    for k in ("state", "fuel", "moisture", "age"):
        np.testing.assert_array_equal(carry[k].cpu().numpy(), model._np[k])
    assert stats[:, 6].sum() > 0

"""Pattern Lab's voice bank as one CUDA kernel a bucket
(``kernels/voice_bank.cu``) held bit for bit against the eager bank it
replaces, and the dispatch that chooses between them.  Imports no jax, so
the card's tests run where only PyTorch with CUDA and nvcc are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_voice_bank.py -q

On the CPU (no card needed):

- CPU tensors take the eager path, and the ``patternlab.bank`` span's
  ``fused`` / ``eager`` attributes count every bucket;
- on the card a lowpass of 64 or more taps (sample rates from ~221 kHz)
  runs as the kernel's scan passes, a shorter one as an FIR, in the
  eager order (the kernel's entry points stood in for by the eager ops);
- the dispatch hands the fused bank each bucket's own rows and arguments
  (the fused entry points stood in for by the eager bank);
- the kernel's constant blocks are laid out as ``synth.BANK_CONSTS`` and
  ``synth.scan_coefs`` say.

On the card, fused against eager, every bit of the masked contributions:
every FM (algorithm, vibrato) bucket and the PSG's tone and noise buckets
at 44.1, 96, 192, 230 and 300 kHz (the last two through the scan), notes
from 10 samples to buckets of 2**17; the tail clamp with starts near the
render's end; and the whole render of ``regen-20s`` and ``regen-120s``
(four seeds each) and of a 230 kHz render.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_suite_torch import kernels
from audio_suite_torch.models import patternlab as pl
from audio_suite_torch.ops import detmath
from audio_suite_torch.ops import synth as sy
from audio_suite_torch.utils import profiling as prof

ROOT = Path(__file__).resolve().parents[1]
GENERATORS = ["Glass Cells", "Fibonacci Gate", "Prime Phase",
              "Pythagorean Canon"]
# note lengths in samples: the fade's n <= 16 and n // 3 < 8 corners up to
# two notes in buckets of 2**17
LENGTHS = (10, 40, 200, 300, 1000, 3000, 5000, 20000, 70000, 100000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def tracer():
    """The tracer on and empty for the test, off and empty after it."""
    prof.disable()
    prof.reset()
    prof.enable()
    yield prof
    prof.disable()
    prof.reset()


def _fm_channels(alg: int, vib: bool):
    """The default channels' operators and feedbacks, all with algorithm
    ``alg``, with or without vibrato."""
    return [dataclasses.replace(c, algorithm=alg, lfo_hz=4.0 + k,
                                lfo_depth=0.05 * (k + 1) if vib else 0.0)
            for k, c in enumerate(pl.default_fm_channels())]


def _program(sr: int, engine: str, chans, device, **channels):
    """Notes of every length in LENGTHS on each of ``chans``, staggered,
    prepared on ``device``: (synth, PreparedRender)."""
    events, t = [], 0.0
    for j, n in enumerate(LENGTHS):
        for k, ch in enumerate(chans):
            events.append(pl.NoteEvent(t, n / sr, 45.0 + 5 * k + j,
                                       0.55 + 0.04 * j, ch, engine))
            t += 0.37 * n / sr + 0.003
    synth = pl.MegaDriveInspiredSynth(sr, seed=11, device=device, **channels)
    return synth, synth.prepare(events, t + max(LENGTHS) / sr + 0.01)


def _eager(synth, bucket, n_total):
    return synth.bucket_contrib(bucket, n_total, False)


def _fused(synth, bucket, n_total):
    return synth.bucket_contrib(bucket, n_total, True)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _diff(a, b) -> str:
    bad = (a.view(torch.int32) != b.view(torch.int32)).nonzero()
    return (f"{len(bad)} of {a.numel()} samples differ, first at "
            f"{bad[:4].tolist()}, max |d| {(a - b).abs().max().item():.3g}")


def _render_program(seed: int, seconds: float, device, sr: int = 44100):
    """The benchmark's Pattern Lab request: RenderConfig's defaults, the
    four builtin generators."""
    cfg = pl.RenderConfig(sample_rate=sr, seconds=seconds, seed=seed)
    events = [e for g in GENERATORS for e in pl.generate(g, cfg)]
    synth = pl.MegaDriveInspiredSynth(cfg.sample_rate, seed=seed,
                                      device=device)
    return synth, synth.prepare(pl.apply_time_ops(events, cfg), cfg.seconds)


# ---------------------------------------------------------------------------
# CPU: the dispatch
# ---------------------------------------------------------------------------

def _bank_span(recs):
    (bank,) = [r for r in recs if r.name == "patternlab.bank"]
    return bank


def test_cpu_tensors_take_the_eager_path(tracer):
    synth, prep = _render_program(5, 2.0, "cpu")
    n0 = (kernels.voice_bank_fm.launches, kernels.voice_bank_psg.launches)
    synth.render_prepared(prep, pcm16=True)
    assert (kernels.voice_bank_fm.launches,
            kernels.voice_bank_psg.launches) == n0
    bank = _bank_span(tracer.records())
    assert bank.attrs == {"fused": 0, "eager": len(prep.spec)}
    assert len(prep.spec) >= 4


def _stand_ins(monkeypatch, synth, calls):
    """The kernel's entry points stood in for by the eager ops on the
    CPU: the bank unfiltered (``one_pole_lp`` as the identity) or with
    its FIRs, each lowpass pass ``one_pole_lp`` and the clamp."""
    def clamp(y, i32, n_total):
        i = torch.arange(y.shape[1], dtype=torch.int32)
        return pl._tail_clamped(y, i32, i, n_total)

    def bank(is_psg):
        def run(f32, i32, L, n_total, *args):
            taps = args[-3:-1] if not is_psg else args[-2:-1]
            calls.append(("psg" if is_psg else "fm", taps))
            b = pl.Bucket(is_psg, L, 0 if is_psg else args[0],
                          False if is_psg else args[1], f32, i32, None)
            if not any(taps):
                monkeypatch.setattr(sy, "one_pole_lp", lambda x, a: x)
            y = synth.bucket_contrib(b, n_total, False)
            monkeypatch.setattr(sy, "one_pole_lp", one_pole_lp)
            return y
        return run

    def fir(x, i32, n_total, w):
        (a,) = [a for a in lps if sy._fir_len(a) == len(w)
                and np.array_equal(sy.fir_weights(a), w)]
        calls.append(("fir", len(w)))
        return clamp(one_pole_lp(x, a), i32, n_total)

    def scan(x, i32, n_total, coefs):
        (a,) = [a for a in lps if sy._fir_len(a) == 64
                and np.array_equal(sy.scan_coefs(a), coefs)]
        calls.append(("scan", 64))
        return clamp(one_pole_lp(x, a), i32, n_total)

    one_pole_lp = sy.one_pole_lp
    lps = {sy._f32(a) for a in (synth._lp1, synth._lp2, synth._psg_lp)}
    monkeypatch.setattr(kernels, "voice_bank_fm", bank(False))
    monkeypatch.setattr(kernels, "voice_bank_psg", bank(True))
    monkeypatch.setattr(kernels, "voice_bank_fir", fir)
    monkeypatch.setattr(kernels, "voice_bank_scan", scan)


@pytest.mark.parametrize("sr,taps", [(44100, (13, 11)), (96000, (28, 24)),
                                     (192000, (55, 47)),
                                     (221000, (63, 54)),
                                     (230000, (64, 57)),
                                     (300000, (64, 64))])
def test_filters_of_64_taps_take_the_scan_pass_on_the_card(monkeypatch, sr,
                                                           taps):
    """Each bucket's launches in order, and the contributions bit-equal
    to the eager bank's, with the kernel's entry points stood in for by
    the eager ops: one launch where every lowpass is under 64 taps; else
    the unfiltered bank, then each lowpass as an FIR or the scan."""
    synth = pl.MegaDriveInspiredSynth(sr, device="cpu")
    got = tuple(sy._fir_len(sy._f32(a)) for a in (synth._lp1, synth._lp2))
    assert got == taps
    assert synth._psg_lp == synth._lp1           # both at 12 kHz
    assert sy.bank_fused("cuda") and sy.bank_fused(torch.device("cuda:0"))
    assert not sy.bank_fused("cpu")
    events = [pl.NoteEvent(0.001, 0.004, 60.0, 0.8, 0, "FM"),
              pl.NoteEvent(0.002, 0.003, 48.0, 0.7, 3, "PSG")]
    prep = synth.prepare(events, 0.0055)
    calls = []
    _stand_ins(monkeypatch, synth, calls)
    for b in pl.buckets(prep):
        calls.clear()
        want = _eager(synth, b, prep.n_total)
        got = _fused(synth, b, prep.n_total)
        assert _bits_equal(got, want), _diff(got, want)
        mine = taps if not b.is_psg else taps[:1]
        if max(mine) < 64:
            assert calls == [("psg" if b.is_psg else "fm", mine)]
        else:
            assert calls == [("psg" if b.is_psg else "fm", (0,) * len(mine))] \
                + [("fir" if k < 64 else "scan", k) for k in mine]


def test_the_scan_branch_renders_eagerly_on_the_cpu(tracer):
    cfg = pl.RenderConfig(sample_rate=230000, seconds=0.2, seed=3)
    events = [pl.NoteEvent(0.01, 0.1, 60.0, 0.8, 0, "FM"),
              pl.NoteEvent(0.05, 0.1, 48.0, 0.7, 3, "PSG")]
    y, _ = pl.render(events, cfg, device="cpu")
    assert np.abs(y).max() > 0.01
    bank = _bank_span(tracer.records())
    assert bank.attrs == {"fused": 0, "eager": 2}


def test_the_fused_bank_gets_each_buckets_rows_and_arguments(tracer,
                                                             monkeypatch):
    """With the fused entry points stood in for by the eager bank (the
    plain reference), the render is the eager render, bit for bit, and
    every bucket counts as fused: each got its own rows, length,
    algorithm, vibrato flag and filters."""
    synth, prep = _render_program(9, 3.0, "cpu")
    want = synth.render_prepared(prep, device_out=True)
    tracer.reset()
    calls = []

    def fm(f32, i32, L, n_total, alg, vib, fade, lp1, lp2, dac_m1, sr):
        calls.append(("fm", L, alg, vib, f32.shape[0]))
        assert (fade, lp1, lp2, dac_m1, sr) == (
            synth._fade, synth._lp1, synth._lp2, synth._dac_m1, synth.sr)
        return _eager(synth, pl.Bucket(False, L, alg, vib, f32, i32, None),
                      n_total)

    def psg(f32, i32, L, n_total, fade, lp, sr, lfsr):
        calls.append(("psg", L, 0, False, f32.shape[0]))
        assert (fade, lp, sr) == (synth._fade, synth._psg_lp, synth.sr)
        assert lfsr is sy.lfsr_tables_on("cpu")
        return _eager(synth, pl.Bucket(True, L, 0, False, f32, i32, None),
                      n_total)

    monkeypatch.setattr(sy, "bank_fused", lambda device: True)
    monkeypatch.setattr(sy, "fm_bank_fused", fm)
    monkeypatch.setattr(sy, "psg_bank_fused", psg)
    got = synth.render_prepared(prep, device_out=True)
    assert _bits_equal(got, want)
    assert calls == [("psg" if p else "fm", L, a if not p else 0,
                      v if not p else False, c)
                     for (p, L, a, v, c) in prep.spec]
    bank = _bank_span(tracer.records())
    assert bank.attrs == {"fused": len(prep.spec), "eager": 0}


def _struct_fields(src: str, struct: str) -> list:
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    out = []
    for m in re.finditer(r"float (\w+)(?:\[(\w+)\])?;", body):
        size = m.group(2)
        out.append((m.group(1), 1 if size is None else
                    int(consts.get(size, size))))
    return out


def test_the_constant_block_is_laid_out_as_the_kernels_struct():
    src = (ROOT / "audio_suite_torch/kernels/voice_bank.cu").read_text()
    assert _struct_fields(src, "BankConsts") == list(sy.BANK_CONSTS)
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["kMaxTaps"]) == kernels.VOICE_BANK_MAX_TAPS - 1
    assert int(const["kTile"]) == kernels.VOICE_BANK_TILE \
        == 1 << int(const["kScanSteps"])
    synth = pl.MegaDriveInspiredSynth(44100, device="cpu")
    c = sy.bank_consts(44100, sy._f32(synth._lp1), sy._f32(synth._lp2),
                       synth._dac_m1)
    at, fields = 0, {}
    for name, size in sy.BANK_CONSTS:
        fields[name] = c[at:at + size]
        at += size
    assert at == c.size and c.dtype == np.float32
    assert np.array_equal(fields["sin_c"], detmath._S32)
    assert np.array_equal(fields["exp2_c"], detmath._E2C)
    hi, lo = fields["cos4_pair"]
    assert hi + lo == detmath._C32[4] and hi != 0 and lo != 0
    assert fields["inv_sr"][0] == np.float32(1 / 44100)
    assert fields["alg2_gain"][0] == np.float32(0.6)
    w1 = sy.fir_weights(synth._lp1)
    assert np.array_equal(fields["w1"][:len(w1)], w1)
    assert not fields["w1"][len(w1):].any()


def test_the_scan_constants_are_the_eager_scans_multipliers():
    """``scan_coefs``: ScanConsts (c, then p[s]) and the later steps'
    multipliers, each the eager scan's A where i >= d, bit for bit."""
    src = (ROOT / "audio_suite_torch/kernels/voice_bank.cu").read_text()
    steps = int(re.search(r"constexpr int kScanSteps = (\d+);",
                          src).group(1))
    assert _struct_fields(src, "ScanConsts") == [("c", 1), ("p", steps)]
    af = sy._f32(pl.MegaDriveInspiredSynth(300000, device="cpu")._lp1)
    coefs = sy.scan_coefs(af)
    assert coefs.shape == (32,) and coefs.dtype == np.float32
    assert coefs[0] == np.float32(1.0) - np.float32(af)
    # the eager scan's A after each step, on a row of 2**14
    A = torch.full((1 << 14,), af)
    d = 1
    while d < A.shape[0]:
        s = d.bit_length() - 1
        assert torch.all(A[d:] == torch.tensor(coefs[1 + s])), d
        A = torch.cat([A[:d], A[:-d] * A[d:]])
        d *= 2


# ---------------------------------------------------------------------------
# The card: fused against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("sr", [44100, 96000, 192000, 230000, 300000])
@pytest.mark.parametrize("alg,vib", [(1, False), (1, True), (2, False),
                                     (2, True), (3, False), (3, True)])
def test_fm_buckets_bit_equal_to_the_eager_bank(cuda, sr, alg, vib):
    synth, prep = _program(sr, "FM", range(6), cuda,
                           fm_channels=_fm_channels(alg, vib))
    seen = set()
    n0 = kernels.voice_bank_scan.launches
    for b in pl.buckets(prep):
        assert (b.alg, b.vib) == (alg, vib)
        want = _eager(synth, b, prep.n_total)
        got = _fused(synth, b, prep.n_total)
        assert _bits_equal(got, want), (b.L, _diff(got, want))
        seen.add(b.L)
    assert min(seen) == 256 and max(seen) == 1 << 17
    assert (kernels.voice_bank_scan.launches > n0) is (sr >= 230000)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [44100, 96000, 192000, 230000, 300000])
@pytest.mark.parametrize("noise", [False, True])
def test_psg_buckets_bit_equal_to_the_eager_bank(cuda, sr, noise):
    chans = (3,) if noise else (0, 1, 2)
    synth, prep = _program(sr, "PSG", chans, cuda)
    n0 = (kernels.voice_bank_psg.launches, kernels.voice_bank_scan.launches)
    for b in pl.buckets(prep):
        assert b.is_psg
        want = _eager(synth, b, prep.n_total)
        got = _fused(synth, b, prep.n_total)
        assert _bits_equal(got, want), (b.L, _diff(got, want))
        assert got.abs().max() > 0.01
    assert kernels.voice_bank_psg.launches == n0[0] + len(prep.spec)
    assert (kernels.voice_bank_scan.launches > n0[1]) is (sr >= 230000)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [44100, 230000])
@pytest.mark.parametrize("engine", ["FM", "PSG"])
def test_the_tail_clamp_bit_equal_near_the_renders_end(cuda, engine, sr):
    """n_total a few samples around a note's start and across the kernel's
    1 024-sample tiles: notes cut short, cut to nothing, or untouched;
    at 230 kHz through the scan's passes too."""
    chans = range(6) if engine == "FM" else range(4)
    synth, prep = _program(sr, engine, chans, cuda)
    for b in pl.buckets(prep):
        starts = b.i32[:, 1].tolist()
        for s in (starts[0], starts[-1]):
            for d in (-3, 0, 1, 2, 1023, 1024, 1025, 4097):
                want = _eager(synth, b, s + d)
                got = _fused(synth, b, s + d)
                assert _bits_equal(got, want), (b.L, d, _diff(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 77, 40_000_003, 2_147_000_001])
@pytest.mark.parametrize("seconds", [20.0, 120.0])
def test_the_whole_render_bit_equal_to_the_eager_bank(cuda, monkeypatch,
                                                      seconds, seed):
    """``regen-20s`` and ``regen-120s``: ``_render_dispatch`` fused and
    eager, float and PCM16; one launch a bucket on the fused path, none on
    the eager one."""
    synth, prep = _render_program(seed, seconds, cuda)
    n_fm = sum(1 for s in prep.spec if not s[0])
    n0 = (kernels.voice_bank_fm.launches, kernels.voice_bank_psg.launches)
    got = synth.render_prepared(prep, device_out=True)
    got16 = synth.render_prepared(prep, device_out=True, pcm16=True)
    assert (kernels.voice_bank_fm.launches - n0[0],
            kernels.voice_bank_psg.launches - n0[1]) \
        == (2 * n_fm, 2 * (len(prep.spec) - n_fm))
    monkeypatch.setattr(sy, "bank_fused", lambda device: False)
    n1 = kernels.voice_bank_fm.launches + kernels.voice_bank_psg.launches
    want = synth.render_prepared(prep, device_out=True)
    want16 = synth.render_prepared(prep, device_out=True, pcm16=True)
    assert kernels.voice_bank_fm.launches \
        + kernels.voice_bank_psg.launches == n1
    assert _bits_equal(got, want), _diff(got, want)
    assert torch.equal(got16, want16)
    assert got.abs().max() > 0.1


@pytest.mark.cuda
def test_a_whole_render_at_230_khz_bit_equal_to_the_eager_bank(cuda,
                                                               monkeypatch):
    """The scan's passes in a whole render: every bucket fused, a scan
    pass a bucket at least, the same bits as the eager bank."""
    synth, prep = _render_program(5, 4.0, cuda, sr=230000)
    n0 = (kernels.voice_bank_scan.launches, kernels.voice_bank_fir.launches)
    got = synth.render_prepared(prep, device_out=True)
    n_fm = sum(1 for s in prep.spec if not s[0])
    assert kernels.voice_bank_scan.launches - n0[0] >= len(prep.spec)
    assert kernels.voice_bank_fir.launches - n0[1] == n_fm
    monkeypatch.setattr(sy, "bank_fused", lambda device: False)
    want = synth.render_prepared(prep, device_out=True)
    assert _bits_equal(got, want), _diff(got, want)
    assert got.abs().max() > 0.1

"""Microsound's combined space kernel, ER (x) IR, from the ER kernel's
nonzero taps (``ops/space.py:er_ir_convolve_plain``; on a CUDA device
``kernels/space_conv.cu``) held against the host's f64 ``np.convolve``
that ``models/microsound.py:_space_kernels`` runs on the CPU.  Imports no
jax, so the card's tests run where only PyTorch with CUDA and nvcc are
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_space_conv.py -q

The fixed seed set: 64 seeds drawn from [1, 2147418112), the ``seed``
draw of the benchmark's ``noise-burst-seeds`` and ``stick-slip-seeds``,
at config 3's ER settings (``benchmark/configs/microsound-c3.json``:
320 taps, 45 ms, 192 kHz), with two IRs: the benchmark's 8 192-tap
decaying noise (built as ``benchmark/engines/microsound.py:setup`` builds
it) and ``examples/irs/comb_chamber.wav``.

On the CPU: the plain sum is bit-equal to ``np.convolve`` on the seed set
and on the edge cases (an IR of 8 taps, one nonzero tap, ER-only and
IR-only parameters); the card path's control flow, with the kernel stood
in for on the ``meta`` device, launches once a miss, never on a memo hit
and never with the ER cloud or the IR off.  On the card: the kernel is
``torch.equal`` to the plain sum on the card and to the host path on the
seed set, the same launch counts, and a render's PCM is the same with the
host's combined kernel.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_suite_torch import kernels
from audio_suite_torch.models import microsound as ms
from audio_suite_torch.ops import space
from audio_suite_torch.utils import profiling as prof
from audio_suite_torch.utils import wavcodec

REPO = Path(__file__).resolve().parents[1]
CONFIG3 = json.loads((REPO / "benchmark/configs/microsound-c3.json")
                     .read_text())
SEEDS = [int(s) for s in
         np.random.default_rng(20261018).integers(1, 2147418112, 64)]
IR_RUN_SEED = 8_589_934_597      # the run seed the benchmark's IR is made
#                                  from: past 32 bits, as run seeds may be


def _bench_ir() -> np.ndarray:
    from benchmark.engines import microsound as bm
    return bm.setup(CONFIG3, IR_RUN_SEED, "cpu").ir


def _comb_ir() -> np.ndarray:
    audio, _ = wavcodec.read_wav(str(REPO / "examples/irs/comb_chamber.wav"))
    return np.asarray(audio, np.float32)


IRS = {"bench": _bench_ir, "comb_chamber": _comb_ir}


def _params(seed: int, **kw) -> ms.MicrosoundParams:
    p = {k: CONFIG3["params"][k] for k in
         ("base_sr", "er_cloud_on", "er_taps", "er_max_ms", "space_ir_on",
          "space_ir_max_samps")}
    return ms.MicrosoundParams.from_dict({**p, "seed": seed, **kw})


def _plain(p: ms.MicrosoundParams, ir_audio, device="cpu"):
    """What the card path computes, by the plain sum on ``device``: the
    combined kernel where the ER cloud and the IR are both on, else the
    ER taps (or two zeros)."""
    er = (space.er_tap_kernel(p.er_taps, p.er_max_ms, p.base_sr, p.seed)
          if p.er_cloud_on else np.zeros(2, np.float32))
    irm = ms._space_ir(p, ir_audio)
    if not (p.er_cloud_on and irm is not None):
        return torch.from_numpy(er)
    return space.er_ir_convolve_plain(
        *space.space_conv_inputs(er, irm, device), er.size)


def _host(p: ms.MicrosoundParams, ir_audio) -> np.ndarray:
    return ms._space_kernels(p, ir_audio, device="cpu")[0]


@pytest.fixture(autouse=True)
def _fresh_memos():
    ms._SPACE_KERNEL_CACHE.clear()
    yield
    prof.disable()
    prof.reset()


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype == np.float32 and a.shape == b.shape \
        and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("ir_name", sorted(IRS))
def test_plain_sum_bit_equal_to_np_convolve_on_the_seed_set(ir_name):
    ir = IRS[ir_name]()
    for seed in SEEDS:
        p = _params(seed)
        got = _plain(p, ir).numpy()
        want = _host(p, ir)
        assert got.size == space.er_tap_kernel(
            p.er_taps, p.er_max_ms, p.base_sr, seed).size + \
            ms._space_ir(p, ir).size - 1
        assert _bits_equal(got, want), (ir_name, seed)


@pytest.mark.parametrize("case", ["ir_8_taps", "ir_7_taps", "er_only",
                                  "ir_only", "neither"])
def test_plain_sum_matches_the_host_path_at_the_edges(case):
    ir = _bench_ir()
    kw = {"ir_8_taps": {}, "ir_7_taps": {},
          "er_only": {"space_ir_on": False},
          "ir_only": {"er_cloud_on": False},
          "neither": {"er_cloud_on": False, "space_ir_on": False}}[case]
    ir = ir[:8] if case == "ir_8_taps" else ir[:7] if case == "ir_7_taps" \
        else ir
    for seed in SEEDS[:8]:
        p = _params(seed, **kw)
        assert _bits_equal(_plain(p, ir).numpy(), _host(p, ir)), seed


@pytest.mark.parametrize("offset", [0, 1, 4321, 8641])
def test_plain_sum_of_one_nonzero_tap(offset):
    rng = np.random.default_rng(offset)
    er = np.zeros(8642, np.float32)
    er[offset] = np.float32(rng.uniform(-1, 1))
    ir = rng.standard_normal(8192)
    got = space.er_ir_convolve_plain(*space.space_conv_inputs(er, ir, "cpu"),
                                     er.size).numpy()
    want = np.convolve(er.astype(np.float64), ir).astype(np.float32)
    assert _bits_equal(got, want)


def test_plain_sum_of_no_nonzero_tap_is_zero():
    er = np.zeros(40, np.float32)
    ir = np.random.default_rng(3).standard_normal(16)
    got = space.er_ir_convolve_plain(*space.space_conv_inputs(er, ir, "cpu"),
                                     40)
    assert got.dtype == torch.float32 and got.shape == (55,)
    assert not got.any() and not torch.signbit(got).any()


def test_nonzero_taps_ascending_in_one_buffer():
    er = np.zeros(64, np.float32)
    er[[0, 7, 9, 63]] = [1.0, -0.5, 2.0 ** -140, -3.25]
    ir = np.random.default_rng(4).standard_normal(9)
    offs, gains, ir64 = space.space_conv_inputs(er, ir, "cpu")
    assert offs.dtype == torch.int32 and gains.dtype == torch.float32
    assert offs.tolist() == [0, 7, 9, 63]
    assert gains.tolist() == er[[0, 7, 9, 63]].tolist()
    assert ir64.dtype == torch.float64 and ir64.tolist() == ir.tolist()
    assert offs.untyped_storage().data_ptr() == \
        gains.untyped_storage().data_ptr() == \
        ir64.untyped_storage().data_ptr()


def test_the_kernel_wrapper_raises_on_cpu_tensors():
    offs, gains, ir = space.space_conv_inputs(np.ones(4, np.float32),
                                              np.zeros(8), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.space_conv(offs, gains, ir, 4)


def _meta_launches(monkeypatch):
    """The card path on the ``meta`` device, its kernel stood in for by a
    launch counter that returns a tensor of the kernel's output shape."""
    calls = []

    def fake(offs, gains, ir, n_er):
        assert offs.dtype == torch.int32 and gains.dtype == torch.float32
        assert ir.dtype == torch.float64 and offs.shape == gains.shape
        calls.append(offs.shape[0])
        return torch.empty(n_er + ir.shape[0] - 1, device=ir.device)

    monkeypatch.setattr(kernels, "space_conv", fake)
    return calls


def test_card_path_launches_once_a_miss_and_never_on_a_hit(monkeypatch):
    calls = _meta_launches(monkeypatch)
    ir = _bench_ir()
    prof.enable()
    p = _params(SEEDS[0])
    first = ms._space_kernels(p, ir, device="meta")
    second = ms._space_kernels(p, ir, device="meta")
    assert first is second
    er, ir_k, ir_on = first
    n_er = space.er_tap_kernel(p.er_taps, p.er_max_ms, p.base_sr,
                               p.seed).size
    assert ir_on and er.device.type == ir_k.device.type == "meta"
    assert er.shape == (n_er + 8191,) and ir_k.shape == (8192,)
    assert ir_k.dtype == torch.float32
    assert len(calls) == 1 and 2 <= calls[0] <= 321
    # another seed misses and launches again
    third = ms._space_kernels(_params(SEEDS[1]), ir, device="meta")
    assert third[0] is not er and len(calls) == 2
    attrs = [(r.attrs["hit"], r.attrs["launched"]) for r in prof.records()
             if r.name == "microsound.space_kernels"]
    assert attrs == [(False, True), (True, False), (False, True)]


@pytest.mark.parametrize("kw", [{"space_ir_on": False},
                                {"er_cloud_on": False}])
def test_card_path_launches_nothing_with_one_side_off(monkeypatch, kw):
    calls = _meta_launches(monkeypatch)
    prof.enable()
    er, ir_k, ir_on = ms._space_kernels(_params(SEEDS[2], **kw), _bench_ir(),
                                        device="meta")
    assert calls == []
    assert ir_on == ("space_ir_on" not in kw)
    assert er.device.type == "meta" and ir_k.device.type == "meta"
    assert [r.attrs["launched"] for r in prof.records()] == [False]


def test_the_cpu_path_is_numpy_and_never_launched(monkeypatch):
    calls = _meta_launches(monkeypatch)
    prof.enable()
    er, ir_k, ir_on = ms._space_kernels(_params(SEEDS[3]), _bench_ir(),
                                        device="cpu")
    assert isinstance(er, np.ndarray) and isinstance(ir_k, np.ndarray)
    assert calls == [] and ir_on
    assert [r.attrs["launched"] for r in prof.records()] == [False]


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: space_conv.cu is built with nvcc "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("ir_name", sorted(IRS))
def test_kernel_bit_equal_to_plain_and_host_on_the_seed_set(cuda, ir_name):
    ir = IRS[ir_name]()
    for seed in SEEDS:
        p = _params(seed)
        n0 = kernels.space_conv.launches
        got = ms._space_kernels(p, ir, device=cuda)[0]
        torch.cuda.synchronize()
        assert kernels.space_conv.launches == n0 + 1
        plain = _plain(p, ir, device=cuda)
        assert got.device == cuda and torch.equal(got, plain), seed
        assert _bits_equal(got.cpu().numpy(), _host(p, ir)), seed


@pytest.mark.cuda
def test_kernel_launches_once_a_miss_and_never_on_a_hit(cuda):
    ir = _bench_ir()
    p = _params(SEEDS[4])
    n0 = kernels.space_conv.launches
    first = ms._space_kernels(p, ir, device=cuda)
    assert kernels.space_conv.launches == n0 + 1
    assert ms._space_kernels(p, ir, device="cuda") is first
    assert kernels.space_conv.launches == n0 + 1
    for kw in ({"space_ir_on": False}, {"er_cloud_on": False}):
        er, ir_k, _ = ms._space_kernels(_params(SEEDS[5], **kw), ir,
                                        device=cuda)
        assert er.device == ir_k.device == cuda
    assert kernels.space_conv.launches == n0 + 1


@pytest.mark.cuda
def test_kernel_at_the_edges(cuda):
    rng = np.random.default_rng(5)
    # one tap at either end, none, and more taps than a shared-memory stage
    for n_er, taps, n_ir in ((8642, [0], 8), (8642, [8641], 8192),
                             (8642, [], 8192), (5000, range(5000), 300)):
        er = np.zeros(n_er, np.float32)
        er[list(taps)] = rng.uniform(-1, 1, len(taps)).astype(np.float32)
        ir = rng.standard_normal(n_ir)
        want = space.er_ir_convolve_plain(
            *space.space_conv_inputs(er, ir, "cpu"), n_er)
        offs, gains, ir_dev = space.space_conv_inputs(er, ir, cuda)
        got = kernels.space_conv(offs, gains, ir_dev, n_er)
        plain = space.er_ir_convolve_plain(offs, gains, ir_dev, n_er)
        assert torch.equal(got, plain), (n_er, len(taps), n_ir)
        assert torch.equal(got.cpu(), want), (n_er, len(taps), n_ir)


@pytest.mark.cuda
def test_render_pcm_same_as_with_the_host_kernel(cuda):
    p = ms.MicrosoundParams.from_dict(
        {**CONFIG3["params"], **CONFIG3["smoke"]["config"]["params"],
         "seed": SEEDS[6]})
    ir = _bench_ir()
    got, _ = ms.render(p, ir_audio=ir, device=cuda, pcm16=True)
    prog = ms.build_program(p, ir_audio=ir)
    want, _ = ms.render_program(p, prog, ms._space_kernels(p, ir, "cpu"),
                                device=cuda, pcm16=True)
    assert torch.equal(got, want)

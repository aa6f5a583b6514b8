"""The re-expression that ``kernels/grain_scan.cu``'s waveguide kernel
relies on, held bit for bit on the CPU, and the padding rows it is given.

- The JAX scan (audio_suite_tpu/ops/generators.py:308-322) writes ring
  slot t mod d at step t, so the slot it reads at step t holds v(t - d),
  0 before step d: v(t) = y(t) + g v(t - d), and the steps t = j (mod d)
  form independent columns.  ``_columns`` computes each line column by
  column, vectorised over j, with the literal ``y + g * 0`` and
  ``(1 - mix) * y + mix * v`` on each column's first link, and is held to
  ``waveguide_scan_plain`` bit for bit (signed zeros included) over d of 0
  and 1, around L, past L and not dividing L, negative and zero gains,
  rows of +0 and -0, and the factory program's delays.
- ``_chunk_events`` gives a padded chunk's padding events a delay of L
  (one link a column, the kernel's cheapest); a waveguide render with
  them is bit-equal to one with the earlier fill of 0.
- The stick-slip kernel's noise feed draws ``noise.normal`` in 32-bit
  registers: ``_normal_kernel_model`` is its per-sample draw in NumPy
  uint32 (the key once, the 12 streams, each hash's low 8 bits cleared so
  that it converts to f32 exactly, the left-to-right f32 sum at scale
  2**32, then 2**-32 and - 6), held bit-equal to ``noise.normal_np``, the
  port's ``noise.normal`` and the JAX package's ``normal`` over seeds 0,
  1, 12345, 2**31 - 1 and negative int32 seeds that wrap, and t up to
  32 767.  ``stick_slip_noise_scan_plain`` is the two draws and
  ``stick_slip_scan_plain``, and ``gen_stick_slip`` on the CPU renders
  as it did from the two rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_suite_torch.models import microsound as ms
from audio_suite_torch.ops import generators, noise
from audio_suite_tpu.ops import noise as j_noise

torch.set_num_threads(1)


def _columns(x, d, g, mix):
    """The waveguide's lines in order, each as independent columns of
    stride max(d, 1), vectorised over the column index j: block k holds
    steps [k s, (k + 1) s) for s = min(max(d, 1), L), and its v reads the
    block before's (zeros for the first block)."""
    E, L = x.shape
    y = x.clone()
    for e in range(E):
        row = y[e]
        for ln in range(d.shape[1]):
            s = min(max(int(d[e, ln]), 1), L)
            gl, ml = g[e, ln], mix[e, ln]
            keep = 1.0 - ml
            out = torch.empty_like(row)
            prev = torch.zeros(s, dtype=torch.float32)
            for t0 in range(0, L, s):
                yt = row[t0:t0 + s]
                v = yt + gl * prev[:yt.shape[0]]
                out[t0:t0 + yt.shape[0]] = keep * yt + ml * v
                prev = v
            row = out
        y[e] = row
    return y


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _case(E, L, lines, dlo, dhi, seed, g_sign=1.0, zero_rows=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, L)).astype(np.float32)
    if zero_rows:
        x[0, ::3] = 0.0
        x[-1, ::2] = -0.0
    d = rng.integers(dlo, dhi + 1, (E, lines)).astype(np.int32)
    g = (g_sign * 0.7 * rng.uniform(0.6, 0.98, (E, lines))).astype(np.float32)
    m = rng.uniform(0.15, 0.45, (E, lines)).astype(np.float32)
    return tuple(torch.tensor(a) for a in (x, d, g, m))


@pytest.mark.parametrize("E,L,lines,dlo,dhi,g_sign,zero_rows", [
    (3, 97, 2, 0, 0, 1.0, False),          # d 0, acting as 1
    (3, 120, 2, 1, 1, 1.0, True),          # d 1
    (4, 256, 3, 255, 255, 1.0, False),     # d = L - 1
    (4, 256, 3, 256, 256, 1.0, True),      # d = L
    (4, 256, 3, 257, 4000, 1.0, True),     # d past L: pointwise lines
    (5, 300, 3, 7, 7, 1.0, False),         # d 7, not dividing 300
    (5, 300, 4, 2, 310, -1.0, True),       # negative gains, mixed d
    (5, 300, 3, 2, 310, 0.0, True),        # zero gains: g * v is +-0
])
def test_waveguide_columns_bit_equal_to_plain(E, L, lines, dlo, dhi, g_sign,
                                              zero_rows):
    x, d, g, m = _case(E, L, lines, dlo, dhi, E * L + lines, g_sign,
                       zero_rows)
    want = generators.waveguide_scan_plain(x, d, g, m)
    got = _columns(x, d, g, m)
    assert torch.equal(_bits(got), _bits(want))
    if zero_rows:
        # the literal first link turns -0 into +0 where g >= 0
        assert torch.any(_bits(x) != _bits(want))


def test_waveguide_columns_bit_equal_to_plain_at_the_factory_shape():
    """The factory program with the waveguide on (156 events of L 2 048,
    8 lines of d 480-9 588, most past L) in its one chunk of 160, padding
    rows included, over seeded grains."""
    prog = ms.build_program(ms.MicrosoundParams(wg_on=True))
    ec = ms._event_chunk(prog["E"], prog["L"])
    (ch,) = ms._chunk_events(prog, ec)
    L = prog["L"]
    assert (prog["E"], ec, L) == (156, 160, 2048)
    d = torch.tensor(ch["wg_d"])
    assert int(d.min()) < L < int(d[:prog["E"]].max())
    x = torch.tensor(np.random.default_rng(17).standard_normal(
        (ec, L)).astype(np.float32))
    g, m = torch.tensor(ch["wg_g"]), torch.tensor(ch["wg_m"])
    want = generators.waveguide_scan_plain(x, d, g, m)
    assert torch.equal(_bits(_columns(x, d, g, m)), _bits(want))


def _padded_params():
    """The factory settings at 2 s with the waveguide on: 39 events, so
    that chunks of 32 leave 25 padding events in the second."""
    return ms.MicrosoundParams(wg_on=True, out_dur_s=2.0)


def test_padding_rows_carry_a_delay_of_L():
    prog = ms.build_program(_padded_params())
    E, L = prog["E"], prog["L"]
    chunks = ms._chunk_events(prog, 32)
    assert len(chunks) == 2 and E % 32 > 0
    pad = chunks[-1]["wg_d"][E % 32:]
    assert pad.shape[0] == 32 - E % 32 and np.all(pad == L)
    assert np.all(chunks[-1]["amp"][E % 32:] == 0.0)


def test_padding_delay_renders_as_the_earlier_fill_of_zero(monkeypatch):
    p = _padded_params()
    want, meta = ms.render(p, device="cpu", event_chunk=32)
    assert meta["events"] % 32 > 0
    chunk_events = ms._chunk_events

    def zero_fill(prog, ec):
        chunks = chunk_events(prog, ec)
        real = prog["E"] - ec * (len(chunks) - 1)
        chunks[-1]["wg_d"][real:] = 0
        return chunks

    monkeypatch.setattr(ms, "_chunk_events", zero_fill)
    got, _ = ms.render(p, device="cpu", event_chunk=32)
    assert float(want.abs().max()) > 0.5
    assert torch.equal(_bits(got), _bits(want))


# ---- stick-slip: the kernel's own draw of its two noise rows

_SS_SEEDS = np.array([0, 1, 12345, 2**31 - 1, -1, -5, -(2**31)], np.int32)
_SS_ARGS = (0.9, 0.06, 0.75, 0.08)     # threshold, build, decay, noise_amt


def _ss_times():
    """Steps 0 to 32 767: the tile edges and a seeded sample between."""
    edges = [0, 1, 2, 3, 4, 127, 128, 129, 2047, 2048, 16383, 32766, 32767]
    rest = np.random.default_rng(5).integers(0, 32768, 400)
    return np.unique(np.concatenate([edges, rest])).astype(np.int64)


def _mix_u32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _normal_kernel_model(seed, t, stream: int) -> np.ndarray:
    """grain_scan.cu's ss_normal for every (seed, t) pair of the broadcast
    seed [S, 1] x t [T], in NumPy uint32 arithmetic."""
    with np.errstate(over="ignore"):
        key = (np.asarray(seed).astype(np.uint32) * np.uint32(0x9E3779B9)
               + np.asarray(t).astype(np.uint32) * np.uint32(0x85EBCA6B))
        acc = None
        for j in range(12):
            c = ((stream * 12 + j + 1) & 0xFFFFFFFF) * 0xC2B2AE35 & 0xFFFFFFFF
            h = _mix_u32(key + np.uint32(c)) & np.uint32(0xFFFFFF00)
            term = h.astype(np.float32)          # exact: <= 24 bits set
            acc = term if acc is None else (acc + term).astype(np.float32)
    return (acc * np.float32(2.0 ** -32) - np.float32(6.0)).astype(np.float32)


@pytest.mark.parametrize("stream", [generators.STREAM_BUILD,
                                    generators.STREAM_OUT, 0, 11])
def test_kernel_draw_model_bit_equal_to_normal(stream):
    seed, t = _SS_SEEDS[:, None], _ss_times()
    got = _normal_kernel_model(seed, t, stream)
    assert np.array_equal(got.view(np.int32),
                          noise.normal_np(seed, t, stream).view(np.int32))
    port = noise.normal(torch.tensor(seed), torch.tensor(t), stream)
    assert np.array_equal(got.view(np.int32), port.numpy().view(np.int32))
    jax_ = np.asarray(j_noise.normal(jnp.asarray(seed), jnp.asarray(t),
                                     stream))
    assert np.array_equal(got.view(np.int32), jax_.view(np.int32))


def test_kernel_draw_model_wraps_the_stream_like_normal():
    """A stream whose 12 s + j + 1 passes 2**32 (the wrapper hands the
    kernel streams mod 2**32)."""
    seed, t = _SS_SEEDS[:, None], _ss_times()[:64]
    stream = 2**32 - 1
    port = noise.normal(torch.tensor(seed), torch.tensor(t), stream)
    assert np.array_equal(_normal_kernel_model(seed, t, stream)
                          .view(np.int32), port.numpy().view(np.int32))


@pytest.mark.parametrize("E,L", [(1, 1), (7, 130), (5, 300), (3, 1000)])
def test_stick_slip_noise_plain_is_the_draws_and_the_row_form(E, L):
    seed = torch.tensor(np.resize(_SS_SEEDS, E))
    i = torch.arange(L)
    rows = generators.stick_slip_scan_plain(
        noise.normal(seed[:, None], i, generators.STREAM_BUILD),
        noise.normal(seed[:, None], i, generators.STREAM_OUT), *_SS_ARGS)
    got = generators.stick_slip_noise_scan_plain(seed, L, *_SS_ARGS)
    assert torch.equal(_bits(got), _bits(rows))
    # the dispatcher takes the plain path for a seed on the CPU
    assert torch.equal(_bits(generators.stick_slip_noise_scan(
        seed, L, *_SS_ARGS)), _bits(rows))
    if L >= 300:
        assert torch.count_nonzero(rows) > 0


def test_gen_stick_slip_on_the_cpu_renders_as_from_the_rows():
    """The generator as it was before it drew through the dispatcher: the
    two rows, the row form, the Hann window and the mask."""
    L = 2048
    seed = torch.tensor(np.resize(_SS_SEEDS, 9))
    n = torch.tensor([1500, 1, 2, 2048, 700, 1500, 1024, 3, 1999])
    i = torch.arange(L)
    bn = noise.normal(seed[:, None], i, generators.STREAM_BUILD)
    on = noise.normal(seed[:, None], i, generators.STREAM_OUT)
    xs = generators.stick_slip_scan(bn, on, *_SS_ARGS)
    want = torch.where(i < n[:, None], xs * generators.hann_t(i, n[:, None]),
                       0.0)
    got = generators.gen_stick_slip(i, n, seed, *_SS_ARGS)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.count_nonzero(want) > 0

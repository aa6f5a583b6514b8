"""The port's Microsound generator modes held against the JAX package.

- ``build_program`` array for array for every mode and option, at the
  fully-featured small configuration of tests/test_microsound.py:19-31;
- each generator against its JAX function over the same events (the JAX
  side vmapped and jitted, as Tier-1 runs it), at -100 dB of the grains'
  peak: the two frameworks' exp / cos round differently in the last ulp,
  and XLA may contract the Gaussian click's and the resonator's
  multiply-adds where the port rounds each op once;
- the raw recurrences: the micro-chaos map bit-equal to JAX's jitted scan;
  the stick-slip loop bit-equal to a once-rounded NumPy f32 loop (the
  oracle's steps in f32) and within one f32 rounding step of JAX's jitted
  scan, where XLA contracts multiply-adds (at the factory settings 43 of
  seed 12345's 2 048 samples differ, see ``test_stick_slip_scan``);
- the waveguide with delays past the grain length (its ring never wraps);
- a render per mode within -100 dBFS of JAX's ``render``.

The plain scans are what runs here; the CUDA kernel of the same
recurrences is held bit-equal to them in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_suite_tpu.models import microsound as jms
from audio_suite_tpu.ops import generators as j_gen
from audio_suite_tpu.ops import noise as j_noise
from audio_suite_tpu.ops import space as j_space
from audio_suite_torch.models import microsound as tms
from audio_suite_torch.ops import generators, noise, space

torch.set_num_threads(1)

TOL_DB = -100.0

# tests/test_microsound.py:19-31, the fully-featured small configuration
SMALL = dict(
    base_sr=8000, out_dur_s=0.4, time_unfold=2.0, micro_ms=4.0,
    seed=4242, event_process="Poisson", grains_per_sec=30.0,
    max_grains=64, grain_amp_rand=0.35, grain_offset_on=True,
    grain_offset_max_ms=10.0, bandlimit_on=True, bandlimit_out_hz=3000.0,
    bandlimit_roll_hz=500.0, er_cloud_on=True, er_taps=64, er_max_ms=20.0,
    stereo_on=True, stereo_width=0.6, env_a=5.0, env_d=50.0, env_s=0.7,
    env_r=100.0, bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="")

# each mode's settings in tests/test_microsound.py:47-94; stick-slip and
# micro-chaos with longer grains, so that the friction slips
MODE_KW = {
    "Gaussian click": {},
    "Dust impulses": dict(dust_density=0.05),
    "Noise burst": dict(noise_tilt=-3.0),
    "Skewed transient": dict(noise_tilt=-3.0),
    "Resonant strike": dict(ring_hz=900.0, ring_decay_ms=3.0),
    "Crackle / corona": dict(crackle_alpha=1.4, crackle_density=60.0,
                             crackle_kernel=32),
    "Stick–slip friction": dict(grains_per_sec=15.0, micro_ms=20.0),
    "Micro-chaos": dict(grains_per_sec=15.0, micro_ms=12.0),
    "Wavelet atoms": dict(wav_base_hz=600.0, wav_count=4, wav_spread=0.6,
                          micro_ms=10.0, grains_per_sec=12.0),
    "IR fragment": dict(grains_per_sec=15.0),
    "Image scanline": dict(grains_per_sec=15.0),
}

_IR = (np.random.default_rng(3).standard_normal(2048) * 0.5) \
    .astype(np.float32)
_IMG = np.random.default_rng(5).integers(0, 256, size=(32, 64)) \
    .astype(np.float64)


def _inputs(mode):
    return dict(ir_audio=_IR if mode == "IR fragment" else None,
                img_gray=_IMG if mode == "Image scanline" else None)


def _params(**kw):
    d = dict(SMALL, **kw)
    return jms.MicrosoundParams.from_dict(d), tms.MicrosoundParams.from_dict(d)


def _dev_db(ref, got):
    """max |got - ref| in dB relative to the reference's peak."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    dev = np.max(np.abs(got - ref))
    return 20.0 * np.log10(max(dev, 1e-300) / np.max(np.abs(ref)))


def _dbfs(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return 20.0 * np.log10(max(np.max(np.abs(got - ref)), 1e-300))


# ---------------------------------------------------------------- programs

_PROGRAM_CASES = [dict(gen_mode=m, **kw) for m, kw in MODE_KW.items()] + [
    dict(gen_mode="IR fragment"),                      # no IR: 2-sample rows
    dict(gen_mode="Image scanline"),                   # no image
    dict(gen_mode="Noise burst", res_bank_on=True, res_modes=8),
    dict(gen_mode="Micro-chaos", wg_on=True, wg_lines=3, wg_max_ms=9.0),
    dict(gen_mode="Dust impulses", res_bank_on=True, wg_on=True,
         bp_unfold="0:1.5, 0.4:3", bp_stretch="0:0.8, 0.4:1.6"),
    dict(gen_mode="Crackle / corona", event_process="Hawkes",
         hawkes_gain=0.8, grain_offset_on=False),
    dict(gen_mode="Wavelet atoms", unfold_mode="Multi-band unfold",
         event_process="Clustered", bp_cutoff="0:2000, 0.4:3500"),
]


@pytest.mark.parametrize("case", _PROGRAM_CASES,
                         ids=[str(i) for i in range(len(_PROGRAM_CASES))])
def test_build_program_equal_every_mode(case):
    pj, pt = _params(**case)
    mode = case["gen_mode"]
    kw = {"ir_audio": _IR if mode == "IR fragment" and len(case) > 1
          else None,
          "img_gray": _IMG if mode == "Image scanline" and len(case) > 1
          else None}
    want = jms.build_program(pj, **kw)
    got = tms.build_program(pt, **kw)
    assert want["E"] > 2
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_chain_cfg_matches_jax_fields():
    """The shared rules (microsound.py:645): the factory default takes the
    shared branch; per-event stretch, warps and physical models do not."""
    for case, shared in [({}, True), (dict(bp_stretch="0:0.8, 0.4:1.6"),
                                      False),
                         (dict(nl_warp_on=True), False),
                         (dict(wg_on=True, gen_mode="Micro-chaos"), False),
                         (dict(bp_unfold="0:1.5, 0.4:3"), True)]:
        pj, pt = _params(**case)
        prog = jms.build_program(pj)
        jc = jms.chain_cfg(pj, prog, prog["E"])
        tc = tms.chain_cfg(pt, prog)
        assert tc.shared_stretch == jc.shared_stretch == shared, case
        for f in ("n_fft", "shared_gain", "oa_win", "L", "mode_id", "ss",
                  "chaos", "wav_count", "dust_kmax", "ck_klen", "wg_dmax",
                  "multiband", "res_modes", "wg_lines"):
            assert getattr(tc, f) == getattr(jc, f), (case, f)
    d = dict(tms.MicrosoundParams().to_dict())
    prog = tms.build_program(tms.MicrosoundParams.from_dict(d))
    cfg = tms.chain_cfg(tms.MicrosoundParams(), prog)
    assert (cfg.mode_id, cfg.shared_stretch, cfg.n_fft, cfg.L) \
        == (0, True, 1500, 2048)


# ---------------------------------------------------------------- generators

def _events(mode, **kw):
    """A JAX program's first chunk for ``mode`` as (JAX device dict, port
    tensor dict, JAX cfg, port cfg)."""
    pj, pt = _params(gen_mode=mode, **dict(MODE_KW[mode], **kw))
    prog = jms.build_program(pj, **_inputs(mode))
    ec = prog["E"]
    jcfg = jms.chain_cfg(pj, prog, ec)
    tcfg = tms.chain_cfg(pt, prog)
    (chunk,) = tms._chunk_events(prog, ec)
    jev = {k: jnp.asarray(v) for k, v in chunk.items() if k != "oa_start"}
    tev = tms.program_to_device(chunk, "cpu")
    return jev, tev, jcfg, tcfg


@pytest.mark.parametrize("mode", list(MODE_KW))
def test_generate_each_mode_matches_jax(mode):
    jev, tev, jcfg, tcfg = _events(mode)
    want = np.asarray(jax.jit(jax.vmap(
        lambda e: jms._generate(e, jcfg)))(jev))
    got = tms._generate(tev, tcfg).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    n = tev["n"].numpy()
    assert all(np.all(got[e, n[e]:] == 0.0) for e in range(len(n)))
    assert np.max(np.abs(want)) > 0
    assert _dev_db(want, got) <= TOL_DB, mode


def test_gen_basic_default_noise_mode():
    """gen_basic's default branch (no GEN_MODES entry reaches it)."""
    L, n = 256, np.array([200, 256, 17], np.int32)
    seeds = np.array([3, 4, 5], np.int32)
    inv = np.full(3, np.float32(1.0) / np.float32(16000.0))
    want = np.asarray(jax.vmap(lambda nn, s: j_gen.gen_basic(
        jnp.arange(L), nn, s, 16000.0, inv[0], 4.0, 5, jnp.zeros(1, jnp.int32),
        jnp.zeros(1, jnp.float32), jnp.int32(0), jnp.int32(8), -3.0, 4200.0,
        12.0))(jnp.asarray(n), jnp.asarray(seeds)))
    got = generators.gen_basic(torch.arange(L), torch.tensor(n),
                               torch.tensor(seeds), torch.tensor(inv), 4.0, 5,
                               -3.0, L).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("klen", [8, 15, 48, 64])
def test_masked_conv_same_and_kernels(klen):
    rng = np.random.default_rng(klen)
    E, L = 4, 300
    x = rng.standard_normal((E, L)).astype(np.float32)
    K = 64
    kl = np.array([klen, max(8, klen // 2), 8, klen], np.int32)
    jk = jax.vmap(lambda k: j_gen.exp_kernel_t(K, k, 6.0))(jnp.asarray(kl))
    tk = generators.exp_kernel_t(K, torch.tensor(kl), 6.0)
    assert _dev_db(np.asarray(jk), tk.numpy()) <= TOL_DB
    want = np.asarray(jax.vmap(lambda r, k, n: j_gen.masked_conv_same(r, k, n))(
        jnp.asarray(x), jk, jnp.asarray(kl)))
    got = generators.masked_conv_same(torch.tensor(x), tk, torch.tensor(kl))
    assert _dev_db(want, got.numpy()) <= TOL_DB
    # a static kernel and length, as crackle and micro-chaos use them
    ek = j_gen.exp_kernel(klen, 5.0)
    np.testing.assert_array_equal(generators.exp_kernel(klen, 5.0), ek)
    want = np.asarray(jax.vmap(lambda r: j_gen.masked_conv_same(
        r, jnp.asarray(ek), klen))(jnp.asarray(x)))
    got = generators.masked_conv_same(torch.tensor(x), ek, klen).numpy()
    assert _dev_db(want, got) <= TOL_DB


def test_hann_and_normalize_masked():
    L = 128
    n = np.array([1, 2, 100, 128], np.int32)
    i = np.arange(L, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda nn: j_gen.hann_t(jnp.asarray(i), nn))(
        jnp.asarray(n)))
    got = generators.hann_t(torch.arange(L), torch.tensor(n)[:, None])
    assert _dev_db(want, got.numpy()) <= TOL_DB
    x = np.random.default_rng(2).standard_normal((4, L)).astype(np.float32)
    x[0] = 0.0                                     # silence stays silent
    mask = i[None, :] < n[:, None]
    want = np.asarray(jax.vmap(lambda r, m: j_space.normalize_masked(
        r, m, 0.9))(jnp.asarray(x), jnp.asarray(mask)))
    got = space.normalize_masked(torch.tensor(x), torch.tensor(mask), 0.9)
    assert np.all(got.numpy()[0] == 0.0)
    # XLA's f32 divide may differ from IEEE division by an ulp
    assert _dev_db(want, got.numpy()) <= TOL_DB


def test_resonator_bank_matches_jax():
    mode = "Gaussian click"
    pj, pt = _params(gen_mode=mode, res_bank_on=True, res_modes=8,
                     res_fmin=100.0, res_fmax=2500.0, micro_ms=10.0)
    prog = jms.build_program(pj)
    L = prog["L"]
    x = np.random.default_rng(7).standard_normal((prog["E"], L)) \
        .astype(np.float32)
    i = jnp.arange(L, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda xx, n, inv, f, ph: j_gen.resonator_bank(
            xx, i, n, inv, f, ph, 20.0, 8)))(
        jnp.asarray(x), prog["n"], prog["inv_gen_sr"], prog["res_f"],
        prog["res_ph"]))
    got = generators.resonator_bank(
        torch.tensor(x), torch.arange(L), torch.tensor(prog["n"]),
        torch.tensor(prog["inv_gen_sr"]), torch.tensor(prog["res_f"]),
        torch.tensor(prog["res_ph"]), 20.0, 8).numpy()
    assert _dev_db(want, got) <= TOL_DB


# ---------------------------------------------------------------- scans

def _chaos_raw_jax(gates, y0, r, gate):
    """The micro-chaos scan of generators.py:223-229, jitted."""
    def step(y, u):
        y2 = r * y * (jnp.float32(1.0) - y)
        v = y2 - jnp.float32(0.5)
        return y2, jnp.where(u < gate, v, 0.0)

    return jax.jit(jax.vmap(lambda g, y: jax.lax.scan(step, y, g)[1]))(
        gates, y0)


def _stick_slip_raw_jax(bn, on, threshold, build, decay, noise_amt):
    """The stick-slip scan of generators.py:194-208, jitted."""
    def step(carry, inp):
        sticking, force = carry
        b, o = inp
        force_stick = force + build * (b * noise_amt + jnp.float32(0.2))
        new_sticking_s = jnp.abs(force_stick) <= threshold
        out_slip = force + jnp.float32(0.25) * o
        force_slip = force * decay
        back = jnp.abs(force_slip) < jnp.float32(0.02)
        force_slip = jnp.where(back, 0.0, force_slip)
        out = jnp.where(sticking, 0.0, out_slip)
        return ((jnp.where(sticking, new_sticking_s, back),
                 jnp.where(sticking, force_stick, force_slip)), out)

    return jax.jit(jax.vmap(lambda b, o: jax.lax.scan(
        step, (jnp.bool_(True), jnp.float32(0.0)), (b, o))[1]))(bn, on)


def _stick_slip_np(bn, on, threshold, build, decay, noise_amt):
    """The stick-slip loop stepped as oracles/microsound_ref.py steps it,
    each op rounded once to f32."""
    f = np.float32
    thr, build, decay, nz = f(threshold), f(build), f(decay), f(noise_amt)
    xs = np.zeros(bn.shape, np.float32)
    for e in range(bn.shape[0]):
        sticking, force = True, f(0.0)
        for t in range(bn.shape[1]):
            if sticking:
                force = f(force + f(build * f(f(bn[e, t] * nz) + f(0.2))))
                sticking = bool(abs(force) <= thr)
            else:
                xs[e, t] = f(force + f(f(0.25) * on[e, t]))
                force = f(force * decay)
                if abs(force) < f(0.02):
                    sticking, force = True, f(0.0)
    return xs


def test_micro_chaos_scan_bit_equal_to_jax():
    """Factory settings: r 3.92, gate 0.35, L 2 048, the factory seeds."""
    seeds = np.arange(12345, 12345 + 24, dtype=np.int32)
    L = 2048
    gates = np.asarray(j_noise.uniform(jnp.asarray(seeds)[:, None],
                                       jnp.arange(L), j_gen.STREAM_GATE))
    y0 = (seeds % 10000).astype(np.float32) * np.float32(1.0 / 10000.0)
    want = np.asarray(_chaos_raw_jax(jnp.asarray(gates), jnp.asarray(y0),
                                     jnp.float32(3.92), jnp.float32(0.35)))
    tg = noise.uniform(torch.tensor(seeds)[:, None], torch.arange(L),
                       generators.STREAM_GATE)
    np.testing.assert_array_equal(tg.numpy(), gates)
    ty0 = generators.chaos_y0(torch.tensor(seeds))
    np.testing.assert_array_equal(ty0.numpy(), y0)
    got = generators.chaos_scan(tg, ty0, 3.92, 0.35).numpy()
    assert np.count_nonzero(want) > L            # the gate opens
    np.testing.assert_array_equal(got, want)


def test_stick_slip_scan():
    """Factory settings (threshold 0.9, build 0.06, decay 0.75, noise 0.08;
    L 2 048, seed 12345 and its neighbours): bit-equal to the once-rounded
    f32 loop; jitted JAX differs from it only by XLA's contractions, each
    sample within one f32 rounding step of the force (43 of seed 12345's
    2 048 samples differ, by at most 2**-22)."""
    seeds = np.arange(12345, 12345 + 6, dtype=np.int32)
    L = 2048
    i = torch.arange(L)
    bn = noise.normal(torch.tensor(seeds)[:, None], i, generators.STREAM_BUILD)
    on = noise.normal(torch.tensor(seeds)[:, None], i, generators.STREAM_OUT)
    args = (0.9, 0.06, 0.75, 0.08)
    got = generators.stick_slip_scan_plain(bn, on, *args).numpy()
    want = _stick_slip_np(bn.numpy(), on.numpy(), *args)
    assert np.all(np.count_nonzero(want, axis=1) > L // 8)   # it slips
    np.testing.assert_array_equal(got, want)
    jx = np.asarray(_stick_slip_raw_jax(
        jnp.asarray(bn.numpy()), jnp.asarray(on.numpy()),
        *(jnp.float32(a) for a in args)))
    # one rounding step of the friction force, which stays below 2: the
    # output force + 0.25 * on carries the force's last bit
    assert np.max(np.abs(jx - got)) <= 2.0 ** -22
    differ = np.count_nonzero(jx != got, axis=1)
    assert np.all(differ < L // 20), differ      # seed 12345: 43 of 2 048


@pytest.mark.parametrize("unfold,micro_ms,dmax_ms", [
    (2.0, 12.0, 2.0), (2.0, 12.0, 8.0), (100.0, 0.25, 8.0)])
def test_waveguide_matches_jax(unfold, micro_ms, dmax_ms):
    """Delays below and around the grain length, and (at x100 unfold, as
    at the factory settings) every delay past it: the ring never wraps and
    reads only zeros, and the literal (1 - mix) * y + mix * v still
    holds."""
    pj, _ = _params(gen_mode="Micro-chaos", wg_on=True, wg_lines=4,
                    wg_max_ms=dmax_ms, micro_ms=micro_ms, time_unfold=unfold)
    prog = jms.build_program(pj)
    L = prog["L"]
    if unfold == 100.0:
        assert prog["wg_d"].min() > L
    x = np.random.default_rng(8).standard_normal((prog["E"], L)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda xx, n, d, g, m: j_gen.waveguide_splinters(
            xx, n, d, g, m, 4, prog["wg_dmax"])))(
        jnp.asarray(x), prog["n"], prog["wg_d"], prog["wg_g"], prog["wg_m"]))
    got = generators.waveguide_splinters(
        torch.tensor(x), torch.tensor(prog["n"]), torch.tensor(prog["wg_d"]),
        torch.tensor(prog["wg_g"]), torch.tensor(prog["wg_m"]), 4,
        prog["wg_dmax"]).numpy()
    assert _dev_db(want, got) <= TOL_DB


# ---------------------------------------------------------------- renders

@pytest.mark.parametrize("mode", list(MODE_KW))
def test_render_each_mode_matches_jax(mode):
    pj, pt = _params(gen_mode=mode, **MODE_KW[mode])
    want, wmeta = jms.render(pj, **_inputs(mode))
    got, meta = tms.render(pt, device="cpu", **_inputs(mode))
    assert meta["events"] == wmeta["events"] > 2
    assert np.max(np.abs(want)) > 0.5
    assert _dbfs(want, got.numpy()) <= TOL_DB, mode


# ---------------------------------------------------------------- scatters

@pytest.mark.parametrize("complex_view", [False, True])
def test_ordered_scatter_add_keeps_the_sequential_order(complex_view):
    """Repeated targets (crackle spikes on one sample, lock spreads on one
    bin) add in index order, as JAX's sequential scatter on the CPU does:
    bit-equal to a Python loop, with sums of three and more terms whose
    order changes the f32 result."""
    rng = np.random.default_rng(21)
    E, M, N = 5, 40, 12
    idx = rng.integers(0, N, (E, M))
    idx[:, :6] = 3                             # a run of six on one target
    val = (rng.standard_normal((E, M) + ((2,) if complex_view else ()))
           * 10.0 ** rng.integers(-4, 4, (E, M) + ((2,) if complex_view
                                                   else ()))) \
        .astype(np.float32)
    drop = N
    idx[:, -3:] = drop                         # dropped entries
    val[:, -3:] = 0.0
    want = np.zeros((E, N + 1) + ((2,) if complex_view else ()), np.float32)
    for e in range(E):
        for m in range(M):
            want[e, idx[e, m]] = want[e, idx[e, m]] + val[e, m]
    ti = torch.tensor(idx)
    rank = ((ti[:, :, None] == ti[:, None, :])
            & torch.ones(M, M, dtype=torch.bool).tril(-1)).sum(-1)
    got = generators.ordered_scatter_add(
        torch.zeros(want.shape), ti, torch.tensor(val), rank,
        int(rank.max()) + 1)
    np.testing.assert_array_equal(got[:, :N].numpy(), want[:, :N])


def test_crackle_passes_bound_the_repeats():
    pj, _ = _params(gen_mode="Crackle / corona", crackle_density=400.0,
                    crackle_alpha=1.1)
    prog = jms.build_program(pj)
    passes = generators.crackle_passes(prog["ck_pos"], prog["n"])
    counts = [np.unique(r[r < n], return_counts=True)[1].max()
              for r, n in zip(prog["ck_pos"], prog["n"])]
    assert passes == max(counts) > 1           # spikes share samples
    i = torch.arange(prog["L"])
    args = (i, torch.tensor(prog["n"]), torch.tensor(prog["ck_pos"]),
            torch.tensor(prog["ck_amp"]), generators.exp_kernel(64, 6.0), 64)
    # one scatter per spike of a row: no rank is left out
    np.testing.assert_array_equal(
        generators.gen_crackle(*args, passes=passes).numpy(),
        generators.gen_crackle(*args, passes=prog["ck_pos"].shape[1])
        .numpy())

"""The multi-device dry run — port of ``dryrun_multichip`` and its engine
checks in ``__graft_entry__.py``.

``dryrun_multichip(n, devices)`` builds n-device meshes and runs one
sharded render per engine through the port's own engine code, each held
against the same render on one device, at the JAX file's sizes and
thresholds:

- microsound: a (dp, ev) mesh, render jobs over "dp", each job's event
  chunks over "ev" through ``chunk_body`` (so through the overlap-add
  kernel on the card), a ``psum`` mixdown; <= -100 dBFS;
- tape: a dp batch of table programs through
  ``varispeed.tape_device_render`` (the ``lerp_read`` kernel); <= -120;
- scrub: a dp batch of gesture programs through
  ``scrub.scrub_render_kernel`` (the ``scrub_read`` kernel); <= -120;
- patternlab: a note-sharded FM voice bank, each shard's notes
  overlap-added, a ``psum`` mix over "ev"; <= -100;
- grid: track-sharded placement reads (``grid._track_positions`` and the
  pattern gather) with a ``psum`` mixdown; <= -120;
- timeline: ``parallel.timeline.sharded_fir_conv`` against the
  single-device convolution, relative <= 1e-5;
- forest fire: ``parallel.ca.simulate_sharded`` bit-exact against the
  dense engine.

A shard's body runs once a mesh position, on that position's device; one
device may fill several positions (``devices=["cpu"] * 8``, or
``[cuda:0] * 4`` on one card).
"""
from __future__ import annotations

import numpy as np
import torch

from .batch import make_mesh, psum


def _dbfs(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    peak = max(1e-12, float(np.max(np.abs(want))))
    e = float(np.max(np.abs(got - want)))
    return -200.0 if e == 0.0 else 20.0 * np.log10(e / peak)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check_microsound(n: int, devices=None) -> str:
    """(dp, ev) mesh: jobs over dp, each job's event chunks over ev with a
    psum mixdown of the overlap-add buffers: the real grain chain."""
    from ..models import microsound as ms
    from ..ops import overlap_add as oa

    mesh = make_mesh(n, axis_names=("dp", "ev"), devices=devices)
    dp, ev = mesh.devices.shape
    p = ms.MicrosoundParams.from_dict(dict(
        base_sr=16000, out_dur_s=0.5, time_unfold=4.0, micro_ms=2.0,
        gen_mode="Noise burst", event_process="Poisson",
        grains_per_sec=float(ev * 16), max_grains=ev * 8,
        bandlimit_on=True, bandlimit_out_hz=6000.0,
        bp_density="", bp_unfold="", bp_cutoff="", bp_stretch="", seed=7))
    prog = ms.build_program(p)
    E = int(prog["E"])
    cfg = ms.chain_cfg(p, prog)
    chunks = ms._chunk_events(prog, max(1, -(-E // ev)))
    while len(chunks) < ev:                  # amp-0 padding chunks
        pad = {k: np.array(v) for k, v in chunks[-1].items()}
        pad["amp"] = np.zeros_like(pad["amp"])
        chunks.append(pad)
    chunks = chunks[:ev]
    gains = (1.0 + 0.25 * np.arange(dp)).astype(np.float32)  # per job
    out_len = oa.ring_out_len(int(prog["out_n"]), int(prog["L"]))

    def chunk(b, c, device):
        ch = dict(chunks[c], amp=chunks[c]["amp"] * gains[b])
        return ms.program_to_device(ch, device)

    def body(b, c, device):
        out = torch.zeros(out_len, dtype=torch.float32, device=device)
        ms.chunk_body(cfg, chunk(b, c, device), out)
        return out

    got = np.stack([_host(psum([body(b, c, mesh.devices[b, c])
                                for c in range(ev)])[0])
                    for b in range(dp)])
    dev0 = mesh.devices[0, 0]
    want = np.zeros((dp, out_len), np.float32)
    for b in range(dp):
        out = torch.zeros(out_len, dtype=torch.float32, device=dev0)
        for c in range(ev):
            ms.chunk_body(cfg, chunk(b, c, dev0), out)
        want[b] = _host(out)
    d = _dbfs(got, want)
    if not (np.isfinite(got).all() and np.max(np.abs(got)) > 0):
        raise AssertionError("microsound dp x ev mixdown is silent or "
                             "not finite")
    if d > -100.0:
        raise AssertionError(f"microsound dp x ev mixdown {d:.1f} dBFS")
    return f"ok ({dp}x{ev} dp*ev, psum mixdown, {d:.1f} dBFS)"


def _check_tape(n: int, devices=None) -> str:
    """dp batch of tape table programs through the device render."""
    from ..models import tape as tp

    mesh = make_mesh(n, axis_names=("dp",), devices=devices)
    devs = mesh.axis_devices("dp")
    sr, T = 8000, 4096
    rng = np.random.default_rng(5)
    audio = (0.5 * np.sin(2 * np.pi * 220 * np.arange(6000) / sr)
             + 0.05 * rng.standard_normal(6000)).astype(np.float32)

    def one(b, device):
        params = tp.TapeParams(
            sample_rate=sr, markers=[2500],
            section_speeds=[1.0 + 0.1 * b, 0.75],
            section_reverse=[False, True], tape_age=40 + b)
        prog = tp.build_tape_program(audio, params, T, device=device)
        out, _ = tp.tape_table_render(prog, device_out=True)
        return out

    got = np.stack([_host(one(b, d)) for b, d in enumerate(devs)])
    want = np.stack([_host(one(b, devs[0])) for b in range(len(devs))])
    d = _dbfs(got, want)
    if not np.max(np.abs(got)) > 0:
        raise AssertionError("tape dp batch is silent")
    if d > -120.0:
        raise AssertionError(f"tape dp batch {d:.1f} dBFS")
    return f"ok ({len(devs)} jobs dp, tape_device_render, {d:.1f} dBFS)"


def _check_scrub(n: int, devices=None) -> str:
    """dp batch of gesture programs through the scrub render."""
    from ..models import scrub

    mesh = make_mesh(n, axis_names=("dp",), devices=devices)
    devs = mesh.axis_devices("dp")
    sr, nb, bs = 8000, 4, 1024
    rng = np.random.default_rng(9)
    audio = (0.6 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr)
             + 0.1 * rng.standard_normal(sr)).astype(np.float32)
    progs = [scrub.build_scrub_program(
        audio, scrub.ScrubConfig(sample_rate=sr, seed=100 + b,
                                 block_size=bs),
        scrub.constant_trace(nb, base_speed=0.3 + 0.1 * b),
        tape_pos0=500.0 * b) for b in range(len(devs))]
    span = max(scrub.span_bound_blocks(p["base_inc_q"], p["js_q"])
               for p in progs)
    span = 1 << (span - 1).bit_length()

    def one(prog, device):
        seg = prog["head_segments"][0]
        return scrub.scrub_render_kernel(
            audio, prog["base_inc_q"], prog["js_q"], prog["seed"],
            prog["mod_consts"], prog["jump_flags"], prog["seg_bases_whole"],
            prog["seg_bases_frac"], prog["env_blocks"], seg["off_whole"],
            seg["off_frac"], seg["gain"], bs, span, device=device)

    got = np.stack([_host(one(p, d)) for p, d in zip(progs, devs)])
    want = np.stack([_host(one(p, devs[0])) for p in progs])
    d = _dbfs(got, want)
    if not np.max(np.abs(got)) > 0:
        raise AssertionError("scrub dp batch is silent")
    if d > -120.0:
        raise AssertionError(f"scrub dp batch {d:.1f} dBFS")
    return f"ok ({len(devs)} jobs dp, scrub render, {d:.1f} dBFS)"


def _check_patternlab(n: int, devices=None) -> str:
    """Note-sharded FM voice bank: jobs over dp, notes over ev, psum mix."""
    from ..models import patternlab as pl
    from ..ops import overlap_add as oa
    from ..ops import synth as synth_ops

    mesh = make_mesh(n, axis_names=("dp", "ev"), devices=devices)
    dp, ev = mesh.devices.shape
    B, E = dp * 2, ev * 4
    sr, T, L = 8000, 2048, 256
    synth = pl.MegaDriveInspiredSynth(sr, seed=3, device="cpu")
    tab = synth._fm_tab
    rng = np.random.default_rng(0)
    chans = rng.integers(0, 6, size=(B, E))
    midis = (48 + rng.integers(0, 24, size=(B, E))).astype(np.float64)
    f_ops = np.stack([pl.fm_op_freqs(tab, chans[b], midis[b])
                      for b in range(B)]).astype(np.float32)   # [B, E, 4]
    # per-note channel params: [B, E, 4] per op, [B, E, 1] per channel
    cp = {k: (v[chans] if v.ndim == 2 else v[chans][..., None])
          for k, v in tab.items() if not k.startswith("_")}
    ns = np.full((B, E), L - 32, np.int32)
    vels = rng.uniform(0.4, 1.0, size=(B, E)).astype(np.float32)
    starts = rng.integers(0, T - L, size=(B, E)).astype(np.int32)
    inv_dac = float(np.float32(1.0 / float(synth._dac_m1)))
    dac = float(np.float32(synth._dac_m1))

    def notes_buf(b, sl, device):
        """Job b's notes ``sl`` overlap-added into a [T] buffer."""
        def t(x):
            return torch.as_tensor(x[b, sl], device=device)
        i_vec = torch.arange(L, dtype=torch.int32, device=device)
        notes = synth_ops.fm_note(
            i_vec, t(ns)[:, None], t(f_ops), t(vels)[:, None],
            {k: t(v) for k, v in cp.items()}, synth._fade, synth._lp1,
            synth._lp2, dac, inv_dac, sr)
        buf = torch.zeros(T + L, dtype=torch.float32, device=device)
        oa.overlap_add(buf, notes.contiguous(), t(starts))
        return buf[:T]

    def master(mix):
        return torch.tanh(mix) * float(np.float32(0.9))

    el = E // ev
    got = []
    for r in range(dp):                       # each dp row: B / dp jobs
        for b in range(r * (B // dp), (r + 1) * (B // dp)):
            parts = [notes_buf(b, slice(c * el, (c + 1) * el),
                               mesh.devices[r, c]) for c in range(ev)]
            got.append(_host(master(psum(parts)[0])))
    got = np.stack(got)
    dev0 = mesh.devices[0, 0]
    want = np.stack([_host(master(notes_buf(b, slice(None), dev0)))
                     for b in range(B)])
    if got.shape != (B, T) or not np.isfinite(got).all():
        raise AssertionError(f"patternlab mix {got.shape}, not finite")
    if not np.max(np.abs(got)) > 0.0:
        raise AssertionError("silent patternlab mix")
    d = _dbfs(got, want)
    if d > -100.0:
        raise AssertionError(f"patternlab note-sharded mix {d:.1f} dBFS")
    return f"ok ({B} jobs x {E} notes on {dp}x{ev}, psum mix, {d:.1f} dBFS)"


def _check_grid(n: int, devices=None) -> str:
    """Track-sharded grid placement: each shard places its tracks with the
    real position kernel and gather, psum mixdown vs the sequential
    sum."""
    from ..models.grid import _track_positions, _TrackMeta
    from ..ops import fixq

    mesh = make_mesh(n, axis_names=("tr",), devices=devices)
    devs = mesh.axis_devices("tr")
    per = 2
    n_tracks = len(devs) * per
    n_pad, pat_n = 4096, 512
    rng = np.random.default_rng(4)
    pats = (rng.standard_normal((n_tracks, pat_n)).astype(np.float32)
            * np.linspace(0.1, 0.5, n_tracks, dtype=np.float32)[:, None])
    tm = _TrackMeta(pat_n=pat_n, base=0, start_idx=0, loop=True,
                    mod_src=-1, win=0, a_q12=0, gain=1.0)

    def place(t, device):
        i = torch.arange(n_pad, dtype=torch.int32, device=device)
        inc = torch.full((n_pad,), fixq.POS_ONE, dtype=torch.int32,
                         device=device)
        reset = torch.zeros(n_pad, dtype=torch.bool, device=device)
        idx, valid = _track_positions(i, inc, reset, tm, n_pad)
        pat = torch.as_tensor(pats[t], device=device)
        return torch.where(valid, pat[idx], 0.0)

    def shard(s, device):
        mix = torch.zeros(n_pad, dtype=torch.float32, device=device)
        for k in range(per):
            mix = mix + place(s * per + k, device)
        return mix

    got = _host(psum([shard(s, d) for s, d in enumerate(devs)])[0])
    want = torch.zeros(n_pad, dtype=torch.float32, device=devs[0])
    for t in range(n_tracks):
        want = want + place(t, devs[0])
    want = _host(want)
    d = _dbfs(got, want)
    if not np.max(np.abs(got)) > 0:
        raise AssertionError("grid track psum is silent")
    if d > -120.0:
        raise AssertionError(f"grid track psum {d:.1f} dBFS")
    return (f"ok ({n_tracks} tracks over {len(devs)} shards, psum mixdown, "
            f"{d:.1f} dBFS)")


def _check_timeline(n: int, devices=None) -> str:
    """FIR convolution over a time-split signal with ppermute halos, vs
    the single-device convolution."""
    from . import timeline as tl

    mesh = make_mesh(n, axis_names=("dp",), devices=devices)
    rng = np.random.default_rng(2)
    xsig = rng.standard_normal(n * 512).astype(np.float32)
    kern = np.exp(-np.arange(700, dtype=np.float32) / 90.0)
    got = _host(tl.sharded_fir_conv(xsig, kern, mesh))
    want = _host(tl.sharded_conv_reference(
        xsig, kern, device=mesh.axis_devices("dp")[0]))
    rel = float(np.max(np.abs(got - want))) / max(
        1e-9, float(np.max(np.abs(want))))
    if rel >= 1e-5:
        raise AssertionError(f"timeline conv off by {rel:.3g} relative")
    return f"ok (ppermute halo conv on {n} devices, {rel:.3g} relative)"


def _check_ca(n: int, devices=None) -> str:
    """The row-sharded Forest Fire CA bit-exact against the dense engine."""
    from ..models import forestfire as ff
    from . import ca

    mesh = make_mesh(n, axis_names=("sp",), devices=devices)
    dev0 = mesh.axis_devices("sp")[0]
    pf = ff.ModelParams(h=16 * n, w=64, ember_rate=0.3)
    carry0 = ff.init_state(pf, seed=3)
    carry0["state"][4:12, 20:44] = ff.FIRE      # seed a fire band
    carry_sh, stats_sh = ca.simulate_sharded(pf, carry0, 6, mesh, seed=3)
    model = ff.ForestFireModel(pf, seed=3, device=dev0)
    model._state = {k: np.array(v) for k, v in carry0.items()}
    stats_dense = model.simulate(6)
    if not np.array_equal(stats_dense, stats_sh):
        raise AssertionError("sharded CA stats diverged from the dense "
                             "engine")
    for k in ("state", "fuel", "moisture", "age"):
        if not np.array_equal(model._np[k], _host(carry_sh[k])):
            raise AssertionError(f"sharded CA field {k} diverged from the "
                                 "dense engine")
    return f"ok (row-sharded, bit-exact vs dense, ({n},) sp mesh)"


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every engine check on meshes of ``n_devices`` devices: the first
    cards of the host, or of ``devices``.  Raises on the first failed
    check; returns engine -> its note and prints the summary."""
    n = int(n_devices)
    results = {
        "microsound": _check_microsound(n, devices),
        "tape": _check_tape(n, devices),
        "scrub": _check_scrub(n, devices),
        "patternlab": _check_patternlab(n, devices),
        "grid": _check_grid(n, devices),
        "timeline": _check_timeline(n, devices),
        "forestfire_ca": _check_ca(n, devices),
    }
    summary = "; ".join(f"{k}: {v}" for k, v in results.items())
    print(f"dryrun_multichip ok on {n} devices — {summary}")
    return results

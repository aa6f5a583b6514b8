"""The port's copy of ``events/rules.py`` held against the JAX package's:

- ``WatchEngine`` on the same metric streams gives equal LED states and
  equal messages for every ``op`` and ``edge``, with hysteresis and
  cooldown on a fake clock, disabled rules and missing metrics;
- ``encode_message`` is byte-identical for int, float, str and bool
  arguments, ``decode_message`` inverts it, and both reject alike;
- ``OSCSender`` sends to a UDP socket on 127.0.0.1 and stops when disabled;
- the port's CA stats at ``SMALL`` through the port's rules give the JAX
  package's OSC packets, byte for byte.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch

from audio_suite_tpu.events import rules as JR
from audio_suite_tpu.models import forestfire as jff
from audio_suite_torch.events import rules as TR
from audio_suite_torch.models import forestfire as tff

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run(mod, rules_kw, stream, dt):
    clock = FakeClock()
    eng = mod.WatchEngine(now_fn=clock)
    eng.set_rules([mod.ThresholdRule(**kw) for kw in rules_kw])
    rec = mod.OSCRecorder()
    leds = []
    for row in stream:
        clock.t += dt
        leds.append(eng.update(row, rec.send))
    return leds, rec


_OPS = [dict(op=">", threshold=10.0), dict(op="<", threshold=10.0),
        dict(op="band", threshold=20.0, threshold_hi=5.0),
        dict(op="nope", threshold=1.0)]


@pytest.mark.parametrize("edge", ["rising", "falling", "both", "level",
                                  "sideways"])
@pytest.mark.parametrize("op", range(len(_OPS)))
@pytest.mark.parametrize("hyst,cool", [(0.0, 0.0), (2.5, 0.0), (1.0, 0.75)])
def test_watch_engine_matches_jax(edge, op, hyst, cool):
    rng = np.random.default_rng(op * 31 + len(edge))
    xs = np.concatenate([rng.uniform(0, 25, 40), [10.0, 12.5, 7.5, 5.0,
                                                  20.0, 8.0, 12.0]])
    stream = [{"x": float(v), "y": int(v)} for v in xs]
    rules_kw = [dict(_OPS[op], metric_key="x", edge=edge, hysteresis=hyst,
                     cooldown_s=cool, osc_address="/fire/x"),
                dict(_OPS[op], metric_key="y", edge=edge, hysteresis=hyst,
                     cooldown_s=cool, send_value=False,
                     osc_address="/fire/y"),
                dict(metric_key="x", enabled=False),
                dict(metric_key="missing", send_state=False)]
    got_leds, got = _run(TR, rules_kw, stream, 0.3)
    want_leds, want = _run(JR, rules_kw, stream, 0.3)
    assert got_leds == want_leds
    assert got.messages == want.messages
    assert got.packets == want.packets


def test_run_stream_matches_update_loop():
    rows = [{"burning": v} for v in (0, 60, 70, 40, 80, 10, 90)]
    out = []
    for mod in (TR, JR):
        eng = mod.WatchEngine(now_fn=lambda: 0.0)
        eng.set_rules([mod.ThresholdRule(metric_key="burning", op=">",
                                         threshold=50, edge="rising",
                                         cooldown_s=0.0)])
        rec = mod.OSCRecorder()
        eng.run_stream(rows, rec.send)
        out.append(rec.packets)
    assert out[0] == out[1] and len(out[0]) == 3


_ARGS = [(), (1,), (1, 42.0), (0, -3.25), ("ab",), ("abcd", 7), (True,),
         (False, 2.5, "x", -7), (2 ** 31 - 1, -2 ** 31), (1e-40, 3.4e38)]


@pytest.mark.parametrize("args", _ARGS, ids=lambda a: repr(a))
@pytest.mark.parametrize("address", ["/fire/burning_hi", "/a", "/abc",
                                     "/fire/trigger"])
def test_encode_message_byte_identical(address, args):
    got = TR.encode_message(address, *args)
    assert got == JR.encode_message(address, *args)
    assert len(got) % 4 == 0
    addr, dec = TR.decode_message(got)
    assert (addr, dec) == JR.decode_message(got)
    assert addr == address
    want = [int(a) if isinstance(a, bool) else a for a in args]
    assert [type(a) for a in dec] == [float if isinstance(a, float) else
                                      type(a) for a in want]
    for d, w in zip(dec, want):
        assert d == (float(np.float32(w)) if isinstance(w, float) else w)


@pytest.mark.parametrize("bad", [None, 1 + 2j, b"raw", [1]])
def test_encode_message_rejects_alike(bad):
    with pytest.raises(TypeError):
        JR.encode_message("/x", bad)
    with pytest.raises(TypeError):
        TR.encode_message("/x", bad)


def test_osc_udp_roundtrip():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    port = rx.getsockname()[1]
    sender = TR.OSCSender(TR.OSCConfig(host="127.0.0.1", port=9))
    try:
        sender.set_target("127.0.0.1", str(port))
        sender.send("/fire/rain", 1, 3.0)
        data, _ = rx.recvfrom(4096)
        assert data == JR.encode_message("/fire/rain", 1, 3.0)
        assert TR.decode_message(data) == ("/fire/rain", [1, 3.0])
        sender.cfg.enabled = False
        sender.send("/fire/rain", 0, 0.0)         # gated: nothing is sent
        rx.settimeout(0.2)
        with pytest.raises(socket.timeout):
            rx.recvfrom(4096)
    finally:
        sender.close()
        rx.close()
    assert dataclasses.asdict(TR.OSCConfig()) == \
        dataclasses.asdict(JR.OSCConfig())


def test_ca_stats_to_packets_match_jax():
    """The config-5 path at SMALL: the port's CA stats through the port's
    rules give the JAX package's OSC byte stream."""
    kw = dict(w=64, h=48, rain_chance=0.05, lightning_rate=1e-4)
    jm = jff.ForestFireModel(jff.ModelParams(**kw), seed=5)
    jm.ignite_at(32, 24, radius=5)
    tm = tff.ForestFireModel(tff.ModelParams(**kw), seed=5, device="cpu")
    tm.ignite_at(32, 24, radius=5)
    streams = []
    for ff, R, m in ((tff, TR, tm), (jff, JR, jm)):
        rows = ff.stats_rows_to_dicts(m.simulate(60))
        clock = FakeClock()
        eng = R.WatchEngine(now_fn=clock)
        eng.set_rules([
            R.ThresholdRule(metric_key="burning", op=">", threshold=30,
                            edge="rising", cooldown_s=0.0,
                            osc_address="/fire/burning_hi"),
            R.ThresholdRule(metric_key="ignitions", op=">", threshold=8,
                            edge="both", cooldown_s=0.1,
                            osc_address="/fire/ignitions_spike"),
            R.ThresholdRule(metric_key="rain", op=">", threshold=0.5,
                            edge="rising", cooldown_s=0.0,
                            osc_address="/fire/rain"),
        ])
        rec = R.OSCRecorder()
        for row in rows:
            clock.t += 1 / 30.0
            eng.update(row, rec.send)
        streams.append(rec.packets)
    assert len(streams[0]) > 1
    assert streams[0] == streams[1]

"""Threshold rules -> OSC event stream — a copy of
audio_suite_tpu/events/rules.py (host code, standard library only), so the
port imports nothing of the JAX package.

- ThresholdRule / WatchEngine: hysteresis-aware threshold evaluation with
  rising/falling/both/level edge detection and per-rule cooldown
  (watchers.py:5-105).  The clock is injectable so tests are deterministic;
  production uses time.perf_counter like the reference.
- OSC: the OSC 1.0 wire format is implemented directly (encode_message) —
  the byte layout is the Pure Data receiver's contract
  (forest_fire_osc_receiver.pd: messages are `/fire/<name> state value`).
"""
from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass


@dataclass
class ThresholdRule:
    """(watchers.py:5-22)"""
    enabled: bool = True
    metric_key: str = "burning"
    op: str = ">"                   # ">", "<", "band"
    threshold: float = 100.0
    threshold_hi: float = 200.0     # for band
    hysteresis: float = 0.0
    cooldown_s: float = 0.25
    edge: str = "rising"            # "rising", "falling", "both", "level"
    osc_address: str = "/fire/trigger"
    send_value: bool = True
    send_state: bool = True


class RuleState:
    def __init__(self):
        self.active = False
        self.last_send_t = 0.0


class WatchEngine:
    """(watchers.py:29-105)"""

    def __init__(self, now_fn=time.perf_counter):
        self.rules: list[ThresholdRule] = []
        self._states: list[RuleState] = []
        self._now = now_fn

    def set_rules(self, rules: list[ThresholdRule]):
        self.rules = list(rules)
        self._states = [RuleState() for _ in self.rules]

    def _eval_active(self, rule: ThresholdRule, x: float,
                     prev_active: bool) -> bool:
        h = float(rule.hysteresis)
        if rule.op == ">":
            return x > ((rule.threshold - h) if prev_active
                        else (rule.threshold + h))
        if rule.op == "<":
            return x < ((rule.threshold + h) if prev_active
                        else (rule.threshold - h))
        if rule.op == "band":
            lo = min(rule.threshold, rule.threshold_hi)
            hi = max(rule.threshold, rule.threshold_hi)
            if prev_active:
                return (x > (lo - h)) and (x < (hi + h))
            return (x > (lo + h)) and (x < (hi - h))
        return False

    def update(self, stats: dict, osc_send_fn):
        """Evaluate all rules against a stats dict; emits via osc_send_fn;
        returns [(enabled, active)] LED states (watchers.py:58-105)."""
        now = self._now()
        led_states: list[tuple[bool, bool]] = []

        for i, rule in enumerate(self.rules):
            st = self._states[i]
            if not rule.enabled:
                st.active = False
                led_states.append((False, False))
                continue
            if rule.metric_key not in stats:
                st.active = False
                led_states.append((True, False))
                continue

            x = float(stats[rule.metric_key])
            prev = st.active
            st.active = self._eval_active(rule, x, prev)
            changed = st.active != prev

            if rule.edge == "level":
                should_send = st.active
            elif rule.edge == "both":
                should_send = changed
            elif rule.edge == "rising":
                should_send = (not prev) and st.active
            elif rule.edge == "falling":
                should_send = prev and (not st.active)
            else:
                should_send = False

            if should_send and (now - st.last_send_t) >= float(rule.cooldown_s):
                st.last_send_t = now
                payload = []
                if rule.send_state:
                    payload.append(1 if st.active else 0)
                if rule.send_value:
                    payload.append(x)
                osc_send_fn(rule.osc_address, *payload)

            led_states.append((True, bool(st.active)))
        return led_states

    def run_stream(self, stats_rows: list[dict], osc_send_fn):
        """Batch evaluation over a device-produced stats stream (one rules
        pass per sim step) — the offline analog of the 30 Hz tick loop
        (main.py:445-479)."""
        for row in stats_rows:
            self.update(row, osc_send_fn)


# ---------------------------------------------------------------------------
# OSC 1.0 wire format + UDP sender
# ---------------------------------------------------------------------------

def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (4 - len(b) % 4 if len(b) % 4 else 0)


def encode_message(address: str, *args) -> bytes:
    """OSC 1.0 message: padded address, ','+typetags padded, big-endian
    args.  int -> 'i' (int32), float -> 'f' (float32), str -> 's', bool ->
    'i' — matching python-osc's argument mapping so the Pd receiver parses
    identically."""
    out = _pad4(address.encode("ascii") + b"\x00")
    tags = ","
    data = b""
    for a in args:
        if isinstance(a, bool):
            tags += "i"
            data += struct.pack(">i", int(a))
        elif isinstance(a, int):
            tags += "i"
            data += struct.pack(">i", a)
        elif isinstance(a, float):
            tags += "f"
            data += struct.pack(">f", a)
        elif isinstance(a, str):
            tags += "s"
            data += _pad4(a.encode("ascii") + b"\x00")
        else:
            raise TypeError(f"unsupported OSC arg type: {type(a)}")
    return out + _pad4(tags.encode("ascii") + b"\x00") + data


def decode_message(data: bytes):
    """Inverse of encode_message (for tests / golden streams)."""
    end = data.index(b"\x00")
    address = data[:end].decode("ascii")
    off = (end + 4) & ~3
    tend = data.index(b"\x00", off)
    tags = data[off:tend].decode("ascii")
    off = (tend + 4) & ~3
    args = []
    for t in tags[1:]:
        if t == "i":
            args.append(struct.unpack(">i", data[off:off + 4])[0])
            off += 4
        elif t == "f":
            args.append(struct.unpack(">f", data[off:off + 4])[0])
            off += 4
        elif t == "s":
            send = data.index(b"\x00", off)
            args.append(data[off:send].decode("ascii"))
            off = (send + 4) & ~3
    return address, args


@dataclass
class OSCConfig:
    """(osc_out.py:5-9)"""
    host: str = "127.0.0.1"
    port: int = 9000
    enabled: bool = True


class OSCSender:
    """UDP OSC sender (osc_out.py:12-25) on a plain socket."""

    def __init__(self, cfg: OSCConfig):
        self.cfg = cfg
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def set_target(self, host: str, port: int):
        self.cfg.host = host
        self.cfg.port = int(port)

    def send(self, address: str, *args):
        if not self.cfg.enabled:
            return
        self._sock.sendto(encode_message(address, *args),
                          (self.cfg.host, int(self.cfg.port)))

    def close(self):
        self._sock.close()


class OSCRecorder:
    """Capture sink with the same send signature — golden event streams."""

    def __init__(self):
        self.messages: list[tuple[str, tuple]] = []
        self.packets: list[bytes] = []

    def send(self, address: str, *args):
        self.messages.append((address, args))
        self.packets.append(encode_message(address, *args))

"""Event-field schedulers — the port's copy of
audio_suite_tpu/events/schedulers.py (microsound_0.2.1/main_v2.py:507-558).

Single / Poisson (exponential gaps) / Clustered (parent Poisson + Gaussian
children) / Hawkes (self-exciting thinning at dt=2 ms).  Event times are
control-rate host metadata (they drive grain placement and breakpoint
evaluation), so they stay NumPy with the reference's rng(seed+9999) seeding.
"""
from __future__ import annotations

import math

import numpy as np


def generate_event_times(process: str, dur_s: float, rate: float, seed: int,
                         cluster_size: int = 6, cluster_spread_ms: float = 25,
                         hawkes_gain: float = 0.6,
                         hawkes_decay_s: float = 0.25) -> list[float]:
    rng = np.random.default_rng(int(seed) + 9999)
    times: list[float] = []

    if process == "Single":
        return [0.0]
    if rate <= 0:
        return [0.0]

    if process == "Poisson":
        t = 0.0
        while t < dur_s:
            t += rng.exponential(1.0 / rate)
            if t < dur_s:
                times.append(t)
        return times

    if process == "Clustered":
        parents = []
        t = 0.0
        parent_rate = max(0.1, rate / max(1, cluster_size))
        while t < dur_s:
            t += rng.exponential(1.0 / parent_rate)
            if t < dur_s:
                parents.append(t)
        spread = cluster_spread_ms / 1000.0
        for p in parents:
            k = int(max(1, round(rng.uniform(0.6, 1.4) * cluster_size)))
            for _ in range(k):
                tt = p + rng.normal(0.0, spread)
                if 0.0 <= tt < dur_s:
                    times.append(tt)
        times.sort()
        return times

    if process == "Hawkes":
        dt = 0.002
        n = int(math.ceil(dur_s / dt))
        activity = 0.0
        for i in range(n):
            t = i * dt
            activity *= math.exp(-dt / max(1e-6, hawkes_decay_s))
            lam = rate + hawkes_gain * activity * rate
            p = min(0.95, lam * dt)
            if rng.random() < p:
                times.append(t + rng.uniform(0, dt))
                activity += 1.0
        return times

    return times

"""The one traffic generator: request k of a run, from a mix file and the
run's seed.

A mix (``traffic/<name>.json``) is data:

    {"loop": "closed", "clients": 1,
     "fixed": {"seconds": 20.0},                 # the same in every request
     "draw": {"seed": {"int": [1, 2147418112]}}, # drawn per request
     "warmup": 6,                                # requests before the window
     "checked": 3}                               # renders checked

A draw is ``{"int": [lo, hi]}`` (hi excluded), ``{"uniform": [lo, hi]}``
or ``{"choice": [...]}``.  Request k of a stream is drawn from its own
generator seeded by (run seed, stream, k), so it depends on nothing else:
the window's requests are the same in a traced and an untraced run of one
seed, and the warm-up's (another stream) are never among them.
"""
from __future__ import annotations

import numpy as np

STREAMS = {"window": 0, "warmup": 1, "slice": 2, "sample": 3}


def seed_words(seed: int) -> list[int]:
    """Any whole number as non-negative words for ``SeedSequence``."""
    return [int(seed) % (1 << 64)]


class Traffic:
    def __init__(self, mix: dict, seed: int):
        if mix.get("loop", "closed") != "closed" or mix.get("clients", 1) != 1:
            raise NotImplementedError("only a closed loop of one client")
        self.mix = mix
        self.seed = int(seed)
        self.warmup = int(mix.get("warmup", 0))
        self.checked = int(mix.get("checked", 1))

    def rng(self, stream: str, k: int = 0) -> np.random.Generator:
        return np.random.default_rng(seed_words(self.seed)
                                     + [STREAMS[stream], int(k)])

    def request(self, k: int, stream: str = "window") -> dict:
        rng = self.rng(stream, k)
        fields = dict(self.mix.get("fixed", {}))
        for key, how in sorted(self.mix.get("draw", {}).items()):
            if "int" in how:
                lo, hi = how["int"]
                fields[key] = int(rng.integers(lo, hi))
            elif "uniform" in how:
                lo, hi = how["uniform"]
                fields[key] = float(rng.uniform(lo, hi))
            elif "choice" in how:
                fields[key] = how["choice"][int(rng.integers(
                    len(how["choice"])))]
            else:
                raise ValueError(f"unknown draw for {key!r}: {how}")
        return fields


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from the run's seed (Algorithm R)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1

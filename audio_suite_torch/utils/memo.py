"""The engines' memos of what a render builds on the host and uploads."""
from __future__ import annotations

from collections import OrderedDict

from .device import canonical_device


class Memo:
    """At most ``bound`` entries, the least recently used evicted first.

    A key names its device through ``canonical_device``, so "cuda" and
    "cuda:0" are one key; a memo of host work passes no device.  ``pins``
    are objects that a key names by identity: their ids are in the key and
    the entry holds them, so no other object takes one of those ids while
    the entry stands, and a hit requires the same objects."""

    def __init__(self, bound: int):
        self.bound = bound
        self._entries: OrderedDict = OrderedDict()

    def get(self, key, build, *, device=None, pins=()):
        """(value, hit): the value stored under ``key``, the device and
        the pins, or on a miss ``build()``'s, stored there."""
        k = (key, None if device is None else canonical_device(device),
             tuple(map(id, pins)))
        ent = self._entries.pop(k, None)
        hit = ent is not None
        if not hit:
            ent = (tuple(pins), build())
        self._entries[k] = ent
        while len(self._entries) > self.bound:
            self._entries.popitem(last=False)
        return ent[1], hit

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

"""Peer blacklists (reference blacklist.go:12-64).

Two host-side implementations with the reference's surface:
  MapBlacklist       — plain set
  TimeCachedBlacklist — entries expire after a TTL (time injectable for
                        tests, like the reference's timecache)

Enforcement points mirror pubsub.go: RPC ingress (1048-1060) and
connection admission (524-530, 636-639). In the vectorized engine the
enforcement is the `blacklist` mask consumed by the dynamic-peers step
(models/gossipsub.py set_blacklist); these classes are the host-side policy
objects an API user manipulates, and `mask()` lowers them onto the device.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


class MapBlacklist:
    def __init__(self):
        self._set: set[bytes] = set()

    def add(self, peer: bytes) -> bool:
        self._set.add(peer)
        return True

    def contains(self, peer: bytes) -> bool:
        return peer in self._set

    def remove(self, peer: bytes) -> None:
        self._set.discard(peer)


class TimeCachedBlacklist:
    """Blacklist whose entries lapse after `ttl` seconds."""

    def __init__(self, ttl: float, now: Callable[[], float] = time.monotonic):
        self.ttl = ttl
        self._now = now
        self._expiry: dict[bytes, float] = {}

    def add(self, peer: bytes) -> bool:
        self._expiry[peer] = self._now() + self.ttl
        return True

    def contains(self, peer: bytes) -> bool:
        exp = self._expiry.get(peer)
        if exp is None:
            return False
        if self._now() >= exp:
            del self._expiry[peer]
            return False
        return True

    def remove(self, peer: bytes) -> None:
        self._expiry.pop(peer, None)


def blacklist_mask(bl, peer_ids: list[bytes]) -> np.ndarray:
    """[N] bool device-lowerable mask from a host blacklist."""
    return np.array([bl.contains(p) for p in peer_ids], dtype=bool)

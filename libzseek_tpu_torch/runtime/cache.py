"""Decompressed-frame LRU cache.

Copy of libzseek_tpu/runtime/cache.py, but for find()'s `count`.  Parity
with the reference cache (src/cache.c of the reference library):
capacity counted in FRAMES (not bytes), find() promotes to MRU, insert()
evicts the LRU entry at capacity and takes ownership of the data.
Entries are host bytes or, for Reader(device_cache=True), uint8 tensors
on the card; a tensor counts its nbytes.

Like the reference, the cache itself is unlocked; the Reader holds the
lock (src/cache.h:27,36).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any


class FrameCache:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = int(capacity)
        self._map: OrderedDict[int, Any] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    @property
    def entries(self) -> int:
        return len(self._map)

    def find(self, frame_idx: int, count: bool = True):
        """Return cached frame data or None; promotes to MRU on hit.
        Counts a hit or a miss unless count=False: the Reader's own
        lookups (its probes, the look after a wait and the double-checked
        insert) are no caller's request, and each request counts once."""
        v = self._map.get(frame_idx)
        if v is None:
            self.misses += count
            return None
        self._map.move_to_end(frame_idx)
        self.hits += count
        return v

    def insert(self, frame_idx: int, data) -> None:
        """Insert (replacing any same-key entry); evicts LRU at capacity."""
        old = self._map.pop(frame_idx, None)
        if old is not None:
            self._bytes -= self._sizeof(old)
        while len(self._map) >= self.capacity:
            _, evicted = self._map.popitem(last=False)
            self._bytes -= self._sizeof(evicted)
        self._map[frame_idx] = data
        self._bytes += self._sizeof(data)

    @staticmethod
    def _sizeof(v) -> int:
        if hasattr(v, "nbytes"):      # a tensor on the card
            return int(v.nbytes)
        return len(v)

    def memory_usage(self) -> int:
        """Approximate resident bytes (data + index), mirroring
        zseek_cache_memory_usage (src/cache.c:161-170)."""
        return self._bytes + 64 * len(self._map)

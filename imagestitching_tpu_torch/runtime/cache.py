"""Decoded-bitmap LRU cache with a pixel budget.

The port's own copy of ``imagestitching_tpu/runtime/cache.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

Twin of the reference's bitmap cache (pages/index/index.js:534-627): decoded
images cached by file identity, bounded by a total-pixel budget (64 MP iOS /
42 MP Android, index.js:6-7) and an entry cap (6/4, index.js:8-9), LRU-evicted
by last-use.  Here the key includes mtime+size so an overwritten file never
serves stale pixels, and eviction is just dropping the array (no handler
detach / ``bmp.close()`` dance — index.js:577-613 — needed with a real GC).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np


class BitmapCache:
    def __init__(self, max_pixels: int = 64_000_000, max_entries: int = 6):
        self.max_pixels = max_pixels
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, Tuple[np.ndarray, int, float]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def file_key(path: str, extra=None) -> Optional[Tuple]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (os.path.abspath(path), st.st_mtime_ns, st.st_size, extra)

    def get(self, key: Tuple) -> Optional[Tuple[np.ndarray, int]]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            arr, orientation, _ = hit
            self._entries[key] = (arr, orientation, time.monotonic())
            self.hits += 1
            return arr, orientation

    def put(self, key: Tuple, arr: np.ndarray, orientation: int) -> None:
        pixels = arr.shape[0] * arr.shape[1]
        if pixels > self.max_pixels or self.max_entries < 1:
            return                          # too big to ever cache
        with self._lock:
            self._entries[key] = (arr, orientation, time.monotonic())
            self._trim()

    def _trim(self) -> None:
        # LRU first; among equals, largest pixel count goes first
        # (index.js:588-607's eviction order).
        def total():
            return sum(v[0].shape[0] * v[0].shape[1]
                       for v in self._entries.values())
        while (len(self._entries) > self.max_entries
               or total() > self.max_pixels):
            victim = min(
                self._entries.items(),
                key=lambda kv: (kv[1][2],
                                -(kv[1][0].shape[0] * kv[1][0].shape[1])))[0]
            del self._entries[victim]
            self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "pixels": sum(v[0].shape[0] * v[0].shape[1]
                              for v in self._entries.values()),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
            }


_global: Optional[BitmapCache] = None
_global_lock = threading.Lock()


def get_cache(max_pixels: int = 64_000_000,
              max_entries: int = 6) -> BitmapCache:
    global _global
    with _global_lock:
        if _global is None:
            _global = BitmapCache(max_pixels, max_entries)
        return _global


def set_cache(cache: Optional[BitmapCache]) -> None:
    global _global
    with _global_lock:
        _global = cache

"""Crash-safe structured logger: in-memory ring + append-only file.

The port's own copy of ``imagestitching_tpu/runtime/logger.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

TPU-native twin of the reference's dual-sink logger (pages/index/index.js:
76-124): a bounded in-memory ring of ``{ts, tag, payload}`` records (ring size
160, index.js:10) mirrored to persistent storage on every write, plus an
append-only log file truncated when it exceeds a size cap (300 KB,
index.js:89-96) — so the last moments before a crash are always readable.

Here the "storage mirror" is the file itself (fsync-able, survives process
death), the ring serves fast introspection/tests, and records are JSON lines.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

_RING_SIZE = 160                 # index.js:10  LOG_RING_SIZE
_MAX_LOG_BYTES = 300 * 1024      # index.js:89  300KB truncation threshold


class StitchLogger:
    def __init__(self, path: Optional[str] = None,
                 ring_size: int = _RING_SIZE,
                 max_bytes: int = _MAX_LOG_BYTES):
        self._ring: Deque[Dict[str, Any]] = collections.deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._path = path
        self._max_bytes = max_bytes
        # Bounded FIFO, not a bare set: once-keys may carry per-signature
        # suffixes (serve engine demotions), and a long-lived server fed a
        # stream of unique signatures must not grow this without bound.
        # Evicting the oldest key merely re-arms its dedup — acceptable.
        self._onced: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._once_cap = 1024
        if path:
            self._init_file()

    def _init_file(self) -> None:
        # Truncate oversized logs at startup (index.js:85-96): keep the tail.
        try:
            if os.path.exists(self._path) and \
                    os.path.getsize(self._path) > self._max_bytes:
                with open(self._path, "rb") as f:
                    f.seek(-self._max_bytes // 2, os.SEEK_END)
                    tail = f.read()
                with open(self._path, "wb") as f:
                    f.write(tail)
        except OSError:
            self._path = None

    def event(self, tag: str, **payload: Any) -> None:
        rec = {"ts": time.time(), "tag": tag, **payload}
        with self._lock:
            self._ring.append(rec)
            if self._path:
                try:
                    with open(self._path, "a") as f:
                        f.write(json.dumps(rec, default=repr) + "\n")
                except OSError:
                    self._path = None  # degrade to ring-only, never crash

    def once(self, tag: str, **payload: Any) -> bool:
        """Log ``tag`` at most once per logger lifetime; True if it logged.

        The one-shot toast dedup analog (pages/index/index.js:65-73): fallback
        ladders use it so a degradation warning fires once per process, not
        once per image/band.
        """
        with self._lock:
            if tag in self._onced:
                return False
            self._onced[tag] = None
            while len(self._onced) > self._once_cap:
                self._onced.popitem(last=False)
        self.event(tag, **payload)
        return True

    def ring(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._onced.clear()


_global: Optional[StitchLogger] = None
_global_lock = threading.Lock()


def get_logger() -> StitchLogger:
    """Process-wide logger; file sink enabled via IMAGESTITCH_LOG env var."""
    global _global
    with _global_lock:
        if _global is None:
            _global = StitchLogger(os.environ.get("IMAGESTITCH_LOG"))
        return _global


def set_logger(logger: StitchLogger) -> None:
    global _global
    with _global_lock:
        _global = logger

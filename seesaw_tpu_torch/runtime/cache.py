"""Process-wide memoization: share-once initialization with per-key locks.

The part of `seesaw_tpu/runtime/cache.py` the port calls (`LocalCache`,
which the index loader uses to share one loaded index between sessions).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict


class LocalCache:
    def __init__(self):
        self._values: Dict[str, object] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._meta_lock = threading.Lock()

    def _lock_for(self, key: str) -> threading.Lock:
        with self._meta_lock:
            if key not in self._locks:
                self._locks[key] = threading.Lock()
            return self._locks[key]

    def get_or_initialize(self, key: str, init: Callable[[], object]):
        """Initialize once per key, even under concurrent callers."""
        if key in self._values:
            return self._values[key]
        with self._lock_for(key):
            if key not in self._values:
                self._values[key] = init()
        return self._values[key]

    def put(self, key: str, value):
        with self._lock_for(key):
            self._values[key] = value

    def invalidate(self, key: str):
        with self._meta_lock:
            self._values.pop(key, None)

    def invalidate_prefix(self, fragment: str):
        """Drop every key containing ``fragment`` (index rebuilds at the
        same path must not serve the stale cached object)."""
        with self._meta_lock:
            for k in [k for k in self._values if fragment in k]:
                self._values.pop(k, None)

    def clear(self):
        with self._meta_lock:
            self._values.clear()


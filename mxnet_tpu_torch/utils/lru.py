"""Bounded LRU with dispatch counters.

The PyTorch counterpart of ``mxnet_tpu/utils/lru.py``. The JAX package
keeps two executable caches on it (eager dispatch and the fused train
step); the port dispatches each op eagerly and has no dispatch cache, so
its one user is the Trainer's fused step (``gluon/fused_step.py``).
Thread-safe; ``stats()`` is the counter surface the profiler reads.
"""
from __future__ import annotations

from collections import OrderedDict

from . import locks as _locks

__all__ = ["CountedLRUCache"]


class CountedLRUCache:
    def __init__(self, maxsize):
        self.maxsize = maxsize
        self._d = OrderedDict()
        # guards: _d, hits, misses, evictions, bypasses, fallbacks
        self._lock = _locks.RankedLock("utils.lru")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bypasses = 0   # dispatches that could not use the cache
        self.fallbacks = 0  # cached entry failed; caller went eager

    def lookup(self, key):
        with self._lock:
            entry = self._d.get(key)
            if entry is None:
                self.misses += 1
            else:
                self._d.move_to_end(key)
                self.hits += 1
            return entry

    def note_hit(self):
        """Hit served from a caller-side fast path (the full key was
        neither rebuilt nor hashed)."""
        with self._lock:
            self.hits += 1

    def note_bypass(self):
        with self._lock:
            self.bypasses += 1

    def note_fallback(self):
        with self._lock:
            self.fallbacks += 1

    def insert(self, key, entry):
        with self._lock:
            self._d[key] = entry
            self._d.move_to_end(key)
            while len(self._d) > max(1, int(self.maxsize)):
                self._d.popitem(last=False)
                self.evictions += 1

    def remove(self, key):
        with self._lock:
            self._d.pop(key, None)

    def clear(self):
        with self._lock:
            self._d.clear()
            self.hits = self.misses = self.evictions = 0
            self.bypasses = self.fallbacks = 0

    def stats(self):
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "bypasses": self.bypasses,
                    "fallbacks": self.fallbacks}

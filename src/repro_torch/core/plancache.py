"""Thread-safe LRU cache of tuning outcomes, keyed by plan signature.

The same tensor shapes arrive again and again in the heavy-traffic case
(every checkpoint step writes the same parameter geometry). A
:class:`PlanCache` handed to :class:`repro_torch.core.Compressor`
(``Compressor(spec, plan_cache=cache)``) memoizes the tuning outcome, the
``(anchor_stride, splines, schemes)`` step tables plus the orchestrator's
pipeline choice, keyed by :func:`repro_torch.core.autotune.plan_signature`
(shape, dtype, error-bound config, coarse stats bucket), so a recurring
field skips the planner and the orchestrator. One cache may serve many
compressors and threads; every operation takes the lock. ``hits``,
``misses`` and ``evictions`` count what happened. The same class as the JAX
package's ``repro.core.plancache.PlanCache``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class PlanCache:
    """Bounded LRU mapping plan signatures to tuning outcomes (a few hundred
    bytes each; the bound guards against signature churn)."""

    def __init__(self, max_entries: int = 256):
        if int(max_entries) < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        """Entry for ``key`` (refreshing its LRU position) or ``None``; counts
        a hit or a miss (:meth:`peek` counts nothing)."""
        with self._lock:
            try:
                value = self._entries[key]
            except KeyError:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def peek(self, key):
        """Like :meth:`get` but without touching LRU order or counters."""
        with self._lock:
            return self._entries.get(key)

    def keys(self) -> list:
        """Current keys, least recently used first."""
        with self._lock:
            return list(self._entries.keys())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> dict:
        with self._lock:
            looked = self.hits + self.misses
            return {"entries": len(self._entries), "max_entries": self.max_entries, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": (self.hits / looked) if looked else 0.0}

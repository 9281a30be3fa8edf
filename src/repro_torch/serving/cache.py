"""Version-keyed answer caches with exact slide invalidation.

The streaming miner stamps every completed slide with a monotonically
increasing ``window_version`` (DESIGN.md §11).  Cached answers (sorted top-k
candidate lists, confidence-ranked rule lists) are stored under
``(query key, version)``: repeated queries between slides return the *same
object* at zero recompute cost, and a slide invalidates **exactly** the
entries built against older windows — entries stamped with the new version
(e.g. a re-mine without a window change) survive untouched.

The data-structure-sensitivity lesson of arXiv:1908.01338 applied to the
query surface: making the cache key (the version) first-class, instead of
clearing a dict on every ingest, is what lets hit/miss/stale accounting be
exact and lets concurrent readers keep hitting a still-valid snapshot while
the writer advances.

Thread-safe; counters are exposed via :meth:`stats` and feed the serving
benchmark's cache-hit-rate column.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, Optional, Tuple

__all__ = ["VersionedCache"]


class VersionedCache:
    """``key -> (version, value)`` with eager cross-version eviction."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Tuple[int, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.stale = 0          # lookups that found an outdated version
        self.stale_evicted = 0  # entries dropped by advance()

    def lookup(self, version: int, key: Hashable):
        """``(found, value)`` — found only on an exact version match.

        A same-key entry from an older window counts (and is evicted) as
        *stale*, not as a plain miss: it measures how much of the cache a
        slide actually invalidated.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return False, None
            ver, value = entry
            if ver == version:
                self.hits += 1
                return True, value
            del self._entries[key]
            self.stale += 1
            return False, None

    def insert(self, version: int, key: Hashable, value: Any) -> None:
        with self._lock:
            self._entries[key] = (int(version), value)

    def advance(self, version: int) -> int:
        """A new window version was published: evict exactly the entries
        keyed to older versions; returns how many were dropped."""
        with self._lock:
            dead = [k for k, (v, _) in self._entries.items() if v != version]
            for k in dead:
                del self._entries[k]
            self.stale_evicted += len(dead)
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses + self.stale
            return {
                "hits": self.hits,
                "misses": self.misses,
                "stale": self.stale,
                "stale_evicted": self.stale_evicted,
                "entries": len(self._entries),
                "hit_rate": self.hits / lookups if lookups else 0.0,
            }

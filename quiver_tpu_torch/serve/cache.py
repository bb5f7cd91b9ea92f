"""Params-versioned embedding cache of the serve engine — the port of
``quiver_tpu/serve/cache.py`` (host only).

Entries are keyed by node id and stamped with the ``params_version`` that
computed them; a lookup at another version is a miss and drops the entry,
and the engine invalidates the whole cache at every weight update, so a
served row may be cache-aged but never crosses a version boundary. The
graph-version floors of the JAX cache belong to streaming graphs, which
this slice does not port.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np

from ..trace import HitRateCounter


class EmbeddingCache:
    """LRU of computed logits keyed by ``(node_id, params_version)``; one
    entry per node; ``capacity`` counts rows (0 disables caching)."""

    def __init__(self, capacity: int, counters: Optional[HitRateCounter] = None):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self.counters = counters if counters is not None else HitRateCounter()
        self.invalidations = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, node_id: Hashable, version: int) -> Optional[np.ndarray]:
        """Value at exactly ``version``, else None. A hit refreshes LRU
        recency; a stale entry counts as a miss and an eviction."""
        with self._lock:
            ent = self._entries.get(node_id)
            if ent is None:
                self.counters.miss()
                return None
            if ent[0] != version:
                del self._entries[node_id]
                self.counters.evict()
                self.counters.miss()
                return None
            self._entries.move_to_end(node_id)
            self.counters.hit()
            return ent[1]

    def get_many(self, node_ids, version: int) -> list:
        """Batch `get`: outcomes and LRU touches of N gets in order, one
        lock hold, counters moved in bulk."""
        out = [None] * len(node_ids)
        hits = misses = evictions = 0
        with self._lock:
            d = self._entries
            if not d:
                self.counters.miss(len(node_ids))
                return out
            for ix, node_id in enumerate(node_ids):
                ent = d.get(node_id)
                if ent is None:
                    misses += 1
                    continue
                if ent[0] != version:
                    del d[node_id]
                    evictions += 1
                    misses += 1
                    continue
                d.move_to_end(node_id)
                hits += 1
                out[ix] = ent[1]
        if hits:
            self.counters.hit(hits)
        if misses:
            self.counters.miss(misses)
        if evictions:
            self.counters.evict(evictions)
        return out

    def put(self, node_id: Hashable, version: int, value: np.ndarray) -> None:
        self.put_many([node_id], version, [value])

    def put_many(self, node_ids, version: int, values) -> None:
        """Batch insert: N puts in order (LRU placement and evictions
        included) under one lock hold."""
        if self.capacity == 0 or not len(node_ids):
            return
        version = int(version)
        evictions = 0
        with self._lock:
            d = self._entries
            for k, v in zip(node_ids, values):
                if k in d:
                    del d[k]
                d[k] = (version, v)
                while len(d) > self.capacity:
                    d.popitem(last=False)
                    evictions += 1
        if evictions:
            self.counters.evict(evictions)

    def invalidate(self) -> int:
        """Drop every entry; returns how many were dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.invalidations += 1
            return n

"""Params-versioned embedding cache of the serve engine — the port of
``quiver_tpu/serve/cache.py`` (host only).

Entries are keyed by node id (or a temporal engine's ``(node, t_bucket)``
key) and stamped with the ``params_version`` that computed them; a lookup
at another version is a miss and drops the entry, and the engine
invalidates the whole cache at every weight update, so a served row may be
cache-aged but never crosses a version boundary.

Over a streaming graph an entry also carries the graph version its flush
sealed against. A commit drops the entries of every node whose sample can
reach a changed row (`invalidate_nodes`, by node whatever the key's
shape), or, in the engine's zero-stall commits, raises those nodes'
graph-version floors (`raise_floor`): resident entries below a floor drop
at once, and a late writeback below it (a flush sealed before the commit
and resolving after it) is refused.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, Optional, Set

import numpy as np

from ..trace import HitRateCounter


def _key_node(key: Hashable) -> Hashable:
    """The node of a cache key: a composite key's first element, a plain
    key itself."""
    return key[0] if isinstance(key, tuple) else key


class EmbeddingCache:
    """LRU of computed logits keyed by ``(node_id, params_version)``; one
    entry per key; ``capacity`` counts rows (0 disables caching)."""

    def __init__(self, capacity: int, counters: Optional[HitRateCounter] = None):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self.counters = counters if counters is not None else HitRateCounter()
        self.invalidations = 0
        self._lock = threading.Lock()
        # key -> (params version, value, graph version)
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self._node_index: Dict[Hashable, Set[Hashable]] = {}  # node -> its resident keys
        # node -> graph-version floor, indexed by node id (grown on demand;
        # a commit raises the floors of up to every node at once)
        self._floor = np.zeros(0, np.int64)

    def __len__(self) -> int:
        return len(self._entries)

    def _floor_of(self, key: Hashable) -> int:
        node = _key_node(key)
        return int(self._floor[node]) if 0 <= node < self._floor.shape[0] else 0

    def _index_add(self, key: Hashable) -> None:
        self._node_index.setdefault(_key_node(key), set()).add(key)

    def _index_drop(self, key: Hashable) -> None:
        node = _key_node(key)
        keys = self._node_index.get(node)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._node_index[node]

    def get(self, node_id: Hashable, version: int) -> Optional[np.ndarray]:
        """Value at exactly ``version`` (and at or above its node's graph
        floor), else None. A hit refreshes LRU recency; a stale entry
        counts as a miss and an eviction."""
        return self.get_many([node_id], version)[0]

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
            floors = self._floor.shape[0] > 0
            for ix, node_id in enumerate(node_ids):
                ent = d.get(node_id)
                if ent is None:
                    misses += 1
                    continue
                ver, value, gv = ent
                if ver != version or (floors and gv < self._floor_of(node_id)):
                    del d[node_id]
                    self._index_drop(node_id)
                    evictions += 1
                    misses += 1
                    continue
                d.move_to_end(node_id)
                hits += 1
                out[ix] = value
        if hits:
            self.counters.hit(hits)
        if misses:
            self.counters.miss(misses)
        if evictions:
            self.counters.evict(evictions)
        return out

    def put(self, node_id: Hashable, version: int, value: np.ndarray, gv: int = 0) -> None:
        """Insert at params ``version``, stamped with graph version ``gv``;
        a put below its node's graph floor is dropped."""
        self.put_many([node_id], version, [value], gv=gv)

    def put_many(self, node_ids, version: int, values, gv: int = 0) -> None:
        """Batch insert: N puts in order (LRU placement and evictions
        included) under one lock hold."""
        if self.capacity == 0 or not len(node_ids):
            return
        version = int(version)
        evictions = 0
        with self._lock:
            d = self._entries
            floors = self._floor.shape[0] > 0
            for k, v in zip(node_ids, values):
                if floors and gv < self._floor_of(k):
                    continue  # a writeback from before a commit that touched the node
                if k in d:
                    del d[k]
                else:
                    self._index_add(k)
                d[k] = (version, v, gv)
                while len(d) > self.capacity:
                    ek, _ = d.popitem(last=False)
                    self._index_drop(ek)
                    evictions += 1
        if evictions:
            self.counters.evict(evictions)

    def entry_version(self, node_id: Hashable) -> Optional[int]:
        """The params version of a key's entry, or None (no LRU touch)."""
        with self._lock:
            ent = self._entries.get(node_id)
            return None if ent is None else ent[0]

    def entry_graph_version(self, node_id: Hashable) -> Optional[int]:
        """The graph version of a key's entry, or None (no LRU touch)."""
        with self._lock:
            ent = self._entries.get(node_id)
            return None if ent is None else ent[2]

    def keys(self):
        """Resident keys, coldest first (no LRU touch)."""
        with self._lock:
            return list(self._entries)

    def invalidate(self) -> int:
        """Drop every entry; returns how many were dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._node_index.clear()
            self.invalidations += 1
            return n

    @staticmethod
    def _node_ids(node_ids) -> np.ndarray:
        """The distinct non-negative node ids of ``node_ids`` (an iterable
        or array of ints), sorted."""
        ids = np.sort(np.asarray(node_ids if isinstance(node_ids, np.ndarray)
                                 else list(node_ids), np.int64))
        # a sort and a neighbour test (a commit passes a million sorted ids,
        # which np.unique would hash)
        keep = ids >= 0
        keep[1:] &= ids[1:] != ids[:-1]
        return ids[keep]

    def _resident(self, ids: np.ndarray):
        """The nodes of sorted ``ids`` with resident entries, found from
        whichever side is smaller (caller holds ``_lock``)."""
        if ids.size <= len(self._node_index):
            return [n for n in ids.tolist() if n in self._node_index]
        mark = np.zeros(int(ids[-1]) + 1, bool)
        mark[ids] = True
        return [n for n in self._node_index if 0 <= n < mark.shape[0] and mark[n]]

    def invalidate_nodes(self, node_ids) -> int:
        """Drop every entry of the given nodes, whatever its key's shape (a
        temporal engine's ``(node, t_bucket)`` keys included): a commit's
        invalidation. O(dropped keys, or resident nodes when fewer);
        survivors keep their LRU order. Returns the entries dropped."""
        ids = self._node_ids(node_ids)
        n = 0
        with self._lock:
            for node in self._resident(ids):
                for k in self._node_index.pop(node):
                    del self._entries[k]
                    n += 1
            if n:
                self.invalidations += 1
        return n

    def raise_floor(self, node_ids, floor: int) -> int:
        """Raise each node's graph-version floor to ``floor`` (floors never
        fall) and drop its resident entries below it; later puts below the
        floor are refused. Returns the entries dropped."""
        floor = int(floor)
        ids = self._node_ids(node_ids)
        n = 0
        with self._lock:
            if ids.size:
                if int(ids[-1]) >= self._floor.shape[0]:
                    grown = np.zeros(int(ids[-1]) + 1, np.int64)
                    grown[: self._floor.shape[0]] = self._floor
                    self._floor = grown
                self._floor[ids] = np.maximum(self._floor[ids], floor)
            for node in self._resident(ids):
                keys = self._node_index[node]
                for k in list(keys):
                    if self._entries[k][2] < floor:
                        del self._entries[k]
                        keys.discard(k)
                        n += 1
                if not keys:
                    del self._node_index[node]
            if n:
                self.invalidations += 1
        return n

    def graph_floor(self, node_id: Hashable) -> int:
        """A node's graph-version floor (0 when never raised)."""
        with self._lock:
            return self._floor_of(int(node_id))

    def invalidate_keys(self, node_ids) -> int:
        """Drop the entries of exactly these keys; returns how many."""
        n = 0
        with self._lock:
            for k in node_ids:
                if self._entries.pop(k, None) is not None:
                    self._index_drop(k)
                    n += 1
            if n:
                self.invalidations += 1
        return n

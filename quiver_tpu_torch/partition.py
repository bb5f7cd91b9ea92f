"""Offline probability-driven feature partitioner — the port of
``quiver_tpu/partition.py`` (``partition_feature_without_replication``,
``quiver_partition_feature``, ``load_quiver_feature_partition``).

Host numpy, carried over: walk the touched nodes in descending total
access probability, in chunks; give each chunk's nodes to the partition
whose own probability most exceeds the other partitions' average, with a
tie-break toward the smaller partitions. The probabilities come from
`GraphSageSampler.sample_prob` (one vector per partition's train split).
Artifacts are ``np.savez`` files, as in the JAX package: per partition the
owned ids and its hot cache of remote rows, and a global partition book.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple, Union

import numpy as np

from .utils import parse_size

CHUNK_SIZE = 256

QUIVER_PARTITION_FILE = "partition_res.npz"
QUIVER_CACHE_FILE = "cache_res.npz"
QUIVER_PARTITION_BOOK_FILE = "feature_partition_book.npz"


def partition_feature_without_replication(
        probs: Sequence[np.ndarray], chunk_size: int = CHUNK_SIZE
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Greedy chunked assignment maximising each partition's own-probability
    advantage. ``probs``: one ``[N]`` access-probability vector per
    partition. Returns ``(per-partition id arrays, partition_book [N])``;
    the id arrays are heat-ordered (hot nodes first)."""
    probs = [np.asarray(p, dtype=np.float64) for p in probs]
    n_parts = len(probs)
    n = probs[0].shape[0]
    for p in probs:
        if p.shape[0] != n:
            raise ValueError("every probability vector must have N entries")
    prob_mat = np.stack(probs)  # [P, N]
    partition_book = np.full(n, -1, dtype=np.int32)
    res: List[List[np.ndarray]] = [[] for _ in range(n_parts)]
    sizes = np.zeros(n_parts, dtype=np.int64)

    total = prob_mat.sum(axis=0)
    touched = np.argsort(-total, kind="stable")
    touched = touched[total[touched] > 0]
    untouched = np.nonzero(total == 0)[0]

    for start in range(0, touched.shape[0], chunk_size):
        chunk = touched[start: start + chunk_size]
        sub = prob_mat[:, chunk]  # [P, C]
        others = (sub.sum(axis=0, keepdims=True) - sub) / max(n_parts - 1, 1)
        gain = sub - others
        gain = gain - (sizes[:, None] - sizes.min()) * 1e-9  # favour the smaller partitions
        pick = np.argmax(gain, axis=0)
        for p in range(n_parts):
            ids = chunk[pick == p]
            if ids.size:
                res[p].append(ids)
                partition_book[ids] = p
                sizes[p] += ids.size
    if untouched.size:  # nodes no partition touches, spread for balance
        order = np.argsort(sizes, kind="stable")
        for p, ids in zip(order, np.array_split(untouched, n_parts)):
            if ids.size:
                res[p].append(ids)
                partition_book[ids] = p
    out = [np.concatenate(r) if r else np.empty(0, dtype=np.int64) for r in res]
    return out, partition_book


def quiver_partition_feature(probs: Sequence[np.ndarray], result_path: str,
                             cache_memory_budget: Union[int, str] = 0,
                             per_feature_size: int = 0, chunk_size: int = CHUNK_SIZE):
    """Partition, pick each partition's hot cache (the hottest rows it does
    not own, ``cache_memory_budget // per_feature_size`` of them) and save
    the artifacts under ``result_path``. Returns ``(partitions, caches,
    partition_book)``."""
    os.makedirs(result_path, exist_ok=True)
    partitions, book = partition_feature_without_replication(probs, chunk_size)
    cache_budget = parse_size(cache_memory_budget)
    cache_rows = 0
    if cache_budget and per_feature_size:
        cache_rows = cache_budget // int(per_feature_size)
    caches = []
    for p, ids in enumerate(partitions):
        part_dir = os.path.join(result_path, f"partition_{p}")
        os.makedirs(part_dir, exist_ok=True)
        others = np.asarray(probs[p], dtype=np.float64).copy()
        others[ids] = 0
        cache_ids = np.argsort(-others, kind="stable")[:cache_rows]
        cache_ids = cache_ids[others[cache_ids] > 0]
        caches.append(cache_ids)
        np.savez(os.path.join(part_dir, QUIVER_PARTITION_FILE), partition_ids=ids)
        np.savez(os.path.join(part_dir, QUIVER_CACHE_FILE), cache_ids=cache_ids)
    np.savez(os.path.join(result_path, QUIVER_PARTITION_BOOK_FILE), partition_book=book)
    return partitions, caches, book


def load_quiver_feature_partition(partition_idx: int, result_path: str):
    """One partition's artifacts: ``(partition_ids, cache_ids,
    partition_book)``."""
    part_dir = os.path.join(result_path, f"partition_{partition_idx}")
    part = np.load(os.path.join(part_dir, QUIVER_PARTITION_FILE))
    cache = np.load(os.path.join(part_dir, QUIVER_CACHE_FILE))
    book = np.load(os.path.join(result_path, QUIVER_PARTITION_BOOK_FILE))
    return part["partition_ids"], cache["cache_ids"], book["partition_book"]

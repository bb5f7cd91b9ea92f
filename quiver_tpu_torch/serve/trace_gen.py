"""Seeded synthetic request traces — the port of
``quiver_tpu/serve/trace_gen.py:zipfian_trace``."""

from __future__ import annotations

import numpy as np


def zipfian_trace(n_nodes: int, n_requests: int, alpha: float = 0.99,
                  seed: int = 0) -> np.ndarray:
    """``[n_requests]`` int64 node ids drawn Zipf(``alpha``) over
    ``n_nodes`` ranks (``alpha=0`` is uniform), the rank-to-node map a
    seeded permutation. Deterministic per arguments, and equal to the JAX
    package's trace for the same arguments."""
    if n_nodes <= 0 or n_requests < 0:
        raise ValueError("need n_nodes > 0 and n_requests >= 0")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    p = ranks ** (-float(alpha))
    p /= p.sum()
    drawn_ranks = rng.choice(n_nodes, size=n_requests, p=p)
    node_of_rank = rng.permutation(n_nodes).astype(np.int64)
    return node_of_rank[drawn_ranks]

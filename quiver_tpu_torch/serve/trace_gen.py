"""Seeded synthetic request traces — the port of
``quiver_tpu/serve/trace_gen.py`` (`zipfian_trace`, `poisson_arrivals`,
`DeltaTrace` and `delta_interleaved_trace`, `temporal_trace`,
`lp_trace`). Every trace is byte-equal to the JAX package's for the same
arguments."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

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


def poisson_arrivals(n_requests: int, qps: float, seed: int = 0) -> np.ndarray:
    """``[n_requests]`` float64 cumulative arrival times (seconds) of a
    Poisson process at rate ``qps``."""
    if qps <= 0:
        raise ValueError("qps must be > 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n_requests))


class DeltaTrace(NamedTuple):
    """A request trace with seeded edge arrivals woven in: ``requests`` is
    the plain `zipfian_trace` at the same arguments, and arrival event
    ``i`` commits edges ``(edge_src[i], edge_dst[i])`` just before request
    ``edge_pos[i]`` is submitted."""

    requests: np.ndarray   # [n_requests] int64 node ids
    edge_pos: np.ndarray   # [n_events] int64 request index an event
    edge_src: np.ndarray   # [n_events, edges_per_event] int64
    edge_dst: np.ndarray   # [n_events, edges_per_event] int64

    @property
    def n_events(self) -> int:
        return int(self.edge_pos.shape[0])

    def events(self) -> Iterator[Tuple[str, object, object]]:
        """The interleaved schedule in commit order: ``("edges", src_row,
        dst_row)`` and ``("request", index, node)``."""
        e = 0
        for i, node in enumerate(self.requests):
            while e < self.n_events and int(self.edge_pos[e]) == i:
                yield ("edges", self.edge_src[e], self.edge_dst[e])
                e += 1
            yield ("request", i, int(node))


def delta_interleaved_trace(n_nodes: int, n_requests: int, alpha: float = 0.99, seed: int = 0,
                            edge_every: int = 32, edges_per_event: int = 4) -> DeltaTrace:
    """A `zipfian_trace` with an arrival event every ``edge_every``
    requests, ``edges_per_event`` new edges each: sources drawn from the
    requests served so far (new edges land on nodes the traffic already
    finds hot), destinations uniform, self-loops moved to the next node.
    The events come from a generator of their own, so the requests equal
    ``zipfian_trace(n_nodes, n_requests, alpha, seed)`` byte for byte."""
    if edge_every <= 0 or edges_per_event <= 0:
        raise ValueError("edge_every and edges_per_event must be > 0")
    requests = zipfian_trace(n_nodes, n_requests, alpha=alpha, seed=seed)
    rng = np.random.default_rng([int(seed), 0x5EED])
    pos = np.arange(edge_every, n_requests, edge_every, dtype=np.int64)
    src = np.zeros((pos.shape[0], edges_per_event), np.int64)
    dst = np.zeros((pos.shape[0], edges_per_event), np.int64)
    for i, p in enumerate(pos):
        picks = rng.integers(0, int(p), edges_per_event)
        src[i] = requests[picks]
        dst[i] = rng.integers(0, n_nodes, edges_per_event)
    loops = src == dst
    dst[loops] = (dst[loops] + 1) % n_nodes
    return DeltaTrace(requests=requests, edge_pos=pos, edge_src=src, edge_dst=dst)


class TemporalTrace(NamedTuple):
    """Query-time-stamped requests with timestamped edge appends: request
    ``i`` asks for ``requests[i]`` as of ``t_query[i]``; event ``j``
    appends edges ``(edge_src[j], edge_dst[j])`` stamped ``edge_ts[j]``
    just before request ``edge_pos[j]``, each stamp between the two
    neighbouring query times."""

    requests: np.ndarray   # [n_requests] int64 node ids
    t_query: np.ndarray    # [n_requests] float64 query times (monotone)
    edge_pos: np.ndarray   # [n_events] int64 request index per event
    edge_src: np.ndarray   # [n_events, edges_per_event] int64
    edge_dst: np.ndarray   # [n_events, edges_per_event] int64
    edge_ts: np.ndarray    # [n_events, edges_per_event] float64

    @property
    def n_events(self) -> int:
        return int(self.edge_pos.shape[0])


def temporal_trace(n_nodes: int, n_requests: int, alpha: float = 0.99, seed: int = 0,
                   qps: float = 1000.0, t0: float = 0.0, edge_every: int = 32,
                   edges_per_event: int = 4) -> TemporalTrace:
    """A `zipfian_trace` node stream with `poisson_arrivals` query times
    from ``t0`` and one edge-append event every ``edge_every`` requests
    (sources from the served prefix, stamps strictly between the
    neighbouring query times). Deterministic per arguments."""
    if edge_every <= 0 or edges_per_event <= 0:
        raise ValueError("edge_every and edges_per_event must be > 0")
    requests = zipfian_trace(n_nodes, n_requests, alpha=alpha, seed=seed)
    t_query = t0 + poisson_arrivals(n_requests, qps, seed=seed)
    rng = np.random.default_rng([int(seed), 0x7E4D])
    pos = np.arange(edge_every, n_requests, edge_every, dtype=np.int64)
    k = pos.shape[0]
    src = np.zeros((k, edges_per_event), np.int64)
    dst = np.zeros((k, edges_per_event), np.int64)
    ets = np.zeros((k, edges_per_event), np.float64)
    for i, p in enumerate(pos):
        picks = rng.integers(0, int(p), edges_per_event)
        src[i] = requests[picks]
        dst[i] = rng.integers(0, n_nodes, edges_per_event)
        lo, hi = float(t_query[p - 1]), float(t_query[p])
        u = rng.uniform(0.05, 0.95, edges_per_event)
        ets[i] = lo + u * (hi - lo)
    loops = src == dst
    dst[loops] = (dst[loops] + 1) % n_nodes
    return TemporalTrace(requests=requests, t_query=t_query, edge_pos=pos,
                         edge_src=src, edge_dst=dst, edge_ts=ets)


class LPTrace(NamedTuple):
    """Link-prediction requests: pairs ``(u[i], v[i])`` labelled 1 for an
    edge of the graph and 0 for a sampled negative, at ``t_query[i]``."""

    u: np.ndarray        # [n_pairs] int64
    v: np.ndarray        # [n_pairs] int64
    label: np.ndarray    # [n_pairs] int8
    t_query: np.ndarray  # [n_pairs] float64


def lp_trace(csr_topo, n_pairs: int, alpha: float = 0.99, seed: int = 0,
             pos_frac: float = 0.5, qps: float = 1000.0, t0: float = 0.0) -> LPTrace:
    """``pos_frac`` of the pairs are edges (a Zipf-hot source and one of
    its neighbours); the rest pair a source already emitted with a uniform
    non-self destination. Degree-0 sources fall back to negatives.
    Deterministic per arguments."""
    if n_pairs < 0 or not 0.0 <= pos_frac <= 1.0:
        raise ValueError("need n_pairs >= 0 and 0 <= pos_frac <= 1")
    indptr = np.asarray(csr_topo.indptr, np.int64)
    indices = np.asarray(csr_topo.indices, np.int64)
    n_nodes = indptr.shape[0] - 1
    hot = zipfian_trace(n_nodes, n_pairs, alpha=alpha, seed=seed)
    t_query = t0 + poisson_arrivals(n_pairs, qps, seed=seed)
    rng = np.random.default_rng([int(seed), 0x1B9A])
    u = np.zeros(n_pairs, np.int64)
    v = np.zeros(n_pairs, np.int64)
    label = np.zeros(n_pairs, np.int8)
    for i in range(n_pairs):
        want_pos = rng.uniform() < pos_frac
        src = int(hot[i])
        deg = int(indptr[src + 1] - indptr[src])
        if want_pos and deg > 0:
            u[i] = src
            v[i] = int(indices[indptr[src] + rng.integers(0, deg)])
            label[i] = 1
        else:
            u[i] = int(u[:i][rng.integers(0, i)]) if i else src
            d = int(rng.integers(0, n_nodes))
            if d == u[i]:
                d = (d + 1) % n_nodes
            v[i] = d
    return LPTrace(u=u, v=v, label=label, t_query=t_query)

"""Temporal neighbor sampling — the port of
``quiver_tpu/workloads/temporal.py`` (the feed-ranking workload over the
tiled sampler).

Per-edge timestamps ride the tile map's payload lanes like the weighted
sampler's weights: `TemporalTiledGraph` lays them out over the same
``(base, deg)`` map, and a temporal draw (`temporal_sample_layer`, kernel
K8 on the card) masks every edge with ``ts > t`` to weight 0 and hands the
rest, weighted ``exp(recency * ts)``, to the weighted sampler's Gumbel
top-k. Three pins hold it:

- the host-masked oracle (`host_masked_oracle`) builds each seed's
  windows from the host CSR and draws through the plain Gumbel top-k: a
  tiled draw equals it bit for bit;
- at ``t = +inf`` a temporal draw equals the weighted draw over
  `TemporalTiledGraph.recency_wtiles` (kernel K8w, the weight of K8's own
  device function) bit for bit;
- the same ``(key, seeds, t)`` gives the same draw, so a dispatch log
  replays.

`temporal_sample_dense` threads each seed's query time down its frontier
lineage through the structural no-dedup layout: neighbor ``(i, j)`` of a
hop of width ``w`` sits at ``w + j*w + i``, so the next hop's times are
``cat([t, t.repeat(k)])``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import random as qrandom
from ..ops.sample import (
    LANE,
    gumbel_topk_positions,
    temporal_edge_weights,
    temporal_weight_rows,
    tiled_temporal_sample_layer,
)
from ..pyg.sage_sampler import DenseAdj, DenseSample
from ..utils import resolve_device

temporal_sample_layer = tiled_temporal_sample_layer

__all__ = ["TemporalTiledGraph", "host_masked_oracle", "temporal_sample_dense",
           "temporal_sample_layer"]


class TemporalTiledGraph:
    """A frozen graph with one float32 arrival time per edge (``edge_ts``,
    aligned with ``csr_topo.indices``) in the tile payload lanes: the
    ``(bd, tiles, ttiles)`` tensors `GraphSageSampler.bind_temporal` reads.
    ``bd`` and ``tiles`` are the topology's cached tile layout
    (`CSRTopo.to_device_tiled`). Keep ``recency * ts`` inside float32
    ``exp`` range (|x| < ~87)."""

    temporal = True  # the bind_temporal marker

    def __init__(self, csr_topo, edge_ts, id_dtype=None, device=None):
        dev = resolve_device(device)
        self.csr_topo = csr_topo
        self.n = csr_topo.node_count
        self.edge_ts = np.asarray(edge_ts, np.float32).reshape(-1)
        if self.edge_ts.shape[0] != csr_topo.edge_count:
            raise ValueError(f"edge_ts has {self.edge_ts.shape[0]} entries for "
                             f"{csr_topo.edge_count} edges")
        self._bd, self._tiles = csr_topo.to_device_tiled(dev, id_dtype)
        # the timestamps' flat upload is freed once their tiles are built
        self._ttiles = csr_topo.tiles_on_device(torch.from_numpy(self.edge_ts).to(dev))

    def temporal_graph(self):
        """The device ``(bd, tiles, ttiles)`` a temporal draw reads."""
        return self._bd, self._tiles, self._ttiles

    def recency_wtiles(self, recency: float) -> torch.Tensor:
        """The weight tiles a temporal draw at ``t = +inf`` equals:
        `ops.sample.temporal_edge_weights` over the timestamp tiles (K8w on
        the card)."""
        return temporal_edge_weights(self._ttiles, float(recency))


def temporal_sample_dense(graph, key, seeds: torch.Tensor, t_seed: torch.Tensor, sizes,
                          recency: float = 0.0, max_deg: int = 512) -> DenseSample:
    """Multi-hop temporal sample in the structural layout: each hop draws
    only edges with ``ts <= t`` of the expanding seed's own query time.
    Keys split per hop as `pyg.sage_sampler.sample_dense_fused` does (or
    come as the hops' key words), so the draw replays from ``(key, seeds,
    t_seed)``. A ``graph`` with ``words`` (`inference.DeviceGraph`: a
    streaming graph's staged addresses) draws through K8's device-graph
    form on the card."""
    bd, tiles, ttiles = graph
    words = getattr(graph, "words", None)
    B = seeds.shape[0]
    dev = seeds.device
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    cur_t = t_seed.to(dev, torch.float32)
    adjs: List[DenseAdj] = []
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    for k, sub in zip(sizes, qrandom.hop_keys(key, len(sizes))):
        nbrs, valid = tiled_temporal_sample_layer(bd, tiles, ttiles, cur, cur_valid, k, sub,
                                                  cur_t, max_deg=max_deg, recency=recency,
                                                  graph_words=words)
        # neighbor (i, j) -> position w + j*w + i: its query time is cur_t[i]
        n_id = torch.cat([cur, nbrs.t().reshape(-1)])
        n_valid = torch.cat([cur_valid, valid.t().reshape(-1)])
        n_t = torch.cat([cur_t, cur_t.repeat(k)])
        count = n_valid.sum(dtype=torch.int32)
        adjs.append(DenseAdj(cols=None, mask=valid, n_src=count, n_dst=prev_count))
        cur, cur_valid, cur_t, prev_count = n_id, n_valid, n_t, count
    return DenseSample(n_id=cur, count=prev_count, batch_size=B, adjs=tuple(adjs[::-1]))


def host_masked_oracle(indptr, indices, edge_ts, seeds, seed_valid, k: int, key, t,
                       max_deg: int = 512, recency: float = 0.0,
                       cutoff=None) -> Tuple[np.ndarray, np.ndarray]:
    """One temporal hop from first principles: each seed's neighbor and
    timestamp windows sliced from the host CSR (no tile map), weighted by
    `ops.sample.temporal_weight_rows` and drawn by the plain
    `ops.sample.gumbel_topk_positions` on the same key, on the CPU.
    Returns ``(nbrs, valid)`` as numpy; a tiled draw must equal it on its
    valid lanes. The window is the tiled layer's ``ceil(max_deg/128)*128``
    lanes, so the uniforms line up."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    edge_ts = np.asarray(edge_ts, np.float32)
    seeds = np.asarray(seeds, np.int64)
    seed_valid = np.asarray(seed_valid, bool)
    n = indptr.shape[0] - 1
    B = seeds.shape[0]
    W = -(-int(max_deg) // LANE) * LANE
    nbr_win = np.zeros((B, W), np.int64)
    ts_win = np.zeros((B, W), np.float32)
    deg = np.zeros((B,), np.int32)
    for b in range(B):
        node = int(np.clip(seeds[b], 0, n - 1))
        d = int(indptr[node + 1] - indptr[node]) if seed_valid[b] else 0
        d = min(d, int(max_deg))
        lo = indptr[node]
        nbr_win[b, :d] = indices[lo:lo + d]
        ts_win[b, :d] = edge_ts[lo:lo + d]
        deg[b] = d
    w_rows = temporal_weight_rows(torch.from_numpy(ts_win),
                                  torch.from_numpy(np.asarray(t, np.float32).reshape(-1)),
                                  recency, cutoff=cutoff)
    pos, valid = gumbel_topk_positions(key, torch.from_numpy(deg), k, w_rows)
    nbrs = np.take_along_axis(nbr_win, np.clip(pos.numpy(), 0, W - 1), axis=1)
    return nbrs, valid.numpy()

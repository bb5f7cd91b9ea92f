"""GraphSAGE k-hop sampler — the port of
``quiver_tpu/pyg/sage_sampler.py`` (``DenseAdj``, ``DenseSample``,
``sample_dense_fused``, ``sample_dense_pure`` and ``GraphSageSampler`` in
its device mode).

The sampler draws one key per call from a deterministic stream
(``fold_in(key(seed), call)``) and splits a sub-key per hop
(``key, sub = split(key)``), exactly as the JAX package does, so the same
seed and call index give bit-equal ``n_id``, masks, ``cols`` and counts.
Keys are derived on the host; only each hop's ``[k, W]`` uniforms are
computed on the device, inside the sampling kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as qrandom
from ..ops.reindex import local_reindex
from ..ops.sample import pad_widths
from ..ops.sample import sample_layer as _sample_layer_op
from ..ops.sample import tiled_sample_layer as _tiled_sample_layer_op
from ..utils import CSRTopo, resolve_device


class DenseAdj(NamedTuple):
    """Static-shape adjacency of one hop. ``cols[i, j]`` is the local id
    (into this hop's source ``n_id``) of the j-th sampled neighbor of
    target i; ``mask`` marks real samples; targets are the prefix
    ``[:mask.shape[0]]`` of the source. ``cols is None`` is the
    structural layout of the no-dedup pipeline: neighbor (i, j) sits at
    source position ``W + j*W + i`` with ``W = mask.shape[0]``."""

    cols: Optional[torch.Tensor]  # [S, k] int32, or None (structural)
    mask: torch.Tensor            # [S, k] bool
    n_src: torch.Tensor           # 0-dim int32: valid source-node count
    n_dst: torch.Tensor           # 0-dim int32: valid target-node count

    @property
    def w_dst(self) -> int:
        return self.mask.shape[0]

    def gather_src(self, x_src: torch.Tensor) -> torch.Tensor:
        """Neighbor rows ``[W_dst, k, ...]`` of the hop-source array."""
        w, k = self.mask.shape
        if self.cols is None:
            s = x_src[w: w * (1 + k)]
            return s.reshape((k, w) + tuple(x_src.shape[1:])).transpose(0, 1)
        idx = torch.clamp(self.cols, 0, x_src.shape[0] - 1).to(torch.int64)
        return x_src[idx]


class DenseSample(NamedTuple):
    n_id: torch.Tensor            # [cap] padded node ids (global)
    count: torch.Tensor           # 0-dim int32: valid length of n_id
    batch_size: int
    adjs: Tuple[DenseAdj, ...]    # outermost hop first
    cap_overflow: Optional[torch.Tensor] = None  # dedup only
    raw_counts: Optional[torch.Tensor] = None    # dedup only: pre-cap counts


def _default_sample_fn(indptr, indices):
    def sample_fn(cur, cur_valid, k, key):
        return _sample_layer_op(indptr, indices, cur, cur_valid, k, key)
    return sample_fn


def sample_dense_fused(indptr, indices, key, seeds: torch.Tensor,
                       sizes: Sequence[int], sample_fn=None) -> DenseSample:
    """Multi-hop sample with no per-hop dedup: neighbor (i, j) of a hop
    of width w lands at ``n_id`` position ``w + j*w + i`` (structural
    layout, ``cols=None``)."""
    if sample_fn is None:
        sample_fn = _default_sample_fn(indptr, indices)
    B = seeds.shape[0]
    dev = seeds.device
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    adjs: List[DenseAdj] = []
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    for k in sizes:
        key, sub = qrandom.split(key)
        nbrs, valid = sample_fn(cur, cur_valid, k, sub)
        n_id = torch.cat([cur, nbrs.t().reshape(-1)])
        n_valid = torch.cat([cur_valid, valid.t().reshape(-1)])
        count = n_valid.sum(dtype=torch.int32)
        adjs.append(DenseAdj(cols=None, mask=valid, n_src=count, n_dst=prev_count))
        cur, cur_valid, prev_count = n_id, n_valid, count
    return DenseSample(n_id=cur, count=prev_count, batch_size=B, adjs=tuple(adjs[::-1]))


def sample_dense_pure(indptr, indices, key, seeds: torch.Tensor,
                      sizes: Sequence[int], caps=None, sample_fn=None) -> DenseSample:
    """Multi-hop sample with a dedup reindex after every hop (the
    reference's hash-table contract) and optional static caps."""
    if sample_fn is None:
        sample_fn = _default_sample_fn(indptr, indices)
    B = seeds.shape[0]
    dev = seeds.device
    widths = pad_widths(B, sizes, caps)
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    adjs: List[DenseAdj] = []
    raws: List[torch.Tensor] = []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    for l, k in enumerate(sizes):
        key, sub = qrandom.split(key)
        nbrs, valid = sample_fn(cur, cur_valid, k, sub)
        res = local_reindex(cur, cur_valid, nbrs, valid)
        n_id, count = res.n_id, res.count
        raws.append(count)
        local_nbrs, nbr_valid = res.local_nbrs, res.nbr_valid
        if widths[l + 1] < n_id.shape[0]:
            cap = widths[l + 1]
            n_id = n_id[:cap]
            overflow = overflow + torch.clamp(count - cap, min=0)
            count = torch.clamp(count, max=cap)
            nbr_valid = nbr_valid & (local_nbrs < cap)
        adjs.append(DenseAdj(cols=local_nbrs, mask=nbr_valid, n_src=count, n_dst=prev_count))
        cur = n_id
        cur_valid = torch.arange(n_id.shape[0], dtype=torch.int32, device=dev) < count
        prev_count = count
    return DenseSample(
        n_id=cur, count=prev_count, batch_size=B, adjs=tuple(adjs[::-1]),
        cap_overflow=overflow, raw_counts=torch.stack(raws),
    )


class GraphSageSampler:
    """K-hop sampler over a :class:`CSRTopo` on one device.

    ``sizes`` are fanouts outermost-first (e.g. ``[15, 10, 5]``);
    ``mode`` is "GPU" (the graph lives on the device; "TPU" is accepted as
    an alias); ``layout`` "tiled" (default) or "flat"; ``dedup`` True
    (default) dedups every hop, False uses the structural no-dedup
    pipeline; ``caps`` optional per-hop static ``n_id`` budgets;
    ``seed`` fixes the key stream; ``device`` defaults to CUDA.
    """

    MODE_ALIASES = {"TPU": "GPU"}

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int], device=None,
                 mode: str = "GPU", caps: Optional[Sequence[Optional[int]]] = None,
                 seed: int = 0, dedup: bool = True, layout: str = "tiled"):
        mode = self.MODE_ALIASES.get(mode, mode)
        if mode != "GPU":
            raise ValueError(f"unsupported mode: {mode} (this port has GPU/TPU only)")
        if layout not in ("tiled", "flat"):
            raise ValueError(f"unsupported layout: {layout}")
        self.csr_topo = csr_topo
        self.sizes = tuple(int(s) for s in sizes)
        self.caps = None if caps is None else tuple(caps)
        self.mode = mode
        self.device = resolve_device(device)
        self.dedup = bool(dedup)
        self.layout = layout
        self._seed = int(seed)
        self._call = 0
        self._graph = None
        self.lazy_init_quiver()

    def lazy_init_quiver(self):
        """Bind the graph to the device: ``(bd, tiles)`` under the tiled
        layout, ``(indptr, indices)`` under the flat one."""
        if self._graph is None:
            if self.layout == "tiled":
                self._graph = self.csr_topo.to_device_tiled(self.device)
            else:
                self._graph = self.csr_topo.to_device(self.device)
        return self._graph

    @property
    def id_dtype(self) -> torch.dtype:
        return self.lazy_init_quiver()[1].dtype

    def next_key(self) -> qrandom.Key:
        """Consume and return the next key of the stream without sampling:
        key i is the key the i-th `sample_dense` call would draw."""
        key = qrandom.fold_in(qrandom.key(self._seed), self._call)
        self._call += 1
        return key

    def _bind(self, graph):
        if self.layout == "tiled":
            bd, tiles = graph

            def sample_fn(cur, cur_valid, k, key):
                return _tiled_sample_layer_op(bd, tiles, cur, cur_valid, k, key)
        else:
            indptr, indices = graph

            def sample_fn(cur, cur_valid, k, key):
                return _sample_layer_op(indptr, indices, cur, cur_valid, k, key)
        return sample_fn

    def fused_sample_spec(self):
        """``(graph, bind, id_dtype)`` for a fused sample+gather+forward
        step (`inference.make_serve_step`): ``bind(graph)`` gives the
        one-hop ``sample_fn`` over the graph tensors."""
        graph = self.lazy_init_quiver()
        return graph, self._bind, graph[1].dtype

    def as_seeds(self, seeds) -> torch.Tensor:
        """Seeds on this sampler's device in its id dtype (int32 where the
        JAX package has int32: numpy int64 seeds are cast, not kept)."""
        if isinstance(seeds, torch.Tensor):
            return seeds.to(device=self.device, dtype=self.id_dtype)
        arr = np.asarray(seeds).astype(np.int32 if self.id_dtype == torch.int32 else np.int64)
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned + async: a pageable copy would wait for all work queued
            # on the stream, serialising concurrent flushes on the host
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def sample_dense(self, seeds) -> DenseSample:
        """Sample a padded batch with the next key of the stream."""
        seeds = self.as_seeds(seeds)
        sample_fn = self._bind(self.lazy_init_quiver())
        if not self.dedup:
            return sample_dense_fused(None, None, self.next_key(), seeds, self.sizes,
                                      sample_fn=sample_fn)
        return sample_dense_pure(None, None, self.next_key(), seeds, self.sizes,
                                 self.caps, sample_fn=sample_fn)

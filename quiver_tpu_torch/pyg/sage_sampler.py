"""GraphSAGE k-hop sampler — the port of
``quiver_tpu/pyg/sage_sampler.py`` (``Adj``, ``DenseAdj``, ``DenseSample``,
``sample_dense_fused``, ``sample_dense_pure``, ``sample_and_gather_fused``,
``sample_and_gather_dedup``, ``probe_hop_counts``, ``caps_from_counts``,
``dense_to_pyg`` and ``GraphSageSampler`` in its device mode, uniform,
weighted (``weighted=True``: the Gumbel top-k kernel K7 over the tile or
flat layout) or temporal (`GraphSageSampler.bind_temporal`: K8, see
`quiver_tpu_torch.workloads.temporal`), with static-cap calibration, the
``auto_grow_caps`` overflow ladder, the reference's ragged surface
(``sample``, ``sample_layer``, ``reindex``) and the streaming binding
(`GraphSageSampler.bind_stream`: every draw reads a
`stream.StreamingTiledGraph`'s current arrays; the port's
``calibrate_caps`` keeps no probe cache, so a commit leaves nothing stale
there)), and its host modes (``mode="HOST"``, ``"CPU"``, and the
reference's alias ``"UVA"``): the graph stays in host memory and the
native engine (`ops.cpu_kernels.HostSampler`) draws each batch, which then
lands on the sampler's device in one copy (`host_dense_sample`).
`GraphSageSampler.share_ipc` / ``lazy_from_ipc_handle`` hand a sampler to
another process (`quiver_tpu_torch.multiprocessing`).

In its device mode the sampler draws one key per call from a
deterministic stream (``fold_in(key(seed), call)``) and splits a sub-key
per hop (``key, sub = split(key)``), exactly as the JAX package does, so the same
seed and call index give bit-equal ``n_id``, masks, ``cols`` and counts.
Keys are derived on the host; only each hop's ``[k, W]`` uniforms are
computed on the device, inside the sampling kernel. In a host mode call i
draws with the engine's RNG seed ``(seed * 0x9E3779B1 + i) & 0x7FFFFFFF``
(hop l adds ``l * 1000003``), as the JAX package's host modes do, so the
same seed and call index give the same batch there too (on one machine:
the engine's draws depend on its core count).
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as qrandom
from ..feature import gather_rows
from ..graphs import byte_fields, byte_views, stage
from ..ops.gather_src import gather_src, structural_view
from ..ops.reindex import local_reindex, reindex_single
from ..ops.sample import pad_widths
from ..ops.sample import sample_prob as _sample_prob
from ..ops.sample import sample_layer as _sample_layer_op
from ..ops.sample import tiled_sample_layer as _tiled_sample_layer_op
from ..ops.sample import tiled_weighted_sample_layer as _tiled_weighted_sample_layer_op
from ..ops.sample import weighted_sample_layer as _weighted_sample_layer_op
from ..utils import CSRTopo, _best_id_dtype, refuse_unexportable_allocator, resolve_device

HOST_MODES = ("HOST", "CPU")


class Adj(NamedTuple):
    """The reference's PyG adjacency of one hop: ``edge_index [2, nnz]``
    int64 (row 0 the source local ids, row 1 the target ones), an empty
    ``e_id`` (the reference keeps it empty too) and ``size = (n_src,
    n_dst)``. Host tensors; `to` moves them."""

    edge_index: torch.Tensor
    e_id: torch.Tensor
    size: Tuple[int, int]

    def to(self, *args, **kwargs) -> "Adj":
        return Adj(self.edge_index.to(*args, **kwargs), self.e_id.to(*args, **kwargs),
                   self.size)


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
        """Neighbor rows ``[W_dst, k, ...]`` of the hop-source array,
        differentiable in ``x_src``: a view in the structural layout, and
        in the cols layout `quiver_tpu_torch.ops.gather_src.gather_src`
        (K14 forward and K14b backward on CUDA tensors), whose gradient
        sums the valid lanes only."""
        w, k = self.mask.shape
        if self.cols is None:
            return structural_view(x_src, w, k)
        return gather_src(x_src, self.mask, self.cols)


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
    layout, ``cols=None``). ``key`` is a host key, split a hop, or the
    hops' key words (`random.hop_keys`)."""
    if sample_fn is None:
        sample_fn = _default_sample_fn(indptr, indices)
    B = seeds.shape[0]
    dev = seeds.device
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    adjs: List[DenseAdj] = []
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    for k, sub in zip(sizes, qrandom.hop_keys(key, len(sizes))):
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
    reference's hash-table contract) and optional static caps. ``key`` as
    in `sample_dense_fused`."""
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
    for l, (k, sub) in enumerate(zip(sizes, qrandom.hop_keys(key, len(sizes)))):
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


def sample_and_gather_fused(indptr, indices, table: torch.Tensor, key, seeds: torch.Tensor,
                            sizes: Sequence[int], gather_fn=None,
                            sample_fn=None) -> Tuple[DenseSample, torch.Tensor]:
    """`sample_dense_fused` with the feature gather interleaved per hop:
    returns ``(ds, x)`` with ``x == table[clip(ds.n_id)]`` row for row
    (invalid lanes carry rows that ``adj.mask`` gates out). The same key
    splits per hop as the sample alone; the rows come through the clipped
    row gather (K3), or ``gather_fn(table, ids) -> rows`` where given (the
    sharded gather of `quiver_tpu_torch.parallel`). ``key`` as in
    `sample_dense_fused`."""
    if gather_fn is None:
        gather_fn = gather_rows
    if sample_fn is None:
        sample_fn = _default_sample_fn(indptr, indices)
    B = seeds.shape[0]
    dev = seeds.device
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    adjs: List[DenseAdj] = []
    xs = [gather_fn(table, seeds)]
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    for k, sub in zip(sizes, qrandom.hop_keys(key, len(sizes))):
        nbrs, valid = sample_fn(cur, cur_valid, k, sub)
        flat = nbrs.t().reshape(-1)
        xs.append(gather_fn(table, flat))
        n_id = torch.cat([cur, flat])
        n_valid = torch.cat([cur_valid, valid.t().reshape(-1)])
        count = n_valid.sum(dtype=torch.int32)
        adjs.append(DenseAdj(cols=None, mask=valid, n_src=count, n_dst=prev_count))
        cur, cur_valid, prev_count = n_id, n_valid, count
    ds = DenseSample(n_id=cur, count=prev_count, batch_size=B, adjs=tuple(adjs[::-1]))
    return ds, torch.cat(xs)


def sample_and_gather_dedup(indptr, indices, table: torch.Tensor, key, seeds: torch.Tensor,
                            sizes: Sequence[int], caps=None, gather_fn=None,
                            sample_fn=None) -> Tuple[DenseSample, torch.Tensor]:
    """The dedup sample of `sample_dense_pure` for every hop but the last,
    whose leaves stay in the structural layout and take their rows straight
    from ``table`` (through ``gather_fn(table, ids) -> rows`` where given,
    else the clipped row gather K3): the leaf aggregation reads the constant
    table, so no gradient flows into it. Returns ``(ds, x)``; ``ds.n_id`` is
    the hop L-1 unique frontier then the structural leaf block (not
    globally unique). ``key`` as in `sample_dense_fused`."""
    if len(sizes) == 0:
        raise ValueError("sizes must name at least one hop")
    if gather_fn is None:
        gather_fn = gather_rows
    if sample_fn is None:
        sample_fn = _default_sample_fn(indptr, indices)
    B = seeds.shape[0]
    dev = seeds.device
    inner_caps = None if caps is None else tuple(caps[: len(sizes) - 1])
    widths = pad_widths(B, sizes[:-1], inner_caps)
    cur = seeds
    cur_valid = torch.ones(B, dtype=torch.bool, device=dev)
    adjs: List[DenseAdj] = []
    raws: List[torch.Tensor] = []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    prev_count = torch.full((), B, dtype=torch.int32, device=dev)
    subs = qrandom.hop_keys(key, len(sizes))
    for l, (k, sub) in enumerate(zip(sizes[:-1], subs)):
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
    nbrs, valid = sample_fn(cur, cur_valid, sizes[-1], subs[-1])
    flat = nbrs.t().reshape(-1)  # leaf (i, j) -> position W + j*W + i
    x = torch.cat([gather_fn(table, cur), gather_fn(table, flat)])
    n_src = prev_count + valid.sum(dtype=torch.int32)
    adjs.append(DenseAdj(cols=None, mask=valid, n_src=n_src, n_dst=prev_count))
    raws.append(n_src)  # structural leaves are never capped
    ds = DenseSample(
        n_id=torch.cat([cur, flat]), count=n_src, batch_size=B, adjs=tuple(adjs[::-1]),
        cap_overflow=overflow, raw_counts=torch.stack(raws),
    )
    return ds, x


def probe_hop_counts(indptr, indices, key, seeds_all: torch.Tensor, sizes: Sequence[int],
                     sample_fn=None) -> np.ndarray:
    """Per-hop unique-frontier counts ``[m, L]`` of the uncapped dedup
    pipeline over ``m`` probe batches ``seeds_all [m, B]``: batch i draws
    with ``fold_in(key, i)``, and every count is read after one sync."""
    counts = []
    for i in range(seeds_all.shape[0]):
        ds = sample_dense_pure(indptr, indices, qrandom.fold_in(key, i), seeds_all[i], sizes,
                               sample_fn=sample_fn)
        counts.append(torch.stack([a.n_src for a in ds.adjs[::-1]]))
    if not counts:
        return np.zeros((0, len(sizes)), np.int32)
    return torch.stack(counts).cpu().numpy()


def caps_from_counts(counts, batch: int, sizes: Sequence[int], margin: float = 1.2,
                     granule: int = 4096) -> Tuple[int, ...]:
    """Static per-hop ``n_id`` caps from probed unique counts: the max over
    the probe batches times ``margin``, rounded up to ``granule``, clipped
    to the uncapped worst case ``B * prod(1 + k)``."""
    counts = np.asarray(counts).reshape(-1, len(sizes))
    worst = pad_widths(batch, sizes)[1:]
    caps = []
    for l in range(len(sizes)):
        need = int(np.max(counts[:, l])) * margin
        caps.append(int(min(-(-need // granule) * granule, worst[l])))
    return tuple(caps)


def dense_to_pyg(ds: DenseSample):
    """The reference's ragged ``(n_id, batch_size, [Adj])`` of a padded
    `DenseSample`, outermost hop first, on the host: ``n_id`` its valid
    prefix, each `Adj` the (source, target) local ids of its valid lanes
    in row-major order."""
    count = int(ds.count)
    n_id = ds.n_id[:count].cpu()
    adjs = []
    for adj in ds.adjs:
        mask = adj.mask.cpu()
        w, k = mask.shape
        if adj.cols is None:  # structural layout: cols[i, j] = W + j*W + i
            cols = w * (1 + torch.arange(k))[None, :] + torch.arange(w)[:, None]
        else:
            cols = adj.cols.cpu()
        rows = torch.arange(w)[:, None].expand(w, k)
        edge_index = torch.stack([cols[mask], rows[mask]]).to(torch.int64)
        adjs.append(Adj(edge_index, torch.empty(0, dtype=torch.int64),
                        (int(adj.n_src), int(adj.n_dst))))
    return n_id, ds.batch_size, adjs


def host_dense_sample(n_id: np.ndarray, count: int, adjs, batch_size: int,
                      device: torch.device) -> DenseSample:
    """The `DenseSample` of a host multi-hop sample
    (`ops.cpu_kernels.HostSampler.sample_multilayer`'s ``(n_id, count,
    adjs)``) on ``device``: ``n_id`` int32 with -1 in its padding (the JAX
    package's int64 padding after its int32 cast), ``cols`` int32, the
    masks, ``n_src``/``n_dst`` 0-dim int32, outermost hop first; no
    ``cap_overflow`` or ``raw_counts``. The arrays go to the card packed in
    one pinned buffer, one copy on the current stream. The caller checks
    that its node ids fit int32."""
    ids = np.full(n_id.shape[0], -1, np.int32)
    ids[:count] = n_id[:count]
    values = [ids, np.int32(count)]
    specs = [(torch.int32, ids.shape), (torch.int32, ())]
    for a in adjs[::-1]:
        values += [a["cols"], a["mask"], np.int32(a["n_src"]), np.int32(a["n_dst"])]
        specs += [(torch.int32, a["cols"].shape), (torch.bool, a["mask"].shape),
                  (torch.int32, ()), (torch.int32, ())]
    fields, nbytes = byte_fields(specs)
    buf = stage(values, fields, nbytes, pin=device.type == "cuda")
    views = byte_views(buf.to(device, non_blocking=True), fields)
    hops = tuple(DenseAdj(*views[i: i + 4]) for i in range(2, len(views), 4))
    return DenseSample(n_id=views[0], count=views[1], batch_size=int(batch_size), adjs=hops)


class GraphSageSampler:
    """K-hop sampler over a :class:`CSRTopo` on one device.

    ``sizes`` are fanouts outermost-first (e.g. ``[15, 10, 5]``);
    ``mode`` is "GPU" (the graph lives on the device; "TPU" and "DMA" are
    aliases), or "HOST" or "CPU" (the graph stays in host memory, which may
    exceed the card's, and the native engine draws on the host: the
    reference's "UVA" and "ZERO_COPY" are aliases of "HOST"; both modes
    put their batches on ``device``); ``layout`` "tiled" (default) or
    "flat", device mode only; ``dedup`` True
    (default) dedups every hop, False uses the structural no-dedup
    pipeline; ``caps`` optional per-hop static ``n_id`` budgets;
    ``seed`` fixes the key stream; ``device`` defaults to CUDA.
    ``weighted=True`` draws each hop with probability proportional to the
    topology's ``edge_weights`` among a row's first ``min(deg, max_deg)``
    edges (the tiled layout reads the weights in the tile map; flat and
    tiled draws are equal when ``max_deg % 128 == 0``).
    ``auto_grow_caps=True`` regrows the caps of a dedup batch that
    overflowed them (``cap_overflow > 0``) from its pre-cap counts, with
    the ``cap_margin`` and ``cap_granule`` of the last `calibrate_caps`,
    and resamples with the next key, at most ``len(sizes) + 1`` times;
    ``cap_regrows`` counts those resamples.

    A host-mode sampler binds nothing to the card: it draws every hop
    through `ops.cpu_kernels.HostSampler` (uniform, or weighted over all
    of a row's edges, ``max_deg`` playing no part), dedups every hop and
    applies ``caps``, but has no ``auto_grow_caps`` ladder and no key
    stream to hand out (`next_key` raises), and refuses the fused step,
    streams and temporal binding, as the JAX package's host modes do. Its
    node ids must fit int32 (its edge offsets may not: a graph past 2^31
    edges samples here); larger id spaces wait for ROADMAP B4.
    """

    MODE_ALIASES = {"TPU": "GPU", "DMA": "GPU", "UVA": "HOST", "ZERO_COPY": "HOST"}

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int], device=None,
                 mode: str = "GPU", caps: Optional[Sequence[Optional[int]]] = None,
                 seed: int = 0, dedup: bool = True, layout: str = "tiled",
                 weighted: bool = False, max_deg: int = 512, auto_grow_caps: bool = False):
        mode = self.MODE_ALIASES.get(mode, mode)
        if mode not in ("GPU",) + HOST_MODES:
            raise ValueError(f"unsupported mode: {mode}")
        if mode in HOST_MODES and _best_id_dtype(csr_topo.node_count + 1) != np.int32:
            raise ValueError(f"a host-mode batch carries int32 node ids; this graph has "
                             f"{csr_topo.node_count} nodes (int64 node ids: ROADMAP B4)")
        if layout not in ("tiled", "flat"):
            raise ValueError(f"unsupported layout: {layout}")
        if weighted and csr_topo.edge_weights is None:
            raise ValueError("weighted=True needs CSRTopo(edge_weights=...) "
                             "(per-edge weights aligned with the COO input)")
        self.csr_topo = csr_topo
        self.sizes = tuple(int(s) for s in sizes)
        self.caps = None if caps is None else tuple(caps)
        self.mode = mode
        self.device = resolve_device(device)
        self.dedup = bool(dedup)
        self.layout = layout
        self.weighted = bool(weighted)
        self.max_deg = int(max_deg)
        self.auto_grow_caps = bool(auto_grow_caps)
        # the overflow ladder's policy, set by calibrate_caps
        self.cap_margin, self.cap_granule = 1.2, 4096
        self.cap_regrows = 0
        self._seed = int(seed)
        self._call = 0
        self._graph = None
        self._temporal = None  # (source, recency) once bind_temporal ran
        self._stream = None    # the StreamingTiledGraph once bind_stream ran
        self._host_engine = None
        if mode == "GPU":
            self.lazy_init_quiver()

    @property
    def on_host(self) -> bool:
        """Whether the graph stays in host memory (HOST and CPU modes)."""
        return self.mode in HOST_MODES

    def _refuse_host(self, what: str) -> None:
        if self.on_host:
            raise TypeError(f"{what} needs mode='GPU' (a device-resident graph); this "
                            f"sampler samples on the host (mode={self.mode!r})")

    def _host(self):
        """The native engine over the host CSR (built at first use)."""
        if self._host_engine is None:
            from ..ops.cpu_kernels import HostSampler

            self._host_engine = HostSampler(
                self.csr_topo.indptr, self.csr_topo.indices,
                weights=self.csr_topo.edge_weights if self.weighted else None)
        return self._host_engine

    def _host_seed(self) -> int:
        """The engine's RNG seed of the next call (one call of the stream)."""
        rng_seed = (self._seed * 0x9E3779B1 + self._call) & 0x7FFFFFFF
        self._call += 1
        return rng_seed

    def _host_sample_dense(self, seeds) -> DenseSample:
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy()
        seeds = np.asarray(seeds).astype(np.int64).reshape(-1)
        n_id, count, adjs = self._host().sample_multilayer(seeds, self.sizes, self._host_seed(),
                                                           self.caps)
        return host_dense_sample(n_id, count, adjs, seeds.shape[0], self.device)

    def lazy_init_quiver(self):
        """Bind the graph to the device: ``(bd, tiles)`` under the tiled
        layout, ``(indptr, indices)`` under the flat one; a weighted
        sampler appends its weights (``wtiles [M, 128]`` or ``w [E]``). A
        stream-bound sampler returns the stream's current ``(bd, tiles)``.
        A host-mode sampler has no device graph (TypeError)."""
        self._refuse_host("a device graph")
        if self._stream is not None:
            return self._stream.graph()
        if self._graph is None:
            if self.layout == "tiled":
                g = self.csr_topo.to_device_tiled(self.device)
                if self.weighted:
                    g = g + (self.csr_topo.to_device_tiled_weights(self.device),)
            else:
                g = self.csr_topo.to_device(self.device)
                if self.weighted:
                    g = g + (self.csr_topo.to_device_weights(self.device),)
            self._graph = g
        return self._graph

    # -- streaming graphs (quiver_tpu_torch.stream) ---------------------------

    @property
    def stream(self):
        """The bound `stream.StreamingTiledGraph`, or None (a frozen graph):
        the serve engine's ``update_graph`` needs one."""
        return self._stream

    def _check_stream(self, stream) -> None:
        self._refuse_host("a streaming graph")
        if self.layout != "tiled":
            raise TypeError("a streaming graph needs layout='tiled' — the flat CSR has no pad "
                            "lanes to append into")
        if self.weighted:
            raise TypeError("streaming deltas keep the uniform tile map only; weighted "
                            "samplers would need wtiles streamed in lockstep")
        dev = getattr(stream, "device", None)
        if dev is not None and torch.device(dev) != self.device:
            raise ValueError(f"the stream's tables live on {dev}, this sampler on {self.device}")

    def bind_stream(self, stream) -> "GraphSageSampler":
        """Sample from a `stream.StreamingTiledGraph`: every draw, and the
        fused serve step, reads the stream's current ``(bd, tiles)``, new
        tensors at each commit with the same shapes (the serve engine
        stages their addresses with each flush, `inference.
        BucketPrograms`). Tiled, uniform samplers only."""
        self._check_stream(stream)
        self._stream = stream
        self._graph = None
        return self

    # -- temporal binding (workloads.temporal) ------------------------------

    @property
    def temporal(self):
        """``(source, recency)`` when this sampler draws temporally
        (`bind_temporal`), else None."""
        return self._temporal

    def bind_temporal(self, source, recency: float = 0.0) -> "GraphSageSampler":
        """Draw every hop among edges with ``ts <= t`` of the expanding
        seed's query time, weighted ``exp(recency * ts)`` (K8). ``source``
        is a `workloads.TemporalTiledGraph`, or a `stream.StreamingTiledGraph`
        built with ``edge_ts=``, which this binds as the stream too
        (`bind_stream`): a committed edge is then drawn by the next query
        with ``t >= ts``. Tiled, uniform, ``dedup=False`` samplers only:
        each seed's t rides its frontier lineage through the structural
        layout."""
        from ..stream import StreamingTiledGraph

        self._refuse_host("bind_temporal")
        if self.layout != "tiled":
            raise TypeError("bind_temporal needs layout='tiled' — timestamps ride the "
                            "tile payload lanes")
        if self.weighted:
            raise TypeError("temporal recency bias replaces static edge weights; "
                            "bind_temporal needs weighted=False")
        if self.dedup:
            raise TypeError("temporal sampling threads per-seed query times down the "
                            "frontier lineage — construct with dedup=False")
        if not getattr(source, "temporal", False):
            raise TypeError("bind_temporal wants a TemporalTiledGraph or a StreamingTiledGraph "
                            f"built with edge_ts= (got {type(source).__name__})")
        if isinstance(source, StreamingTiledGraph):
            self._check_stream(source)
            self._stream = source
            self._graph = None
        self._temporal = (source, float(recency))
        return self

    def temporal_graph_arrays(self):
        """The device ``(bd, tiles, ttiles)`` a temporal draw reads."""
        if self._temporal is None:
            raise TypeError("sampler has no temporal binding")
        return self._temporal[0].temporal_graph()

    def fused_graph_arrays(self):
        """The device graph tensors a fused serve step takes: the temporal
        triple, or the binding of `lazy_init_quiver` (a stream's current
        pair)."""
        if self._temporal is not None:
            return self.temporal_graph_arrays()
        return self.lazy_init_quiver()

    @property
    def id_dtype(self) -> torch.dtype:
        if self.on_host:
            return torch.int32  # checked at construction
        return self.lazy_init_quiver()[1].dtype

    def next_key(self) -> qrandom.Key:
        """Consume and return the next key of the stream without sampling:
        key i is the key the i-th `sample_dense` call would draw. A
        host-mode sampler has no key stream (TypeError): its engine's RNG
        seed comes from the seed and the call index inside `sample_dense`."""
        if self.on_host:
            raise TypeError("next_key() draws the device-mode key stream; a HOST/CPU sampler "
                            "derives its engine's RNG seed inside sample_dense")
        key = qrandom.fold_in(qrandom.key(self._seed), self._call)
        self._call += 1
        return key

    def _bind(self, graph):
        max_deg = self.max_deg
        if self.layout == "tiled" and self.weighted:
            bd, tiles, wtiles = graph

            def sample_fn(cur, cur_valid, k, key):
                return _tiled_weighted_sample_layer_op(bd, tiles, wtiles, cur, cur_valid, k,
                                                       key, max_deg)
        elif self.layout == "tiled":
            bd, tiles = graph
            words = getattr(graph, "words", None)  # a streaming graph's staged addresses

            def sample_fn(cur, cur_valid, k, key):
                return _tiled_sample_layer_op(bd, tiles, cur, cur_valid, k, key,
                                              graph_words=words)
        elif self.weighted:
            indptr, indices, w = graph

            def sample_fn(cur, cur_valid, k, key):
                return _weighted_sample_layer_op(indptr, indices, w, cur, cur_valid, k, key,
                                                 max_deg)
        else:
            indptr, indices = graph

            def sample_fn(cur, cur_valid, k, key):
                return _sample_layer_op(indptr, indices, cur, cur_valid, k, key)
        return sample_fn

    def fused_sample_spec(self):
        """``(graph, bind, id_dtype)`` for a fused sample+gather+forward
        step (`inference.make_serve_step`): ``bind(graph)`` gives the
        one-hop ``sample_fn`` over the graph tensors (``(bd, tiles)`` or
        ``(indptr, indices)``, with the weights last on a weighted
        sampler)."""
        self._refuse_host("fused sampling")
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

    def sample_prob(self, train_idx, total_node_count: int) -> torch.Tensor:
        """Per-node hot-probability estimate (`ops.sample.sample_prob`) over
        the flat CSR on this sampler's device, whatever the sampling
        layout; on the card through the cached transposed graph (K11)."""
        indptr, indices = self.csr_topo.to_device(self.device)
        transposed = (self.csr_topo.to_device_transposed(self.device)
                      if self.device.type == "cuda" else None)
        return _sample_prob(indptr, indices, self.sizes, train_idx, total_node_count,
                            transposed=transposed)

    def sample_dense(self, seeds, t=None) -> DenseSample:
        """Sample a padded batch with the next key of the stream. ``t``
        (temporal samplers only): per-seed query times, scalar or ``[B]``;
        every hop of a seed's expansion draws only edges with ``ts <=
        t[seed]``."""
        if self._temporal is not None:
            if t is None:
                raise TypeError("temporal sampler needs a query time: sample_dense(seeds, t=...)")
            from ..workloads.temporal import temporal_sample_dense

            seeds = self.as_seeds(seeds)
            tv = np.asarray(t, np.float32).reshape(-1)
            if tv.shape[0] == 1 and seeds.shape[0] != 1:
                tv = np.broadcast_to(tv, (seeds.shape[0],)).copy()
            if tv.shape[0] != seeds.shape[0]:
                raise ValueError(f"t has {tv.shape[0]} entries for {seeds.shape[0]} seeds")
            return temporal_sample_dense(self.temporal_graph_arrays(), self.next_key(), seeds,
                                         torch.from_numpy(tv).to(self.device), self.sizes,
                                         recency=self._temporal[1], max_deg=self.max_deg)
        if t is not None:
            raise TypeError("t= is only meaningful on a temporal sampler (bind_temporal first)")
        if self.on_host:
            return self._host_sample_dense(seeds)
        seeds = self.as_seeds(seeds)
        sample_fn = self._bind(self.lazy_init_quiver())
        if not self.dedup:
            return sample_dense_fused(None, None, self.next_key(), seeds, self.sizes,
                                      sample_fn=sample_fn)
        ds = sample_dense_pure(None, None, self.next_key(), seeds, self.sizes,
                               self.caps, sample_fn=sample_fn)
        if self.auto_grow_caps and self.caps is not None:
            ds = self._grow_caps(ds, seeds, sample_fn)
        return ds

    def _grow_caps(self, ds: DenseSample, seeds: torch.Tensor, sample_fn) -> DenseSample:
        """The overflow ladder: while ``ds`` dropped nodes, raise the caps
        to `caps_from_counts` of its pre-cap counts (a monotone merge; an
        uncapped hop stays uncapped) and resample with the next key. Hop
        l+1's raw count is taken under hop l's capped frontier, so one
        regrowth can reveal more demand: ``len(sizes) + 1`` rounds, then a
        `RuntimeWarning` if nodes are still dropped."""
        for _ in range(len(self.sizes) + 1):
            if int(ds.cap_overflow) == 0:
                return ds
            grown = caps_from_counts(ds.raw_counts.cpu().numpy()[None, :], seeds.shape[0],
                                     self.sizes, margin=self.cap_margin,
                                     granule=self.cap_granule)
            self.caps = tuple(None if o is None else max(o, n) for o, n in zip(self.caps, grown))
            self.cap_regrows += 1
            ds = sample_dense_pure(None, None, self.next_key(), seeds, self.sizes, self.caps,
                                   sample_fn=sample_fn)
        if int(ds.cap_overflow) > 0:
            warnings.warn(f"auto_grow_caps: still dropping {int(ds.cap_overflow)} nodes after "
                          f"regrowth to caps={self.caps}; raise cap_margin/cap_granule",
                          RuntimeWarning, stacklevel=3)
        return ds

    # -- static-cap calibration ----------------------------------------------

    def calibrate_caps(self, probe_seeds, margin: float = 1.2, granule: int = 4096,
                       set_caps: bool = True) -> Tuple[int, ...]:
        """Per-hop static ``n_id`` caps from probe batches ``probe_seeds``
        (``[m, B]``, or m batches of one length; >= 8 keep the max stable):
        `probe_hop_counts` of the uncapped dedup pipeline under this
        sampler's own draw (layout, weights), with one key of its stream,
        then `caps_from_counts`. Keeps ``margin`` and ``granule`` for the
        ``auto_grow_caps`` ladder; installs the caps unless ``set_caps`` is
        False. Returns them. A host-mode sampler probes with an uncapped
        host sample a batch, one call of its stream each."""
        batches = np.stack([np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
                            for b in probe_seeds])
        if batches.ndim != 2:
            raise ValueError(f"probe_seeds must be [m, B]; got {batches.shape}")
        if self.on_host:
            counts = np.asarray([[a["n_src"] for a in self._host().sample_multilayer(
                b.astype(np.int64), self.sizes, self._host_seed())[2]] for b in batches])
        else:
            counts = probe_hop_counts(None, None, self.next_key(), self.as_seeds(batches),
                                      self.sizes, sample_fn=self._bind(self.lazy_init_quiver()))
        caps = caps_from_counts(counts, batches.shape[1], self.sizes, margin=margin,
                                granule=granule)
        self.cap_margin, self.cap_granule = float(margin), int(granule)
        if set_caps:
            self.caps = caps
        return caps

    # -- the reference's ragged surface ----------------------------------------

    def _plain_draws(self, what: str):
        if self._temporal is not None:
            raise TypeError(f"{what} draws without query times; a temporal sampler samples "
                            "through sample_dense(seeds, t=...)")
        return self._bind(self.lazy_init_quiver())

    def sample(self, input_nodes):
        """The reference's ``(n_id, batch_size, [Adj])`` (`dense_to_pyg`;
        host tensors, one sync). Always the dedup pipeline, with this
        sampler's caps (and its ladder when ``dedup``): the ragged contract
        needs a unique, prefix-valid ``n_id``."""
        if self.on_host:
            return dense_to_pyg(self._host_sample_dense(input_nodes))
        sample_fn = self._plain_draws("sample()")
        if self.dedup:
            return dense_to_pyg(self.sample_dense(input_nodes))
        ds = sample_dense_pure(None, None, self.next_key(), self.as_seeds(input_nodes),
                               self.sizes, self.caps, sample_fn=sample_fn)
        return dense_to_pyg(ds)

    def sample_layer(self, seeds, size: int):
        """One hop of ``size`` draws a seed with the next key: ``(neighbors,
        counts)``, the valid draws of each seed in order, ragged, on this
        sampler's device (int64 ids from a host-mode sampler's engine)."""
        if self.on_host:
            if isinstance(seeds, torch.Tensor):
                seeds = seeds.cpu().numpy()
            nbrs, valid = self._host().sample_layer(np.asarray(seeds, np.int64), int(size),
                                                    self._host_seed())
            return (torch.from_numpy(nbrs[valid]).to(self.device),
                    torch.from_numpy(valid.sum(axis=1)).to(self.device))
        sample_fn = self._plain_draws("sample_layer()")
        seeds = self.as_seeds(seeds)
        nbrs, valid = sample_fn(seeds, torch.ones(seeds.shape, dtype=torch.bool,
                                                  device=seeds.device), int(size),
                                self.next_key())
        return nbrs[valid], valid.sum(dim=1)

    # -- the hand-off to another process (quiver_tpu_torch.multiprocessing) -------

    def share_ipc(self) -> tuple:
        """A handle another process rebuilds this sampler from
        (`lazy_from_ipc_handle`), with the reference's fields: the topology
        (its host arrays moved into shared memory, `CSRTopo.share_memory_`),
        sizes, device, mode, caps, seed, dedup, weighted, max_deg,
        auto_grow_caps and layout, then the card graph when this sampler has
        bound one (the tensors themselves: CUDA IPC, no copy). A host-mode
        sampler builds the native engine here, before any child starts.
        Stream- and temporal-bound samplers are refused: their bindings do
        not cross processes yet."""
        if self._stream is not None:
            raise TypeError("a stream-bound sampler cannot be handed to another process: the "
                            "child would sample the stale base graph (streaming graphs across "
                            "processes: ROADMAP A14)")
        if self._temporal is not None:
            raise TypeError("a temporal-bound sampler cannot be handed to another process: "
                            "the timestamp tiles do not cross yet (ROADMAP A16)")
        self.csr_topo.share_memory_()
        if self.on_host:
            from ..ops.cpu_kernels import _load_native

            _load_native()
        elif self._graph is not None and self.device.type == "cuda":
            refuse_unexportable_allocator()
        return (self.csr_topo, self.sizes, str(self.device), self.mode, self.caps, self._seed,
                self.dedup, self.weighted, self.max_deg, self.auto_grow_caps, self.layout,
                self._graph)

    @classmethod
    def lazy_from_ipc_handle(cls, ipc_handle: tuple) -> "GraphSageSampler":
        """The sampler of a `share_ipc` handle in this process. Its key
        stream starts at call 0, as a fresh sampler's does, however many
        batches the sharer drew. A handed card graph is bound as it is (no
        K12 build, no second copy); without one the graph is bound at first
        use, as by any new sampler."""
        (csr_topo, sizes, device, mode, caps, seed, dedup, weighted, max_deg, auto_grow_caps,
         layout, graph) = ipc_handle
        if graph is not None:  # bound as the topology's own tables
            tables, weights = tuple(graph[:2]), (graph[2] if weighted else None)
            if layout == "tiled":
                csr_topo.adopt_device_tables(tiled=tables, tiled_weights=weights)
            else:
                csr_topo.adopt_device_tables(flat=tables, weights=weights)
        return cls(csr_topo, sizes, device=device, mode=mode, caps=caps, seed=seed,
                   dedup=dedup, layout=layout, weighted=weighted, max_deg=max_deg,
                   auto_grow_caps=auto_grow_caps)

    def reindex(self, inputs, outputs, counts):
        """The reference's reindex of a ragged one-hop result: ``(n_id, row,
        col)`` with ``n_id`` the inputs then their new neighbors once each,
        ascending, and ``(row, col)`` each output's target and source
        local ids, in input order (`ops.reindex.reindex_single`)."""
        counts_np = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor) else counts,
                               np.int64).reshape(-1)
        inputs = self.as_seeds(inputs)
        n_id, count, col = reindex_single(inputs, outputs, counts_np)
        row = torch.repeat_interleave(torch.arange(inputs.shape[0], device=self.device),
                                      torch.from_numpy(counts_np).to(self.device))
        return n_id[: int(count)], row, col

"""Routed fleet serving: seed-ownership routing over the serve exchange — the
port of ``quiver_tpu/serve/dist.py``'s partitioning (``contiguous_partition``,
``closure_masks``, ``shard_from_mask``, ``shard_topology_by_owner``,
``shard_topology_for_seeds``), shard features (``LoopbackComm``,
``_ShardFeature``, ``ClosureFeature``), ``DistServeConfig``,
``DistServeStats``, the ``DistServeEngine`` core and the replay oracles.

A request's path:

1. the router (`DistServeEngine`) answers repeats from its result cache,
   coalesces the rest and flushes on ``max_batch`` / ``max_delay_ms``, as
   `ServeEngine` does (it borrows that engine's admission and flush code,
   late admission included: a seed arriving while a routed flush waits for
   its window permit joins it, up to ``max_batch``, before the owner split);
2. each flush splits its seeds by owner (``global2host``, a stable argsort);
3. ``exchange="collective"`` ships the per-owner seed ids over the serve
   exchange (`comm.TorchComm.exchange_serve`: an id all_to_all over the
   router's own rank threads, the owners' answerers on the calling thread,
   a logits all_to_all back); ``"host"`` calls each owner in turn;
4. each owner serves from its own ``len(sizes) - 1``-hop closure shard with
   the port's `ServeEngine` (K1, K2, K4 on the card; K12 built its tiles):
   under ``feature_residency="closure"`` from its closure's feature rows
   (`ClosureFeature`, gathered in the fused step through K3's index map),
   under ``"exchange"`` from its own rows plus the other owners' over a
   feature exchange (`feature.DistFeature` over a `comm.TorchComm` of its
   own: K3t for its rows, K13f for the ones it answers);
5. the answers land back in the flush's key order.

Every served row is bit-equal to an offline replay of the owning shard's
dispatch log through a sampler over the FULL graph (`replay_shard_oracle`),
and ``hosts=1`` is the single-host `ServeEngine` bit for bit.

Deliberate differences from the JAX package (ROADMAP): ``exchange="auto"``
is collective (rank threads stand in for hosts on any device count);
host-mode legs run one after another (``sequential_legs`` is accepted
either way; results are the same); answerers run on the calling thread.
Not ported: the replica, hedging and failover, faults, tenants and
shedding, tiers and prefetch, the workload monitor and journal, the
elastic fleet and streaming — `DistServeConfig` refuses a non-default
value of any of their fields, naming its ROADMAP item — and the
vectorised whole-batch admission (the router admits request by request).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm import TorchComm, round_up_pow2
from ..feature import DistFeature, Feature, PartitionInfo
from ..inference import batch_logits, bind_params
from ..ops.sample import pad_widths
from ..trace import HitRateCounter, LatencyHistogram, SpanRecorder
from ..utils import CSRTopo, resolve_device
from .cache import EmbeddingCache
from .engine import ResultBatch, ServeConfig, ServeEngine, ServeStats


# -- partitioning ----------------------------------------------------------------------

def contiguous_partition(n_nodes: int, hosts: int) -> np.ndarray:
    """Balanced contiguous ``global2host``: host h owns rows ``[h *
    ceil(N/H), ...)``. int32 [N]."""
    if hosts < 1 or n_nodes < 1:
        raise ValueError("need hosts >= 1 and n_nodes >= 1")
    per = -(-n_nodes // hosts)
    return np.minimum(np.arange(n_nodes, dtype=np.int64) // per, hosts - 1).astype(np.int32)


def closure_masks(indptr: np.ndarray, indices: np.ndarray, seed_mask: np.ndarray, hops: int,
                  feat_hops: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(topo_mask, feat_mask)`` bool [N]: the ``hops``-hop adjacency
    closure and the ``feat_hops``-hop feature closure of ``seed_mask``. Each
    hop marks the endpoints of the frontier's edges (a boolean scatter over
    the edges, O(E) a hop)."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    closure = seed_mask.copy()
    frontier = closure.copy()
    topo_closure = closure.copy() if hops == 0 else None
    for hop in range(feat_hops):
        if not frontier.any():
            break
        reached = np.zeros(n, bool)
        reached[indices[np.repeat(frontier, deg)]] = True
        nxt = reached & ~closure
        if not nxt.any():
            break
        closure |= nxt
        frontier = nxt
        if hop + 1 == hops:
            topo_closure = closure.copy()
    if topo_closure is None:  # the BFS ran out of graph before `hops`
        topo_closure = closure.copy()
    return topo_closure, closure


def shard_from_mask(csr_topo: CSRTopo, topo_mask: np.ndarray) -> Tuple[CSRTopo, Dict[str, float]]:
    """The global-id-space shard CSR that keeps adjacency only for rows in
    ``topo_mask`` (every other row reads degree 0), and its edge stats."""
    indptr = np.asarray(csr_topo.indptr, np.int64)
    indices = np.asarray(csr_topo.indices, np.int64)
    n = indptr.shape[0] - 1
    full_deg = indptr[1:] - indptr[:-1]
    deg = np.where(topo_mask, full_deg, 0)
    new_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=new_indptr[1:])
    keep_edge = np.repeat(topo_mask, full_deg)
    new_indices = indices[keep_edge]
    new_weights = (None if csr_topo.edge_weights is None
                   else np.asarray(csr_topo.edge_weights, np.float32)[keep_edge])
    shard = CSRTopo(indptr=new_indptr, indices=new_indices, edge_weights=new_weights)
    stats = {
        "edges_kept": int(new_indices.shape[0]),
        "edges_total": int(indices.shape[0]),
        "edge_frac": float(new_indices.shape[0]) / float(max(indices.shape[0], 1)),
    }
    return shard, stats


def _closure_shard(csr_topo: CSRTopo, seed_mask: np.ndarray, hops: int, feat_hops: int):
    """(shard_topo, stats, feature-closure ids) of the seeds in ``seed_mask``."""
    topo_mask, feat_mask = closure_masks(np.asarray(csr_topo.indptr, np.int64),
                                         np.asarray(csr_topo.indices, np.int64), seed_mask,
                                         hops, feat_hops)
    shard, edge_stats = shard_from_mask(csr_topo, topo_mask)
    stats = {
        "owned_nodes": int(seed_mask.sum()),
        "closure_nodes": int(topo_mask.sum()),
        "feature_closure_nodes": int(feat_mask.sum()),
        **edge_stats,
    }
    return shard, stats, np.nonzero(feat_mask)[0]


def shard_topology_by_owner(csr_topo: CSRTopo, global2host: np.ndarray, host: int, hops: int,
                            return_closure: bool = False, closure_hops: Optional[int] = None):
    """Host ``host``'s serving topology shard: the full-id-space CSR with
    adjacency kept only for the ``hops``-hop closure of its owned nodes
    (``hops = len(sizes) - 1``: the last hop's frontier is gathered, never
    expanded). A sampler over it draws bit-equal to one over the full graph
    for owned seeds. Returns ``(shard_topo, stats)`` (``owned_nodes``,
    ``closure_nodes``, ``feature_closure_nodes``, ``edges_kept``,
    ``edges_total``, ``edge_frac``), with ``return_closure`` also the sorted
    global ids of the ``closure_hops``-hop closure (default ``hops``)."""
    g2h = np.asarray(global2host)
    n = np.asarray(csr_topo.indptr).shape[0] - 1
    if g2h.shape[0] != n:
        raise ValueError(f"global2host has {g2h.shape[0]} rows, graph has {n}")
    hops = max(int(hops), 0)
    feat_hops = hops if closure_hops is None else max(int(closure_hops), hops)
    shard, stats, closure = _closure_shard(csr_topo, g2h == host, hops, feat_hops)
    if return_closure:
        return shard, stats, closure
    return shard, stats


def shard_topology_for_seeds(csr_topo: CSRTopo, seed_ids: np.ndarray, hops: int,
                             closure_hops: Optional[int] = None):
    """`shard_topology_by_owner` for an explicit seed set: ``(shard_topo,
    stats, closure_ids)``."""
    n = np.asarray(csr_topo.indptr).shape[0] - 1
    seed_ids = np.asarray(seed_ids, np.int64)
    if seed_ids.size and (seed_ids.min() < 0 or seed_ids.max() >= n):
        raise ValueError(f"seed ids outside [0, {n})")
    mask = np.ones(n, np.int32)  # host 1 = everyone else
    mask[seed_ids] = 0           # host 0 = the seed set
    return shard_topology_by_owner(csr_topo, mask, 0, hops, return_closure=True,
                                   closure_hops=closure_hops)


# -- shard features ----------------------------------------------------------------------

class LoopbackComm:
    """The ``exchange="host"`` stand-in for `comm.TorchComm`: the same
    `register_local_table` / `exchange` surface answered by indexing the
    blocks directly (the wire moves bytes, never changes them)."""

    def __init__(self):
        self._blocks: Dict[int, torch.Tensor] = {}

    def register_local_table(self, host: int, rows) -> None:
        self._blocks[host] = torch.as_tensor(rows, dtype=torch.float32)

    def exchange(self, host2ids, budget=None):
        res = []
        for j, ids in enumerate(host2ids):
            ids = torch.as_tensor(np.asarray(ids, np.int64))
            block = self._blocks[j]
            res.append(block[ids.to(block.device)] if ids.numel() else None)
        return res


class _ShardFeature:
    """An owner's feature view under the exchange residency: ids clipped
    into ``[0, N)`` (a sample's padding lanes), owned rows from the local
    block and the others over the feature exchange (`feature.DistFeature`)."""

    def __init__(self, dist: DistFeature, n_nodes: int):
        self._dist = dist
        self._n = n_nodes

    def __getitem__(self, n_id):
        ids = torch.as_tensor(n_id).to(torch.int64).cpu()
        return self._dist[torch.clamp(ids, 0, self._n - 1)]


class ClosureFeature:
    """An owner's resident serve features over global ids (the
    ``"closure"`` residency): the feature rows of its whole closure and an
    int32 ``[N]`` global -> row map (-1 outside the closure), both moved to
    the serving device once. `gather_spec` hands them to the fused step,
    which gathers ``rows[clip(map[clip(n_id)])]`` through K3's index map;
    an out-of-closure id reads row 0, and only masked pad lanes carry such
    ids. Where the map is the identity (``hosts=1``) the spec has no map, so
    the step is the plain-table one of the single-host engine.

    ``reserve_rows`` (room for rows entering the closure under streaming
    graph deltas) must be 0: streaming is not ported (ROADMAP A14)."""

    def __init__(self, rows, local_map: np.ndarray, reserve_rows: int = 0):
        if reserve_rows:
            raise NotImplementedError("ClosureFeature reserve rows serve streaming graphs, "
                                      "which are not ported yet (ROADMAP A14)")
        self._rows = torch.as_tensor(rows, dtype=torch.float32)
        self._map = np.asarray(local_map, np.int32)
        if self._rows.dim() != 2 or self._map.ndim != 1:
            raise ValueError("ClosureFeature wants rows [C, D] and map [N]")
        self._identity = self._map.shape[0] == self._rows.shape[0] and bool(
            np.array_equal(self._map, np.arange(self._map.shape[0], dtype=np.int32)))
        self._dev: Dict[torch.device, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}

    @property
    def resident_rows(self) -> int:
        return self._rows.shape[0]

    def gather_spec(self, device):
        """``(rows [C, D], map [N] int32 or None)`` on ``device``."""
        device = torch.device(device)
        spec = self._dev.get(device)
        if spec is None:
            spec = self._dev[device] = (
                self._rows.to(device),
                None if self._identity else torch.from_numpy(self._map).to(device))
        return spec


def _feat_reserve(config, n_closure: int) -> int:
    """`ClosureFeature` reserve rows for a closure of ``n_closure`` nodes:
    room for rows entering it under streaming deltas (0 on a frozen graph)."""
    if not config.streaming:
        return 0
    return max(64, int(config.stream_reserve_frac * n_closure))


def _take_rows(feat, ids: np.ndarray):
    """Rows ``ids`` of a numpy or torch ``[N, D]`` table, where it lies."""
    if isinstance(feat, torch.Tensor):
        return feat[torch.from_numpy(np.asarray(ids, np.int64)).to(feat.device)]
    return np.asarray(feat, np.float32)[ids]


# -- config and stats --------------------------------------------------------------------

def _unported(default, what: str, item: str):
    """A `DistServeConfig` field of a feature the port does not have yet:
    any value but ``default`` raises, naming ROADMAP ``item``."""
    return field(default=default, metadata={"unported": (what, item)})


@dataclass
class DistServeConfig:
    """Router knobs (per-owner engine knobs ride ``shard_config``).

    hosts          : number of owners (`comm.HostRankTable` hosts).
    max_batch      : router flush width: unique seeds a flush, before the
                     owner split.
    max_delay_ms   : flush-age policy, as `ServeConfig.max_delay_ms`.
    max_in_flight  : routed flushes in flight at once.
    exchange       : "collective" (ids and logits ride the serve exchange
                     over rank threads), "host" (direct owner calls; the
                     exchange residency's feature exchange through a
                     `LoopbackComm`) or "auto" (collective).
    budget         : per-owner seed-id lanes of the serve exchange; default
                     ``round_up_pow2(max_batch)``, so a whole flush to one
                     owner fits.
    shard_config   : the owners' `ServeConfig` (default: the router's
                     max_batch, max_delay_ms, max_in_flight, cache_entries,
                     clock and record_dispatches).
    cache_entries  : embedding-cache rows at each owner.
    router_cache_entries : the router's result-cache rows (default:
                     ``cache_entries``; 0 disables it). A repeat of a node
                     served under the current params is answered at the
                     router: no routing, no exchange bytes, no owner work.
    clock          : monotonic clock shared with the owners.
    flush_poll_ms  : background flusher poll period.
    record_dispatches : keep the router's ``(seeds, [(owner, ids)])`` log
                     (and, through the default shard config, each owner's).
    feature_residency : "closure" (each owner holds its feature closure's
                     rows, `ClosureFeature`: the fused step) or "exchange"
                     (own rows plus a per-flush feature exchange: the split
                     step). Value-identical.
    sequential_legs : accepted either way: the port runs host-mode legs one
                     after another (the JAX package's bit-parity twin of
                     its concurrent fan-out).
    late_admission : seeds arriving while a routed flush waits for its
                     window permit join it up to ``max_batch`` (and, through
                     the default shard config, the same at each owner).

    The other fields are the JAX package's fleet policies and observers
    that the port does not have yet; each must keep its default.
    """

    hosts: int = 2
    max_batch: int = 64
    max_delay_ms: float = 2.0
    max_in_flight: int = 2
    exchange: str = "auto"
    budget: Optional[int] = None
    shard_config: Optional[ServeConfig] = None
    cache_entries: int = 100_000
    router_cache_entries: Optional[int] = None
    clock: Callable[[], float] = time.monotonic
    flush_poll_ms: float = 0.2
    record_dispatches: bool = False
    feature_residency: str = "closure"
    sequential_legs: bool = False
    late_admission: bool = True
    journal_events: int = _unported(0, "the event journal", "A12")
    workload: Optional[object] = _unported(None, "workload telemetry", "A12")
    tenant_weights: Optional[Dict[str, float]] = _unported(None, "tenants", "A12")
    max_queue_depth: int = _unported(0, "shedding", "A12")
    drain_deadline_s: float = _unported(30.0, "the bounded drain", "A12")
    tier_promote_batch: int = _unported(64, "adaptive tiers", "A12")
    tier_promote_min: float = _unported(2.0, "adaptive tiers", "A12")
    tier_hysteresis: float = _unported(1.25, "adaptive tiers", "A12")
    tier_adapt_every_s: float = _unported(0.0, "adaptive tiers", "A12")
    tier_prefetch: bool = _unported(False, "flush-ahead prefetch", "A12")
    tier_prefetch_hops: Optional[int] = _unported(None, "flush-ahead prefetch", "A12")
    tier_prefetch_max_rows: int = _unported(4096, "flush-ahead prefetch", "A12")
    replicate_top_k: int = _unported(0, "the hot-set replica", "A16")
    replica_refresh_every_s: float = _unported(0.0, "the hot-set replica", "A16")
    replica_drift_frac: float = _unported(0.5, "the hot-set replica", "A16")
    hedge_deadline_ms: float = _unported(0.0, "hedged dispatch", "A16")
    full_graph_fallback: bool = _unported(False, "the full-graph failover engine", "A16")
    eject_after: int = _unported(2, "owner ejection (failover)", "A16")
    eject_backoff_flushes: int = _unported(16, "owner ejection (failover)", "A16")
    fault_injector: Optional[object] = _unported(None, "fault injection (serve/faults.py)",
                                                 "A16")
    leg_fanout: int = _unported(0, "the concurrent owner fan-out", "A16")
    migrate_batch_seeds: int = _unported(256, "the elastic fleet", "A16")
    rebalance_imbalance: float = _unported(1.5, "the elastic fleet", "A16")
    rebalance_max_seeds: int = _unported(1024, "the elastic fleet", "A16")
    rebalance_every_s: float = _unported(0.0, "the elastic fleet", "A16")
    streaming: bool = _unported(False, "streaming graphs", "A14")
    stream_reserve_frac: float = _unported(0.5, "streaming graphs", "A14")
    stream_invalidate_hops: Optional[int] = _unported(None, "streaming graphs", "A14")
    stream_replica_rebuild: bool = _unported(True, "streaming graphs", "A14")
    fenced_commits: bool = _unported(False, "zero-stall commits", "A14")

    def __post_init__(self):
        for f in fields(self):
            if "unported" in f.metadata and getattr(self, f.name) != f.default:
                what, item = f.metadata["unported"]
                raise NotImplementedError(
                    f"DistServeConfig.{f.name}={getattr(self, f.name)!r}: {what} is not ported "
                    f"yet (ROADMAP {item}); leave it at {f.default!r}")

    def resolved_shard_config(self) -> ServeConfig:
        if self.shard_config is not None:
            return self.shard_config
        return ServeConfig(max_batch=self.max_batch, max_delay_ms=self.max_delay_ms,
                           max_in_flight=self.max_in_flight, cache_entries=self.cache_entries,
                           clock=self.clock, record_dispatches=self.record_dispatches,
                           late_admission=self.late_admission)


@dataclass
class DistServeStats:
    """Router counters; `DistServeEngine.aggregate_stats` merges the owners'
    `ServeStats` beside them. ``exchange_id_bytes`` / ``exchange_logit_bytes``
    count the serve exchange's global payloads (``H*H*L`` int32 ids and
    ``H*H*L*C`` float32 logits a routed flush in collective mode)."""

    requests: int = 0
    coalesced: int = 0
    router_dispatches: int = 0
    routed_seeds: int = 0
    late_admitted: int = 0
    request_errors: int = 0
    inflight_peak: int = 0
    sub_batches: Dict[int, int] = field(default_factory=dict)
    sub_batch_seeds: Dict[int, int] = field(default_factory=dict)
    exchange_id_bytes: int = 0
    exchange_logit_bytes: int = 0
    router_cache: HitRateCounter = field(default_factory=HitRateCounter)
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    spans: SpanRecorder = field(default_factory=SpanRecorder)

    def mean_sub_batch_width(self) -> Dict[int, float]:
        return {h: self.sub_batch_seeds[h] / n for h, n in self.sub_batches.items() if n}

    def snapshot(self) -> Dict[str, object]:
        return {
            "requests": self.requests,
            "coalesced": self.coalesced,
            "router_dispatches": self.router_dispatches,
            "routed_seeds": self.routed_seeds,
            "late_admitted": self.late_admitted,
            "request_errors": self.request_errors,
            "inflight_peak": self.inflight_peak,
            "sub_batches": dict(self.sub_batches),
            "mean_sub_batch_width": self.mean_sub_batch_width(),
            "exchange_id_bytes": self.exchange_id_bytes,
            "exchange_logit_bytes": self.exchange_logit_bytes,
            "router_cache": self.router_cache.snapshot(),
            "latency": self.latency.snapshot(),
            "overlap": self.spans.overlap_summary(),
        }


class _RoutedFlush:
    """Router state of one flush between assemble and resolve. ``bucket``
    is the late-admission cap (``max_batch``: the router pads nothing);
    ``split`` is ``[(owner, ids, positions)]``, built at seal, so that
    late-admitted seeds route with their flush; ``error`` fails the whole
    flush, ``slot_errors`` (position -> exception) only the slots of an
    owner sub-batch that failed in host mode."""

    __slots__ = ("keys", "slots", "bucket", "split", "error", "slot_errors")

    def __init__(self, keys, slots):
        self.keys = keys
        self.slots = slots
        self.bucket = 0
        self.split: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.error: Optional[BaseException] = None
        self.slot_errors: Dict[int, BaseException] = {}


class DistServeEngine:
    """Seed-ownership-sharded serving front end. Typical use::

        dist = DistServeEngine.build(model, params, csr_topo, feat, sizes=[15, 10, 5],
                                     hosts=2, config=DistServeConfig(max_batch=64))
        dist.warmup()
        out = dist.predict(node_ids)     # routed, owner-served, re-merged

    The constructor takes prebuilt owner engines keyed by host (`build`
    partitions the graph and builds them). Admission, the flush policy and
    the flush itself are `ServeEngine`'s, so the two front ends make the
    same batching and cache decisions request for request."""

    def __init__(self, engines: Dict[int, ServeEngine], global2host: np.ndarray, out_dim: int,
                 config: Optional[DistServeConfig] = None, comm: Optional[TorchComm] = None,
                 shard_topo_stats: Optional[Dict[int, Dict[str, float]]] = None):
        self.config = config or DistServeConfig()
        if self.config.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        mode = self.config.exchange
        if mode not in ("auto", "collective", "host"):
            raise ValueError(f"unknown exchange mode {mode!r}")
        if mode == "auto":
            mode = "collective" if comm is not None else "host"
        if mode == "collective" and comm is None:
            raise ValueError("exchange='collective' needs a TorchComm")
        self.exchange_mode = mode
        self.engines = dict(engines)
        self.hosts = self.config.hosts
        self.global2host = np.array(global2host, np.int32, copy=True)
        self.out_dim = int(out_dim)
        self.comm = comm
        self.shard_topo_stats = shard_topo_stats or {}
        self._budget = self.config.budget or round_up_pow2(self.config.max_batch)
        self._clock = self.config.clock
        self.stats = DistServeStats()
        rc = self.config.router_cache_entries
        self.cache = EmbeddingCache(self.config.cache_entries if rc is None else rc,
                                    counters=self.stats.router_cache)
        self.params_version = 0
        self.dispatch_log: List[Tuple[np.ndarray, List[Tuple[int, np.ndarray]]]] = []
        self._pending: "OrderedDict[int, object]" = OrderedDict()
        self._inflight: Dict[int, object] = {}
        self._open: Optional[_RoutedFlush] = None  # as ServeEngine._open
        self._lock = threading.Lock()           # queue, cache version, stats
        self._fence = threading.Condition(self._lock)
        self._seq = threading.Lock()            # drain + split + dispatch log
        self._window = threading.BoundedSemaphore(self.config.max_in_flight)
        self._inflight_flushes = 0              # guarded by _lock
        self._threads: List[threading.Thread] = []
        self._running = False
        if mode == "collective":
            self.comm.static_budget = self._budget  # the serve exchange's static shape
            for h in self.engines:
                self.comm.register_serve_answerer(h, self._make_answerer(h))

    # -- construction --------------------------------------------------------------

    @classmethod
    def build(cls, model, params, csr_topo: CSRTopo, feat, sizes: Sequence[int], *, hosts: int,
              config: Optional[DistServeConfig] = None, global2host: Optional[np.ndarray] = None,
              sampler_seed: int = 0, sampler_kw: Optional[dict] = None,
              out_dim: Optional[int] = None, device=None) -> "DistServeEngine":
        """Partition ``csr_topo`` and ``feat`` (numpy or a tensor ``[N, D]``)
        by seed ownership and build the router and its ``hosts`` owner
        engines in one process, on ``device`` (the card unless the caller
        asks for the CPU). Every owner sampler is born with ``sampler_seed``,
        so each owner's key stream is a fresh single-host sampler's: the
        replay oracle replays any owner's log through a full-graph sampler.
        ``sampler_kw`` goes to every owner's `GraphSageSampler`."""
        from ..pyg.sage_sampler import GraphSageSampler

        dev = resolve_device(device)
        config = config or DistServeConfig(hosts=hosts)
        if config.hosts != hosts:
            raise ValueError(f"config.hosts={config.hosts} != hosts={hosts}")
        n = np.asarray(csr_topo.indptr).shape[0] - 1
        if global2host is None:
            global2host = contiguous_partition(n, hosts)
        global2host = np.asarray(global2host, np.int32)
        out_dim = out_dim if out_dim is not None else getattr(model, "out_dim", None)
        if out_dim is None:
            raise ValueError("pass out_dim= (the model has no out_dim attribute)")
        residency = config.feature_residency
        if residency not in ("closure", "exchange"):
            raise ValueError(f"unknown feature_residency {residency!r}")
        mode = "host" if config.exchange == "host" else "collective"
        comm = None
        if mode == "collective":
            comm = TorchComm(rank=0, world_size=hosts, hosts=hosts, device=dev)
        shard_cfg = config.resolved_shard_config()
        kw = dict(sampler_kw or {})
        # the exchange residency's feature budget: an owner forward gathers
        # up to the largest bucket's last padded n_id width, all of which
        # could be remote
        feat_budget = round_up_pow2(pad_widths(max(shard_cfg.resolved_buckets()), sizes,
                                               kw.get("caps"))[-1])
        engines: Dict[int, ServeEngine] = {}
        topo_stats: Dict[int, Dict[str, float]] = {}
        feat_comms = []
        for h in range(hosts):
            # adjacency closure: len(sizes) - 1 expansion hops; the feature
            # closure one deeper (the last hop's leaves are gathered)
            topo_h, topo_stats[h], closure_ids = _closure_shard(
                csr_topo, global2host == h, len(sizes) - 1, len(sizes))
            sampler = GraphSageSampler(topo_h, sizes=sizes, seed=sampler_seed, device=dev, **kw)
            if residency == "closure":
                local_map = np.full(n, -1, np.int32)
                local_map[closure_ids] = np.arange(closure_ids.shape[0], dtype=np.int32)
                shard_feat = ClosureFeature(_take_rows(feat, closure_ids), local_map,
                                            reserve_rows=_feat_reserve(config,
                                                                       closure_ids.shape[0]))
            else:
                owned = np.nonzero(global2host == h)[0]
                f = Feature(device=dev, device_cache_size=0)  # the owner's rows on the host
                f.from_cpu_tensor(_take_rows(feat, owned))
                f.set_local_order(owned)
                if mode == "collective":
                    fcomm = TorchComm(rank=h, world_size=hosts, hosts=hosts, device=dev)
                    fcomm.static_budget = feat_budget
                else:
                    fcomm = LoopbackComm()
                feat_comms.append(fcomm)
                info = PartitionInfo(device=dev, host=h, hosts=hosts, global2host=global2host)
                shard_feat = _ShardFeature(DistFeature(f, info, fcomm), n)
            engines[h] = ServeEngine(model, params, sampler, shard_feat, shard_cfg)
        # single controller: every feature comm holds every host's block
        for h in range(hosts):
            block = _take_rows(feat, np.nonzero(global2host == h)[0])
            for fcomm in feat_comms:
                fcomm.register_local_table(h, block)
        return cls(engines, global2host, out_dim, config=config, comm=comm,
                   shard_topo_stats=topo_stats)

    def _make_answerer(self, host: int):
        """The owner side of the serve exchange: ids arrive requester-major
        ``[H, L]`` (-1 pads); each requester's valid lanes go through the
        owner engine's whole path (cache, coalescing, micro-batching), the
        pad lanes answer zeros."""

        def answer(recv_ids: np.ndarray) -> np.ndarray:
            recv_ids = np.asarray(recv_ids)
            out = np.zeros((recv_ids.shape[0], recv_ids.shape[1], self.out_dim), np.float32)
            for req in range(recv_ids.shape[0]):
                valid = recv_ids[req] >= 0
                if valid.any():
                    ids = recv_ids[req][valid].astype(np.int64)
                    out[req, valid] = np.asarray(self.engines[host].predict(ids))
            return out

        return answer

    # -- request path: `ServeEngine`'s admission, keyed by node id ---------------------

    def submit(self, node_id: int):
        """Enqueue one request: a router-cache hit answers it outright; else
        it coalesces or waits, as in `ServeEngine.submit`."""
        return self.submit_many((node_id,))[0]

    def submit_many(self, node_ids, t=None) -> ResultBatch:
        """Admit requests in order (the whole batch is refused first if an id
        lies outside ``[0, N)``), flushing inline at every fill of
        ``max_batch``."""
        if t is not None:
            raise TypeError("t= is a temporal-serving argument; the routed temporal fleet "
                            "is not ported yet (ROADMAP A16)")
        ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        n_ids = self.global2host.shape[0]
        bad = (ids < 0) | (ids >= n_ids)
        if bad.any():
            raise ValueError(f"node id {int(ids[bad][0])} outside [0, {n_ids})")
        return self._submit_keyed_many(ids.tolist())

    # the router admits as the engine does: its extra state matters only
    # after the drain
    _submit_keyed_many = ServeEngine._submit_keyed_many
    _admit_locked = ServeEngine._admit_locked
    _drain_locked = ServeEngine._drain_locked
    flush_inline = ServeEngine.flush_inline
    results_many = ServeEngine.results_many
    should_flush = ServeEngine.should_flush
    pump = ServeEngine.pump
    flush = ServeEngine.flush
    start = ServeEngine.start
    stop = ServeEngine.stop
    _poll_loop = ServeEngine._poll_loop
    __enter__ = ServeEngine.__enter__
    __exit__ = ServeEngine.__exit__

    def predict(self, node_ids, timeout: Optional[float] = None) -> np.ndarray:
        """``[len(ids), out_dim]`` logits in request order (flushed inline
        when no background flusher runs)."""
        handles = self.submit_many(node_ids)
        if not len(handles):
            return np.zeros((0, self.out_dim), np.float32)
        self.flush_inline(handles.done)
        return self.results_many(handles, timeout)

    # -- the router's flush stages (driven by `ServeEngine.flush`) -----------------

    def _assemble(self) -> Optional[_RoutedFlush]:
        """Drain up to ``max_batch`` pending slots in arrival order and, with
        late admission on and room left, publish the flush (caller holds
        ``_seq``), as `ServeEngine._assemble`."""
        with self._lock:
            if not self._pending:
                return None
            keys, slots = self._drain_locked()
            fl = _RoutedFlush(keys, slots)
            fl.bucket = self.config.max_batch
            self._inflight_flushes += 1
            self.stats.inflight_peak = max(self.stats.inflight_peak, self._inflight_flushes)
            if self.config.late_admission and len(keys) < fl.bucket:
                self._open = fl
        return fl

    def _seal_assembled(self, fl: _RoutedFlush) -> None:
        """Close late admission, then the owner split (a stable argsort of
        the owners: hosts ascending, positions ascending within each) and
        the dispatch-log entry, in dispatch order (caller holds ``_seq``)."""
        with self._lock:
            self._open = None
        try:
            arr = np.asarray(fl.keys, np.int64)
            owners = self.global2host[arr].astype(np.int64)
            if arr.size:
                order = np.argsort(owners, kind="stable")
                cuts = np.nonzero(np.diff(owners[order]))[0] + 1
                for pos in np.split(order, cuts):
                    h = int(owners[pos[0]])
                    if 0 <= h < self.hosts:
                        fl.split.append((h, arr[pos], pos))
            if self.config.record_dispatches:
                self.dispatch_log.append((arr.copy(), [(h, ids.copy()) for h, ids, _ in fl.split]))
        except BaseException as exc:
            fl.error = exc

    def _dispatch(self, fl: _RoutedFlush) -> np.ndarray:
        """Forward the per-owner sub-batches and place the answers in
        flush-key order: one serve exchange (collective) or one owner call a
        sub-batch (host)."""
        out = np.zeros((len(fl.keys), self.out_dim), np.float32)
        if self.exchange_mode == "collective":
            by_host = {h: (ids, pos) for h, ids, pos in fl.split}
            if by_host:
                host2ids = [by_host[h][0] if h in by_host else np.array([], np.int64)
                            for h in range(self.hosts)]
                res = self.comm.exchange_serve(host2ids, out_dim=self.out_dim,
                                               budget=self._budget)
                L = self._budget
                with self._lock:
                    self.stats.exchange_id_bytes += self.hosts * self.hosts * L * 4
                    self.stats.exchange_logit_bytes += self.hosts * self.hosts * L * self.out_dim * 4
                for h, (ids, pos) in by_host.items():
                    out[pos] = res[h]
        else:
            for h, ids, pos in fl.split:
                self._owner_leg(fl, h, ids, pos, out)
        out.setflags(write=False)  # rows go to every waiter and the cache
        return out

    def _owner_leg(self, fl: _RoutedFlush, h: int, ids, pos, out) -> None:
        """One host-mode owner sub-batch; a failure resolves only its own
        slots with the error (the flush and the other sub-batches go on)."""
        try:
            out[pos] = np.asarray(self.engines[h].predict(ids))
        except Exception as exc:  # noqa: BLE001 — handed to this sub-batch's waiters
            for p in pos:
                fl.slot_errors[int(p)] = exc

    def _resolve(self, fl: _RoutedFlush, rows: Optional[np.ndarray]) -> None:
        """Resolve every slot with its row or its error, write the router
        cache, count; wakes the fence. An errored slot is never cached."""
        with self._lock:
            now = t_res0 = self._clock()
            for k in fl.keys:
                self._inflight.pop(k, None)
            errs = [fl.error or fl.slot_errors.get(i) for i in range(len(fl.keys))]
            fresh = [(k, rows[i]) for i, (k, s) in enumerate(zip(fl.keys, fl.slots))
                     if errs[i] is None and s.version == self.params_version]
            self.cache.put_many([k for k, _ in fresh], self.params_version, [r for _, r in fresh])
            for i, slot in enumerate(fl.slots):
                if errs[i] is None:
                    slot.resolve(rows[i])
                else:
                    slot.resolve(None, error=errs[i])
                    self.stats.request_errors += 1
            waits = [t0 for s in fl.slots for t0 in s.waiters]
            self.stats.latency.record_ms_many((now - np.asarray(waits, np.float64)) * 1e3)
            if fl.error is None:
                self.stats.router_dispatches += 1
                self.stats.routed_seeds += len(fl.keys)
                for h, ids, _ in fl.split:
                    self.stats.sub_batches[h] = self.stats.sub_batches.get(h, 0) + 1
                    self.stats.sub_batch_seeds[h] = self.stats.sub_batch_seeds.get(h, 0) + len(ids)
            self._inflight_flushes -= 1
            self._fence.notify_all()
            self.stats.spans.record("resolve", t_res0, self._clock())

    # -- weights, warmup, stats ----------------------------------------------------

    def update_params(self, params) -> None:
        """Fence the router (no routed flush in the air), then every owner
        through its own `ServeEngine.update_params`: no served logit crosses
        the update, and every cache is invalidated together."""
        with self._seq:
            with self._fence:
                while self._inflight_flushes:
                    self._fence.wait()
                for eng in self.engines.values():
                    eng.update_params(params)
                self.params_version += 1
                self.cache.invalidate()
                for slot in self._pending.values():
                    slot.version = self.params_version

    def warmup(self) -> Dict[int, Dict[int, float]]:
        """Warm every owner's buckets (no owner's key stream moves).
        Returns {host: {bucket: seconds}}."""
        return {h: eng.warmup() for h, eng in self.engines.items()}

    def aggregate_stats(self) -> Dict[str, object]:
        """The router's snapshot, each owner's, their merge (owner-side
        latency; the router's own ``latency`` is end to end) and each
        owner's topology shard stats."""
        merged = ServeStats()
        for h in sorted(self.engines):
            merged.merge(self.engines[h].stats)
        return {
            "router": self.stats.snapshot(),
            "per_shard": {h: self.engines[h].stats.snapshot() for h in sorted(self.engines)},
            "topology": self.shard_topo_stats,
            "shards_merged": merged.snapshot(),
        }

    def reset_stats(self) -> None:
        """Zero the router's and every owner's counters (cache contents stay)."""
        with self._lock:
            self.stats = DistServeStats()
            self.cache.counters = self.stats.router_cache
        for eng in self.engines.values():
            eng.reset_stats()


# -- the replay oracles ------------------------------------------------------------------

def _replay(engine: ServeEngine, model, params, full_sampler_factory, full_feature):
    """(node, row) for every valid lane of ``engine``'s dispatch log, in log
    order, replayed through a fresh full-graph sampler and `batch_logits`."""
    sampler = full_sampler_factory()
    bound = bind_params(model, params, sampler.device)
    for padded, nvalid in engine.dispatch_log:
        logits = batch_logits(bound, sampler, full_feature, padded).cpu().numpy()
        for i in range(nvalid):
            yield int(padded[i]), logits[i]


def replay_shard_oracle(dist: DistServeEngine, model, params,
                        full_sampler_factory: Callable[[], object],
                        full_feature) -> Dict[int, np.ndarray]:
    """Replay every owner's dispatch log through a FRESH sampler over the
    FULL graph (``full_sampler_factory`` births it like the owner samplers:
    same seed) and the offline `inference.batch_logits` over the full
    feature table; returns {node: logits row} of each node's first
    computation. Owners must record their dispatches."""
    served: Dict[int, np.ndarray] = {}
    for h in sorted(dist.engines):
        for node, row in _replay(dist.engines[h], model, params, full_sampler_factory,
                                 full_feature):
            served.setdefault(node, row)
    return served


def replay_fleet_oracle(dist: DistServeEngine, model, params,
                        full_sampler_factory: Callable[[], object],
                        full_feature) -> Dict[int, List[np.ndarray]]:
    """`replay_shard_oracle` keeping EVERY computation of every node
    ({node: [candidate rows]}); a served row is right iff it equals one
    candidate. Over the owners only (the port has no replica, fallback or
    retired engines yet)."""
    served: Dict[int, List[np.ndarray]] = {}
    for h in sorted(dist.engines):
        for node, row in _replay(dist.engines[h], model, params, full_sampler_factory,
                                 full_feature):
            served.setdefault(node, []).append(row)
    return served


__all__ = ["ClosureFeature", "DistServeConfig", "DistServeEngine", "DistServeStats",
           "LoopbackComm", "closure_masks", "contiguous_partition", "replay_fleet_oracle",
           "replay_shard_oracle", "shard_from_mask", "shard_topology_by_owner",
           "shard_topology_for_seeds"]

"""Online serving engine — the port of ``quiver_tpu/serve/engine.py``
(dynamic micro-batching, request coalescing, a params-versioned
embedding cache, pipelined dispatch).

Requests queue until ``max_batch`` unique cache-missing seeds wait or the
oldest has aged ``max_delay_ms``, then flush as one batch padded to a
fixed bucket. A flush runs three stages:

- **assemble** (under the sequencing lock): drain up to ``max_batch``
  pending slots and fix the flush's bucket; with late admission on and pad
  slack left, publish the flush so that seeds arriving while it waits for
  an in-flight window permit fill its pad lanes; then take the permit and
  seal: close admission, append the dispatch-log entry and consume the
  sampler's next key, so the key stream and the replay log see each final
  batch once, in dispatch order, however many flushes are in flight;
- **dispatch**: the fused step (sample + gather + forward,
  `inference.BucketPrograms`: on the card the bucket's captured CUDA
  graph, replayed against the `binding()` recorded at the seal) or the
  split pair (`sample_batch` in the seal, `forward_logits` here) is
  queued on the card; the logits are read back after the flush's own
  CUDA event (`inference.to_host`), so with ``max_in_flight=2`` one
  flush's host work overlaps the other's device work;
- **resolve**: cache writeback, slot resolution, latency accounting.

Admission has one body, `_admit_locked`, run request by request under
``_lock`` by `submit` and `submit_many` alike, so a batch makes the
decisions, and writes the dispatch log, of N scalar submits. The pending
queue is one insertion-ordered dict under that lock: every admission and
every drain takes the whole queue, so the JAX package's stripes
(``submit_stripes``) would add only lock traffic here.

`update_params` fences: it blocks new assembles, waits for every
in-flight flush, copies the new weights into the engine's one module in
place (the graphs were captured with it) and bumps the version. `warmup`
captures every bucket (fused, on the card; on the CPU a run on a fixed
key) or runs it through a twin sampler (split), so the serving key
stream stays untouched, then seals the fused table.

Over a streaming graph (a sampler bound to a `stream.StreamingTiledGraph`)
the engine commits graph changes while it serves: `stage_edges`,
`stage_removals` and `stage_updates` gather them in ``pending_delta``, and
`update_graph` commits them (with the sliding-window expiry of
``stream_retention_window``), `expire_edges`, `compact_graph` and
`provision_reserve` run the lifecycle. By default a commit is zero-stall:
the new device arrays are built beside the live ones (the scatters copy on
write), then flipped under ``_seq`` with a `BucketPrograms.rebind`, which
over a streaming graph captures nothing (the graphs read each flush's
graph addresses from its staged inputs); every flush logs the graph
version it sealed against (``dispatch_graph_versions``) and runs against
that epoch's arrays, and the cache refuses rows below its nodes' raised
floors. ``fenced_commits=True`` drains every in-flight flush first, the
reference's other mode, which serves the same rows and logs. A commit
that needs more reserve than is left provisions
(``stream_provision_tiles``) behind the fence and captures every bucket
anew, once.

This slice ports the single-host core. A request is admitted under a
key: the node id here, ``(node, t_bucket)`` on the temporal engine
(`quiver_tpu_torch.workloads.TemporalServeEngine`), which overrides the
hooks that turn a flush's keys into dispatch arrays (`_flush_arrays`)
and a dispatch-log entry (`_dispatch_log_entry`); this engine refuses a
temporal-bound sampler. Tenants and shedding, the journal and workload
monitor, tiers and prefetch, the metrics registry (ROADMAP A12) and the
stream's wall-clock daemons (A14's second part) wait for later slices;
with them off the JAX engine makes the same batching decisions as this
one, late admission and graph commits included, so the two write equal
dispatch logs.
"""

from __future__ import annotations

import collections.abc
import copy
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference import (
    BucketPrograms,
    bind_params,
    draw_sample_key,
    forward_logits,
    pad_seed_batch,
    sample_batch,
    strict_float32,
    to_host,
)
from ..lifecycle import RetentionPolicy
from ..stream import GraphDelta, StreamCapacityError, validate_edge_ids
from ..trace import HitRateCounter, LatencyHistogram, SpanRecorder
from .cache import EmbeddingCache


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (appended if not itself one)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


@dataclass
class ServeConfig:
    """Engine knobs (the JAX engine's meaning for each).

    max_batch      : flush when this many unique cache-missing seeds wait
                     (also the largest bucket).
    max_delay_ms   : flush a non-empty queue once its oldest request has
                     waited this long.
    buckets        : fixed batch shapes (default: powers of two up to
                     ``max_batch``).
    max_in_flight  : how many flushes may sit between assemble and
                     resolve at once.
    cache_entries  : embedding-cache capacity in rows (0 disables it).
    clock          : injectable monotonic clock (seconds); latency, spans
                     and the delay policy read only this.
    flush_poll_ms  : background flusher poll period (`start()` mode).
    record_dispatches : keep ``(padded_batch, n_valid)`` per dispatch, in
                     dispatch-index (= key-stream) order.
    dispatch_mode  : "auto" (fused when the feature can be gathered in the
                     step, else split), "fused" (error if it cannot) or
                     "split".
    late_admission : a seed arriving while an assembled flush waits for its
                     window permit rides that flush's pad lanes (up to its
                     bucket) instead of waiting for the next flush.
    submit_stripes : the JAX package's stripe count for its pending queue,
                     kept so that configs carry over; the port's queue is
                     one dict (see the module docstring), and batches and
                     dispatch logs do not depend on it there either.
    stream_invalidate_hops : reverse-closure depth of a commit's cache
                     invalidation (default ``len(sampler.sizes) - 1``: the
                     last frontier is gathered, never expanded).
    stream_adapt_tiers : the JAX package's tier pass after a commit, kept
                     so that configs carry over; no effect until the
                     engine's tier hooks are ported (ROADMAP A12).
    stream_retention_window : > 0: every commit on a temporal stream
                     expires the edges older than its clock (the largest
                     committed timestamp) minus this window, in the same
                     flip (`lifecycle.RetentionPolicy`).
    stream_compact_max_moves : a `compact_graph` pass's relocations.
    stream_compact_min_reclaim : the compaction daemon's threshold
                     (`lifecycle.CompactionPolicy`), kept so that configs
                     carry over; the daemon is not ported (below).
    stream_provision_tiles : > 0: a commit that runs out of reserve grows
                     the tile bank by this many rows and retries once.
    stream_compact_every_s, stream_retention_every_s,
    stream_retention_clock : the wall-clock lifecycle daemons, not ported
                     (ROADMAP A14, second part): only their defaults run.
    fenced_commits : False (default): zero-stall commits (built off the
                     fence, flipped under ``_seq``); True: every commit
                     drains the in-flight flushes first.
    """

    max_batch: int = 64
    max_delay_ms: float = 2.0
    buckets: Optional[Sequence[int]] = None
    max_in_flight: int = 2
    cache_entries: int = 100_000
    clock: Callable[[], float] = time.monotonic
    flush_poll_ms: float = 0.2
    record_dispatches: bool = False
    dispatch_mode: str = "auto"
    late_admission: bool = True
    submit_stripes: int = 8
    stream_invalidate_hops: Optional[int] = None
    stream_adapt_tiers: bool = True
    stream_retention_window: float = 0.0
    stream_compact_every_s: float = 0.0
    stream_compact_min_reclaim: int = 8
    stream_compact_max_moves: int = 0
    stream_provision_tiles: int = 0
    stream_retention_every_s: float = 0.0
    stream_retention_clock: Optional[Callable[[], float]] = None
    fenced_commits: bool = False

    def __post_init__(self):
        for name in ("stream_compact_every_s", "stream_retention_every_s",
                     "stream_retention_clock"):
            if getattr(self, name) not in (0.0, None):
                raise ValueError(f"ServeConfig.{name}: the stream's wall-clock lifecycle daemons "
                                 "are not ported yet (ROADMAP A14, second part); call "
                                 "compact_graph / expire_edges instead")

    def resolved_buckets(self) -> Tuple[int, ...]:
        if self.buckets is None:
            return default_buckets(self.max_batch)
        bs = tuple(sorted(int(b) for b in self.buckets))
        if not bs or bs[0] < 1:
            raise ValueError("buckets must be positive")
        if bs[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {bs[-1]} < max_batch {self.max_batch}: "
                "a full flush would not fit any bucket"
            )
        return bs


class _Slot:
    """One unique (node_id, params_version) computation; coalesced
    requests share it. ``waiters`` holds each request's submit time."""

    __slots__ = ("node_id", "version", "_event", "resolved", "value", "error",
                 "enqueue_t", "waiters")

    def __init__(self, node_id: int, version: int, enqueue_t: float):
        self.node_id = node_id
        self.version = version
        self._event = threading.Event()
        self.resolved = False
        self.value: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueue_t = enqueue_t
        self.waiters: List[float] = []

    def resolve(self, value: Optional[np.ndarray], error=None) -> None:
        self.value = value
        self.error = error
        self.resolved = True
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class ServeResult:
    """Handle returned by `ServeEngine.submit`: a value (cache hit) or a
    slot (queued computation)."""

    __slots__ = ("_slot", "_value")

    def __init__(self, slot: Optional[_Slot] = None, value: Optional[np.ndarray] = None):
        self._slot = slot
        self._value = value

    def done(self) -> bool:
        return self._slot is None or self._slot.resolved

    def error(self) -> Optional[BaseException]:
        """The flush's error once resolved, else None."""
        return None if self._slot is None else self._slot.error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The logits row (read-only: shared with the cache and every
        coalesced request). Raises the flush's error if it failed."""
        if self._slot is None:
            return self._value
        if not self._slot.wait(timeout):
            raise TimeoutError("serve request not resolved in time")
        if self._slot.error is not None:
            raise self._slot.error
        return self._slot.value


class ResultBatch(collections.abc.Sequence):
    """The handles `ServeEngine.submit_many` returns, in request order."""

    __slots__ = ("_items",)

    def __init__(self, items: List[ServeResult]):
        self._items = items

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def done(self) -> bool:
        return all(h.done() for h in self._items)

    def gather(self, timeout: Optional[float] = None) -> np.ndarray:
        """All rows as one ``[N, C]`` array in request order."""
        if not self._items:
            return np.zeros((0, 0), np.float32)
        return np.stack([h.result(timeout) for h in self._items])


@dataclass
class ServeStats:
    """Engine counters: ``requests`` counts every submit, ``coalesced``
    those attached to a pending or in-flight slot, ``late_admitted`` the
    new slots that joined an assembled flush's pad lanes, ``dispatches`` the
    device batches resolved, ``dispatch_calls``/``execute_calls`` the
    dispatch stages entered and the step calls they ran (1 per flush
    fused, 2 split), ``inflight_peak`` the most flushes seen between
    assemble and resolve; ``spans`` holds per-stage spans. Graph commits:
    ``graph_deltas`` commits, ``delta_edges`` their staged operations,
    ``delta_tile_writes``/``delta_tile_spills`` pad-lane writes against
    relocations, ``delta_cache_invalidated`` the cache entries they
    dropped, ``edges_deleted``/``edges_expired``, ``tiles_reclaimed`` and
    ``compactions``; ``commit_stall`` the serving stall a commit held, in
    milliseconds (zero-stall: the flip's ``_seq`` hold; fenced: the drain
    and the commit)."""

    requests: int = 0
    coalesced: int = 0
    late_admitted: int = 0
    dispatches: int = 0
    dispatched_seeds: int = 0
    padded_seeds: int = 0
    dispatch_calls: int = 0
    execute_calls: int = 0
    request_errors: int = 0
    graph_deltas: int = 0
    delta_edges: int = 0
    delta_tile_writes: int = 0
    delta_tile_spills: int = 0
    delta_cache_invalidated: int = 0
    edges_deleted: int = 0
    edges_expired: int = 0
    tiles_reclaimed: int = 0
    compactions: int = 0
    inflight_peak: int = 0
    dispatch_buckets: Dict[int, int] = field(default_factory=dict)
    cache: HitRateCounter = field(default_factory=HitRateCounter)
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    spans: SpanRecorder = field(default_factory=SpanRecorder)
    commit_stall: LatencyHistogram = field(
        default_factory=lambda: LatencyHistogram(min_ms=1e-5, max_ms=1e6))

    _COUNTERS = ("requests", "coalesced", "late_admitted", "dispatches", "dispatched_seeds",
                 "padded_seeds", "dispatch_calls", "execute_calls", "request_errors",
                 "graph_deltas", "delta_edges", "delta_tile_writes", "delta_tile_spills",
                 "delta_cache_invalidated", "edges_deleted", "edges_expired", "tiles_reclaimed",
                 "compactions")

    def merge(self, other: "ServeStats") -> "ServeStats":
        """Fold another engine's stats into this one (the fleet's merged
        view over its owners; merge into a fresh `ServeStats`): counters
        add, ``inflight_peak`` is the largest, the bucket counts, cache
        counters, latency histogram and spans merge. Returns self."""
        for name in self._COUNTERS:
            setattr(self, name, getattr(self, name) + getattr(other, name))
        self.inflight_peak = max(self.inflight_peak, other.inflight_peak)
        for b, n in other.dispatch_buckets.copy().items():
            self.dispatch_buckets[b] = self.dispatch_buckets.get(b, 0) + n
        self.cache.merge(other.cache)
        self.latency.merge(other.latency)
        self.spans.merge(other.spans)
        self.commit_stall.merge(other.commit_stall)
        return self

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {name: getattr(self, name) for name in self._COUNTERS}
        out.update(inflight_peak=self.inflight_peak,
                   dispatch_buckets=dict(self.dispatch_buckets),
                   cache=self.cache.snapshot(), latency=self.latency.snapshot(),
                   overlap=self.spans.overlap_summary(),
                   commit_stall=self.commit_stall.snapshot())
        return out


class _Flush:
    """Per-flush state between assemble and resolve. ``bucket`` is fixed at
    the drain; late admission appends to ``keys`` and ``slots`` up to it
    until `ServeEngine._seal_assembled` closes the flush."""

    __slots__ = ("keys", "slots", "model", "bucket", "ds", "key", "binding", "padded", "extra",
                 "error", "graph_version")

    def __init__(self, keys, slots, model):
        self.keys = keys
        self.slots = slots
        self.model = model  # the module this flush runs (weights change only under the fence)
        self.bucket = 0
        self.ds = None
        self.key = None
        self.binding = None  # the fused programs' binding() at the seal
        self.padded = None
        self.extra: Tuple[np.ndarray, ...] = ()  # per-seed arrays padded like the seeds
        self.error: Optional[BaseException] = None
        self.graph_version = 0  # the graph epoch the flush sealed against


class ServeEngine:
    """Serve node predictions from ``model`` (weights ``params``, a
    ``state_dict``; None keeps the model's own) over ``sampler`` and a
    ``[N, D]`` ``feature`` table. Typical use::

        engine = ServeEngine(model, params, sampler, feature,
                             ServeConfig(max_batch=64))
        engine.warmup()
        with engine:                      # starts the background flushers
            logits = engine.predict([node_id])[0]

    or synchronously: ``h = engine.submit(n); engine.flush(); h.result()``.
    The engine runs on the sampler's device.
    """

    # subclasses that dispatch a query time per seed set this (the
    # temporal engine, quiver_tpu_torch.workloads.TemporalServeEngine)
    _temporal_capable = False

    def __init__(self, model, params, sampler, feature,
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        if getattr(sampler, "temporal", None) is not None and not self._temporal_capable:
            raise TypeError("temporal-bound samplers need the temporal engine — use "
                            "quiver_tpu_torch.workloads.TemporalServeEngine (this engine "
                            "would dispatch without a query time)")
        if self.config.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if self.config.dispatch_mode not in ("auto", "fused", "split"):
            raise ValueError(f"unknown dispatch_mode {self.config.dispatch_mode!r}")
        self._buckets = self.config.resolved_buckets()
        self.device = sampler.device
        strict_float32()
        # the engine's own module: update_params loads weights into it in place
        self._model = bind_params(model, model.state_dict() if params is None else params,
                                  self.device)
        self._sampler = sampler
        self._feature = feature
        self._programs: Optional[BucketPrograms] = None
        if self.config.dispatch_mode != "split":
            try:
                self._programs = BucketPrograms(sampler, feature)
            except TypeError as exc:
                if self.config.dispatch_mode == "fused":
                    raise ValueError(
                        f"dispatch_mode='fused' but the serve step cannot fuse: {exc}"
                    ) from exc
        self._clock = self.config.clock
        self.stats = ServeStats()
        self.cache = EmbeddingCache(self.config.cache_entries, counters=self.stats.cache)
        self.params_version = 0
        # graph commits: the version (guarded by _seq where flushes read it),
        # the staged changes (guarded by _lock) and the retention clock
        self.graph_version = 0
        self.pending_delta = None
        self.retention = (RetentionPolicy(self.config.stream_retention_window)
                          if self.config.stream_retention_window > 0 else None)
        self.dispatch_log: List[tuple] = []
        # the graph version each logged dispatch sealed against, aligned
        # with dispatch_log
        self.dispatch_graph_versions: List[int] = []
        self._pending: "OrderedDict[int, _Slot]" = OrderedDict()
        self._inflight: Dict[int, _Slot] = {}
        # the assembled flush that takes late admissions (guarded by _lock;
        # set only while its flusher holds _seq, before its seal)
        self._open: Optional[_Flush] = None
        self._lock = threading.Lock()           # queue, cache version, stats
        self._fence = threading.Condition(self._lock)
        self._seq = threading.Lock()            # drain + dispatch log + key draw
        self._window = threading.BoundedSemaphore(self.config.max_in_flight)
        self._inflight_flushes = 0              # guarded by _lock
        # one commit at a time (re-entrant: a commit's expiry); no flush takes it
        self._commit_lock = threading.RLock()
        self._threads: List[threading.Thread] = []
        self._running = False

    # -- request path -----------------------------------------------------

    def submit(self, node_id: int) -> ServeResult:
        """Enqueue one request; a fill of ``max_batch`` flushes inline. A
        seed arriving while an assembled flush waits for its window permit
        rides that flush's pad lanes (late admission)."""
        return self.submit_many((node_id,))[0]

    def submit_many(self, node_ids, t=None) -> ResultBatch:
        """Admit requests in order (cache hit, else coalesce, else late
        admission or a new pending slot), flushing inline at every fill of
        ``max_batch``: the decisions, and so the dispatch log, of N single
        submits. ``t`` is refused here (the temporal engine takes query
        times)."""
        if t is not None:
            raise TypeError("t= is a temporal-serving argument (TemporalServeEngine); "
                            "this engine serves untimed nodes")
        return self._submit_keyed_many(np.asarray(node_ids, dtype=np.int64).reshape(-1).tolist())

    def _submit_keyed_many(self, keys: List) -> ResultBatch:
        """The admission loop behind `submit_many`: ``keys`` are the
        coalescing and cache identities (node ids, or ``(node, t_bucket)``
        on the temporal engine)."""
        n = len(keys)
        results: List[Optional[ServeResult]] = [None] * n
        max_batch = self.config.max_batch
        i = 0
        while i < n:
            need_flush = False
            now = self._clock()
            with self._lock:
                while i < n and not need_flush:
                    res = self._admit_locked(keys[i], now)
                    results[i] = res
                    i += 1
                    need_flush = res._slot is not None and len(self._pending) >= max_batch
            if need_flush:
                self.flush()
        return ResultBatch(results)

    def _admit_locked(self, key, now: float) -> ServeResult:
        """One request's cache check, coalescing and admission (caller
        holds ``_lock``). A new slot joins the open flush while it has pad
        slack (late admission), else the pending queue."""
        self.stats.requests += 1
        cached = self.cache.get(key, self.params_version)
        if cached is not None:
            self.stats.latency.record_ms((self._clock() - now) * 1e3)
            return ServeResult(value=cached)
        slot = self._pending.get(key) or self._inflight.get(key)
        if slot is not None and slot.version == self.params_version:
            self.stats.coalesced += 1
        else:
            slot = _Slot(key, self.params_version, now)
            fl = self._open
            if fl is not None and len(fl.keys) < fl.bucket:
                # the open flush's update_params fence holds: _open only
                # exists while its flusher holds _seq, so versions agree
                fl.keys.append(key)
                fl.slots.append(slot)
                self._inflight[key] = slot
                self.stats.late_admitted += 1
            else:
                self._pending[key] = slot
        slot.waiters.append(now)
        return ServeResult(slot=slot)

    def predict(self, node_ids, t=None, timeout: Optional[float] = None) -> np.ndarray:
        """Submit every id, flush inline when no background thread runs,
        and return ``[len(ids), C]`` logits in request order. ``t`` goes
        to `submit_many` (query times on the temporal engine)."""
        handles = self.submit_many(node_ids, t=t)
        if not len(handles):
            return np.zeros((0, 0), np.float32)
        self.flush_inline(handles.done)
        return self.results_many(handles, timeout)

    def flush_inline(self, done) -> None:
        """Unless a background flusher runs, flush until ``done()`` holds
        or nothing is pending."""
        if not self._running:
            while not done() and self._pending:
                self.flush()

    def results_many(self, handles, timeout: Optional[float] = None) -> np.ndarray:
        """Rows of a batch of handles as one ``[len(handles), C]`` array."""
        if isinstance(handles, ResultBatch):
            return handles.gather(timeout)
        if not len(handles):
            return np.zeros((0, 0), np.float32)
        return np.stack([h.result(timeout) for h in handles])

    # -- flush policy -----------------------------------------------------

    def should_flush(self) -> bool:
        with self._lock:
            if not self._pending:
                return False
            if len(self._pending) >= self.config.max_batch:
                return True
            oldest = next(iter(self._pending.values())).enqueue_t
        return (self._clock() - oldest) * 1e3 >= self.config.max_delay_ms

    def pump(self) -> int:
        """Flush iff ``max_batch`` or ``max_delay_ms`` demands it; returns
        the seeds dispatched (0 if the policy held)."""
        return self.flush() if self.should_flush() else 0

    # -- the three flush stages -------------------------------------------

    def _drain_locked(self) -> Tuple[List, List[_Slot]]:
        """Move up to ``max_batch`` pending slots, oldest first, into
        ``_inflight`` (caller holds ``_lock``)."""
        keys = list(itertools.islice(self._pending, self.config.max_batch))
        slots = [self._pending.pop(k) for k in keys]
        self._inflight.update(zip(keys, slots))
        return keys, slots

    def _assemble(self) -> Optional[_Flush]:
        """Drain up to ``max_batch`` pending slots and fix the bucket; with
        late admission on and pad slack left, publish the flush so that
        submits fill the slack until `_seal_assembled` closes it (caller
        holds ``_seq``)."""
        with self._lock:
            if not self._pending:
                return None
            keys, slots = self._drain_locked()
            fl = _Flush(keys, slots, self._model)
            fl.bucket = self._bucket_for(len(keys))
            self._inflight_flushes += 1
            self.stats.inflight_peak = max(self.stats.inflight_peak, self._inflight_flushes)
            if self.config.late_admission and len(keys) < fl.bucket:
                self._open = fl
        return fl

    def _seal_assembled(self, fl: _Flush) -> None:
        """Close late admission, then log the dispatch and consume the next
        key, in dispatch order (caller holds ``_seq`` and a permit): the log
        and the key stream see the final batch once. Errors are kept in
        ``fl.error`` and re-raised by `flush` after every slot of the flush
        is resolved with them."""
        with self._lock:
            self._open = None
        try:
            seeds, extras = self._flush_arrays(fl)
            padded = pad_seed_batch(seeds, fl.bucket)
            fl.extra = tuple(pad_seed_batch(e, fl.bucket) for e in extras)
            # the epoch pin: a commit flips under _seq too, so the stamp, the
            # binding below and the key are of one graph version
            fl.graph_version = self.graph_version
            if self.config.record_dispatches:
                self.dispatch_log.append(self._dispatch_log_entry(fl, padded))
                self.dispatch_graph_versions.append(fl.graph_version)
            if self._programs is not None:
                fl.key = draw_sample_key(self._sampler)
                fl.padded = padded
                # the arrays this flush runs against, whatever rebinds before it runs
                fl.binding = self._programs.binding()
            else:
                fl.ds = sample_batch(self._sampler, padded)
        except BaseException as exc:
            fl.error = exc

    # hooks the temporal engine overrides: how a flush's keys become
    # dispatch arrays and what a dispatch-log entry records
    def _flush_arrays(self, fl: _Flush):
        """``(seeds int64 [n], extra per-seed arrays)`` of ``fl.keys``;
        here the keys are the seeds."""
        return np.asarray(fl.keys, dtype=np.int64), ()

    def _dispatch_log_entry(self, fl: _Flush, padded: np.ndarray):
        return (padded.copy(), len(fl.keys))

    def _dispatch(self, fl: _Flush) -> np.ndarray:
        """Device work of one flush and its read-back (no engine lock)."""
        with self._lock:
            self.stats.dispatch_calls += 1
        if fl.ds is None and self._programs is not None:
            logits = self._programs(fl.bucket, fl.model, fl.key, fl.padded, *fl.extra,
                                    binding=fl.binding)
            n_exec = 1
        else:
            logits = to_host(forward_logits(fl.model, self._feature, fl.ds))
            n_exec = 2  # the sample ran in _seal_assembled
        with self._lock:
            self.stats.execute_calls += n_exec
        logits.setflags(write=False)  # rows go to every waiter and the cache
        return logits

    def _resolve(self, fl: _Flush, logits: Optional[np.ndarray]) -> None:
        """Resolve this flush's slots, write the cache, count; wakes the
        fence. Safe out of dispatch order."""
        with self._lock:
            now = t_res0 = self._clock()
            for k in fl.keys:
                self._inflight.pop(k, None)
            if fl.error is None:
                rows = list(logits[: len(fl.slots)])
                fresh = [(k, r) for k, r, s in zip(fl.keys, rows, fl.slots)
                         if s.version == self.params_version]
                self.cache.put_many([k for k, _ in fresh], self.params_version,
                                    [r for _, r in fresh], gv=fl.graph_version)
                for slot, row in zip(fl.slots, rows):
                    slot.resolve(row)
                self.stats.dispatches += 1
                self.stats.dispatched_seeds += len(fl.keys)
                self.stats.padded_seeds += fl.bucket - len(fl.keys)
                self.stats.dispatch_buckets[fl.bucket] = (
                    self.stats.dispatch_buckets.get(fl.bucket, 0) + 1)
            else:
                for slot in fl.slots:
                    slot.resolve(None, error=fl.error)
                self.stats.request_errors += len(fl.slots)
            waits = [t0 for s in fl.slots for t0 in s.waiters]
            self.stats.latency.record_ms_many((now - np.asarray(waits, np.float64)) * 1e3)
            self._inflight_flushes -= 1
            self._fence.notify_all()
            self.stats.spans.record("resolve", t_res0, self._clock())

    def flush(self) -> int:
        """Dispatch up to ``max_batch`` pending seeds now (policy
        bypassed); returns the seeds dispatched, late-admitted ones
        included. Synchronous on the calling thread; a stage error
        re-raises here after the flush's slots are resolved with it.
        Overlap comes from concurrent callers, up to ``max_in_flight``
        flushes; the window permit is taken under ``_seq`` after the drain,
        so seeds arriving while a flush waits for it join that flush."""
        fl = None
        have_permit = False
        try:
            with self._seq:
                t0 = self._clock()
                fl = self._assemble()
                if fl is None:
                    return 0
                self.stats.spans.record("assemble", t0, self._clock())
                try:
                    # late seeds fill the pad lanes while this waits
                    self._window.acquire()
                    have_permit = True
                    t0 = self._clock()
                    self._seal_assembled(fl)
                    self.stats.spans.record("assemble", t0, self._clock())
                finally:
                    # the seal closed admission first; this covers an
                    # interrupt between the permit and the seal
                    with self._lock:
                        self._open = None
            logits = None
            if fl.error is None:
                t0 = self._clock()
                try:
                    logits = self._dispatch(fl)
                except BaseException as exc:
                    fl.error = exc
                self.stats.spans.record("dispatch", t0, self._clock())
            self._resolve(fl, logits)
            if fl.error is not None:
                raise fl.error
            return len(fl.keys)
        finally:
            if have_permit:
                self._window.release()

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def reset_stats(self) -> None:
        """Zero every counter and re-point the cache's counter at the new
        stats (cache contents are untouched)."""
        with self._lock:
            self.stats = ServeStats()
            self.cache.counters = self.stats.cache

    # -- warmup and weights -------------------------------------------------

    def _warmup_sampler(self):
        """A twin of the serving sampler whose key stream warmup may
        consume: the same seed and config, and the same graph tensors on
        the device (no second copy of the graph is built)."""
        twin = copy.copy(self._sampler)
        twin._call = 0
        return twin

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> Dict[int, float]:
        """Build every bucket so the first real request at each does not
        pay for kernel builds, allocations or a capture: on the card the
        fused step's graph a bucket is captured (a failed capture raises).
        No serving key is consumed. The fused table is then sealed (a later
        miss raises). Returns {bucket: seconds}."""
        buckets = self._buckets if buckets is None else tuple(sorted(int(b) for b in buckets))
        with self._lock:
            model = self._model
        times: Dict[int, float] = {}
        if self._programs is not None:
            for b in buckets:
                t0 = time.perf_counter()
                self._programs.compile_bucket(b, model)
                times[b] = time.perf_counter() - t0
            self._programs.seal()
            return times
        twin = self._warmup_sampler()
        for b in buckets:
            t0 = time.perf_counter()
            to_host(forward_logits(model, self._feature, sample_batch(twin, np.zeros(b, np.int64))))
            times[b] = time.perf_counter() - t0
        return times

    def update_params(self, params) -> None:
        """Install new weights behind a fence: no new assemble, every
        in-flight flush resolved, then the weights copied into the
        engine's module in place (the captured graphs read its parameters;
        no graph is captured anew), a version bump and a cache
        invalidation. Pending slots are re-stamped to the new version."""
        with self._seq:
            with self._fence:
                while self._inflight_flushes:
                    self._fence.wait()
                self._model.load_state_dict(params)
                if self.device.type == "cuda":
                    # the copies precede every later flush on any stream
                    torch.cuda.current_stream(self.device).synchronize()
                self.params_version += 1
                self.cache.invalidate()
                for slot in self._pending.values():
                    slot.version = self.params_version

    # -- graph commits (quiver_tpu_torch.stream) ---------------------------

    def _bound_stream(self, what: str):
        stream = getattr(self._sampler, "stream", None)
        if stream is None:
            raise ValueError(f"{what} needs a stream-bound sampler — build a "
                             "stream.StreamingTiledGraph over the topology and call "
                             "sampler.bind_stream(stream) (or bind_temporal) before "
                             "constructing the engine")
        return stream

    def _node_count(self) -> Optional[int]:
        stream = getattr(self._sampler, "stream", None)
        if stream is not None:
            return stream.n
        topo = getattr(self._sampler, "csr_topo", None)
        return None if topo is None else topo.node_count

    def _stage(self, add) -> int:
        with self._lock:
            if self.pending_delta is None:
                self.pending_delta = GraphDelta()
            add(self.pending_delta)
            return len(self.pending_delta)

    def stage_edges(self, src, dst, ts=None) -> int:
        """Add edge arrivals to ``pending_delta`` (nothing moves until a
        commit). Ids are checked here against the graph's node range, and a
        temporal stream's timestamps (one an edge) too, so a bad arrival
        raises here and never reaches the buffer. Returns the staged
        operations."""
        src, dst = validate_edge_ids(src, dst, self._node_count(), "staged")
        stream = getattr(self._sampler, "stream", None)
        if stream is not None:
            if stream.temporal:
                if ts is None or np.asarray(ts).reshape(-1).shape != src.shape:
                    raise ValueError("temporal stream needs one ts per staged edge")
            elif ts is not None:
                raise ValueError("edge timestamps staged into a non-temporal stream — build "
                                 "StreamingTiledGraph(edge_ts=...) to carry them")
        return self._stage(lambda d: d.add_edges(src, dst, ts=ts))

    def stage_removals(self, src, dst) -> int:
        """Add edge deletions to ``pending_delta``; their existence is
        checked at the commit (an edge appended in the same batch may be
        removed). Returns the staged operations."""
        src, dst = validate_edge_ids(src, dst, self._node_count(), "removed")
        return self._stage(lambda d: d.remove_edges(src, dst))

    def stage_updates(self, src, dst, ts) -> int:
        """Add timestamp rewrites to ``pending_delta`` (temporal streams;
        finite ``ts``). Returns the staged operations."""
        stream = getattr(self._sampler, "stream", None)
        if stream is not None and not stream.temporal:
            raise ValueError("timestamp updates need a temporal stream "
                             "(StreamingTiledGraph(edge_ts=...)) — plain streamed tiles carry "
                             "no per-edge payload to rewrite")
        src, dst = validate_edge_ids(src, dst, self._node_count(), "updated")
        return self._stage(lambda d: d.update_edges(src, dst, ts))

    def _hops(self) -> int:
        hops = self.config.stream_invalidate_hops
        return max(len(self._sampler.sizes) - 1, 0) if hops is None else hops

    def _affected(self, stream, delta, n_edges, invalidate, expired) -> np.ndarray:
        """The nodes whose cached rows a commit makes stale: the reverse
        closure of its sources and its expired rows' sources (or
        ``invalidate``, given, with the expired rows' closure)."""
        if invalidate is not None:
            affected = np.asarray(list(invalidate), np.int64)
            if expired is not None:
                affected = np.union1d(affected,
                                      stream.affected_seeds(expired["sources"], self._hops()))
            return affected
        srcs = np.asarray(delta.sources(), np.int64) if n_edges else np.array([], np.int64)
        if expired is not None:
            srcs = np.union1d(srcs, expired["sources"])
        if not srcs.size:
            return np.array([], np.int64)
        return stream.affected_seeds(srcs, self._hops())

    def _expire_with(self, stream, delta, summary, defer: bool):
        """The commit's retention expiry (a temporal stream with a window):
        the stream's expiry summary when edges expired, else None."""
        if self.retention is None or not stream.temporal:
            return None
        cut = self.retention.cutoff_for(delta.max_ts())
        if cut is None:
            return None
        exp = stream.expire_edges(cut, defer_publish=defer)
        self.retention.mark_expired(cut)
        summary["edges_expired"] = exp["edges_expired"]
        summary["retention_cutoff"] = cut
        return exp if exp["edges_expired"] else None

    def _count_commit(self, summary, n_edges, invalidated, expired, stall_us) -> None:
        """A commit's stats (caller holds ``_lock``)."""
        st = self.stats
        if expired is not None:
            st.edges_expired += expired["edges_expired"]
        st.graph_deltas += 1
        st.delta_edges += n_edges
        st.delta_tile_writes += summary["pad_writes"]
        st.delta_tile_spills += summary["tile_spills"]
        st.delta_cache_invalidated += invalidated
        st.edges_deleted += summary.get("edges_deleted", 0)
        st.commit_stall.record_ms(stall_us / 1e3)

    def update_graph(self, delta=None, *, installs=None, invalidate=None) -> Dict[str, object]:
        """Commit a graph delta (``None``: ``pending_delta``, cleared) to the
        bound stream, bump ``graph_version`` and drop the cached rows of
        every node whose sample can reach a changed row (``invalidate``: a
        set given instead). With ``stream_retention_window`` the commit also
        expires the edges its clock has left behind. An empty commit does
        nothing. The delta is visible to every flush sealed after this
        returns; a flush sealed before it serves its own epoch and logs it
        in ``dispatch_graph_versions``.

        Zero-stall (default): the new arrays are built while flushes run,
        then flipped under ``_seq`` (`StreamingTiledGraph.publish` and a
        `BucketPrograms.rebind` that captures nothing), and the affected
        nodes' cache floors rise after the flip. ``fenced_commits=True``
        drains every in-flight flush first. A commit that needs more
        reserve than is left takes the fenced path, provisioning when
        ``stream_provision_tiles`` allows (one capture of every bucket). A
        commit that fails before the stream changed re-stages a pending
        delta."""
        stream = self._bound_stream("update_graph")
        from_pending = delta is None
        with self._lock:
            if delta is None:
                delta, self.pending_delta = self.pending_delta, None
        n_edges = 0 if delta is None else len(delta)
        if n_edges == 0 and not installs:
            return {"edges": 0, "installs": 0, "cache_invalidated": 0, "affected_seeds": 0,
                    "graph_version": self.graph_version}
        if self.config.fenced_commits:
            return self._update_graph_fenced(stream, delta, installs, invalidate, n_edges,
                                             from_pending)
        return self._update_graph_zerostall(stream, delta, installs, invalidate, n_edges,
                                            from_pending)

    def _restage(self, delta, from_pending: bool, n_edges: int, applied: bool) -> None:
        """A commit failed: a pending delta the stream never took goes back
        ahead of anything staged since (arrival order is replay order)."""
        if from_pending and n_edges and not applied:
            with self._lock:
                if self.pending_delta is not None:
                    delta.extend(self.pending_delta)
                self.pending_delta = delta

    def _wait_inflight_locked(self) -> None:
        """Wait for every in-flight flush to resolve (caller holds
        ``_fence``)."""
        while self._inflight_flushes:
            self._fence.wait()

    def _update_graph_fenced(self, stream, delta, installs, invalidate, n_edges,
                             from_pending) -> Dict[str, object]:
        applied = provisioned = False
        try:
            with self._commit_lock, self._seq:
                t_stall0 = self._clock()
                with self._fence:
                    self._wait_inflight_locked()
                    try:
                        summary = stream.apply(delta, installs=installs)
                    except StreamCapacityError:
                        if self.config.stream_provision_tiles <= 0:
                            raise
                        # grow the bank once and retry the same batch; a
                        # second failure propagates
                        stream.provision_reserve(self.config.stream_provision_tiles)
                        provisioned = True
                        summary = stream.apply(delta, installs=installs)
                    applied = True
                    self.graph_version += 1
                    expired = self._expire_with(stream, delta, summary, defer=False)
                    if self._programs is not None:
                        graph = self._sampler.fused_graph_arrays()
                        if provisioned:  # the one shape change: capture anew
                            self._programs.reprovision(graph, model=self._model)
                        else:
                            self._programs.rebind(graph=graph)
                    affected = self._affected(stream, delta, n_edges, invalidate, expired)
                    invalidated = self.cache.invalidate_nodes(affected)
                    stall_us = (self._clock() - t_stall0) * 1e6
                    self._count_commit(summary, n_edges, invalidated, expired, stall_us)
        except BaseException:
            self._restage(delta, from_pending, n_edges, applied)
            raise
        summary.update(cache_invalidated=invalidated, provisioned=provisioned,
                       affected_seeds=int(affected.size), graph_version=self.graph_version)
        return summary

    def _update_graph_zerostall(self, stream, delta, installs, invalidate, n_edges,
                                from_pending) -> Dict[str, object]:
        applied = False
        try:
            with self._commit_lock:
                try:
                    summary = stream.apply(delta, installs=installs, defer_publish=True)
                except StreamCapacityError:
                    # nothing moved: the whole commit again, fenced (it
                    # provisions and retries, or raises)
                    return self._update_graph_fenced(stream, delta, installs, invalidate,
                                                      n_edges, from_pending)
                applied = True
                new_version = self.graph_version + 1
                expired = self._expire_with(stream, delta, summary, defer=True)
                affected = self._affected(stream, delta, n_edges, invalidate, expired)
                stall_us = self._flip(stream, new_version)
                invalidated = self.cache.raise_floor(affected, new_version)
                with self._lock:
                    self._count_commit(summary, n_edges, invalidated, expired, stall_us)
        except BaseException:
            self._restage(delta, from_pending, n_edges, applied)
            raise
        summary.update(cache_invalidated=invalidated, provisioned=False,
                       affected_seeds=int(affected.size), graph_version=self.graph_version,
                       commit_stall_us=stall_us)
        return summary

    def _flip(self, stream, version: int) -> float:
        """The zero-stall commit's one serving-visible moment, under
        ``_seq``: the staged arrays go live, the version moves to
        ``version`` and the programs bind the new arrays. Returns the hold
        in microseconds."""
        with self._seq:
            t0 = self._clock()
            stream.publish()
            self.graph_version = version
            if self._programs is not None:
                self._programs.rebind(graph=self._sampler.fused_graph_arrays())
            return (self._clock() - t0) * 1e6

    def expire_edges(self, t_commit=None) -> Dict[str, object]:
        """Run retention now: advance its clock to ``t_commit`` (None keeps
        it) and expire every edge at or before ``clock - window``, one
        version bump and an invalidation of the expired rows' closure, as
        a commit of its own (zero-stall or fenced like `update_graph`).
        Returns the stream's expiry summary with ``cache_invalidated``,
        ``graph_version`` and ``retention_cutoff``."""
        stream = self._bound_stream("retention expiry")
        if not stream.temporal:
            raise ValueError("retention expiry needs a temporal stream-bound sampler "
                             "(StreamingTiledGraph(edge_ts=...) + bind_temporal)")
        if self.retention is None:
            raise ValueError("retention is off — set ServeConfig(stream_retention_window=W)")
        cut = self.retention.cutoff_for(t_commit)
        if cut is None:
            return {"edges_expired": 0, "nodes": 0, "cache_invalidated": 0,
                    "graph_version": self.graph_version}
        invalidated = 0
        if self.config.fenced_commits:
            with self._commit_lock, self._seq:
                with self._fence:
                    self._wait_inflight_locked()
                    exp = stream.expire_edges(cut)
                    self.retention.mark_expired(cut)
                    if exp["edges_expired"]:
                        self.graph_version += 1
                        if self._programs is not None:
                            self._programs.rebind(graph=self._sampler.fused_graph_arrays())
                        affected = stream.affected_seeds(exp["sources"], self._hops())
                        invalidated = self.cache.invalidate_nodes(affected)
                        self.stats.edges_expired += exp["edges_expired"]
                        self.stats.delta_cache_invalidated += invalidated
        else:
            with self._commit_lock:
                exp = stream.expire_edges(cut, defer_publish=True)
                self.retention.mark_expired(cut)
                if exp["edges_expired"]:
                    new_version = self.graph_version + 1
                    affected = stream.affected_seeds(exp["sources"], self._hops())
                    stall_us = self._flip(stream, new_version)
                    invalidated = self.cache.raise_floor(affected, new_version)
                    with self._lock:
                        self.stats.edges_expired += exp["edges_expired"]
                        self.stats.delta_cache_invalidated += invalidated
                        self.stats.commit_stall.record_ms(stall_us / 1e3)
        exp.update(cache_invalidated=invalidated, graph_version=self.graph_version,
                   retention_cutoff=cut)
        return exp

    def compact_graph(self, max_moves=None) -> Dict[str, object]:
        """One compaction pass: the plan is read under the stream's lock
        only, then applied (zero-stall: staged and flipped under ``_seq``;
        fenced: behind the drain). It changes no draw: no version bump, no
        invalidation. Returns the apply summary with ``graph_version``."""
        stream = self._bound_stream("compaction")
        if max_moves is None:
            max_moves = self.config.stream_compact_max_moves
        plan = stream.plan_compaction(max_moves=max_moves)
        if self.config.fenced_commits:
            with self._commit_lock, self._seq:
                with self._fence:
                    self._wait_inflight_locked()
                    summary = stream.apply_compaction(plan)
                    if self._programs is not None:
                        self._programs.rebind(graph=self._sampler.fused_graph_arrays())
                    self.stats.tiles_reclaimed += summary["tiles_reclaimed"]
                    self.stats.compactions += 1
        else:
            with self._commit_lock:
                summary = stream.apply_compaction(plan, defer_publish=True)
                stall_us = self._flip(stream, self.graph_version)
                with self._lock:
                    self.stats.tiles_reclaimed += summary["tiles_reclaimed"]
                    self.stats.compactions += 1
                    self.stats.commit_stall.record_ms(stall_us / 1e3)
        summary["graph_version"] = self.graph_version
        return summary

    def provision_reserve(self, tiles=None) -> Dict[str, object]:
        """Grow the tile bank by ``tiles`` rows (default
        ``stream_provision_tiles``) behind the fence, then capture every
        warmed bucket anew at the new shapes (`BucketPrograms.
        reprovision`), once, under the commit lock, so no zero-stall
        commit is between its build and its flip. Served rows do not
        change. Returns the reserve report."""
        stream = self._bound_stream("provisioning")
        if tiles is None:
            tiles = self.config.stream_provision_tiles
        if int(tiles) <= 0:
            raise ValueError(f"provision_reserve needs a positive tile count, got {tiles} (set "
                             "ServeConfig(stream_provision_tiles=...) or pass tiles=)")
        with self._commit_lock, self._seq:
            with self._fence:
                self._wait_inflight_locked()
                report = stream.provision_reserve(int(tiles))
                if self._programs is not None:
                    self._programs.reprovision(self._sampler.fused_graph_arrays(),
                                               model=self._model)
        return report

    # -- background flushers -----------------------------------------------

    def start(self) -> "ServeEngine":
        """Start ``max_in_flight`` poller threads applying the flush policy."""
        if self._running:
            return self
        self._running = True
        self._threads = [
            threading.Thread(target=self._poll_loop, name=f"quiver-serve-flusher-{i}",
                             daemon=True)
            for i in range(self.config.max_in_flight)
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the pollers; with ``drain`` flush what is still queued;
        leave no flush in flight."""
        self._running = False
        for t in self._threads:
            t.join()
        self._threads = []
        if drain:
            while self._pending:
                self.flush()
        with self._fence:
            while self._inflight_flushes:
                self._fence.wait()

    def _poll_loop(self) -> None:
        while self._running:
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — the flush resolved its waiters with the error
                pass
            time.sleep(self.config.flush_poll_ms / 1e3)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ServeConfig", "ServeEngine", "ServeResult", "ResultBatch", "ServeStats",
           "default_buckets"]

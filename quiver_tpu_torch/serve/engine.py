"""Online serving engine — the port of ``quiver_tpu/serve/engine.py``
(dynamic micro-batching, request coalescing, a params-versioned
embedding cache, pipelined dispatch).

Requests queue until ``max_batch`` unique cache-missing seeds wait or the
oldest has aged ``max_delay_ms``, then flush as one batch padded to a
fixed bucket. A flush runs three stages:

- **assemble** (under the sequencing lock): drain up to ``max_batch``
  pending slots, take an in-flight window permit, then seal: append the
  dispatch-log entry and consume the sampler's next key — so the key stream and the replay log follow
  dispatch order however many flushes are in flight;
- **dispatch**: the fused step (sample + gather + forward,
  `inference.BucketPrograms`) or the split pair (`sample_batch` in the
  seal, `forward_logits` here) is queued on the current CUDA stream; the
  logits are read back after the flush's own CUDA event
  (`inference.to_host`), so with ``max_in_flight=2`` one flush's host
  work overlaps the other's device work;
- **resolve**: cache writeback, slot resolution, latency accounting.

`update_params` fences: it blocks new assembles, waits for every
in-flight flush, swaps the weights and bumps the version. `warmup` runs
every bucket once on a fixed key (fused) or through a twin sampler
(split), so the serving key stream stays untouched.

This slice ports the single-host core. Tenants and shedding, late
admission, the journal and workload monitor, tiers and prefetch,
streaming graphs, temporal serving and the metrics registry wait for a
later slice (ROADMAP A12); with them off the JAX engine makes the same
batching decisions as this one, so the two write equal dispatch logs.
"""

from __future__ import annotations

import collections.abc
import copy
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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
    those attached to a pending or in-flight slot, ``dispatches`` the
    device batches resolved, ``dispatch_calls``/``execute_calls`` the
    dispatch stages entered and the step calls they ran (1 per flush
    fused, 2 split), ``inflight_peak`` the most flushes seen between
    assemble and resolve; ``spans`` holds per-stage spans."""

    requests: int = 0
    coalesced: int = 0
    dispatches: int = 0
    dispatched_seeds: int = 0
    padded_seeds: int = 0
    dispatch_calls: int = 0
    execute_calls: int = 0
    request_errors: int = 0
    inflight_peak: int = 0
    dispatch_buckets: Dict[int, int] = field(default_factory=dict)
    cache: HitRateCounter = field(default_factory=HitRateCounter)
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    spans: SpanRecorder = field(default_factory=SpanRecorder)


class _Flush:
    """Per-flush state between assemble and resolve."""

    __slots__ = ("keys", "slots", "model", "bucket", "ds", "key", "padded", "error")

    def __init__(self, keys, slots, model):
        self.keys = keys
        self.slots = slots
        self.model = model  # the weights snapshot this flush runs under
        self.bucket = 0
        self.ds = None
        self.key = None
        self.padded = None
        self.error: Optional[BaseException] = None


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

    def __init__(self, model, params, sampler, feature,
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        if self.config.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if self.config.dispatch_mode not in ("auto", "fused", "split"):
            raise ValueError(f"unknown dispatch_mode {self.config.dispatch_mode!r}")
        self._buckets = self.config.resolved_buckets()
        self.device = sampler.device
        strict_float32()
        self._base_model = model
        self._model = bind_params(model, params, self.device)
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
        self.dispatch_log: List[Tuple[np.ndarray, int]] = []
        self._pending: "OrderedDict[int, _Slot]" = OrderedDict()
        self._inflight: Dict[int, _Slot] = {}
        self._lock = threading.Lock()           # queue, cache version, stats
        self._fence = threading.Condition(self._lock)
        self._seq = threading.Lock()            # drain + dispatch log + key draw
        self._window = threading.BoundedSemaphore(self.config.max_in_flight)
        self._inflight_flushes = 0              # guarded by _lock
        self._threads: List[threading.Thread] = []
        self._running = False

    # -- request path -----------------------------------------------------

    def submit(self, node_id: int) -> ServeResult:
        """Enqueue one request; a fill of ``max_batch`` flushes inline."""
        return self.submit_many((node_id,))[0]

    def submit_many(self, node_ids) -> ResultBatch:
        """Admit requests in order (cache hit, else coalesce, else a new
        pending slot), flushing inline at every fill of ``max_batch`` —
        exactly where N single submits would flush."""
        keys = np.asarray(node_ids, dtype=np.int64).reshape(-1).tolist()
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

    def _admit_locked(self, key: int, now: float) -> ServeResult:
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
            self._pending[key] = slot
        slot.waiters.append(now)
        return ServeResult(slot=slot)

    def predict(self, node_ids, timeout: Optional[float] = None) -> np.ndarray:
        """Submit every id, flush inline when no background thread runs,
        and return ``[len(ids), C]`` logits in request order."""
        handles = self.submit_many(node_ids)
        if not len(handles):
            return np.zeros((0, 0), np.float32)
        if not self._running:
            while not handles.done() and self._pending:
                self.flush()
        return self.results_many(handles, timeout)

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

    def _assemble(self) -> Optional[_Flush]:
        """Drain up to ``max_batch`` pending slots (caller holds ``_seq``)."""
        with self._lock:
            if not self._pending:
                return None
            keys = []
            for k in self._pending:
                keys.append(k)
                if len(keys) == self.config.max_batch:
                    break
            slots = [self._pending.pop(k) for k in keys]
            self._inflight.update(zip(keys, slots))
            fl = _Flush(keys, slots, self._model)
            fl.bucket = self._bucket_for(len(keys))
            self._inflight_flushes += 1
            self.stats.inflight_peak = max(self.stats.inflight_peak, self._inflight_flushes)
        return fl

    def _seal_assembled(self, fl: _Flush) -> None:
        """Log the dispatch and consume the next key, in dispatch order
        (caller holds ``_seq`` and a permit). Errors are kept in
        ``fl.error`` and re-raised by `flush` after every slot of the flush
        is resolved with them."""
        try:
            padded = pad_seed_batch(np.asarray(fl.keys, dtype=np.int64), fl.bucket)
            if self.config.record_dispatches:
                self.dispatch_log.append((padded.copy(), len(fl.keys)))
            if self._programs is not None:
                fl.key = draw_sample_key(self._sampler)
                fl.padded = padded
            else:
                fl.ds = sample_batch(self._sampler, padded)
        except BaseException as exc:
            fl.error = exc

    def _dispatch(self, fl: _Flush) -> np.ndarray:
        """Device work of one flush and its read-back (no engine lock)."""
        with self._lock:
            self.stats.dispatch_calls += 1
        if fl.ds is None and self._programs is not None:
            out = self._programs(fl.bucket, fl.model, fl.key, fl.padded)
            n_exec = 1
        else:
            out = forward_logits(fl.model, self._feature, fl.ds)
            n_exec = 2  # the sample ran in _seal_assembled
        logits = to_host(out)
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
                                    [r for _, r in fresh])
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
        bypassed); returns the seeds dispatched. Synchronous on the
        calling thread; a stage error re-raises here after the flush's
        slots are resolved with it. Overlap comes from concurrent
        callers, up to ``max_in_flight`` flushes."""
        fl = None
        have_permit = False
        try:
            with self._seq:
                t0 = self._clock()
                fl = self._assemble()
                if fl is None:
                    return 0
                self.stats.spans.record("assemble", t0, self._clock())
                self._window.acquire()
                have_permit = True
                t0 = self._clock()
                self._seal_assembled(fl)
                self.stats.spans.record("assemble", t0, self._clock())
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
        """Run every bucket once so the first real request at each does
        not pay for kernel builds and allocations; no serving key is
        consumed. The fused table is then sealed (a later miss raises).
        Returns {bucket: seconds}."""
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
        in-flight flush resolved, then the swap, a version bump and a
        cache invalidation. Pending slots are re-stamped to the new
        version."""
        model = bind_params(self._base_model, params, self.device)
        with self._seq:
            with self._fence:
                while self._inflight_flushes:
                    self._fence.wait()
                self._model = model
                self.params_version += 1
                self.cache.invalidate()
                for slot in self._pending.values():
                    slot.version = self.params_version

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

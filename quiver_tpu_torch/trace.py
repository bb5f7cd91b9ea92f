"""Timing and metrics — the part of ``quiver_tpu/trace.py`` the port
uses: the scope `timer`, the aggregated `trace_scope` (on when
``QUIVER_ENABLE_TRACE`` is set) and `trace_report`, the benchmark helpers
`median_min_max` and `seps`, `SpanRecorder` (stage spans and their
measured overlap) with `export_chrome_trace` of its spans, and for serving
`LatencyHistogram` and `HitRateCounter`. Host only.

Not ported yet: ``MetricsRegistry`` and the journal and counter sources of
the Chrome trace (they come with the serving observability slice)."""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import os
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRACE_ENV = "QUIVER_ENABLE_TRACE"

_registry: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))
# one lock for the read-modify-write of a scope's totals and for
# trace_report(reset=True)'s snapshot-then-clear
_registry_lock = threading.Lock()


def trace_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "0") not in ("0", "", "false", "False")


class timer:
    """Scope timer on the host clock: ``with timer("sample") as t: ...``
    then ``t.elapsed`` (seconds). Device work must be synchronised inside
    the scope to be counted."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self) -> "timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[timer] {self.name}: {self.elapsed * 1e3:.3f} ms")


class _SyncBox:
    """Handle a scope parks its output tensors in (``box.sync = out``) so
    the scope waits for the work that makes them, not just its launch."""

    __slots__ = ("sync",)

    def __init__(self):
        self.sync = None


def _wait_for(tensors) -> None:
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def trace_scope(name: str, sync=None) -> Iterator[_SyncBox]:
    """Aggregated scope timer, a no-op unless ``QUIVER_ENABLE_TRACE`` is
    set: adds (count, seconds) to ``name``'s totals. CUDA work is queued,
    not done, when its call returns: pass the scope's output tensors as
    ``sync=`` (or assign them to the yielded box) and the scope waits for
    the current stream of their device before stopping the clock."""
    box = _SyncBox()
    box.sync = sync
    if not trace_enabled():
        yield box
        return
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        if box.sync is not None:
            _wait_for(box.sync)
        dt = time.perf_counter() - t0
        with _registry_lock:
            cnt, tot = _registry[name]
            _registry[name] = (cnt + 1, tot + dt)


def trace_report(reset: bool = False) -> Dict[str, Tuple[int, float]]:
    """``{name: (count, total_seconds)}`` of the aggregated scopes;
    ``reset=True`` snapshots and clears under one lock."""
    with _registry_lock:
        out = dict(_registry)
        if reset:
            _registry.clear()
    return out


def median_min_max(values) -> Dict[str, float]:
    """``{"median", "min", "max", "n"}`` of a numeric sequence (the median
    of an even count is the mean of the two middle values)."""
    vals = [float(v) for v in values]
    if not vals:
        raise ValueError("median_min_max needs at least one value")
    return {"median": statistics.median(vals), "min": min(vals), "max": max(vals),
            "n": len(vals)}


def seps(sampled_edges: int, seconds: float) -> float:
    """Sampled edges per second."""
    return sampled_edges / max(seconds, 1e-12)


def _snapshot_deque(dq) -> tuple:
    """Tuple copy of a deque under concurrent appends (iterating a deque
    being mutated raises RuntimeError, so retry)."""
    for _ in range(64):
        try:
            return tuple(dq)
        except RuntimeError:
            continue
    return ()


class SpanRecorder:
    """Bounded recorder of ``(stage, t0, t1)`` spans on one clock, with the
    measured concurrency of the stages (`overlap_summary`)."""

    def __init__(self, maxlen: int = 100_000):
        self._spans = collections.deque(maxlen=maxlen)

    def record(self, stage: str, t0: float, t1: float) -> None:
        self._spans.append((stage, t0, t1))

    def __iter__(self):
        return iter(_snapshot_deque(self._spans))

    def __len__(self) -> int:
        return len(self._spans)

    def __bool__(self) -> bool:
        return bool(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def merge(self, other) -> "SpanRecorder":
        """Append ``other``'s spans (a recorder or any iterable of triples);
        an overlap summary of the merged spans means something only when
        both recorders read one clock. Returns self."""
        for span in tuple(other):
            self._spans.append(span)
        return self

    def overlap_summary(self) -> dict:
        """Busy seconds per stage, the union-covered wall, ``overlap_frac``
        (share of covered wall with >= 2 stages active) and
        ``hidden_frac_measured`` ((sum of busy - covered) / sum of busy)."""
        spans = _snapshot_deque(self._spans)
        if not spans:
            return {}
        busy: Dict[str, float] = {}
        events = []
        for stage, t0, t1 in spans:
            busy[stage] = busy.get(stage, 0.0) + (t1 - t0)
            events.append((t0, 1))
            events.append((t1, -1))
        events.sort()
        covered = multi = 0.0
        depth = 0
        prev = events[0][0]
        for t, d in events:
            if depth >= 1:
                covered += t - prev
            if depth >= 2:
                multi += t - prev
            depth += d
            prev = t
        total_busy = sum(busy.values())
        return {
            "busy_s": {k: round(v, 4) for k, v in busy.items()},
            "covered_wall_s": round(covered, 4),
            "overlap_frac": round(multi / covered, 4) if covered else 0.0,
            "hidden_frac_measured": (
                round((total_busy - covered) / total_busy, 4) if total_busy else 0.0
            ),
        }


def _assign_lanes(intervals: Sequence[Tuple[float, float]]) -> List[int]:
    """Greedy interval colouring: overlapping intervals get distinct lanes."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    lane_free: List[float] = []  # lane -> the time it frees up
    lanes = [0] * len(intervals)
    for i in order:
        t0, t1 = intervals[i]
        for ln, free in enumerate(lane_free):
            if free <= t0:
                lane_free[ln] = t1
                lanes[i] = ln
                break
        else:
            lanes[i] = len(lane_free)
            lane_free.append(t1)
    return lanes


def chrome_trace_events(sources: Sequence[Tuple[str, object]]) -> List[Dict[str, object]]:
    """Chrome ``trace_events`` of span sources ``[(process_name, source)]``,
    a source being a `SpanRecorder` or any iterable of ``(stage, t0, t1)``
    triples on one clock: one pid a source, one named track a stage
    (overlapping spans of one stage fan out to numbered tracks), times
    rebased to the earliest span."""
    by_pid = [(pid, name, [tuple(s) for s in src]) for pid, (name, src) in enumerate(sources)]
    t_min = min((t0 for _, _, spans in by_pid for _, t0, _ in spans), default=0.0)
    events: List[Dict[str, object]] = []
    tids: Dict[Tuple[int, str], int] = {}

    def tid_for(pid: int, track: str) -> int:
        if (pid, track) not in tids:
            tids[(pid, track)] = sum(1 for k in tids if k[0] == pid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[(pid, track)], "args": {"name": track}})
        return tids[(pid, track)]

    for pid, name, _ in by_pid:
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": name}})
    for pid, _, spans in by_pid:
        by_stage: Dict[str, List[Tuple[float, float]]] = {}
        for stage, t0, t1 in spans:
            by_stage.setdefault(stage, []).append((t0, t1))
        for stage, iv in by_stage.items():
            for (t0, t1), lane in zip(iv, _assign_lanes(iv)):
                events.append({
                    "name": stage, "ph": "X", "ts": round((t0 - t_min) * 1e6, 3),
                    "dur": round(max(t1 - t0, 0.0) * 1e6, 3), "pid": pid,
                    "tid": tid_for(pid, stage if lane == 0 else f"{stage}/{lane}"),
                    "cat": "span",
                })
    return events


def export_chrome_trace(path: str, sources: Sequence[Tuple[str, object]],
                        metadata: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Write (when ``path`` is not empty) and return a Chrome trace JSON
    (Perfetto loads it) of the span sources; see `chrome_trace_events`."""
    doc: Dict[str, object] = {"traceEvents": chrome_trace_events(sources),
                              "displayTimeUnit": "ms"}
    if metadata:
        doc["metadata"] = metadata
    if path:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc


class LatencyHistogram:
    """Log-bucketed latency histogram: bounded memory, ``percentile``
    within one bucket (``growth`` 1.25, ~12%), exact min/max clamp the
    answer. Thread-safe."""

    def __init__(self, min_ms: float = 1e-3, max_ms: float = 6e4, growth: float = 1.25):
        if not (min_ms > 0 and max_ms > min_ms and growth > 1):
            raise ValueError("need 0 < min_ms < max_ms and growth > 1")
        nb = int(math.ceil(math.log(max_ms / min_ms) / math.log(growth))) + 1
        self._edges = [min_ms * growth ** i for i in range(nb)]
        self._edges_arr = np.asarray(self._edges, np.float64)
        self._counts = [0] * (nb + 1)  # +1: overflow bucket above max_ms
        self._lock = threading.Lock()
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0

    def record_ms(self, ms: float) -> None:
        ms = float(ms)
        i = bisect.bisect_left(self._edges, ms)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def record_ms_many(self, ms) -> None:
        """Bulk `record_ms`: same buckets, count, min and max as N scalar
        calls; ``sum_ms`` is one vector sum."""
        arr = np.asarray(ms, np.float64).reshape(-1)
        n = arr.shape[0]
        if n == 0:
            return
        binned = np.bincount(np.searchsorted(self._edges_arr, arr, side="left"),
                             minlength=len(self._counts))
        with self._lock:
            for i in np.flatnonzero(binned).tolist():
                self._counts[i] += int(binned[i])
            self.count += n
            self.sum_ms += float(arr.sum())
            self.min_ms = min(self.min_ms, float(arr.min()))
            self.max_ms = max(self.max_ms, float(arr.max()))

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]: the geometric midpoint of the p-th sample's
        bucket, clamped to the observed [min, max]."""
        if not 0 <= p <= 100:
            raise ValueError("percentile wants p in [0, 100]")
        with self._lock:
            if not self.count:
                return 0.0
            rank = max(1, math.ceil(p / 100.0 * self.count))
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    if i == 0:
                        mid = self.min_ms
                    elif i == len(self._edges):
                        mid = self.max_ms
                    else:
                        mid = math.sqrt(self._edges[i - 1] * self._edges[i])
                    return min(max(mid, self.min_ms), self.max_ms)
            return self.max_ms

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other``'s samples into this histogram (the fleet's merged
        view over its owners); both must have the same bucket edges.
        Returns self."""
        if self._edges != other._edges:
            raise ValueError("LatencyHistogram.merge needs identical bucket edges")
        with self._lock, other._lock:
            for i, c in enumerate(other._counts):
                self._counts[i] += c
            self.count += other.count
            self.sum_ms += other.sum_ms
            if other.count:
                self.min_ms = min(self.min_ms, other.min_ms)
                self.max_ms = max(self.max_ms, other.max_ms)
        return self

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_ms": self.mean_ms,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
            "min_ms": self.min_ms if self.count else 0.0,
            "max_ms": self.max_ms,
        }


class HitRateCounter:
    """Hit/miss/eviction counters of the serving cache (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def hit(self, n: int = 1) -> None:
        with self._lock:
            self.hits += n

    def miss(self, n: int = 1) -> None:
        with self._lock:
            self.misses += n

    def evict(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += n

    def merge(self, other: "HitRateCounter") -> "HitRateCounter":
        """Fold ``other``'s counts into this counter. Returns self."""
        with self._lock, other._lock:
            self.hits += other.hits
            self.misses += other.misses
            self.evictions += other.evictions
        return self

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        t = self.total
        return self.hits / t if t else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hit_rate}

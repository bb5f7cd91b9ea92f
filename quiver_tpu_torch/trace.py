"""Timing and metrics — the part of ``quiver_tpu/trace.py`` the port
uses: the scope `timer`, the benchmark helpers `median_min_max` and
`seps`, and for serving `SpanRecorder` (stage spans and their measured
overlap), `LatencyHistogram` and `HitRateCounter`. Host only."""

from __future__ import annotations

import bisect
import collections
import math
import statistics
import threading
import time
from typing import Dict

import numpy as np


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

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        t = self.total
        return self.hits / t if t else 0.0

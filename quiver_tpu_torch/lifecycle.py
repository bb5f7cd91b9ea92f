"""Graph lifecycle policies — the port of ``quiver_tpu/lifecycle.py``.

A `stream.StreamingTiledGraph` lives on through deletions, sliding-window
expiry, tile compaction and reserve growth. The mechanisms live in
`quiver_tpu_torch.stream` (they mutate tile state under its lock); this
module holds the deterministic policies that decide when each runs, so the
decisions replay from the commit stream alone:

- `RetentionPolicy(window=W)`: at a commit whose clock (the delta's largest
  staged timestamp) is ``t_commit``, expire every edge with ``ts <=
  t_commit - W``. The subtraction is float32 (`retention_cutoff`): the
  timestamps are float32 lanes, and a float64 cutoff between two adjacent
  float32 values could classify a lane differently. Expiry masks a lane's
  timestamp to ``+inf``, the bit-dual of querying the unexpired stream
  through a ``cutoff < ts <= t`` band.
- `CompactionPolicy`: compact once the reserve report shows at least
  ``min_reclaimable`` reclaimable tile rows. Compaction moves whole rows
  through the ``base`` indirection and changes no draw.
- `ProvisionPolicy`: grow the tile bank by whole banks when free rows sink
  below a floor; each growth is one shape change, paid once by the serve
  engine's `inference.BucketPrograms.reprovision`.

Every policy is a pure function of what it observes (the commit clock, the
reserve report): no wall clock, no random draw.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["CompactionPolicy", "ProvisionPolicy", "RetentionPolicy", "retention_cutoff"]


def retention_cutoff(t_commit: float, window: float) -> float:
    """``t_commit - window`` on the float32 grid: both operands snapped to
    float32, the subtraction in float32, the result returned as that
    float32 value."""
    return float(np.float32(np.float32(t_commit) - np.float32(window)))


class RetentionPolicy:
    """Sliding-window expiry for temporal streams, ``window`` in timestamp
    units. Each commit advances the clock to the largest timestamp seen (a
    late arrival never moves it back); `cutoff_for` gives the cutoff the
    engine passes to `StreamingTiledGraph.expire_edges`, or None when the
    window has not advanced past the last cutoff applied."""

    def __init__(self, window: float):
        if not (float(window) > 0.0) or not np.isfinite(window):
            raise ValueError(f"retention window must be positive and finite, got {window}")
        self.window = float(np.float32(window))
        self._clock: Optional[float] = None
        self._last_cutoff: Optional[float] = None

    def observe(self, t_commit: Optional[float]) -> None:
        """Advance the clock to ``t_commit`` (a running maximum)."""
        if t_commit is None:
            return
        t = float(np.float32(t_commit))
        if self._clock is None or t > self._clock:
            self._clock = t

    def cutoff_for(self, t_commit: Optional[float] = None) -> Optional[float]:
        """Observe ``t_commit``; the cutoff to expire at, or None when the
        window has not advanced since the last expiry."""
        self.observe(t_commit)
        if self._clock is None:
            return None
        cut = retention_cutoff(self._clock, self.window)
        if self._last_cutoff is not None and cut <= self._last_cutoff:
            return None
        return cut

    def mark_expired(self, cutoff: float) -> None:
        """Record that expiry ran at ``cutoff``."""
        if self._last_cutoff is None or cutoff > self._last_cutoff:
            self._last_cutoff = float(np.float32(cutoff))

    def state(self) -> Dict[str, Optional[float]]:
        return {"window": self.window, "clock": self._clock, "last_cutoff": self._last_cutoff}


class CompactionPolicy:
    """Compact once the reserve report shows at least ``min_reclaimable``
    reclaimable tile rows; ``max_moves`` bounds a pass's relocations (0:
    reclaim only)."""

    def __init__(self, min_reclaimable: int = 8, max_moves: int = 0):
        self.min_reclaimable = max(int(min_reclaimable), 1)
        self.max_moves = max(int(max_moves), 0)

    def should_compact(self, report: Dict[str, object]) -> bool:
        return int(report.get("reclaimable_tiles", 0)) >= self.min_reclaimable


class ProvisionPolicy:
    """Grow the tile bank by ``bank_tiles`` rows whenever fewer than
    ``min_free_tiles`` rows are free."""

    def __init__(self, bank_tiles: int, min_free_tiles: int = 0):
        if int(bank_tiles) <= 0:
            raise ValueError(f"bank_tiles must be positive, got {bank_tiles}")
        self.bank_tiles = int(bank_tiles)
        self.min_free_tiles = max(int(min_free_tiles), 0)

    def should_provision(self, report: Dict[str, object]) -> bool:
        return int(report.get("reserve_free", 0)) < self.min_free_tiles

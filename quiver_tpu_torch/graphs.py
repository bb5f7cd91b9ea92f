"""What the port's captured steps share: `inference.BucketPrograms` (the
serve step, a graph a bucket) and `train_programs.TrainPrograms` (a
training step, a graph a signature).

- `byte_fields` / `byte_views` / `stage`: a call's host inputs packed into
  one byte buffer of typed, 8-byte aligned fields, so that one
  host-to-device copy fills a graph's static inputs.
- `capture`: the capture itself (``capture_error_mode="thread_local"``),
  with the wrappers' launches tallied by stream
  (`_kernels.begin_capture_tally`): they go to the graph's `Tally` and not
  to `_kernels.counts`, which then holds only launches that ran.
- `GraphBook`: the tallies of an object's captures, one a capture, kept
  after the graph is gone; a path's launches are each tally times its
  replays (`replayed_launches`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _kernels

Field = Tuple[int, int, torch.dtype, Tuple[int, ...]]


def byte_fields(specs: Sequence[Tuple[torch.dtype, Tuple[int, ...]]]) -> Tuple[List[Field], int]:
    """The byte layout of ``specs`` ``[(dtype, shape)]``: ``[(offset,
    bytes, dtype, shape)]``, each 8-byte aligned, and the total bytes (at
    least 8)."""
    fields, off = [], 0
    for dtype, shape in specs:
        n = int(np.prod(shape)) * dtype.itemsize
        fields.append((off, n, dtype, tuple(shape)))
        off += -(-n // 8) * 8
    return fields, max(off, 8)


def byte_views(buf: torch.Tensor, fields: Sequence[Field]):
    """Typed views of a byte buffer laid out by `byte_fields`."""
    return tuple(buf[o:o + n].view(dtype).view(shape) for o, n, dtype, shape in fields)


def stage(values, fields: Sequence[Field], nbytes: int, pin: bool) -> torch.Tensor:
    """One host byte buffer (pinned with ``pin``) holding ``values``,
    numpy arrays already in their fields' dtypes, at their fields."""
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    for (o, n, _, _), v in zip(fields, values):
        raw[o:o + n] = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
    return buf


class Tally:
    """What one captured graph launches and how often it ran: the
    wrappers' launch counts captured on its stream, the kernels the
    process launched during the capture (`_kernels.kernel_launches`, other
    threads' included), the capture's seconds and the replays since."""

    __slots__ = ("counts", "kernels", "seconds", "replays")

    def __init__(self, counts: Dict[str, int], kernels: int, seconds: float):
        self.counts, self.kernels, self.seconds, self.replays = counts, kernels, seconds, 0


def end_failed_capture(graph) -> None:
    """End a capture whose step raised; the step's error is the one the
    caller sees, so the capture's own (an invalidated capture) is
    dropped."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


def capture(graph, stream, fn: Callable):
    """Capture ``fn()`` into ``graph`` on ``stream``, which the caller has
    made current. Returns ``(fn's result, its Tally)``; if ``fn`` raises,
    the capture is ended and the error passes on. ``thread_local``: other
    threads copying, launching or replaying on their own streams meanwhile
    (a pipeline's stages, a flush) are no error of this capture."""
    kernels0 = _kernels.kernel_launches()
    t0 = time.perf_counter()
    _kernels.begin_capture_tally(stream.cuda_stream)
    try:
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            end_failed_capture(graph)
            raise
        graph.capture_end()
    finally:
        counts = _kernels.end_capture_tally(stream.cuda_stream)
    return out, Tally(counts, _kernels.kernel_launches() - kernels0, time.perf_counter() - t0)


class GraphBook:
    """The tallies of an object's captures, one a capture, kept after its
    graph is gone."""

    def __init__(self):
        self._tallies: List[Tally] = []

    def _record(self, tally: Tally) -> Tally:
        self._tallies.append(tally)
        return tally

    def replayed_launches(self) -> Dict[str, int]:
        """Launches of each kernel the replays made since the last
        `reset_replays`: each graph's captured launches times its replays
        (`_kernels.counts` holds only eager launches)."""
        out: Dict[str, int] = {}
        for t in self._tallies:
            for name, c in t.counts.items():
                out[name] = out.get(name, 0) + c * t.replays
        return out

    def reset_replays(self) -> None:
        for t in self._tallies:
            t.replays = 0

    @staticmethod
    def pool_bytes(graphs) -> int:
        """The bytes of the reserved segments of ``graphs``' memory pools
        on the card."""
        pools = {tuple(g.pool()) for g in graphs}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

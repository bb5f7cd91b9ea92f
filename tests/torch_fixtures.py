"""Fixtures shared by the port's tests (tests/test_torch_*.py)."""

import threading
import time

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none.
    Decided here at run time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def run_in_child(target, *args, timeout=120):
    """Run ``target(*args, queue)`` in one ``spawn`` child (its arguments
    travel through ``ForkingPickler``: the port's reducers where imported)
    and return what it put as ``("ok", value)``; fail with the traceback it
    put as ``("error", text)``. Every wait has a timeout, and a child still
    alive after its join is killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=target, args=(*args, q))
    p.start()
    try:
        status, out = q.get(timeout=timeout)
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not p.is_alive() and p.exitcode == 0, p.exitcode
    assert status == "ok", out
    return out


def prob_kernel_order(tindptr, tsrc, w, lane_items, seq_span):
    """``csrc/prob.cu``'s additions (K11) replayed in numpy float32 over
    the transposed graph (``tindptr [N+1]``, ``tsrc [E]``) and the weights
    ``w [N]``: the merge of node ends and edges cut into ranges of 32 x
    ``lane_items`` items; in a range, each lane's sequential sum over its
    items, the inclusive segmented scan over the lanes (Kogge-Stone, 5
    levels), one addition of a lane's part to the earlier lanes'; then the
    parts of a node that crosses ranges, in range order, one by one up to
    ``seq_span`` parts, else strided over 32 lanes and a butterfly.
    Returns ``(next [N] float32, start [n_ranges + 1, 2])``, the second the
    (node, edge) where each range starts."""
    f32 = np.float32
    tindptr = np.asarray(tindptr, np.int64)
    n, E = tindptr.shape[0] - 1, int(np.asarray(tsrc).shape[0])
    IW = 32 * lane_items
    total = n + E
    n_ranges = -(-total // IW)
    d = np.minimum(np.arange(n_ranges + 1, dtype=np.int64) * IW, total)
    cv = np.searchsorted(np.arange(n) + tindptr[1:], d, side="left")  # ends before d
    ce = d - cv
    vals = np.asarray(w, f32)[np.asarray(tsrc, np.int64)]
    out = np.zeros(n, f32)
    head = np.zeros(n_ranges, f32)
    tail = np.zeros(n_ranges, f32)
    for r in range(n_ranges):
        v0, e0 = int(cv[r]), int(ce[r])
        n_rows, n_e = int(cv[r + 1]) - v0, int(ce[r + 1]) - e0
        rend = np.append(tindptr[v0 + 1: v0 + 1 + n_rows] - e0, n_e)
        c, f, h = np.zeros(32, f32), np.zeros(32, bool), np.zeros(32, f32)
        first = np.zeros(32, np.int64)
        for lane in range(32):
            dd = lane * lane_items
            i = int(np.sum(np.arange(n_rows) + rend[:n_rows] < dd))
            first[lane], j = i, dd - i
            acc, ends = f32(0), False
            for t in range(lane_items):
                if dd + t >= n_rows + n_e:
                    break
                if j < rend[i]:
                    acc = f32(acc + vals[e0 + j])
                    j += 1
                else:
                    if ends:
                        out[v0 + i] = acc
                    else:
                        h[lane], ends = acc, True
                    acc = f32(0)
                    i += 1
            if not ends:
                h[lane] = acc
            c[lane], f[lane] = acc, ends
        ends = f.copy()
        off = 1
        while off < 32:
            c2, f2 = c.copy(), f.copy()
            for lane in range(off, 32):
                if not f[lane]:
                    c2[lane] = f32(c[lane - off] + c[lane])
                f2[lane] = f[lane] or f[lane - off]
            c, f = c2, f2
            off *= 2
        for lane in np.nonzero(ends)[0]:
            s = f32((c[lane - 1] if lane else f32(0)) + h[lane])
            if first[lane] == 0 and tindptr[v0] < e0:
                head[r] = s
            else:
                out[v0 + first[lane]] = s
        tail[r] = c[31]
    for r in range(n_ranges):
        v = int(cv[r])
        start = int(tindptr[v])
        if not (start < ce[r] and v < cv[r + 1]):
            continue
        ra = (v + start) // IW
        parts = [tail[q] for q in range(ra, r)] + [head[r]]
        if len(parts) <= seq_span:
            acc = f32(0)
            for p in parts:
                acc = f32(acc + p)
        else:
            lanes = np.zeros(32, f32)
            for i, p in enumerate(parts):
                lanes[i % 32] = f32(lanes[i % 32] + p)
            for off in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ off]).astype(f32)
            acc = lanes[0]
        out[v] = acc
    return out, np.stack([cv, ce], axis=1)


class DispatchGate:
    """Holds every call of an engine's dispatch stage (``_dispatch``, which
    a flush enters holding its window permit) until `release` lets the
    next one run, in arrival order. The lever of the late-admission tests,
    on either package's engines and routers alike."""

    def __init__(self, engine):
        self._inner = engine._dispatch
        engine._dispatch = self
        self._cv = threading.Condition()
        self.arrived = self.allowed = self.done = 0

    def __call__(self, fl):
        with self._cv:
            me = self.arrived
            self.arrived += 1
            self._cv.notify_all()
            self._cv.wait_for(lambda: self.allowed > me)
        try:
            return self._inner(fl)
        finally:
            with self._cv:
                self.done += 1
                self._cv.notify_all()

    def wait_arrived(self, n: int, timeout: float = 60.0) -> None:
        with self._cv:
            assert self._cv.wait_for(lambda: self.arrived >= n, timeout), \
                f"only {self.arrived} of {n} dispatches arrived"

    def release(self, timeout: float = 60.0) -> None:
        """Let the next held dispatch run, once it has arrived, and wait
        until it returns."""
        with self._cv:
            n = self.allowed + 1
            assert self._cv.wait_for(lambda: self.arrived >= n, timeout), "no dispatch came"
            self.allowed = n
            self._cv.notify_all()
            assert self._cv.wait_for(lambda: self.done >= n, timeout), "a dispatch hung"

    def open(self) -> None:
        with self._cv:
            self.allowed = 1 << 60
            self._cv.notify_all()


def gated_late_run(engine, submit, mif, stalled, waiting, late, submit_late=None):
    """The late-admission trace: each of the ``mif`` batches of ``stalled``
    is flushed from a thread and held in its dispatch stage with a window
    permit; then ``waiting`` is flushed from a thread, which drains it,
    publishes the open flush and waits for a permit; ``late`` arrives then
    (through ``submit_late``, default ``submit``); then the held dispatches
    run one at a time in order, and whatever is still pending is flushed.
    ``submit(engine, requests)`` returns handles. Returns all the handles
    in request order."""
    gate = DispatchGate(engine)
    handles, threads = [], []

    def flush_in_thread():
        t = threading.Thread(target=engine.flush, daemon=True)
        t.start()
        threads.append(t)

    for i, batch in enumerate(stalled[:mif]):
        handles += submit(engine, batch)
        flush_in_thread()
        gate.wait_arrived(i + 1)
    handles += submit(engine, waiting)
    flush_in_thread()
    deadline = time.monotonic() + 60
    while engine._open is None:
        assert time.monotonic() < deadline, "the waiting flush never opened"
        time.sleep(0.002)
    handles += (submit_late or submit)(engine, late)
    for _ in range(mif + 1):
        gate.release()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    gate.open()
    while engine.flush():
        pass
    return handles

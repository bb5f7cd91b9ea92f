"""Hybrid device + CPU sampling — the port of
``quiver_tpu/pyg/mixed_sampler.py`` (``SampleJob``, ``TrainSampleJob``, the
CPU worker loop and ``MixedGraphSageSampler``), the reference's
``MixedGraphSageSampler``.

An epoch's tasks (seed batches) are split between the device sampler, which
samples inline on the card (or, in ``HOST_CPU_MIXED``, with the host engine
in this process), and spawned CPU worker processes that each run the native
host engine (`ops.cpu_kernels.HostSampler`) over the CSR, and the per-edge
weights when weighted, attached through ``multiprocessing.shared_memory``.
Every epoch re-decides the split from the measured average time a task on
each side (`MixedGraphSageSampler.decide_task_num`).

Workers are spawned, never forked, and never touch CUDA: they import the
port's package (which builds nothing when imported), draw on the host and
send numpy arrays back; the parent puts each result on its device. Each
worker has its own task and result queues, and a daemon drainer thread a
worker pumps its results into one in-process inbox, so a worker killed
mid-message poisons only its own queues; its pending tasks go to the
survivors, results of an older epoch are dropped, and the pool heals at
the next epoch.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..utils import CSRTopo, _best_id_dtype, resolve_device
from .sage_sampler import DenseSample, GraphSageSampler, host_dense_sample

# posted on a worker's result queue, by the worker as it exits or by
# shutdown, so that worker's drainer thread returns instead of blocking
_DRAIN_DONE = ("__qt_drain_done__",)


class SampleJob:
    """An indexable, shuffleable task list: each task a seed batch."""

    def __getitem__(self, index: int):
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class TrainSampleJob(SampleJob):
    """The train ids shuffled an epoch (``default_rng(seed)``), cut into
    batches of ``batch_size`` (the last one shorter)."""

    def __init__(self, train_idx: np.ndarray, batch_size: int, seed: int = 0):
        self.train_idx = np.asarray(train_idx, np.int64).copy()
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def shuffle(self) -> None:
        self._rng.shuffle(self.train_idx)

    def __len__(self) -> int:
        return (len(self.train_idx) + self.batch_size - 1) // self.batch_size

    def __getitem__(self, index: int):
        lo = index * self.batch_size
        return self.train_idx[lo: lo + self.batch_size]


def _cpu_worker_loop(shm_names, shapes, sizes, caps, seed, task_q, result_q, weights_shm=None):
    """A worker process: attach the CSR (and ``weights_shm``'s ``(name,
    shape)`` float32 weights) from shared memory, then sample each task
    ``(epoch, task_idx, seeds)`` with RNG seed ``seed + epoch * 1009 +
    task_idx`` and post ``(epoch, task_idx, n_id, count, adjs, seconds)``
    until a None task."""
    from multiprocessing import shared_memory

    from ..ops.cpu_kernels import HostSampler

    shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
    indptr = np.ndarray(shapes[0], dtype=np.int64, buffer=shms[0].buf)
    indices = np.ndarray(shapes[1], dtype=np.int64, buffer=shms[1].buf)
    weights = None
    if weights_shm is not None:
        shms.append(shared_memory.SharedMemory(name=weights_shm[0]))
        weights = np.ndarray(weights_shm[1], np.float32, buffer=shms[-1].buf)
    eng = HostSampler(indptr, indices, weights=weights)
    try:
        while True:
            item = task_q.get()
            if item is None:
                return
            epoch, task_idx, seeds = item
            t0 = time.perf_counter()
            n_id, count, adjs = eng.sample_multilayer(np.asarray(seeds, np.int64), sizes,
                                                      seed + epoch * 1009 + task_idx, caps)
            result_q.put((epoch, task_idx, n_id, count, adjs, time.perf_counter() - t0))
    finally:
        try:
            result_q.put(_DRAIN_DONE)
        except (OSError, ValueError):
            pass
        del eng, indptr, indices, weights
        for shm in shms:
            shm.close()


class MixedGraphSageSampler:
    """Adaptive device + CPU k-hop sampler.

    ``mode``: "GPU_CPU_MIXED" (the card and the workers), "HOST_CPU_MIXED"
    (the host engine in this process and the workers), "GPU_ONLY" or
    "CPU_ONLY"; the JAX package's spellings are accepted ("TPU_CPU_MIXED",
    "TPU_ONLY", and the reference's "UVA_CPU_MIXED", an alias of
    HOST_CPU_MIXED, and "UVA_ONLY", an alias of GPU_ONLY: unlike
    ``GraphSageSampler(mode="UVA")``, which samples on the host).
    ``device`` is the device sampler's, and where every sample lands
    (default CUDA). Iterating yields ``(task_idx, DenseSample)`` for every
    task of one epoch (the job reshuffled each epoch), the device's tasks
    in order with the workers' results as they arrive. A device task draws
    with the device sampler's next call; CPU task ``t`` of epoch ``e`` with
    RNG seed ``seed + 7919 * s + e * 1009 + t``, ``s`` the spawn count of
    the worker that ran it.

    ``weighted=True`` draws both halves by the topology's edge weights.
    The card weights only a row's first ``max_deg`` edges and the workers
    all of them, so GPU_CPU_MIXED with workers refuses a graph whose
    largest degree exceeds ``max_deg``; HOST_CPU_MIXED, whose device half
    is the host engine, is exempt.
    """

    MODES = ("GPU_CPU_MIXED", "HOST_CPU_MIXED", "GPU_ONLY", "CPU_ONLY")
    MODE_ALIASES = {"TPU_CPU_MIXED": "GPU_CPU_MIXED", "UVA_CPU_MIXED": "HOST_CPU_MIXED",
                    "TPU_ONLY": "GPU_ONLY", "UVA_ONLY": "GPU_ONLY"}

    def __init__(self, job: SampleJob, csr_topo: CSRTopo, sizes: Sequence[int],
                 num_workers: int = 2, device=None, mode: str = "GPU_CPU_MIXED",
                 caps: Optional[Sequence[Optional[int]]] = None, seed: int = 0,
                 auto_tune_workers: bool = False, device_share_target: float = 0.5,
                 weighted: bool = False, max_deg: int = 512):
        mode = self.MODE_ALIASES.get(mode, mode)
        if mode not in self.MODES:
            raise ValueError(f"unsupported mode: {mode}")
        if mode == "CPU_ONLY" and num_workers < 1:
            raise ValueError("CPU_ONLY mode needs num_workers >= 1")
        if weighted and csr_topo.edge_weights is None:
            raise ValueError("weighted=True needs CSRTopo(edge_weights=...) "
                             "(per-edge weights aligned with the COO input)")
        if weighted and mode == "GPU_CPU_MIXED" and num_workers > 0:
            graph_max_deg = int(np.max(np.diff(csr_topo.indptr))) if len(csr_topo.indptr) > 1 \
                else 0
            if graph_max_deg > max_deg:
                raise ValueError(
                    f"weighted MIXED sampling needs max_deg >= the graph's max degree "
                    f"({graph_max_deg}; got max_deg={max_deg}): the card weights only the "
                    f"first max_deg edges of a row while the CPU workers weight all of them, "
                    f"so the two halves of one epoch would sample different distributions. "
                    f"Raise max_deg, or use CPU_ONLY/GPU_ONLY.")
        self.num_workers = num_workers if "MIXED" in mode or mode == "CPU_ONLY" else 0
        if self.num_workers and _best_id_dtype(csr_topo.node_count + 1) != np.int32:
            raise ValueError(f"a host-sampled batch carries int32 node ids; this graph has "
                             f"{csr_topo.node_count} nodes (int64 node ids: ROADMAP B4)")
        self.job = job
        self.csr_topo = csr_topo
        self.sizes = tuple(int(s) for s in sizes)
        self.caps = None if caps is None else tuple(caps)
        self.mode = mode
        self.seed = seed
        self.weighted = bool(weighted)
        self.device = resolve_device(device)
        self.device_sampler = None if mode == "CPU_ONLY" else GraphSageSampler(
            csr_topo, sizes, device=self.device, mode="HOST" if mode.startswith("HOST") else "GPU",
            caps=caps, seed=seed, weighted=weighted, max_deg=max_deg)
        self._workers = []
        self._task_qs = None
        self._result_qs = None
        self._inbox = None
        self._shms = []
        self._drainers = []
        self._spawn_count = 0
        self._epoch = 0
        # the averages behind the split (exponential, 0.9 old / 0.1 new)
        self.avg_device_time = 0.0
        self.avg_cpu_time = 0.0
        self.auto_tune_workers = auto_tune_workers and "MIXED" in mode
        self.device_share_target = float(device_share_target)
        self.last_device_share = None  # the device's share of the last epoch's tasks

    # -- the worker pool ---------------------------------------------------------

    def _spawn_worker(self, slot: int) -> None:
        """Start, or replace with fresh queues, the worker in ``slot`` and
        its drainer thread. Only drainer threads read a worker's result
        pipe: a worker killed mid-put leaves a partial message that blocks
        its reader for good, and that strands one daemon thread, never the
        caller."""
        ctx = mp.get_context("spawn")
        self._task_qs[slot] = ctx.Queue()
        result_q = ctx.Queue()
        self._result_qs[slot] = result_q
        self._spawn_count += 1
        shm_names, shapes, weights_shm = self._worker_shm_args
        p = ctx.Process(target=_cpu_worker_loop,
                        args=(shm_names, shapes, self.sizes, self.caps,
                              self.seed + 7919 * self._spawn_count, self._task_qs[slot],
                              result_q, weights_shm),
                        daemon=True)
        p.start()
        self._workers[slot] = p
        inbox = self._inbox

        def drain():
            try:
                while True:
                    item = result_q.get()
                    if item == _DRAIN_DONE:
                        return
                    inbox.put(item)
            except (OSError, EOFError, ValueError):
                return  # the queue was closed or poisoned

        th = threading.Thread(target=drain, name=f"qt-mixed-drain-{slot}", daemon=True)
        th.start()
        self._drainers.append(th)

    def lazy_init(self) -> None:
        """Start the pool (the CSR into shared memory, the workers), or
        respawn any worker that died since the last epoch."""
        if self.num_workers == 0:
            return
        if self._workers:
            for slot, p in enumerate(self._workers):
                if not p.is_alive():
                    self._spawn_worker(slot)
            return
        from multiprocessing import shared_memory

        from ..ops.cpu_kernels import _load_native

        _load_native()  # build the engine once here, and fail here if it cannot be
        self._task_qs = [None] * self.num_workers
        self._result_qs = [None] * self.num_workers
        self._workers = [None] * self.num_workers
        self._inbox = queue_mod.Queue()
        shm_names, shapes = [], []
        arrays = [(self.csr_topo.indptr, np.int64), (self.csr_topo.indices, np.int64)]
        if self.weighted:
            arrays.append((self.csr_topo.edge_weights, np.float32))
        for arr, dt in arrays:
            arr = np.ascontiguousarray(arr, dt)
            shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
            self._shms.append(shm)
            np.ndarray(arr.shape, dt, buffer=shm.buf)[:] = arr
            shm_names.append(shm.name)
            shapes.append(arr.shape)
        weights_shm = (shm_names[2], shapes[2]) if self.weighted else None
        self._worker_shm_args = (shm_names[:2], shapes[:2], weights_shm)
        for w in range(self.num_workers):
            self._spawn_worker(w)

    def shutdown(self) -> None:
        """Stop the workers (a None task, then terminate after 5 s), retire
        the drainers, and close and unlink the shared memory."""
        # a slot stays None where lazy_init failed before spawning it
        workers = [p for p in self._workers if p is not None]
        if self._task_qs is not None:
            for q, p in zip(self._task_qs, self._workers):
                if p is not None and p.is_alive():
                    q.put(None)
        for p in workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in self._result_qs or []:  # a terminated worker posted no sentinel
            if q is None:
                continue
            try:
                q.put(_DRAIN_DONE)
            except (OSError, ValueError):
                pass
        for th in self._drainers:  # one wedged on a torn message stays, a daemon
            th.join(timeout=5)
        self._drainers = [th for th in self._drainers if th.is_alive()]
        # never let the interpreter's exit join these queues' feeder threads:
        # a dead worker's task queue can hold items no one will read
        for q in (self._task_qs or []) + (self._result_qs or []):
            if q is not None:
                q.cancel_join_thread()
        self._workers = []
        self._task_qs = None
        self._result_qs = None
        self._inbox = None
        for shm in self._shms:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # interpreter teardown: the modules may be gone
            pass

    # -- the split ---------------------------------------------------------------

    def decide_task_num(self, total: int) -> int:
        """The number of this epoch's ``total`` tasks the device takes: all
        or none in the single-sided modes, half in the first epoch, then
        ``total * dev_rate / (dev_rate + cpu_rate)`` with ``dev_rate = 1 /
        avg_device_time`` and ``cpu_rate = num_workers / avg_cpu_time``."""
        if self.mode == "CPU_ONLY":
            return 0
        if self.num_workers == 0 or self.mode == "GPU_ONLY":
            return total
        if self.avg_device_time <= 0 or self.avg_cpu_time <= 0:
            return max(total // 2, 1)
        device_rate = 1.0 / self.avg_device_time
        cpu_rate = self.num_workers / self.avg_cpu_time
        return int(round(total * device_rate / (device_rate + cpu_rate)))

    def _update_avg(self, attr: str, dt: float) -> None:
        prev = getattr(self, attr)
        setattr(self, attr, dt if prev == 0 else 0.9 * prev + 0.1 * dt)

    def suggest_num_workers(self, device_share_target: Optional[float] = None,
                            max_workers: Optional[int] = None) -> int:
        """The worker count that brings the device's share of the tasks to
        ``device_share_target`` (default the sampler's) at the measured
        averages: ``w = avg_cpu * (1 - t) / (t * avg_dev)``, clipped to
        ``[1, max_workers]`` (default the host's cores); the current count
        before any measurement or for a target outside (0, 1)."""
        t = self.device_share_target if device_share_target is None else device_share_target
        if self.avg_device_time <= 0 or self.avg_cpu_time <= 0 or not 0 < t < 1:
            return self.num_workers
        if max_workers is None:
            max_workers = max(os.cpu_count() or 1, 1)
        w = self.avg_cpu_time * (1.0 - t) / (t * self.avg_device_time)
        return int(np.clip(round(w), 1, max_workers))

    def _maybe_retune_workers(self) -> None:
        """With ``auto_tune_workers``: a new pool of `suggest_num_workers`
        between epochs when the count should change."""
        if not self.auto_tune_workers:
            return
        want = self.suggest_num_workers()
        if want != self.num_workers and self._workers:
            self.shutdown()
            self.num_workers = want

    def _to_dense(self, n_id, count, adjs) -> DenseSample:
        batch = int(adjs[0]["n_dst"]) if adjs else 0
        return host_dense_sample(n_id, count, adjs, batch, self.device)

    def _wait_device(self, ds: DenseSample) -> None:
        """Wait for the device sampler's work (its launches, or a host
        sample's copy to the card) queued on the current stream."""
        if ds.n_id.is_cuda:
            torch.cuda.current_stream(ds.n_id.device).synchronize()

    # -- an epoch ----------------------------------------------------------------

    def __iter__(self) -> Iterator:
        self._maybe_retune_workers()
        self.lazy_init()
        self.job.shuffle()
        # results of an abandoned epoch's tasks may still arrive: each is
        # tagged with its epoch, and older ones are dropped on receipt
        self._epoch += 1
        epoch = self._epoch
        total = len(self.job)
        device_num = self.decide_task_num(total)
        self.last_device_share = device_num / max(total, 1)
        pending: set = set(range(device_num, total))
        # epoch-scoped recovery state: alive workers at the last resubmit,
        # the last result's time and the last resubmit's
        recover = {"last_alive": len(self._workers), "last_progress": time.monotonic(),
                   "last_resubmit": time.monotonic()}

        def recv(block: bool):
            """The next new result of this epoch from the inbox, or None
            when none arrives (within ~2 s when blocking)."""
            deadline = time.monotonic() + (2.0 if block else 0.0)
            while True:
                try:
                    timeout = max(deadline - time.monotonic(), 0.0)
                    item = self._inbox.get(timeout=timeout) if timeout else \
                        self._inbox.get_nowait()
                except queue_mod.Empty:
                    return None
                r_epoch, task_idx, n_id, count, adjs, dt = item
                if r_epoch != epoch or task_idx not in pending:
                    continue  # an older epoch's, or a duplicate after a resubmit
                pending.discard(task_idx)
                recover["last_progress"] = time.monotonic()
                self._update_avg("avg_cpu_time", dt)
                return task_idx, self._to_dense(n_id, count, adjs)

        def submit(tasks):
            """Round-robin ``tasks`` over the live workers' queues."""
            targets = [q for q, p in zip(self._task_qs, self._workers) if p.is_alive()]
            if not targets:
                raise RuntimeError("all CPU sampler workers died (see worker stderr); "
                                   f"{len(pending)} task(s) unfinished")
            for i, t in enumerate(tasks):
                targets[i % len(targets)].put((epoch, t, np.asarray(self.job[t], np.int64)))

        def recv_blocking():
            """`recv` with recovery: when a worker died while tasks are
            pending, or nothing arrived for an idle window (3x the average
            task, 10-90 s), every pending task goes again to the live
            workers (duplicates are dropped in `recv`); a dead pool raises
            at once, a stalled one after 4 windows (at least 120 s)."""
            start = time.monotonic()
            while True:
                res = recv(block=True)
                if res is not None:
                    return res
                alive = sum(p.is_alive() for p in self._workers)
                if alive == 0:
                    raise RuntimeError("all CPU sampler workers died (see worker stderr); "
                                       f"{len(pending)} task(s) unfinished")
                now = time.monotonic()
                died = alive < recover["last_alive"]
                idle_s = min(max(10.0, 3.0 * self.avg_cpu_time), 90.0)
                idle_steal = (now - recover["last_progress"] > idle_s
                              and now - recover["last_resubmit"] > idle_s)
                if died or idle_steal:
                    submit(sorted(pending))
                    recover["last_alive"] = alive
                    recover["last_resubmit"] = now
                if now - start > max(120.0, 4.0 * idle_s):
                    raise TimeoutError("CPU sampler workers stalled")

        try:
            if pending:
                submit(range(device_num, total))
            for t in range(device_num):
                t0 = time.perf_counter()
                ds = self.device_sampler.sample_dense(self.job[t])
                self._wait_device(ds)
                self._update_avg("avg_device_time", time.perf_counter() - t0)
                yield t, ds
                while pending:  # the CPU results that arrived meanwhile
                    res = recv(block=False)
                    if res is None:
                        break
                    yield res
            while pending:
                yield recv_blocking()
        except Exception:
            self.shutdown()
            raise

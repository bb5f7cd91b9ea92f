"""Staged sample -> tiered gather -> train pipeline — the port of
``quiver_tpu/pipeline.py`` (``AsyncReadPool``, ``TieredBatch``,
``HostStaged``, ``tiered_lookup``, ``TieredFeaturePipeline``,
``PipelineStats``, ``TrainPipeline``, ``make_tiered_train_step``).

It is the path for a feature table that does not fit on the card: the
table's hot prefix lives in device memory, its tail in pinned host memory.
Per batch, the host remaps the sampled ids into stored rows, gathers the
cold (host-tier) rows into a pinned staging buffer padded to a power of
two, and copies them to the card with one asynchronous copy; the step then
assembles the batch's rows with `tiered_lookup` (K5, ``csrc/gather.cu``):
hot rows gathered on the card, cold rows scattered into their slots.

`TrainPipeline` runs three stages on three worker threads (sample and its
``n_id`` fetch, host gather, upload) ahead of the step on the caller's
thread, so the batch's wall time tends to the slowest stage instead of the
sum. On CUDA the sample and upload stages each run on a stream of their
own (every thread would otherwise queue on the legacy default stream, and
the sample stage's device-to-host fetch would wait for the previous
step's kernels); every tensor a stage hands to the step crosses with an
event the step's stream waits on and a ``record_stream`` that keeps the
caching allocator from reusing its memory early. Host-to-device copies are
``non_blocking`` from pinned memory only, and a staging buffer is a fresh
pinned tensor per batch: the pinned allocator gives a block out again only
after the copies that read it have completed.

The cold gather is the port's own host code (``torch.index_select`` into
the pinned staging tensor, multi-threaded and outside the interpreter
lock), not ``quiver_tpu/ops/cpu_kernels.gather_rows``. The staged values
are those of the reference, bit for bit.

The cold stage spans the whole hierarchy: a feature with a disk tier
(``Feature(disk_path=...)``) stages its host rows from the DRAM middle and
its disk rows from the flat file through the feature's `AsyncReadPool`
("disk" mode); an adaptive feature routes each batch by a snapshot of its
`tiers.TierStore` placement, ``mapped`` then carrying HBM slots
("adaptive" mode). ``prefetch=True`` issues a batch's disk reads from the
sample stage, one stage before the gather takes them
(`tiers.PrefetchBuffer`). The bytes are those of an all-DRAM epoch.

Not ported yet: (A12) the metrics registry behind ``register_metrics``;
(A9) the mixed sampler's feedback into `PipelineStats`.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .pyg.sage_sampler import DenseSample
from .shard_tensor import STORE_DTYPES, rows_from_numpy
from .tiers import TIER_HOST, PrefetchBuffer
from .train_programs import TrainPrograms, TrainStep, descend
from .trace import SpanRecorder, export_chrome_trace, trace_scope
from .utils import round_up_pow2


class AsyncReadPool:
    """Bounded worker pool for chunked cold-tier reads: a batch split
    across ``workers`` threads overlaps the reads (the reads release the
    interpreter lock). `gather` is the synchronous surface, `submit` the
    future-returning one.

    Error contract: a failing chunk read cancels every queued sibling,
    observes every future and re-raises the first failure in submission
    order at the caller; the pool keeps serving later gathers.
    """

    def __init__(self, workers: int = 4, chunk_rows: int = 4096, name: str = "qt-diskread"):
        if workers < 1:
            raise ValueError("AsyncReadPool needs >= 1 worker")
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        self.workers = int(workers)
        self.chunk_rows = int(chunk_rows)
        self._pool = concurrent.futures.ThreadPoolExecutor(workers, name)
        self.reads = 0    # chunk reads issued
        self.gathers = 0  # gather() batches served
        self.rows = 0
        self.bytes = 0
        self.errors = 0
        self.seconds = 0.0

    def _chunks(self, ids: np.ndarray):
        n = ids.shape[0]
        per = max(self.chunk_rows if n > self.workers * self.chunk_rows else -(-n // self.workers),
                  1)
        return [ids[i: i + per] for i in range(0, n, per)]

    def gather(self, read_block, local_ids: np.ndarray) -> np.ndarray:
        """``read_block(ids_chunk) -> rows`` fanned across the workers;
        returns the rows concatenated in input order."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        t0 = time.monotonic()
        self.gathers += 1
        if ids.shape[0] == 0:
            return read_block(ids)
        chunks = self._chunks(ids)
        if len(chunks) == 1:  # no pool hop for a batch one worker serves anyway
            self.reads += 1
            out = read_block(chunks[0])
            self.rows += out.shape[0]
            self.bytes += out.nbytes
            self.seconds += time.monotonic() - t0
            return out
        futs = [self._pool.submit(read_block, c) for c in chunks]
        self.reads += len(futs)
        error: Optional[BaseException] = None
        parts = []
        for f in futs:
            if error is not None:
                # the first failure wins: cancel what has not started and
                # observe the rest so nothing is logged at collection
                f.cancel()
                f.add_done_callback(lambda fut: fut.cancelled() or fut.exception())
                continue
            try:
                parts.append(f.result())
            except BaseException as exc:  # re-raised below, after the siblings
                error = exc
        if error is not None:
            self.errors += 1
            raise error
        out = np.concatenate(parts, axis=0)
        self.rows += out.shape[0]
        self.bytes += out.nbytes
        self.seconds += time.monotonic() - t0
        return out

    def submit(self, read_block, local_ids: np.ndarray):
        """One asynchronous read; the future resolves to the rows or raises
        the read's error."""
        return self._pool.submit(read_block, np.asarray(local_ids, np.int64))

    def stats(self) -> dict:
        return {"workers": self.workers, "gathers": self.gathers, "reads": self.reads,
                "rows": self.rows, "bytes": self.bytes, "errors": self.errors,
                "seconds": self.seconds}

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait, cancel_futures=True)

    def __enter__(self) -> "AsyncReadPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class TieredBatch(NamedTuple):
    """Device-ready inputs of one pipelined step."""

    ds: DenseSample            # padded sample (its adjs feed the model)
    mapped: torch.Tensor       # [W] int32 stored rows; -1 invalid
    cold_rows: torch.Tensor    # [C_b, D] staged host-tier rows (padded bucket)
    cold_pos: torch.Tensor     # [C_b] int32 slot of each cold row; W pads
    seeds: torch.Tensor        # [B] int32 seed node ids (for labels)


class HostStaged(NamedTuple):
    """The host half of staging, awaiting its upload: CPU tensors, pinned
    when the pipeline's device is CUDA (bfloat16 rows have no numpy
    dtype there)."""

    mapped: torch.Tensor            # [W] int32, -1 invalid
    rows: Optional[torch.Tensor]    # [C_b, D] cold rows in the stored dtype, or None
    pos: Optional[torch.Tensor]     # [C_b] int32 slots, or None


def tiered_lookup_plain(hot_table: torch.Tensor, mapped: torch.Tensor,
                        cold_rows: torch.Tensor, cold_pos: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `tiered_lookup`, on ``mapped``'s device."""
    H, W = hot_table.shape[0], mapped.shape[0]
    m = mapped.to(torch.int64)
    is_hot = (m >= 0) & (m < H)
    out = torch.zeros((W, hot_table.shape[1]), dtype=hot_table.dtype, device=mapped.device)
    out[is_hot] = hot_table[m[is_hot]]
    if cold_rows.shape[0]:
        p = cold_pos.to(torch.int64)
        keep = (p >= 0) & (p < W)
        out[p[keep]] = cold_rows[keep]
    return out


def tiered_lookup(hot_table: torch.Tensor, mapped: torch.Tensor, cold_rows: torch.Tensor,
                  cold_pos: torch.Tensor) -> torch.Tensor:
    """The step's tiered feature assembly (K5): ``[W, D]`` rows with
    ``hot_table[mapped[r]]`` where ``0 <= mapped[r] < H`` and zeros
    elsewhere, then cold row i written into slot ``cold_pos[i]`` (slots
    outside ``[0, W)`` are padding and dropped). Bit-equal copies in the
    table's dtype. On CUDA tensors one call of ``csrc/gather.cu``'s
    ``qt_tiered_lookup``; on CPU tensors `tiered_lookup_plain`."""
    if hot_table.dim() != 2 or cold_rows.dim() != 2 or mapped.dim() != 1 or cold_pos.dim() != 1:
        raise ValueError("tiered_lookup takes hot [H, D], mapped [W], cold_rows [C, D] and "
                         "cold_pos [C]")
    if cold_rows.shape[0] != cold_pos.shape[0] or (cold_rows.shape[0]
                                                   and cold_rows.shape[1] != hot_table.shape[1]):
        raise ValueError("cold_rows [C, D] and cold_pos [C] must match each other and the table")
    devs = {hot_table.device, mapped.device, cold_rows.device, cold_pos.device}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    if not mapped.is_cuda:
        return tiered_lookup_plain(hot_table, mapped, cold_rows, cold_pos)
    if hot_table.dtype not in STORE_DTYPES.values() or cold_rows.dtype != hot_table.dtype:
        raise TypeError(f"the lookup kernel copies rows of one dtype of {', '.join(STORE_DTYPES)}")
    if mapped.dtype != torch.int32 or cold_pos.dtype != torch.int32:
        raise TypeError("the lookup kernel takes int32 mapped and cold_pos")
    hot_table, mapped = hot_table.contiguous(), mapped.contiguous()
    cold_rows, cold_pos = cold_rows.contiguous(), cold_pos.contiguous()
    W, D = mapped.shape[0], hot_table.shape[1]
    out = torch.empty((W, D), dtype=hot_table.dtype, device=mapped.device)
    if W == 0 or D == 0:
        return out
    _kernels.launch("tiered_lookup", hot_table.data_ptr(), hot_table.shape[0],
                    D * hot_table.element_size(), mapped.data_ptr(), W, cold_rows.data_ptr(),
                    cold_rows.shape[0], cold_pos.data_ptr(), out.data_ptr(),
                    _kernels.stream_of(mapped))
    return out


def _host_ids(ids) -> torch.Tensor:
    """Lookup ids as a flat int64 CPU tensor."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.ascontiguousarray(ids))
    return ids.reshape(-1).to("cpu", torch.int64)


class TieredFeaturePipeline:
    """Prepares `TieredBatch` inputs for a tiered `Feature` (or a
    `quant.QuantizedFeature`, whose tiers hold encoded rows) on the
    feature's device, in one of three modes:

    - "dram": one device shard (the hot prefix, ``hot_table``) plus an
      optional pinned host tail (``cold_np``);
    - "disk": the same plus a flat-file disk tail (``disk_path``), whose
      rows the cold stage reads through the feature's read pool;
    - "adaptive": a `tiers.TierStore`. The pipeline snapshots its placement
      at construction (the maps are copied, the HBM table and the DRAM
      cache pinned: a later `TierStore.apply` writes new ones, so the pinned
      ones keep their bytes); ``mapped`` carries HBM slots, host-cache and
      disk rows are staged. Build a fresh pipeline after an ``apply`` to
      train on the new placement.

    Per batch, `prepare_host` remaps ids through ``feature_order``, splits
    hot from cold and gathers the cold rows into a pinned staging tensor;
    `upload` copies them to the card. ``prefetch=True`` (disk and adaptive
    modes; inert in "dram") adds the flush-ahead leg, `prefetch`.
    """

    def __init__(self, feature, prefetch: bool = False, prefetch_max_rows: int = 8192):
        self.feature = feature
        self.dtype = feature.dtype
        order = feature.feature_order
        self._order = None if order is None else torch.from_numpy(np.asarray(order, np.int64))
        # true tier traffic (padding excluded), accumulated across prepare()
        self.cold_rows_seen = 0
        self.rows_seen = 0
        self.disk_rows_seen = 0
        self._prefetch: Optional[PrefetchBuffer] = None
        store = getattr(feature, "tier_store", None)
        if store is not None and getattr(feature, "codec", None) is not None:
            raise NotImplementedError(
                "an adaptive QuantizedFeature cannot feed the staged pipeline: the quantized "
                "lookup reads its side tables by stored row, and an adaptive batch's mapped "
                "carries HBM slots (read it through QuantizedFeature.__getitem__)")
        if store is not None:
            self.mode = "adaptive"
            self._store = store
            self.device = store.device
            self._tier_of = store.placement.tier_of.copy()
            self._slot_of = store.placement.slot_of.copy()
            self.hot_rows = store.placement.hbm_rows
            self.hot_table = (store.hbm_table if store.hbm_table is not None else
                              torch.zeros((0, feature.dim), dtype=self.dtype, device=self.device))
            self._host_cache = store.host_cache
            self.cold_np = None
            if prefetch:
                self._prefetch = store.enable_prefetch(max_rows=prefetch_max_rows)
            self._pin = self.device.type == "cuda"
            return
        st = feature.shard_tensor
        if st is None:
            raise ValueError("feature not built; call from_cpu_tensor first")
        if len(st.device_shards) > 1:
            raise ValueError("tiered pipeline expects one hot shard + optional host tail")
        self._store = None
        self.device = st.device
        self._pin = self.device.type == "cuda"
        if st.device_shards:
            _, self.hot_table, off = st.device_shards[0]
            self.hot_rows = off.end - off.start
        else:
            self.hot_table = torch.zeros((0, feature.dim), dtype=self.dtype, device=self.device)
            self.hot_rows = 0
        self.cold_np = st.cpu_tensor  # the pinned host tail, or None
        self._shards = st
        if st.disk_shard is None:
            self.mode = "dram"
            return
        self.mode = "disk"
        self._disk_start = st.disk_offset.start
        if prefetch:
            if st.read_pool is None:
                raise ValueError("prefetch needs an AsyncReadPool (build the Feature with "
                                 "read_pool=/disk_read_workers=)")
            shard = st.disk_shard
            self._prefetch = PrefetchBuffer(lambda ids: shard.read_block(ids), st.read_pool,
                                            max_rows=prefetch_max_rows)
            if hasattr(feature, "disk_staged"):
                feature.disk_staged = self._prefetch.staged_mask

    def _staging(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def prepare_host(self, ids, valid_count: Optional[int] = None) -> HostStaged:
        """The host half of staging: id remap, hot/cold split and cold
        gather (the disk rows through the read pool); no device call, so it
        runs on the gather thread while another batch uploads.
        ``valid_count`` (``ds.count``) marks the padding tail, whose lanes
        the model masks and whose rows are not fetched. Cold rows are
        padded to ``round_up_pow2(C, 256)`` rows of zeros at slot ``W``."""
        with trace_scope("pipeline.prepare_host"):
            ids = _host_ids(ids)
            W = ids.shape[0]
            invalid = (ids < 0) | (ids >= self.feature.shape[0])
            if valid_count is not None and valid_count < W:
                invalid[valid_count:] = True
            safe = torch.where(invalid, 0, ids)
            stored = self._order[safe] if self._order is not None else safe
            stored = torch.where(invalid, -1, stored)
            self.rows_seen += W
            if self.mode == "adaptive":
                return self._prepare_adaptive(stored, W)
            mapped = self._staging((W,), torch.int32)
            mapped.copy_(stored)
            if self.cold_np is None and self.mode != "disk":
                return HostStaged(mapped, None, None)
            cold_sel = torch.nonzero(stored >= self.hot_rows).reshape(-1)
            C = cold_sel.shape[0]
            if C == 0:  # hot-only batch: no padded upload at all
                return HostStaged(mapped, None, None)
            pos, rows = self._cold_staging(cold_sel, W)
            cold_ids = stored[cold_sel]
            with trace_scope("pipeline.cold_gather"):
                if self.mode == "disk":
                    on_disk = cold_ids >= self._disk_start
                    host_sel = torch.nonzero(~on_disk).reshape(-1)
                    if host_sel.shape[0]:
                        rows[host_sel] = self.cold_np.index_select(
                            0, cold_ids[host_sel] - self.hot_rows)
                    disk_sel = torch.nonzero(on_disk).reshape(-1)
                    if disk_sel.shape[0]:
                        self.disk_rows_seen += disk_sel.shape[0]
                        st = self._shards
                        rows[disk_sel] = self._read_cold(
                            (cold_ids[disk_sel] - self._disk_start).numpy(),
                            lambda i: st.disk_shard.read_rows(i, pool=st.read_pool))
                else:
                    torch.index_select(self.cold_np, 0, cold_ids - self.hot_rows, out=rows[:C])
            return HostStaged(mapped, rows, pos)

    def _cold_staging(self, cold_sel: torch.Tensor, W: int):
        """Pinned ``(pos, rows)`` of a cold bucket: the C slots then ``W``
        (dropped by the scatter), and rows whose padding is zero. Counts
        the C rows in ``cold_rows_seen``."""
        C = cold_sel.shape[0]
        self.cold_rows_seen += C
        b = round_up_pow2(C, floor=256)
        pos = self._staging((b,), torch.int32)
        pos[:C].copy_(cold_sel)
        pos[C:] = W
        rows = self._staging((b, self.feature.dim), self.dtype)
        rows[C:].zero_()
        return pos, rows

    def _read_cold(self, ids: np.ndarray, read) -> torch.Tensor:
        """Disk rows for ``ids`` as a tensor of the stored dtype: the rows a
        prefetch staged out of DRAM, the rest through ``read`` (a pooled
        flat-file read): the same bytes either way."""
        pf = self._prefetch
        arr = read(ids) if pf is None else pf.take_or_read(ids, read)
        return rows_from_numpy(arr, self.dtype)

    def _prepare_adaptive(self, stored: torch.Tensor, W: int) -> HostStaged:
        """Staging against the placement snapshot (`tiers.TierStore.stage`):
        ``mapped`` carries HBM slots (-1 elsewhere); host-cache rows come
        from the snapshot's DRAM cache, disk rows from the backing file
        (prefetched rows out of staging)."""
        with trace_scope("pipeline.cold_gather"):
            mapped_np, pos, rows, n_disk = self._store.stage(
                stored.numpy(), lambda sel: self._cold_staging(torch.from_numpy(sel), W),
                self._tier_of, self._slot_of, self._host_cache, self._prefetch)
        mapped = self._staging((W,), torch.int32)
        mapped.copy_(torch.from_numpy(mapped_np))
        self.disk_rows_seen += n_disk
        return HostStaged(mapped, rows, pos)

    @property
    def prefetch_stats(self) -> dict:
        return self._prefetch.stats() if self._prefetch is not None else {}

    def prefetch(self, ids, valid_count: Optional[int] = None) -> int:
        """Issue `AsyncReadPool` reads for the disk-resident rows of a
        batch's ``n_id``, from the sample stage, one stage before the
        gather takes them; returns the rows issued (0 without prefetch).
        Observe-only on bits."""
        pf = self._prefetch
        if pf is None:
            return 0
        ids = _host_ids(ids).numpy()
        if valid_count is not None and valid_count < ids.shape[0]:
            ids = ids[:valid_count]
        ids = ids[(ids >= 0) & (ids < self.feature.shape[0])]
        if ids.size == 0:
            return 0
        stored = self._order.numpy()[ids] if self._order is not None else ids
        if self.mode == "adaptive":
            disk = stored[self._tier_of[stored] > TIER_HOST]
            return pf.issue(disk) if disk.size else 0
        local = stored[stored >= self._disk_start] - self._disk_start
        return pf.issue(local) if local.size else 0

    def cancel_prefetch(self) -> int:
        """Drop staged prefetch rows (the mid-epoch error unwind): see
        `tiers.PrefetchBuffer.cancel`."""
        return self._prefetch.cancel() if self._prefetch is not None else 0

    def _h2d(self, t: torch.Tensor) -> torch.Tensor:
        # asynchronous only from pinned memory: a pageable source may be
        # rewritten before an asynchronous copy has read it
        return t.to(self.device, non_blocking=self._pin and t.is_pinned())

    def upload(self, staged: HostStaged) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device half of staging: the host-to-device copies, queued on
        the current stream (the upload stage's own in `TrainPipeline`)."""
        with trace_scope("pipeline.h2d"):
            mapped = self._h2d(staged.mapped)
            if staged.rows is None:
                cold_rows = torch.zeros((0, self.feature.dim), dtype=self.dtype,
                                        device=self.device)
                cold_pos = torch.zeros((0,), dtype=torch.int32, device=self.device)
            else:
                cold_rows, cold_pos = self._h2d(staged.rows), self._h2d(staged.pos)
            return mapped, cold_rows, cold_pos

    def prepare(self, n_id, valid_count: Optional[int] = None):
        """``(mapped, cold_rows, cold_pos)`` for a padded ``n_id``: the
        single-threaded `prepare_host` then `upload`."""
        return self.upload(self.prepare_host(n_id, valid_count))


@dataclass
class PipelineStats:
    batches: int = 0
    cold_rows: int = 0
    hot_rows: int = 0
    # the mixed sampler's feedback (ROADMAP A9); stays unset here
    avg_device_sample_s: float = 0.0
    avg_cpu_sample_s: float = 0.0
    device_share: Optional[float] = None
    # (stage, t0, t1) monotonic spans of every stage body and step, from
    # all four threads; built eagerly so no thread races a lazy init
    spans: SpanRecorder = field(default_factory=SpanRecorder)

    def record(self, stage: str, t0: float, t1: float) -> None:
        self.spans.record(stage, t0, t1)

    def overlap_summary(self) -> dict:
        """Measured concurrency of the recorded spans (see
        `trace.SpanRecorder.overlap_summary`)."""
        return self.spans.overlap_summary() if self.spans else {}

    def register_metrics(self, registry=None, prefix: str = "quiver_pipeline", labels=None):
        raise NotImplementedError("PipelineStats.register_metrics is not ported yet: the "
                                  "metrics registry comes with ROADMAP A12")


def _tensors(obj):
    """Every tensor inside nested tuples (NamedTuples included)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


class TrainPipeline:
    """sample -> tiered gather -> step, with staged prefetch threads.

    ``step_fn(batch: TieredBatch, generator) -> loss`` updates the model
    and optimizer it holds in place (see `make_tiered_train_step`, whose
    step carries ``.model`` and ``.optimizer``, what checkpoints save).
    Three one-worker stages run ahead of the step on the caller's thread:

      1. sample: the sampling launches and the ``n_id``/count fetches;
      2. gather: id remap and host cold gather (no device call);
      3. upload: the host-to-device copies.

    Each batch is a chain of three futures; ``depth`` chains beyond the
    three stage buffers are kept in flight. ``measure_overlap=True`` waits
    for each step's loss so its span ("step") covers the step's device
    work; otherwise the span ("step_dispatch") covers its launch.
    """

    def __init__(self, sampler, feature, step_fn, depth: int = 2,
                 tiered: Optional[TieredFeaturePipeline] = None, checkpoint=None,
                 checkpoint_every: int = 0, measure_overlap: bool = False):
        self.sampler = sampler
        # one TieredFeaturePipeline per feature: two would drift apart on stats
        self.tiered = tiered if tiered is not None else TieredFeaturePipeline(feature)
        self.step_fn = step_fn
        self.depth = max(depth, 1)
        self.stats = PipelineStats()
        self.measure_overlap = bool(measure_overlap)
        self.checkpoint = checkpoint
        self.checkpoint_every = int(checkpoint_every)
        if checkpoint is not None and self.checkpoint_every <= 0:
            raise ValueError("checkpoint given but checkpoint_every not set")
        if checkpoint is None and self.checkpoint_every > 0:
            raise ValueError("checkpoint_every set but no checkpoint manager")
        if checkpoint is not None and not (hasattr(step_fn, "model")
                                           and hasattr(step_fn, "optimizer")):
            raise ValueError("checkpoints save step_fn.model and step_fn.optimizer; "
                             "build the step with make_tiered_train_step")
        # resume numbering where the store left off, so a fresh pipeline
        # after preemption never saves below the stored latest step
        self.global_step = int(checkpoint.latest_step() or 0) if checkpoint is not None else 0
        self.device = self.tiered.device
        self._streams = None
        if self.device.type == "cuda":
            self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))

    # -- the three stage bodies ------------------------------------------------

    def _sample_body(self, ds: DenseSample, seeds):
        """Stage 1: the device-to-host fetches that wait for the sampling."""
        # valid lanes form the n_id prefix only when every hop was deduped
        # (explicit cols); the structural layout interleaves invalid lanes
        prefix_valid = all(a.cols is not None for a in ds.adjs)
        ids = ds.n_id.cpu()
        vc = int(ds.count) if prefix_valid else None
        if seeds is None:
            seeds = ids[: ds.batch_size]  # the seed batch is the n_id prefix
        self.tiered.prefetch(ids, valid_count=vc)
        return ds, seeds, ids, vc

    def _gather_body(self, ds, seeds, ids, vc):
        """Stage 2: host remap and cold gather."""
        before = self.tiered.cold_rows_seen
        host = self.tiered.prepare_host(ids, valid_count=vc)
        cold = self.tiered.cold_rows_seen - before
        self.stats.batches += 1
        self.stats.cold_rows += cold
        self.stats.hot_rows += host.mapped.shape[0] - cold
        return ds, seeds, host

    def _upload_body(self, ds, seeds, host) -> TieredBatch:
        """Stage 3: the host-to-device copies."""
        mapped, cold_rows, cold_pos = self.tiered.upload(host)
        s = _host_ids(seeds).to(torch.int32)
        if self.device.type == "cuda":
            s = s.pin_memory()
        return TieredBatch(ds=ds, mapped=mapped, cold_rows=cold_rows, cold_pos=cold_pos,
                           seeds=self.tiered._h2d(s))

    def _stage_ds(self, ds: DenseSample, seeds=None) -> TieredBatch:
        """All three stages in turn on the current stream (bootstrap and
        direct callers; the epoch loop runs them on their own threads)."""
        return self._upload_body(*self._gather_body(*self._sample_body(ds, seeds)))

    def _stage(self, seeds) -> TieredBatch:
        return self._stage_ds(self.sampler.sample_dense(seeds), seeds)

    # -- streams ---------------------------------------------------------------

    @contextlib.contextmanager
    def _on_stream(self, i: int):
        """Run the body on stage ``i``'s stream (0 sample, 1 upload) of the
        feature's device; nothing changes on the CPU."""
        if self._streams is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._streams[i]):
            yield

    def _event(self):
        """An event recorded on the current stream (None on the CPU)."""
        if self._streams is None:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _hand_over(self, batch: TieredBatch, events) -> TieredBatch:
        """Make the stages' tensors safe to use on the caller's stream: wait
        for the stages' events, and mark every tensor as used there."""
        if self._streams is None:
            return batch
        cur = torch.cuda.current_stream(self.device)
        for ev in events:
            cur.wait_event(ev)
        for t in _tensors(batch):
            if t.is_cuda:
                t.record_stream(cur)
        return batch

    # -- the epoch -------------------------------------------------------------

    def register_metrics(self, registry=None, prefix: str = "quiver_pipeline", labels=None):
        raise NotImplementedError("TrainPipeline.register_metrics is not ported yet: the "
                                  "metrics registry comes with ROADMAP A12")

    def export_chrome_trace(self, path: str, metadata=None):
        """Chrome trace (Perfetto loads it) of the recorded stage spans."""
        return export_chrome_trace(path, [("train_pipeline", self.stats.spans)], metadata)

    def run_epoch(self, seed_batches: Sequence, generator: Optional[torch.Generator] = None):
        """One epoch over ``seed_batches``; returns the losses. Sampling,
        cold gather and upload of the next batches run on the stage
        threads while the card steps batch i. ``generator`` (a
        ``torch.Generator`` on the device) is handed to every step."""
        return self._run(((self.sampler.sample_dense(s), s) for s in seed_batches), generator)

    def run_epoch_iter(self, samples: Iterable, generator: Optional[torch.Generator] = None):
        """Train over an iterator of `DenseSample`s (or ``(task, DenseSample)``
        pairs) of one padded shape; the seeds are each sample's ``n_id``
        prefix."""

        def pairs():
            for item in samples:
                # a DenseSample is itself a (named) tuple: test it first
                yield (item if isinstance(item, DenseSample) else item[1]), None

        return self._run(pairs(), generator)

    def _run(self, sample_pairs, generator):
        """The staged loop. ``sample_pairs`` yields ``(DenseSample, seeds)``
        lazily; its next() (the sampling launches) runs on the sample
        thread, one thread a stage keeping batches in order."""
        it = iter(sample_pairs)
        losses = []
        spool = concurrent.futures.ThreadPoolExecutor(1, "qt-sample")
        gpool = concurrent.futures.ThreadPoolExecutor(1, "qt-gather")
        upool = concurrent.futures.ThreadPoolExecutor(1, "qt-upload")

        def sample_next():
            t0 = time.monotonic()
            with self._on_stream(0):
                item = next(it, None)
                if item is None:
                    return None
                out = self._sample_body(*item)
                ev = self._event()
            self.stats.record("sample", t0, time.monotonic())
            return out, ev

        def gather(fut):
            r = fut.result()
            if r is None:
                return None
            t0 = time.monotonic()
            out = self._gather_body(*r[0])
            self.stats.record("gather", t0, time.monotonic())
            return out, r[1]

        def upload(fut):
            r = fut.result()
            if r is None:
                return None
            t0 = time.monotonic()
            with self._on_stream(1):
                batch = self._upload_body(*r[0])
                ev = self._event()
            self.stats.record("upload", t0, time.monotonic())
            return batch, [e for e in (r[1], ev) if e is not None]

        q = collections.deque()
        failed = False
        try:

            def launch():
                f1 = spool.submit(sample_next)
                f2 = gpool.submit(gather, f1)
                q.append((f1, f2, upool.submit(upload, f2)))

            for _ in range(self.depth + 2):
                launch()
            while True:
                r = q.popleft()[-1].result()
                if r is None:
                    break
                launch()
                batch = self._hand_over(*r)
                t0 = time.monotonic()
                loss = self.step_fn(batch, generator)
                if self.measure_overlap:
                    loss = float(loss)  # the span covers the step's device work
                    self.stats.record("step", t0, time.monotonic())
                else:
                    self.stats.record("step_dispatch", t0, time.monotonic())
                losses.append(loss)
                self.global_step += 1
                if self.checkpoint is not None and self.global_step % self.checkpoint_every == 0:
                    self.checkpoint.save(
                        self.global_step,
                        {"model": self.step_fn.model.state_dict(),
                         "optimizer": self.step_fn.optimizer.state_dict()},
                        wait=False)
        except BaseException:
            # a stage or the step raised mid-epoch: cancel every queued stage
            # future so the shutdown below does not wait behind batches nobody
            # consumes, observe every future of every chain in flight (each
            # can fail on its own), then re-raise the original error
            failed = True
            for pool in (spool, gpool, upool):
                pool.shutdown(wait=False, cancel_futures=True)
            while q:
                for f in q.popleft():
                    f.cancel()
                    f.add_done_callback(lambda fut: fut.cancelled() or fut.exception())
            raise
        finally:
            for pool in (spool, gpool, upool):
                pool.shutdown(wait=True)
            if failed:
                # only after the stage pools drained: a gather still running
                # would stage rows again after an earlier cancel
                self.tiered.cancel_prefetch()
            if self.checkpoint is not None:
                self.checkpoint.flush()
        return [float(loss) for loss in losses]


def make_tiered_train_step(model, optimizer, labels, hot_table: torch.Tensor):
    """``step(batch, generator=None) -> loss`` for `TrainPipeline`: the
    tiered lookup (K5), labels of the clamped seeds, the forward with
    ``train=True`` (dropout drawn from ``generator``), cross-entropy,
    backward and ``optimizer.step()``, in place. On the card it is one
    captured graph a ``(W, C_b)`` (`train_programs.TrainPrograms`; the
    optimizer built with ``capturable=True``): a batch's tensors are copied
    into the graph's static inputs on the caller's stream, then the graph
    replays; on the CPU the step runs eagerly. The step carries ``.model``
    and ``.optimizer``; resume through its ``load_state_dict``, which
    captures anew."""
    labels = torch.as_tensor(labels).to(hot_table.device, torch.int64)
    n = labels.shape[0]

    def body(inputs, host, generator):
        adjs, mapped, cold_rows, cold_pos, seeds = inputs
        x = tiered_lookup(hot_table, mapped, cold_rows, cold_pos)
        y = labels[torch.clamp(seeds.to(torch.int64), 0, n - 1)]
        return descend(model, optimizer, x, adjs, y, generator)

    programs = TrainPrograms(body, model, optimizer, hot_table.device,
                             bound=lambda: (hot_table, labels))

    def step(batch: TieredBatch, generator: Optional[torch.Generator] = None):
        return programs((tuple(batch.ds.adjs), batch.mapped, batch.cold_rows, batch.cold_pos,
                         batch.seeds), generator=generator)

    return TrainStep(programs, step)

"""The disk tier and adaptive placement — the port of ``quiver_tpu/tiers.py``
(``TIER_*``, ``DIRECT_ALIGN``, ``drop_page_cache``, ``o_direct_supported``,
``DiskShard``, ``_set_rows``, ``PrefetchBuffer``, ``TierPlacement``,
``PlacementPlan``, ``plan_adaptive``, ``TierStore``) on one device.

Two halves, as in the reference:

1. A fourth storage tier: `DiskShard`, a flat ``.npy`` row file read
   through ``np.memmap`` (or, with ``direct=True``, through per-thread
   O_DIRECT descriptors into page-aligned buffers) and optionally through a
   `pipeline.AsyncReadPool`. `shard_tensor.ShardTensor.append_disk` hangs it
   under the shard book as a static tail, in the store's dtype.
2. Adaptive placement: `TierStore` — an HBM cache table, a host DRAM cache
   and the full table on disk, placed by a host-side `TierPlacement`.
   `plan_adaptive` turns measured per-row weights into a bounded
   `PlacementPlan`; `TierStore.apply` runs it: demotions edit the map,
   host promotions write the DRAM cache, and HBM promotions land as one
   row scatter on the card (K6, `set_rows`, ``csrc/gather.cu``).

Every row's bytes stay in the backing file, so placement never changes a
gathered byte. `set_rows` keeps the reference's copy-on-write meaning: it
returns a new table and leaves its input untouched, so a pipeline that
pinned the old table before an ``apply`` still reads the old slots' bytes.
`TierStore.apply` writes host promotions into a new DRAM cache too (the
reference writes its numpy cache in place), so such a pipeline's snapshot
stays whole across an apply.
`TierStore.gather` is one launch of the tiered lookup (K5): HBM lanes by
slot, host-cache and disk rows staged on the host (pinned on CUDA) with
their positions.

Host code (the disk reads, the placement book, the planner) is numpy and
threads, carried over from the reference.

Not ported yet (ROADMAP A12): ``expected_closure``, ``tier_daemon_loop``
and ``find_tiered_feature``, which serve the serve engine's tier hooks.
"""

from __future__ import annotations

import heapq
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .shard_tensor import STORE_DTYPES, normalize_dtype, rows_from_numpy, rows_to_numpy
from .utils import resolve_device, round_up_pow2

TIER_HBM = 0
TIER_HOST = 1
TIER_DISK = 2
TIER_NAMES = ("hbm", "host", "disk")

# O_DIRECT reads must be aligned to the device's logical block size in
# offset, length and buffer address; 4096 covers every common device.
DIRECT_ALIGN = 4096


def drop_page_cache(path: str) -> bool:
    """Ask the kernel to evict ``path``'s pages from the page cache
    (``posix_fadvise(DONTNEED)`` over the whole file), the page-cache reset
    for disk measurements where the filesystem refuses O_DIRECT. Returns
    False instead of raising where the call or the file is missing."""
    if not hasattr(os, "posix_fadvise"):
        return False
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def o_direct_supported(path: str) -> bool:
    """Whether ``path``'s filesystem accepts an aligned O_DIRECT read,
    probed by doing one into a page-aligned anonymous mmap buffer
    (overlayfs and tmpfs commonly refuse with EINVAL)."""
    if not hasattr(os, "O_DIRECT"):
        return False
    import mmap as _mmap

    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError:
        return False
    try:
        buf = _mmap.mmap(-1, DIRECT_ALIGN)
        try:
            return os.preadv(fd, [buf], 0) >= 0
        finally:
            buf.close()
    except OSError:
        return False
    finally:
        os.close(fd)


class DiskShard:
    """Flat-file ``[R, D]`` row shard on disk (``.npy``, read through
    ``np.memmap``).

    ``read_rows`` is the read surface: local row ids in, a fresh
    C-contiguous array out; with a pool the read is split into chunks that
    run on the pool's workers. Out-of-range ids raise: callers mask padding
    before the disk tier, so a bad id here means a corrupt placement map.

    ``direct=True`` reads through O_DIRECT descriptors (one per reading
    thread) into page-aligned buffers, bypassing the page cache: the read a
    cold-disk measurement needs. The bytes equal the memmap path's. Raises
    at open where the filesystem refuses O_DIRECT (probe with
    `o_direct_supported` first).
    """

    # contiguous aligned spans merge into one pread up to this many bytes
    DIRECT_RUN_BYTES = 1 << 20

    def __init__(self, path: str, direct: bool = False):
        self.path = path
        self._mm = np.load(path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError(f"disk shard {path} must be [R, D]")
        self.direct = bool(direct)
        self._fd = None
        if self.direct:
            if not hasattr(os, "O_DIRECT"):
                raise OSError("platform has no O_DIRECT")
            self._fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
            if not o_direct_supported(path):
                os.close(self._fd)
                self._fd = None
                raise OSError(f"filesystem refuses O_DIRECT reads: {path}")
            self._data_off = int(self._mm.offset)  # where the npy header ends
            # one descriptor per reading thread: concurrent preads on one
            # shared descriptor serialize in the kernel
            self._tls = threading.local()
            self._all_fds: List[int] = [self._fd]
            self._fd_lock = threading.Lock()

    def _direct_fd(self) -> int:
        fd = getattr(self._tls, "fd", None)
        if fd is None:
            fd = os.open(self.path, os.O_RDONLY | os.O_DIRECT)
            self._tls.fd = fd
            with self._fd_lock:
                self._all_fds.append(fd)
        return fd

    def _direct_buf(self, nbytes: int) -> np.ndarray:
        """This thread's block-aligned read buffer, grown to ``nbytes``."""
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.shape[0] < nbytes:
            base = np.empty(nbytes + DIRECT_ALIGN, np.uint8)
            shift = (-base.ctypes.data) % DIRECT_ALIGN
            self._tls.buf_base = base  # keeps the allocation alive
            self._tls.buf = buf = base[shift: shift + nbytes]
        return buf

    def __del__(self):
        fds = getattr(self, "_all_fds", None)
        if fds is None:
            fds = [f for f in (getattr(self, "_fd", None),) if f is not None]
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def _read_block_direct(self, ids: np.ndarray) -> np.ndarray:
        """Aligned O_DIRECT gather: rows are grouped by the aligned block
        span around them, spans dedup, and contiguous spans merge into one
        pread of at most ``DIRECT_RUN_BYTES``."""
        rb = self.row_bytes
        out = np.empty((ids.shape[0], self._mm.shape[1]), self._mm.dtype)
        row_u8 = out.view(np.uint8).reshape(ids.shape[0], rb)
        offs = self._data_off + ids.astype(np.int64) * rb
        a0 = (offs // DIRECT_ALIGN) * DIRECT_ALIGN
        a1 = (-(-(offs + rb) // DIRECT_ALIGN)) * DIRECT_ALIGN
        order = np.argsort(a0, kind="stable")
        runs: List[Tuple[int, int]] = []
        rows_of: List[List[int]] = []
        for j in order.tolist():
            s, e = int(a0[j]), int(a1[j])
            if runs and s <= runs[-1][1] and e - runs[-1][0] <= self.DIRECT_RUN_BYTES:
                if e > runs[-1][1]:
                    runs[-1] = (runs[-1][0], e)
            else:
                runs.append((s, e))
                rows_of.append([])
            rows_of[-1].append(j)
        buf_np = self._direct_buf(max((e - s for s, e in runs), default=DIRECT_ALIGN))
        mv = memoryview(buf_np)
        fd = self._direct_fd()
        for (s, e), members in zip(runs, rows_of):
            got = os.preadv(fd, [mv[: e - s]], s)
            for j in members:
                lo = int(offs[j]) - s
                if lo + rb > got:
                    raise OSError(f"short O_DIRECT read at row {int(ids[j])}: "
                                  f"run [{s}, {e}) got {got}")
                row_u8[j] = buf_np[lo: lo + rb]
        return out

    @classmethod
    def create(cls, path: str, rows: np.ndarray) -> "DiskShard":
        """Write ``rows`` as a ``.npy`` file (at their dtype) and open it."""
        rows = np.ascontiguousarray(rows)
        if rows.ndim != 2:
            raise ValueError("disk shard rows must be [R, D]")
        if not path.endswith(".npy"):
            path = path + ".npy"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.save(path, rows)
        return cls(path)

    @property
    def shape(self) -> Tuple[int, int]:
        return self._mm.shape

    @property
    def dtype(self) -> np.dtype:
        return self._mm.dtype

    @property
    def nbytes(self) -> int:
        """Payload bytes (the npy header is not counted)."""
        return int(self._mm.shape[0]) * self.row_bytes

    @property
    def row_bytes(self) -> int:
        return int(self._mm.shape[1]) * self._mm.dtype.itemsize

    def read_block(self, local_ids: np.ndarray) -> np.ndarray:
        """One synchronous gather (the unit of work a read pool chunks)."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self._mm.shape[0]):
            raise ValueError(f"disk read ids outside [0, {self._mm.shape[0]}): corrupt "
                             "placement map (callers mask padding before the disk tier)")
        if self._fd is not None:
            return self._read_block_direct(ids)
        return np.ascontiguousarray(self._mm[ids])

    def drop_cache(self) -> bool:
        """Evict this shard's pages from the page cache (`drop_page_cache`)."""
        return drop_page_cache(self.path)

    def read_rows(self, local_ids: np.ndarray, pool=None) -> np.ndarray:
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        if pool is None or ids.size == 0:
            return self.read_block(ids)
        return pool.gather(self.read_block, ids)


# the row scatter's dtypes: the feature tables' (`shard_tensor.STORE_DTYPES`)
# and int32, the streaming graph's tile and (base, deg) tables (B1)
SET_ROWS_DTYPES = (*STORE_DTYPES.values(), torch.int32)


def set_rows_plain(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `set_rows`, on ``table``'s device. A slot
    given twice takes the later row, as the reference's scatter does on the
    CPU; an index assignment leaves that undefined on the card, so only the
    last row of each slot is assigned."""
    out = table.clone()
    s = slots.to(torch.int64)
    i = ((s >= 0) & (s < table.shape[0])).nonzero().view(-1)
    order = torch.sort(s[i], stable=True).indices  # equal slots keep their row order
    si = s[i[order]]
    last = torch.ones_like(si, dtype=torch.bool)
    last[:-1] = si[1:] != si[:-1]
    pick = i[order[last]]
    out[s[pick]] = rows[pick]
    return out


def set_rows(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A new ``[H, D]`` table equal to ``table`` with row ``rows[i]`` in
    slot ``slots[i]`` (K6): slots outside ``[0, H)`` are padding and are
    dropped; ``table`` itself is left untouched (copy-on-write). Bit-equal
    copies in the table's dtype: float32, int8 or bfloat16 for a feature
    table, and int32 for the streaming graph's tile and ``(base, deg)``
    tables (B1, `stream.StreamingTiledGraph`'s commits, whose float32
    timestamp tiles take the float32 form). On CUDA tensors one call of
    ``csrc/gather.cu``'s ``qt_set_rows``: two kernels, a flat copy of the
    table, then the rows whose slot no later row takes written into it (a
    slot given twice takes the later row); on CPU tensors
    `set_rows_plain`."""
    if table.dim() != 2 or slots.dim() != 1 or rows.dim() != 2:
        raise ValueError("set_rows takes table [H, D], slots [b] and rows [b, D]")
    if rows.shape[0] != slots.shape[0] or (rows.shape[0] and rows.shape[1] != table.shape[1]):
        raise ValueError("slots [b] and rows [b, D] must match each other and the table")
    devs = {table.device, slots.device, rows.device}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    if not table.is_cuda:
        return set_rows_plain(table, slots, rows)
    if table.dtype not in SET_ROWS_DTYPES or rows.dtype != table.dtype:
        raise TypeError("the row scatter copies rows of one dtype of "
                        f"{', '.join(str(d).removeprefix('torch.') for d in SET_ROWS_DTYPES)}")
    if slots.dtype != torch.int64:
        raise TypeError(f"the row scatter takes int64 slots; got {slots.dtype}")
    if slots.shape[0] >= 2**31:
        raise ValueError("the row scatter takes fewer than 2^31 rows a call")
    H, D = table.shape
    out = torch.empty((H, D), dtype=table.dtype, device=table.device)
    if H == 0 or D == 0:
        return out
    table, slots, rows = table.contiguous(), slots.contiguous(), rows.contiguous()
    # scratch of which the kernels write and read only the entries at the slots
    slot_row = torch.empty(H, dtype=torch.int32, device=table.device)
    _kernels.launch("set_rows", table.data_ptr(), H, D * table.element_size(), slots.data_ptr(),
                    slots.shape[0], rows.data_ptr(), slot_row.data_ptr(), out.data_ptr(),
                    _kernels.stream_of(out), variant=str(table.dtype).removeprefix("torch."))
    return out


class PrefetchBuffer:
    """Flush-ahead staging of disk-tier reads: an engine that knows a
    gather's rows one stage early ``issue()``s `AsyncReadPool` reads then,
    and the gather ``take()``s the landed rows out of DRAM.

    Observe-only on bits: staged rows are read by the same ``read_fn`` the
    direct path uses, so a taken row is byte-identical to an unstaged read.
    A staged read that failed is not a hit: the gather falls back to the
    direct read and raises the error the prefetch-off run would.

    Accounting: ``issued`` rows submitted (after dedup and the ``max_rows``
    bound), ``hits`` rows a gather took from staging, ``wasted`` rows staged
    and never taken (cleared by ``cancel()``), ``errors`` failed staged
    reads. An optional ``listener(kind, n)`` mirrors hit and wasted counts.
    """

    def __init__(self, read_fn: Callable[[np.ndarray], np.ndarray], pool,
                 max_rows: int = 8192):
        if pool is None:
            raise ValueError("PrefetchBuffer needs an AsyncReadPool")
        self._read_fn = read_fn
        self._pool = pool
        self.max_rows = int(max_rows)
        self._staged: Dict[int, Tuple[object, int]] = {}  # row -> (chunk future, lane)
        self._lock = threading.Lock()
        self.issued = 0
        self.hits = 0
        self.wasted = 0
        self.errors = 0
        self.listener: Optional[Callable[[str, int], None]] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._staged)

    def _emit(self, kind: str, n: int) -> None:
        if n and self.listener is not None:
            try:
                self.listener(kind, n)
            except Exception:
                pass  # observe-only: a broken tap never breaks reads

    def issue(self, local_ids: np.ndarray) -> int:
        """Submit pool reads for the not-yet-staged subset of
        ``local_ids`` (bounded by ``max_rows`` staged in all); returns the
        rows issued. Dedup keeps first occurrences in order, so a
        ``max_rows`` cut keeps the rows nearest the front."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return 0
        _, first = np.unique(ids, return_index=True)
        ids = ids[np.sort(first)]
        chunk = max(int(getattr(self._pool, "chunk_rows", 1024)), 1)
        read = self._read_fn
        with self._lock:
            fresh = [int(i) for i in ids if int(i) not in self._staged]
            room = self.max_rows - len(self._staged)
            if room <= 0 or not fresh:
                return 0
            fresh = fresh[:room]
            arr = np.asarray(fresh, np.int64)
            for lo in range(0, arr.shape[0], chunk):
                part = arr[lo: lo + chunk]
                fut = self._pool.submit(read, part)
                for lane, sid in enumerate(part.tolist()):
                    self._staged[sid] = (fut, lane)
            self.issued += len(fresh)
        return len(fresh)

    def staged_mask(self, local_ids: np.ndarray) -> np.ndarray:
        """Bool mask of ``local_ids`` currently staged (no consume)."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        with self._lock:
            staged = self._staged
            return np.fromiter((int(i) in staged for i in ids), bool, ids.shape[0])

    def take(self, local_ids: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Consume the staged subset of ``local_ids``: ``(positions, rows)``
        with ``positions`` into ``local_ids`` (rows None when nothing hit).
        A staged read still in flight is waited on; one that failed is
        dropped, so the caller re-reads it and meets the error itself."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        with self._lock:
            if not self._staged:
                return np.empty(0, np.int64), None
            entries = []
            for j, i in enumerate(ids.tolist()):
                e = self._staged.pop(int(i), None)
                if e is not None:
                    entries.append((j, e))
        by_fut: Dict[int, Tuple[object, List[int], List[int]]] = {}
        for j, (fut, lane) in entries:
            g = by_fut.get(id(fut))
            if g is None:
                g = by_fut[id(fut)] = (fut, [], [])
            g[1].append(j)
            g[2].append(lane)
        pos_parts, row_parts = [], []
        failed = 0
        for fut, js, lanes in by_fut.values():
            try:
                chunk_rows = fut.result()
            except BaseException:
                failed += len(js)
                continue
            pos_parts.append(np.asarray(js, np.int64))
            row_parts.append(chunk_rows[np.asarray(lanes)])
        hits = sum(p.shape[0] for p in pos_parts)
        self.hits += hits
        self.errors += failed
        self.wasted += failed
        self._emit("hit", hits)
        self._emit("wasted", failed)
        if not pos_parts:
            return np.empty(0, np.int64), None
        return np.concatenate(pos_parts), np.concatenate(row_parts)

    def take_or_read(self, local_ids: np.ndarray,
                     read_fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """``[n, D]`` rows for ``local_ids``: staged bytes where a prefetch
        landed them, ``read_fn(rest)`` for the others (the same bytes)."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        if not len(self):
            return read_fn(ids)
        hit_pos, hit_rows = self.take(ids)
        if hit_pos.size == 0:
            return read_fn(ids)
        out = np.empty((ids.shape[0], hit_rows.shape[1]), hit_rows.dtype)
        out[hit_pos] = hit_rows
        rest = np.ones(ids.shape[0], bool)
        rest[hit_pos] = False
        if rest.any():
            out[rest] = read_fn(ids[rest])
        return out

    def cancel(self) -> int:
        """Drop every staged row: cancel what the pool has not started,
        observe every future (nothing is logged at collection) and count
        the rows as wasted. Returns the rows dropped; never blocks on a
        read in flight."""
        with self._lock:
            staged, self._staged = self._staged, {}
        if not staged:
            return 0
        seen = set()
        for fut, _ in staged.values():
            if id(fut) in seen:
                continue
            seen.add(id(fut))
            fut.cancel()
            fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        n = len(staged)
        self.wasted += n
        self._emit("wasted", n)
        return n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            staged = len(self._staged)
        return {"issued": self.issued, "hits": self.hits, "wasted": self.wasted,
                "errors": self.errors, "staged": staged, "max_rows": self.max_rows}


class TierPlacement:
    """Host-side placement book of a three-tier adaptive store.

    ``tier_of[stored_row]`` in {TIER_HBM, TIER_HOST, TIER_DISK};
    ``slot_of[stored_row]`` the row's slot in its tier's cache table (-1 on
    disk: disk rows are read by stored id from the full backing file).
    ``hbm_slots``/``host_slots`` are the inverse (slot -> stored id, -1
    free). ``version`` counts applied batches. It starts as the static
    prefix placement: rows ``[0, hbm)`` in HBM, the next ``host`` in DRAM.
    """

    def __init__(self, n: int, hbm_rows: int, host_rows: int):
        if hbm_rows < 0 or host_rows < 0:
            raise ValueError("tier capacities must be >= 0")
        hbm_rows = min(hbm_rows, n)
        host_rows = min(host_rows, n - hbm_rows)
        self.n = int(n)
        self.hbm_rows = int(hbm_rows)
        self.host_rows = int(host_rows)
        self.tier_of = np.full(n, TIER_DISK, np.int8)
        self.slot_of = np.full(n, -1, np.int64)
        self.tier_of[:hbm_rows] = TIER_HBM
        self.slot_of[:hbm_rows] = np.arange(hbm_rows)
        self.tier_of[hbm_rows: hbm_rows + host_rows] = TIER_HOST
        self.slot_of[hbm_rows: hbm_rows + host_rows] = np.arange(host_rows)
        self.hbm_slots = np.arange(hbm_rows, dtype=np.int64)
        self.host_slots = np.arange(hbm_rows, hbm_rows + host_rows, dtype=np.int64)
        self.version = 0

    def counts(self) -> Dict[str, int]:
        return {"hbm": int((self.tier_of == TIER_HBM).sum()),
                "host": int((self.tier_of == TIER_HOST).sum()),
                "disk": int((self.tier_of == TIER_DISK).sum())}

    def residents(self, tier: int) -> np.ndarray:
        """Stored ids resident in ``tier`` now."""
        return np.nonzero(self.tier_of == tier)[0]

    def _slot_table(self, tier: int) -> np.ndarray:
        return self.hbm_slots if tier == TIER_HBM else self.host_slots

    def free_slots(self, tier: int) -> np.ndarray:
        return np.nonzero(self._slot_table(tier) < 0)[0]

    def release(self, stored: int) -> None:
        """Free ``stored``'s slot (a no-op on disk)."""
        t = int(self.tier_of[stored])
        if t == TIER_DISK:
            return
        self._slot_table(t)[self.slot_of[stored]] = -1
        self.tier_of[stored] = TIER_DISK
        self.slot_of[stored] = -1

    def occupy(self, stored: int, tier: int, slot: int) -> None:
        self._slot_table(tier)[slot] = stored
        self.tier_of[stored] = tier
        self.slot_of[stored] = slot

    def check(self) -> None:
        """Invariant sweep (tests; O(N))."""
        for tier in (TIER_HBM, TIER_HOST):
            tab = self._slot_table(tier)
            res = self.residents(tier)
            assert res.size == int((tab >= 0).sum()), "slot table drift"
            assert np.array_equal(np.sort(tab[tab >= 0]), np.sort(res)), "slot table drift"
            assert np.array_equal(tab[self.slot_of[res]], res), "inverse map drift"
        assert np.all(self.slot_of[self.tier_of == TIER_DISK] == -1)


@dataclass
class PlacementPlan:
    """An ordered batch of tier moves ``(stored_row, dst_tier)``; demotions
    come before the promotions whose slots they free."""

    moves: List[Tuple[int, int]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.moves)

    def demote(self, stored: int, dst: int = TIER_DISK) -> None:
        self.moves.append((int(stored), int(dst)))

    def promote(self, stored: int, dst: int) -> None:
        self.moves.append((int(stored), int(dst)))


def plan_adaptive(placement: TierPlacement, hot_stored: np.ndarray, hot_weight: np.ndarray,
                  resident_weight: Callable[[np.ndarray], np.ndarray], max_moves: int = 64,
                  min_weight: float = 2.0, hysteresis: float = 1.25) -> PlacementPlan:
    """Greedy bounded promote/demote plan from a measured hot set.

    ``hot_stored``/``hot_weight`` are candidate stored rows and their
    weights; ``resident_weight(stored_ids)`` prices current residents. The
    HBM pass lets the hottest non-HBM candidates displace the coldest HBM
    residents when ``cand_w >= max(victim_w * hysteresis, min_weight)``; a
    displaced victim moves to a free host slot, else displaces a colder
    host resident (which drops to disk), else drops to disk. The host pass
    does the same for the remaining disk candidates against host
    residents. ``max_moves`` bounds the plan's length.
    """
    plan = PlacementPlan()
    hot_stored = np.asarray(hot_stored, np.int64).reshape(-1)
    hot_weight = np.asarray(hot_weight, np.float64).reshape(-1)
    keep = hot_weight >= min_weight
    hot_stored, hot_weight = hot_stored[keep], hot_weight[keep]
    if hot_stored.size == 0:
        return plan
    order = np.argsort(-hot_weight, kind="stable")
    hot_stored, hot_weight = hot_stored[order], hot_weight[order]
    hot_w_of = dict(zip(hot_stored.tolist(), hot_weight.tolist()))

    def victim_list(tier: int) -> List[Tuple[float, int]]:
        res = placement.residents(tier)
        if res.size == 0:
            return []
        w = np.asarray(resident_weight(res), np.float64)
        # a resident that is itself a hot candidate keeps the larger weight
        for i, sid in enumerate(res.tolist()):
            if sid in hot_w_of:
                w[i] = max(w[i], hot_w_of[sid])
        order = np.argsort(w, kind="stable")
        return [(float(w[i]), int(res[i])) for i in order]

    moved: set = set()
    free_host = placement.free_slots(TIER_HOST).size
    host_victims = victim_list(TIER_HOST)
    hv_i = 0

    def spill_to_host(victim_sid: int, victim_w: float) -> None:
        nonlocal free_host, hv_i
        if placement.host_rows == 0:
            plan.demote(victim_sid, TIER_DISK)
            return
        if free_host > 0:
            free_host -= 1
            plan.demote(victim_sid, TIER_HOST)
            return
        while hv_i < len(host_victims) and host_victims[hv_i][1] in moved:
            hv_i += 1
        if hv_i < len(host_victims) and host_victims[hv_i][0] < victim_w:
            _, sid = host_victims[hv_i]
            hv_i += 1
            moved.add(sid)
            plan.demote(sid, TIER_DISK)
            plan.demote(victim_sid, TIER_HOST)
        else:
            plan.demote(victim_sid, TIER_DISK)

    if placement.hbm_rows > 0:
        hbm_victims = victim_list(TIER_HBM)
        free_hbm = placement.free_slots(TIER_HBM).size
        vi = 0
        for sid, w in zip(hot_stored.tolist(), hot_weight.tolist()):
            if len(plan) + 3 > max_moves:
                break
            if placement.tier_of[sid] == TIER_HBM or sid in moved:
                continue
            if free_hbm > 0:
                free_hbm -= 1
            else:
                while vi < len(hbm_victims) and hbm_victims[vi][1] in moved:
                    vi += 1
                if vi >= len(hbm_victims):
                    break
                vw, vsid = hbm_victims[vi]
                if w < max(vw * hysteresis, min_weight):
                    break  # victims only get hotter from here
                vi += 1
                moved.add(vsid)
                spill_to_host(vsid, vw)
            moved.add(sid)
            plan.promote(sid, TIER_HBM)

    if placement.host_rows > 0:
        host_victims2 = [(w, sid) for w, sid in victim_list(TIER_HOST) if sid not in moved]
        vi = 0
        for sid, w in zip(hot_stored.tolist(), hot_weight.tolist()):
            if len(plan) + 2 > max_moves:
                break
            if sid in moved or placement.tier_of[sid] != TIER_DISK:
                continue
            if free_host > 0:
                free_host -= 1
            else:
                while vi < len(host_victims2) and host_victims2[vi][1] in moved:
                    vi += 1
                if vi >= len(host_victims2):
                    break
                vw, vsid = host_victims2[vi]
                if w < max(vw * hysteresis, min_weight):
                    break
                vi += 1
                moved.add(vsid)
                plan.demote(vsid, TIER_DISK)
            moved.add(sid)
            plan.promote(sid, TIER_HOST)
    return plan


class TierStore:
    """Adaptive three-tier row store: an HBM cache table (on the device), a
    host DRAM cache (a CPU tensor) and the full table on disk, placed by a
    `TierPlacement`. All in the store's dtype (float32, int8 or bfloat16).

    The backing file holds every stored row, so promotion copies disk bytes
    into a cache slot and demotion frees the slot: ``gather`` returns the
    same bytes under any placement. Gathers are not locked against
    ``apply``: callers fence them (a pipeline snapshots the placement and
    the two cache tables at construction; build a fresh one after an
    ``apply`` to read the new placement).
    """

    def __init__(self, backing: DiskShard, placement: TierPlacement,
                 hbm_table: Optional[torch.Tensor], host_cache: Optional[torch.Tensor],
                 dtype, device=None, read_pool=None):
        self.backing = backing
        self.placement = placement
        self.hbm_table = hbm_table    # [hbm_rows, D] on the device, or None
        self.host_cache = host_cache  # [host_rows, D] CPU tensor, or None
        self.dtype = normalize_dtype(dtype)
        self.device = resolve_device(device)
        self.read_pool = read_pool
        self.dim = int(backing.shape[1])
        self._lock = threading.Lock()  # orders concurrent apply() calls only
        self.rows_promoted = 0
        self.rows_demoted = 0
        self.prefetch: Optional[PrefetchBuffer] = None

    @classmethod
    def build(cls, rows: torch.Tensor, path: str, hbm_rows: int, host_rows: int, device=None,
              read_pool=None) -> "TierStore":
        """Spill the full stored table ``rows`` (a CPU tensor of the store
        dtype) to ``path`` and fill the fast tiers with the prefix placement
        (rows ``[0, hbm)`` on the device, ``[hbm, hbm + host)`` in DRAM),
        the static split's."""
        rows = rows.contiguous()
        n = rows.shape[0]
        backing = DiskShard.create(path, rows_to_numpy(rows))
        placement = TierPlacement(n, hbm_rows, host_rows)
        hbm_rows, host_rows = placement.hbm_rows, placement.host_rows
        device = resolve_device(device)
        hbm_table = rows[:hbm_rows].to(device, copy=True) if hbm_rows > 0 else None
        # an owned copy: host promotions write into its slots
        host_cache = rows[hbm_rows: hbm_rows + host_rows].clone() if host_rows > 0 else None
        return cls(backing, placement, hbm_table, host_cache, rows.dtype, device, read_pool)

    @property
    def n_rows(self) -> int:
        return self.placement.n

    @property
    def placement_version(self) -> int:
        return self.placement.version

    def tier_bytes(self) -> Dict[str, int]:
        """Live byte footprint per tier at the stored dtype (``device`` is
        the occupied rows, not the cache capacity)."""
        row = self.dim * self.dtype.itemsize
        c = self.placement.counts()
        return {"device": c["hbm"] * row, "host": c["host"] * row, "disk": self.backing.nbytes,
                "device_capacity": self.placement.hbm_rows * row,
                "host_capacity": self.placement.host_rows * row, "row": row}

    def tier_split(self, stored_ids: np.ndarray) -> Dict[str, int]:
        """Per-tier row counts of a gather batch; disk rows a prefetch
        already staged count as ``disk_prefetched``."""
        ids = np.asarray(stored_ids, np.int64)
        t = self.placement.tier_of[ids]
        disk = int((t == TIER_DISK).sum())
        staged = 0
        pf = self.prefetch
        if pf is not None and disk and len(pf):
            staged = int(pf.staged_mask(ids[t == TIER_DISK]).sum())
        out = {"hbm": int((t == TIER_HBM).sum()), "host": int((t == TIER_HOST).sum()),
               "disk": disk - staged}
        if staged:
            out["disk_prefetched"] = staged
        return out

    def enable_prefetch(self, max_rows: int = 8192,
                        listener: Optional[Callable[[str, int], None]] = None) -> PrefetchBuffer:
        """Attach (or retune) the flush-ahead staging buffer; needs a read
        pool."""
        if self.read_pool is None:
            raise ValueError("prefetch needs an AsyncReadPool (build the Feature with "
                             "read_pool=/disk_read_workers=)")
        if self.prefetch is None:
            # the backing's own method: a closure over self would keep the
            # store (and its pool's threads) alive in a cycle
            self.prefetch = PrefetchBuffer(self.backing.read_block, self.read_pool,
                                           max_rows=max_rows)
        else:
            self.prefetch.max_rows = int(max_rows)
        if listener is not None:
            self.prefetch.listener = listener
        return self.prefetch

    def prefetch_rows(self, stored_ids) -> int:
        """Issue flush-ahead reads for the disk-resident subset of
        ``stored_ids``; returns the rows issued."""
        if self.prefetch is None:
            return 0
        ids = np.asarray(stored_ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < self.placement.n)]
        disk = ids[self.placement.tier_of[ids] == TIER_DISK]
        return self.prefetch.issue(disk) if disk.size else 0

    def cancel_prefetch(self) -> int:
        """Drop staged prefetch rows (see `PrefetchBuffer.cancel`)."""
        return self.prefetch.cancel() if self.prefetch is not None else 0

    def gather_np(self, stored_ids: np.ndarray) -> np.ndarray:
        """The host oracle: rows straight from the backing file (bfloat16
        rows as their int16 bits)."""
        return self.backing.read_rows(np.asarray(stored_ids, np.int64), pool=self.read_pool)

    def stage(self, stored: np.ndarray, alloc, tier_of: np.ndarray, slot_of: np.ndarray,
              host_cache: Optional[torch.Tensor], prefetch: Optional[PrefetchBuffer]):
        """The host half of a tiered lookup: split a batch of stored ids
        (negative: invalid, a zero row) over a placement — the live one
        (`gather`) or a pipeline's snapshot — given as ``tier_of``,
        ``slot_of`` and its DRAM cache ``host_cache``, and stage the cold
        rows; disk rows a ``prefetch`` staged come out of DRAM, the rest
        from the backing file (the same bytes). ``alloc(cold_sel)`` gives
        ``(pos, rows)`` for the C >= 1 cold lanes ``cold_sel``, of which
        this fills ``rows[:C]``.

        Returns ``(mapped, pos, rows, n_disk)``: ``mapped`` [W] int32 numpy
        holds the HBM lanes' slots and -1 elsewhere; ``pos`` and ``rows``
        are None when no lane is cold."""
        valid = stored >= 0
        safe = np.where(valid, stored, 0)
        tiers = tier_of[safe]
        is_hbm = valid & (tiers == TIER_HBM)
        mapped = np.where(is_hbm, slot_of[safe], -1).astype(np.int32)
        (cold_sel,) = np.nonzero(valid & ~is_hbm)
        if cold_sel.size == 0:
            return mapped, None, None, 0
        pos, rows = alloc(cold_sel)
        cold_ids, cold_tiers = stored[cold_sel], tiers[cold_sel]
        (host_sel,) = np.nonzero(cold_tiers == TIER_HOST)
        if host_sel.size and host_cache is not None:
            rows[torch.from_numpy(host_sel)] = host_cache.index_select(
                0, torch.from_numpy(slot_of[cold_ids[host_sel]]))
        (disk_sel,) = np.nonzero(cold_tiers != TIER_HOST)
        if disk_sel.size:
            def read(ids):
                return self.backing.read_rows(ids, pool=self.read_pool)

            ids = cold_ids[disk_sel]
            arr = read(ids) if prefetch is None else prefetch.take_or_read(ids, read)
            rows[torch.from_numpy(disk_sel)] = rows_from_numpy(arr, self.dtype)
        return mapped, pos, rows, int(disk_sel.size)

    def gather(self, stored_ids) -> torch.Tensor:
        """Rows by stored id on the store's device, in the stored dtype:
        one tiered lookup (K5) — HBM slots gathered on the card, host-cache
        and disk rows staged on the host (pinned on CUDA) and scattered into
        their lanes. Ids outside the store give zero rows."""
        from .pipeline import tiered_lookup  # pipeline imports this module

        pin = self.device.type == "cuda"
        ids = np.asarray(stored_ids, np.int64).reshape(-1)
        ids = np.where((ids >= 0) & (ids < self.placement.n), ids, -1)

        def alloc(cold_sel):
            return (torch.from_numpy(cold_sel.astype(np.int32)),
                    torch.empty((cold_sel.shape[0], self.dim), dtype=self.dtype, pin_memory=pin))

        pl = self.placement
        mapped, pos, rows, _ = self.stage(ids, alloc, pl.tier_of, pl.slot_of, self.host_cache,
                                          self.prefetch)
        mapped = torch.from_numpy(mapped)
        if pos is None:
            pos, rows = alloc(np.zeros(0, np.int64))
        hot = self.hbm_table
        if hot is None:
            hot = torch.zeros((0, self.dim), dtype=self.dtype, device=self.device)
        if pin:
            mapped, pos = mapped.pin_memory(), pos.pin_memory()
        return tiered_lookup(hot, mapped.to(self.device, non_blocking=pin),
                             rows.to(self.device, non_blocking=pin),
                             pos.to(self.device, non_blocking=pin))

    def apply(self, plan: PlacementPlan) -> Dict[str, object]:
        """Run a `PlacementPlan` as one batch: map updates in plan order
        (demotions free the slots promotions take), then one backing read
        and a DRAM write for host promotions, and one backing read and one
        row scatter (K6, into a new table) for HBM promotions; both cache
        tables are replaced, never written in place. Staged prefetch rows
        are dropped first: they predate the placement."""
        with self._lock:
            self.cancel_prefetch()
            pl = self.placement
            promote_hbm: List[Tuple[int, int]] = []   # (stored, slot)
            promote_host: List[Tuple[int, int]] = []
            promoted = demoted = 0
            # each tier's free slots as a min-heap: a move takes the lowest
            # free slot, as the reference's free_slots(dst)[0] does, without
            # a scan of the slot table per move
            free = {t: pl.free_slots(t).tolist() for t in (TIER_HBM, TIER_HOST)}
            for sid, dst in plan.moves:
                cur = int(pl.tier_of[sid])
                if dst == cur:
                    continue
                if cur != TIER_DISK:
                    heapq.heappush(free[cur], int(pl.slot_of[sid]))
                pl.release(sid)
                if dst == TIER_DISK:
                    demoted += 1
                    continue
                if not free[dst]:
                    # an over-full plan: the row stays on disk
                    if cur != TIER_DISK:
                        demoted += 1
                    continue
                slot = heapq.heappop(free[dst])
                pl.occupy(sid, dst, slot)
                (promote_hbm if dst == TIER_HBM else promote_host).append((sid, slot))
                if dst < cur:
                    promoted += 1
                else:
                    demoted += 1  # an HBM -> host demotion lands in DRAM
            moved_stored = np.asarray(sorted({sid for sid, _ in plan.moves}), np.int64)
            if promote_host and self.host_cache is not None:
                sids = np.asarray([s for s, _ in promote_host], np.int64)
                slots = torch.from_numpy(np.asarray([sl for _, sl in promote_host], np.int64))
                # into a new DRAM cache, as K6 writes a new HBM table: a
                # pipeline's snapshot keeps reading the old one whole
                host_cache = self.host_cache.clone()
                host_cache[slots] = rows_from_numpy(
                    self.backing.read_rows(sids, pool=self.read_pool), self.dtype)
                self.host_cache = host_cache
            if promote_hbm and self.hbm_table is not None:
                sids = np.asarray([s for s, _ in promote_hbm], np.int64)
                got = rows_from_numpy(self.backing.read_rows(sids, pool=self.read_pool),
                                      self.dtype)
                b = round_up_pow2(sids.shape[0], floor=256)
                slots = torch.full((b,), pl.hbm_rows, dtype=torch.int64)
                slots[: sids.shape[0]] = torch.tensor([sl for _, sl in promote_hbm])
                rows = torch.zeros((b, self.dim), dtype=self.dtype)
                rows[: sids.shape[0]] = got
                dev = self.hbm_table.device
                self.hbm_table = set_rows(self.hbm_table, slots.to(dev), rows.to(dev))
            pl.version += 1
            self.rows_promoted += promoted
            self.rows_demoted += demoted
            return {"moves": len(plan.moves), "promoted_rows": promoted,
                    "demoted_rows": demoted, "promoted_hbm": len(promote_hbm),
                    "promoted_host": len(promote_host), "moved_stored": moved_stored,
                    "version": pl.version, "counts": pl.counts()}

"""Feature store and row gathers — the port of ``quiver_tpu/feature.py``
(``DeviceConfig``, ``validate_lookup_ids``, ``Feature`` under the
``device_replicate`` policy on one device, ``_padded_gather``,
``_padded_gather_ordered``) and of the in-program gather of
``quiver_tpu/inference.py:make_serve_step``.

`gather_rows` is ``ids -> clip(0, n-1) -> [index_map -> clip(0, R-1)] ->
table row``: on CUDA tensors it launches the kernel of ``csrc/gather.cu``
(K3), on CPU tensors it runs `gather_rows_plain`. ``Feature.__getitem__``
is one launch of the tiered gather (`shard_tensor.tiered_gather`, K3t);
``Feature.lookup_padded`` is K3 over the resident table. Ids stay on the
device. A ``Feature`` stores float32, int8 or bfloat16 rows
(`shard_tensor.normalize_dtype`): ``gather_stored`` returns rows in the
stored dtype (what `quant.QuantizedFeature` reads), while ``__getitem__``
and ``lookup_padded`` take float32 stores only, as the reference's callers
use them.

With a ``disk_path`` the store spans four tiers: the device prefix, a host
DRAM middle bounded by ``host_memory_budget`` and a flat ``.npy`` tail on
disk (`tiers.DiskShard`, read through an `pipeline.AsyncReadPool`); with
``adaptive_tiers`` a `tiers.TierStore` places rows between the three
instead, and ``gather_stored``/``__getitem__`` go through its tiered lookup
(K5).

The distributed layer: ``Feature.set_local_order`` (this host stores only
its own rows and maps global ids to them), `PartitionInfo` (which host owns
each id) and `DistFeature` (dispatch ids by owner, exchange the remote ones
over a `comm.TorchComm`, merge with the local gather).

Not ported yet: the ``p2p_clique_replicate`` policy, ``from_mmap`` and
``set_mmap_file``, the observe-only taps (``tier_counter``, ``row_tap``)
and the IPC handles.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import _kernels
from .shard_tensor import CPU_DEVICE, ShardTensor, ShardTensorConfig, _rows_of, normalize_dtype
from .utils import CSRTopo, parse_size, reindex_feature, resolve_device


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    n = index_map.shape[0] if index_map is not None else table.shape[0]
    idx = torch.clamp(ids.to(torch.int64), 0, n - 1)
    if index_map is not None:
        idx = torch.clamp(index_map[idx].to(torch.int64), 0, table.shape[0] - 1)
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``table[clip(ids)]`` (through ``index_map`` when given) as a
    ``[len(ids), D]`` tensor, bit-equal copies."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table [R, D] and ids [n] expected; got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}")
    if index_map is not None and index_map.dim() != 1:
        raise ValueError("index_map must be [N]")
    devs = {table.device, ids.device} | ({index_map.device} if index_map is not None else set())
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    if not table.is_cuda:
        return gather_rows_plain(table, ids, index_map)
    if table.dtype != torch.float32:
        raise TypeError(f"the gather kernel takes a float32 table; got {table.dtype}")
    for t, name in ((ids, "ids"), (index_map, "index_map")):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"the gather kernel takes int32 {name}; got {t.dtype}")
    table, ids = table.contiguous(), ids.contiguous()
    if index_map is not None:
        index_map = index_map.contiguous()
    R, D = table.shape
    out = torch.empty((ids.shape[0], D), dtype=table.dtype, device=table.device)
    if ids.shape[0] == 0 or D == 0:
        return out
    n_clip = index_map.shape[0] if index_map is not None else R
    _kernels.launch(
        "gather_rows", table.data_ptr(), R, D, ids.data_ptr(), ids.shape[0], n_clip,
        index_map.data_ptr() if index_map is not None else None, out.data_ptr(),
        _kernels.stream_of(table),
    )
    return out


@dataclass
class DeviceConfig:
    device_list: List[int]
    device_cache_size: Union[int, str] = 0


def validate_lookup_ids(node_idx, n: int) -> np.ndarray:
    """Opt-in strict id check for feature lookups (host side): returns the
    flattened int64 ids, or raises ValueError naming how many lie outside
    ``[0, n)`` and a few of them. The lookups themselves never raise:
    `Feature.lookup_padded` clips such ids and `Feature.__getitem__`
    zero-fills them, so the sampler's sentinel padding flows through."""
    ids = np.asarray(node_idx).astype(np.int64).reshape(-1)
    bad = (ids < 0) | (ids >= n)
    if bad.any():
        examples = ids[bad][:8].tolist()
        raise ValueError(
            f"{int(bad.sum())} of {ids.size} lookup ids outside [0, {n}); "
            f"examples: {examples} (jit lookups would clip these, eager "
            "lookups would zero-fill — see Feature.validate_ids)"
        )
    return ids


class Feature:
    """Tiered ``[N, D]`` feature store on one device.

    rank : CUDA ordinal whose memory holds the hot rows (``device``
        overrides it, e.g. ``"cpu"`` for the plain versions)
    device_list : devices taking part in caching (one in this port)
    device_cache_size : hot bytes on the device (int or "200M"/"4G")
    cache_policy : "device_replicate" ("p2p_clique_replicate" and its
        alias "ici_replicate" are not ported yet)
    csr_topo : optional CSRTopo — stores rows in degree-descending order
        so the cached prefix is the hot set (``feature_order`` remaps ids)
    dtype : stored dtype, float32 (default), int8 or "bfloat16"
    host_memory_budget : host DRAM bytes of the middle tier when a disk
        tier is configured (0: device misses go straight to disk); ignored
        without ``disk_path``, where the host tail holds every other row
    disk_path : ``.npy`` path of the disk tier: the rows beyond the device
        and host budgets (static), or the full stored table (adaptive)
    adaptive_tiers : place rows with a `tiers.TierStore` (promotions and
        demotions in batches, `TierStore.apply`) instead of the static
        shard book; the bytes gathered are the same under any placement
    disk_read_workers : `pipeline.AsyncReadPool` width of the disk reads
        when no ``read_pool`` is given
    read_pool : an existing `pipeline.AsyncReadPool` to share
    """

    def __init__(self, rank: int = 0, device_list: Optional[Sequence[int]] = None,
                 device_cache_size: Union[int, str] = 0,
                 cache_policy: str = "device_replicate", csr_topo: Optional[CSRTopo] = None,
                 dtype=np.float32, device=None, host_memory_budget: Union[int, str] = 0,
                 disk_path: Optional[str] = None, adaptive_tiers: bool = False,
                 disk_read_workers: int = 4, read_pool=None):
        if cache_policy == "ici_replicate":
            cache_policy = "p2p_clique_replicate"
        if cache_policy not in ("device_replicate", "p2p_clique_replicate"):
            raise ValueError(f"unknown cache_policy: {cache_policy}")
        if adaptive_tiers and disk_path is None:
            raise ValueError("adaptive_tiers needs a disk_path (the full-table backing "
                             "file is what makes placement moves bit-neutral)")
        if disk_path is not None and cache_policy != "device_replicate":
            raise ValueError("disk tiers support cache_policy='device_replicate' only "
                             "(the clique stripe has no per-rank disk story yet)")
        if cache_policy != "device_replicate":
            raise NotImplementedError(f"cache_policy {cache_policy!r} is not ported yet")
        self.dtype = normalize_dtype(dtype)
        self.rank = rank
        self.device_list = list(device_list) if device_list else [rank]
        self.device_cache_size = parse_size(device_cache_size)
        self.cache_policy = cache_policy
        self.csr_topo = csr_topo
        self.device = resolve_device(f"cuda:{rank}" if device is None else device)
        self.feature_order: Optional[np.ndarray] = None  # old id -> stored row
        # set_local_order: ids are global, feature_order maps the owned ones
        # to local rows and every other id to -1
        self._local_order_applied = False
        self._order_dev: Optional[torch.Tensor] = None   # the same, int32 on the device
        self._inv_order: Optional[np.ndarray] = None
        self.shard_tensor: Optional[ShardTensor] = None
        self._dim: Optional[int] = None
        self._n: int = 0
        self.host_memory_budget = parse_size(host_memory_budget)
        self.disk_path = disk_path
        self.adaptive_tiers = bool(adaptive_tiers)
        self.disk_read_workers = int(disk_read_workers)
        self.read_pool = read_pool
        self._pool_finalizer: Optional[weakref.finalize] = None
        self.tier_store = None  # tiers.TierStore when adaptive
        # (disk-local ids -> bool mask) of rows a flush-ahead prefetch has
        # staged in DRAM, installed by the pipeline that runs the prefetch
        # of a static disk tail; observe-only
        self.disk_staged = None

    def from_cpu_tensor(self, cpu_tensor) -> None:
        """Ingest the full ``[N, D]`` table (numpy or torch) in the stored
        dtype: reorder it by degree when a ``csr_topo`` is attached, then
        keep the first ``device_cache_size`` bytes of rows on the device
        and the rest in the pinned host tail (or, with a ``disk_path``, in
        the host and disk tiers: `_build_disk_tiers`)."""
        rows = _rows_of(cpu_tensor, self.dtype)
        self._n, self._dim = rows.shape
        cache_rows = min(self.device_cache_size // (self._dim * self.dtype.itemsize), self._n)
        if self.csr_topo is not None and not self._local_order_applied:
            _, order = reindex_feature(self.csr_topo, None, cache_rows / max(self._n, 1))
            inv = np.empty_like(order)
            inv[order] = np.arange(order.shape[0], dtype=order.dtype)
            rows = rows.index_select(0, torch.from_numpy(inv))  # stored row j: node inv[j]
            self.feature_order = order
            self.csr_topo.feature_order = order
            self._order_dev = torch.from_numpy(order.astype(np.int32)).to(self.device)
            self._inv_order = None
        if self.disk_path is not None:
            self._build_disk_tiers(rows, cache_rows)
            return
        st = ShardTensor(self.device, ShardTensorConfig({}), dtype=self.dtype)
        if cache_rows > 0:
            st.append(rows[:cache_rows], self.rank)
        if cache_rows < self._n:
            st.append(rows[cache_rows:], CPU_DEVICE)
        self.shard_tensor = st

    def _build_disk_tiers(self, rows: torch.Tensor, cache_rows: int) -> None:
        """The four-tier build: the device prefix, a host DRAM middle of
        ``host_memory_budget`` bytes, the rest on disk; ``rows`` are in the
        stored order. Adaptive mode builds a `tiers.TierStore` with the same
        initial placement, so a frozen adaptive store and a static one
        gather the same bytes from the same tiers."""
        row_bytes = self._dim * self.dtype.itemsize
        host_rows = 0
        if self.host_memory_budget > 0:
            host_rows = min(self.host_memory_budget // row_bytes, self._n - cache_rows)
        if self.read_pool is None:
            from .pipeline import AsyncReadPool

            self.read_pool = AsyncReadPool(self.disk_read_workers)
            # a pool of the feature's own: its threads end with the feature
            self._pool_finalizer = weakref.finalize(self, self.read_pool.shutdown, False)
        if self.adaptive_tiers:
            from .tiers import TierStore

            self.tier_store = TierStore.build(rows, self.disk_path, hbm_rows=cache_rows,
                                              host_rows=host_rows, device=self.device,
                                              read_pool=self.read_pool)
            self.shard_tensor = None
            return
        st = ShardTensor(self.device, ShardTensorConfig({}), dtype=self.dtype)
        if cache_rows > 0:
            st.append(rows[:cache_rows], self.rank)
        if host_rows > 0:
            st.append(rows[cache_rows: cache_rows + host_rows], CPU_DEVICE)
        if cache_rows + host_rows < self._n:
            st.append_disk(rows[cache_rows + host_rows:], self.disk_path,
                           read_pool=self.read_pool)
        self.shard_tensor = st

    def close(self) -> None:
        """Shut down the disk read pool this feature built and wait for its
        threads (a pool handed in as ``read_pool`` stays its caller's)."""
        fin = self._pool_finalizer
        if fin is not None and fin.detach() is not None:
            self.read_pool.shutdown(wait=True)

    def _float32_only(self, what: str) -> None:
        if self.dtype != torch.float32:
            raise TypeError(f"Feature.{what} reads float32 stores; this one holds {self.dtype} "
                            "(use gather_stored, or quant.QuantizedFeature to decode)")

    def __getitem__(self, node_idx) -> torch.Tensor:
        """Rows for (original) node ids on this feature's device, in one
        tiered-gather launch: ids remap through ``feature_order``; ids
        outside ``[0, N)`` (the sampler's sentinel padding) give zero
        rows."""
        self._float32_only("__getitem__")
        if self.tier_store is not None:
            stored, invalid = self._map_ids(node_idx)
            return self.tier_store.gather(np.where(invalid, -1, stored))
        return self.shard_tensor.gather(node_idx, n_valid=self._id_space(), order=self._order_dev)

    def _id_space(self) -> int:
        """The ids a lookup takes: ``[0, N)``, or with a local order every
        global id its map covers (unowned ones map to -1, a zero row)."""
        return self.feature_order.shape[0] if self._local_order_applied else self._n

    def _map_ids(self, node_idx):
        """(stored_rows, invalid_mask) of a lookup batch on the host;
        invalid lanes map to stored row 0."""
        if isinstance(node_idx, torch.Tensor):
            node_idx = node_idx.cpu().numpy()
        ids = np.asarray(node_idx).astype(np.int64).reshape(-1)
        invalid = (ids < 0) | (ids >= self._id_space())
        if invalid.any():
            ids = np.where(invalid, 0, ids)
        if self.feature_order is not None:
            ids = self.feature_order[ids]
        if self._local_order_applied:
            invalid |= ids < 0
            ids = np.where(invalid, 0, ids)
        return ids, invalid

    def gather_stored(self, stored) -> torch.Tensor:
        """Rows by stored row id (no remap) in the stored dtype, through
        whichever store backs this feature: one K3t launch on CUDA for the
        static shard book, one K5 launch for an adaptive store; ids outside
        the store give zero rows."""
        if self.tier_store is not None:
            if isinstance(stored, torch.Tensor):
                stored = stored.cpu().numpy()
            return self.tier_store.gather(stored)
        return self.shard_tensor[stored]

    def tier_bytes(self) -> Dict[str, int]:
        """Live per-tier byte footprint (an adaptive store reports its
        current placement)."""
        if self.tier_store is not None:
            return self.tier_store.tier_bytes()
        return {} if self.shard_tensor is None else self.shard_tensor.tier_bytes()

    def stored_rows_of(self, node_ids) -> np.ndarray:
        """Node id -> stored row (-1 for out-of-range ids)."""
        stored, invalid = self._map_ids(node_ids)
        return np.where(invalid, -1, stored)

    def node_ids_of_stored(self, stored) -> np.ndarray:
        """Stored row -> node id (the inverse of ``feature_order``;
        identity without a reorder)."""
        stored = np.asarray(stored, np.int64).reshape(-1)
        if self.feature_order is None:
            return stored
        if self._inv_order is None:
            inv = np.empty(self.feature_order.shape[0], np.int64)
            inv[self.feature_order] = np.arange(self.feature_order.shape[0], dtype=np.int64)
            self._inv_order = inv
        return self._inv_order[stored]

    @property
    def resident(self) -> bool:
        """Whether every row lives on the device (`lookup_padded` works)."""
        st = self.shard_tensor
        return (st is not None and st.cpu_tensor is None and st.disk_shard is None
                and len(st.device_shards) == 1)

    def lookup_padded(self, node_idx: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gather for padded id tensors of a fully device-resident
        feature: ids are clipped into ``[0, N)`` (not zero-filled),
        remapped through ``feature_order``, clipped into the table, and
        the rows of lanes where ``valid`` is False are zeroed."""
        if not self.resident:
            raise ValueError(
                "lookup_padded needs a fully device-resident feature; "
                "use __getitem__ (tiered)"
            )
        self._float32_only("lookup_padded")
        if not isinstance(node_idx, torch.Tensor):
            node_idx = torch.from_numpy(np.asarray(node_idx).astype(np.int64))
        if node_idx.dtype != torch.int32:  # clamped first, so the clip is unchanged
            node_idx = torch.clamp(node_idx.to(torch.int64), -1, self._id_space()).to(torch.int32)
        rows = gather_rows(self.shard_tensor.device_rows, node_idx.to(self.device),
                           self._order_dev)
        if valid is not None:
            rows = rows * valid[:, None].to(rows.dtype)
        return rows

    def validate_ids(self, node_idx) -> np.ndarray:
        """Strict opt-in id check: raise instead of the lookups' silent
        clip or zero-fill. See :func:`validate_lookup_ids`."""
        return validate_lookup_ids(node_idx, self._n)

    @property
    def shape(self):
        return (self._n, self._dim)

    @property
    def dim(self) -> int:
        return self._dim or 0

    def size(self, axis: int) -> int:
        return self.shape[axis]

    def set_local_order(self, local_order) -> None:
        """After cross-host partitioning this host stores only its rows, in
        the order of ``local_order`` (their global ids): map global id ->
        local row, -1 for ids it does not own (a zero row)."""
        local_order = np.asarray(local_order, dtype=np.int64)
        order = np.full(int(local_order.max()) + 1 if local_order.size else 0, -1, np.int64)
        order[local_order] = np.arange(local_order.shape[0], dtype=np.int64)
        self.feature_order = order
        self._order_dev = torch.from_numpy(order.astype(np.int32)).to(self.device)
        self._inv_order = None
        self._local_order_applied = True


class PartitionInfo:
    """Cross-host partition metadata: ``global2host`` maps node id -> owning
    host; ``replicate`` lists remote ids this host also holds, after its own
    rows."""

    def __init__(self, device, host: int, hosts: int, global2host, replicate=None):
        self.device = device
        self.host = host
        self.hosts = hosts
        self.global2host = np.asarray(global2host, dtype=np.int32)
        self.replicate = None if replicate is None else np.asarray(replicate, dtype=np.int64)
        self._build_global2local()

    def _build_global2local(self):
        """global id -> owner-local row for every host (each host's owned ids
        rank 0..n_h-1); replicated ids follow this host's owned rows."""
        n = self.global2host.shape[0]
        self.global2local = np.zeros(n, dtype=np.int64)
        for h in range(self.hosts):
            owned = np.nonzero(self.global2host == h)[0]
            self.global2local[owned] = np.arange(owned.shape[0])
        local_mask = self.global2host == self.host
        if self.replicate is not None:
            local_mask = local_mask.copy()
            owned_count = int(local_mask.sum())
            rep = self.replicate[~local_mask[self.replicate]]
            self.global2local[rep] = owned_count + np.arange(rep.shape[0])
            local_mask[rep] = True
        self.local_ids = np.nonzero(local_mask)[0]
        self.local_mask = local_mask

    def dispatch(self, ids: np.ndarray):
        """Split a request batch by owning host: ``(per_host_ids,
        local_ids, per_host_positions, local_positions)``."""
        ids = np.asarray(ids).astype(np.int64)
        local = self.local_mask[ids]
        local_pos = np.nonzero(local)[0]
        remote_pos = np.nonzero(~local)[0]
        owner = self.global2host[ids[remote_pos]]
        per_host, per_pos = [], []
        for h in range(self.hosts):
            sel = remote_pos[owner == h]
            per_host.append(ids[sel])
            per_pos.append(sel)
        return per_host, ids[local_pos], per_pos, local_pos


class DistFeature:
    """Multi-host feature lookup: dispatch ids by owner, exchange the remote
    ones over ``comm`` (owner-local rows), merge with the local gather.
    Collective: every host calls ``__getitem__`` together. Returns ``[n, D]``
    float32 on the local feature's device."""

    def __init__(self, feature: Feature, info: PartitionInfo, comm):
        self.feature = feature
        self.info = info
        self.comm = comm

    def __getitem__(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids).astype(np.int64).reshape(-1)
        per_host, local_ids, per_pos, local_pos = self.info.dispatch(ids)
        per_host_local = [self.info.global2local[h_ids] for h_ids in per_host]
        if not getattr(self.comm, "multiprocess", False) and not any(
                len(h) for h in per_host_local):
            # a shard-local lookup skips the collective (single controller
            # only: processes of a pod must all enter it together)
            remote: List[Optional[torch.Tensor]] = [None] * self.info.hosts
        else:
            remote = self.comm.exchange(per_host_local)
        dev = self.feature.device
        out = torch.zeros((ids.shape[0], self.feature.dim), dtype=torch.float32, device=dev)
        if local_ids.size:
            # a Feature with a local order maps global ids itself
            q = local_ids if self.feature._local_order_applied else (
                self.info.global2local[local_ids])
            out[torch.from_numpy(local_pos).to(dev)] = self.feature[q].to(dev)
        for h, rows in enumerate(remote):
            if rows is not None and per_pos[h].size:
                out[torch.from_numpy(per_pos[h]).to(dev)] = torch.as_tensor(rows).to(dev)
        return out

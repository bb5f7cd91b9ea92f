"""QuantizedFeature — the tiered feature store over encoded rows, the port
of ``quiver_tpu/quant/feature.py`` under ``device_replicate`` on one
device.

It composes a `Feature` rather than repeating it: the degree reorder
happens here (so the per-row side tables stay aligned with the stored
order), then an inner ``Feature(dtype=codec.storage_dtype)`` tiers the
encoded payload — a device prefix and a pinned host tail, both encoded.
It answers to the attributes `pipeline.TieredFeaturePipeline` reads
(``shard_tensor``, ``feature_order``, ``dim``, ``shape``, ``dtype``), so the
pipeline stages encoded cold rows, the host-to-device copy carries the
codec's width, and the step decodes after the scatter
(`lookup.quantized_tiered_lookup`, K9b).

Capacity accounting: the side tables (int8: float32 scale and zero over
all N rows) live on the device whatever the hot share, so their bytes are
charged against ``device_cache_size`` first and the rest buys hot payload
rows; a budget the side tables alone overflow raises.

The disk and adaptive tiers (``host_memory_budget``, ``disk_path``,
``adaptive_tiers``, ``disk_read_workers``, ``read_pool``) pass through to
the inner `Feature`, so the disk tail (or the adaptive backing file) holds
encoded rows: they cross the disk, the link and the staging at the codec's
width and K9b decodes them after the upload.

Not ported yet: the clique stripe (``p2p_clique_replicate`` raises) and,
as in `Feature`, the observe-only taps (``tier_counter``, ``row_tap``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..feature import Feature, validate_lookup_ids
from ..shard_tensor import normalize_dtype
from ..utils import CSRTopo, parse_size, reindex_feature, resolve_device
from .codecs import QuantizedRows, get_codec
from .lookup import gather_dequant


class QuantizedFeature:
    """Tiered ``[N, D]`` feature store holding codec-encoded rows.

    The constructor is `Feature`'s plus ``codec`` (a registry name —
    ``"fp32"``, ``"bf16"``, ``"int8"`` — or an object meeting the codec
    contract of `quant.codecs`).
    """

    def __init__(self, codec: Union[str, object] = "int8", rank: int = 0,
                 device_list: Optional[Sequence[int]] = None,
                 device_cache_size: Union[int, str] = 0,
                 cache_policy: str = "device_replicate", csr_topo: Optional[CSRTopo] = None,
                 device=None, host_memory_budget: Union[int, str] = 0,
                 disk_path: Optional[str] = None, adaptive_tiers: bool = False,
                 disk_read_workers: int = 4, read_pool=None):
        if cache_policy == "ici_replicate":
            cache_policy = "p2p_clique_replicate"
        if cache_policy != "device_replicate":
            raise NotImplementedError(f"cache_policy {cache_policy!r} is not ported yet")
        self.codec = get_codec(codec)
        self.host_memory_budget = host_memory_budget
        self.disk_path = disk_path
        self.adaptive_tiers = bool(adaptive_tiers)
        self.disk_read_workers = int(disk_read_workers)
        self.read_pool = read_pool
        self.rank = rank
        self.device_list = list(device_list) if device_list else [rank]
        self.device_cache_size = parse_size(device_cache_size)
        self.cache_policy = cache_policy
        self.csr_topo = csr_topo
        self.device = resolve_device(f"cuda:{rank}" if device is None else device)
        self.feature_order: Optional[np.ndarray] = None
        self._inv_order: Optional[np.ndarray] = None
        self.inner: Optional[Feature] = None
        self._n = 0
        self._dim: Optional[int] = None
        self._scale_np: Optional[np.ndarray] = None
        self._zero_np: Optional[np.ndarray] = None
        self._scale_dev: Optional[torch.Tensor] = None
        self._zero_dev: Optional[torch.Tensor] = None
        self._order_dev: Optional[torch.Tensor] = None

    # -- build -------------------------------------------------------------------

    def from_cpu_tensor(self, cpu_tensor) -> None:
        """Ingest the float32 table: reorder it (degree-descending when a
        ``csr_topo`` is attached), encode it, then tier the encoded payload
        through an inner `Feature`."""
        if isinstance(cpu_tensor, torch.Tensor):
            cpu_tensor = cpu_tensor.detach().cpu().numpy()
        arr = np.asarray(cpu_tensor, np.float32)
        if arr.ndim != 2:
            raise ValueError("features must be [N, D]")
        self._n, self._dim = arr.shape
        side_total = self.codec.side_bytes_per_row * self._n
        if 0 < self.device_cache_size < side_total:
            # a stated budget the side tables alone overflow is a configuration
            # error (0 stays the explicit all-cold choice)
            raise ValueError(
                f"device_cache_size ({self.device_cache_size} B) cannot even hold the "
                f"{self.codec.name} codec's device-resident side tables ({int(side_total)} B "
                f"for N={self._n}); raise the budget or use a sideless codec (bf16)")
        payload_row_bytes = self._dim * normalize_dtype(self.codec.storage_dtype).itemsize
        cache_rows = min(int(max(0.0, self.device_cache_size - side_total) // payload_row_bytes),
                         self._n)
        if self.csr_topo is not None:
            # Feature's hot-ratio policy, with rows priced at the codec's width
            arr, order = reindex_feature(self.csr_topo, arr, cache_rows / max(self._n, 1))
            self.feature_order = order
            self.csr_topo.feature_order = order
            self._inv_order = None
        enc = self.codec.encode(arr)
        # the inner Feature derives its hot rows from its own row bytes: hand
        # it exactly cache_rows of payload (no csr_topo: reordered above)
        inner = Feature(rank=self.rank, device_list=self.device_list,
                        device_cache_size=cache_rows * payload_row_bytes,
                        cache_policy=self.cache_policy, dtype=self.codec.storage_dtype,
                        device=self.device, host_memory_budget=self.host_memory_budget,
                        disk_path=self.disk_path, adaptive_tiers=self.adaptive_tiers,
                        disk_read_workers=self.disk_read_workers, read_pool=self.read_pool)
        inner.from_cpu_tensor(enc.payload)
        self.inner = inner
        self._scale_np = None if enc.scale is None else np.asarray(enc.scale, np.float32)
        self._zero_np = None if enc.zero is None else np.asarray(enc.zero, np.float32)
        self._scale_dev = self._zero_dev = self._order_dev = None

    # -- what the pipeline and the tests read ---------------------------------------

    @property
    def shard_tensor(self):
        return None if self.inner is None else self.inner.shard_tensor

    @property
    def tier_store(self):
        """The inner store's adaptive `tiers.TierStore` (None when static):
        placement moves encoded rows."""
        return None if self.inner is None else self.inner.tier_store

    @property
    def disk_staged(self):
        """The inner store's flush-ahead staging mask hook (see
        `Feature.disk_staged`)."""
        return None if self.inner is None else self.inner.disk_staged

    @disk_staged.setter
    def disk_staged(self, fn):
        if self.inner is None:
            raise ValueError("disk_staged needs a built feature (call from_cpu_tensor first)")
        self.inner.disk_staged = fn

    def tier_bytes(self):
        """Encoded payload bytes per tier; the side tables are reported by
        `side_table_bytes`."""
        return {} if self.inner is None else self.inner.tier_bytes()

    def _stored(self, ids: np.ndarray):
        """(stored rows, invalid mask) of node ids on the host; invalid
        lanes map to the stored row of node 0."""
        invalid = (ids < 0) | (ids >= self._n)
        safe = np.where(invalid, 0, ids)
        return (self.feature_order[safe] if self.feature_order is not None else safe), invalid

    def stored_rows_of(self, node_ids) -> np.ndarray:
        """Node id -> stored (encoded) row; -1 out of range."""
        stored, invalid = self._stored(np.asarray(node_ids).astype(np.int64).reshape(-1))
        return np.where(invalid, -1, stored)

    def node_ids_of_stored(self, stored) -> np.ndarray:
        """Stored row -> node id (the inverse of the reorder)."""
        stored = np.asarray(stored, np.int64).reshape(-1)
        if self.feature_order is None:
            return stored
        if self._inv_order is None:
            inv = np.full(self._n, -1, np.int64)
            inv[self.feature_order] = np.arange(self._n, dtype=np.int64)
            self._inv_order = inv
        return self._inv_order[stored]

    @property
    def dtype(self) -> torch.dtype:
        return self.codec.storage_dtype

    @property
    def shape(self):
        return (self._n, self._dim)

    @property
    def dim(self) -> int:
        return self._dim or 0

    def size(self, axis: int) -> int:
        return self.shape[axis]

    @property
    def hot_rows(self) -> int:
        """Encoded rows resident on the device (the hot prefix, or an
        adaptive store's HBM residents)."""
        if self.tier_store is not None:
            return self.tier_store.placement.counts()["hbm"]
        st = self.shard_tensor
        return 0 if st is None else sum(o.end - o.start for _, _, o in st.device_shards)

    def side_table_bytes(self) -> int:
        """Bytes of the device-resident side tables (0 for sideless codecs)."""
        return 0 if self._scale_np is None else self._scale_np.nbytes + self._zero_np.nbytes

    @property
    def scale(self) -> Optional[torch.Tensor]:
        """``[N_stored]`` float32 scale table on the device (None without
        side tables)."""
        if self._scale_np is not None and self._scale_dev is None:
            self._scale_dev = torch.from_numpy(self._scale_np).to(self.device)
        return self._scale_dev

    @property
    def zero(self) -> Optional[torch.Tensor]:
        if self._zero_np is not None and self._zero_dev is None:
            self._zero_dev = torch.from_numpy(self._zero_np).to(self.device)
        return self._zero_dev

    # -- lookups ---------------------------------------------------------------------

    def __getitem__(self, node_idx) -> torch.Tensor:
        """Tiered gather and decode by original node id on the device: the
        encoded rows cross the tiers at the codec's width (one K3t launch
        over the inner store), then the batch is decoded; invalid ids give
        zero rows, as ``Feature.__getitem__``'s do."""
        if isinstance(node_idx, torch.Tensor):
            node_idx = node_idx.cpu().numpy()
        stored, invalid = self._stored(np.asarray(node_idx).astype(np.int64).reshape(-1))
        q = self.inner.gather_stored(np.where(invalid, -1, stored))
        if self._scale_np is not None:
            idx = torch.from_numpy(stored).to(self.device)
            x = self.codec.dequant(q, self.scale[idx], self.zero[idx])
        else:
            x = self.codec.dequant(q)
        return x * torch.from_numpy(~invalid).to(self.device, x.dtype)[:, None]

    def lookup_padded(self, node_idx: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused gather and decode (K9a) for a fully device-resident table:
        ids clipped into ``[0, N)`` (not zero-filled), through the feature
        order, as ``Feature.lookup_padded``; lanes where ``valid`` is False
        are zeroed."""
        st = self.shard_tensor
        if st is None or st.cpu_tensor is not None or len(st.device_shards) != 1:
            raise ValueError("lookup_padded needs a fully device-resident feature; use "
                             "__getitem__ (tiered) or the quantized pipeline")
        if not isinstance(node_idx, torch.Tensor):
            node_idx = torch.from_numpy(np.asarray(node_idx).astype(np.int64))
        if node_idx.dtype != torch.int32:  # clamped first, so the clip is unchanged
            node_idx = torch.clamp(node_idx.to(torch.int64), -1, self._n).to(torch.int32)
        if self.feature_order is not None and self._order_dev is None:
            self._order_dev = torch.from_numpy(self.feature_order.astype(np.int32)).to(self.device)
        rows = gather_dequant(self.codec, st.device_shards[0][1], node_idx.to(self.device),
                              self.scale, self.zero, index_map=self._order_dev)
        if valid is not None:
            rows = rows * valid[:, None].to(rows.dtype)
        return rows

    def validate_ids(self, node_idx) -> np.ndarray:
        """Opt-in strict id check on the host (see `Feature.validate_ids`)."""
        return validate_lookup_ids(node_idx, self._n)

    def decode_rows(self, node_idx) -> np.ndarray:
        """The host oracle: rows by original node id, gathered through the
        tiers and decoded with the codec's numpy `decode` (for tests and
        debugging; the fused paths are held against it)."""
        stored, invalid = self._stored(np.asarray(node_idx).astype(np.int64).reshape(-1))
        q = self.inner.gather_stored(stored).cpu()
        enc = QuantizedRows(q, None if self._scale_np is None else self._scale_np[stored],
                            None if self._zero_np is None else self._zero_np[stored])
        x = np.array(self.codec.decode(enc), np.float32)  # a writable copy
        x[invalid] = 0.0
        return x

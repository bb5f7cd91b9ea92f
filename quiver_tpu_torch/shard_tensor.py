"""ShardTensor — one logical ``[N, D]`` tensor over up to three tiers: the
port of ``quiver_tpu/shard_tensor.py`` (``normalize_dtype``, ``Offset``,
``ShardTensorConfig``, ``ShardTensor``) on one device.

Rows ``[0, H)`` live in device memory, the next rows in a pinned host
tail (``tensor.pin_memory()``) and, after `ShardTensor.append_disk`, the
last ones in a flat ``.npy`` file on disk (`tiers.DiskShard`), all in the
stored dtype: float32, int8 or bfloat16 (the encoded rows of a quantized
store). `tiered_gather` reads the first two in one launch of the kernel of
``csrc/gather.cu``: host rows are read in-kernel through the tail's mapped
device pointer, as the reference's ``shard_tensor.cu.hpp`` did, so there is
no host gather, no staging copy and no scatter merge. Disk rows are read
on the host (through the read pool when one is attached) into a pinned
staging tensor, copied to the card, and scattered into their output rows
by the same call, after the gather. On a CPU device every tier is a CPU
tensor and `tiered_gather_plain` runs instead.

bfloat16 stays a torch dtype end to end: numpy has no bfloat16 without
``ml_dtypes``, so rows are torch tensors here and a float32 table is
converted with ``Tensor.to(torch.bfloat16)`` (round to nearest even, as
``ml_dtypes`` rounds); on disk a bfloat16 row is stored as its int16 bits.

Not ported yet: a second device shard (the clique stripe) and the IPC
handles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import _kernels
from .utils import parse_size, resolve_device

CPU_DEVICE = -1  # the reference's device id of the pinned host shard


STORE_DTYPES = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}


def normalize_dtype(dtype) -> torch.dtype:
    """The store dtype of a tiered tensor as a torch dtype: float32, int8 or
    bfloat16 (spelt ``"bfloat16"``, ``"bf16"``, ``torch.bfloat16`` or an
    ``ml_dtypes`` numpy dtype). Any other dtype raises."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif str(dtype) in ("bfloat16", "bf16"):
        name = "bfloat16"
    else:
        name = np.dtype(dtype).name
    if name not in STORE_DTYPES:
        raise TypeError(f"dtype {dtype} is not ported yet: the port stores "
                        f"{', '.join(STORE_DTYPES)}")
    return STORE_DTYPES[name]


@dataclass
class Offset:
    """Row range [start, end) owned by one shard."""

    start: int
    end: int


@dataclass
class ShardTensorConfig:
    """Per-device memory budget: device rank -> bytes (int or "200M")."""

    device_memory_budget: Dict[int, Union[int, str]] = field(default_factory=dict)

    def __post_init__(self):
        self.device_memory_budget = {
            int(d): parse_size(v) for d, v in self.device_memory_budget.items()
        }

    @property
    def device_list(self) -> List[int]:
        return sorted(self.device_memory_budget.keys())


def _rows_of(tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tensor`` (numpy or torch, 2-D) as a contiguous CPU tensor of
    ``dtype``; a float table becomes bfloat16 by ``Tensor.to`` (round to
    nearest even)."""
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.from_numpy(np.ascontiguousarray(tensor))
    if tensor.dim() != 2:
        raise ValueError("ShardTensor shards must be 2-D")
    return tensor.detach().to("cpu", dtype).contiguous()


def rows_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """A CPU row tensor as numpy for a `tiers.DiskShard`: bfloat16 rows as
    their int16 bits."""
    if rows.dtype == torch.bfloat16:
        rows = rows.view(torch.int16)
    return rows.numpy()


def rows_from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Rows read from a `tiers.DiskShard` as a CPU tensor of the store's
    ``dtype`` (the inverse of `rows_to_numpy`; no copy)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(dtype) if t.dtype != dtype else t


def _ids_on(ids, device: torch.device, n_valid: int) -> torch.Tensor:
    """Lookup ids as int32 on ``device``. Ids outside ``[0, n_valid)`` stay
    outside it (they are clamped to -1 or ``n_valid``), so the gather
    still zero-fills them after the cast."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids).astype(np.int64).reshape(-1))
    ids = ids.reshape(-1)
    if ids.dtype != torch.int32:
        ids = torch.clamp(ids.to(torch.int64), -1, n_valid).to(torch.int32)
    if ids.device != device:
        ids = ids.to(device)
    return ids


def tiered_gather_plain(dev_rows: Optional[torch.Tensor], host_rows: Optional[torch.Tensor],
                        ids: torch.Tensor, n_valid: int,
                        order: Optional[torch.Tensor] = None,
                        disk_rows: Optional[torch.Tensor] = None,
                        disk_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of `tiered_gather` on ``ids``' device: the
    device rows are indexed where they are, the host rows on the host,
    then the staged disk rows are written into their slots."""
    dev = ids.device
    some = next(t for t in (dev_rows, host_rows, disk_rows) if t is not None)
    H = 0 if dev_rows is None else dev_rows.shape[0]
    n_host = 0 if host_rows is None else host_rows.shape[0]
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_valid)
    s = torch.where(valid, ids, 0)
    if order is not None:
        s = order.to(dev)[s].to(torch.int64)
    valid &= (s >= 0) & (s < H + n_host)
    out = torch.zeros((ids.shape[0], some.shape[1]), dtype=some.dtype, device=dev)
    in_dev = valid & (s < H)
    if H:
        out[in_dev] = dev_rows[s[in_dev].to(dev_rows.device)].to(dev)
    in_host = valid & (s >= H)
    if n_host:
        out[in_host] = host_rows[(s[in_host] - H).cpu()].to(dev)
    if disk_rows is not None and disk_rows.shape[0]:
        p = disk_pos.to(dev, torch.int64)
        keep = (p >= 0) & (p < ids.shape[0])
        out[p[keep]] = disk_rows.to(dev)[keep]
    return out


def tiered_gather(dev_rows: Optional[torch.Tensor], host_rows: Optional[torch.Tensor],
                  ids: torch.Tensor, n_valid: int,
                  order: Optional[torch.Tensor] = None,
                  disk_rows: Optional[torch.Tensor] = None,
                  disk_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of the tiered table for ``ids`` as ``[len(ids), D]`` on
    ``ids``' device, in the tiers' dtype (float32, int8 or bfloat16): ids
    outside ``[0, n_valid)`` give zero rows; the stored row is
    ``order[id]`` (``id`` without an order), read from ``dev_rows [H, D]``
    when below H, from ``host_rows [R, D]`` (pinned host memory) when in
    ``[H, H + R)`` and zero beyond; then staged ``disk_rows [C, D]`` (on
    ``ids``' device) land in output rows ``disk_pos [C]`` (int32; positions
    outside ``[0, len(ids))`` are padding). Bit-equal copies."""
    if dev_rows is None and host_rows is None and disk_rows is None:
        raise ValueError("a tiered gather needs at least one tier")
    if ids.dim() != 1:
        raise ValueError(f"ids must be [n]; got {tuple(ids.shape)}")
    if (disk_rows is None) != (disk_pos is None):
        raise ValueError("disk_rows and disk_pos come together")
    if not ids.is_cuda:
        return tiered_gather_plain(dev_rows, host_rows, ids, n_valid, order, disk_rows, disk_pos)
    some = next(t for t in (dev_rows, host_rows, disk_rows) if t is not None)
    for t, name in ((dev_rows, "device rows"), (host_rows, "host rows"),
                    (disk_rows, "disk rows")):
        if t is not None and (t.dtype not in STORE_DTYPES.values() or t.dtype != some.dtype
                              or t.dim() != 2 or not t.is_contiguous()):
            raise TypeError(f"the tiered gather takes contiguous [R, D] {name} of one "
                            f"dtype of {', '.join(STORE_DTYPES)}")
    if dev_rows is not None and dev_rows.device != ids.device:
        raise ValueError(f"device rows on {dev_rows.device} but ids on {ids.device}")
    if host_rows is not None and (host_rows.is_cuda or not host_rows.is_pinned()):
        raise ValueError("the host tail must be a pinned CPU tensor")
    if order is not None and (order.device != ids.device or order.dtype != torch.int32):
        raise TypeError("order must be an int32 tensor on the ids' device")
    if disk_rows is not None and (disk_rows.device != ids.device or disk_pos.device != ids.device
                                  or disk_pos.dtype != torch.int32
                                  or disk_pos.shape != disk_rows.shape[:1]):
        raise TypeError("disk rows [C, D] and int32 disk_pos [C] must lie on the ids' device")
    if ids.dtype != torch.int32:
        raise TypeError(f"the tiered gather takes int32 ids; got {ids.dtype}")
    ids = ids.contiguous()
    D = some.shape[1]
    out = torch.empty((ids.shape[0], D), dtype=some.dtype, device=ids.device)
    if ids.shape[0] == 0 or D == 0:
        return out
    host_ptr = None
    if host_rows is not None and host_rows.shape[0] > 0:
        host_ptr = _kernels.host_device_pointer(host_rows)
    n_disk = 0 if disk_rows is None else disk_rows.shape[0]
    if n_disk:
        disk_rows, disk_pos = disk_rows.contiguous(), disk_pos.contiguous()
    variant = str(some.dtype).removeprefix("torch.")
    _kernels.launch(
        "tiered_gather",
        dev_rows.data_ptr() if dev_rows is not None else None,
        0 if dev_rows is None else dev_rows.shape[0], host_ptr,
        0 if host_rows is None else host_rows.shape[0], D * some.element_size(), ids.data_ptr(),
        ids.shape[0],
        int(n_valid), order.contiguous().data_ptr() if order is not None else None,
        disk_rows.data_ptr() if n_disk else None, n_disk,
        disk_pos.data_ptr() if n_disk else None,
        out.data_ptr(), _kernels.stream_of(ids),
        variant=(variant, "disk") if n_disk else variant,
    )
    return out


class ShardTensor:
    """Logical row-sharded tensor: one device shard (rows ``[0, H)``)
    then a host tail (rows ``[H, N)``), in `append` order as in the
    reference, both in ``dtype`` (see `normalize_dtype`).
    ``current_device`` is a CUDA ordinal or any torch device (``"cpu"``
    runs the plain version); the tail is pinned on CUDA."""

    def __init__(self, current_device: Union[int, str, torch.device] = 0,
                 shard_tensor_config: Optional[ShardTensorConfig] = None, dtype=np.float32):
        if isinstance(current_device, int):
            current_device = f"cuda:{current_device}"
        self.device = resolve_device(current_device)
        self.config = shard_tensor_config or ShardTensorConfig({})
        self.dtype = normalize_dtype(dtype)
        self.device_shards: List[tuple] = []  # (device_rank, tensor, Offset), at most one
        self.cpu_tensor: Optional[torch.Tensor] = None
        self.cpu_offset: Optional[Offset] = None
        self.disk_shard = None  # tiers.DiskShard, the final tier
        self.disk_offset: Optional[Offset] = None
        self.read_pool = None   # pipeline.AsyncReadPool for the disk reads
        self._host_order = None  # (order tensor, its int64 numpy copy) for the disk reads
        self._n_rows = 0
        self._dim: Optional[int] = None

    def append(self, tensor, device: int) -> None:
        """Place ``tensor`` as the next row range: on this handle's device
        for a rank >= 0, in the pinned host tail for -1."""
        if self.disk_shard is not None:
            raise ValueError("the disk shard must be the final tier")
        arr = _rows_of(tensor, self.dtype)
        if self._dim is None:
            self._dim = arr.shape[1]
        elif arr.shape[1] != self._dim:
            raise ValueError("shard dim mismatch")
        off = Offset(self._n_rows, self._n_rows + arr.shape[0])
        if device == CPU_DEVICE:
            if self.cpu_tensor is not None:
                raise ValueError("host shard already set")
            host = arr
            if self.device.type == "cuda":
                host = host.pin_memory()
            self.cpu_tensor = host
            self.cpu_offset = off
        else:
            if self.cpu_tensor is not None:
                raise ValueError("device shards must precede the host shard")
            if self.device_shards:
                raise NotImplementedError(
                    "a second device shard (the clique stripe) is not ported yet")
            self.device_shards.append((device, arr.to(self.device, copy=True), off))
        self._n_rows = off.end

    def append_disk(self, tensor, path: str, read_pool=None) -> None:
        """Spill ``tensor`` as the final tier: a flat ``.npy`` row file at
        ``path`` in the stored dtype (a quantized store spills its encoded
        rows). Reads go through ``read_pool`` (`pipeline.AsyncReadPool`)
        when one is attached, else one synchronous page-cache read."""
        from .tiers import DiskShard  # tiers imports this module

        if self.disk_shard is not None:
            raise ValueError("disk shard already set")
        arr = _rows_of(tensor, self.dtype)
        if self._dim is None:
            self._dim = arr.shape[1]
        elif arr.shape[1] != self._dim:
            raise ValueError("shard dim mismatch")
        self.disk_shard = DiskShard.create(path, rows_to_numpy(arr))
        self.disk_offset = Offset(self._n_rows, self._n_rows + arr.shape[0])
        self._n_rows = self.disk_offset.end
        if read_pool is not None:
            self.read_pool = read_pool

    @classmethod
    def new_from_cpu_tensor(cls, tensor, shard_tensor_config: ShardTensorConfig,
                            current_device: Union[int, str, torch.device] = 0,
                            dtype=np.float32) -> "ShardTensor":
        """Budget-based split: the device shard takes as many rows as its
        budget holds, the host tail the rest."""
        self = cls(current_device, shard_tensor_config, dtype=dtype)
        arr = _rows_of(tensor, self.dtype)
        row_bytes = arr.shape[1] * self.dtype.itemsize
        cursor = 0
        for dev in self.config.device_list:
            rows = min(self.config.device_memory_budget[dev] // row_bytes, arr.shape[0] - cursor)
            if rows <= 0:
                continue
            self.append(arr[cursor: cursor + rows], dev)
            cursor += rows
        if cursor < arr.shape[0]:
            self.append(arr[cursor:], CPU_DEVICE)
        return self

    from_cpu_tensor = new_from_cpu_tensor

    @property
    def shape(self):
        return (self._n_rows, self._dim or 0)

    @property
    def size(self):
        return self._n_rows * (self._dim or 0)

    @property
    def device_rows(self) -> Optional[torch.Tensor]:
        return self.device_shards[0][1] if self.device_shards else None

    def device_ratio(self) -> float:
        dev_rows = sum(o.end - o.start for _, _, o in self.device_shards)
        return dev_rows / max(self._n_rows, 1)

    def tier_bytes(self) -> Dict[str, int]:
        """Byte footprint per tier at the stored dtype."""
        row = (self._dim or 0) * self.dtype.itemsize
        dev = sum((o.end - o.start) * row for _, _, o in self.device_shards)
        host = 0 if self.cpu_tensor is None else (self.cpu_offset.end - self.cpu_offset.start) * row
        disk = 0 if self.disk_shard is None else (self.disk_offset.end - self.disk_offset.start) * row
        return {"device": dev, "host": host, "disk": disk, "row": row}

    def gather(self, ids, n_valid: Optional[int] = None,
               order: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`tiered_gather` of this tensor's tiers on this handle's device:
        ids outside ``[0, n_valid)`` (default: the row count) give zero
        rows; ``order`` remaps ids to stored rows first."""
        n_valid = self._n_rows if n_valid is None else int(n_valid)
        dev_ids = _ids_on(ids, self.device, n_valid)
        disk_rows = disk_pos = None
        if self.disk_shard is not None:
            disk_rows, disk_pos = self._stage_disk(ids, n_valid, order)
        return tiered_gather(self.device_rows, self.cpu_tensor, dev_ids, n_valid, order,
                             disk_rows, disk_pos)

    def _stage_disk(self, ids, n_valid, order):
        """The disk rows of a gather on this handle's device: ``(rows [C,
        D], pos [C] int32)``, read on the host and copied from pinned
        staging on CUDA; ``(None, None)`` when no id lands on disk. The
        host read remaps through a host copy of ``order``, made once per
        order tensor."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids).astype(np.int64).reshape(-1)
        valid = (ids >= 0) & (ids < n_valid)
        s = np.where(valid, ids, 0)
        if order is not None:
            held = self._host_order
            if held is None or held[0] is not order:
                held = self._host_order = (order, order.cpu().numpy().astype(np.int64))
            s = held[1][s]
        off = self.disk_offset
        (sel,) = np.nonzero(valid & (s >= off.start) & (s < off.end))
        if sel.size == 0:
            return None, None
        rows = rows_from_numpy(self.disk_shard.read_rows(s[sel] - off.start, pool=self.read_pool),
                               self.dtype)
        pos = torch.from_numpy(sel.astype(np.int32))
        if self.device.type == "cuda":
            rows, pos = rows.pin_memory(), pos.pin_memory()
        return (rows.to(self.device, non_blocking=True),
                pos.to(self.device, non_blocking=True))

    def __getitem__(self, ids) -> torch.Tensor:
        """Rows by global id on this handle's device; ids outside every
        shard give zero rows."""
        return self.gather(ids)

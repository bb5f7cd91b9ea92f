"""Graph topology container and small helpers — the port of
``quiver_tpu/utils.py`` (``CSRTopo``, ``parse_size``, ``_best_id_dtype``).

Topology lives in host numpy arrays and is materialised on a torch device
on demand. Ids on the device are int32 wherever the JAX package uses int32
(JAX runs with x64 off; torch would keep int64 silently), int64 only for
graphs whose ids do not fit.
"""

from __future__ import annotations

import re
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA was asked for (or defaulted to) and no card
    is present — nothing carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "torch versions of the kernels on the CPU"
        )
    return dev


def parse_size(sz: Union[int, str, float]) -> int:
    """Parse a human byte size like ``"200M"``, ``"4GB"``, ``"1.5g"`` to bytes."""
    if isinstance(sz, (int, np.integer)):
        return int(sz)
    if isinstance(sz, float):
        return int(sz)
    s = str(sz).strip().upper()
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)\s*([KMGT]?)B?", s)
    if not m:
        raise ValueError(f"Cannot parse size: {sz!r}")
    value = float(m.group(1))
    unit = m.group(2)
    mult = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}[unit]
    return int(value * mult)


def _best_id_dtype(max_value: int) -> np.dtype:
    """int32 when every index fits, else int64."""
    return np.dtype(np.int32) if max_value < 2**31 - 1 else np.dtype(np.int64)


class CSRTopo:
    """CSR graph topology (``indptr [N+1]``, ``indices [E]`` host int64).

    Build from an ``edge_index`` COO pair ``[2, E]`` (stable counting sort
    on the source row, as the JAX package does) or from ``(indptr,
    indices)``. `to_device` and `to_device_tiled` return cached tensors.
    """

    def __init__(self, edge_index=None, indptr=None, indices=None,
                 num_nodes: Optional[int] = None):
        if edge_index is not None:
            edge_index = np.asarray(edge_index)
            if edge_index.shape[0] != 2:
                raise ValueError("edge_index must be [2, E]")
            src = np.asarray(edge_index[0], dtype=np.int64)
            dst = np.asarray(edge_index[1], dtype=np.int64)
            n = int(num_nodes) if num_nodes is not None else int(
                max(src.max(initial=-1), dst.max(initial=-1)) + 1
            )
            order = np.argsort(src, kind="stable")
            self.indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(src[order], minlength=n), out=self.indptr[1:])
            self.indices = dst[order]
        elif indptr is not None and indices is not None:
            self.indptr = np.ascontiguousarray(np.asarray(indptr, dtype=np.int64))
            self.indices = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
            if num_nodes is not None and num_nodes + 1 > self.indptr.shape[0]:
                pad = np.full(num_nodes + 1 - self.indptr.shape[0], self.indptr[-1])
                self.indptr = np.concatenate([self.indptr, pad])
        else:
            raise ValueError("need edge_index or (indptr, indices)")
        self._flat_cache = None
        self._tiled_cache = None

    @property
    def degree(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    @property
    def node_count(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def edge_count(self) -> int:
        return self.indices.shape[0]

    def to_device(self, device=None, id_dtype=None):
        """``(indptr, indices)`` as tensors on ``device`` (default CUDA),
        int32 when the edge count fits."""
        dev = resolve_device(device)
        if id_dtype is None:
            id_dtype = _best_id_dtype(max(self.edge_count, self.node_count + 1))
        key = (str(dev), np.dtype(id_dtype).name)
        if self._flat_cache is not None and self._flat_cache[0] == key:
            return self._flat_cache[1]
        pair = (
            torch.from_numpy(self.indptr.astype(id_dtype)).to(dev),
            torch.from_numpy(self.indices.astype(id_dtype)).to(dev),
        )
        self._flat_cache = (key, pair)
        return pair

    def to_device_tiled(self, device=None, id_dtype=None):
        """The 128-lane tile layout ``(bd [N, 2] int32, tiles [M, 128])``
        on ``device`` (see `ops.sample.build_tiled_host`)."""
        from .ops.sample import build_tiled_host

        dev = resolve_device(device)
        if id_dtype is None:
            id_dtype = _best_id_dtype(self.node_count + 1)
        key = ("tiled", str(dev), np.dtype(id_dtype).name)
        if self._tiled_cache is not None and self._tiled_cache[0] == key:
            return self._tiled_cache[1]
        bd, tiles = build_tiled_host(self.indptr, self.indices, id_dtype)
        pair = (torch.from_numpy(bd).to(dev), torch.from_numpy(tiles).to(dev))
        self._tiled_cache = (key, pair)
        return pair

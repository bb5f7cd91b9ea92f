"""Graph topology container and small helpers — the port of
``quiver_tpu/utils.py`` (``CSRTopo``, ``parse_size``, ``_best_id_dtype``,
``show_tensor_info``, ``reindex_by_config``, ``reindex_feature``,
``heat_reorder``) and of ``round_up_pow2`` from ``quiver_tpu/comm.py``.

Topology lives in host numpy arrays and is materialised on a torch device
on demand; the tile tables are built on the device from the flat arrays
there (`ops.sample.build_tiled_device`, kernel K12 on the card) through one
host row map per topology. Ids on the device are int32 wherever the JAX
package uses int32 (JAX runs with x64 off; torch would keep int64
silently), int64 only for graphs whose ids do not fit.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Union

import numpy as np
import torch


# the host arrays of a CSRTopo that `CSRTopo.share_memory_` moves into shared memory
SHARED_ARRAYS = ("indptr", "indices", "edge_weights", "_feature_order")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another, with its index (the current device's when none is given).
    Raises when CUDA was asked for (or defaulted to) and no card is present
    — nothing carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the plain "
                "torch versions of the kernels on the CPU"
            )
        if dev.index is None:  # "cuda" and "cuda:0" must key one device cache entry
            dev = torch.device("cuda", torch.cuda.current_device())
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


def round_up_pow2(n: int, floor: int = 16) -> int:
    """The least power-of-two multiple of ``floor`` that is >= ``n``: the
    bucket a padded batch is rounded up to, so its shape repeats."""
    v = floor
    while v < n:
        v <<= 1
    return v


def shared_tensor(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` as a CPU tensor in shared memory: a
    `multiprocessing` pickle of it carries a file descriptor, not the
    bytes."""
    return torch.from_numpy(np.ascontiguousarray(arr)).share_memory_()


def is_view_of(arr, t: Optional[torch.Tensor]) -> bool:
    """Whether numpy ``arr`` is the whole of tensor ``t``'s memory."""
    return (t is not None and isinstance(arr, np.ndarray) and arr.size == t.numel()
            and (arr.size == 0 or arr.ctypes.data == t.data_ptr()))


def refuse_unexportable_allocator() -> None:
    """Raise when the CUDA caching allocator is set to expandable segments,
    whose blocks the port does not hand to another process (CUDA IPC
    exports ``cudaMalloc`` blocks); nothing copies in their place."""
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        conf = os.environ.get(var, "").replace(" ", "")
        if "expandable_segments:true" in conf.lower():
            raise RuntimeError(f"{var}={conf!r}: the port hands device tensors to other "
                               "processes by CUDA IPC, which it does not do for expandable "
                               "segments; unset expandable_segments")


def _best_id_dtype(max_value: int) -> np.dtype:
    """int32 when every index fits, else int64."""
    return np.dtype(np.int32) if max_value < 2**31 - 1 else np.dtype(np.int64)


class CSRTopo:
    """CSR graph topology (``indptr [N+1]``, ``indices [E]`` host int64).

    Build from an ``edge_index`` COO pair ``[2, E]`` (stable counting sort
    on the source row, as the JAX package does) or from ``(indptr,
    indices)``. ``edge_weights`` (optional, ``[E]`` float32, aligned with
    the COO input or with ``indices``) feed the weighted sampler; the COO
    build permutes them by the same sort. `to_device`, `to_device_tiled`
    and `to_device_tiled_weights` return cached tensors; the tile tables
    are built on the device (`tiles_on_device`).
    """

    def __init__(self, edge_index=None, indptr=None, indices=None,
                 num_nodes: Optional[int] = None, edge_weights=None):
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
            self.edge_weights = None
            if edge_weights is not None:
                ew = np.asarray(edge_weights, np.float32)
                if ew.shape != src.shape:
                    raise ValueError(f"edge_weights shape {ew.shape} != edge count "
                                     f"{src.shape} of edge_index")
                self.edge_weights = ew[order]
        elif indptr is not None and indices is not None:
            self.indptr = np.ascontiguousarray(np.asarray(indptr, dtype=np.int64))
            self.indices = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
            self.edge_weights = (None if edge_weights is None
                                 else np.asarray(edge_weights, np.float32))
            if num_nodes is not None and num_nodes + 1 > self.indptr.shape[0]:
                pad = np.full(num_nodes + 1 - self.indptr.shape[0], self.indptr[-1])
                self.indptr = np.concatenate([self.indptr, pad])
        else:
            raise ValueError("need edge_index or (indptr, indices)")
        if self.edge_weights is not None and self.edge_weights.shape != self.indices.shape:
            raise ValueError(f"edge_weights shape {self.edge_weights.shape} != indices "
                             f"shape {self.indices.shape}")
        self._flat_cache = None
        self._tiled_cache = None
        self._wtiled_cache = None
        self._weights_cache = None
        self._transposed_cache = None
        self._tile_map = None  # (bd, row_start, row_width), host numpy
        self._feature_order: Optional[np.ndarray] = None
        self._shared = {}  # name -> the shared tensor its array views (`share_memory_`)

    def __getstate__(self):
        # device tensors and the host row map (a cache of indptr) stay in
        # their process; an array moved by `share_memory_` travels as its
        # shared tensor
        state = self.__dict__.copy()
        for name in ("_flat_cache", "_tiled_cache", "_wtiled_cache", "_weights_cache",
                     "_transposed_cache", "_tile_map"):
            state[name] = None
        for name in SHARED_ARRAYS:
            t = self._shared.get(name)
            if t is not None and is_view_of(state[name], t):
                state[name] = t
        return state

    def __setstate__(self, state):
        shared = {}
        for name in SHARED_ARRAYS:
            if isinstance(state.get(name), torch.Tensor):
                shared[name] = state[name]
                state[name] = state[name].numpy()
        self.__dict__.update(state)
        self._shared = shared

    def share_memory_(self) -> "CSRTopo":
        """Move the host arrays (``indptr``, ``indices``, ``edge_weights``
        and ``feature_order``) into shared memory: each becomes a numpy view
        of a shared-memory torch tensor. A `multiprocessing` pickle
        (``ForkingPickler``: a spawned child's arguments, a queue) then
        carries their file descriptors, not their bytes, and the child maps
        the same pages; a plain pickle still carries the bytes. Device
        tensors never travel (`__getstate__`). Idempotent; returns self."""
        for name in SHARED_ARRAYS:
            arr = getattr(self, name)
            if arr is None or is_view_of(arr, self._shared.get(name)):
                continue
            t = shared_tensor(arr)
            self._shared[name] = t
            setattr(self, name, t.numpy())
        return self

    def adopt_device_tables(self, flat=None, tiled=None, weights=None,
                            tiled_weights=None) -> None:
        """Take device tables made elsewhere (another process's, mapped by
        CUDA IPC) as this topology's: ``flat`` ``(indptr, indices)``,
        ``tiled`` ``(bd, tiles)``, ``weights`` ``[E]``, ``tiled_weights``
        ``[M, 128]``. `to_device`, `to_device_tiled`, `to_device_weights`
        and `to_device_tiled_weights` then return them on their device and
        dtype instead of building their own."""
        if flat is not None:
            name = str(flat[1].dtype).removeprefix("torch.")
            self._flat_cache = ((str(flat[1].device), name), tuple(flat))
        if tiled is not None:
            name = str(tiled[1].dtype).removeprefix("torch.")
            self._tiled_cache = (("tiled", str(tiled[1].device), name), tuple(tiled))
        if weights is not None:
            self._weights_cache = (str(weights.device), weights)
        if tiled_weights is not None:
            self._wtiled_cache = (str(tiled_weights.device), tiled_weights)

    @property
    def feature_order(self) -> Optional[np.ndarray]:
        """Old node id -> stored feature row, set by a `Feature` built
        with this topology (None until then)."""
        return self._feature_order

    @feature_order.setter
    def feature_order(self, order) -> None:
        self._feature_order = np.asarray(order, dtype=np.int64)

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

    def tile_map(self):
        """``(bd [N, 2] int32, row_start [M] int64, row_width [M] int32)``
        of the tile layout, computed on the host once
        (`ops.sample.tiled_base_host`, `ops.sample.tiled_rowmap_host`)."""
        from .ops.sample import tiled_base_host, tiled_rowmap_host

        if self._tile_map is None:
            bd, _ = tiled_base_host(self.indptr)
            self._tile_map = (bd, *tiled_rowmap_host(self.indptr))
        return self._tile_map

    def tiles_on_device(self, flat: torch.Tensor) -> torch.Tensor:
        """The ``[M, 128]`` tile table of ``flat [E]`` (aligned with
        ``indices``), built on ``flat``'s device through this topology's
        row map (`ops.sample.build_tiled_device`: K12 on the card)."""
        from .ops.sample import build_tiled_device

        _, start, width = self.tile_map()
        dev = flat.device
        return build_tiled_device(flat, torch.from_numpy(start).to(dev),
                                  torch.from_numpy(width).to(dev))

    def to_device_tiled(self, device=None, id_dtype=None):
        """The 128-lane tile layout ``(bd [N, 2] int32, tiles [M, 128])``
        on ``device``, the table built there (`tiles_on_device`); bit-equal
        to `ops.sample.build_tiled_host`'s."""
        dev = resolve_device(device)
        if id_dtype is None:
            id_dtype = _best_id_dtype(self.node_count + 1)
        name = np.dtype(id_dtype).name
        key = ("tiled", str(dev), name)
        if self._tiled_cache is not None and self._tiled_cache[0] == key:
            return self._tiled_cache[1]
        # the flat ids at the tiles' dtype: `to_device`'s when it holds them
        # there, else an upload freed after the build
        if self._flat_cache is not None and self._flat_cache[0] == (str(dev), name):
            flat = self._flat_cache[1][1]
        else:
            flat = torch.from_numpy(self.indices.astype(id_dtype, copy=False)).to(dev)
        pair = (torch.from_numpy(self.tile_map()[0]).to(dev, copy=True),
                self.tiles_on_device(flat))
        self._tiled_cache = (key, pair)
        return pair

    def to_device_weights(self, device=None) -> torch.Tensor:
        """The edge weights ``[E]`` float32 on ``device``, aligned with
        `to_device`'s ``indices`` (cached)."""
        dev = resolve_device(device)
        if self.edge_weights is None:
            raise ValueError("no edge_weights on this CSRTopo")
        if self._weights_cache is not None and self._weights_cache[0] == str(dev):
            return self._weights_cache[1]
        w = torch.from_numpy(self.edge_weights).to(dev)
        self._weights_cache = (str(dev), w)
        return w

    def to_device_tiled_weights(self, device=None) -> torch.Tensor:
        """The edge weights in the tile map of `to_device_tiled`'s tiles,
        ``[M, 128]`` float32 on ``device`` (cached), built there: the
        weighted sampler's window then reads whole weight tiles."""
        dev = resolve_device(device)
        if self.edge_weights is None:
            raise ValueError("no edge_weights on this CSRTopo")
        if self._wtiled_cache is not None and self._wtiled_cache[0] == str(dev):
            return self._wtiled_cache[1]
        if self._weights_cache is not None and self._weights_cache[0] == str(dev):
            flat = self._weights_cache[1]
        else:  # an upload freed after the build
            flat = torch.from_numpy(self.edge_weights).to(dev)
        w = self.tiles_on_device(flat)
        self._wtiled_cache = (str(dev), w)
        return w

    def to_device_transposed(self, device=None):
        """The edges grouped by destination that the probability kernel
        pulls over (`ops.sample.TransposedCSR`) on ``device``, built on the
        host once (`ops.sample.build_transposed_host`) and cached."""
        from .ops.sample import build_transposed_host

        dev = resolve_device(device)
        if self._transposed_cache is not None and self._transposed_cache[0] == str(dev):
            return self._transposed_cache[1]
        t = build_transposed_host(self.indptr, self.indices).to(dev)
        self._transposed_cache = (str(dev), t)
        return t


def show_tensor_info(x, name: str = "", file=None) -> str:
    """One line naming an array: dtype, shape, device, data pointer and
    whether a host tensor is pinned (the reference's ``show_tensor_info``);
    numpy arrays show ``host=numpy`` (and a memmap its file). Printed to
    ``file`` and returned."""
    parts = [name or type(x).__name__, f"shape={tuple(getattr(x, 'shape', ()))}",
             f"dtype={getattr(x, 'dtype', '?')}"]
    if isinstance(x, torch.Tensor):
        parts += [f"device={x.device}", f"data_ptr={x.data_ptr():#x}",
                  f"nbytes={x.numel() * x.element_size():,}"]
        if x.device.type == "cpu":
            parts.append(f"pinned={x.is_pinned()}")
    elif isinstance(x, np.ndarray):
        parts.append(f"nbytes={x.nbytes:,}")
        parts.append(f"memmap={x.filename}" if isinstance(x, np.memmap) else "host=numpy")
    line = " ".join(parts)
    print(line, file=file)
    return line


def reindex_by_config(adj_csr: CSRTopo, graph_feature, gpu_portion: float, seed: int = 0):
    """Degree-descending hot/cold reorder: sort nodes by out-degree
    (descending, stable on ties), shuffle the hot prefix (the top
    ``gpu_portion`` fraction) with a generator seeded by ``seed``, and
    return ``(permuted_feature, new_order)`` where ``new_order`` maps old
    node id -> position in the permuted feature ("feature_order"). Host
    numpy, the same arrays as the JAX package's."""
    if not 0.0 <= gpu_portion <= 1.0:
        raise ValueError("gpu_portion must be in [0, 1]")
    node_count = adj_csr.node_count
    split = int(node_count * gpu_portion)
    perm_range = np.random.default_rng(seed).permutation(split)
    prev_order = np.argsort(-adj_csr.degree, kind="stable")
    prev_order[:split] = prev_order[perm_range]
    new_order = np.empty(node_count, dtype=np.int64)
    new_order[prev_order] = np.arange(node_count, dtype=np.int64)
    if graph_feature is not None:
        graph_feature = np.asarray(graph_feature)[prev_order]
    return graph_feature, new_order


def reindex_feature(graph: CSRTopo, feature, ratio: float, seed: int = 0):
    """`reindex_by_config` as `Feature` calls it: ``(reordered_feature,
    feature_order)``."""
    return reindex_by_config(graph, feature, ratio, seed=seed)


def heat_reorder(edge_index, num_nodes: Optional[int] = None, features=None, labels=None,
                 index_sets=(), heat=None):
    """Renumber the whole id space heat-descending, so that "rows below
    ``hot_rows`` are the hot tier" holds for graph, features, labels and
    index sets alike. ``heat`` defaults to in+out degree; pass measured
    access probabilities (`GraphSageSampler.sample_prob`) for the
    probability-driven placement. Host numpy.

    Returns ``(edge_index_r, features_r, labels_r, sets_r, order, inv)``
    with ``order[new_id] = old_id`` and ``inv[old_id] = new_id``; absent
    features or labels pass through as None."""
    edge_index = np.asarray(edge_index)
    n = int(num_nodes) if num_nodes is not None else int(edge_index.max()) + 1
    if heat is None:
        heat = np.bincount(edge_index[0], minlength=n) + np.bincount(edge_index[1], minlength=n)
    else:
        heat = np.asarray(heat)
        if heat.shape[0] != n:
            raise ValueError(f"heat has {heat.shape[0]} entries for {n} nodes")
    order = np.argsort(-heat, kind="stable").astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    edge_r = inv[edge_index]
    feats_r = None if features is None else np.asarray(features)[order]
    labels_r = None if labels is None else np.asarray(labels)[order]
    sets_r = tuple(inv[np.asarray(s)] for s in index_sets)
    return edge_r, feats_r, labels_r, sets_r, order, inv

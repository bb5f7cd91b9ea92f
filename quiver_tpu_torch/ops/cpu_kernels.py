"""Host (CPU) sampling and gather engine — the port of
``quiver_tpu/ops/cpu_kernels.py``: the native engine's loader, `host_reindex`,
`HostSampler` and the module-level `gather_rows`.

The engine is the port's own copy of the JAX package's C++ source,
``csrc/quiver_cpu.cpp`` (five C entry points: ``qt_sample_layer``,
``qt_sample_layer_weighted``, ``qt_reindex``, ``qt_gather_rows_bytes`` and
``qt_gather_rows``). At first use `_load_native` compiles it with g++ at
the JAX package's Makefile flags into ``quiver_tpu_torch/_build/`` (the file
name carries a hash of the source, the flags and the host CPU's feature
flags, since ``-march=native`` is among them) and loads it with ``ctypes``;
nothing is built when this module is imported. A seed's draws depend on the
host's core count (a thread a chunk of the batch, each thread's generator
seeded from its index), so they equal the JAX package's on the same
machine, not across machines.

There is no quiet fallback: if g++ is missing or the build or the load
fails, `_load_native` raises with the compiler's output. The JAX package's
numpy paths, whose draws differ, stay here as named plain versions for the
tests (`sample_layer_plain`, `host_reindex_plain`); nothing on a sampling
path calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .sample import pad_widths

SENTINEL = np.iinfo(np.int64).max  # the padding of a multi-hop frontier

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "quiver_cpu.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-march=native", "-pthread", "-shared"]

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
# C entry point -> argtypes (all return void)
ENTRY_POINTS = {
    # indptr, indices, num_nodes, seeds, batch, k, rng seed, out nbrs, out valid
    "qt_sample_layer": [_P, _P, _I64, _P, _I64, _I64, _U64, _P, _P],
    # the same with the float32 weights (CSR edge order) third
    "qt_sample_layer_weighted": [_P, _P, _P, _I64, _P, _I64, _I64, _U64, _P, _P],
    # head, seed_count, nbrs, mask, total, out n_id, out count, out local
    "qt_reindex": [_P, _I64, _P, _P, _I64, _P, _P, _P],
    # src, rows, row bytes, ids, batch, out
    "qt_gather_rows_bytes": [_P, _I64, _I64, _P, _I64, _P],
    # src float32, rows, columns, ids, batch, out float32
    "qt_gather_rows": [_P, _I64, _I64, _P, _I64, _P],
}

_lib = None
_lib_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (what ``-march=native`` compiles for),
    or nothing where ``/proc/cpuinfo`` has none."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def lib_path() -> Path:
    """Where the engine for this source, these flags and this CPU lives."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join([CXX] + CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libquiver_cpu-{h.hexdigest()[:16]}.so"


def _load_native() -> ctypes.CDLL:
    """The loaded engine, compiled with g++ on first use. Raises
    RuntimeError, with the compiler's output, when it cannot be built or
    loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(f"the host sampling engine could not be built "
                                   f"({' '.join(cmd)}): {exc}") from exc
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"the host sampling engine failed to build "
                                   f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as exc:
            raise RuntimeError(f"the host sampling engine {out} failed to load: {exc}") from exc
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here (it raises where it is
    needed and does not)."""
    try:
        _load_native()
    except RuntimeError:
        return False
    return True


def sample_layer_plain(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, k: int,
                       seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's numpy one-hop sample (``_np_sample_layer``): a
    k-subset without replacement through ``default_rng(seed)``, every edge
    where ``deg <= k``, an empty row for an out-of-range seed. Its draws
    differ from the engine's."""
    rng = np.random.default_rng(seed)
    B = seeds.shape[0]
    nbrs = np.zeros((B, k), np.int64)
    valid = np.zeros((B, k), bool)
    node_count = indptr.shape[0] - 1
    in_range = (seeds >= 0) & (seeds < node_count)
    safe = np.where(in_range, seeds, 0)
    starts = indptr[safe]
    degs = np.where(in_range, indptr[safe + 1] - starts, 0)
    for i in range(B):
        deg = int(degs[i])
        if deg <= 0:
            continue
        start = int(starts[i])
        if deg <= k:
            nbrs[i, :deg] = indices[start: start + deg]
            valid[i, :deg] = True
        else:
            pos = rng.choice(deg, size=k, replace=False)
            nbrs[i] = indices[start + pos]
            valid[i] = True
    return nbrs, valid


def host_reindex_plain(seeds: np.ndarray, seed_count: int, nbrs: np.ndarray,
                       mask: np.ndarray) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """The JAX package's numpy reindex, the contract of `host_reindex`."""
    seeds = np.asarray(seeds, np.int64)
    head = seeds[:seed_count]
    nbr_vals = nbrs[mask]
    new = np.setdiff1d(nbr_vals, head)  # sorted unique, seed values excluded
    count = seed_count + new.shape[0]
    n_id = np.concatenate([head, new])
    local_new = seed_count + np.clip(np.searchsorted(new, nbrs), 0, max(new.shape[0] - 1, 0))
    if seed_count > 0:
        uq_s, first_slot = np.unique(head, return_index=True)
        pc = np.clip(np.searchsorted(uq_s, nbrs), 0, uq_s.shape[0] - 1)
        in_seeds = uq_s[pc] == nbrs
        local = np.where(in_seeds, first_slot[pc], local_new)
    else:
        local = local_new
    return n_id, count, np.where(mask, local, 0).astype(np.int32), mask


def host_reindex(seeds: np.ndarray, seed_count: int, nbrs: np.ndarray,
                 mask: np.ndarray) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """``(n_id, count, local_nbrs [S, k] int32, mask)`` of one hop, by the
    engine's ``qt_reindex``: the first ``seed_count`` seeds keep their slots
    verbatim (duplicates included; a lookup takes the first slot holding its
    value), the new neighbors follow once each in ascending order, and a
    masked lane's local id is 0 — the device reindex's contract."""
    S, k = nbrs.shape
    total = S * k
    head = np.ascontiguousarray(np.asarray(seeds, np.int64)[:seed_count])
    nbrs_c = np.ascontiguousarray(nbrs, np.int64)
    mask_c = np.ascontiguousarray(mask, np.uint8)
    if head.shape[0] != seed_count or mask_c.shape != nbrs_c.shape:
        raise ValueError(f"{seed_count} seeds asked of {head.shape[0]}; mask {mask_c.shape} "
                         f"against nbrs {nbrs_c.shape}")
    n_id = np.empty(seed_count + total, np.int64)
    count = np.zeros(1, np.int64)
    local = np.empty(total, np.int32)
    _load_native().qt_reindex(head.ctypes.data, seed_count, nbrs_c.ctypes.data,
                              mask_c.ctypes.data, total, n_id.ctypes.data, count.ctypes.data,
                              local.ctypes.data)
    c = int(count[0])
    return n_id[:c], c, local.reshape(S, k), mask


class HostSampler:
    """The engine bound to one CSR graph (``indptr [N+1]``, ``indices [E]``
    int64, kept as given where they already are: a memmap stays a view).
    ``weights`` (float32, CSR edge order) switches every draw to the
    weighted k-subset (``qt_sample_layer_weighted``: Efraimidis-Spirakis
    keys over all of a row's edges; a non-positive weight is never drawn).
    The engine is built, or the error raised, here."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 weights: Optional[np.ndarray] = None):
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.indices = np.ascontiguousarray(indices, np.int64)
        self._lib = _load_native()
        self.weights = None
        if weights is not None:
            self.weights = np.ascontiguousarray(weights, np.float32)
            if self.weights.shape[0] != self.indices.shape[0]:
                raise ValueError(f"weights has {self.weights.shape[0]} entries for "
                                 f"{self.indices.shape[0]} edges")

    @property
    def node_count(self) -> int:
        return self.indptr.shape[0] - 1

    def sample_layer(self, seeds: np.ndarray, k: int, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """``(nbrs [B, k] int64, valid [B, k] bool)``: ``min(deg, k)``
        distinct neighbors a seed (every edge in CSR order where ``deg <=
        k`` on the uniform draw), drawn with RNG seed ``seed``."""
        seeds = np.ascontiguousarray(seeds, np.int64).reshape(-1)
        B, k = seeds.shape[0], int(k)
        nbrs = np.empty((B, k), np.int64)
        valid = np.empty((B, k), np.uint8)
        args = [self.indptr.ctypes.data, self.indices.ctypes.data, self.node_count,
                seeds.ctypes.data, B, k, ctypes.c_uint64(seed), nbrs.ctypes.data,
                valid.ctypes.data]
        if self.weights is not None:
            args.insert(2, self.weights.ctypes.data)
            self._lib.qt_sample_layer_weighted(*args)
        else:
            self._lib.qt_sample_layer(*args)
        return nbrs, valid.astype(bool)

    def sample_multilayer(self, seeds: np.ndarray, sizes: Sequence[int], seed: int,
                          caps: Optional[Sequence[Optional[int]]] = None
                          ) -> Tuple[np.ndarray, int, List[Dict]]:
        """A multi-hop sample padded as the device path pads
        (`ops.sample.pad_widths`): hop l draws with RNG seed ``seed + l *
        1000003`` from the valid prefix of the frontier, reindexes it
        (`host_reindex`) and truncates at the hop's cap. Returns ``(n_id,
        count, adjs)``: ``n_id`` the last frontier padded with `SENTINEL`,
        and per hop, innermost first, ``dict(cols, mask, n_src, n_dst)``."""
        B = seeds.shape[0]
        widths = pad_widths(B, sizes, caps)
        width = B
        cur = np.ascontiguousarray(seeds, np.int64)
        cur_count = B
        adjs: List[Dict] = []
        for l, k in enumerate(sizes):
            nbrs_v, valid_v = self.sample_layer(cur[:cur_count], k, seed + l * 1000003)
            nbrs = np.zeros((width, k), np.int64)
            mask = np.zeros((width, k), bool)
            nbrs[:cur_count] = nbrs_v
            mask[:cur_count] = valid_v
            n_id, count, local_nbrs, mask = host_reindex(cur, cur_count, nbrs, mask)
            new_width = widths[l + 1]
            if count > new_width:
                n_id = n_id[:new_width]
                count = new_width
                mask = mask & (local_nbrs < new_width)
            adjs.append(dict(cols=local_nbrs, mask=mask, n_src=count, n_dst=cur_count))
            cur = np.full(new_width, SENTINEL, np.int64)
            cur[:count] = n_id
            cur_count = count
            width = new_width
        return cur, cur_count, adjs

    def gather_rows(self, table: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """`gather_rows` of ``table``."""
        return gather_rows(table, ids)


def gather_rows(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """``[len(ids), D]`` rows of a 2-D table of any plain dtype (float32,
    bfloat16 as numpy holds it, int8, ...) through the engine's parallel
    byte-row gather (``qt_gather_rows_bytes``). An out-of-range id
    (negative or >= N; every id of a zero-row table) gives a zero row."""
    if table.ndim != 2 or table.dtype.hasobject:
        raise TypeError(f"gather_rows takes a 2-D table of plain values; got a {table.ndim}-D "
                        f"{table.dtype} array")
    table = np.ascontiguousarray(table)
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    out = np.empty((ids.shape[0], table.shape[1]), table.dtype)
    _load_native().qt_gather_rows_bytes(table.ctypes.data, table.shape[0],
                                        table.shape[1] * table.itemsize, ids.ctypes.data,
                                        ids.shape[0], out.ctypes.data)
    return out

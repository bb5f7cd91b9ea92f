"""Build, load and launch the port's CUDA kernels.

Every kernel source is a ``csrc/*.cu`` file with a plain C interface. At
first use each source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``quiver_tpu_torch/_build/`` (git-ignored), all
sources in parallel, and loaded with ``ctypes``. A library is rebuilt when
its source, the shared headers or the flags change (the file name carries
their hash). Nothing is built or imported when this module is imported:
the CPU tests import every module of the package.

Each launch goes through :func:`launch`, which adds one to the kernel's
launch count (and to ``name/variant`` where a kernel has layouts that a
run must show apart), calls the C entry point on the caller's current
CUDA stream and raises at once if the launch was refused. Beside these
counts of wrapper calls, the libraries count the kernels a call runs
(`kernel_launches`): every ``<<<...>>>`` site of the sources adds one to a
single counter of the process, which this module owns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# largest fanout k of the uniform sampling kernels (K1, K1b, K13b: k / 32
# steps a lane in registers; csrc/sample.cu QT_SAMPLE_KMAX)
SAMPLE_KMAX = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint

# kernel name -> (source stem, C entry point, argtypes)
KERNELS = {
    "sample_tiled": ("sample", "qt_sample_tiled",
                     [_P, _P, _LL, _I, _P, _P, _I, _I, _U, _U, _P, _P, _P]),
    "sample_flat": ("sample", "qt_sample_flat",
                    [_P, _P, _LL, _I, _P, _P, _I, _I, _U, _U, _P, _P, _P]),
    "local_reindex": ("reindex", "qt_local_reindex",
                      [_P, _P, _P, _P, _I, _I, _P, _LL, _P, _P, _P, _P, _P]),
    "gather_rows": ("gather", "qt_gather_rows",
                    [_P, _LL, _I, _P, _LL, _LL, _P, _P, _P]),
    "masked_mean": ("aggregate", "qt_masked_mean",
                    [_P, _LL, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P]),
    "masked_mean_backward": ("aggregate", "qt_masked_mean_backward",
                             [_P, _I, _P, _P, _I, _I, _LL, _P, _P, _LL, _I, _P]),
    "gather_src": ("gather", "qt_gather_src", [_P, _LL, _I, _I, _P, _LL, _P, _P]),
    "gather_src_backward": ("aggregate", "qt_gather_src_backward",
                            [_P, _I, _P, _P, _I, _I, _LL, _P, _P, _LL, _I, _P]),
    "block_out_degree": ("aggregate", "qt_block_out_degree", [_P, _P, _LL, _LL, _P, _P]),
    "tiered_gather": ("gather", "qt_tiered_gather",
                      [_P, _LL, _P, _LL, _I, _P, _LL, _LL, _P, _P, _LL, _P, _P, _P]),
    "full_mean": ("full_mean", "qt_full_mean",
                  [_P, _P, _I, _LL, _LL, _P, _LL, _I, _P, _P, _LL, _P]),
    "tiered_lookup": ("gather", "qt_tiered_lookup", [_P, _LL, _I, _P, _LL, _P, _LL, _P, _P, _P]),
    "gather_dequant": ("dequant", "qt_gather_dequant",
                       [_I, _P, _LL, _I, _P, _LL, _LL, _P, _P, _P, _P, _P]),
    "quantized_tiered_lookup": ("dequant", "qt_quantized_tiered_lookup",
                                [_I, _P, _LL, _I, _P, _LL, _P, _LL, _P, _P, _P, _LL, _P, _P]),
    "set_rows": ("gather", "qt_set_rows", [_P, _LL, _I, _P, _LL, _P, _P, _P, _P]),
    "neighbor_prob": ("prob", "qt_neighbor_prob",
                      [_P, _P, _LL, ctypes.c_float, _P, _P, _LL, _P, _P, _LL, _I, _I, _P, _LL,
                       _P, _P]),
    "weighted_sample_tiled": ("weighted", "qt_weighted_sample_tiled",
                              [_P, _P, _P, _LL, _I, _P, _P, _I, _I, _I, _U, _U, _P, _P, _P]),
    "weighted_sample_flat": ("weighted", "qt_weighted_sample_flat",
                             [_P, _P, _P, _LL, _I, _P, _P, _I, _I, _I, _U, _U, _P, _P, _P]),
    "temporal_sample_tiled": ("weighted", "qt_temporal_sample_tiled",
                              [_P, _P, _P, _LL, _I, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                               ctypes.c_float, _U, _U, _P, _P, _P]),
    "recency_weights": ("weighted", "qt_recency_weights", [_P, _LL, ctypes.c_float, _P, _P]),
    "build_tiles": ("tiles", "qt_build_tiles", [_P, _LL, _P, _P, _LL, _P, _P]),
    "sharded_rows": ("gather", "qt_sharded_rows", [_P, _LL, _I, _I, _P, _LL, _LL, _P, _P]),
    "sharded_sample_tiled": ("sample", "qt_sharded_sample_tiled",
                             [_P, _P, _LL, _I, _LL, _LL, _P, _P, _I, _I, _U, _U, _I, _LL, _P, _P,
                              _P]),
    "sharded_sample_flat": ("sample", "qt_sharded_sample_flat",
                            [_P, _P, _LL, _I, _LL, _LL, _P, _P, _I, _I, _U, _U, _I, _LL, _P, _P,
                             _P]),
    "sharded_dequant": ("dequant", "qt_sharded_dequant",
                        [_I, _P, _LL, _I, _P, _P, _P, _LL, _P, _P]),
    "grouped_unpack": ("collective", "qt_grouped_unpack", [_P, _I, _LL, _I, _P, _P]),
    "cold_compact": ("collective", "qt_cold_compact", [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P]),
    "cold_merge": ("collective", "qt_cold_merge", [_P, _I, _P, _P, _P, _LL, _I, _P]),
    "exchange_rows": ("collective", "qt_exchange_rows", [_P, _LL, _I, _P, _LL, _P, _P]),
}
# the draws with a device-key form: name -> its C entry point, which takes
# a pointer to the hop's two uint32 key words in device memory in place of
# the two words by value (the form a captured CUDA graph replays with new
# keys); its launches count under the kernel's name and "name/device_key"
DEVICE_KEY = {"sample_tiled": "qt_sample_tiled_dk", "sample_flat": "qt_sample_flat_dk",
              "weighted_sample_tiled": "qt_weighted_sample_tiled_dk",
              "weighted_sample_flat": "qt_weighted_sample_flat_dk",
              "temporal_sample_tiled": "qt_temporal_sample_tiled_dk"}


# the draws with a device-graph form (the serve step over a streaming graph,
# `stream.StreamingTiledGraph`): name -> (C entry point, argtypes). It takes
# one pointer to the tables' addresses in device memory (uint64 words: bd and
# tiles, then ttiles) where the device-key form takes the tables, and the
# key words by pointer; its launches count under the kernel's name and
# "name/device_key" and "name/device_graph"
DEVICE_GRAPH = {
    "sample_tiled": ("qt_sample_tiled_dg", [_P, _LL, _I, _P, _P, _I, _I, _P, _P, _P, _P]),
    "temporal_sample_tiled": ("qt_temporal_sample_tiled_dg",
                              [_P, _LL, _I, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                               ctypes.c_float, _P, _P, _P, _P]),
}


def _device_key_argtypes(argtypes):
    """The by-value form's argument types with its two key words (the one
    pair of unsigned ints) replaced by one pointer."""
    i = next(j for j in range(len(argtypes) - 1) if argtypes[j] is _U and argtypes[j + 1] is _U)
    return argtypes[:i] + [_P] + argtypes[i + 2:]


# kernels whose launches are also counted per layout, as "name/variant"
VARIANTS = {"masked_mean": ("float32", "bfloat16"),
            "masked_mean_backward": ("cols", "structural", "float32", "bfloat16"),
            "gather_src": ("float32", "bfloat16"),
            "gather_src_backward": ("float32", "bfloat16"),
            "tiered_gather": ("float32", "int8", "bfloat16", "disk"),
            "set_rows": ("float32", "int8", "bfloat16", "int32"),
            "gather_dequant": ("fp32", "bf16", "int8"),
            "quantized_tiered_lookup": ("fp32", "bf16", "int8"),
            "build_tiles": ("int32", "float32"),
            "sharded_rows": ("float32", "bfloat16", "int8"),
            "sharded_dequant": ("fp32", "bf16", "int8"),
            "grouped_unpack": ("float32", "bfloat16", "int8", "int32"),
            "cold_merge": ("float32", "bfloat16"),
            **{name: ("device_key",) for name in DEVICE_KEY},
            **{name: ("device_key", "device_graph") for name in DEVICE_GRAPH}}
# C helpers that launch nothing: name -> (source stem, argtypes)
HELPERS = {"qt_host_device_pointer": ("gather", [_P, ctypes.POINTER(ctypes.c_void_p)]),
           "qt_host_register": ("gather", [_P, _LL, ctypes.POINTER(_I)]),
           "qt_host_unregister": ("gather", [_P]),
           "qt_local_reindex_scratch": ("reindex", [_I, _I, ctypes.POINTER(_LL)]),
           "qt_masked_mean_backward_scratch": ("aggregate",
                                               [_LL, _I, _I, _I, ctypes.POINTER(_LL)]),
           "qt_block_out_degree_plan": ("aggregate", [_LL, _LL, ctypes.POINTER(_LL),
                                                      ctypes.POINTER(_I)]),
           "qt_cold_compact_scratch": ("collective", [_LL, ctypes.POINTER(_LL)]),
           "qt_neighbor_prob_scratch": ("prob", [_LL, _LL, ctypes.POINTER(_LL)]),
           "qt_full_mean_scratch": ("full_mean", [_LL, _LL, _I, ctypes.POINTER(_LL)]),
           "qt_full_mean_segment_edges": ("full_mean", [ctypes.POINTER(_I)])}
SOURCES = sorted({stem for stem, _, _ in KERNELS.values()})

_lock = threading.Lock()        # launch counts and the loaded libraries
_build_lock = threading.Lock()  # one build at a time in this process
_libs: Dict[str, ctypes.CDLL] = {}
_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_counts.update({f"{name}/{v}": 0 for name, vs in VARIANTS.items() for v in vs})
# every library adds its kernel launches here (csrc/common.cuh qt_count_launch)
_kernel_launches = ctypes.c_ulonglong(0)
# capturing stream handle -> the launches captured into it (`capture_tally`)
_capture_tallies: Dict[int, Dict[str, int]] = {}
build_log: Dict[str, str] = {}


def counts() -> Dict[str, int]:
    """Launch count of every kernel since the last `reset_counts`: the
    launches made eagerly (one captured into a graph under
    `begin_capture_tally` is in that graph's tally instead)."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for name in _counts:
            _counts[name] = 0


def kernel_launches() -> int:
    """Kernels launched on the card since the last `reset_kernel_launches`,
    counted by the host at every ``<<<...>>>`` site of the loaded libraries:
    a wrapper call that runs several kernels counts each of them."""
    return _kernel_launches.value


def reset_kernel_launches() -> None:
    _kernel_launches.value = 0


def begin_capture_tally(stream: int) -> None:
    """Count apart the launches that go into a CUDA graph being captured on
    the stream with raw handle ``stream``: every launch made while that
    stream is current and capturing, from any thread (the autograd engine
    runs a captured backward on its own thread, on the forward's stream),
    goes to the tally and not to `counts`, since nothing runs until the
    graph is replayed. Launches other threads make on other streams
    meanwhile stay in `counts`."""
    with _lock:
        _capture_tallies[int(stream)] = {}


def end_capture_tally(stream: int) -> Dict[str, int]:
    """The launches (by name and ``name/variant``) captured on ``stream``
    since `begin_capture_tally`."""
    with _lock:
        return _capture_tallies.pop(int(stream))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together. Returns the seconds it took; the
    compiler's ``-Xptxas -v`` report lands in `build_log`."""
    with _build_lock:
        return _build()


def _build() -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in SOURCES:
        out = _lib_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    build()  # a no-op when the library is up to date
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(stem)))
            entries = [(fn, a) for s, fn, a in KERNELS.values() if s == stem]
            entries += [(DEVICE_KEY[name], _device_key_argtypes(a))
                        for name, (s, _, a) in KERNELS.items() if s == stem and name in DEVICE_KEY]
            entries += [DEVICE_GRAPH[name] for name, (s, _, _) in KERNELS.items()
                        if s == stem and name in DEVICE_GRAPH]
            entries += [(fn, a) for fn, (s, a) in HELPERS.items() if s == stem]
            for fn, argtypes in entries:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p
            lib.qt_bind_launch_counter.argtypes = [_P]
            lib.qt_bind_launch_counter.restype = None
            lib.qt_bind_launch_counter(ctypes.addressof(_kernel_launches))
            _libs[stem] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args, variant=None) -> None:
    """Launch kernel ``name`` with C arguments ``args`` (pointers and the
    stream as ints). Counts the launch (under ``name/variant`` too, for a
    kernel listed in `VARIANTS`; ``variant`` may be a tuple of them) and
    raises if CUDA refused it. The variant "device_key" launches the
    kernel's device-key form (`DEVICE_KEY`): ``args`` then carry one
    pointer to the key words where the by-value form takes two words; with
    "device_graph" as well, its device-graph form (`DEVICE_GRAPH`)."""
    stem, fn, _ = KERNELS[name]
    lib = _lib(stem)
    variants = (variant,) if isinstance(variant, str) else (variant or ())
    if "device_graph" in variants:
        fn = DEVICE_GRAPH[name][0]
    elif "device_key" in variants:
        fn = DEVICE_KEY[name]
    # a launch captured into a tallied graph runs nothing now: it goes to
    # the graph's tally only, so `counts` holds launches that ran
    into = _counts
    if _capture_tallies and torch.cuda.is_current_stream_capturing():
        into = _capture_tallies.get(torch.cuda.current_stream().cuda_stream, _counts)
    with _lock:
        for n in (name,) + tuple(f"{name}/{v}" for v in variants):
            into[n] = into.get(n, 0) + 1
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.qt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


def host_device_pointer(t: torch.Tensor) -> int:
    """The device address through which a kernel reads the pinned host
    tensor ``t`` (its UVA mapping). Raises when ``t`` is not pinned,
    mapped host memory."""
    lib = _lib(HELPERS["qt_host_device_pointer"][0])
    out = ctypes.c_void_p()
    rc = lib.qt_host_device_pointer(t.data_ptr(), ctypes.byref(out))
    if rc != 0 or not out.value:
        msg = lib.qt_error_string(rc).decode() if rc else "null mapping"
        raise RuntimeError(f"host tensor is not mapped for device reads: error {rc} ({msg})")
    return out.value


def host_register(t: torch.Tensor) -> bool:
    """Register the memory of CPU tensor ``t`` (a shared-memory mapping)
    with the card, mapped, so that `host_device_pointer` works on it.
    Returns True when this call registered it (its caller then owns the
    `host_unregister`), False when it was page-locked already. Raises with
    the CUDA error when the registration fails."""
    lib = _lib(HELPERS["qt_host_register"][0])
    done = ctypes.c_int(0)
    rc = lib.qt_host_register(t.data_ptr(), t.numel() * t.element_size(), ctypes.byref(done))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of {t.numel() * t.element_size():,} host bytes "
                           f"failed: error {rc} ({lib.qt_error_string(rc).decode()})")
    return bool(done.value)


def host_unregister(t: torch.Tensor) -> None:
    """Undo a `host_register` of ``t`` that returned True."""
    lib = _lib(HELPERS["qt_host_unregister"][0])
    rc = lib.qt_host_unregister(t.data_ptr())
    if rc != 0:
        raise RuntimeError(f"cudaHostUnregister failed: error {rc} "
                           f"({lib.qt_error_string(rc).decode()})")


def masked_mean_backward_scratch_bytes(w_src: int, w_dst: int, k: int, D: int = 0) -> int:
    """Bytes of device scratch the cols layout of ``masked_mean_backward``
    takes at row width ``D`` (its scaled gradient rows), or, at ``D = 0``,
    ``gather_src_backward``, which shares its source segments; the layout
    is known to ``csrc/aggregate.cu`` alone."""
    lib = _lib(HELPERS["qt_masked_mean_backward_scratch"][0])
    out = ctypes.c_longlong()
    lib.qt_masked_mean_backward_scratch(w_src, w_dst, k, D, ctypes.byref(out))
    return out.value


def neighbor_prob_scratch_bytes(n: int, n_edges: int) -> int:
    """Bytes of device scratch one ``neighbor_prob`` hop takes over ``n``
    nodes and ``n_edges`` edges (the weights and the parts of the nodes that
    cross merge-path ranges); the layout is known to ``csrc/prob.cu``
    alone."""
    lib = _lib(HELPERS["qt_neighbor_prob_scratch"][0])
    out = ctypes.c_longlong()
    lib.qt_neighbor_prob_scratch(n, n_edges, ctypes.byref(out))
    return out.value


def local_reindex_scratch_words(S: int, k: int) -> int:
    """int32 elements of device scratch ``local_reindex`` takes at ``S``
    seeds of ``k`` lanes (its hash table, two lists of the new uniques,
    counts, digit histograms and the sort's tile status words; none when
    the call fits one block); the layout is known to ``csrc/reindex.cu``
    alone."""
    lib = _lib(HELPERS["qt_local_reindex_scratch"][0])
    out = ctypes.c_longlong()
    lib.qt_local_reindex_scratch(S, k, ctypes.byref(out))
    return out.value


def full_mean_scratch_bytes(n: int, n_edges: int, D: int) -> int:
    """Bytes of device scratch ``full_mean`` takes for ``n`` rows,
    ``n_edges`` edges and width ``D`` (the segment table and partial rows
    of its heavy rows, sized for the most segments the edges can make);
    its layout is known to ``csrc/full_mean.cu`` alone."""
    lib = _lib(HELPERS["qt_full_mean_scratch"][0])
    out = ctypes.c_longlong()
    lib.qt_full_mean_scratch(n, n_edges, D, ctypes.byref(out))
    return out.value


def full_mean_segment_edges() -> int:
    """The edges of one segment of ``full_mean``: a row of more edges is
    split into segments that separate warps sum."""
    lib = _lib(HELPERS["qt_full_mean_segment_edges"][0])
    out = ctypes.c_int()
    lib.qt_full_mean_segment_edges(ctypes.byref(out))
    return out.value


def block_out_degree_plan(n_lanes: int, w_src: int) -> tuple:
    """``(blocks, table_slots)`` of one ``block_out_degree`` call at
    ``n_lanes`` lanes and ``w_src`` sources on the current card: the
    cooperative grid's blocks and each block's shared-memory table (0: the
    lanes add to the output at once); the plan is ``csrc/aggregate.cu``'s."""
    lib = _lib(HELPERS["qt_block_out_degree_plan"][0])
    blocks, slots = ctypes.c_longlong(), ctypes.c_int()
    rc = lib.qt_block_out_degree_plan(n_lanes, w_src, ctypes.byref(blocks), ctypes.byref(slots))
    if rc != 0:
        raise RuntimeError(f"block_out_degree's plan failed: error {rc} "
                           f"({lib.qt_error_string(rc).decode()})")
    return blocks.value, slots.value


def cold_compact_scratch_len(w: int) -> int:
    """int32 elements of device scratch ``cold_compact`` takes at ``w``
    lanes (one count a block, at most a block a tile); the tile size is
    known to ``csrc/scan.cuh`` alone."""
    lib = _lib(HELPERS["qt_cold_compact_scratch"][0])
    out = ctypes.c_longlong()
    lib.qt_cold_compact_scratch(w, ctypes.byref(out))
    return out.value

"""Build, load and launch the port's CUDA kernels.

Every kernel source is a ``csrc/*.cu`` file with a plain C interface. At
first use each source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``quiver_tpu_torch/_build/`` (git-ignored), all
sources in parallel, and loaded with ``ctypes``. A library is rebuilt when
its source, the shared headers or the flags change (the file name carries
their hash). Nothing is built or imported when this module is imported:
the CPU tests import every module of the package.

Each launch goes through :func:`launch`, which adds one to the kernel's
launch count, calls the C entry point on the caller's current CUDA stream
and raises at once if the launch was refused.
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
# largest fanout k of the sampling kernel (k-entry tables per thread) and
# of the mean kernel (one warp ballot of the k mask bits)
KMAX = 32

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
                      [_P, _P, _P, _P, _I, _I, _P, _LL, _P, _LL,
                       _P, _P, _P, _P, _P]),
    "gather_rows": ("gather", "qt_gather_rows",
                    [_P, _LL, _I, _P, _LL, _LL, _P, _P, _P]),
    "masked_mean": ("aggregate", "qt_masked_mean",
                    [_P, _LL, _I, _P, _P, _I, _I, _P, _P]),
}
SOURCES = sorted({stem for stem, _, _ in KERNELS.values()})

_lock = threading.Lock()        # launch counts and the loaded libraries
_build_lock = threading.Lock()  # one build at a time in this process
_libs: Dict[str, ctypes.CDLL] = {}
_counts: Dict[str, int] = {name: 0 for name in KERNELS}
build_log: Dict[str, str] = {}


def counts() -> Dict[str, int]:
    """Launch count of every kernel since the last `reset_counts`."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for name in _counts:
            _counts[name] = 0


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
            for s, fn, argtypes in KERNELS.values():
                if s == stem:
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` with C arguments ``args`` (pointers and the
    stream as ints). Counts the launch and raises if CUDA refused it."""
    stem, fn, _ = KERNELS[name]
    lib = _lib(stem)
    with _lock:
        _counts[name] += 1
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.qt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")

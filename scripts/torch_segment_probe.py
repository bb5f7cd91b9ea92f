#!/usr/bin/env python3
"""Segment lengths of the port's two segmented reductions on the
products-shaped graph, and the full-graph mean's time by segment length.

    python3 scripts/torch_segment_probe.py [--seed 0] [--segments 256,512,...]

Needs one CUDA card (the port's kernels are built from
``quiver_tpu_torch/csrc``). Prints, one JSON object a line:

- ``k4b_segments``: for a dedup ``sample_dense`` of 1,024 seeds at sizes
  [15, 10, 5] and [64, 10, 5], each hop that takes the neighbor-mean
  gradient (layers 1 and 2): the valid lanes naming each source row, their
  largest and 99th-percentile count over the rows named at all;
- ``k10_heavy``: per segment length S, the rows of more than S edges and the
  segments they make;
- ``k10_time``: per S, the full-graph mean at D = 100 and 256 over the whole
  graph (a copy of ``csrc/full_mean.cu`` built with S in place of
  ``kSegEdges``), median milliseconds of CUDA-event timed runs with the L2
  cache flushed, checked within 1e-5 of the plain version and bit-equal
  when run twice; and ``torch.sparse.mm`` + divide on the same inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from quiver_tpu_torch import GraphSageSampler, _kernels  # noqa: E402
from quiver_tpu_torch.datasets import PRODUCTS, powerlaw_csr  # noqa: E402
from quiver_tpu_torch.inference import full_mean_aggregate_plain  # noqa: E402
from quiver_tpu_torch.utils import CSRTopo  # noqa: E402

_FLUSH = None


def log(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=5, warm=1):
    """Median device ms of ``fn()``, each run after a 256 MB write."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k4b_segments(topo, seeds, sizes, seed):
    ds = GraphSageSampler(topo, sizes, device="cuda", seed=seed).sample_dense(seeds)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    for layer in (1, 2):
        adj, w_src = ds.adjs[layer], w_srcs[layer]
        src = torch.clamp(adj.cols.long(), 0, w_src - 1)[adj.mask]
        seg = torch.bincount(src, minlength=w_src)
        seg = seg[seg > 0].float()
        log({"k4b_segments": {"sizes": list(sizes), "layer": layer,
                              "W_dst": adj.w_dst, "k": int(adj.mask.shape[1]), "W_src": w_src,
                              "valid_lanes": int(adj.mask.sum()), "rows_named": seg.numel(),
                              "max": int(seg.max()), "p99": float(torch.quantile(seg, 0.99))}})


def build_variant(S: int, out_dir: Path):
    """The source of K10 with S edges a segment, and its library's path."""
    src = (_kernels.CSRC / "full_mean.cu").read_text()
    text, n = re.subn(r"constexpr int kSegEdges = \d+;", f"constexpr int kSegEdges = {S};", src)
    if n != 1:
        raise RuntimeError("kSegEdges not found in csrc/full_mean.cu")
    cu = out_dir / f"full_mean_{S}.cu"
    cu.write_text(text)
    so = out_dir / f"libfull_mean_{S}.so"
    return cu, so


def load_variant(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.qt_full_mean.argtypes = [P, P, I, LL, LL, P, LL, I, P, P, LL, P]
    lib.qt_full_mean_scratch.argtypes = [LL, LL, I, ctypes.POINTER(LL)]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segments", default="256,512,1024,2048,4096,8192")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_segment_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    log({"build_s": _kernels.build()})
    log({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()})
    segs = [int(s) for s in args.segments.split(",")]
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    procs = []
    for S in segs:
        cu, so = build_variant(S, tmp)
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs.append((S, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for S, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for S={S}:\n{out}")
        libs[S] = load_variant(so)

    n, e = PRODUCTS["n_nodes"], 2 * PRODUCTS["n_edges"]
    indptr_np, indices_np = powerlaw_csr(n, e, seed=args.seed)
    topo = CSRTopo(indptr=indptr_np, indices=indices_np)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed + 3)
    seeds = torch.from_numpy(rng.choice(n, 1024, replace=False).astype(np.int32)).to(dev)
    for sizes in ((15, 10, 5), (64, 10, 5)):
        k4b_segments(topo, seeds, sizes, args.seed + 11)

    indptr, indices = topo.to_device(dev)
    deg = (indptr[1:] - indptr[:-1]).long()
    for S in segs:
        heavy = deg > S
        log({"k10_heavy": {"S": S, "heavy_rows": int(heavy.sum()),
                           "segments": int(((deg[heavy] + S - 1) // S).sum()),
                           "heavy_edge_share": float(deg[heavy].sum() / deg.sum())}})
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    adjacency = torch.sparse_csr_tensor(indptr, indices, torch.ones(indices.shape[0], device=dev),
                                        size=(n, n))
    denom = torch.clamp(deg, min=1).to(torch.float32)[:, None]
    stream = torch.cuda.current_stream().cuda_stream
    for D in (100, 256):
        h = torch.randn((n, D), generator=gen, device=dev)
        want = full_mean_aggregate_plain(indptr, indices, h)
        lib_ms = time_ms(lambda: torch.sparse.mm(adjacency, h) / denom, reps=3)
        for S, lib in libs.items():
            nb = ctypes.c_longlong()
            lib.qt_full_mean_scratch(n, indices.shape[0], D, ctypes.byref(nb))
            scratch = torch.empty(nb.value, dtype=torch.uint8, device=dev)

            def run():
                out = torch.empty((n, D), device=dev)
                rc = lib.qt_full_mean(indptr.data_ptr(), indices.data_ptr(), 0, n,
                                      indices.shape[0], h.data_ptr(), n, D, out.data_ptr(),
                                      scratch.data_ptr(), nb.value, stream)
                if rc:
                    raise RuntimeError(f"full_mean S={S} failed: {rc}")
                return out

            got, again = run(), run()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5))
            log({"k10_time": {"S": S, "D": D, "ms": time_ms(run), "sparse_mm_ms": lib_ms,
                              "max_abs_err": err, "within_1e-5": ok,
                              "rerun_bit_equal": bool(torch.equal(got, again)),
                              "scratch_bytes": nb.value}})
            del got, again, scratch
        del h, want
    return 0


if __name__ == "__main__":
    sys.exit(main())

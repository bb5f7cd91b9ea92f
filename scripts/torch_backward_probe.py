#!/usr/bin/env python3
"""The neighbor mean's gradient (K4b, cols layout) and the hop-source
gather's gradient (K14b) on the products-shaped graph, through builds of
``quiver_tpu_torch/csrc/aggregate.cu`` that differ, timed in turns in one
process, and the device time of each of their kernels.

    python3 scripts/torch_backward_probe.py [--in-flight 8,16] [--variant name=file.cu ...]

Needs one CUDA card. Builds ``csrc/aggregate.cu`` once for each value of
``--in-flight`` (its ``kLanesInFlight``) and each ``--variant`` source (for
example an earlier commit's ``aggregate.cu``, written beside the repo),
and calls their C entry points through ctypes at the shapes of
``chip_smoke.py``: K4b on layers 1 and 2 of a dedup ``sample_dense`` of
1,024 seeds at [15, 10, 5] (float32 and bfloat16), K14b at GAT's widths
(1,024, 1,024, 47) and at F = 256 on layer 1. Each output is checked
bit-equal to the first build's. Prints one JSON object a line: per shape
and build the median milliseconds of CUDA-event timed runs with the L2
cache flushed, taken in the order first to last, then last to first (the
two medians and their mean); then, for the first build, the device time
of every kernel of one call of each shape from ``torch.profiler``.
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
from quiver_tpu_torch.utils import CSRTopo  # noqa: E402

_FLUSH = None
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def log(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=15, warm=3):
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


class Build:
    """One build of aggregate.cu and its two backward entry points."""

    def __init__(self, name: str, so: Path, text: str):
        self.name = name
        self.lib = ctypes.CDLL(str(so))
        # an earlier scratch helper takes no row width
        self.scratch_takes_d = bool(re.search(
            r"qt_masked_mean_backward_scratch\(long long w_src, int w_dst, int k, int D", text))
        self.lib.qt_masked_mean_backward_scratch.argtypes = (
            [LL, I, I, I, ctypes.POINTER(LL)] if self.scratch_takes_d
            else [LL, I, I, ctypes.POINTER(LL)])
        for fn in ("qt_masked_mean_backward", "qt_gather_src_backward"):
            getattr(self.lib, fn).argtypes = [P, I, P, P, I, I, LL, P, P, LL, I, P]

    def scratch(self, w_src, w, k, D):
        out = ctypes.c_longlong()
        args = (w_src, w, k, D) if self.scratch_takes_d else (w_src, w, k)
        self.lib.qt_masked_mean_backward_scratch(*args, ctypes.byref(out))
        return torch.empty(out.value, dtype=torch.uint8, device="cuda")

    def call(self, fn, g, F, mask, cols, w_src, D_scratch):
        w, k = mask.shape
        gx = torch.empty((w_src,) + tuple(g.shape[1:] if fn == "qt_masked_mean_backward"
                                          else g.shape[2:]), dtype=g.dtype, device="cuda")
        scratch = self.scratch(w_src, w, k, D_scratch)
        rc = getattr(self.lib, fn)(g.data_ptr(), F, mask.data_ptr(), cols.data_ptr(), w, k,
                                   w_src, gx.data_ptr(), scratch.data_ptr(), scratch.numel(),
                                   int(g.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} {fn} failed: {rc}")
        return gx


def build_all(in_flight, variants):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    src = (_kernels.CSRC / "aggregate.cu").read_text()
    jobs = []
    for n in in_flight:
        text, hits = re.subn(r"constexpr int kLanesInFlight = \d+;",
                             f"constexpr int kLanesInFlight = {n};", src)
        if hits != 1:
            raise RuntimeError("kLanesInFlight not found in csrc/aggregate.cu")
        jobs.append((f"in_flight={n}", text))
    for spec in variants:
        name, path = spec.split("=", 1)
        jobs.append((name, Path(path).read_text()))
    procs = []
    for i, (name, text) in enumerate(jobs):
        cu, so = tmp / f"aggregate_{i}.cu", tmp / f"libaggregate_{i}.so"
        cu.write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs.append((name, so, text, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
    builds = []
    for name, so, text, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = re.findall(r"Function properties for (\w*src_sum\w*|\w*mean_bwd_sum\w*)\n.*\n"
                          r"ptxas info\s+: Used (\d+) registers", out)
        log({"build": name, "sum_kernel_registers": regs})
        builds.append(Build(name, so, text))
    return builds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--in-flight", default="8,16")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_backward_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()})
    builds = build_all([int(x) for x in args.in_flight.split(",")], args.variant)

    n, e = PRODUCTS["n_nodes"], 2 * PRODUCTS["n_edges"]
    indptr, indices = powerlaw_csr(n, e, seed=args.seed)
    topo = CSRTopo(indptr=indptr, indices=indices)
    dev = torch.device("cuda")
    train_idx = np.random.default_rng(args.seed + 3).choice(n, PRODUCTS["train_nodes"],
                                                            replace=False)
    seeds = torch.from_numpy(train_idx[:1024].astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    cases = []
    ds = GraphSageSampler(topo, (15, 10, 5), device=dev, seed=args.seed + 11).sample_dense(seeds)
    for layer in (1, 2):
        adj, w_src = ds.adjs[layer], ds.adjs[layer - 1].w_dst
        W = adj.mask.shape[0]
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn((W, 256), generator=gen, device=dev).to(dt)
            cases.append((f"K4b layer {layer} {str(dt)[6:]}", "qt_masked_mean_backward", g, 256,
                          adj, w_src, 256))
    ds = GraphSageSampler(topo, (15, 10, 5), device=dev, seed=args.seed + 70).sample_dense(seeds)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    for layer, F in ((0, 1024), (1, 1024), (2, 47), (1, 256)):
        adj, w_src = ds.adjs[layer], w_srcs[layer]
        W, k = adj.mask.shape
        g = torch.randn((W, k, F), generator=gen, device=dev)
        cases.append((f"K14b layer {layer} F={F}", "qt_gather_src_backward", g, F, adj, w_src, 0))

    for name, fn, g, F, adj, w_src, d_scratch in cases:
        outs = [b.call(fn, g, F, adj.mask, adj.cols, w_src, d_scratch) for b in builds]
        torch.cuda.synchronize()
        same = [bool(torch.equal(outs[0], o)) for o in outs]
        del outs
        order = list(range(len(builds)))
        ms = {b.name: [] for b in builds}
        for i in order + order[::-1]:
            b = builds[i]
            ms[b.name].append(time_ms(lambda: b.call(fn, g, F, adj.mask, adj.cols, w_src,
                                                     d_scratch)))
        segs = torch.bincount(torch.clamp(adj.cols.long(), 0, w_src - 1)[adj.mask],
                              minlength=w_src)
        log({"case": name, "W": list(adj.mask.shape), "w_src": w_src,
             "segment_max": int(segs.max()), "bit_equal_to_first": same,
             "ms": {k: {"runs": v, "mean": sum(v) / len(v)} for k, v in ms.items()}})

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = builds[0]
    for name, fn, g, F, adj, w_src, d_scratch in cases:
        b.call(fn, g, F, adj.mask, adj.cols, w_src, d_scratch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                b.call(fn, g, F, adj.mask, adj.cols, w_src, d_scratch)
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
                key = ev.key.split("(")[0].removeprefix("void ")[:60]
                per[key] = per.get(key, 0.0) + ev.device_time_total / 1e3 / 3
        log({"profile": name, "build": b.name, "device_ms_per_call": per,
             "sum": sum(per.values())})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The neighbor mean's gradient (K4b, cols layout) and the hop-source
gather's gradient (K14b) on the products-shaped graph, through builds of
``quiver_tpu_torch/csrc/aggregate.cu`` that differ, timed in turns in one
process, with the kernels each call launches and the device time of each
kernel.

    python3 scripts/torch_backward_probe.py [--set NAME=VALUE ...] [--steps]
                                            [--variant name=file.cu ...]

Needs one CUDA card. Builds the tree's ``csrc/aggregate.cu``, once more
for each ``--set NAME=VALUE`` (its ``constexpr int NAME`` set to VALUE,
say kLanesInFlight=16; several joined by ";" make one build), with
``--steps`` once for each of the one-launch kernel's steps (the kernel
returning where the step begins, at the comment lines of `STEPS`, so that
the differences of their times are the steps' times; their outputs are
not the gradient), and each
``--variant`` source (for example an earlier commit's ``aggregate.cu``,
written under a git-ignored directory), and calls their C entry points
through ctypes at the shapes of ``chip_smoke.py``: K4b on layers 1 and 2
of a dedup ``sample_dense`` of 1,024 seeds at [15, 10, 5] (float32 and
bfloat16, D = 256), and every K14b call of chip_smoke's kernels-7 phase
(GAT's widths 1,024, 1,024 and 47 and GCN's 256 on layers 1 and 2, float32,
and the bfloat16 calls at 1,024 and 256). Each output is checked bit-equal
to the first build's. Prints one JSON object a line: per shape and build
the median milliseconds of CUDA-event timed runs with the L2 cache flushed
(`chip_smoke.time_ms`) and the same queued behind a 1 ms spin
(`chip_smoke.time_ms_queued`: the card's time alone), taken in the order
first to last, then last to first, and the kernels one call launches (the
build's own launch counter); beside each K14b shape, ``index_add_`` of
its valid rows (given) by both timers; then, for the first build, the
device time of every kernel of one call of each shape from
``torch.profiler``.
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

import chip_smoke as cs  # noqa: E402
from quiver_tpu_torch import GraphSageSampler, _kernels  # noqa: E402
from quiver_tpu_torch.datasets import PRODUCTS, powerlaw_csr  # noqa: E402
from quiver_tpu_torch.utils import CSRTopo  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# where each step of csrc/aggregate.cu's one launch begins, as (the function,
# the line): the kernel's first (so the first variant times the launch
# alone), the grid path's count, scan, fill, order, the long rows' sums and
# the warps' sums; the small path's scan, fill, order, long and short rows' sums
GRID, SMALL = "src_backward_kernel(const SrcArgs a)", "__device__ void src_small("
STEPS = ((GRID, "// K4b: the targets' rows scaled"), (GRID, "// 1. count"),
         (GRID, "// 2. scan"), (GRID, "// 3. fill"), (GRID, "// 4. order"),
         (GRID, "// 5. the ordered sums"),
         (GRID, "const int chunks = (a.F + kSrcCols"), (SMALL, "// their starts"),
         (SMALL, "// the fill: base"), (SMALL, "// the order, in place"),
         (SMALL, "// the sums: the long rows"), (SMALL, "src_sum_short<In, Out>(a, base"))


def log(obj):
    print(json.dumps(obj), flush=True)


class Build:
    """One build of aggregate.cu and its two backward entry points."""

    def __init__(self, name: str, so: Path, text: str):
        self.name = name
        self.lib = ctypes.CDLL(str(so))
        # the build's own count of kernel launches (csrc/common.cuh)
        self.launches = ctypes.c_ulonglong(0)
        self.lib.qt_bind_launch_counter.argtypes = [P]
        self.lib.qt_bind_launch_counter(ctypes.addressof(self.launches))
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


def build_all(sets, steps, variants):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    src = (_kernels.CSRC / "aggregate.cu").read_text()
    jobs = [("tree", src)]
    for spec in sets:  # NAME=VALUE, or several joined by ";"
        text = src
        for one in spec.split(";"):
            name, value = one.split("=", 1)
            text, hits = re.subn(rf"constexpr int {name} = [^;]+;",
                                 f"constexpr int {name} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"{name} not found in csrc/aggregate.cu")
        jobs.append((spec, text))
    for n, (where, marker) in enumerate(STEPS if steps else ()):
        at = src.index(marker, src.index(where))
        jobs.append((f"stop_before={n + 1}", src[:at] + "return;\n" + src[at:]))
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
        regs = re.findall(r"Function properties for (\w*(?:src_sum|src_backward_kernel)\w*)\n"
                          r".*\nptxas info\s+: Used (\d+) registers", out)
        log({"build": name, "sum_kernel_registers": regs})
        builds.append(Build(name, so, text))
    return builds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_backward_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()})
    builds = build_all(args.set, args.steps, args.variant)

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
    for layer, F, dt in ((0, 1024, torch.float32), (1, 1024, torch.float32),
                         (2, 47, torch.float32), (1, 256, torch.float32), (2, 256, torch.float32),
                         (0, 1024, torch.bfloat16), (1, 1024, torch.bfloat16),
                         (1, 256, torch.bfloat16), (2, 256, torch.bfloat16)):
        adj, w_src = ds.adjs[layer], w_srcs[layer]
        W, k = adj.mask.shape
        g = torch.randn((W, k, F), generator=gen, device=dev).to(dt)
        cases.append((f"K14b layer {layer} F={F} {str(dt)[6:]}", "qt_gather_src_backward", g, F,
                      adj, w_src, 0))

    for name, fn, g, F, adj, w_src, d_scratch in cases:
        outs = [b.call(fn, g, F, adj.mask, adj.cols, w_src, d_scratch) for b in builds]
        torch.cuda.synchronize()
        same = [bool(torch.equal(outs[0], o)) for o in outs]
        del outs
        order = list(range(len(builds)))
        ms = {b.name: [] for b in builds}
        queued = {b.name: [] for b in builds}
        launches = {}
        for i in order + order[::-1]:
            b = builds[i]

            def one(b=b):
                return b.call(fn, g, F, adj.mask, adj.cols, w_src, d_scratch)
            ms[b.name].append(cs.time_ms(one))
            queued[b.name].append(cs.time_ms_queued(one))
            torch.cuda.synchronize()
            b.launches.value = 0
            one()
            launches[b.name] = b.launches.value
        src = torch.clamp(adj.cols.long(), 0, w_src - 1)
        segs = torch.bincount(src[adj.mask], minlength=w_src)
        entry = {"case": name, "W": list(adj.mask.shape), "w_src": w_src,
                 "segment_max": int(segs.max()), "bit_equal_to_first": same,
                 "launches": launches,
                 "ms": {k: {"runs": v, "mean": sum(v) / len(v)} for k, v in ms.items()},
                 "queued_ms": {k: {"runs": v, "mean": sum(v) / len(v)}
                               for k, v in queued.items()}}
        if fn == "qt_gather_src_backward":  # the library call: index_add_ of the valid rows
            idx = src[adj.mask].contiguous()
            rows = g.reshape(-1, F)[adj.mask.reshape(-1)].contiguous()

            def lib():
                return torch.zeros((w_src, F), dtype=g.dtype, device=dev).index_add_(0, idx, rows)
            entry["index_add_ms"] = cs.time_ms(lib)
            entry["index_add_queued_ms"] = cs.time_ms_queued(lib)
            del idx, rows
        log(entry)

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

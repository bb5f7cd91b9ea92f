#!/usr/bin/env python3
"""The probability pull (K11, ``quiver_tpu_torch/csrc/prob.cu``) of the
tree against builds of other sources of ``prob.cu`` (for example the pull
before its redesign), at ``chip_smoke.py``'s three hops on the
products-shaped graph, timed in turns in one process.

    python3 scripts/torch_prob_probe.py [--variant name=file.cu ...] [--lane-items 8,16]

Needs one CUDA card. Builds the tree's ``prob.cu``, once more for each
value of ``--lane-items`` (its ``kProbLaneItems``), and each ``--variant``
source with the tree's nvcc flags and headers, and calls their C entry
points through ctypes. A source whose entry point takes the tile table of
the design before the redesign (``tile_node``, ``tile_ptr``,
``long_nodes``: a warp a 1,024-edge tile) gets that table, built here as
that design built it; the others get the merge-path ranges of their own
``kProbLaneItems`` and the scratch their own ``qt_neighbor_prob_scratch``
sizes.

The hops are chip_smoke's kernels-4: the products-shaped graph of
``build_graph(1.0, seed)``, ``prob`` 1 on the 196,615 train nodes, then
k = 15, 10 and 5, each hop fed the tree's previous result. Per hop and
build: the median milliseconds of CUDA-event timed runs with the L2 cache
flushed (`chip_smoke.time_ms`) and queued behind a 1 ms spin
(`chip_smoke.time_ms_queued`), taken first to last, then last to first;
the kernels one call launches (the build's own counter); whether two runs
are bit-equal; the largest relative error against the float64 sum of the
same terms and, for the tree, the share of its order's bound
(`neighbor_prob_depth`) used; and the byte bound of chip_smoke's K11 row.
One JSON object a line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from quiver_tpu_torch import _kernels  # noqa: E402
from quiver_tpu_torch.datasets import PRODUCTS  # noqa: E402
from quiver_tpu_torch.ops.sample import (  # noqa: E402
    merge_path_ranges,
    neighbor_prob,
    neighbor_prob_depth,
    neighbor_prob_plain,
)

P, LL, I, F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
OLD_TILE = 1024  # edges a warp of the tiled design sums


def log(obj):
    print(json.dumps(obj), flush=True)


class Build:
    """One build of prob.cu and its entry point, with the inputs its ABI
    takes."""

    def __init__(self, name: str, so: Path, text: str):
        self.name = name
        self.lib = ctypes.CDLL(str(so))
        self.launches = ctypes.c_ulonglong(0)
        self.lib.qt_bind_launch_counter.argtypes = [P]
        self.lib.qt_bind_launch_counter(ctypes.addressof(self.launches))
        self.tiled = "tile_node" in text
        fn = self.lib.qt_neighbor_prob
        if self.tiled:
            fn.argtypes = [P, P, LL, F32, P, P, P, P, LL, I, P, LL, P, P, P, P]
        else:
            fn.argtypes = [P, P, LL, F32, P, P, LL, P, P, LL, I, I, P, LL, P, P]
            self.lib.qt_neighbor_prob_scratch.argtypes = [LL, LL, ctypes.POINTER(LL)]
            self.lane_items = int(re.search(r"constexpr int kProbLaneItems = (\d+);",
                                            text).group(1))
            self.seq_span = int(re.search(r"constexpr int kProbSeqSpan = (\d+);", text).group(1))
        fn.restype = ctypes.c_int

    def prepare(self, t, n: int, dev):
        """Buffers of the call: the tile table (tiled design) or scratch."""
        e = int(t.tsrc.numel())
        self.w = torch.empty(n, dtype=torch.float32, device=dev)
        if self.tiled:
            tcount = np.diff(t.tindptr.cpu().numpy())
            ntiles = np.maximum(-(-tcount // OLD_TILE), 1)
            tile_ptr = np.zeros(n + 1, np.int64)
            np.cumsum(ntiles, out=tile_ptr[1:])
            self.tile_node = torch.from_numpy(
                np.repeat(np.arange(n, dtype=np.int32), ntiles)).to(dev)
            self.tile_ptr = torch.from_numpy(tile_ptr).to(dev)
            self.long_nodes = torch.from_numpy(
                np.nonzero(ntiles > 1)[0].astype(np.int32)).to(dev)
            self.partial = torch.empty(self.tile_node.numel(), dtype=torch.float32, device=dev)
        else:
            nb = ctypes.c_longlong()
            self.lib.qt_neighbor_prob_scratch(n, e, ctypes.byref(nb))
            self.scratch = torch.empty(max(nb.value, 1), dtype=torch.uint8, device=dev)
            node, edge = merge_path_ranges(t.tindptr.cpu().numpy(), 32 * self.lane_items)
            self.range_node = torch.from_numpy(node).to(dev)
            self.range_edge = torch.from_numpy(edge).to(dev)

    def call(self, t, prob, k: int):
        n = prob.numel()
        out = torch.empty(n, dtype=torch.float32, device=prob.device)
        st = torch.cuda.current_stream().cuda_stream
        if self.tiled:
            rc = self.lib.qt_neighbor_prob(
                prob.data_ptr(), t.deg.data_ptr(), n, float(k), t.tindptr.data_ptr(),
                t.tsrc.data_ptr(), self.tile_node.data_ptr(), self.tile_ptr.data_ptr(),
                self.tile_node.numel(), OLD_TILE, self.long_nodes.data_ptr(),
                self.long_nodes.numel(), self.w.data_ptr(), self.partial.data_ptr(),
                out.data_ptr(), st)
        else:
            rc = self.lib.qt_neighbor_prob(
                prob.data_ptr(), t.deg.data_ptr(), n, float(k), t.tindptr.data_ptr(),
                t.tsrc.data_ptr(), t.tsrc.numel(), self.range_node.data_ptr(),
                self.range_edge.data_ptr(), self.range_node.numel() - 1, self.lane_items,
                self.seq_span, self.scratch.data_ptr(), self.scratch.numel(), out.data_ptr(), st)
        if rc:
            raise RuntimeError(f"{self.name}: qt_neighbor_prob failed: {rc}")
        return out


def build_all(lane_items, variants):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    src = (_kernels.CSRC / "prob.cu").read_text()
    jobs = [("tree", src)]
    for n in lane_items:
        text, hits = re.subn(r"constexpr int kProbLaneItems = \d+;",
                             f"constexpr int kProbLaneItems = {n};", src)
        if hits != 1:
            raise RuntimeError("kProbLaneItems not found in csrc/prob.cu")
        jobs.append((f"lane_items={n}", text))
    for spec in variants:
        name, path = spec.split("=", 1)
        jobs.append((name, Path(path).read_text()))
    procs = []
    for i, (name, text) in enumerate(jobs):
        cu, so = tmp / f"prob_{i}.cu", tmp / f"libprob_{i}.so"
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
        log({"build": name, "ptxas": re.findall(r"Used \d+ registers[^\n]*", out)})
        builds.append(Build(name, so, text))
    return builds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lane-items", default="")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prob_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": cs.card_line()})
    builds = build_all([int(x) for x in args.lane_items.split(",") if x], args.variant)

    dev = torch.device("cuda")
    topo = cs.build_graph(1.0, args.seed)
    n = topo.node_count
    t0 = time.perf_counter()
    tr = topo.to_device_transposed(dev)
    torch.cuda.synchronize()
    log({"transposed_build_s": time.perf_counter() - t0, "nodes": n,
         "edges": int(tr.tsrc.numel())})
    for b in builds:
        b.prepare(tr, n, dev)
    indptr, indices = topo.to_device(dev)
    train = np.random.default_rng(args.seed + 3).choice(n, PRODUCTS["train_nodes"],
                                                        replace=False)
    last = torch.zeros(n, device=dev)
    last[torch.from_numpy(train).to(dev)] = 1.0
    e = int(tr.tsrc.numel())
    depth = neighbor_prob_depth(tr).double()
    u = 2.0**-24
    for k in cs.SIZES:
        exact = neighbor_prob_plain(indptr, indices, last, k, acc_dtype=torch.float64)
        nz = exact > 0
        order = list(range(len(builds)))
        ms = {b.name: [] for b in builds}
        queued = {b.name: [] for b in builds}
        checks = {}
        for b in builds:
            got, again = b.call(tr, last, k), b.call(tr, last, k)
            torch.cuda.synchronize()
            rel = float(((got.double() - exact).abs()[nz] / exact[nz]).max())
            checks[b.name] = {"reruns_bit_equal": bool(torch.equal(got, again)),
                              "bit_equal_to_tree": bool(torch.equal(
                                  got, neighbor_prob(indptr, indices, last, k, tr))),
                              "max_rel_err_vs_float64": rel}
            b.launches.value = 0
            b.call(tr, last, k)
            checks[b.name]["launches"] = b.launches.value
        tree = neighbor_prob(indptr, indices, last, k, tr)
        tol = (depth * u / (1 - depth * u) + 1e-9) * exact
        diff = (tree.double() - exact).abs()
        share = float(torch.where(tol > 0, diff / tol, torch.zeros_like(tol)).max())
        for i in order + order[::-1]:
            b = builds[i]
            ms[b.name].append(cs.time_ms(lambda: b.call(tr, last, k)))
            queued[b.name].append(cs.time_ms_queued(lambda: b.call(tr, last, k)))
        log({"hop_k": k, "nodes": n, "edges": e,
             "bound_ms": cs.bound(e * 4 + n * (8 + 4 + 4 + 4 + 8), f32_adds=e)[0],
             "tree_order_bound_share_used": share, "tree_within_order_bound": bool(share <= 1),
             "checks": checks,
             "ms": {k_: {"runs": v, "mean": sum(v) / len(v)} for k_, v in ms.items()},
             "queued_ms": {k_: {"runs": v, "mean": sum(v) / len(v)}
                           for k_, v in queued.items()}})
        del exact
        last = tree
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GCN's out-degree count (K14c) and the hot/cold compaction (K13d) at
``chip_smoke.py``'s shapes, through builds of
``quiver_tpu_torch/csrc/aggregate.cu`` and ``csrc/collective.cu`` that
differ, timed in turns in one process, with the kernels each call launches
and the library call that computes the same function.

    python3 scripts/torch_count_probe.py [--variant name=file.cu ...] [--steps]
                                         [--set NAME=VALUE ...] [--graph]

Needs one CUDA card. Builds the tree's two sources; each ``--variant``
source (an earlier commit's ``aggregate.cu`` or ``collective.cu``, written
under a git-ignored directory; which of the two it is, is read from its
entry points); with ``--set NAME=VALUE`` a build of the source that holds
``constexpr int NAME`` with it set to VALUE (several joined by ";" make one
build), say kCountHashMinLanes=0 to give every block of a K14c call a
table; with ``--steps`` one build for each phase of the two kernels (the
kernel returning where the phase begins, at the comment lines of `STEPS`,
so that the differences of their times are the phases' times; their
outputs are not the result). Shapes: K14c on the three hops of a dedup
``sample_dense`` of 1,024 seeds at [15, 10, 5] on the products-shaped graph
(chip_smoke's kernels-7 sample); the compaction on ids of chip_smoke's two
hot/cold widths with its budgets and cold counts (the cold lanes placed at
random, from the seed). Each output of the tree and the variants is checked
bit-equal to the plain version. Prints one JSON object a line: per shape
and build the median milliseconds queued behind a 1 ms spin with the L2
cache flushed (`chip_smoke.time_ms_queued`), taken first to last, then
last to first, and the kernels one call launches (the build's own launch
counter); beside them the library call queued: ``index_add_`` of the mask
into zeros (K14c) and the stable ``argsort`` of the flag cut to the budget
(the compaction). ``--graph`` then captures the tree's calls of both
kernels (cooperative launches) in a ``torch.cuda.CUDAGraph`` and replays it,
and says whether the replay is bit-equal.
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
from quiver_tpu_torch.ops.gather_src import block_out_degree, block_out_degree_plain  # noqa: E402
from quiver_tpu_torch.parallel.collectives import cold_compact, cold_compact_plain  # noqa: E402
from quiver_tpu_torch.utils import CSRTopo  # noqa: E402

P, LL = ctypes.c_void_p, ctypes.c_longlong
# where each phase begins, as (source, the kernel, the line): K14c (zero,
# lanes, the tables to the output) and the compaction (read and count, the
# prefix, fill). A build that returns at a kernel's first line times its
# launch alone.
K14C, COMPACT = "out_degree_kernel(", "cold_compact_kernel("
STEPS = (("aggregate", K14C, "// 1. zero"), ("aggregate", K14C, "// 2."),
         ("aggregate", K14C, "// 3."), ("collective", COMPACT, "// 1. read"),
         ("collective", COMPACT, "// 2."), ("collective", COMPACT, "// 3."))
# chip_smoke's hot/cold widths: (what, W, budget, n_cold) of its host setup
COMPACT_SHAPES = (("frontier", 180_224, 123_904, 53_406),
                  ("leaves", 901_120, 619_008, 326_271))


def log(obj):
    print(json.dumps(obj), flush=True)


class Build:
    """One build of aggregate.cu (K14c) or collective.cu (the compaction)."""

    def __init__(self, name: str, stem: str, so: Path, text: str):
        self.name, self.stem = name, stem
        self.lib = ctypes.CDLL(str(so))
        self.launches = ctypes.c_ulonglong(0)  # the build's own launch counter
        self.lib.qt_bind_launch_counter.argtypes = [P]
        self.lib.qt_bind_launch_counter(ctypes.addressof(self.launches))
        if stem == "aggregate":
            # before the one-launch design the wrapper passed an int32 scratch
            self.scratch_arg = bool(re.search(r"void\* deg, void\* out", text))
            self.lib.qt_block_out_degree.argtypes = [P, P, LL, LL] + [P] * (
                3 if self.scratch_arg else 2)
        else:
            self.lib.qt_cold_compact.argtypes = [P, LL, LL, LL, LL, P, P, P, P, P]
            self.lib.qt_cold_compact_scratch.argtypes = [LL, ctypes.POINTER(LL)]

    def count(self, mask, cols, w_src):
        out = torch.empty(w_src, dtype=torch.float32, device="cuda")
        extra = [torch.empty(w_src, dtype=torch.int32, device="cuda").data_ptr()] \
            if self.scratch_arg else []
        rc = self.lib.qt_block_out_degree(mask.data_ptr(), cols.data_ptr(), mask.numel(), w_src,
                                          *extra, out.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} qt_block_out_degree failed: {rc}")
        return out

    def compact(self, ids, lo, hi, budget):
        W = ids.shape[0]
        n = LL()
        self.lib.qt_cold_compact_scratch(W, ctypes.byref(n))
        scratch = torch.empty(n.value, dtype=torch.int32, device="cuda")
        sel = torch.empty(budget, dtype=torch.int32, device="cuda")
        cold_local = torch.empty_like(sel)
        counts = torch.empty(2, dtype=torch.int32, device="cuda")  # both builds write it
        rc = self.lib.qt_cold_compact(ids.data_ptr(), W, lo, hi, budget, sel.data_ptr(),
                                      cold_local.data_ptr(), counts.data_ptr(),
                                      scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} qt_cold_compact failed: {rc}")
        return sel, cold_local, counts


def build_all(sets, steps, variants):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    src = {stem: (_kernels.CSRC / f"{stem}.cu").read_text() for stem in ("aggregate", "collective")}
    jobs = [("tree", stem, text) for stem, text in src.items()]
    for spec in sets:  # NAME=VALUE, or several joined by ";", all in one source
        stem = None
        for one in spec.split(";"):
            name, value = one.split("=", 1)
            hit = [s for s, t in src.items() if re.search(rf"constexpr int {name} = ", t)]
            if len(hit) != 1 or stem not in (None, hit[0]):
                raise RuntimeError(f"{name} is not one constant of one source")
            stem = hit[0]
        text = src[stem]
        for one in spec.split(";"):
            name, value = one.split("=", 1)
            text = re.sub(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text)
        jobs.append((spec, stem, text))
    for n, (stem, where, marker) in enumerate(STEPS if steps else ()):
        text = src[stem]
        at = text.index(marker, text.index(where))
        jobs.append((f"stop_before={n + 1}", stem, text[:at] + "return;\n" + text[at:]))
    for spec in variants:
        name, path = spec.split("=", 1)
        text = Path(path).read_text()
        stem = "aggregate" if "qt_block_out_degree" in text else "collective"
        jobs.append((name, stem, text))
    procs = []
    for i, (name, stem, text) in enumerate(jobs):
        cu, so = tmp / f"{stem}_{i}.cu", tmp / f"lib{stem}_{i}.so"
        cu.write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs.append((name, stem, so, text, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    builds = []
    for name, stem, so, text, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = re.findall(r"Function properties for (\w*(?:out_degree|cold_compact)\w*)\n"
                          r".*\nptxas info\s+: Used (\d+) registers", out)
        log({"build": name, "source": f"{stem}.cu", "registers": regs})
        builds.append(Build(name, stem, so, text))
    return builds


def time_builds(builds, fn, check):
    """Each build's queued ms in turns (first to last, then back) and its
    kernel launches a call; ``check(out)`` says whether a build's output is
    the plain version's (None for the step builds, whose output is not)."""
    same = {}
    for b in builds:
        out = fn(b)
        torch.cuda.synchronize()
        same[b.name] = None if b.name.startswith("stop_before") else check(out)
        del out
    queued = {b.name: [] for b in builds}
    launches = {}
    for b in builds + builds[::-1]:
        queued[b.name].append(cs.time_ms_queued(lambda b=b: fn(b)))
        torch.cuda.synchronize()
        b.launches.value = 0
        fn(b)
        launches[b.name] = b.launches.value
    return {"equal_to_plain": same, "launches": launches,
            "queued_ms": {k: {"runs": v, "mean": sum(v) / len(v)} for k, v in queued.items()}}


def graph_check(cases_k14c, cases_compact):
    """Capture the tree's K14c and compaction calls in one CUDA graph, replay
    it, and compare with the eager calls."""
    eager = [block_out_degree(m, c, w) for m, c, w in cases_k14c]
    eager += [t for ids, lo, hi, b in cases_compact for t in cold_compact(ids, lo, hi, b)]
    torch.cuda.synchronize()
    entry = {"graph": "K14c x3, compaction x2"}
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):  # the eager calls above were the warm-up
            outs = [block_out_degree(m, c, w) for m, c, w in cases_k14c]
            outs += [t for ids, lo, hi, b in cases_compact for t in cold_compact(ids, lo, hi, b)]
        for o in outs:
            o.fill_(-7)
        g.replay()
        torch.cuda.synchronize()
        entry["captured"] = True
        entry["replay_bit_equal"] = all(torch.equal(a, b) for a, b in zip(eager, outs))
        _kernels.reset_kernel_launches()
        g.replay()
        torch.cuda.synchronize()
        entry["host_launches_in_a_replay"] = _kernels.kernel_launches()
    except Exception as exc:  # the finding is whether it captures
        entry["captured"] = False
        entry["error"] = f"{type(exc).__name__}: {exc}"[:400]
        torch.cuda.synchronize()
    log(entry)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--graph", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_count_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()})
    builds = build_all(args.set, args.steps, args.variant)
    agg = [b for b in builds if b.stem == "aggregate"]
    col = [b for b in builds if b.stem == "collective"]
    dev = torch.device("cuda")

    n, e = PRODUCTS["n_nodes"], 2 * PRODUCTS["n_edges"]
    indptr, indices = powerlaw_csr(n, e, seed=args.seed)
    topo = CSRTopo(indptr=indptr, indices=indices)
    train_idx = np.random.default_rng(args.seed + 3).choice(n, PRODUCTS["train_nodes"],
                                                            replace=False)
    seeds = torch.from_numpy(train_idx[:1024].astype(np.int32)).to(dev)
    ds = GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed + 70).sample_dense(seeds)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    cases_k14c = []
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        mask, cols = adj.mask.contiguous(), adj.cols.contiguous()
        want = block_out_degree_plain(mask, cols, w_src)
        flat_idx = torch.clamp(cols.long(), 0, w_src - 1).reshape(-1)
        ones = mask.reshape(-1).to(torch.float32)
        entry = {"case": f"K14c layer {layer}", "lanes": mask.numel(),
                 "valid": int(mask.sum()), "w_src": w_src,
                 "plan_blocks_table_slots": _kernels.block_out_degree_plan(mask.numel(), w_src)}
        entry.update(time_builds(agg, lambda b: b.count(mask, cols, w_src),
                                 lambda out: bool(torch.equal(out, want))))
        entry["index_add_queued_ms"] = cs.time_ms_queued(
            lambda: torch.zeros(w_src, device=dev).index_add_(0, flat_idx, ones))
        log(entry)
        cases_k14c.append((mask, cols, w_src))
    del ds

    rng = np.random.default_rng(args.seed + 16)
    cases_compact = []
    for what, W, budget, n_cold in COMPACT_SHAPES:
        lo, hi = 2_000_000, 2_400_000
        ids = rng.integers(0, lo, W).astype(np.int32)  # hot ids
        at = rng.choice(W, n_cold, replace=False)
        ids[at] = rng.integers(lo, hi, n_cold)
        ids[rng.choice(W, 64, replace=False)] = np.iinfo(np.int32).max  # padding sentinels
        ids = torch.from_numpy(ids).to(dev)
        want = cold_compact_plain(ids, lo, hi, budget)
        flag = ((ids >= lo) & (ids < hi)).to(torch.int32)
        entry = {"case": f"compaction {what}", "W": W, "budget": budget,
                 "n_cold": int(want[2][0])}
        entry.update(time_builds(col, lambda b: b.compact(ids, lo, hi, budget),
                                 lambda out: all(bool(torch.equal(x, y))
                                                 for x, y in zip(out, want))))
        entry["argsort_queued_ms"] = cs.time_ms_queued(
            lambda: torch.argsort(1 - flag, stable=True)[:budget])
        log(entry)
        cases_compact.append((ids, lo, hi, budget))
    if args.graph:
        graph_check(cases_k14c, cases_compact)
    return 0


if __name__ == "__main__":
    sys.exit(main())

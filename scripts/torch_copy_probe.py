#!/usr/bin/env python3
"""The row scatter (B1, K6) and the sharded row gather (K13a, K13c's pack)
at ``chip_smoke.py``'s shapes, through builds of
``quiver_tpu_torch/csrc/gather.cu`` that differ, timed in turns in one
process, with the kernels each call launches and the library call that
computes the same function.

    python3 scripts/torch_copy_probe.py [--variant name=file.cu ...]
                                        [--set NAME=VALUE ...] [--seed S]

Needs one CUDA card. Builds the tree's ``gather.cu``; each ``--variant``
source (an earlier commit's ``gather.cu``, written under a git-ignored
directory; one that fails to build is logged and left out); with ``--set
NAME=VALUE`` a build of the tree's source with ``constexpr int NAME`` set
to VALUE (several joined by ";" make one build), say kCopyUnroll=8. Shapes, the data drawn from the seed on the
card: B1 a node commit (the int32 tile table [2,849,473, 128] and the
(base, deg) table [2,449,029, 2], 12 and 6 rows at sorted slots padded to
the 64-row bucket) and a temporal commit (those and the float32
timestamp tiles, 1,299 and 7 rows, buckets 2,048 and 64); K6 one
placement batch on the 20% cache table (489,805 x 100 float32, 65,000
rows at distinct random slots padded to 65,536); K13a shard 0 of 2 over
811,008 ids (distinct random node ids with 5% padding sentinels) on the
products table's stripe ([1,224,515, 100]) in float32, bfloat16 and int8;
K13c's pack the same over two groups' 1,622,016 ids. Each output of every
build is checked bit-equal to the plain version. Prints one JSON object a
line: per shape and build the median milliseconds queued behind a 1 ms
spin with the L2 cache flushed (`chip_smoke.time_ms_queued`), taken first
to last, then last to first, and the kernels one call launches (the
build's own launch counter); beside them the library call queued:
``index_copy_`` on a ``clone`` of each table (B1, K6; a bare ``clone`` of
the tables too) and ``index_select`` of the clamped local ids (K13a), and
the bound (`chip_smoke.bound`, the bytes each kernel row of chip_smoke
counts).
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

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from quiver_tpu_torch import _kernels  # noqa: E402
from quiver_tpu_torch.datasets import PRODUCTS  # noqa: E402
from quiver_tpu_torch.parallel.collectives import partial_rows_plain  # noqa: E402
from quiver_tpu_torch.tiers import set_rows_plain  # noqa: E402
from quiver_tpu_torch.utils import round_up_pow2  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
M_CAP = 2_849_473  # chip_smoke's streamed tile rows (stream phase, m_cap)
NODE_ROWS, TEMPORAL_ROWS = (12, 6), (1_299, 7)  # (tile rows, (base, deg) rows) a commit
K6_ROWS, K6_FRAC = 65_000, 0.2
K13A_IDS, PAD_FRAC = 811_008, 0.05


def log(obj):
    print(json.dumps(obj), flush=True)


class Build:
    """One build of gather.cu: its row scatter and its sharded row gather."""

    def __init__(self, name: str, so: Path):
        self.name = name
        self.lib = ctypes.CDLL(str(so))
        self.launches = ctypes.c_ulonglong(0)  # the build's own launch counter
        self.lib.qt_bind_launch_counter.argtypes = [P]
        self.lib.qt_bind_launch_counter(ctypes.addressof(self.launches))
        self.lib.qt_set_rows.argtypes = [P, LL, I, P, LL, P, P, P, P]
        self.lib.qt_sharded_rows.argtypes = [P, LL, I, I, P, LL, LL, P, P]

    def set_rows(self, table, slots, rows):
        H, D = table.shape
        out = torch.empty_like(table)
        slot_row = torch.empty(H, dtype=torch.int32, device=table.device)
        rc = self.lib.qt_set_rows(table.data_ptr(), H, D * table.element_size(),
                                  slots.data_ptr(), slots.shape[0], rows.data_ptr(),
                                  slot_row.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} qt_set_rows failed: {rc}")
        return out

    def sharded_rows(self, block, ids, shard):
        R, D = block.shape
        out = torch.empty((ids.shape[0], D), dtype=block.dtype, device=block.device)
        rc = self.lib.qt_sharded_rows(block.data_ptr(), R, D, block.element_size(),
                                      ids.data_ptr(), ids.shape[0], shard * R, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.name} qt_sharded_rows failed: {rc}")
        return out


def build_all(sets, variants):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    src = (_kernels.CSRC / "gather.cu").read_text()
    jobs = [("tree", src)]
    for spec in sets:  # NAME=VALUE, or several joined by ";"
        text = src
        for one in spec.split(";"):
            name, value = one.split("=", 1)
            if not re.search(rf"constexpr int {name} = ", text):
                raise RuntimeError(f"{name} is no constant of gather.cu")
            text = re.sub(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text)
        jobs.append((spec, text))
    for spec in variants:
        name, path = spec.split("=", 1)
        jobs.append((name, Path(path).read_text()))
    procs = []
    for i, (name, text) in enumerate(jobs):
        cu, so = tmp / f"gather_{i}.cu", tmp / f"libgather_{i}.so"
        cu.write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    builds = []
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            if name == "tree":
                raise RuntimeError(f"nvcc failed for the tree's gather.cu:\n{out}")
            log({"build": name, "nvcc_failed": out[-4000:]})  # the other builds go on
            continue
        regs = re.findall(r"Function properties for (\w*(?:set_rows|copy_table|patch_rows|"
                          r"slot_map|sharded_rows)\w*)\n.*\nptxas info\s+: Used (\d+) registers",
                          out)
        log({"build": name, "registers": regs})
        builds.append(Build(name, so))
    return builds


def time_builds(builds, fn, want):
    """Each build's queued ms in turns (first to last, then back), its
    kernel launches a call, and whether its outputs equal ``want``."""
    same = {}
    for b in builds:
        out = fn(b)
        torch.cuda.synchronize()
        same[b.name] = all(torch.equal(x, y) for x, y in zip(out, want))
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


def random_table(gen, shape, dtype):
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=dtype, device="cuda", generator=gen)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, dtype=dtype, device="cuda", generator=gen)
    return torch.rand(shape, device="cuda", generator=gen).to(dtype)


def scatter_case(gen, tables, n_rows, sorted_slots=True, floor=64):
    """One call a table: (table, slots, rows) with ``n_rows[i]`` rows at
    distinct slots (sorted, as a commit's, or in random order, as a
    placement's) padded with the row count to the bucket."""
    calls = []
    for table, n in zip(tables, n_rows):
        H = table.shape[0]
        b = round_up_pow2(n, floor=floor)
        pick = torch.randperm(H, device="cuda", generator=gen)[:n]
        slots = torch.full((b,), H, dtype=torch.int64, device="cuda")
        slots[:n] = torch.sort(pick).values if sorted_slots else pick
        calls.append((table, slots, random_table(gen, (b, table.shape[1]), table.dtype)))
    return calls


def scatter_entry(builds, case, calls):
    want = [set_rows_plain(*c) for c in calls]
    valid = [(t, s[s < t.shape[0]], r[: int((s < t.shape[0]).sum())]) for t, s, r in calls]
    n_bytes = sum(2 * t.numel() * t.element_size() + s.numel() * 8 + r.numel() * r.element_size()
                  for t, s, r in calls)
    entry = {"case": case, "tables": [list(t.shape) for t, _, _ in calls],
             "rows": [int(s.numel()) for _, s, _ in valid],
             "buckets": [int(s.numel()) for _, s, _ in calls], "bound_ms": cs.bound(n_bytes)[0]}
    entry.update(time_builds(builds, lambda b: [b.set_rows(*c) for c in calls], want))
    entry["index_copy_on_clone_queued_ms"] = cs.time_ms_queued(
        lambda: [t.clone().index_copy_(0, s, r) for t, s, r in valid])
    entry["clone_queued_ms"] = cs.time_ms_queued(lambda: [t.clone() for t, _, _ in calls])
    log(entry)


def gather_entry(builds, case, block, ids, es):
    R, D = block.shape
    want = [partial_rows_plain(block, ids, 0)]
    own = (ids >= 0) & (ids < R)
    local = torch.clamp(ids.long(), 0, R - 1)
    W = ids.shape[0]
    n_bytes = W * 4 + torch.unique(ids[own]).numel() * D * es + W * D * es
    entry = {"case": case, "ids": W, "owned": int(own.sum()), "bound_ms": cs.bound(n_bytes)[0]}
    entry.update(time_builds(builds, lambda b: [b.sharded_rows(block, ids, 0)], want))
    entry["index_select_queued_ms"] = cs.time_ms_queued(
        lambda: torch.index_select(block, 0, local))
    log(entry)


def unique_ids(gen, n_nodes, W):
    """``W`` lanes of distinct node ids in random order, PAD_FRAC of them
    the padding sentinel (INT32_MAX), as a dedup batch's gather ids."""
    ids = torch.randperm(n_nodes, device="cuda", generator=gen)[:W].to(torch.int32)
    pad = torch.rand(W, device="cuda", generator=gen) < PAD_FRAC
    return torch.where(pad, torch.iinfo(torch.int32).max, ids)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_copy_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()})
    builds = build_all(args.set, args.variant)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    N = PRODUCTS["n_nodes"]

    # B1: a node commit and a temporal commit
    bd = random_table(gen, (N, 2), torch.int32)
    tiles = random_table(gen, (M_CAP, 128), torch.int32)
    node = scatter_case(gen, (tiles, bd), NODE_ROWS)
    scatter_entry(builds, "B1 node commit", node)
    ttiles = random_table(gen, (M_CAP, 128), torch.float32)
    t_rows = (TEMPORAL_ROWS[1], TEMPORAL_ROWS[0], TEMPORAL_ROWS[0])
    scatter_entry(builds, "B1 temporal commit", scatter_case(gen, (bd, tiles, ttiles), t_rows))
    del bd, tiles, ttiles, node
    torch.cuda.empty_cache()

    # K6: one placement batch on the 20% cache table
    H = int(N * K6_FRAC)
    cache = random_table(gen, (H, cs.DIM), torch.float32)
    scatter_entry(builds, "K6 apply", scatter_case(gen, (cache,), (K6_ROWS,), sorted_slots=False,
                                                   floor=256))
    del cache
    torch.cuda.empty_cache()

    # K13a shard 0 of 2 and K13c's pack at the gathered width, three dtypes
    R = -(-N // 2)
    ids = unique_ids(gen, N, K13A_IDS)
    pack_ids = torch.cat([ids, unique_ids(gen, N, K13A_IDS)])
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        block = random_table(gen, (R, cs.DIM), dtype)
        es = block.element_size()
        name = str(dtype).removeprefix("torch.")
        gather_entry(builds, f"K13a shard 0 {name}", block, ids, es)
        gather_entry(builds, f"K13c pack {name}", block, pack_ids, es)
        del block
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The neighbor mean (K4) and the dedup reindex (K2) of the tree against
builds of earlier sources of ``csrc/aggregate.cu`` and ``csrc/reindex.cu``
(the kernels before their redesign), at the shapes of ``chip_smoke.py``
on the products-shaped graph, timed in turns in one process.

    python3 scripts/torch_redesign_probe.py --old-aggregate OLD.cu --old-reindex OLD.cu

Needs one CUDA card. Builds the two earlier sources with the tree's nvcc
flags and calls their C entry points (the signatures before the
redesign) through ctypes; the tree's kernels run through the package's
wrappers. Shapes: K2 on the three hops of a B = 64 flush and on the hops
of one dedup sample of a batch of 1,024 at [15, 10, 5], uncapped and cut
to the caps ``calibrate_caps`` gives (chip_smoke's caps phase); K4 on the
three layers of the flush (float32), the bfloat16 layers of a batch of
1,024 and the k = 64 layer of a [64, 10, 5] sample (float32, D = 256).
Every K2 output is checked bit-equal to the earlier build's and K4's
within 1e-5 of it. Prints one JSON object a line: per case the median
milliseconds of CUDA-event timed runs with the L2 cache flushed, taken
earlier, tree, tree (and the tree's K4 with its lane split turned off),
earlier, each also queued behind a spin (the card's time alone), and the
kernel launches of one call counted by ``torch.profiler`` (K2: also each
of the tree's kernels' device microseconds a call).
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from quiver_tpu_torch import random as qrandom  # noqa: E402
from quiver_tpu_torch.models import sage  # noqa: E402
from quiver_tpu_torch.ops import reindex, sample  # noqa: E402
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj, sample_dense_pure  # noqa: E402
from quiver_tpu_torch.serve import zipfian_trace  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def log(obj):
    print(json.dumps(obj), flush=True)


def build_old(aggregate: Path, reindex_cu: Path):
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    procs = []
    for name, src in (("aggregate", aggregate), ("reindex", reindex_cu)):
        cu, so = tmp / f"{name}_old.cu", tmp / f"lib{name}_old.so"
        cu.write_text(src.read_text())
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    libs["aggregate"].qt_masked_mean.argtypes = [P, LL, I, P, P, I, I, P, I, P]
    libs["reindex"].qt_local_reindex.argtypes = [P, P, P, P, I, I, P, LL, P, LL, P, P, P, P, P]
    return libs


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def old_reindex(lib, seeds, seed_valid, nbrs, nbr_valid):
    """The earlier K2's C entry point (a bitonic sort over next_pow2(S*k))."""
    S, k = nbrs.shape
    W = S * (1 + k)
    H, Pn = _pow2(max(2 * W, 2)), _pow2(max(S * k, 2))
    dev = seeds.device
    scratch = torch.empty(3 * H + 2, dtype=torch.int32, device=dev)
    uniq = torch.empty(Pn, dtype=torch.int32, device=dev)
    n_id = torch.empty(W, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ls = torch.empty(S, dtype=torch.int32, device=dev)
    ln = torch.empty((S, k), dtype=torch.int32, device=dev)
    rc = lib.qt_local_reindex(seeds.data_ptr(), seed_valid.data_ptr(), nbrs.data_ptr(),
                              nbr_valid.data_ptr(), S, k, scratch.data_ptr(), H,
                              uniq.data_ptr(), Pn, n_id.data_ptr(), count.data_ptr(),
                              ls.data_ptr(), ln.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the earlier K2 failed: {rc}")
    return reindex.ReindexResult(n_id, count, ls, ln, nbr_valid)


def old_mean(lib, x, adj):
    """The earlier K4's C entry point (a warp a target, 32 columns a pass)."""
    w, k = adj.mask.shape
    D = x.shape[1]
    out = torch.empty((w, D), dtype=x.dtype, device=x.device)
    rc = lib.qt_masked_mean(x.data_ptr(), x.shape[0], D, adj.mask.data_ptr(),
                            None if adj.cols is None else adj.cols.data_ptr(), w, k,
                            out.data_ptr(), int(x.dtype == torch.bfloat16),
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the earlier K4 failed: {rc}")
    return out


def kernels(fn, calls=5):
    """CUDA kernels of one call of ``fn`` in a profiler trace of ``calls``
    calls: their number, and each kernel's device microseconds a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    return (sum(ev.count for ev in rows) / calls,
            {ev.key.split("(")[0][:40]: ev.device_time_total / calls for ev in rows})


def no_split(fn):
    """``fn()`` with K4's lane split turned off (one warp a column slice)."""
    def run():
        fill = sage.MEAN_FILL_WARPS
        sage.MEAN_FILL_WARPS = 0
        try:
            return fn()
        finally:
            sage.MEAN_FILL_WARPS = fill
    return run


def in_turns(variants):
    """Median ms of each ``(name, fn)``, taken first to last, then last to
    first, by `chip_smoke.time_ms` and by `chip_smoke.time_ms_queued` (the
    card's time alone)."""
    ms = {name: {"runs": [], "queued_runs": []} for name, _ in variants}
    for name, fn in variants + variants[::-1]:
        ms[name]["runs"].append(cs.time_ms(fn))
        ms[name]["queued_runs"].append(cs.time_ms_queued(fn))
    for v in ms.values():
        v["mean"], v["queued_mean"] = (sum(v["runs"]) / len(v["runs"]),
                                       sum(v["queued_runs"]) / len(v["queued_runs"]))
    return ms


def k2_case(libs, tag, h):
    args = (h["cur"], h["cur_valid"], h["nbrs"], h["valid"])
    new, old = reindex.local_reindex(*args), old_reindex(libs["reindex"], *args)
    torch.cuda.synchronize()
    v = h["valid"]
    same = (torch.equal(new.n_id, old.n_id) and torch.equal(new.count, old.count)
            and torch.equal(new.local_seeds, old.local_seeds)
            and torch.equal(new.local_nbrs[v], old.local_nbrs[v]))
    if not same:
        raise RuntimeError(f"K2 {tag}: the tree's output differs from the earlier build's")
    S, k = h["nbrs"].shape
    n_seed = int(h["cur_valid"].sum())
    log({"kernel": "K2", "case": tag, "S": S, "k": k, "valid_seeds": n_seed,
         "new_uniques": int(new.count) - n_seed, "bit_equal": same,
         "ms": in_turns([("earlier", lambda: old_reindex(libs["reindex"], *args)),
                         ("tree", lambda: reindex.local_reindex(*args))]),
         "launches": {"earlier": kernels(lambda: old_reindex(libs["reindex"], *args))[0],
                      "tree": kernels(lambda: reindex.local_reindex(*args))[0]},
         "tree_kernel_us": kernels(lambda: reindex.local_reindex(*args))[1]})


def k4_case(libs, tag, x, adj):
    new, old = sage.masked_mean_aggregate(x, adj), old_mean(libs["aggregate"], x, adj)
    torch.cuda.synchronize()
    err = float((new.float() - old.float()).abs().max())
    if not torch.allclose(new.float(), old.float(), atol=1e-5, rtol=1e-5):
        raise RuntimeError(f"K4 {tag}: the tree's output differs from the earlier build's by {err}")
    W, k = adj.mask.shape
    D = x.shape[1]
    plan = sage.mean_launch_plan(W, k, D, x.element_size())
    log({"kernel": "K4", "case": tag, "W": W, "k": k, "D": D, "dtype": str(x.dtype)[6:],
         "plan_vec_colwarps_split": plan, "max_abs_diff": err,
         "ms": in_turns([("earlier", lambda: old_mean(libs["aggregate"], x, adj)),
                         ("tree", lambda: sage.masked_mean_aggregate(x, adj)),
                         ("tree_no_split", no_split(lambda: sage.masked_mean_aggregate(x, adj)))])})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-aggregate", type=Path, required=True)
    ap.add_argument("--old-reindex", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_redesign_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": cs.card_line()})
    libs = build_old(args.old_aggregate, args.old_reindex)
    dev = torch.device("cuda")
    topo = cs.build_graph(1.0, args.seed)
    n = topo.node_count
    g_tiled = topo.to_device_tiled(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    train_idx = np.random.default_rng(args.seed + 3).choice(n, cs.PRODUCTS_TRAIN, replace=False)
    seeds_1024 = torch.from_numpy(train_idx[:cs.TRAIN_BATCH].astype(np.int32)).to(dev)
    trace = zipfian_trace(n, 2000, alpha=0.99, seed=args.seed + 1)
    seeds_64 = torch.from_numpy(trace[:cs.BATCH].astype(np.int32)).to(dev)

    # K2: the flush's hops, then a batch of 1,024 uncapped and capped
    key = qrandom.fold_in(qrandom.key(1234), 0)
    for h in cs.hop_inputs(g_tiled, seeds_64, key)[0]:
        k2_case(libs, "flush", h)
    order = np.random.default_rng(args.seed + 40).permutation(train_idx)
    probes = order[:cs.CAP_PROBES * cs.TRAIN_BATCH].reshape(cs.CAP_PROBES, cs.TRAIN_BATCH)
    caps = GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed + 41).calibrate_caps(
        probes, margin=cs.CAP_MARGIN, granule=cs.CAP_GRANULE)
    log({"caps": caps})
    for name, c in (("uncapped", None), ("capped", caps)):
        for h in cs.hop_inputs(g_tiled, seeds_1024, qrandom.key(args.seed + 44), caps=c)[0]:
            k2_case(libs, name, h)

    # K4: the flush's layers (float32), a batch's bfloat16 layers, the k = 64 layer
    ds = sample_dense_pure(None, None, key, seeds_64, cs.SIZES,
                           sample_fn=lambda c, v, k, kk: sample.tiled_sample_layer(
                               *g_tiled, c, v, k, kk))
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        D = cs.DIM if layer == 0 else cs.HIDDEN
        k4_case(libs, f"flush layer {layer}", torch.randn((w_src, D), generator=gen, device=dev),
                adj)
    ds = GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed + 70).sample_dense(seeds_1024)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        D = cs.DIM if layer == 0 else cs.HIDDEN
        x = torch.randn((w_src, D), generator=gen, device=dev).to(torch.bfloat16)
        k4_case(libs, f"bf16 batch layer {layer}", x, adj)
    ds = sample_dense_pure(None, None, qrandom.key(args.seed + 90), seeds_1024, cs.FANOUT_SIZES,
                           sample_fn=lambda c, v, k, kk: sample.tiled_sample_layer(
                               *g_tiled, c, v, k, kk))
    adj = ds.adjs[-1]
    w_src = ds.adjs[-2].w_dst
    k4_case(libs, "k64", torch.randn((w_src, cs.HIDDEN), generator=gen, device=dev),
            DenseAdj(adj.cols, adj.mask, None, None))
    return 0


if __name__ == "__main__":
    sys.exit(main())

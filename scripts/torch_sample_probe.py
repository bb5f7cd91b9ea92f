#!/usr/bin/env python3
"""The uniform draw (K1 tiled, K1b flat, K13b and the grouped hop K13e;
``csrc/sample.cu``) of the tree against a build of an earlier source of
``sample.cu`` (the draw before its redesign), at the shapes of
``chip_smoke.py`` on the products-shaped graph, timed in turns in one
process.

    python3 scripts/torch_sample_probe.py --old-sample OLD.cu

Needs one CUDA card. Builds the earlier source with the tree's nvcc flags
and headers and loads it with ctypes: its K1 entry points take the tree's
arguments, so the package's wrappers run it in turn with the tree's; its
K13b entry points (the [W, k] neighbor and flag pair, before the stacked
slab) are called directly.

Shapes: K1 and K1b at the three hops of a B = 64 flush ([15, 10, 5]); at
the hops of one dedup sample of a batch of 1,024, uncapped and cut to the
caps ``calibrate_caps`` gives over 8 probe batches (chip_smoke's mc setup);
at k = 33, 64 and 512 over the batch's 1,024 seeds; at k = 5 and 10 over
4,096 to 262,144 random rows (where one thread a row already fills the
card); K13b tiled and flat on shard 0 of 2 (dp 2 x ici 2) at every hop of
kernels-8's calibrated batch; and K13e, rank (0, 0) of host 2 x dp 1 x ici 2
at kernels-9's calibrated hops: the tree's draw at the gathered width into
the stacked slab and one unpack, against the earlier draw's pair and an
unpack of each. Every output is checked bit-equal to the earlier build's
and the tree's K1 to its plain version. Prints one JSON object a shape:
the median milliseconds of CUDA-event timed runs with the L2 cache flushed
(`chip_smoke.time_ms`) and queued behind a 1 ms spin
(`chip_smoke.time_ms_queued`, the card's time alone), taken earlier, tree,
tree, earlier; the kernels of one call (`_kernels.kernel_launches`); the
bound (`chip_smoke.sample_bound`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from quiver_tpu_torch import GraphSageSampler, _kernels  # noqa: E402
from quiver_tpu_torch import random as qrandom  # noqa: E402
from quiver_tpu_torch.ops import sample  # noqa: E402
from quiver_tpu_torch.parallel import local_meshes, shard_topology_rows  # noqa: E402
from quiver_tpu_torch.parallel.collectives import grouped_unpack  # noqa: E402
from quiver_tpu_torch.parallel.topology import (  # noqa: E402
    sample_layer_partial_slab,
    tiled_sample_layer_partial_slab,
)
from quiver_tpu_torch.serve import zipfian_trace  # noqa: E402

P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
OLD_SHARDED = [P, P, LL, I, LL, LL, P, P, I, I, U, U, P, P, P]  # before the stacked slab
SCAN_KS, SCAN_WIDTHS = (5, 10), (4096, 16384, 65536, 180224, 262144)


def log(obj):
    print(json.dumps(obj), flush=True)


def build_old(src: Path) -> ctypes.CDLL:
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    cu, so = tmp / "sample_old.cu", tmp / "libsample_old.so"
    cu.write_text(src.read_text())
    out = subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
                          str(_kernels.CSRC), "-o", str(so), str(cu)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier sample.cu:\n{out.stdout}{out.stderr}")
    log({"ptxas": "earlier", "log": [l for l in out.stdout.splitlines() + out.stderr.splitlines()
                                      if "registers" in l or "spill" in l]})
    lib = ctypes.CDLL(str(so))
    for name in ("sample_tiled", "sample_flat"):
        _, fn, argtypes = _kernels.KERNELS[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    for fn in ("qt_sharded_sample_tiled", "qt_sharded_sample_flat"):
        getattr(lib, fn).argtypes = OLD_SHARDED
        getattr(lib, fn).restype = I
    lib.qt_error_string.argtypes = [I]
    lib.qt_error_string.restype = ctypes.c_char_p
    return lib


@contextmanager
def using(lib):
    """The package's K1 wrappers launch ``lib``'s entry points inside."""
    saved = _kernels._libs["sample"]
    _kernels._libs["sample"] = lib
    try:
        yield
    finally:
        _kernels._libs["sample"] = saved


def launches(fn) -> int:
    torch.cuda.synchronize()
    _kernels.reset_kernel_launches()
    fn()
    n = _kernels.kernel_launches()
    torch.cuda.synchronize()
    return n


def in_turns(old_fn, tree_fn):
    """Median ms and queued ms of each, taken earlier, tree, tree, earlier."""
    ms = {name: {"runs": [], "queued_runs": []} for name in ("earlier", "tree")}
    for name in ("earlier", "tree", "tree", "earlier"):
        fn = old_fn if name == "earlier" else tree_fn
        ms[name]["runs"].append(cs.time_ms(fn))
        ms[name]["queued_runs"].append(cs.time_ms_queued(fn))
    for v in ms.values():
        v["mean"] = sum(v["runs"]) / 2
        v["queued_mean"] = sum(v["queued_runs"]) / 2
    ms["queued_speedup"] = ms["earlier"]["queued_mean"] / ms["tree"]["queued_mean"]
    return ms


def k1_case(old, tag, g, fn, plain, cur, valid, k, key, indptr, check_plain=True):
    args = (cur, valid, k, key)
    got = fn(*g, *args)
    with using(old):
        was = fn(*g, *args)
    want = plain(*g, *args) if check_plain else got
    torch.cuda.synchronize()
    for a, b, c in zip(got, was, want):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise RuntimeError(f"{tag}: the tree's draw differs from the earlier build's or the "
                               "plain version")
    n = launches(lambda: fn(*g, *args))

    def old_fn():
        with using(old):
            fn(*g, *args)

    b = cs.sample_bound(indptr, cur, valid, k)
    log({"case": tag, "W": int(cur.shape[0]), "k": k, "bit_equal": True, "kernels": n,
         "bound_ms": b[0], "bound_by": b[1],
         "ms": in_turns(old_fn, lambda: fn(*g, *args))})


def old_pair(old, layout, a, b, start, end, cur, valid, k, key):
    """The earlier K13b: the [W, k] neighbor and int32 flag pair."""
    W = cur.shape[0]
    nbrs = torch.empty((W, k), dtype=torch.int32, device=cur.device)
    flags = torch.empty((W, k), dtype=torch.int32, device=cur.device)
    n_rows = a.shape[0] if layout == "tiled" else a.shape[0] - 1
    rc = getattr(old, f"qt_sharded_sample_{layout}")(
        a.data_ptr(), b.data_ptr(), b.shape[0], n_rows, start, end, cur.data_ptr(),
        valid.data_ptr(), W, k, int(key[0]), int(key[1]), nbrs.data_ptr(), flags.data_ptr(),
        _kernels.stream_of(cur))
    if rc:
        raise RuntimeError(f"the earlier K13b failed to launch: {old.qt_error_string(rc)}")
    return nbrs, flags


def shard_blocks(meshes, topo, axes):
    n = meshes[0].axis_size(axes)
    by_shard = [next(m for m in meshes if m.index(axes) == p) for p in range(n)]
    flat = [shard_topology_rows(m, topo, layout="flat") for m in by_shard]
    tiled = [shard_topology_rows(m, topo, layout="tiled") for m in by_shard]
    return {"flat": ([(s.indptr, s.indices) for s in flat], sample_layer_partial_slab),
            "tiled": ([(s.bd, s.tiles) for s in tiled], tiled_sample_layer_partial_slab)}, \
        flat[0].row_start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-sample", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sample_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": cs.card_line()})
    log({"ptxas": "tree", "log": [l for l in _kernels.build_log.get("sample", "").splitlines()
                                  if "registers" in l or "spill" in l]})
    old = build_old(args.old_sample)
    dev = torch.device("cuda")
    seed = args.seed
    topo = cs.build_graph(1.0, seed)
    n = topo.node_count
    g_tiled, g_flat = topo.to_device_tiled(dev), topo.to_device(dev)
    indptr = g_flat[0]
    layouts = (("tiled", g_tiled, sample.tiled_sample_layer, sample.tiled_sample_layer_plain),
               ("flat", g_flat, sample.sample_layer, sample.sample_layer_plain))

    # K1 / K1b at a B = 64 flush's hops
    trace = zipfian_trace(n, 2000, alpha=0.99, seed=seed + 1)
    flush = torch.from_numpy(trace[:cs.BATCH].astype(np.int32)).to(dev)
    hops, _ = cs.hop_inputs(g_tiled, flush, qrandom.fold_in(qrandom.key(1234), 0))
    for name, g, fn, plain in layouts:
        for l, h in enumerate(hops):
            k1_case(old, f"K1 {name} flush hop {l}", g, fn, plain, h["cur"], h["cur_valid"],
                    h["k"], h["key"], indptr)

    # a batch of 1,024: its hops uncapped and capped, then the wide fanouts
    table = torch.randn((n, cs.DIM), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    train_idx = np.random.default_rng(seed + 3).choice(n, cs.PRODUCTS_TRAIN, replace=False)
    seeds = torch.from_numpy(train_idx[:cs.TRAIN_BATCH].astype(np.int32)).to(dev)
    order = np.random.default_rng(seed + 80).permutation(train_idx)
    probes = order[-cs.MC_CAP_PROBES * cs.TRAIN_BATCH:].reshape(cs.MC_CAP_PROBES, cs.TRAIN_BATCH)
    caps = GraphSageSampler(topo, cs.SIZES, device=dev, seed=seed + 81).calibrate_caps(
        probes, margin=cs.CAP_MARGIN, granule=cs.CAP_GRANULE)
    log({"caps": caps})
    for tag, c in (("uncapped", None), ("capped", caps)):
        bh, _ = cs.hop_inputs(g_tiled, seeds, qrandom.key(seed + 44), caps=c)
        for name, g, fn, plain in layouts:
            for l, h in enumerate(bh):
                k1_case(old, f"K1 {name} batch {tag} hop {l}", g, fn, plain, h["cur"],
                        h["cur_valid"], h["k"], h["key"], indptr)
    ones = torch.ones_like(seeds, dtype=torch.bool)
    for k in (33, 64, 512):
        for name, g, fn, plain in layouts:
            k1_case(old, f"K1 {name} k={k}", g, fn, plain, seeds, ones, k,
                    qrandom.fold_in(qrandom.key(4321), k), indptr)
    rng = np.random.default_rng(seed + 5)
    for k in SCAN_KS:
        for W in SCAN_WIDTHS:
            cur = torch.from_numpy(rng.integers(0, n, W).astype(np.int32)).to(dev)
            valid = torch.ones(W, dtype=torch.bool, device=dev)
            k1_case(old, f"K1 tiled scan W={W} k={k}", g_tiled, sample.tiled_sample_layer,
                    sample.tiled_sample_layer_plain, cur, valid, k, qrandom.key(W + k), indptr,
                    check_plain=False)

    # K13b: shard 0 of the ici pair (dp 2 x ici 2) at kernels-8's calibrated hops
    meshes = local_meshes(cs.MC_RANKS, dp=cs.MC_DP, device=dev, timeout_s=600)
    blocks, row_start = shard_blocks(meshes, topo, "ici")
    key = qrandom.fold_in(qrandom.key(seed + 82), 0)
    lane_hops, _ = cs.dedup_lanes(topo, table, caps, seeds, key)
    start, end = int(row_start[0]), int(row_start[1])
    for layout, (blk, slab_fn) in blocks.items():
        for l, (cur, cv, k, sub) in enumerate(lane_hops):
            a = (*blk[0], start, end, cur, cv, k, sub)
            slab = slab_fn(*a)
            was = old_pair(old, layout, *a)
            torch.cuda.synchronize()
            if not (torch.equal(slab[0, 0], was[0]) and torch.equal(slab[0, 1], was[1])):
                raise RuntimeError(f"K13b {layout} hop {l}: the tree differs from the earlier "
                                   "build")
            own = cv & (cur >= start) & (cur < end)
            b = cs.sharded_sample_bound(indptr, cur, cv, k, start, end)
            log({"case": f"K13b {layout} shard 0 hop {l}", "W": int(cur.shape[0]), "k": k,
                 "owned_rows": int(own.sum()), "bit_equal": True,
                 "kernels": launches(lambda: slab_fn(*a)), "bound_ms": b[0], "bound_by": b[1],
                 "ms": in_turns(lambda: old_pair(old, layout, *a), lambda: slab_fn(*a))})
    del blocks, meshes

    # K13e: rank (0, 0) of host 2 x dp 1 x ici 2 at kernels-9's calibrated hops
    meshes = local_meshes(cs.HOST_RANKS, hosts=cs.HOST_HOSTS, device=dev, timeout_s=600)
    G, ici = meshes[0].hosts, meshes[0].ici
    blocks, row_start = shard_blocks(meshes, topo, ("host", "ici"))
    hkey = qrandom.key(seed + 130)
    keys = [qrandom.split(qrandom.fold_in(hkey, g))[0] for g in range(G)]
    group_seeds = [torch.from_numpy(order[g * cs.TRAIN_BATCH:(g + 1) * cs.TRAIN_BATCH]
                                    .astype(np.int32)).to(dev) for g in range(G)]
    lanes = [cs.dedup_lanes(topo, table, caps, group_seeds[g], keys[g])[0] for g in range(G)]
    for layout, (blk, slab_fn) in blocks.items():
        for l in range(len(cs.SIZES)):
            k = lanes[0][l][2]
            w = lanes[0][l][0].shape[0]
            all_cur = torch.cat([lanes[g][l][0] for g in range(G)])
            all_valid = torch.cat([lanes[g][l][1] for g in range(G)])
            # the slabs rank (0, 0) receives: shard (g, 0)'s draw of host 0's rows
            recv = torch.stack([slab_fn(*blk[g * ici], int(row_start[g * ici]),
                                        int(row_start[g * ici + 1]), all_cur, all_valid, k,
                                        keys[g], groups=G)[0] for g in range(G)])
            a0 = (*blk[0], int(row_start[0]), int(row_start[1]), all_cur, all_valid, k, keys[0])
            pa, pb = recv[:, 0].contiguous(), recv[:, 1].contiguous()

            def tree_hop():
                return slab_fn(*a0, groups=G), grouped_unpack(recv)

            def old_hop():
                return old_pair(old, layout, *a0), grouped_unpack(pa), grouped_unpack(pb)

            t, o = tree_hop(), old_hop()
            torch.cuda.synchronize()
            if not (torch.equal(t[0][:, 0].reshape(-1, k), o[0][0])
                    and torch.equal(t[0][:, 1].reshape(-1, k), o[0][1])
                    and torch.equal(t[1][0], o[1]) and torch.equal(t[1][1], o[2])):
                raise RuntimeError(f"K13e {layout} hop {l}: the tree differs from the earlier "
                                   "draw and unpacks")
            b = cs.sharded_sample_bound(indptr, all_cur, all_valid, k, int(row_start[0]),
                                        int(row_start[1]))
            log({"case": f"K13e {layout} rank (0, 0) hop {l}", "W": w, "G": G, "k": k,
                 "bit_equal": True, "kernels": launches(tree_hop), "draw_bound_ms": b[0],
                 "ms": in_turns(old_hop, tree_hop)})
    return 0


if __name__ == "__main__":
    sys.exit(main())

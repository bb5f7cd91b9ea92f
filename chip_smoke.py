#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphSAGE serving path on one card.

    python3 chip_smoke.py [--scale 1.0] [--requests 2000] [--seed 0]

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — compile every kernel of the path from ``quiver_tpu_torch/csrc``
             (one nvcc per source, in parallel) and print the seconds;
2. card    — the card's name and power limit from nvidia-smi;
3. graph   — a products-shaped power-law graph from the seed (2,449,029
             nodes and 123,718,280 directed edges at scale 1.0), a
             [N, 100] float32 feature table and a GraphSAGE(100 -> 256 ->
             256 -> 47) with weights from seeded numpy;
4. kernels — every kernel at the shapes one B=64 flush gives it (sizes
             [15, 10, 5], D = 100 and 256), held against its plain torch
             version on the same inputs on the card: bit-equal for the
             sampler (tiled and flat), the reindex and the gather, within
             1e-5 for the neighbor mean. Times are medians of CUDA-event
             timed runs with the L2 cache flushed between runs;
5. serve   — ServeEngine(max_batch=64) on the tiled sampler: warmup, then
             Zipf requests from 4 client threads; every kernel of the path
             must have launched (counts zeroed just before, read just
             after). Then 8 dispatches replayed through batch_logits with a
             fresh sampler must equal the served rows bit for bit, and 2
             dispatches replayed with the plain torch versions on the CPU
             must agree within 1e-3;
6. flat    — a shorter serve run on the flat layout (the flat sampling
             kernel's path), counts read the same way;
7. report  — one JSON line of all kernels, the card line, then the
             ``{"ok": true, ...}`` line last.

Exits non-zero without a card. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # deterministic GEMMs

import numpy as np
import torch

from quiver_tpu_torch import GraphSAGE, GraphSageSampler, ServeConfig, ServeEngine, _kernels
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.datasets import PRODUCTS, powerlaw_csr
from quiver_tpu_torch.feature import gather_rows, gather_rows_plain
from quiver_tpu_torch.inference import batch_logits, bind_params
from quiver_tpu_torch.models.sage import masked_mean_aggregate, masked_mean_aggregate_plain
from quiver_tpu_torch.ops import reindex, sample
from quiver_tpu_torch.serve import zipfian_trace
from quiver_tpu_torch.utils import CSRTopo

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
# Its 67 TFLOP/s float32 rate counts an FMA as two operations on 128 lanes
# per SM; a lone float add issues at half of it, and a 32-bit integer op
# (add, shift, logic, compare) at 64 per SM per clock, a quarter of it
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0).
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# integer ops of one threefry2x32 uniform: 2 key adds, 5 rounds of 4 x
# (add, funnel shift, xor) and 2 key adds, then xor, shift and or
THREEFRY_INT_OPS = 2 + 5 * (4 * 3 + 2) + 3
STEP_INT_OPS = 5  # a Fisher-Yates step besides its draw: span, j, clamp, head test

SIZES = (15, 10, 5)
BATCH = 64
DIM, HIDDEN, CLASSES = 100, 256, 47
N_EDGES_FULL = 2 * PRODUCTS["n_edges"]  # products is undirected: both directions

SOURCES = {
    "sample_tiled": ("quiver_tpu_torch/csrc/sample.cu", "quiver_tpu/ops/sample.py:526"),
    "sample_flat": ("quiver_tpu_torch/csrc/sample.cu", "quiver_tpu/ops/sample.py:288"),
    "local_reindex": ("quiver_tpu_torch/csrc/reindex.cu", "quiver_tpu/ops/reindex.py:124"),
    "gather_rows": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/feature.py:141"),
    "masked_mean": ("quiver_tpu_torch/csrc/aggregate.cu", "quiver_tpu/models/sage.py:25"),
}
MAIN_PATH = ("sample_tiled", "local_reindex", "gather_rows", "masked_mean")


def log(*a):
    print(*a, flush=True)


class Failed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


# -- timing --------------------------------------------------------------------

_L2_FLUSH = None


def time_ms(fn, reps=15, warm=3):
    """Median device milliseconds of ``fn()``, each run timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2 cache."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _L2_FLUSH.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved, int_ops=0, f32_adds=0):
    """Least time (ms) for the work, and which side binds: the bytes over
    the HBM rate, or the operations over their peak rate (integer and
    float pipes issue side by side, so the slower of the two)."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = max(int_ops / INT32_OPS_PER_S, f32_adds / F32_ADDS_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sample_bound(indptr, cur, cur_valid, k):
    """K1's least time for one hop on this hop's data. Bytes: seeds and
    flags, one (base, degree) pair and min(deg, k) neighbor ids per
    distinct valid seed, the [W, k] ids and flags written. Operations:
    only rows with deg > k draw; each takes k uniforms and k steps, and
    step i scans the i tail slots filled before it."""
    W = cur.shape[0]
    s = torch.clamp(cur.long(), 0, indptr.shape[0] - 2)
    deg = torch.where(cur_valid, indptr[s + 1] - indptr[s], 0)
    u = torch.unique(s[cur_valid])
    deg_u = indptr[u + 1] - indptr[u]
    n_bytes = W * 5 + u.numel() * 8 + int(torch.clamp(deg_u, max=k).sum()) * 4 + W * k * 5
    n_draw = int((deg > k).sum())
    return bound(n_bytes, n_draw * (k * (THREEFRY_INT_OPS + STEP_INT_OPS) + k * (k - 1) // 2))


# -- phases ----------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_graph(scale: float, seed: int):
    n = max(int(PRODUCTS["n_nodes"] * scale), 1000)
    e = max(int(N_EDGES_FULL * scale), 10 * n)
    t0 = time.perf_counter()
    indptr, indices = powerlaw_csr(n, e, seed=seed)
    topo = CSRTopo(indptr=indptr, indices=indices)
    log(f"graph: {n} nodes, {topo.edge_count} edges, built in {time.perf_counter() - t0:.1f} s")
    return topo


def make_model_params(seed: int):
    """GraphSAGE(100, 256, 47, 3 layers) and a state_dict drawn from
    seeded numpy (uniform in +-1/sqrt(fan_in), as nn.Linear draws)."""
    model = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    params = {}
    for name, p in sd.items():
        lim = 1.0 / np.sqrt(sd[name.rsplit(".", 1)[0] + ".weight"].shape[1])
        params[name] = torch.from_numpy(rng.uniform(-lim, lim, tuple(p.shape)).astype(np.float32))
    return model, params


def hop_inputs(graph_tiled, seeds, key):
    """The inputs one B=64 flush hands each kernel: per hop the sampling
    and reindex inputs, then the final n_id for the gather."""
    cur = seeds
    cur_valid = torch.ones_like(seeds, dtype=torch.bool)
    hops = []
    for k in SIZES:
        key, sub = qrandom.split(key)
        nbrs, valid = sample.tiled_sample_layer(*graph_tiled, cur, cur_valid, k, sub)
        hops.append(dict(cur=cur, cur_valid=cur_valid, k=k, key=sub, nbrs=nbrs, valid=valid))
        res = reindex.local_reindex(cur, cur_valid, nbrs, valid)
        cur = res.n_id
        cur_valid = torch.arange(cur.shape[0], device=cur.device) < res.count
    return hops, cur


def kernel_phase(topo, table, model, seeds):
    """Hold every kernel against its plain version at the path's shapes;
    returns per-kernel sums over one flush's calls."""
    dev = table.device
    g_tiled = topo.to_device_tiled(dev)
    g_flat = topo.to_device(dev)
    key = qrandom.fold_in(qrandom.key(1234), 0)
    hops, n_id = hop_inputs(g_tiled, seeds, key)
    rows = {}

    def add(name, err, ms, plain_ms, b, lib_ms=None, shape=""):
        r = rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                       bound_by="bytes", library_ms=None, calls=0))
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b[0]
        if b[1] == "operations":
            r["bound_by"] = "operations"
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["calls"] += 1
        log(json.dumps({"kernel": name, "shape": shape, "kernel_ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
                        "max_abs_err": float(err)}))

    def int_err(a, b):
        for x, y in zip(a, b):
            check(torch.equal(x, y), "kernel output differs from its plain version")
        return 0.0

    # K1 / K1b: sampling, tiled and flat, at each hop's width
    for h in hops:
        W, k = h["cur"].shape[0], h["k"]
        args = (h["cur"], h["cur_valid"], k, h["key"])
        b = sample_bound(g_flat[0], h["cur"], h["cur_valid"], k)
        for name, g, fn, plain in (
            ("sample_tiled", g_tiled, sample.tiled_sample_layer, sample.tiled_sample_layer_plain),
            ("sample_flat", g_flat, sample.sample_layer, sample.sample_layer_plain),
        ):
            got, want = fn(*g, *args), plain(*g, *args)
            err = int_err(got, want)
            check(torch.equal(got[1], h["valid"]) and torch.equal(got[0][got[1]], h["nbrs"][h["valid"]]),
                  "flat and tiled draws differ")
            add(name, err, time_ms(lambda: fn(*g, *args)), time_ms(lambda: plain(*g, *args), reps=5),
                b, shape=f"W={W} k={k}")

    # K2: reindex at each hop
    for h in hops:
        S, k = h["cur"].shape[0], h["k"]
        args = (h["cur"], h["cur_valid"], h["nbrs"], h["valid"])
        got, want = reindex.local_reindex(*args), reindex.local_reindex_plain(*args)
        int_err((got.n_id, got.count, got.local_seeds, got.local_nbrs[h["valid"]]),
                (want.n_id, want.count, want.local_seeds, want.local_nbrs[h["valid"]]))
        W = S * (1 + k)
        b = bound(S * 5 + S * k * 5 + W * 4 + 4 + S * 4 + S * k * 4)
        add("local_reindex", 0.0, time_ms(lambda: reindex.local_reindex(*args)),
            time_ms(lambda: reindex.local_reindex_plain(*args), reps=5), b, shape=f"S={S} k={k}")

    # K3: the feature gather of the final n_id
    n = n_id.shape[0]
    int_err((gather_rows(table, n_id),), (gather_rows_plain(table, n_id),))
    clipped = torch.clamp(n_id, 0, table.shape[0] - 1)
    # the padding slots all clip to one row: each distinct row is read once
    b = bound(n * 4 + torch.unique(clipped).numel() * DIM * 4 + n * DIM * 4)
    add("gather_rows", 0.0, time_ms(lambda: gather_rows(table, n_id)),
        time_ms(lambda: gather_rows_plain(table, n_id)), b,
        lib_ms=time_ms(lambda: torch.index_select(table, 0, clipped)), shape=f"n={n} D={DIM}")

    # K4: the neighbor mean of each layer, on that layer's real input
    from quiver_tpu_torch.pyg.sage_sampler import sample_dense_pure

    ds = sample_dense_pure(None, None, key, seeds, SIZES,
                           sample_fn=lambda c, v, k, kk: sample.tiled_sample_layer(
                               *g_tiled, c, v, k, kk))
    check(torch.equal(ds.n_id, n_id), "multi-hop sample differs from the hop-by-hop inputs")
    with torch.inference_mode():
        x = gather_rows(table, ds.n_id)
        for conv, adj in zip(model.convs, ds.adjs):
            W, k = adj.mask.shape
            D = x.shape[1]
            got = masked_mean_aggregate(x, adj)
            want = masked_mean_aggregate_plain(x, adj)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"masked_mean differs from its plain version by {err}")
            lanes = int(adj.mask.sum())
            # targets share neighbors under dedup: each distinct source row is read once
            if adj.cols is None:
                src = (W + torch.arange(k, device=dev)[None, :] * W
                       + torch.arange(W, device=dev)[:, None])
            else:
                src = torch.clamp(adj.cols, 0, x.shape[0] - 1)
            idx_bytes = W * k * (5 if adj.cols is not None else 1)
            b = bound(idx_bytes + torch.unique(src[adj.mask]).numel() * D * 4 + W * D * 4,
                      f32_adds=lanes * D + W * D)
            add("masked_mean", err, time_ms(lambda: masked_mean_aggregate(x, adj)),
                time_ms(lambda: masked_mean_aggregate_plain(x, adj), reps=5), b,
                shape=f"W={W} k={k} D={D}")
            x = torch.relu(conv(x, adj))
    torch.cuda.synchronize()
    return rows


def serve_phase(engine, trace, clients):
    """Requests from ``clients`` threads, 8 ids a call; returns
    (node -> first served row, wall seconds)."""
    served = {}
    lock = threading.Lock()
    errors = []

    def client(chunk):
        try:
            for j in range(0, len(chunk), 8):
                ids = chunk[j:j + 8]
                out = engine.predict(ids, timeout=120)
                with lock:
                    for node, row in zip(ids.tolist(), out):
                        served.setdefault(node, row)
        except Exception as exc:  # noqa: BLE001 — reported and failed below
            errors.append(exc)

    t0 = time.perf_counter()
    with engine:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in np.array_split(trace, clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client did not finish")
    check(not errors, f"client errors: {errors[:3]}")
    return served, wall


def replay_check(topo, model, params, table, engine, served, device, n_dispatch, atol):
    """Replay the first dispatches through batch_logits with a fresh
    sampler on ``device``; returns the largest difference to the served
    rows (0.0 means bit-equal)."""
    feat = table if device != "cpu" else table.cpu()
    m = bind_params(model, params, device)
    twin = GraphSageSampler(topo, SIZES, device=device, seed=engine._sampler._seed)
    worst = 0.0
    for padded, nvalid in engine.dispatch_log[:n_dispatch]:
        out = batch_logits(m, twin, feat, padded).cpu().numpy()
        for i in range(nvalid):
            row = served.get(int(padded[i]))
            if row is not None:
                worst = max(worst, float(np.abs(row - out[i]).max()))
    check(worst <= atol, f"replay on {device} differs from the served rows by {worst}")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="graph scale (1.0 = products)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    log(f"build: {_kernels.build():.1f} s")
    for stem, text in sorted(_kernels.build_log.items()):
        log(f"-- ptxas {stem}.cu\n{text.strip()}")
    card = card_line()
    log(f"card: {card}")

    topo = build_graph(args.scale, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    table = torch.randn((topo.node_count, DIM), generator=gen, device=dev)
    model, params = make_model_params(args.seed)
    trace = zipfian_trace(topo.node_count, args.requests, alpha=0.99, seed=args.seed + 1)
    seeds = torch.from_numpy(trace[:BATCH].astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=args.seed)  # tiled, dedup
    log(f"tiled graph on the card in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase(topo, table, bind_params(model, params, dev), seeds)

    # -- the main path: tiled serving ------------------------------------------
    engine = ServeEngine(model, params, sampler, table,
                         ServeConfig(max_batch=BATCH, record_dispatches=True))
    warm = engine.warmup()
    log(f"warmup: {json.dumps({str(b): round(t, 4) for b, t in warm.items()})}")
    engine.reset_stats()
    _kernels.reset_counts()
    served, wall = serve_phase(engine, trace, clients=4)
    counts = _kernels.counts()
    st = engine.stats
    check(st.requests == args.requests and len(served) == len(set(trace.tolist())),
          "not every request was answered")
    out = np.stack(list(served.values()))
    check(out.shape[1] == CLASSES and np.isfinite(out).all(), "served logits malformed")
    summary = {
        "requests": st.requests, "wall_s": wall, "qps": st.requests / wall,
        "latency": st.latency.snapshot(), "cache_hit_rate": st.cache.hit_rate, "coalesced": st.coalesced,
        "dispatches": st.dispatches, "dispatched_seeds": st.dispatched_seeds,
        "inflight_peak": st.inflight_peak, "launches": counts,
        "launches_per_flush": {k: v / max(st.dispatches, 1) for k, v in counts.items()},
        "overlap": st.spans.overlap_summary(),
    }
    log("serve: " + json.dumps(summary))
    for name in MAIN_PATH:
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    launches = dict(counts)
    replay_dev = replay_check(topo, model, params, table, engine, served, dev, 8, 0.0)
    replay_cpu = replay_check(topo, model, params, table, engine, served, "cpu", 2, 1e-3)
    log(f"replay: 8 dispatches on the card max |diff| {replay_dev} (bit-equal); "
        f"2 on the CPU plain path max |diff| {replay_cpu:.3g}")

    # -- the flat layout's path ------------------------------------------------
    flat = GraphSageSampler(topo, SIZES, device=dev, seed=args.seed, layout="flat")
    fengine = ServeEngine(model, params, flat, table, ServeConfig(max_batch=BATCH))
    fengine.warmup()
    _kernels.reset_counts()
    fserved, fwall = serve_phase(fengine, trace[: max(args.requests // 8, 64)], clients=2)
    fcounts = _kernels.counts()
    log("flat serve: " + json.dumps({"requests": fengine.stats.requests, "wall_s": fwall,
                                     "launches": fcounts}))
    for name in ("sample_flat", "local_reindex", "gather_rows", "masked_mean"):
        check(fcounts[name] > 0, f"kernel {name} never launched on the flat path")
    launches["sample_flat"] = fcounts["sample_flat"]

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)

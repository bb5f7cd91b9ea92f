#!/usr/bin/env python3
"""The Gumbel top-k draw (K7 tiled and flat, K8; ``csrc/weighted.cu``) of
the tree against a build of an earlier source of ``weighted.cu`` (the
kernel before its redesign), at the shapes of ``chip_smoke.py``'s
kernels-5 and fanout phases on the products-shaped graph, timed in turns
in one process, with the cost of the scoring chain alone.

    python3 scripts/torch_gumbel_probe.py --old-weighted OLD.cu [--variant NAME=SPEC ...]

Needs one CUDA card. Builds, with the tree's nvcc flags, all at once:
the earlier source; the tree's with its arg-max rounds off
(``-DQT_ARGMAX_MAX_K=0``: every k through the radix select) and on up to
k = 64 (``argmax64``); the tree's scoring pass alone
(``-DQT_GUMBEL_SCORE_ONLY=1``: no selection, outputs unchecked); and each
``--variant`` (``name=FILE.cu``, or ``name=tree:-DMACRO=VALUE``). Each
library is loaded with ctypes and swapped in under the package's
wrappers in turn (the C entry points did not change).

First, the cost of a live lane's scoring chain alone, from a small
kernel (``csrc/gumbel.cuh``'s device functions in a grid-stride loop over
15,113,458 lanes, a hop 3's live lanes, no memory but one word a
thread): the threefry uniform, then with log(u), with -log(-log(u)), the
whole score (a third log, of a weight made from u), each as throughput
(a wave of 1,056 blocks of 256 threads) and as latency (one warp, 1,000
lanes a thread), the score with its noise read from a table of the 2^23
uniforms' noise (32 MB) in place of two logs, and the lanes where the
table differs from the logs; and the opcodes of the tree's tiled kernel
in its SASS (``cuobjdump -sass``), counted by kind.

Then the shapes: K7 tiled and flat at the three hops of a batch-1024
weighted sample ([15, 10, 5], max_deg 512), K8 at the three hops of a
B = 64 temporal flush (recency 0.02 with and without the cutoff 10,
recency 0), and K7 tiled and flat and K8 at k = 64 over the 1,024 seeds.
Every build's outputs but the scoring pass's are checked bit-equal to
the tree's, and the tree's to the plain version. Prints one JSON object
a shape: the live lanes (below deg, weight > 0) and the lanes a warp a
row walks (32 a step to max(deg, k)), each build's median milliseconds
of CUDA-event timed runs with the L2 cache flushed (`chip_smoke.time_ms`)
and queued behind a 1 ms spin (`chip_smoke.time_ms_queued`, the card's
time alone), taken first to last and back, and the earlier build's and
the tree's queued time at k = 1 (the scoring pass and one round of
selection).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
from quiver_tpu_torch.workloads import TemporalTiledGraph, quantize_t  # noqa: E402
from quiver_tpu_torch.serve import temporal_trace  # noqa: E402

BUILDS = ["earlier", "tree", "argmax0", "argmax64", "scoreonly"]  # more with --variant
UNCHECKED = {"scoreonly"}  # timing builds whose outputs are not the draw's
CHAIN_LANES = 15_113_458
CHAIN_SRC = r"""
#include "common.cuh"
#include "gumbel.cuh"
// the Gumbel noise -log(-log(u)) of each of the 2^23 uniforms (u's 23 bits)
__global__ void table_kernel(float* t) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const float f = __fsub_rn(__uint_as_float(static_cast<unsigned>(m) | 0x3F800000u), 1.0f);
  const float u = fmaxf(QT_GUMBEL_MINVAL, __fmaf_rn(f, __fsub_rn(1.0f, QT_GUMBEL_MINVAL),
                                                    QT_GUMBEL_MINVAL));
  t[m] = -qt_log32(-qt_log32(u));
}
// mode 0: the uniform; 1: log(u); 2: -log(-log(u)); 3: the whole score;
// 4: the score with the noise from the table; 5: mode 2 != the table (count)
__global__ void chain_kernel(int mode, long long n, unsigned k0, unsigned k1, const float* t,
                             unsigned* out) {
  unsigned acc = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    const float u = qt_gumbel_uniform(k0, k1, static_cast<uint64_t>(i));
    float s = u;
    if (mode == 1) s = qt_log32(u);
    if (mode == 2) s = -qt_log32(-qt_log32(u));
    if (mode == 3) s = qt_gumbel_score(__fmaf_rn(u, 0.5f, 0.25f), u);
    const int m = static_cast<int>(__fmul_rn(__fsub_rn(u, QT_GUMBEL_MINVAL), 8388608.0f));
    if (mode == 4) s = __fadd_rn(qt_log32(__fmaf_rn(u, 0.5f, 0.25f)), t[m & 0x7FFFFF]);
    if (mode == 5) {
      const float f = qt_uniform(k0, k1, static_cast<uint64_t>(i));
      const int mm = static_cast<int>(__fmul_rn(f, 8388608.0f));
      acc += __float_as_uint(-qt_log32(-qt_log32(u))) != __float_as_uint(t[mm]);
      continue;
    }
    acc ^= __float_as_uint(s);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
QT_EXPORT int qt_chain_probe(int mode, long long n, int blocks, int threads, const void* t,
                             void* out, void* stream) {
  chain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, n, 0x1234u, 0x5678u, static_cast<const float*>(t), static_cast<unsigned*>(out));
  return qt_launch_status();
}
QT_EXPORT int qt_chain_table(void* t, void* stream) {
  table_kernel<<<(1 << 23) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(t));
  return qt_launch_status();
}
QT_DEFINE_ERROR_STRING
"""


def log(obj):
    print(json.dumps(obj), flush=True)


def chain_costs():
    """ms of the scoring chain alone, by mode, as throughput and latency."""
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    cu, so = tmp / "chain.cu", tmp / "libchain.so"
    cu.write_text(CHAIN_SRC)
    out = subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, "-I",
                          str(_kernels.CSRC), "-o", str(so), str(cu)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the chain probe:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.qt_chain_probe.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.qt_chain_table.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    buf = torch.empty(1056 * 256, dtype=torch.int32, device="cuda")
    table = torch.empty(1 << 23, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    table_ms = cs.time_ms_queued(lambda: lib.qt_chain_table(table.data_ptr(), stream))
    res = {"table_build_ms": table_ms}
    for mode, what in enumerate(("uniform", "log(u)", "-log(-log(u))", "score",
                                 "score, noise from the table", "noise != table")):
        def run(n, blocks, threads, mode=mode):
            if lib.qt_chain_probe(mode, n, blocks, threads, table.data_ptr(), buf.data_ptr(),
                                  stream):
                raise RuntimeError("the chain probe failed to launch")
        if mode == 5:
            run(CHAIN_LANES, 1056, 256)
            res[what] = int(buf.sum())
            continue
        res[what] = {"throughput_ms": cs.time_ms_queued(lambda: run(CHAIN_LANES, 1056, 256)),
                     "ns_a_lane_one_warp": cs.time_ms_queued(lambda: run(32_000, 1, 32)) * 1e3}
    log({"chain": res, "lanes": CHAIN_LANES})


def sass_mix():
    """Opcodes of the tree's tiled Gumbel kernel, by kind."""
    tool = Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_kernels._lib_path("weighted"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if not fn or "12TiledWeights" not in fn:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m:
            op = m.group(2).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    log({"sass_tiled_opcodes": dict(sorted(counts.items(), key=lambda x: -x[1])),
         "total": sum(counts.values())})


def build_variants(old: Path, extra):
    """``{name: CDLL}``: the earlier source, the tree's with two
    crossovers and each ``--variant`` (``name=FILE.cu`` or
    ``name=tree:-DMACRO=VALUE``), built with the tree's nvcc flags, all
    at once."""
    tmp = Path(tempfile.mkdtemp(dir=_kernels.BUILD_DIR))
    tree = _kernels.CSRC / "weighted.cu"
    jobs = {"earlier": (old, []), "argmax0": (tree, ["-DQT_ARGMAX_MAX_K=0"]),
            "argmax64": (tree, ["-DQT_ARGMAX_MAX_K=64"]),
            "scoreonly": (tree, ["-DQT_GUMBEL_SCORE_ONLY=1"])}
    for spec in extra:
        name, src = spec.split("=", 1)
        jobs[name] = (tree, [src[5:]]) if src.startswith("tree:") else (Path(src), [])
        BUILDS.append(name)
    procs = {}
    for name, (src, defs) in jobs.items():
        cu, so = tmp / f"weighted_{name}.cu", tmp / f"libweighted_{name}.so"
        cu.write_text(src.read_text())
        cmd = [_kernels._nvcc(), *_kernels.ARCH_FLAGS, *_kernels.NVCC_FLAGS, *defs, "-I",
               str(_kernels.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {"tree": _kernels._lib("weighted")}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} weighted.cu:\n{out}")
        lib = ctypes.CDLL(str(so))
        for stem, fn, argtypes in _kernels.KERNELS.values():
            if stem == "weighted":
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.qt_error_string.argtypes = [ctypes.c_int]
        lib.qt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        log({"ptxas": name, "log": "\n".join(line for line in out.splitlines()
                                             if "registers" in line or "spill" in line)})
    return libs


@contextmanager
def using(lib):
    """The package's wrappers launch ``lib``'s entry points inside."""
    saved = _kernels._libs["weighted"]
    _kernels._libs["weighted"] = lib
    try:
        yield
    finally:
        _kernels._libs["weighted"] = saved


def timed(libs, fn):
    """Median ms of ``fn()`` under each build, taken first to last and back,
    by `chip_smoke.time_ms` and `chip_smoke.time_ms_queued`."""
    ms = {name: {"runs": [], "queued_runs": []} for name in BUILDS}
    for name in BUILDS + BUILDS[::-1]:  # first to last, then back
        with using(libs[name]):
            ms[name]["runs"].append(cs.time_ms(fn))
            ms[name]["queued_runs"].append(cs.time_ms_queued(fn))
    for v in ms.values():
        v["mean"] = sum(v["runs"]) / len(v["runs"])
        v["queued_mean"] = sum(v["queued_runs"]) / len(v["queued_runs"])
    return ms


def case(libs, tag, fn, plain, k1, deg, k, live):
    """One shape: every build bit-equal to the tree and the tree to the
    plain version; times; lanes."""
    outs = {}
    for name in BUILDS:
        with using(libs[name]):
            outs[name] = fn()
    want = plain()
    torch.cuda.synchronize()
    tree = outs["tree"]
    for name, got in list(outs.items()) + [("plain", want)]:
        if name in UNCHECKED:
            continue
        if not (torch.equal(got[0], tree[0]) and torch.equal(got[1], tree[1])):
            raise RuntimeError(f"{tag}: the {name} output differs from the tree's")
    span = torch.clamp(deg, min=k)
    k1_ms = {}
    for name in ("earlier", "tree"):
        with using(libs[name]):
            k1_ms[name] = cs.time_ms_queued(k1)
    log({"case": tag, "W": int(deg.shape[0]), "k": k, "live_lanes": live,
         "lanes_below_deg": int(deg.sum()), "span_lanes": int(span.sum()),
         "warp_row_lanes": int((32 * torch.ceil(span / 32.0)).sum()), "bit_equal": True,
         "ms": timed(libs, fn), "k1_queued_ms": k1_ms})


def live_lanes(key, deg, w_rows):
    return int(torch.isfinite(sample.gumbel_scores(key, deg, w_rows)).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-weighted", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=[],
                    help="another build: name=FILE.cu or name=tree:-DMACRO=VALUE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gumbel_probe: no CUDA device", file=sys.stderr)
        return 2
    _kernels.build()
    log({"card": cs.card_line()})
    chain_costs()
    sass_mix()
    libs = build_variants(args.old_weighted, args.variant)
    dev = torch.device("cuda")
    seed, D = args.seed, cs.MAX_DEG
    topo = cs.build_graph(1.0, seed)
    n = topo.node_count
    wtopo, ts_np = cs.weighted_inputs(topo, seed)
    indptr = topo.to_device(dev)[0]
    g_tiled = (*wtopo.to_device_tiled(dev), wtopo.to_device_tiled_weights(dev))
    g_flat = (*wtopo.to_device(dev), wtopo.to_device_weights(dev))
    w_flat = g_flat[2]
    train_idx = np.random.default_rng(seed + 3).choice(n, cs.PRODUCTS_TRAIN, replace=False)
    seeds = torch.from_numpy(train_idx[:cs.TRAIN_BATCH].astype(np.int32)).to(dev)

    def flat_window(cur, cur_valid):
        deg, ptr = cs.gumbel_inputs(indptr, cur, cur_valid, D)
        lanes = torch.clamp(ptr[:, None] + torch.arange(D, device=dev)[None, :], 0,
                            w_flat.shape[0] - 1)
        return deg, w_flat[lanes]

    # K7 at the weighted sample's hops, then at k = 64 over the seeds
    wsampler = GraphSageSampler(wtopo, cs.SIZES, device=dev, seed=seed + 21, weighted=True,
                                max_deg=D)
    graph_w, bind, _ = wsampler.fused_sample_spec()
    hops = cs.weighted_hops(graph_w, bind, seeds, qrandom.key(seed + 22))
    ones = torch.ones_like(seeds, dtype=torch.bool)
    hops.append(dict(cur=seeds, cur_valid=ones, k=cs.FANOUT_SIZES[0], key=qrandom.key(seed + 93)))
    for layout, g, fn, plain in (
        ("tiled", g_tiled, sample.tiled_weighted_sample_layer,
         sample.tiled_weighted_sample_layer_plain),
        ("flat", g_flat, sample.weighted_sample_layer, sample.weighted_sample_layer_plain),
    ):
        for h in hops:
            k = h["k"]
            a = (h["cur"], h["cur_valid"], k, h["key"], D)
            a1 = (h["cur"], h["cur_valid"], 1, h["key"], D)
            deg, w_rows = flat_window(h["cur"], h["cur_valid"])
            case(libs, f"K7 {layout} W={h['cur'].shape[0]} k={k}",
                 lambda g=g, fn=fn, a=a: fn(*g, *a), lambda g=g, p=plain, a=a: p(*g, *a),
                 lambda g=g, fn=fn, a1=a1: fn(*g, *a1), deg, k, live_lanes(h["key"], deg, w_rows))

    # K8 at a B = 64 temporal flush's hops, three variants, then k = 64
    tg = TemporalTiledGraph(topo, ts_np, device=dev)
    graph = tg.temporal_graph()
    ttrace = temporal_trace(n, 2000, alpha=0.99, seed=seed + 31, qps=cs.TEMPORAL_QPS, t0=0.0)
    spread = np.linspace(0, 1999, cs.BATCH).astype(np.int64)
    tseeds = torch.from_numpy(ttrace.requests[spread].astype(np.int32)).to(dev)
    tvals = torch.from_numpy(np.float32([quantize_t(t, cs.T_QUANTUM)
                                         for t in ttrace.t_query[spread]])).to(dev)
    thops = cs.temporal_hops(graph, tseeds, tvals, qrandom.key(seed + 23))
    gen = torch.Generator(device=dev).manual_seed(seed + 91)
    thops.append(dict(cur=seeds, cur_valid=ones, k=cs.FANOUT_SIZES[0], key=qrandom.key(seed + 93),
                      t=torch.rand(seeds.shape[0], generator=gen, device=dev) * cs.TS_SPAN))
    for name, rec, cutoff in (("recency 0.02", cs.RECENCY, None),
                              ("recency 0.02, cutoff 10", cs.RECENCY, 10.0),
                              ("recency 0", 0.0, None)):
        for h in thops:
            k = h["k"]
            if k == cs.FANOUT_SIZES[0] and cutoff is not None:
                continue
            tail = (h["t"], D, rec, cutoff)
            a = (h["cur"], h["cur_valid"], k, h["key"], *tail)
            a1 = (h["cur"], h["cur_valid"], 1, h["key"], *tail)
            deg, _ = cs.gumbel_inputs(indptr, h["cur"], h["cur_valid"], D)
            base = graph[0][torch.clamp(h["cur"].long(), 0, graph[0].shape[0] - 1), 0]
            w_rows = sample.temporal_weight_rows(sample._tiled_payload_window(base, graph[2], D),
                                                 h["t"], rec, cutoff)
            case(libs, f"K8 {name} W={h['cur'].shape[0]} k={k}",
                 lambda a=a: sample.tiled_temporal_sample_layer(*graph, *a),
                 lambda a=a: sample.tiled_temporal_sample_layer_plain(*graph, *a),
                 lambda a1=a1: sample.tiled_temporal_sample_layer(*graph, *a1), deg, k,
                 live_lanes(h["key"], deg, w_rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

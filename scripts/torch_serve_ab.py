"""Time two checkouts of the port's serving against each other on one card:
`ServeEngine` (chip_smoke's serve phase), `TemporalServeEngine` (its
temporal serve phase) and `DistServeEngine` fleet leg (a).

    python scripts/torch_serve_ab.py --trees OLD,NEW [--order 0,1,1,0] [--late-off]

Each tree is a checkout holding ``quiver_tpu_torch/`` and ``chip_smoke.py``
(unpack the older commit with ``git archive`` into a git-ignored directory).
One process measures the trees in turn, in ``--order`` (slots), swapping the
package's modules between slots, so both see the same graph and table (built
once, chip_smoke's products-scale powerlaw graph and ``[N, 100]`` float32
table), the same seeded weights and the same zipfian trace. Per slot:

- ``serve``: a fresh `ServeEngine` over the tiled sampler (max_batch 64) at
  max_in_flight 1 and 2, 4 client threads calling ``predict`` with 8 ids a
  call (chip_smoke's serve load) and with 32 (its ``serve burst``), ``--reps``
  runs each;
- ``temporal``: a fresh `TemporalServeEngine` over the tiled no-dedup
  sampler bound to seeded timestamps (max_batch 64, t quantum 0.05, recency
  0.02) at max_in_flight 1 and 2, chip_smoke's temporal trace (query times
  at 40 a second) from 4 clients of 8 ids, ``--reps`` runs each;
- ``fleet``: a fresh `DistServeEngine.build` (2 owners, closure residency,
  collective exchange) at max_in_flight 1 and 2, the whole trace from 4
  clients of 8 ids, ``--fleet-reps`` runs each;

each at the tree's default config and, with ``--late-off`` where the default
turns late admission on, with ``late_admission=False`` too. Every run prints
an ``ab:`` JSON line (QPS, p50/p99 from the engine's latency histogram,
flushes, mean flush width, padded lanes, late admissions). After the timed
runs of each serve and temporal setting, one more run under
``torch.profiler`` gives the card's idle share over the run (1 - the union
of the device events' intervals over the run's wall time; its line's
``rep`` is "profiled", and its QPS, slowed by the profiler, is not
summarized). The last lines are ``ab summary:``, the median of each (tree,
case) over its runs in every slot, and the card's name and power limit.
Needs one CUDA card (``--device cpu`` is a small dry run).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

CLIENTS = 4
PER_CALLS = (8, 32)
IN_FLIGHT = (1, 2)
FLEET_HOSTS = 2


def load_tree(tree: Path):
    """Import ``tree``'s chip_smoke (and through it its quiver_tpu_torch),
    dropping any copy of either a previous slot imported."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.split(".")[0] == "quiver_tpu_torch":
            del sys.modules[name]
    sys.path[:] = [str(tree)] + [p for p in sys.path if p != str(tree)]
    importlib.invalidate_caches()
    cs = importlib.import_module("chip_smoke")
    pkg = importlib.import_module("quiver_tpu_torch")
    for mod in (cs, pkg):
        if not Path(mod.__file__).resolve().is_relative_to(tree):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {tree}")
    return cs, pkg


def drive(engine, trace, per_call, t=None):
    """``trace`` from CLIENTS threads, ``per_call`` ids a predict call (with
    their query times ``t`` on a temporal engine), under the engine's
    background flushers; returns the wall seconds."""
    errors = []

    def client(chunk, tchunk):
        try:
            for j in range(0, len(chunk), per_call):
                ids = chunk[j:j + per_call]
                kw = {} if tchunk is None else {"t": tchunk[j:j + per_call]}
                out = engine.predict(ids, timeout=120, **kw)
                if out.shape[0] != len(ids) or not np.isfinite(out).all():
                    raise RuntimeError("malformed served rows")
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    t0 = time.perf_counter()
    tparts = [None] * CLIENTS if t is None else np.array_split(t, CLIENTS)
    with engine:
        threads = [threading.Thread(target=client, args=(c, tc))
                   for c, tc in zip(np.array_split(trace, CLIENTS), tparts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client errors: {errors[:3]}")
    return wall


def config_cases(cls, late_off: bool) -> list:
    """The tree's default config, then, with ``late_off``, late admission
    off where it is on by default."""
    late = cls.__dataclass_fields__.get("late_admission")
    return [("default", {})] + ([("late-off", {"late_admission": False})]
                                if late_off and late is not None and late.default is True
                                else [])


def idle_share(run, dev) -> dict:
    """``run()`` (returning its wall seconds) under torch.profiler: the
    card's idle share over the run, 1 - the union of its device events'
    intervals (kernels and copies) over the wall time, and those events."""
    if dev.type != "cuda":
        return {"idle_share": None, "device_events": 0, "profiled_wall_s": run()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"idle_share": 1.0 - busy / (wall * 1e6), "device_busy_s": busy / 1e6,
            "device_events": len(spans), "profiled_wall_s": wall}


def stats_record(st, wall, router=False) -> dict:
    lat = st.latency.snapshot()
    flushes = st.router_dispatches if router else st.dispatches
    seeds = st.routed_seeds if router else st.dispatched_seeds
    return dict(qps=st.requests / wall, p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
                wall_s=wall, dispatches=flushes, mean_flush_width=seeds / max(flushes, 1),
                late_admitted=getattr(st, "late_admitted", 0))


def run_slot(label, tree, order_ix, shared, args, dev, out):
    cs, pkg = load_tree(tree)
    if dev.type == "cuda":
        kernels = importlib.import_module("quiver_tpu_torch._kernels")
        log(f"slot {order_ix} ({label}, {tree}): kernels built in {kernels.build():.1f} s")
    if "indptr" not in shared:
        g = cs.build_graph(args.scale, args.seed)
        shared.update(indptr=g.indptr, indices=g.indices)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        shared["table"] = torch.randn((g.node_count, cs.DIM), generator=gen, device=dev)
    topo = pkg.CSRTopo(indptr=shared["indptr"], indices=shared["indices"])
    table = shared["table"]
    model, params = cs.make_model_params(args.seed)
    trace = cs.zipfian_trace(topo.node_count, args.requests, alpha=0.99, seed=args.seed + 1)
    base = {"tree": label, "slot": order_ix}

    for case, extra in config_cases(pkg.ServeConfig, args.late_off):
        for mif in IN_FLIGHT:
            for per_call in PER_CALLS:
                for rep in [*range(args.reps), "profiled"]:
                    sampler = pkg.GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed)
                    eng = pkg.ServeEngine(model, params, sampler, table,
                                          pkg.ServeConfig(max_batch=cs.BATCH, max_in_flight=mif,
                                                          **extra))
                    eng.warmup()
                    eng.reset_stats()
                    if rep == "profiled":
                        prof = idle_share(lambda: drive(eng, trace, per_call), dev)
                        rec = dict(stats_record(eng.stats, prof["profiled_wall_s"]), **prof)
                    else:
                        rec = stats_record(eng.stats, drive(eng, trace, per_call))
                    emit(out, dict(base, what="serve", case=case, max_in_flight=mif,
                                   per_call=per_call, rep=rep,
                                   padded_seeds=eng.stats.padded_seeds, **rec))
                    del eng, sampler
    gc.collect()
    torch.cuda.empty_cache()

    wl = importlib.import_module("quiver_tpu_torch.workloads")
    ts = np.random.default_rng(args.seed + 20).uniform(0.0, cs.TS_SPAN, topo.edge_count)
    tg = wl.TemporalTiledGraph(topo, ts.astype(np.float32), device=dev)
    ttrace = cs.temporal_trace(topo.node_count, args.requests, alpha=0.99,
                               seed=args.seed + 31, qps=cs.TEMPORAL_QPS, t0=0.0)
    for case, extra in config_cases(pkg.ServeConfig, args.late_off):
        for mif in IN_FLIGHT:
            for rep in [*range(args.reps), "profiled"]:
                sampler = pkg.GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed,
                                               dedup=False, max_deg=cs.MAX_DEG)
                sampler.bind_temporal(tg, recency=cs.RECENCY)
                eng = wl.TemporalServeEngine(model, params, sampler, table,
                                             pkg.ServeConfig(max_batch=cs.BATCH,
                                                             max_in_flight=mif, **extra),
                                             t_quantum=cs.T_QUANTUM)
                eng.warmup()
                eng.reset_stats()
                run = lambda: drive(eng, ttrace.requests, 8, t=ttrace.t_query)  # noqa: E731
                if rep == "profiled":
                    prof = idle_share(run, dev)
                    rec = dict(stats_record(eng.stats, prof["profiled_wall_s"]), **prof)
                else:
                    rec = stats_record(eng.stats, run())
                emit(out, dict(base, what="temporal", case=case, max_in_flight=mif,
                               per_call=8, rep=rep, padded_seeds=eng.stats.padded_seeds, **rec))
                del eng, sampler
    del tg
    gc.collect()
    torch.cuda.empty_cache()

    serve = importlib.import_module("quiver_tpu_torch.serve")
    for case, extra in config_cases(serve.DistServeConfig, args.late_off):
        for mif in IN_FLIGHT:
            for rep in range(args.fleet_reps):
                cfg = serve.DistServeConfig(hosts=FLEET_HOSTS, max_batch=cs.BATCH,
                                            feature_residency="closure", max_in_flight=mif,
                                            **extra)
                dist = serve.DistServeEngine.build(model, params, topo, table, cs.SIZES,
                                                   hosts=FLEET_HOSTS, config=cfg,
                                                   sampler_seed=args.seed, device=dev)
                if dist.exchange_mode != "collective":
                    raise RuntimeError("the fleet did not take the collective exchange")
                dist.warmup()
                dist.reset_stats()
                rec = stats_record(dist.stats, drive(dist, trace, 8), router=True)
                emit(out, dict(base, what="fleet", case=case, max_in_flight=mif, per_call=8,
                               rep=rep, padded_seeds=sum(e.stats.padded_seeds
                                                         for e in dist.engines.values()),
                               **rec))
                del dist
                gc.collect()  # the comm's answerers hold the engine in a cycle
                torch.cuda.empty_cache()


def log(msg):
    print(msg, flush=True)


def emit(out, rec):
    out.append(rec)
    log("ab: " + json.dumps(rec))


def summarize(out):
    groups = {}
    for r in out:
        key = (r["what"], r["tree"], r["case"], r["max_in_flight"], r["per_call"])
        groups.setdefault(key, []).append(r)
    for key, rs in sorted(groups.items()):
        what, tree, case, mif, per_call = key
        timed = [r for r in rs if r["rep"] != "profiled"]
        idle = [r["idle_share"] for r in rs if r.get("idle_share") is not None]
        med = {m: statistics.median(r[m] for r in timed)
               for m in ("qps", "p50_ms", "p99_ms", "dispatches", "mean_flush_width",
                         "padded_seeds", "late_admitted")}
        log("ab summary: " + json.dumps(dict(what=what, tree=tree, case=case,
                                             max_in_flight=mif, per_call=per_call,
                                             runs=len(timed), **med,
                                             qps_range=[min(r["qps"] for r in timed),
                                                        max(r["qps"] for r in timed)],
                                             idle_share=idle)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", required=True, help="comma-separated checkouts, e.g. OLD,NEW")
    ap.add_argument("--order", default="0,1,1,0", help="tree indices, one a slot")
    ap.add_argument("--scale", type=float, default=1.0, help="graph scale (1.0 = products)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fleet-reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a small dry run")
    ap.add_argument("--late-off", action="store_true",
                    help="also run each engine with late admission off")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    names = args.trees.split(",")
    trees = [Path(t).resolve() for t in names]
    labels = [f"{i}:{name}" for i, name in enumerate(names)]
    dev = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
           else torch.device("cpu"))
    shared, out = {}, []
    cwd = os.getcwd()
    for order_ix, i in enumerate(int(x) for x in args.order.split(",")):
        os.chdir(trees[i])  # a tree's kernel build and chip_smoke resolve paths from here
        try:
            run_slot(labels[i], trees[i], order_ix, shared, args, dev, out)
        finally:
            os.chdir(cwd)
    summarize(out)
    if dev.type != "cuda":
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"card: {card.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

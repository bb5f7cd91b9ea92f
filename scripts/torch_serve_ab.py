"""Time two checkouts of the port's serving against each other on one card:
`ServeEngine` (chip_smoke's serve phase) and `DistServeEngine` fleet leg (a).

    python scripts/torch_serve_ab.py --trees OLD,NEW [--order 0,1,1,0]

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
- ``fleet``: a fresh `DistServeEngine.build` (2 owners, closure residency,
  collective exchange) at max_in_flight 1 and 2, the whole trace from 4
  clients of 8 ids, ``--fleet-reps`` runs each;

each at the tree's default config and, where that turns late admission on,
with ``late_admission=False`` too. Every run prints an ``ab:`` JSON line (QPS,
p50/p99 from the engine's latency histogram, flushes, mean flush width,
padded lanes, late admissions); the last lines are ``ab summary:``, the
median of each (tree, case) over its runs in every slot, and the card's name
and power limit. Needs one CUDA card (``--device cpu`` is a small dry run).
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


def drive(engine, trace, per_call):
    """``trace`` from CLIENTS threads, ``per_call`` ids a predict call, under
    the engine's background flushers; returns the wall seconds."""
    errors = []

    def client(chunk):
        try:
            for j in range(0, len(chunk), per_call):
                out = engine.predict(chunk[j:j + per_call], timeout=120)
                if out.shape[0] != len(chunk[j:j + per_call]) or not np.isfinite(out).all():
                    raise RuntimeError("malformed served rows")
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    t0 = time.perf_counter()
    with engine:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in np.array_split(trace, CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client errors: {errors[:3]}")
    return wall


def config_cases(cls) -> list:
    """The tree's default config, then late admission off where it is on
    by default."""
    late = cls.__dataclass_fields__.get("late_admission")
    return [("default", {})] + ([("late-off", {"late_admission": False})]
                                if late is not None and late.default is True else [])


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

    for case, extra in config_cases(pkg.ServeConfig):
        for mif in IN_FLIGHT:
            for per_call in PER_CALLS:
                for rep in range(args.reps):
                    sampler = pkg.GraphSageSampler(topo, cs.SIZES, device=dev, seed=args.seed)
                    eng = pkg.ServeEngine(model, params, sampler, table,
                                          pkg.ServeConfig(max_batch=cs.BATCH, max_in_flight=mif,
                                                          **extra))
                    eng.warmup()
                    eng.reset_stats()
                    wall = drive(eng, trace, per_call)
                    st = eng.stats
                    lat = st.latency.snapshot()
                    emit(out, dict(base, what="serve", case=case, max_in_flight=mif,
                                   per_call=per_call, rep=rep, qps=st.requests / wall,
                                   p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"], wall_s=wall,
                                   dispatches=st.dispatches,
                                   mean_flush_width=st.dispatched_seeds / max(st.dispatches, 1),
                                   padded_seeds=st.padded_seeds,
                                   late_admitted=getattr(st, "late_admitted", 0)))
                    del eng, sampler
    gc.collect()
    torch.cuda.empty_cache()

    serve = importlib.import_module("quiver_tpu_torch.serve")
    for case, extra in config_cases(serve.DistServeConfig):
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
                wall = drive(dist, trace, 8)
                st = dist.stats
                lat = st.latency.snapshot()
                emit(out, dict(base, what="fleet", case=case, max_in_flight=mif, per_call=8,
                               rep=rep, qps=st.requests / wall, p50_ms=lat["p50_ms"],
                               p99_ms=lat["p99_ms"], wall_s=wall,
                               dispatches=st.router_dispatches,
                               mean_flush_width=st.routed_seeds / max(st.router_dispatches, 1),
                               padded_seeds=sum(e.stats.padded_seeds
                                                for e in dist.engines.values()),
                               late_admitted=getattr(st, "late_admitted", 0)))
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
        med = {m: statistics.median(r[m] for r in rs)
               for m in ("qps", "p50_ms", "p99_ms", "dispatches", "mean_flush_width",
                         "padded_seeds", "late_admitted")}
        log("ab summary: " + json.dumps(dict(what=what, tree=tree, case=case,
                                             max_in_flight=mif, per_call=per_call,
                                             runs=len(rs), **med,
                                             qps_range=[min(r["qps"] for r in rs),
                                                        max(r["qps"] for r in rs)])))


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

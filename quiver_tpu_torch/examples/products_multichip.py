"""Multi-device GraphSAGE training over a (dp, ici) or (host, dp, ici) mesh
of ranks — the port of ``examples/products_multichip.py``: per-data-group
seed shards, the feature table striped over the feature axes (and, with
``--topology sharded``, the graph row-sharded over them), the gradients
averaged over the data groups.

    python -m quiver_tpu_torch.examples.products_multichip [--device cpu]
        [--devices 4 --dp 2] [--hosts 2 [--hot-frac 0.2]]
        [--topology replicated|sharded] [--pipeline dedup|fused] [--bf16] [flags]

Without ``torch.distributed``, ``--devices N`` rank threads (the
``make_mesh(N, --dp, --hosts)`` mesh) run on ``--device``, the card unless
``cpu`` is asked for: the counterpart of the JAX example's
``QUIVER_VIRTUAL_DEVICES``. Under ``torchrun`` (an initialised process
group), each process is one rank on its own GPU; that path is unverified.
``--hot-frac`` heat-orders the id space and replicates that fraction of the
table per host (the hot/cold gather), with a cold budget calibrated over 4
probe batches.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import CSRTopo, GraphSAGE, GraphSageSampler
from .. import random as qrandom
from ..datasets import synthetic_powerlaw
from ..inference import sampled_eval, strict_float32
from ..parallel import (
    calibrate_cold_budget,
    local_meshes,
    make_mesh,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    mesh_axes,
    replicate,
    run_ranks,
    shard_topology_rows,
)
from ..parallel.train import hot_cold_stripes, stripe_rows
from ..utils import heat_reorder


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-per-dp", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--avg-deg", type=int, default=15)
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--sizes", default="15,10,5")
    ap.add_argument("--steps-per-epoch", type=int, default=0, help="0 = full epoch")
    ap.add_argument("--pipeline", default="dedup", choices=["dedup", "fused"])
    ap.add_argument("--hosts", type=int, default=0,
                    help="add a host axis: a (host, dp, ici) mesh")
    ap.add_argument("--topology", default="replicated", choices=["replicated", "sharded"],
                    help="sharded = row-shard the CSR over ici (no rank holds the full graph)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (parameters and logits stay float32)")
    ap.add_argument("--hot-frac", type=float, default=0.0,
                    help="replicate this heat-ordered fraction of the feature table per host; "
                         "only the cold remainder crosses hosts (needs --hosts >= 2)")
    ap.add_argument("--label-signal", type=float, default=1.5,
                    help="class-signal strength of the synthetic features; lower = harder task")
    ap.add_argument("--devices", type=int, default=4,
                    help="rank threads on --device (ignored under torch.distributed)")
    ap.add_argument("--dp", type=int, default=None, help="data-parallel groups (default: "
                    "make_mesh_shape's)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Train and evaluate; prints the JAX example's lines and returns
    ``{"loss", "val_acc", "test_acc", "seconds"}``."""
    args = parse_args(argv)
    if args.hot_frac and not args.hosts:
        raise ValueError("--hot-frac needs --hosts: hot/cold placement needs a multi-host mesh")
    strict_float32()
    hosts = args.hosts or None
    if dist.is_initialized():
        meshes = [make_mesh(dp=args.dp, hosts=hosts, device=args.device)]
    else:
        meshes = local_meshes(args.devices, dp=args.dp, device=args.device, hosts=hosts)
    dev = meshes[0].device

    rng = np.random.default_rng(0)
    n = args.nodes
    edge_index, feat, labels, train_idx = synthetic_powerlaw(
        n, n * args.avg_deg, dim=args.dim, classes=args.classes, train_frac=0.3, seed=0,
        label_signal=args.label_signal)
    rest = np.setdiff1d(np.arange(n), train_idx)
    val_idx, test_idx = rest[: n // 20], rest[n // 20: n // 10]
    if args.hot_frac:
        # heat-order the id space so the hot prefix is the replicated tier
        edge_index, feat, labels, (train_idx, val_idx, test_idx), _, _ = heat_reorder(
            edge_index, n, feat, labels, (train_idx, val_idx, test_idx))
    topo = CSRTopo(edge_index=edge_index)
    m0 = meshes[0]
    _, feat_axes, dp = mesh_axes(m0)
    print(f"mesh: {m0.shape} ({m0.size} ranks), {m0.hosts or 1} hosts, {dp} data-parallel "
          f"groups", flush=True)

    sizes = tuple(int(s) for s in args.sizes.split(","))
    model = GraphSAGE(args.dim, args.hidden, args.classes, num_layers=len(sizes), dropout=0.5,
                      dtype=torch.bfloat16 if args.bf16 else None)
    model.reset_parameters(torch.Generator().manual_seed(1))
    hot_rows = int(n * args.hot_frac) if args.hot_frac else None
    cold_budget = None
    if hot_rows:
        # probe-calibrated cold-lane fraction (margin like the sampler caps)
        probe_sampler = GraphSageSampler(topo, sizes=sizes, device=dev, seed=7)
        probes = [rng.choice(train_idx, min(64, len(train_idx))) for _ in range(4)]
        cold_budget = calibrate_cold_budget(probe_sampler, probes, hot_rows)
        print(f"hot tier: {hot_rows} rows, calibrated cold budget {cold_budget:.2f}",
              flush=True)
    batch_global = args.batch_per_dp * dp
    steps = args.steps_per_epoch or max(len(train_idx) // batch_global, 1)
    batches = [[rng.choice(train_idx, batch_global).astype(np.int32) for _ in range(steps)]
               for _ in range(args.epochs)]
    # one stripe tensor (pair) per feature index: the ranks of a dp group only read it
    feat_dev = torch.from_numpy(feat).to(dev)
    stripes = {}
    for m in meshes:
        p = m.index(feat_axes)
        if p not in stripes:
            stripes[p] = (hot_cold_stripes(feat_dev, hot_rows, m.hosts, m.ici, m.host_idx,
                                           m.ici_idx) if hot_rows
                          else stripe_rows(feat_dev, m.axis_size(feat_axes), p))
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(dev)
    if args.topology == "replicated":
        graph = tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in (topo.indptr, topo.indices))

    def rank(mesh):
        replica = replicate(mesh, model)
        opt = torch.optim.Adam(replica.parameters(), lr=1e-3)
        kw = dict(pipeline=args.pipeline, hot_rows=hot_rows, cold_budget=cold_budget)
        if args.topology == "sharded":
            step = make_sharded_topo_train_step(mesh, replica, opt, sizes, **kw)
            graph_args = (shard_topology_rows(mesh, topo),)
        else:
            step = make_sharded_train_step(mesh, replica, opt, sizes, **kw)
            graph_args = graph
        block = stripes[mesh.index(feat_axes)]
        loss = overflow = None
        total_overflow = 0
        for epoch, epoch_batches in enumerate(batches):
            t0 = time.time()
            for i, seeds in enumerate(epoch_batches):
                out = step(qrandom.key(epoch * 100000 + i), *graph_args, block, labels_dev,
                           torch.from_numpy(seeds))
                loss, overflow = out if hot_rows else (out, None)
                if overflow is not None:
                    total_overflow += int(overflow)
            loss = float(loss)  # waits for the epoch's last step
            dt = time.time() - t0
            if mesh.rank == 0:
                ov = f"  cold_overflow={int(overflow)}" if overflow is not None else ""
                print(f"epoch {epoch}: {dt:.2f}s  loss={loss:.4f}  "
                      f"{len(epoch_batches) * batch_global / dt:.0f} seeds/s{ov}", flush=True)
        return replica, loss, total_overflow

    t0 = time.time()
    replica, loss, total_overflow = run_ranks(rank, meshes)[0]
    out: Dict[str, float] = {"loss": loss, "seconds": time.time() - t0}
    if hot_rows:
        out.update(cold_budget=cold_budget, cold_overflow=total_overflow)
    replica.eval()
    eval_sampler = GraphSageSampler(topo, sizes=sizes, device=dev, seed=123)
    for name, idx in (("val", val_idx), ("test", test_idx)):
        if len(idx):
            acc = sampled_eval(replica, eval_sampler, feat_dev, labels, idx,
                               batch_size=min(1024, len(idx)))
            out[f"{name}_acc"] = acc
            print(f"{name} acc: {acc:.4f} ({len(idx)} nodes)", flush=True)
    return out


if __name__ == "__main__":
    main()

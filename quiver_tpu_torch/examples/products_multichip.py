"""Multi-device GraphSAGE training over a (dp, ici) mesh of ranks — the port
of ``examples/products_multichip.py``: per-dp-group seed shards, the
feature table striped over ici (and, with ``--topology sharded``, the graph
row-sharded over it), the gradients averaged over dp.

    python -m quiver_tpu_torch.examples.products_multichip [--device cpu]
        [--devices 4 --dp 2] [--topology replicated|sharded]
        [--pipeline dedup|fused] [--bf16] [flags]

Without ``torch.distributed``, ``--devices N`` rank threads (a
``make_mesh_shape(N, --dp)`` mesh) run on ``--device``, the card unless
``cpu`` is asked for: the counterpart of the JAX example's
``QUIVER_VIRTUAL_DEVICES``. Under ``torchrun`` (an initialised process
group), each process is one rank on its own GPU; that path is unverified.
Not ported yet (ROADMAP A16, the host axis): ``--hosts`` and ``--hot-frac``.
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
    local_meshes,
    make_mesh,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    replicate,
    run_ranks,
    shard_topology_rows,
)
from ..parallel.collectives import HOST_AXIS_TODO
from ..parallel.train import stripe_rows


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
    ap.add_argument("--hosts", type=int, default=0, help="not ported yet (the host axis)")
    ap.add_argument("--topology", default="replicated", choices=["replicated", "sharded"],
                    help="sharded = row-shard the CSR over ici (no rank holds the full graph)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (parameters and logits stay float32)")
    ap.add_argument("--hot-frac", type=float, default=0.0, help="not ported yet (the host axis)")
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
    if args.hosts:
        raise NotImplementedError(f"--hosts: {HOST_AXIS_TODO}")
    if args.hot_frac:
        raise NotImplementedError(f"--hot-frac: {HOST_AXIS_TODO}")
    strict_float32()
    if dist.is_initialized():
        meshes = [make_mesh(dp=args.dp, device=args.device)]
    else:
        meshes = local_meshes(args.devices, dp=args.dp, device=args.device)
    dev = meshes[0].device

    rng = np.random.default_rng(0)
    n = args.nodes
    edge_index, feat, labels, train_idx = synthetic_powerlaw(
        n, n * args.avg_deg, dim=args.dim, classes=args.classes, train_frac=0.3, seed=0,
        label_signal=args.label_signal)
    rest = np.setdiff1d(np.arange(n), train_idx)
    val_idx, test_idx = rest[: n // 20], rest[n // 20: n // 10]
    topo = CSRTopo(edge_index=edge_index)
    m0 = meshes[0]
    dp = m0.dp
    print(f"mesh: {m0.shape} ({m0.size} ranks), {dp} data-parallel groups", flush=True)

    sizes = tuple(int(s) for s in args.sizes.split(","))
    model = GraphSAGE(args.dim, args.hidden, args.classes, num_layers=len(sizes), dropout=0.5,
                      dtype=torch.bfloat16 if args.bf16 else None)
    model.reset_parameters(torch.Generator().manual_seed(1))
    batch_global = args.batch_per_dp * dp
    steps = args.steps_per_epoch or max(len(train_idx) // batch_global, 1)
    batches = [[rng.choice(train_idx, batch_global).astype(np.int32) for _ in range(steps)]
               for _ in range(args.epochs)]
    # one stripe tensor per ici index: the ranks of a dp group only read it
    feat_dev = torch.from_numpy(feat).to(dev)
    stripes = {m.ici_idx: stripe_rows(feat_dev, m.ici, m.ici_idx) for m in meshes}
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(dev)
    if args.topology == "replicated":
        graph = tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in (topo.indptr, topo.indices))

    def rank(mesh):
        replica = replicate(mesh, model)
        opt = torch.optim.Adam(replica.parameters(), lr=1e-3)
        if args.topology == "sharded":
            step = make_sharded_topo_train_step(mesh, replica, opt, sizes,
                                                pipeline=args.pipeline)
            graph_args = (shard_topology_rows(mesh, topo),)
        else:
            step = make_sharded_train_step(mesh, replica, opt, sizes, pipeline=args.pipeline)
            graph_args = graph
        block = stripes[mesh.ici_idx]
        loss = None
        for epoch, epoch_batches in enumerate(batches):
            t0 = time.time()
            for i, seeds in enumerate(epoch_batches):
                loss = step(qrandom.key(epoch * 100000 + i), *graph_args, block, labels_dev,
                            torch.from_numpy(seeds))
            loss = float(loss)  # waits for the epoch's last step
            dt = time.time() - t0
            if mesh.rank == 0:
                print(f"epoch {epoch}: {dt:.2f}s  loss={loss:.4f}  "
                      f"{len(epoch_batches) * batch_global / dt:.0f} seeds/s", flush=True)
        return replica, loss

    t0 = time.time()
    replica, loss = run_ranks(rank, meshes)[0]
    out: Dict[str, float] = {"loss": loss, "seconds": time.time() - t0}
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

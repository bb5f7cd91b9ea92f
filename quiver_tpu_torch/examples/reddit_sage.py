"""Single-GPU GraphSAGE, GAT or GCN training — the port of
``examples/reddit_sage.py``: sample -> feature lookup -> forward/backward
-> Adam, then sampled validation and test accuracy and, for GraphSAGE, the
layer-wise full-neighbor test accuracy.

    python -m quiver_tpu_torch.examples.reddit_sage [--device cpu] [flags]

With --dataset pointing at an .npz holding {edge_index [2,E], features
[N,D], labels [N], train_idx} (and optional valid_idx/test_idx) it trains
that graph; without it, a synthetic power-law community graph stands in.
``--model gat`` trains a GAT with 4 heads of ``--hidden``, ``--model gcn``
a GCN with norm "right"; ``--bf16`` computes in bfloat16 (float32
parameters and logits). Runs on the card unless ``--device cpu`` asks for
the plain torch versions; on the card each training step is one captured
CUDA graph (`train_programs.make_sample_train_step`, Adam with
``capturable=True``). ``--mode HOST`` (or ``CPU``, or the reference's
``UVA``) keeps the graph in host memory and samples it with the native host
engine; the step from the gathered rows on is then the captured graph.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import GAT, GCN, CSRTopo, Feature, GraphSAGE, GraphSageSampler
from ..inference import full_inference_accuracy, sampled_eval, strict_float32
from ..trace import seps
from ..train_programs import make_sample_train_step
from ..utils import resolve_device


def synthetic_reddit(n=50_000, dim=64, ncls=16, avg_deg=25, seed=0):
    """Power-law community graph with train, validation and test splits
    (the JAX example's arrays, draw for draw): ``(edge_index, features,
    labels, train_idx, val_idx, test_idx)``."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, ncls, n)
    deg = np.minimum((rng.pareto(1.5, n) + 1).astype(np.int64) * 3, 500)
    deg = np.maximum(deg * avg_deg // max(int(deg.mean()), 1), 2)
    src = np.repeat(np.arange(n), deg)
    # 90% intra-community edges: a random member of src's community
    order = np.argsort(comm, kind="stable")
    start = np.searchsorted(comm[order], np.arange(ncls))
    size = np.append(start[1:], n) - start
    c = comm[src]
    intra_pick = order[start[c] + rng.integers(0, size[c])]
    dst = np.where(rng.random(src.shape[0]) < 0.9, intra_pick, rng.integers(0, n, src.shape[0]))
    feat = np.eye(ncls, dtype=np.float32)[comm][:, : min(ncls, dim)]
    if dim > ncls:
        feat = np.concatenate(
            [feat, rng.standard_normal((n, dim - ncls)).astype(np.float32) * 0.5], axis=1)
    labels = comm.astype(np.int32)
    perm = rng.permutation(n)
    train_idx = perm[: n // 10]
    val_idx = perm[n // 10: n // 10 + max(n // 20, 1)]
    test_idx = perm[n // 10 + max(n // 20, 1): n // 10 + 2 * max(n // 20, 1)]
    return np.stack([src, dst]), feat, labels, train_idx, val_idx, test_idx


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default=None, help=".npz with edge_index/features/labels/train_idx")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--sizes", default="25,10")
    ap.add_argument("--cache", default="1G", help="device_cache_size")
    ap.add_argument("--mode", default="TPU", choices=["TPU", "HOST", "CPU", "GPU", "UVA"])
    ap.add_argument("--nodes", type=int, default=50_000, help="synthetic graph size")
    ap.add_argument("--dim", type=int, default=64, help="synthetic feature dim")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--model", default="sage", choices=["sage", "gat", "gcn"])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Train and evaluate; prints the JAX example's lines and returns
    ``{"loss", "val_acc", "test_acc", "test_acc_full"}`` (those it
    computed)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    strict_float32()

    if args.dataset:
        from ..datasets import load_npz

        data = load_npz(args.dataset)
        edge_index, feat, labels, train_idx = (
            data["edge_index"], data["features"], data["labels"], data["train_idx"])
        val_idx = data.get("valid_idx", data.get("val_idx"))
        test_idx = data.get("test_idx")
    else:
        edge_index, feat, labels, train_idx, val_idx, test_idx = synthetic_reddit(
            n=args.nodes, dim=args.dim)
    sizes = [int(s) for s in args.sizes.split(",")]
    ncls = int(labels.max()) + 1
    labels = np.asarray(labels)

    csr_topo = CSRTopo(edge_index=edge_index)
    sampler = GraphSageSampler(csr_topo, sizes=sizes, device=dev, mode=args.mode)
    feature = Feature(rank=0, device_list=[0], device_cache_size=args.cache, csr_topo=csr_topo,
                      device=dev)
    feature.from_cpu_tensor(feat)

    dtype = torch.bfloat16 if args.bf16 else None
    if args.model == "gat":
        model = GAT(feat.shape[1], args.hidden, ncls, heads=4, num_layers=len(sizes),
                    dropout=0.5, dtype=dtype)
    elif args.model == "gcn":
        model = GCN(feat.shape[1], args.hidden, ncls, num_layers=len(sizes), dropout=0.5,
                    dtype=dtype)
    else:
        model = GraphSAGE(feat.shape[1], args.hidden, ncls, num_layers=len(sizes), dropout=0.5,
                          dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    # on the card the step is one captured CUDA graph (its optimizer state
    # lives there); a host-mode sampler, a sampler that grows its caps or a
    # feature with a disk tier keeps the sample and gather outside the graph
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, capturable=dev.type == "cuda")
    train_step = make_sample_train_step(sampler, feature, labels, model, opt)
    dropout_gen = torch.Generator(device=dev).manual_seed(1)

    rng = np.random.default_rng(0)
    # small graphs can have fewer train nodes than the batch size; shrink the
    # batch so every epoch runs at least one step
    batch_size = min(args.batch_size, len(train_idx))
    out: Dict[str, float] = {}
    for epoch in range(args.epochs):
        perm = rng.permutation(train_idx)
        t0 = time.time()
        edges = torch.zeros((), dtype=torch.int64, device=dev)
        n_batches = 0
        model.train()
        for lo in range(0, len(perm) - batch_size + 1, batch_size):
            loss, sampled = train_step(perm[lo: lo + batch_size], dropout_gen)
            edges += sampled
            n_batches += 1
        out["loss"] = float(loss.detach())  # waits for the epoch's last step
        dt = time.time() - t0
        print(f"epoch {epoch}: {dt:.2f}s  loss={out['loss']:.4f}  "
              f"SEPS={seps(int(edges), dt) / 1e6:.2f}M  batches={n_batches}", flush=True)

    model.eval()
    for name, idx in (("val", val_idx), ("test", test_idx)):
        if idx is not None and len(idx):
            acc = sampled_eval(model, sampler, feature, labels, idx, batch_size)
            out[f"{name}_acc"] = acc
            print(f"{name} acc: {acc:.4f} ({len(idx)} nodes)", flush=True)
    if args.model == "sage" and test_idx is not None and len(test_idx):
        # exact layer-wise full-neighbor inference (float32, as the JAX package's)
        facc = full_inference_accuracy(model, csr_topo, feat, labels, test_idx)
        out["test_acc_full"] = facc
        print(f"test acc (full inference): {facc:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()

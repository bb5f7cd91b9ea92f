#!/usr/bin/env python3
"""``chip_smoke.py``'s host legs (d), (e) and (f) alone, taken from the
``chip_smoke.py`` of a given checkout, so that two checkouts' legs can run
in turns in one call on one card.

    python3 scripts/torch_host_legs.py [--root DIR] [--seed 0]

Needs one CUDA card. Imports ``chip_smoke`` and ``quiver_tpu_torch`` from
``--root`` (default: this checkout), builds the products-shaped graph and
its [N, 100] table as ``chip_smoke.py`` does, leg (a)'s caps as its mc
setup does (``calibrate_caps`` over 8 probe batches), and a heat order
from ``sample_prob`` (K11) over the train split, hottest first, ties by id
(in place of the tiers phase's ``heat_reorder``, which only the hot/cold
leg reads); then runs ``host_setup`` and ``host_phase``: three legs on 4
rank threads (host 2 x dp 1 x ici 2), each a ``host train:`` line with its
median step and its collective milliseconds a step by wrapper.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from quiver_tpu_torch import GraphSageSampler

    if not torch.cuda.is_available():
        print("torch_host_legs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    seed = args.seed
    cs.log(f"root: {root}; build: {cs._kernels.build():.1f} s; card: {cs.card_line()}")
    cs.strict_float32()
    topo = cs.build_graph(1.0, seed)
    n = topo.node_count
    table = torch.randn((n, cs.DIM), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    train_idx = np.random.default_rng(seed + 3).choice(n, cs.PRODUCTS_TRAIN, replace=False)
    order = np.random.default_rng(seed + 80).permutation(train_idx)
    probes = order[-cs.MC_CAP_PROBES * cs.TRAIN_BATCH:].reshape(cs.MC_CAP_PROBES, cs.TRAIN_BATCH)
    caps = GraphSageSampler(topo, cs.SIZES, device=dev, seed=seed + 81).calibrate_caps(
        probes, margin=cs.CAP_MARGIN, granule=cs.CAP_GRANULE)
    heat = GraphSageSampler(topo, cs.SIZES, device=dev, seed=seed).sample_prob(train_idx, n)
    heat_order = np.argsort(-heat.cpu().numpy(), kind="stable")
    host = cs.host_setup(topo, table, train_idx, heat_order, caps, seed)
    cs.host_phase(topo, table, cs.train_labels(n, dev), host, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())

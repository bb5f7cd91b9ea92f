"""One rank's gather and train step on the community graph, shared by
tests/test_torch_parallel.py's rank threads and its four-process gloo world.
Imports torch, numpy and the port only, so each process starts quickly."""

import numpy as np
import torch

from __graft_entry__ import _community_graph
from quiver_tpu_torch import CSRTopo, GraphSAGE
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.parallel import (
    make_sharded_train_step,
    mesh_axes,
    shard_feature_rows,
    sharded_gather,
)

SIZES, LR, HIDDEN = (4, 4), 1e-2, 16


def rank_work(m):
    """One sharded gather over the mesh's feature axes (ids -1 to 200, past
    both ends) and one replicated-graph step on rank ``m`` (the grouped
    gathers on a host mesh): ``{"rows", "params"}``."""
    edge_index, feat, labels, _ = _community_graph()
    tt = CSRTopo(edge_index=edge_index)
    rows = sharded_gather(shard_feature_rows(m, feat), torch.arange(-1, 201, dtype=torch.int32), m,
                          mesh_axes(m)[1])
    model = GraphSAGE(feat.shape[1], HIDDEN, 4, num_layers=2, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_sharded_train_step(m, model, opt, SIZES)
    graph = tuple(torch.from_numpy(np.asarray(a).astype(np.int32)) for a in (tt.indptr, tt.indices))
    step(qrandom.key(4), *graph, shard_feature_rows(m, feat), torch.from_numpy(labels),
         torch.arange(16, dtype=torch.int32) * 7)
    return {"rows": rows, "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}

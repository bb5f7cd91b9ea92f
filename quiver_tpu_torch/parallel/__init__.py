"""Data-parallel training over a (dp, ici) or (host, dp, ici) mesh of
ranks — the port of ``quiver_tpu/parallel``: the ``Mesh`` and its
constructors (`local_meshes` for rank threads in one process, `make_mesh`
over ``torch.distributed``), `run_ranks`, the collectives (`allreduce_sum`,
`allgather`, `all_to_all`, `reduce_scatter_sum`, `allreduce_max`), the
sharded row gather (K13a), the grouped and all-to-all gathers (K13c), the
replicated-hot/cold gather (K13d), the owner-masked sharded sample (K13b)
and its grouped form (K13e: K13b at the host-gathered width, then K13c's
int32 unpack), and both train steps.

Not ported yet: ``parallel/scaling.py`` (ROADMAP A17)."""

from .collectives import (
    all_to_all,
    allgather,
    allreduce_max,
    allreduce_sum,
    pad_to_multiple,
    reduce_scatter_sum,
    replicated_psum,
    sharded_gather,
    sharded_gather_a2a,
    sharded_gather_grouped,
    sharded_gather_hot_cold,
)
from .topology import (
    ShardedTopology,
    TiledShardedTopology,
    build_tiled_topology_shards,
    build_topology_shards,
    gather_comm_bytes,
    partition_rows_by_edges,
    resolve_topology_layout,
    sampling_comm_bytes,
    shard_topology_rows,
    sharded_sample_layer,
    sharded_sample_layer_grouped,
    tiled_sharded_sample_layer,
    tiled_sharded_sample_layer_grouped,
)
from .train import (
    Mesh,
    calibrate_cold_budget,
    local_meshes,
    make_mesh,
    make_mesh_shape,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    mesh_axes,
    replicate,
    run_ranks,
    shard_feature_hot_cold,
    shard_feature_rows,
)

__all__ = [
    "Mesh",
    "all_to_all",
    "allgather",
    "allreduce_max",
    "ShardedTopology",
    "TiledShardedTopology",
    "allreduce_sum",
    "build_tiled_topology_shards",
    "build_topology_shards",
    "calibrate_cold_budget",
    "gather_comm_bytes",
    "local_meshes",
    "make_mesh",
    "make_mesh_shape",
    "make_sharded_topo_train_step",
    "make_sharded_train_step",
    "mesh_axes",
    "pad_to_multiple",
    "partition_rows_by_edges",
    "reduce_scatter_sum",
    "replicate",
    "replicated_psum",
    "resolve_topology_layout",
    "run_ranks",
    "sampling_comm_bytes",
    "shard_feature_hot_cold",
    "shard_feature_rows",
    "shard_topology_rows",
    "sharded_gather",
    "sharded_gather_a2a",
    "sharded_gather_grouped",
    "sharded_gather_hot_cold",
    "sharded_sample_layer",
    "sharded_sample_layer_grouped",
    "tiled_sharded_sample_layer",
    "tiled_sharded_sample_layer_grouped",
]

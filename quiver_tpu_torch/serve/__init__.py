"""Online serving on the port: `ServeEngine` and its parts, and the routed
fleet (`DistServeEngine`)."""

from .cache import EmbeddingCache
from .dist import (
    ClosureFeature,
    DistServeConfig,
    DistServeEngine,
    DistServeStats,
    LoopbackComm,
    closure_masks,
    contiguous_partition,
    replay_fleet_oracle,
    replay_shard_oracle,
    shard_from_mask,
    shard_topology_by_owner,
    shard_topology_for_seeds,
)
from .engine import (
    ResultBatch,
    ServeConfig,
    ServeEngine,
    ServeResult,
    ServeStats,
    default_buckets,
)
from .trace_gen import (
    DeltaTrace,
    LPTrace,
    TemporalTrace,
    lp_trace,
    delta_interleaved_trace,
    poisson_arrivals,
    temporal_trace,
    zipfian_trace,
)

__all__ = [
    "ClosureFeature", "DistServeConfig", "DistServeEngine", "DistServeStats", "LoopbackComm",
    "closure_masks", "contiguous_partition", "replay_fleet_oracle", "replay_shard_oracle",
    "shard_from_mask", "shard_topology_by_owner", "shard_topology_for_seeds",
    "DeltaTrace", "EmbeddingCache", "LPTrace", "ResultBatch", "ServeConfig", "ServeEngine", "ServeResult",
    "ServeStats", "TemporalTrace", "default_buckets", "delta_interleaved_trace", "lp_trace", "poisson_arrivals",
    "temporal_trace", "zipfian_trace",
]

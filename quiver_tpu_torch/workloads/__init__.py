"""Temporal and link-prediction serving on the port — the port of
``quiver_tpu/workloads`` (single host).

- **Temporal neighbor sampling** (feed ranking): per-edge timestamps ride
  the tile map's payload lanes (`TemporalTiledGraph`); a temporal draw
  (`temporal_sample_layer`, kernel K8) masks edges with ``ts > t`` out of
  the weighted sampler's Gumbel top-k, recency-biased by ``exp(recency *
  ts)``. `TemporalServeEngine` serves it with ``(node, t_bucket)`` cache
  and coalescing keys and the query times as an argument of the fused step.
- **Link-prediction serving** (retrieval): ``submit_pair(u, v, t=)`` looks
  both endpoints up through the engine and scores them with a `PairHead`.

A temporal sampler may draw from a streaming graph with timestamps
(`quiver_tpu_torch.stream.StreamingTiledGraph(edge_ts=)`), which the
engine's commits change while it serves. Waiting for later slices: the
routed temporal engine and its fleet oracle (``serve/dist.py``, which
ROADMAP A16 leaves after its single-host training half: it comes with the
host axis, ``comm.py`` and ``DistFeature``).
"""

from .linkpred import LinkPredictor, PairHead, PairResult
from .serving import TemporalServeEngine, quantize_t, quantize_t_many, replay_temporal_log
from .temporal import (
    TemporalTiledGraph,
    host_masked_oracle,
    temporal_sample_dense,
    temporal_sample_layer,
)

__all__ = [
    "LinkPredictor", "PairHead", "PairResult", "TemporalServeEngine", "TemporalTiledGraph",
    "host_masked_oracle", "quantize_t", "quantize_t_many", "replay_temporal_log",
    "temporal_sample_dense", "temporal_sample_layer",
]

from .mixed_sampler import MixedGraphSageSampler, SampleJob, TrainSampleJob
from .sage_sampler import (
    Adj,
    DenseAdj,
    DenseSample,
    GraphSageSampler,
    caps_from_counts,
    dense_to_pyg,
    host_dense_sample,
    probe_hop_counts,
    sample_and_gather_dedup,
    sample_and_gather_fused,
    sample_dense_fused,
    sample_dense_pure,
)

__all__ = [
    "Adj",
    "DenseAdj",
    "DenseSample",
    "GraphSageSampler",
    "MixedGraphSageSampler",
    "SampleJob",
    "TrainSampleJob",
    "caps_from_counts",
    "dense_to_pyg",
    "host_dense_sample",
    "probe_hop_counts",
    "sample_and_gather_dedup",
    "sample_and_gather_fused",
    "sample_dense_fused",
    "sample_dense_pure",
]

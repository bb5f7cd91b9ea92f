from .sage_sampler import (
    Adj,
    DenseAdj,
    DenseSample,
    GraphSageSampler,
    caps_from_counts,
    dense_to_pyg,
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
    "caps_from_counts",
    "dense_to_pyg",
    "probe_hop_counts",
    "sample_and_gather_dedup",
    "sample_and_gather_fused",
    "sample_dense_fused",
    "sample_dense_pure",
]

from .sage_sampler import DenseAdj, DenseSample, GraphSageSampler

__all__ = ["DenseAdj", "DenseSample", "GraphSageSampler"]

"""Online serving on the port: `ServeEngine` and its parts."""

from .cache import EmbeddingCache
from .engine import (
    ResultBatch,
    ServeConfig,
    ServeEngine,
    ServeResult,
    ServeStats,
    default_buckets,
)
from .trace_gen import (
    LPTrace,
    TemporalTrace,
    lp_trace,
    poisson_arrivals,
    temporal_trace,
    zipfian_trace,
)

__all__ = [
    "EmbeddingCache", "LPTrace", "ResultBatch", "ServeConfig", "ServeEngine", "ServeResult",
    "ServeStats", "TemporalTrace", "default_buckets", "lp_trace", "poisson_arrivals",
    "temporal_trace", "zipfian_trace",
]

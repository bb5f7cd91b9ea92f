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
from .trace_gen import zipfian_trace

__all__ = [
    "EmbeddingCache", "ResultBatch", "ServeConfig", "ServeEngine", "ServeResult",
    "ServeStats", "default_buckets", "zipfian_trace",
]

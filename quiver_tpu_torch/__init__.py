"""quiver_tpu_torch — the PyTorch/CUDA port of quiver_tpu on one card:
GraphSAGE serving (sample -> dedup -> gather -> forward -> ServeEngine),
training of GraphSAGE, GCN and GAT in float32 or bfloat16 compute (tiered
Feature -> sample-and-gather -> forward/backward -> Adam -> eval), the
staged tiered train pipeline (TrainPipeline -> TieredFeaturePipeline ->
tiered_lookup) over float32,
int8 and bf16 feature tables (`quant`), out-of-core training
(GraphSageSampler.sample_prob -> utils.heat_reorder / `partition` -> a disk
tier, static or adaptive (`tiers`) -> the staged pipeline with
flush-ahead prefetch), weighted sampling (GraphSageSampler(weighted=True))
and temporal feed-ranking and link-prediction serving (`workloads`),
data-parallel training on a mesh of ranks (`parallel`), routed fleet
serving over the serve exchange (`serve.DistServeEngine` over `comm`) and
serving over a graph that changes while it serves (`stream`, `lifecycle`:
commits, deletions, expiry, compaction and reserve growth through the
serve engine's ``update_graph``), and processes: features and samplers
handed to spawned children by CUDA IPC and shared memory
(`multiprocessing`) and `comm.TorchComm`'s exchanges with one process a
host. On the card the serve step and every
single-card training step run as captured CUDA graphs (`inference.
BucketPrograms`, `train_programs`).

Imports torch and numpy only, never jax or quiver_tpu. Entry points run on
CUDA unless ``device="cpu"`` is passed, where every kernel's plain torch
version runs instead. The kernels (``csrc/*.cu``) are built for sm_90a at
first use (`quiver_tpu_torch._kernels.build`).
"""

from .checkpoint import CheckpointManager
from .convert import (gat_params_from_flax, gcn_params_from_flax, pair_head_params_from_jax,
                      sage_params_from_flax)
from .feature import Feature
from .models import GAT, GCN, GraphSAGE
from .pipeline import TieredFeaturePipeline, TrainPipeline
from .pyg import GraphSageSampler
from .quant import QuantizedFeature
from .serve import ServeConfig, ServeEngine
from .utils import CSRTopo

__all__ = [
    "CSRTopo", "CheckpointManager", "Feature", "GAT", "GCN", "GraphSAGE", "GraphSageSampler",
    "QuantizedFeature", "ServeConfig", "ServeEngine", "TieredFeaturePipeline", "TrainPipeline",
    "gat_params_from_flax", "gcn_params_from_flax", "pair_head_params_from_jax",
    "sage_params_from_flax",
]

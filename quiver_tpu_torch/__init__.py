"""quiver_tpu_torch — the PyTorch/CUDA port of quiver_tpu, slice 1:
GraphSAGE serving (sample -> dedup -> gather -> forward -> ServeEngine).

Imports torch and numpy only, never jax or quiver_tpu. Entry points run on
CUDA unless ``device="cpu"`` is passed, where every kernel's plain torch
version runs instead. The kernels (``csrc/*.cu``) are built for sm_90a at
first use (`quiver_tpu_torch._kernels.build`).
"""

from .convert import sage_params_from_flax
from .models import GraphSAGE
from .pyg import GraphSageSampler
from .serve import ServeConfig, ServeEngine
from .utils import CSRTopo

__all__ = [
    "CSRTopo", "GraphSAGE", "GraphSageSampler", "ServeConfig", "ServeEngine",
    "sage_params_from_flax",
]

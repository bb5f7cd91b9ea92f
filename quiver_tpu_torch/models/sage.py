"""GraphSAGE over dense padded hops — the port of
``quiver_tpu/models/sage.py`` (``masked_mean_aggregate``, ``SAGEConv``,
``GraphSAGE``) as ``nn.Module``s.

Semantics match PyG ``SAGEConv(mean)``: ``out = lin_l(mean_j x_j) +
lin_r(x_i)``; relu and dropout between layers, no head. The neighbor mean
is the kernel of ``csrc/aggregate.cu`` on CUDA tensors (forward only in
this slice) and `masked_mean_aggregate_plain` on CPU tensors. The linear
layers stay ``nn.Linear`` (``torch.nn.functional.linear``), as the JAX package leaves them
to XLA. Float32 products run in full float32: the serve and eval entry
points (`quiver_tpu_torch.inference`) turn TF32 off before the model runs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import _kernels
from ..pyg.sage_sampler import DenseAdj


def masked_mean_aggregate_plain(x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
    gathered = adj.gather_src(x_src)                   # [W_dst, k, D]
    m = adj.mask[..., None].to(x_src.dtype)
    s = (gathered * m).sum(dim=1)
    cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1).to(x_src.dtype)
    return s / cnt


def masked_mean_aggregate(x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
    """Mean of the valid sampled neighbors per target: ``[W_dst, D]``
    from ``x_src [W_src, D]`` (cols or structural layout)."""
    w, k = adj.mask.shape
    if x_src.dim() != 2:
        raise ValueError(f"x_src must be [W_src, D]; got {tuple(x_src.shape)}")
    if adj.cols is None and x_src.shape[0] < w * (1 + k):
        raise ValueError(f"structural layout needs {w * (1 + k)} source rows; "
                         f"got {x_src.shape[0]}")
    if not x_src.is_cuda:
        return masked_mean_aggregate_plain(x_src, adj)
    if x_src.dtype != torch.float32 or adj.mask.dtype != torch.bool:
        raise TypeError("the mean kernel takes float32 x and a bool mask")
    if adj.cols is not None and adj.cols.dtype != torch.int32:
        raise TypeError(f"the mean kernel takes int32 cols; got {adj.cols.dtype}")
    if k > _kernels.KMAX:
        raise ValueError(f"the mean kernel takes k <= {_kernels.KMAX}; got {k}")
    x_src = x_src.contiguous()
    mask = adj.mask.contiguous()
    cols = adj.cols.contiguous() if adj.cols is not None else None
    D = x_src.shape[1]
    out = torch.empty((w, D), dtype=x_src.dtype, device=x_src.device)
    if w == 0 or D == 0:
        return out
    _kernels.launch(
        "masked_mean", x_src.data_ptr(), x_src.shape[0], D, mask.data_ptr(),
        cols.data_ptr() if cols is not None else None, w, k, out.data_ptr(),
        _kernels.stream_of(x_src),
    )
    return out


class SAGEConv(nn.Module):
    """One GraphSAGE layer (mean aggregator): ``lin_l`` on the neighbor
    mean (with bias), ``lin_r`` on the target rows (no bias)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.lin_l = nn.Linear(in_dim, out_dim, bias=bias)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
        x_dst = x_src[: adj.w_dst]  # targets are the prefix of the source
        agg = masked_mean_aggregate(x_src, adj)
        return self.lin_l(agg) + self.lin_r(x_dst)


class GraphSAGE(nn.Module):
    """Multi-layer GraphSAGE. ``in_dim`` is explicit (flax infers it at
    init; a torch module is built with its weights)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.num_layers = num_layers
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1]) for i in range(num_layers)
        )
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, adjs: Sequence[DenseAdj]) -> torch.Tensor:
        if len(adjs) != self.num_layers:
            raise ValueError(f"{len(adjs)} hops for a {self.num_layers}-layer model")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj)
            if i != self.num_layers - 1:
                x = self.dropout(F.relu(x))
        return x.to(torch.float32)

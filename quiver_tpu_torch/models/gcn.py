"""GCN over dense padded hops — the port of ``quiver_tpu/models/gcn.py``
(``GCNConv``, ``GCN``: DGL ``GraphConv``-style mini-batch semantics).

- ``norm="right"``: the mean over the target itself and its valid sampled
  neighbors, ``(x_i + sum_j m_ij x_j) / (deg_in_i + 1)``.
- ``norm="both"``: the symmetric ``1/sqrt(d_i d_j)`` with degrees counted
  within the sampled block (self-loops on both sides). The source
  out-degree is the float32 count of the valid lanes naming each source row
  (`quiver_tpu_torch.ops.gather_src.block_out_degree`: K14c on CUDA
  tensors); in the structural layout every source lane is a per-edge copy,
  so it is 1.

The neighbor rows come from ``DenseAdj.gather_src`` (K14 forward, K14b
backward on CUDA tensors, in the cols layout); the masked sums, scalings
and the linear layer stay on torch ops. ``dtype=torch.bfloat16`` computes
in bfloat16 with float32 parameters and logits, casting where the JAX
package casts: the degrees are counted in float32 and then cast.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gather_src import block_out_degree
from ..pyg.sage_sampler import DenseAdj
from .sage import dropout, lecun_normal_, linear_in

NORMS = ("right", "both")


class GCNConv(nn.Module):
    """One GCN layer over a `DenseAdj` (self-loop included), then ``lin``."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "right", bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm: {norm!r}")
        self.lin = nn.Linear(in_dim, out_dim, bias=bias)
        self.norm = norm
        self.dtype = dtype

    def forward(self, x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
        if self.dtype is not None:
            x_src = x_src.to(self.dtype)
        w_dst = adj.w_dst
        x_dst = x_src[:w_dst]
        gathered = adj.gather_src(x_src)                      # [W_dst, k, D]
        m = adj.mask[..., None].to(x_src.dtype)
        deg_in = adj.mask.sum(dim=1).to(x_src.dtype)          # sampled in-degree
        if self.norm == "right":
            s = (gathered * m).sum(dim=1) + x_dst
            agg = s / (deg_in + 1.0)[:, None]
        else:
            w_src = x_src.shape[0]
            if adj.cols is None:
                deg_out = torch.ones(w_src, dtype=torch.float32, device=x_src.device)
            else:
                deg_out = block_out_degree(adj.mask, adj.cols, w_src)
            deg_out = deg_out.to(x_src.dtype)
            inv_dst = torch.rsqrt(deg_in + 1.0)
            inv_src_all = torch.rsqrt(deg_out + 1.0)
            inv_src = adj.gather_src(inv_src_all[:, None])[..., 0]  # [W_dst, k]
            s = (gathered * m * inv_src[..., None]).sum(dim=1)
            s = s + x_dst * inv_dst[:, None]
            agg = s * inv_dst[:, None]
        return linear_in(self.lin, agg, self.dtype)


class GCN(nn.Module):
    """Multi-layer GCN: relu and dropout between layers, float32 logits."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 dropout: float = 0.5, norm: str = "right",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.num_layers = num_layers
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], norm=norm, dtype=dtype) for i in range(num_layers)
        )
        self.dropout = float(dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``nn.Dense``'s init: lecun-normal kernels, zero biases."""
        with torch.no_grad():
            for conv in self.convs:
                lecun_normal_(conv.lin.weight, generator)
                if conv.lin.bias is not None:
                    conv.lin.bias.zero_()

    def forward(self, x: torch.Tensor, adjs: Sequence[DenseAdj], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[W_0, out_dim]`` (float32); ``train=True`` applies
        dropout between layers, its mask drawn from ``generator``."""
        if len(adjs) != self.num_layers:
            raise ValueError(f"{len(adjs)} hops for a {self.num_layers}-layer model")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj)
            if i != self.num_layers - 1:
                x = F.relu(x)
                if train and self.dropout > 0.0:
                    x = dropout(x, self.dropout, generator)
        return x.to(torch.float32)

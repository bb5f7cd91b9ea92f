"""GAT over dense padded hops — the port of ``quiver_tpu/models/gat.py``
(``GATConv``, ``GAT``: PyG ``GATConv`` semantics, after the reference's
reddit GAT example).

Per layer: ``hs = lin(x_src)`` as ``[W_src, H, D]``; the neighbor rows
``hn = gather_src(hs)`` ``[W_dst, k, H, D]`` (K14 forward, K14b backward on
CUDA tensors, in the cols layout); scores ``leaky_relu(<hn, att_src> +
<hd, att_dst>, 0.2)`` with masked lanes set to -1e9 and the target's own
lane appended last; a softmax over the ``k + 1`` lanes in float32, cast to
the compute dtype; the weighted sum of the lanes. Hidden layers concatenate
their heads, the last layer has one head and takes the mean, with ELU and
dropout between layers. The dense math stays on torch ops.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..pyg.sage_sampler import DenseAdj
from .sage import dropout, lecun_normal_, linear_in

MASKED_SCORE = -1e9


class GATConv(nn.Module):
    """One GAT layer: ``lin`` (no bias) to ``heads * out_dim``, attention
    vectors ``att_src`` and ``att_dst`` of shape ``[1, heads, out_dim]``;
    ``[W_dst, heads * out_dim]`` out with ``concat``, else the mean over
    heads ``[W_dst, out_dim]``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin = nn.Linear(in_dim, heads * out_dim, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_dim))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_dim))
        self.heads, self.out_dim, self.concat = heads, out_dim, concat
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init: a lecun-normal ``lin`` kernel, and ``glorot_uniform``
        attention vectors with flax's fans of a ``(1, H, D)`` shape (fan_in
        H, fan_out D: uniform in ``+-sqrt(6 / (H + D))``; torch's
        ``xavier_uniform_`` would take fan_in ``H * D``)."""
        with torch.no_grad():
            lecun_normal_(self.lin.weight, generator)
            limit = math.sqrt(6.0 / (self.heads + self.out_dim))
            for att in (self.att_src, self.att_dst):
                att.uniform_(-limit, limit, generator=generator)

    def forward(self, x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
        h, d = self.heads, self.out_dim
        if self.dtype is not None:
            x_src = x_src.to(self.dtype)
        w_dst = adj.w_dst
        hs = linear_in(self.lin, x_src, self.dtype).reshape(-1, h, d)  # [W_src, H, D]
        hd = hs[:w_dst]                                                 # [W_dst, H, D]
        a_src = self.att_src.to(hs.dtype)
        a_dst = self.att_dst.to(hs.dtype)

        hn = adj.gather_src(hs)                                         # [W_dst, k, H, D]
        e_src = (hn * a_src[None]).sum(dim=-1)                          # [W_dst, k, H]
        e_dst = (hd * a_dst).sum(dim=-1)                                # [W_dst, H]
        # the target is its own extra neighbor (PyG adds self loops)
        e_self = e_dst + (hd * a_src[0]).sum(dim=-1)                    # [W_dst, H]
        e = F.leaky_relu(e_src + e_dst[:, None, :], self.negative_slope)
        e_self = F.leaky_relu(e_self, self.negative_slope)
        neg = torch.full((), MASKED_SCORE, dtype=e.dtype, device=e.device)
        e = torch.where(adj.mask[:, :, None], e, neg)
        all_e = torch.cat([e, e_self[:, None, :]], dim=1)               # [W_dst, k+1, H]
        alpha = torch.softmax(all_e.to(torch.float32), dim=1).to(hs.dtype)
        vals = torch.cat([hn, hd[:, None]], dim=1)                      # [W_dst, k+1, H, D]
        out = (alpha[..., None] * vals).sum(dim=1)                      # [W_dst, H, D]
        if self.concat:
            return out.reshape(w_dst, h * d)
        return out.mean(dim=1)


class GAT(nn.Module):
    """Multi-layer GAT: ``heads`` concatenated heads of ``hidden_dim`` on the
    hidden layers, one head (a mean) on the output layer, ELU and dropout
    between layers, float32 logits."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, heads: int = 4,
                 num_layers: int = 2, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        convs = []
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(GATConv(in_dim if i == 0 else hidden_dim * heads,
                                 out_dim if last else hidden_dim, heads=1 if last else heads,
                                 concat=not last, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.dropout = float(dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init of every layer (`GATConv.reset_parameters`), drawn
        from ``generator`` in layer order."""
        for conv in self.convs:
            conv.reset_parameters(generator)

    def forward(self, x: torch.Tensor, adjs: Sequence[DenseAdj], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[W_0, out_dim]`` (float32); ``train=True`` applies
        dropout between layers, its mask drawn from ``generator``."""
        if len(adjs) != self.num_layers:
            raise ValueError(f"{len(adjs)} hops for a {self.num_layers}-layer model")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj)
            if i != self.num_layers - 1:
                x = F.elu(x)
                if train and self.dropout > 0.0:
                    x = dropout(x, self.dropout, generator)
        return x.to(torch.float32)

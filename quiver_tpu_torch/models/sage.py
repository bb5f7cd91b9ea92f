"""GraphSAGE over dense padded hops — the port of
``quiver_tpu/models/sage.py`` (``masked_mean_aggregate``, ``SAGEConv``,
``GraphSAGE``) as ``nn.Module``s.

Semantics match PyG ``SAGEConv(mean)``: ``out = lin_l(mean_j x_j) +
lin_r(x_i)``; relu and dropout between layers, no head. The neighbor mean
is a ``torch.autograd.Function``: on CUDA tensors its forward is the
kernel of ``csrc/aggregate.cu`` (K4) and its backward the deterministic
kernel beside it (K4b); on CPU tensors both are the plain torch versions
in this module. The linear layers stay ``nn.Linear``, as the JAX package
leaves them to XLA. Float32 products run in full float32: the entry
points (`quiver_tpu_torch.inference`, the example) turn TF32 off.

``dtype=torch.bfloat16`` is the flax mixed-precision recipe of the JAX
package: parameters stay float32, each layer casts its input and its
parameters to bfloat16 and computes there (the mean in float32 with one
rounding), and the logits come back float32. `lecun_normal_`,
`linear_in` and `dropout` are shared with `models.gcn` and `models.gat`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _kernels
from ..ops.gather_src import gather_src_plain, structural_view
from ..pyg.sage_sampler import DenseAdj

# std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax ``nn.Dense``'s kernel init on a torch ``[out, in]`` weight:
    ``variance_scaling(1.0, "fan_in", "truncated_normal")``, a normal cut
    at +-2 sigma, sigma scaled so that the variance is ``1/fan_in``."""
    s = (1.0 / weight.shape[1]) ** 0.5 / TRUNC_NORMAL_STD
    nn.init.trunc_normal_(weight, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


def linear_in(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype`` (flax ``nn.Dense(dtype=...)``: the
    float32 parameters cast to the compute dtype); ``None`` keeps ``lin``."""
    if dtype is None:
        return lin(x)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def masked_mean_aggregate_plain(x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
    """Plain torch version of K4; a bfloat16 ``x_src`` is averaged in
    float32 and rounded once, as the kernel does."""
    if x_src.dtype == torch.bfloat16:
        return masked_mean_aggregate_plain(x_src.float(), adj).to(torch.bfloat16)
    w, k = adj.mask.shape
    gathered = (structural_view(x_src, w, k) if adj.cols is None
                else gather_src_plain(x_src, adj.cols))  # [W_dst, k, D]
    m = adj.mask[..., None].to(x_src.dtype)
    s = (gathered * m).sum(dim=1)
    cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1).to(x_src.dtype)
    return s / cnt


# K4's launch plan (csrc/aggregate.cu): warps a block; the targets' warps
# below which a target's lanes are split among more warps (8 an SM of
# 132: at the batch-1,024 shapes one warp a slice is as fast or faster,
# at a flush's 64 targets the split halves the time; scripts/
# torch_redesign_probe.py); the fewest lanes a split of a target may take
MEAN_BLOCK_WARPS = 8
MEAN_FILL_WARPS = 132 * 8
MEAN_MIN_SPLIT_LANES = 4


def _mean_vec(D: int, elem_bytes: int, align: int) -> int:
    vb = 16
    while vb > elem_bytes and ((D * elem_bytes) % vb or align % vb):
        vb //= 2
    return vb // elem_bytes


def mean_launch_plan(w_dst: int, k: int, D: int, elem_bytes: int,
                     align: int = 16) -> Tuple[int, int, int]:
    """K4's ``(vec, col_warps, split)`` for ``w_dst`` targets of ``k``
    lanes and ``D`` columns of ``elem_bytes`` each, the row pointers
    aligned to ``align`` bytes. ``vec``: elements a thread loads, 16 bytes
    where the row stride and ``align`` allow, else 8, 4 or 2. A target
    takes one warp a ``32 * vec``-column slice (at most 8), and, while the
    targets' warps number fewer than `MEAN_FILL_WARPS` and each part keeps
    at least `MEAN_MIN_SPLIT_LANES` lanes, twice as many warps, each
    summing a part of the lanes (``split``), up to 8 warps a target. The
    split is the float32 plan's at the same shape whatever the element
    type (a bfloat16 row takes as wide or wider slices), so a bfloat16
    mean adds in the float32 kernel's order and is its result rounded
    once."""
    vec = _mean_vec(D, elem_bytes, align)
    col_warps = min(-(-D // (32 * vec)), MEAN_BLOCK_WARPS)
    f32_warps = min(-(-D // (32 * _mean_vec(D, 4, align))), MEAN_BLOCK_WARPS)
    split = 1
    while (f32_warps * split * 2 <= MEAN_BLOCK_WARPS
           and -(-k // (2 * split)) >= MEAN_MIN_SPLIT_LANES
           and w_dst * f32_warps * split < MEAN_FILL_WARPS):
        split *= 2
    return vec, col_warps, split


def _mean_forward(x_src: torch.Tensor, mask: torch.Tensor,
                  cols: Optional[torch.Tensor]) -> torch.Tensor:
    if not x_src.is_cuda:
        return masked_mean_aggregate_plain(x_src, DenseAdj(cols, mask, None, None))
    w, k = mask.shape
    x_src = x_src.contiguous()
    mask = mask.contiguous()
    cols = cols.contiguous() if cols is not None else None
    D = x_src.shape[1]
    out = torch.empty((w, D), dtype=x_src.dtype, device=x_src.device)
    if w == 0 or D == 0:
        return out
    bf16 = x_src.dtype == torch.bfloat16
    ptrs = x_src.data_ptr() | out.data_ptr()
    vec, col_warps, split = mean_launch_plan(w, k, D, x_src.element_size(),
                                             min(ptrs & -ptrs, 16))
    _kernels.launch(
        "masked_mean", x_src.data_ptr(), x_src.shape[0], D, mask.data_ptr(),
        cols.data_ptr() if cols is not None else None, w, k, out.data_ptr(), int(bf16),
        vec, col_warps, split, _kernels.stream_of(x_src),
        variant="bfloat16" if bf16 else "float32",
    )
    return out


def masked_mean_backward_plain(g: torch.Tensor, mask: torch.Tensor,
                               cols: Optional[torch.Tensor], w_src: int) -> torch.Tensor:
    """Gradient of the masked mean with respect to ``x_src [w_src, D]``:
    lane (i, j) adds ``mask[i, j] * g[i] / max(cnt_i, 1)`` to its source
    row, as the reference's autodiff does (``index_add_`` in the cols
    layout, a reshape in the structural one). A bfloat16 ``g`` is divided
    and summed in float32 and rounded once, as the kernel does."""
    if g.dtype == torch.bfloat16:
        return masked_mean_backward_plain(g.float(), mask, cols, w_src).to(torch.bfloat16)
    w, k = mask.shape
    cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1).to(g.dtype)
    contrib = (g / cnt)[:, None, :] * mask[..., None].to(g.dtype)  # [W, k, D]
    gx = torch.zeros((w_src, g.shape[1]), dtype=g.dtype, device=g.device)
    if cols is None:
        gx[w: w * (1 + k)] = contrib.transpose(0, 1).reshape(k * w, g.shape[1])
    else:
        idx = torch.clamp(cols, 0, w_src - 1).to(torch.int64).reshape(-1)
        gx.index_add_(0, idx, contrib.reshape(w * k, g.shape[1]))
    return gx


def masked_mean_backward(g: torch.Tensor, mask: torch.Tensor, cols: Optional[torch.Tensor],
                         w_src: int) -> torch.Tensor:
    """`masked_mean_backward_plain`'s function; on CUDA tensors one
    counted launch of K4b, whose C entry point runs its kernels in turn
    (the cols layout: the targets' scaled rows, then K14b's count, scan,
    fill, rank and ordered sum). Deterministic: no float atomics, two runs
    give bit-equal gradients. Any k."""
    w, k = mask.shape
    if g.shape[0] != w:
        raise ValueError(f"gradient of {g.shape[0]} rows for {w} targets")
    if not g.is_cuda:
        return masked_mean_backward_plain(g, mask, cols, w_src)
    if g.dtype not in (torch.float32, torch.bfloat16) or mask.dtype != torch.bool:
        raise TypeError("the mean backward kernel takes a float32 or bfloat16 gradient and "
                        "a bool mask")
    if cols is not None and cols.dtype != torch.int32:
        raise TypeError(f"the mean backward kernel takes int32 cols; got {cols.dtype}")
    if cols is not None and w * k >= 2**31:
        raise ValueError(f"the mean backward kernel indexes lanes in int32; got {w} x {k}")
    g, mask = g.contiguous(), mask.contiguous()
    D = g.shape[1]
    dev = g.device
    gx = torch.empty((w_src, D), dtype=g.dtype, device=dev)
    if w_src == 0 or D == 0:
        return gx
    scratch, n_bytes = None, 0
    if cols is not None:
        cols = cols.contiguous()
        n_bytes = _kernels.masked_mean_backward_scratch_bytes(w_src, w, k, D)
        scratch = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    bf16 = g.dtype == torch.bfloat16
    _kernels.launch(
        "masked_mean_backward", g.data_ptr(), D, mask.data_ptr(),
        cols.data_ptr() if cols is not None else None, w, k, w_src, gx.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, n_bytes, int(bf16),
        _kernels.stream_of(g), variant=("structural" if cols is None else "cols",
                                        "bfloat16" if bf16 else "float32"),
    )
    return gx


class _MaskedMean(torch.autograd.Function):
    """The neighbor mean with its gradient to ``x_src`` (none to the
    mask or cols)."""

    @staticmethod
    def forward(ctx, x_src, mask, cols):
        ctx.save_for_backward(mask, cols)
        ctx.w_src = x_src.shape[0]
        return _mean_forward(x_src, mask, cols)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        mask, cols = ctx.saved_tensors
        return masked_mean_backward(g, mask, cols, ctx.w_src), None, None


def masked_mean_aggregate(x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
    """Mean of the valid sampled neighbors per target: ``[W_dst, D]``
    from ``x_src [W_src, D]`` (cols or structural layout), differentiable
    in ``x_src``."""
    w, k = adj.mask.shape
    if x_src.dim() != 2:
        raise ValueError(f"x_src must be [W_src, D]; got {tuple(x_src.shape)}")
    if adj.cols is None and x_src.shape[0] < w * (1 + k):
        raise ValueError(f"structural layout needs {w * (1 + k)} source rows; "
                         f"got {x_src.shape[0]}")
    if x_src.is_cuda:
        if x_src.dtype not in (torch.float32, torch.bfloat16) or adj.mask.dtype != torch.bool:
            raise TypeError("the mean kernel takes float32 or bfloat16 x and a bool mask")
        if adj.cols is not None and adj.cols.dtype != torch.int32:
            raise TypeError(f"the mean kernel takes int32 cols; got {adj.cols.dtype}")
    return _MaskedMean.apply(x_src, adj.mask, adj.cols)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's inverted dropout (``where(keep, x / keep_prob, 0)``) with the
    keep mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator (never the global RNG)")
    keep_prob = 1.0 - rate
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(
        keep_prob, generator=generator)
    return torch.where(keep > 0, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class SAGEConv(nn.Module):
    """One GraphSAGE layer (mean aggregator): ``lin_l`` on the neighbor
    mean (with bias), ``lin_r`` on the target rows (no bias), computed in
    ``dtype`` (None: the input's)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin_l = nn.Linear(in_dim, out_dim, bias=bias)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)
        self.dtype = dtype

    def forward(self, x_src: torch.Tensor, adj: DenseAdj) -> torch.Tensor:
        if self.dtype is not None:
            x_src = x_src.to(self.dtype)
        x_dst = x_src[: adj.w_dst]  # targets are the prefix of the source
        agg = masked_mean_aggregate(x_src, adj)
        return linear_in(self.lin_l, agg, self.dtype) + linear_in(self.lin_r, x_dst, self.dtype)


class GraphSAGE(nn.Module):
    """Multi-layer GraphSAGE. ``in_dim`` is explicit (flax infers it at
    init; a torch module is built with its weights). ``dtype`` is the
    compute dtype (None or ``torch.bfloat16``); parameters and logits stay
    float32."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.out_dim = out_dim
        self.num_layers = num_layers
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], dtype=dtype) for i in range(num_layers)
        )
        self.dropout = float(dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``nn.Dense``'s default init, drawn from ``generator``:
        lecun-normal weights (``variance_scaling(1.0, "fan_in",
        "truncated_normal")``: a normal cut at +-2 sigma, sigma scaled so
        that the variance is ``1/fan_in``) and zero biases."""
        with torch.no_grad():
            for conv in self.convs:
                for lin in (conv.lin_l, conv.lin_r):
                    lecun_normal_(lin.weight, generator)
                    if lin.bias is not None:
                        lin.bias.zero_()

    def forward(self, x: torch.Tensor, adjs: Sequence[DenseAdj], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[W_0, out_dim]`` (float32). ``train=True`` applies
        dropout between layers, its mask drawn from ``generator`` (a
        ``torch.Generator`` on ``x``'s device)."""
        if len(adjs) != self.num_layers:
            raise ValueError(f"{len(adjs)} hops for a {self.num_layers}-layer model")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj)
            if i != self.num_layers - 1:
                x = F.relu(x)
                if train and self.dropout > 0.0:
                    x = dropout(x, self.dropout, generator)
        return x.to(torch.float32)

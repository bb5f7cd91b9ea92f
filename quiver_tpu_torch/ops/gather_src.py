"""The hop-source gather of the dense adjacency and GCN's block out-degree
— the port of ``quiver_tpu/pyg/sage_sampler.py:DenseAdj.gather_src`` in
the cols layout, with its gradient, and of the out-degree count at
``quiver_tpu/models/gcn.py:69-71``.

- `gather_src` (differentiable in ``x_src``): ``x_src[clip(cols, 0,
  W_src - 1)]``, ``[W_dst, k, ...]`` from ``x_src [W_src, ...]``. On CUDA
  tensors its forward is the kernel K14 (``csrc/gather.cu``) and its
  backward K14b (``csrc/aggregate.cu``); on CPU tensors both are the plain
  torch versions here (`gather_src_plain`, `gather_src_backward_plain`).
- `block_out_degree`: the float32 count of valid lanes per source row,
  K14c (``csrc/aggregate.cu``) on CUDA tensors, `block_out_degree_plain`
  on CPU tensors.

Rows of any trailing shape are gathered as flat rows of ``F =
prod(shape[1:])`` elements, in float32 or bfloat16.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def structural_view(x_src: torch.Tensor, w: int, k: int) -> torch.Tensor:
    """The neighbor rows ``[w, k, ...]`` of the structural layout, where
    neighbor (i, j) sits at source position ``w + j*w + i``: a slice, a
    reshape and a transpose (a view; autograd's gradient is a copy)."""
    s = x_src[w: w * (1 + k)]
    return s.reshape((k, w) + tuple(x_src.shape[1:])).transpose(0, 1)


def gather_src_plain(x_src: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K14: ``x_src[clip(cols, 0, W_src - 1)]``."""
    return x_src[torch.clamp(cols, 0, x_src.shape[0] - 1).to(torch.int64)]


def _kernel_dtype(t: torch.Tensor, what: str) -> str:
    name = _DTYPES.get(t.dtype)
    if name is None:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16 rows; got {t.dtype}")
    return name


def _check_lanes(mask: torch.Tensor, cols: torch.Tensor, what: str) -> None:
    if mask.dtype != torch.bool or cols.dtype != torch.int32:
        raise TypeError(f"the {what} kernel takes a bool mask and int32 cols; "
                        f"got {mask.dtype} and {cols.dtype}")
    if mask.shape != cols.shape or mask.dim() != 2:
        raise ValueError(f"mask and cols must both be [W_dst, k]; got {tuple(mask.shape)} "
                         f"and {tuple(cols.shape)}")


def gather_src_rows(x_src: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """`gather_src_plain`'s function, with no gradient; on CUDA tensors one
    counted launch of K14 (a bit copy)."""
    if not x_src.is_cuda:
        return gather_src_plain(x_src, cols)
    variant = _kernel_dtype(x_src, "gather_src")
    if cols.dtype != torch.int32 or cols.device != x_src.device:
        raise TypeError(f"the gather_src kernel takes int32 cols on {x_src.device}; "
                        f"got {cols.dtype} on {cols.device}")
    x = x_src.contiguous()
    cols = cols.contiguous()
    rest = tuple(x.shape[1:])
    out = torch.empty(tuple(cols.shape) + rest, dtype=x.dtype, device=x.device)
    F = math.prod(rest)
    if out.numel() == 0:
        return out
    if x.shape[0] == 0:
        raise ValueError("gather_src from an empty source")
    _kernels.launch("gather_src", x.data_ptr(), x.shape[0], F, x.element_size(),
                    cols.data_ptr(), cols.numel(), out.data_ptr(), _kernels.stream_of(x),
                    variant=variant)
    return out


def gather_src_backward_plain(g: torch.Tensor, mask: torch.Tensor, cols: torch.Tensor,
                              w_src: int) -> torch.Tensor:
    """Plain torch version of K14b: the gradient ``[w_src, ...]`` of
    `gather_src` from ``g [W_dst, k, ...]``, each valid lane's row added to
    its clipped source row in ascending lane order (``index_add_``, float32
    accumulation, one rounding to ``g``'s dtype)."""
    w, k = mask.shape
    rest = tuple(g.shape[2:])
    flat = g.reshape(w * k, -1)
    m = mask.reshape(-1)
    idx = torch.clamp(cols.reshape(-1), 0, w_src - 1).to(torch.int64)[m]
    gx = torch.zeros((w_src, flat.shape[1]), dtype=torch.float32, device=g.device)
    gx.index_add_(0, idx, flat[m].to(torch.float32))
    return gx.to(g.dtype).reshape((w_src,) + rest)


def gather_src_backward(g: torch.Tensor, mask: torch.Tensor, cols: torch.Tensor,
                        w_src: int) -> torch.Tensor:
    """`gather_src_backward_plain`'s function; on CUDA tensors one counted
    launch of K14b, one kernel on the card (count, scan, fill, order and the
    ordered sum: a small call's in each block's shared memory for its own
    rows, a larger one's in phases apart by grid barriers). Deterministic:
    no float atomics, two runs give bit-equal gradients."""
    w, k = mask.shape
    if tuple(g.shape[:2]) != (w, k):
        raise ValueError(f"gradient of shape {tuple(g.shape)} for a [{w}, {k}] hop")
    if not g.is_cuda:
        return gather_src_backward_plain(g, mask, cols, w_src)
    variant = _kernel_dtype(g, "gather_src_backward")
    _check_lanes(mask, cols, "gather_src_backward")
    if w * k >= 2**31:
        raise ValueError(f"the gather_src_backward kernel indexes lanes in int32; got {w} x {k}")
    g, mask, cols = g.contiguous(), mask.contiguous(), cols.contiguous()
    rest = tuple(g.shape[2:])
    F = math.prod(rest)
    gx = torch.empty((w_src,) + rest, dtype=g.dtype, device=g.device)
    if w_src == 0 or F == 0:
        return gx
    n_bytes = _kernels.masked_mean_backward_scratch_bytes(w_src, w, k)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=g.device)
    _kernels.launch("gather_src_backward", g.data_ptr(), F, mask.data_ptr(), cols.data_ptr(),
                    w, k, w_src, gx.data_ptr(), scratch.data_ptr(), n_bytes,
                    int(g.dtype == torch.bfloat16), _kernels.stream_of(g), variant=variant)
    return gx


class _GatherSrc(torch.autograd.Function):
    """The cols-layout gather with its gradient to ``x_src`` (none to the
    mask or cols)."""

    @staticmethod
    def forward(ctx, x_src, mask, cols):
        ctx.save_for_backward(mask, cols)
        ctx.w_src = x_src.shape[0]
        return gather_src_rows(x_src, cols)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        mask, cols = ctx.saved_tensors
        return gather_src_backward(g, mask, cols, ctx.w_src), None, None


def gather_src(x_src: torch.Tensor, mask: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Neighbor rows ``[W_dst, k, ...]`` of ``x_src [W_src, ...]`` at
    ``clip(cols, 0, W_src - 1)``, differentiable in ``x_src``.

    The gradient sums the valid lanes only (``mask``), in lane order. JAX's
    transpose of ``jnp.take`` scatters every lane's cotangent, but every
    caller of the JAX package gives a masked lane a cotangent of +-0: GCN
    and GraphSAGE multiply the gathered rows by the mask, and GAT's masked
    scores are -1e9 before a float32 softmax, whose exp is exactly 0. Adding
    +-0 to a sum that starts at +0 changes no bit, so for those callers the
    two gradients are bit-equal; a caller whose masked lanes carry other
    cotangents loses them here."""
    return _GatherSrc.apply(x_src, mask, cols)


def block_out_degree_plain(mask: torch.Tensor, cols: torch.Tensor, w_src: int) -> torch.Tensor:
    """Plain torch version of K14c: ``[w_src]`` float32 counts of the valid
    lanes naming each source row, as ``jnp.zeros(w_src).at[cols].add(mask,
    mode="drop")`` counts them: a negative col counts from the end, a col
    outside ``[-w_src, w_src)`` is dropped (not clipped)."""
    c = cols.reshape(-1).to(torch.int64)
    c = torch.where(c < 0, c + w_src, c)
    keep = (c >= 0) & (c < w_src)
    out = torch.zeros(w_src, dtype=torch.float32, device=mask.device)
    return out.index_add_(0, c[keep], mask.reshape(-1)[keep].to(torch.float32))


def block_out_degree(mask: torch.Tensor, cols: torch.Tensor, w_src: int) -> torch.Tensor:
    """`block_out_degree_plain`'s function; on CUDA tensors one counted
    launch of K14c, one cooperative kernel: the output zeroed, one grid
    barrier, then float atomics, merged by source in each block's table in
    shared memory where a block has many lanes (exact: every partial is an
    integer, and past 2^24 lanes the kernel counts in integers)."""
    if not mask.is_cuda:
        return block_out_degree_plain(mask, cols, w_src)
    _check_lanes(mask, cols, "block_out_degree")
    mask, cols = mask.contiguous(), cols.contiguous()
    out = torch.empty(w_src, dtype=torch.float32, device=mask.device)
    if w_src == 0:
        return out
    _kernels.launch("block_out_degree", mask.data_ptr(), cols.data_ptr(), mask.numel(), w_src,
                    out.data_ptr(), _kernels.stream_of(mask))
    return out

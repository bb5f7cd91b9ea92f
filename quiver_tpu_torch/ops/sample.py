"""One-hop uniform neighbor sampling — the port of
``quiver_tpu/ops/sample.py`` (``pad_widths``, ``fisher_yates_positions``,
``sample_layer``, ``tiled_sample_layer`` and the host tile build).

Each row draws ``min(deg, k)`` distinct neighbor positions by a partial
Fisher-Yates shuffle over k threefry uniforms of shape ``[k, W]``; rows
with ``deg <= k`` copy all neighbors. The draw is bit-equal to the JAX
package on the same key. ``sample_layer`` reads the flat CSR,
``tiled_sample_layer`` the 128-lane tile layout; both give the same draw.

On a CUDA tensor the wrappers launch the hand-written kernel of
``csrc/sample.cu``; on a CPU tensor they run the plain torch version in
this module, which the tests hold against the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from .. import random as qrandom

LANE = 128  # tile row width of the tiled layout


def pad_widths(batch: int, sizes, caps=None):
    """Static padded n_id widths per hop: ``W_{l+1} = min(cap_l, W_l*(1+k_l))``."""
    widths = [int(batch)]
    for l, k in enumerate(sizes):
        w = widths[-1] * (1 + int(k))
        if caps is not None and caps[l] is not None:
            w = min(w, int(caps[l]))
        widths.append(w)
    return widths


def fisher_yates_positions(key, deg: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos [B, k] int32, valid [B, k] bool)``: for each row, ``min(deg,
    k)`` distinct positions in ``[0, deg)``; ``0..deg-1`` in order where
    ``deg <= k``. Plain torch, step for step the JAX formulation."""
    deg = deg.to(torch.int32)
    B = deg.shape[0]
    dev = deg.device
    if k == 0:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B, 0), dtype=torch.bool, device=dev))
    ar_k = torch.arange(k, dtype=torch.int32, device=dev)
    us = qrandom.uniform(key, (k, B), device=dev)
    head = ar_k.expand(B, k).clone()
    tail_j = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    tail_v = torch.zeros((B, k), dtype=torch.int32, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    lim = torch.clamp(deg - 1, min=0)
    outs = []
    for i in range(k):
        span = torch.clamp(deg - i, min=1)
        j = i + (us[i] * span.to(torch.float32)).to(torch.int32)
        j = torch.minimum(j, lim)
        in_head = j < k
        onehot = ar_k[None, :] == j[:, None]
        head_val = torch.where(onehot, head, 0).sum(dim=1).to(torch.int32)
        match = tail_j == j[:, None]
        has_match = match.any(dim=1)
        first = match.to(torch.int32).argmax(dim=1).to(torch.int32)
        tail_val = torch.where(
            has_match, torch.where(match, tail_v, 0).sum(dim=1).to(torch.int32), j
        )
        val_j = torch.where(in_head, head_val, tail_val)
        val_i = head[:, i].clone()
        head = torch.where(onehot & in_head[:, None], val_i[:, None], head)
        head[:, i] = val_j
        slot = torch.where(has_match, first, cnt)
        write_tail = ~in_head
        onehot_s = (ar_k[None, :] == slot[:, None]) & write_tail[:, None]
        tail_j = torch.where(onehot_s, j[:, None], tail_j)
        tail_v = torch.where(onehot_s, val_i[:, None], tail_v)
        cnt = cnt + (write_tail & ~has_match).to(torch.int32)
        outs.append(val_j)
    pos = torch.stack(outs, dim=1)
    pos = torch.where(deg[:, None] <= k, ar_k[None, :], pos)
    valid = ar_k[None, :] < torch.clamp(deg, max=k)[:, None]
    return pos, valid


def _check_layer_args(seeds, seed_valid, k, graph):
    if seeds.dim() != 1 or seed_valid.shape != seeds.shape:
        raise ValueError("seeds and seed_valid must be [W] of one shape")
    if seed_valid.dtype != torch.bool:
        raise TypeError("seed_valid must be bool")
    if int(k) < 0:
        raise ValueError("fanout k must be >= 0")
    for t in graph:
        if t.device != seeds.device:
            raise ValueError(
                f"graph tensor on {t.device} but seeds on {seeds.device}"
            )


def sample_layer_plain(indptr, indices, seeds, seed_valid, k, key):
    """Plain torch one-hop draw over the flat CSR."""
    n = indptr.shape[0] - 1
    s = torch.clamp(seeds, 0, n - 1).to(torch.int64)
    ptr = indptr[s]
    deg = (indptr[s + 1] - ptr).to(torch.int32)
    deg = torch.where(seed_valid, deg, 0)
    pos, valid = fisher_yates_positions(key, deg, k)
    flat = torch.clamp(ptr[:, None].to(torch.int64) + pos, 0, indices.shape[0] - 1)
    return indices[flat], valid


def tiled_sample_layer_plain(bd, tiles, seeds, seed_valid, k, key):
    """Plain torch one-hop draw over the tile layout."""
    n = bd.shape[0]
    s = torch.clamp(seeds, 0, n - 1).to(torch.int64)
    both = bd[s]
    base = both[:, 0]
    deg = torch.where(seed_valid, both[:, 1], 0)
    pos, valid = fisher_yates_positions(key, deg, k)
    rows = torch.clamp(base[:, None].to(torch.int64) + (pos >> 7), 0, tiles.shape[0] - 1)
    return tiles[rows, (pos & (LANE - 1)).to(torch.int64)], valid


def _launch_sample(kind, a, b, seeds, seed_valid, k, key):
    """Launch the sampling kernel: ``kind`` is "tiled" (``a=bd``,
    ``b=tiles``) or "flat" (``a=indptr``, ``b=indices``)."""
    for t, name in ((a, "graph"), (b, "graph"), (seeds, "seeds")):
        if t.dtype != torch.int32:
            raise TypeError(f"the sampling kernel takes int32 {name}; got {t.dtype}")
    if int(k) > _kernels.KMAX:
        raise ValueError(f"the sampling kernel takes k <= {_kernels.KMAX}; got {k}")
    a, b = a.contiguous(), b.contiguous()
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    W = seeds.shape[0]
    nbrs = torch.empty((W, k), dtype=torch.int32, device=seeds.device)
    valid = torch.empty((W, k), dtype=torch.bool, device=seeds.device)
    if W == 0 or k == 0:
        return nbrs, valid
    if kind == "tiled":
        n_nodes, extent = a.shape[0], b.shape[0]
    else:
        n_nodes, extent = a.shape[0] - 1, b.shape[0]
    _kernels.launch(
        "sample_" + kind, a.data_ptr(), b.data_ptr(), extent, n_nodes,
        seeds.data_ptr(), seed_valid.data_ptr(), W, int(k),
        int(key[0]), int(key[1]), nbrs.data_ptr(), valid.data_ptr(),
        _kernels.stream_of(seeds),
    )
    return nbrs, valid


def sample_layer(indptr, indices, seeds, seed_valid, k: int, key):
    """One-hop sample over the flat CSR: ``(nbrs [W, k], valid [W, k])``.
    ``key`` is a host key (`quiver_tpu_torch.random.key`). Kernel on CUDA
    tensors, plain torch on CPU tensors."""
    _check_layer_args(seeds, seed_valid, k, (indptr, indices))
    if seeds.is_cuda:
        return _launch_sample("flat", indptr, indices, seeds, seed_valid, k, key)
    return sample_layer_plain(indptr, indices, seeds, seed_valid, k, key)


def tiled_sample_layer(bd, tiles, seeds, seed_valid, k: int, key):
    """One-hop sample over the tile layout, draw-identical to
    `sample_layer` on the same key."""
    _check_layer_args(seeds, seed_valid, k, (bd, tiles))
    if seeds.is_cuda:
        return _launch_sample("tiled", bd, tiles, seeds, seed_valid, k, key)
    return tiled_sample_layer_plain(bd, tiles, seeds, seed_valid, k, key)


def tiled_base_host(indptr) -> Tuple[np.ndarray, int]:
    """Host half of the tile build: ``(bd [N,2] int32, m_rows)``."""
    deg = np.diff(indptr).astype(np.int64)
    rows_per = -(-deg // LANE)
    base = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(rows_per, out=base[1:])
    if base[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"tile row count {base[-1]} exceeds int32")
    bd = np.stack([base[:-1].astype(np.int32), deg.astype(np.int32)], axis=1)
    return bd, max(int(base[-1]), 1)


def build_tiled_host(indptr: np.ndarray, indices: np.ndarray, id_dtype=None):
    """Host build of the 128-lane tile layout: each node's edge list starts
    at a tile-row boundary of a ``[M, 128]`` table; ``bd [N, 2]`` holds
    (tile_base, degree). Returns ``(bd, tiles)``."""
    if id_dtype is None:
        from ..utils import _best_id_dtype

        id_dtype = _best_id_dtype(indptr.shape[0])
    bd, M = tiled_base_host(indptr)
    base = bd[:, 0].astype(np.int64)
    deg = bd[:, 1].astype(np.int64)
    tiles = np.zeros((M, LANE), np.dtype(id_dtype))
    out_pos = (
        np.repeat(base * LANE, deg)
        + np.arange(len(indices), dtype=np.int64)
        - np.repeat(indptr[:-1].astype(np.int64), deg)
    )
    tiles.reshape(-1)[out_pos] = indices.astype(id_dtype, copy=False)
    return bd, tiles

"""Row-sharded graph topology over the mesh — the port of
``quiver_tpu/parallel/topology.py`` (``ShardedTopology``,
``TiledShardedTopology``, ``resolve_topology_layout``,
``partition_rows_by_edges``, ``build_topology_shards``,
``build_tiled_topology_shards``, ``shard_topology_rows``,
``sharded_sample_layer``, ``tiled_sharded_sample_layer``, their grouped
forms, ``gather_comm_bytes``, ``sampling_comm_bytes``).

Each shard of the striping axes owns a contiguous, edge-balanced range of
rows, and each rank holds only its shard's CSR block. One hop's draw is a
collective: every shard draws neighbors for the frontier rows it owns
(degree 0 elsewhere; kernel K13b, ``csrc/sample.cu``, writing its
neighbors and int32 flags as one stacked slab) and one all-reduce over the
striping group assembles the ``[W, k]`` neighbors and flags. The draw
is K1's, counter for counter, so the assembled neighbors equal the
unsharded draw with the same key on its valid lanes.

Two block layouts share the machinery: ``flat`` (`ShardedTopology`: a local
indptr and the block's edges) and ``tiled`` (`TiledShardedTopology`: the
128-lane tile layout of the block, built on the card by K12 from the
block's edges).

On a host mesh the graph stripes over ``("host", "ici")`` and each host
draws for its own frontier: the grouped samplers all-gather the frontiers
over host, run K13b at the gathered width into one stacked int32 slab of
each host's neighbors and flags, and hand each host its own ``[W, k]`` pair
back (one all-to-all and one K13c int32 unpack of the slab, then one sum
over ici).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from ..ops.sample import (
    LANE,
    _check_layer_args,
    build_tiled_device,
    build_tiled_host,
    fisher_yates_positions,
    pad_widths,
    tiled_base_host,
    tiled_rowmap_host,
)
from . import collectives
from .collectives import _axes, _axis


class ShardedTopology(NamedTuple):
    """One rank's block of a row-sharded CSR (`shard_topology_rows`).

    ``indptr``    [R_max+1] — the shard's LOCAL indptr (offsets into its own
                  indices block), edge-padded so padding rows read as degree 0;
    ``indices``   [E_pad]   — the shard's neighbor block, zero-padded;
    ``row_start`` [P+1]     — global row boundaries, a host int64 tensor
                  (shard p owns rows ``row_start[p]:row_start[p+1]``).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    row_start: torch.Tensor

    layout = "flat"

    @property
    def n_shards(self) -> int:
        return self.row_start.shape[0] - 1


class TiledShardedTopology(NamedTuple):
    """One rank's block of a row-sharded CSR in the 128-lane tile layout.

    ``bd``    [R_max, 2] int32 — the shard's LOCAL (tile_base, degree) table,
              row-padded with degree-0 rows;
    ``tiles`` [M_max, 128]    — the shard's tile table, padded to the
              largest shard's tile count (rounded up to 8 rows);
    ``row_start`` [P+1]       — global row boundaries, as `ShardedTopology`.
    """

    bd: torch.Tensor
    tiles: torch.Tensor
    row_start: torch.Tensor

    layout = "tiled"

    @property
    def n_shards(self) -> int:
        return self.row_start.shape[0] - 1


def resolve_topology_layout(layout: Optional[str], device=None) -> str:
    """Default the sharded-topology layout per device: ``None`` means "tiled"
    on the card (the sampler's default there, as the JAX package's on the
    TPU) and "flat" elsewhere (the CPU runs the layout the JAX package's
    virtual CPU meshes use)."""
    if layout is None:
        layout = "tiled" if device is not None and torch.device(device).type == "cuda" else "flat"
    if layout not in ("flat", "tiled"):
        raise ValueError(f"unsupported topology layout: {layout!r}")
    return layout


def partition_rows_by_edges(indptr: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous row boundaries with ~equal edges per shard.

    Returns ``row_start`` [n_shards+1] with ``row_start[0]=0`` and
    ``row_start[-1]=N``. Row ranges may be empty on pathological graphs
    (one row owning nearly all edges); the sampler handles that (degree-0
    ownership elsewhere).
    """
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    e = int(indptr[-1])
    targets = (np.arange(1, n_shards) * e) // n_shards
    cuts = np.searchsorted(indptr, targets, side="left")
    row_start = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    return np.maximum.accumulate(row_start)  # enforce monotone under ties


def _flat_dims(indptr, row_start, pad_multiple):
    """(r_max, e_pad, ptr dtype) of the stacked flat blocks."""
    n_shards = row_start.shape[0] - 1
    r_max = max(int(np.max(row_start[1:] - row_start[:-1])) if n_shards else 0, 1)
    e_pad = 0
    for p in range(n_shards):
        e_pad = max(e_pad, int(indptr[row_start[p + 1]] - indptr[row_start[p]]))
    e_pad = max(-(-e_pad // pad_multiple) * pad_multiple, pad_multiple)
    return r_max, e_pad, np.int32 if e_pad < 2**31 else np.int64


def _flat_block(indptr, indices, row_start, p, r_max, e_pad, ptr_dt, id_dtype=None):
    """Shard p's (local indptr [r_max+1], indices [e_pad]) block, its ids in
    ``id_dtype`` (default: the graph's)."""
    lo, hi = int(row_start[p]), int(row_start[p + 1])
    local = (indptr[lo: hi + 1] - indptr[lo]).astype(ptr_dt)
    ptr = np.zeros(r_max + 1, ptr_dt)
    ptr[: hi - lo + 1] = local
    # edge-pad: rows past this shard's range read as degree 0
    ptr[hi - lo + 1:] = local[-1] if local.size else 0
    idx = np.zeros(e_pad, id_dtype or indices.dtype)
    blk = indices[int(indptr[lo]): int(indptr[hi])]
    idx[: blk.shape[0]] = blk
    return ptr, idx


def _row_start_dtype(row_start):
    return np.int32 if int(row_start[-1]) < 2**31 else np.int64


def build_topology_shards(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_shards: int,
    pad_multiple: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side shard construction: (indptr_blocks [P, R_max+1],
    indices_blocks [P, E_pad], row_start [P+1]) as stacked numpy arrays, the
    JAX package's arrays (see `ShardedTopology`)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    row_start = partition_rows_by_edges(indptr, n_shards)
    r_max, e_pad, ptr_dt = _flat_dims(indptr, row_start, pad_multiple)
    indptr_blocks = np.zeros((n_shards, r_max + 1), ptr_dt)
    indices_blocks = np.zeros((n_shards, e_pad), indices.dtype)
    for p in range(n_shards):
        indptr_blocks[p], indices_blocks[p] = _flat_block(indptr, indices, row_start, p, r_max,
                                                          e_pad, ptr_dt)
    return indptr_blocks, indices_blocks, row_start.astype(_row_start_dtype(row_start))


def _tiled_dims(indptr, row_start, pad_multiple):
    """(r_max, m_max) of the stacked tiled blocks: the largest shard's row
    count and tile count (rounded up to ``pad_multiple``), from the host
    base tables alone."""
    n_shards = row_start.shape[0] - 1
    r_max = max(int(np.max(row_start[1:] - row_start[:-1])) if n_shards else 0, 1)
    m_max = 1
    for p in range(n_shards):
        lo, hi = int(row_start[p]), int(row_start[p + 1])
        m_max = max(m_max, tiled_base_host(indptr[lo: hi + 1] - indptr[lo])[1])
    return r_max, -(-m_max // pad_multiple) * pad_multiple


def build_tiled_topology_shards(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_shards: int,
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side TILED shard construction: (bd_blocks [P, R_max, 2],
    tiles_blocks [P, M_max, 128], row_start [P+1]) as stacked numpy arrays
    (see `TiledShardedTopology`). Row boundaries come from the flat build's
    split, and each shard's block is `build_tiled_host` of its local indptr,
    so a shard's tile table holds exactly its flat block's edges, in order.
    The oracle of the card's build in `shard_topology_rows`."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    row_start = partition_rows_by_edges(indptr, n_shards)
    r_max, m_max = _tiled_dims(indptr, row_start, pad_multiple)
    bd_blocks = np.zeros((n_shards, r_max, 2), np.int32)
    tiles_blocks = np.zeros((n_shards, m_max, LANE), indices.dtype)
    for p in range(n_shards):
        lo, hi = int(row_start[p]), int(row_start[p + 1])
        local_ptr = (indptr[lo: hi + 1] - indptr[lo]).astype(np.int64)
        local_idx = indices[int(indptr[lo]): int(indptr[hi])]
        bd, tiles = build_tiled_host(local_ptr, local_idx, indices.dtype)
        bd_blocks[p, : bd.shape[0]] = bd
        tiles_blocks[p, : tiles.shape[0]] = tiles
    return bd_blocks, tiles_blocks, row_start.astype(_row_start_dtype(row_start))


def shard_topology_rows(mesh, topo, axes=None, layout: Optional[str] = None):
    """This rank's block of a `CSRTopo` row-sharded over ``axes`` (default:
    the mesh's feature axes, ``("host", "ici")`` on a host mesh, else
    ``("ici",)``), on the rank's device: the rank holds only its shard's rows
    (~E/P edges, edge-balanced). ``layout`` "flat" (`ShardedTopology`) or "tiled"
    (`TiledShardedTopology`); None resolves per device
    (`resolve_topology_layout`). The tiled block's tile table is built on
    the rank's device from the block's edges through its host row map (K12
    on the card, its plain version on the CPU), bit-equal to
    `build_tiled_topology_shards`'s block. Pair with the same ``layout`` on
    `train.make_sharded_topo_train_step`. Ids are int32 (K13b's)."""
    layout = resolve_topology_layout(layout, mesh.device)
    if axes is None:
        from .train import mesh_axes

        axes = mesh_axes(mesh)[1]
    p, n_shards, _ = _axis(mesh, axes)
    indptr = np.asarray(topo.indptr, np.int64)
    indices = np.asarray(topo.indices)
    if indptr.shape[0] - 1 >= 2**31 or indptr[-1] >= 2**31:
        raise ValueError("the sharded sampler takes int32 node ids and edge offsets "
                         "(ROADMAP A3: wider ids are not ported)")
    row_start = partition_rows_by_edges(indptr, n_shards)
    rs = torch.from_numpy(row_start.astype(np.int64))
    dev = mesh.device
    if layout == "flat":
        r_max, e_pad, ptr_dt = _flat_dims(indptr, row_start, 512)
        ptr, idx = _flat_block(indptr, indices, row_start, p, r_max, e_pad, ptr_dt, np.int32)
        return ShardedTopology(torch.from_numpy(ptr).to(dev), torch.from_numpy(idx).to(dev), rs)
    r_max, m_max = _tiled_dims(indptr, row_start, 8)
    lo, hi = int(row_start[p]), int(row_start[p + 1])
    local_ptr = indptr[lo: hi + 1] - indptr[lo]
    bd_np, _ = tiled_base_host(local_ptr)
    bd = np.zeros((r_max, 2), np.int32)
    bd[: bd_np.shape[0]] = bd_np
    start, width = tiled_rowmap_host(local_ptr)
    src = torch.from_numpy(indices[int(indptr[lo]): int(indptr[hi])].astype(np.int32))
    tiles = build_tiled_device(src.to(dev), torch.from_numpy(start).to(dev),
                               torch.from_numpy(width).to(dev))
    if tiles.shape[0] < m_max:
        tiles = torch.cat([tiles, torch.zeros((m_max - tiles.shape[0], LANE),
                                              dtype=tiles.dtype, device=dev)])
    return TiledShardedTopology(torch.from_numpy(bd).to(dev), tiles, rs)


# -- the owner-masked draw (K13b) ----------------------------------------------

def _owner_window(row_start: torch.Tensor, p: int) -> Tuple[int, int]:
    return int(row_start[p]), int(row_start[p + 1])


def sample_layer_partial_plain(indptr_blk, indices_blk, start: int, end: int, cur, cur_valid,
                               k: int, key):
    """Plain torch K13b over a flat block: the port's ``sample_layer_plain``
    with the owner mask — neighbors for the frontier rows in ``[start,
    end)``, degree 0 elsewhere, neighbor 0 on invalid lanes, valid as int32."""
    r_max = indptr_blk.shape[0] - 1
    local = cur.to(torch.int64) - start
    mine = cur_valid & (local >= 0) & (cur.to(torch.int64) < end)
    s = torch.clamp(local, 0, r_max - 1)
    ptr = indptr_blk[s]
    deg = torch.where(mine, (indptr_blk[s + 1] - ptr).to(torch.int32), 0)
    pos, valid = fisher_yates_positions(key, deg, k)
    flat = torch.clamp(ptr[:, None].to(torch.int64) + pos, 0, indices_blk.shape[0] - 1)
    nbrs = torch.where(valid, indices_blk[flat], 0)
    return nbrs.to(torch.int32), valid.to(torch.int32)


def tiled_sample_layer_partial_plain(bd_blk, tiles_blk, start: int, end: int, cur, cur_valid,
                                     k: int, key):
    """Plain torch K13b over a tiled block: the tiled draw with the owner
    mask (same draw as the flat form on the same key)."""
    local = cur.to(torch.int64) - start
    mine = cur_valid & (local >= 0) & (cur.to(torch.int64) < end)
    both = bd_blk[torch.clamp(local, 0, bd_blk.shape[0] - 1)]
    base, deg = both[:, 0], torch.where(mine, both[:, 1], 0)
    pos, valid = fisher_yates_positions(key, deg, k)
    rows = torch.clamp(base.to(torch.int64)[:, None] + (pos >> 7), 0, tiles_blk.shape[0] - 1)
    nbrs = torch.where(valid, tiles_blk[rows, (pos & (LANE - 1)).to(torch.int64)], 0)
    return nbrs.to(torch.int32), valid.to(torch.int32)


def _stack_slab(nbrs, valid, groups: int):
    """``[G, 2, w, k]``: each group's neighbors, then its int32 flags."""
    W, k = nbrs.shape
    w = W // groups
    return torch.stack([nbrs.view(groups, w, k), valid.view(groups, w, k)], dim=1)


def _launch_partial(kind, a, b, start, end, cur, cur_valid, k, key, groups):
    for t, name in ((a, "graph block"), (b, "graph block"), (cur, "frontier")):
        if t.dtype != torch.int32:
            raise TypeError(f"the sharded sampling kernel takes int32 {name}; got {t.dtype}")
    if int(k) > _kernels.SAMPLE_KMAX:
        raise ValueError(f"the sampling kernel takes k <= {_kernels.SAMPLE_KMAX}; got {k}")
    a, b, cur, cur_valid = a.contiguous(), b.contiguous(), cur.contiguous(), cur_valid.contiguous()
    W = cur.shape[0]
    w = W // groups
    slab = torch.empty((groups, 2, w, k), dtype=torch.int32, device=cur.device)
    if W == 0 or k == 0:
        return slab
    n_rows = a.shape[0] if kind == "tiled" else a.shape[0] - 1
    _kernels.launch("sharded_sample_" + kind, a.data_ptr(), b.data_ptr(), b.shape[0], n_rows,
                    int(start), int(end), cur.data_ptr(), cur_valid.data_ptr(), W, int(k),
                    int(key[0]), int(key[1]), w, 2 * w * k, slab.data_ptr(),
                    slab[0, 1].data_ptr(), _kernels.stream_of(cur))
    return slab


def _check_groups(cur, groups: int) -> None:
    if groups < 1 or cur.shape[0] % groups:
        raise ValueError(f"a frontier of {cur.shape[0]} rows does not split into {groups} "
                         "groups")


def sample_layer_partial_slab(indptr_blk, indices_blk, start: int, end: int, cur, cur_valid,
                              k: int, key, groups: int = 1):
    """`sample_layer_partial` written as one stacked int32 slab ``[G, 2, w,
    k]`` (``G = groups``, ``w = W / G``): group g's neighbors at ``[g, 0]``,
    its flags at ``[g, 1]``, the layout one collective sum takes. Kernel
    K13b (``sharded_sample_flat``) writes it in place on CUDA tensors; on
    CPU tensors the plain version's pair is stacked."""
    _check_layer_args(cur, cur_valid, k, (indptr_blk, indices_blk))
    _check_groups(cur, groups)
    if cur.is_cuda:
        return _launch_partial("flat", indptr_blk, indices_blk, start, end, cur, cur_valid, k,
                               key, groups)
    return _stack_slab(*sample_layer_partial_plain(indptr_blk, indices_blk, start, end, cur,
                                                   cur_valid, k, key), groups)


def tiled_sample_layer_partial_slab(bd_blk, tiles_blk, start: int, end: int, cur, cur_valid,
                                    k: int, key, groups: int = 1):
    """`sample_layer_partial_slab` over a tiled block (kernel K13b,
    ``sharded_sample_tiled``, on CUDA tensors)."""
    _check_layer_args(cur, cur_valid, k, (bd_blk, tiles_blk))
    _check_groups(cur, groups)
    if cur.is_cuda:
        return _launch_partial("tiled", bd_blk, tiles_blk, start, end, cur, cur_valid, k, key,
                               groups)
    return _stack_slab(*tiled_sample_layer_partial_plain(bd_blk, tiles_blk, start, end, cur,
                                                         cur_valid, k, key), groups)


def sample_layer_partial(indptr_blk, indices_blk, start: int, end: int, cur, cur_valid,
                         k: int, key):
    """This shard's un-reduced contribution to a one-hop sample over a flat
    block of global rows ``[start, end)``: ``(nbrs [W, k] int32, valid [W, k]
    int32)``, the two halves of `sample_layer_partial_slab`'s ``[1, 2, W,
    k]``. Kernel K13b (``sharded_sample_flat``) on CUDA tensors,
    `sample_layer_partial_plain` on CPU tensors."""
    slab = sample_layer_partial_slab(indptr_blk, indices_blk, start, end, cur, cur_valid, k, key)
    return slab[0, 0], slab[0, 1]


def tiled_sample_layer_partial(bd_blk, tiles_blk, start: int, end: int, cur, cur_valid,
                               k: int, key):
    """`sample_layer_partial` over a tiled block: kernel K13b
    (``sharded_sample_tiled``) on CUDA tensors, the plain version on CPU
    tensors."""
    slab = tiled_sample_layer_partial_slab(bd_blk, tiles_blk, start, end, cur, cur_valid, k, key)
    return slab[0, 0], slab[0, 1]


def _psum_assemble(slab, group):
    """Owner-exclusive full assembly of a stacked ``[..., 2, w, k]`` slab:
    shard contributions are zeros off the owner, so one sum over the
    striping group IS the gather. Returns ``(nbrs, valid > 0)``."""
    slab = collectives.allreduce_sum(slab, group)
    return slab[..., 0, :, :], slab[..., 1, :, :] > 0


def sharded_sample_layer(indptr_blk, indices_blk, row_start, cur, cur_valid, k: int, key, mesh,
                         axis_name="ici") -> Tuple[torch.Tensor, torch.Tensor]:
    """Collective one-hop sample from a row-sharded flat CSR: ``cur`` (int32
    global ids) and ``cur_valid`` must be identical on every rank of the
    axis. Each shard draws for the frontier rows it owns and one sum of the
    stacked neighbors and flags over the axis assembles ``(nbrs [W, k]
    int32, valid [W, k] bool)`` with global neighbor ids, neighbor 0 where
    invalid — the unsharded `ops.sample.sample_layer`'s draw on its valid
    lanes."""
    p, _, group = _axis(mesh, axis_name)
    start, end = _owner_window(row_start, p)
    slab = sample_layer_partial_slab(indptr_blk, indices_blk, start, end, cur, cur_valid, k, key)
    return _psum_assemble(slab[0], group)


def tiled_sharded_sample_layer(bd_blk, tiles_blk, row_start, cur, cur_valid, k: int, key, mesh,
                               axis_name="ici") -> Tuple[torch.Tensor, torch.Tensor]:
    """`sharded_sample_layer` over the TILE block layout: same contract,
    same draws on the same key."""
    p, _, group = _axis(mesh, axis_name)
    start, end = _owner_window(row_start, p)
    slab = tiled_sample_layer_partial_slab(bd_blk, tiles_blk, start, end, cur, cur_valid, k, key)
    return _psum_assemble(slab[0], group)


def _grouped_collective_sample(partial_fn, cur, cur_valid, k: int, mesh, axes, group_axis: str,
                               via: str):
    """The grouped draw both block layouts ride: all-gather the frontiers
    and their flags over ``group_axis``, draw once at the gathered width
    through ``partial_fn(all_cur, all_valid, G) -> [G, 2, w, k]`` (K13b over
    this shard's owner window, writing each group's neighbors and int32
    flags as one stacked slab), then hand each group its own ``[w, k]``
    pair: ``via="scatter"`` sends the slab through
    `collectives.reduce_scatter_sum` over ``group_axis`` (one all-to-all,
    then one K13c int32 unpack) and sums its ``[2, w, k]`` over the other
    striping axes in one all-reduce; ``via="psum"`` sums the whole slab
    over every striping axis in one all-reduce and takes this group's
    ``[2, w, k]``. The flags stay int32 through the sums, as the JAX
    package's psum of int32 flags, and become bool at the end."""
    if via not in ("scatter", "psum"):
        raise ValueError(f"unknown via {via!r}")
    me, G, group = _axis(mesh, group_axis)
    all_cur = collectives.allgather(cur, group).reshape(-1)
    all_valid = collectives.allgather(cur_valid, group).reshape(-1)
    slab = partial_fn(all_cur, all_valid, G)
    if via == "psum" or group_axis not in axes:
        nbrs, valid = _psum_assemble(slab, mesh.group(axes))
        return nbrs[me], valid[me]
    own = collectives.reduce_scatter_sum(slab, group)
    other = tuple(a for a in axes if a != group_axis)
    if other:
        return _psum_assemble(own, mesh.group(other))
    return own[0], own[1] > 0


def sharded_sample_layer_grouped(indptr_blk, indices_blk, row_start, cur, cur_valid, k: int, key,
                                 mesh, axes, group_axis: str = "host", via: str = "scatter"):
    """`sharded_sample_layer` for frontiers that DIFFER across
    ``group_axis`` (one of the striping ``axes``, typically "host": each
    host samples its own seeds): ``cur`` and ``cur_valid`` are identical on
    the ranks of the other striping axes. Returns this rank's ``(nbrs [W, k]
    int32, valid [W, k] bool)`` — on its valid lanes the unsharded draw of
    its own frontier with the same key. The grouped machinery and both
    ``via`` spellings: `_grouped_collective_sample`."""
    axes = _axes(axes)
    start, end = _owner_window(row_start, mesh.index(axes))

    def partial_fn(all_cur, all_valid, groups):
        return sample_layer_partial_slab(indptr_blk, indices_blk, start, end, all_cur, all_valid,
                                         k, key, groups)

    return _grouped_collective_sample(partial_fn, cur, cur_valid, k, mesh, axes, group_axis, via)


def tiled_sharded_sample_layer_grouped(bd_blk, tiles_blk, row_start, cur, cur_valid, k: int, key,
                                       mesh, axes, group_axis: str = "host",
                                       via: str = "scatter"):
    """`sharded_sample_layer_grouped` over the TILE block layout: the same
    grouped machinery and ``via`` spellings, the same draws."""
    axes = _axes(axes)
    start, end = _owner_window(row_start, mesh.index(axes))

    def partial_fn(all_cur, all_valid, groups):
        return tiled_sample_layer_partial_slab(bd_blk, tiles_blk, start, end, all_cur, all_valid,
                                               k, key, groups)

    return _grouped_collective_sample(partial_fn, cur, cur_valid, k, mesh, axes, group_axis, via)


# -- collective byte models (host only) --------------------------------------------

def gather_comm_bytes(mesh, width: int, dim: int, cold_budget: Optional[int] = None,
                      feat_bytes: int = 4, id_bytes: int = 4,
                      via: str = "scatter") -> Dict[str, float]:
    """Per-gather collective-byte model (ring costs, the conventions of
    `sampling_comm_bytes`) for ONE feature gather of ``width`` ids, the JAX
    package's: on a host mesh the grouped gather (the ids all-gathered over
    host, then the row return trip: ``via="scatter"`` reduce-scatters the
    ``[H, W, D]`` partials over host and sums ``[W, D]`` over ici, ``"psum"``
    sums ``[H * W, D]`` over both), and with ``cold_budget`` the hot/cold
    gather (an ici-only sum at full width, the grouped path at the budget's
    width). ``dcn_bytes`` are the host axis's; on one card they model the
    bytes the host axis's collectives move, since no DCN is there."""
    from .train import mesh_axes

    _, feat_axes, _ = mesh_axes(mesh)
    has_host = "host" in mesh.axis_names
    hostsz = mesh.shape["host"] if has_host else 1
    out = {"ici_bytes": 0.0, "dcn_bytes": 0.0}

    def add_psum(n_elems, axes):
        for a in axes:
            sz = mesh.shape[a]
            if sz == 1:
                continue
            b = 2.0 * (sz - 1) / sz * n_elems * feat_bytes
            out["dcn_bytes" if a == "host" else "ici_bytes"] += b

    def add_grouped_rows(w):
        """Return-trip bytes for a grouped gather of w rows per group."""
        if via == "scatter":
            out["dcn_bytes"] += (hostsz - 1) / hostsz * hostsz * w * dim * feat_bytes
            add_psum(w * dim, ici_axes)
        else:
            add_psum(w * hostsz * dim, feat_axes)

    ici_axes = tuple(a for a in feat_axes if a != "host")
    if not has_host:
        add_psum(width * dim, feat_axes)
    elif cold_budget is None:
        out["dcn_bytes"] += (hostsz - 1) / hostsz * width * hostsz * id_bytes
        add_grouped_rows(width)
    else:
        add_psum(width * dim, ici_axes)
        out["dcn_bytes"] += (hostsz - 1) / hostsz * cold_budget * hostsz * id_bytes
        add_grouped_rows(cold_budget)
    out["total_bytes"] = out["ici_bytes"] + out["dcn_bytes"]
    return out


def sampling_comm_bytes(mesh, sizes: Sequence[int], batch_per_group: int, feature_dim: int = 0,
                        caps: Optional[Sequence[Optional[int]]] = None, id_bytes: int = 4,
                        feat_bytes: int = 4, via: str = "scatter",
                        layout: str = "flat") -> Dict[str, float]:
    """Static per-step collective-traffic model of the sharded-topology
    step, the JAX package's: per rank and step, the ring bytes of every
    hop's ``[W, k]`` neighbor and int32 valid sums over the ici axis
    (``ici_bytes``) and the host axis (``dcn_bytes``: on a host mesh the
    frontier all-gather and the grouped return trip, ``via`` as in
    `gather_comm_bytes`) and, with ``feature_dim > 0``, the fused pipeline's
    per-hop feature gathers and its seed rows. ``hbm_descriptors`` and
    ``hbm_fetch_bytes`` count the shard-local fetches of the block layout
    (128-lane tile rows under "tiled", single elements under "flat") at the
    host-gathered width. A model: gloo's algorithms may move other bytes."""
    from .train import mesh_axes

    _, feat_axes, _ = mesh_axes(mesh)
    has_host = "host" in mesh.axis_names
    hostsz = mesh.shape["host"] if has_host else 1
    out: Dict[str, float] = {"ici_bytes": 0.0, "dcn_bytes": 0.0}
    widths = pad_widths(batch_per_group, sizes, caps)
    ici_axes = tuple(a for a in feat_axes if a != "host")

    def add_psum(n_elems: int, elem_bytes: int, axes=None):
        for a in (feat_axes if axes is None else axes):
            sz = mesh.shape[a]
            if sz == 1:
                continue
            b = 2.0 * (sz - 1) / sz * n_elems * elem_bytes
            out["dcn_bytes" if a == "host" else "ici_bytes"] += b

    def add_all_gather_host(n_elems: int, elem_bytes: int):
        if hostsz > 1:
            out["dcn_bytes"] += (hostsz - 1) / hostsz * n_elems * hostsz * elem_bytes

    def add_grouped(per_group_elems: int, elem_bytes: int):
        if not has_host or via == "psum":
            add_psum(per_group_elems * hostsz, elem_bytes)
        else:
            out["dcn_bytes"] += (hostsz - 1) / hostsz * hostsz * per_group_elems * elem_bytes
            add_psum(per_group_elems, elem_bytes, axes=ici_axes)

    layout = resolve_topology_layout(layout)
    hbm_desc = 0.0
    hbm_fetch = 0.0
    for l, k in enumerate(sizes):
        if has_host:
            add_all_gather_host(widths[l], id_bytes + 1)  # frontier ids + valid
        add_grouped(widths[l] * k, id_bytes + 4)  # nbrs + int32 valid return
        if feature_dim:
            add_grouped(widths[l] * k * feature_dim, feat_bytes)
        w = widths[l] * hostsz
        hbm_desc += w + w * k  # degree/base lookup + k-split position fetch
        per_fetch = LANE * id_bytes if layout == "tiled" else id_bytes
        hbm_fetch += w * 8 + w * k * per_fetch
    if feature_dim:
        add_grouped(widths[0] * feature_dim, feat_bytes)  # seed rows
    out["hbm_descriptors"] = hbm_desc
    out["hbm_fetch_bytes"] = hbm_fetch
    out["total_bytes"] = out["ici_bytes"] + out["dcn_bytes"]
    return out

"""Mesh collectives for sharded feature access — the port of
``quiver_tpu/parallel/collectives.py`` (``sharded_gather`` with
``_partial_rows``, ``sharded_gather_grouped``, ``sharded_gather_a2a``,
``sharded_gather_hot_cold``, ``replicated_psum``, ``pad_to_multiple``).

The feature table is row-striped over the mesh's feature axes (``ici``, or
``("host", "ici")`` on a host mesh, flat index ``host_idx * ici + ici_idx``):
shard ``p`` holds rows ``[p * R, (p + 1) * R)`` as its ``[R, D]`` block. A
gather by global id builds each shard's partial (its own rows, zero rows
elsewhere; kernel K13a, ``csrc/gather.cu``) and one all-reduce over the
striping group assembles the rows: exactly one shard owns each id, so the sum
is exact. When the ids differ across the host axis (each host samples its
own seeds), the grouped gather all-gathers them over host, packs the partial
at the gathered width and returns each host its own slab: an all-to-all of
the ``[G, W, D]`` partial and the sum of the ``G`` received slabs in group
order (kernel K13c, ``csrc/collective.cu``), then the sum over ici. The
hot/cold gather serves a per-host replicated hot prefix over ici alone and
sends only a compacted budget of cold ids through the grouped gather
(kernel K13d: the compaction and the merge back).

Every exchange with the other ranks goes through one of the module-level
wrappers `allreduce_sum`, `allgather`, `all_to_all` and `allreduce_max`
(`COLLECTIVES`), and the port calls them through this module, so one patch
of these names sees every collective.

Everything here runs on one rank of a `parallel.train.Mesh`, inside
`parallel.train.run_ranks` (or one process per GPU under
``torch.distributed``): every rank of the group must make the same calls in
the same order, as every device of a JAX ``shard_map`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels

# the wrappers through which every exchange with the other ranks goes
COLLECTIVES = ("allreduce_sum", "allgather", "all_to_all", "allreduce_max")

# what one all-reduce sums, and as what: floats as floats (so -0.0 plus the
# other shards' +0.0 gives +0.0, as XLA's psum), integers and bool partials
# as integers of the same width; each partial has one nonzero owner, so
# every sum is exact
SUM_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int8)


def allreduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (a ``torch.distributed``
    ``ProcessGroup``; the port's rank threads use gloo) and return it: the
    JAX package's ``lax.psum``. A group of one rank leaves ``t`` as it is,
    as a psum over an axis of size 1 does."""
    return _allreduce(t, group, dist.ReduceOp.SUM, "allreduce_sum")


def allreduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` replaced in place by its elementwise maximum over ``group``
    and returned: the JAX package's ``lax.pmax``."""
    return _allreduce(t, group, dist.ReduceOp.MAX, "allreduce_max")


def _allreduce(t, group, op, name):
    if t.dtype not in SUM_DTYPES:
        raise TypeError(f"{name} takes {SUM_DTYPES}; got {t.dtype}")
    if group.size() == 1:
        return t
    if not t.is_contiguous():
        raise ValueError(f"{name} reduces a contiguous tensor in place")
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    group.allreduce([t], opts).wait()
    return t


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo moves it: bool as its int8 bytes (gloo has no bool)."""
    if t.dtype == torch.bool:
        return t.view(torch.int8)
    if t.dtype not in SUM_DTYPES:
        raise TypeError(f"the collectives move {SUM_DTYPES} or bool; got {t.dtype}")
    return t


def allgather(t: torch.Tensor, group) -> torch.Tensor:
    """``[G, *t.shape]``: every rank's ``t`` stacked in group order, the JAX
    package's ``lax.all_gather`` (untiled). A group of one rank gives
    ``t[None]``."""
    if group.size() == 1:
        return t[None]
    src = _wire(t.contiguous()).reshape(-1)
    out = torch.empty(group.size() * src.numel(), dtype=src.dtype, device=src.device)
    group._allgather_base(out, src).wait()
    out = out.view((group.size(),) + tuple(t.shape))
    return out.view(t.dtype) if t.dtype == torch.bool else out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all of the ``[G, ...]`` slabs of ``t``: rank ``r``'s slab
    ``j`` lands as slab ``r`` of rank ``j``'s result. A group of one rank
    gives ``t``."""
    if t.dim() == 0 or t.shape[0] != group.size():
        raise ValueError(f"all_to_all takes [G, ...] slabs with G = {group.size()}; got "
                         f"{tuple(t.shape)}")
    if group.size() == 1:
        return t
    src = _wire(t.contiguous())
    out = torch.empty_like(src)
    group.alltoall_base(out, src, [], [], dist.AllToAllOptions()).wait()
    return out.view(t.dtype) if t.dtype == torch.bool else out


# -- K13c: the grouped unpack ------------------------------------------------------------

# element type -> (the kernel's type code, launch variant); csrc/collective.cu
_UNPACK_TYPES = {torch.float32: (0, "float32"), torch.bfloat16: (1, "bfloat16"),
                 torch.int8: (2, "int8"), torch.int32: (3, "int32")}


def grouped_unpack_plain(slabs: torch.Tensor) -> torch.Tensor:
    """Plain torch K13c: the ``G`` slabs of ``[G, ...]`` summed in group
    order, floats in float32 (bfloat16 rounded once), integers as int32
    narrowed to the slabs' type."""
    acc_dtype = torch.float32 if slabs.dtype.is_floating_point else torch.int32
    acc = slabs[0].to(acc_dtype)
    for g in range(1, slabs.shape[0]):
        acc = acc + slabs[g].to(acc_dtype)
    return acc.to(slabs.dtype)


def grouped_unpack(slabs: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 of the ``[G, ...]`` slabs an `all_to_all` gave
    this rank, in group order: kernel K13c (``grouped_unpack``) on CUDA
    tensors, `grouped_unpack_plain` on CPU tensors. float32, bfloat16, int8
    or int32; with at most one nonzero contributor an element, the sum is
    exact (a ``-0.0`` owner plus the others' ``+0.0`` is ``+0.0``, as XLA's
    psum)."""
    if slabs.dtype not in _UNPACK_TYPES:
        raise TypeError(f"the grouped unpack sums {tuple(_UNPACK_TYPES)}; got {slabs.dtype}")
    if slabs.dim() < 1 or slabs.shape[0] == 0:
        raise ValueError(f"grouped_unpack takes [G, ...] slabs with G >= 1; got "
                         f"{tuple(slabs.shape)}")
    if not slabs.is_cuda:
        return grouped_unpack_plain(slabs)
    slabs = slabs.contiguous()
    out = torch.empty(slabs.shape[1:], dtype=slabs.dtype, device=slabs.device)
    code, variant = _UNPACK_TYPES[slabs.dtype]
    if out.numel():
        _kernels.launch("grouped_unpack", slabs.data_ptr(), slabs.shape[0], out.numel(), code,
                        out.data_ptr(), _kernels.stream_of(slabs), variant=variant)
    return out


def reduce_scatter_sum(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slab of the ``[G, ...]`` slabs summed over ``group``: the
    JAX package's ``lax.psum_scatter(t, axis, scatter_dimension=0,
    tiled=False)``. An `all_to_all` of the slabs, then K13c's unpack sums the
    ``G`` received slabs in group order on the card."""
    if group.size() == 1:
        return t[0]
    return grouped_unpack(all_to_all(t, group))


# -- axes ------------------------------------------------------------------------------

def _axes(axis_name) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _axis(mesh, axis_name):
    """(shard index, shard count, group) of one mesh axis or of a tuple of
    axes (indexed flat, major to minor: the block order of
    ``P(("host", "ici"))``)."""
    axes = _axes(axis_name)
    return mesh.index(axes), mesh.axis_size(axes), mesh.group(axes)


# -- K13a: one shard's partial ------------------------------------------------------------

def _check_ids(ids: torch.Tensor) -> None:
    if ids.dtype == torch.int64:
        raise TypeError("the sharded gathers take int32 ids; int64 ids (tables past 2^31 rows) "
                        "are not ported (ROADMAP A3)")


def partial_rows_plain(table_block: torch.Tensor, ids: torch.Tensor, shard: int) -> torch.Tensor:
    """Plain torch K13a: this shard's rows for global ``ids`` (``ids -
    shard * R`` in ``[0, R)``), zero rows elsewhere — the ``where``/``take``
    form of the JAX package's ``_partial_rows``."""
    R = table_block.shape[0]
    local = ids.to(torch.int64) - shard * R
    in_range = (local >= 0) & (local < R)
    if R == 0:
        return torch.zeros((ids.shape[0], table_block.shape[1]), dtype=table_block.dtype,
                           device=table_block.device)
    rows = table_block[torch.clamp(local, 0, R - 1)]
    return torch.where(in_range[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))


_ELEM_VARIANT = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}


def partial_rows(table_block: torch.Tensor, ids: torch.Tensor, shard: int) -> torch.Tensor:
    """This shard's un-reduced contribution to a row gather, ``[W, D]``:
    kernel K13a (``sharded_rows``) on CUDA tensors, `partial_rows_plain` on
    CPU tensors. ``table_block`` is float32, bfloat16 or an int8 payload;
    ``ids`` ``[W]`` int32 global ids."""
    if table_block.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table_block [R, D] and ids [W] expected; got "
                         f"{tuple(table_block.shape)}, {tuple(ids.shape)}")
    if ids.device != table_block.device:
        raise ValueError(f"ids on {ids.device} but the block on {table_block.device}")
    if not table_block.is_cuda:
        return partial_rows_plain(table_block, ids, shard)
    variant = _ELEM_VARIANT.get(table_block.dtype)
    if variant is None:
        raise TypeError(f"the sharded gather kernel copies float32, bfloat16 or int8 rows; "
                        f"got {table_block.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"the sharded gather kernel takes int32 ids; got {ids.dtype}")
    block, ids = table_block.contiguous(), ids.contiguous()
    R, D = block.shape
    out = torch.empty((ids.shape[0], D), dtype=block.dtype, device=block.device)
    if ids.shape[0] == 0 or D == 0:
        return out
    _kernels.launch("sharded_rows", block.data_ptr(), R, D, block.element_size(),
                    ids.data_ptr(), ids.shape[0], int(shard) * R, out.data_ptr(),
                    _kernels.stream_of(block), variant=variant)
    return out


# -- the gathers ------------------------------------------------------------------------

def sharded_gather(table_block: torch.Tensor, ids: torch.Tensor, mesh,
                   axis_name="ici") -> torch.Tensor:
    """Gather rows by *global* id from a row-striped table.

    table_block: this rank's ``[R, D]`` block of the table striped over
    ``axis_name`` — one axis, or a tuple of axes such as ``("host", "ici")``
    whose flat index orders the stripes major to minor (shard ``p`` holds
    rows ``[p * R, (p + 1) * R)``; `train.shard_feature_rows`); ids: ``[W]``
    int32 global ids, identical on every rank of the axes. Returns the
    ``[W, D]`` rows, identical on every rank of the axes; ids no shard holds
    (padding sentinels, ids past the table) give zero rows. ``mesh`` is this
    rank's `train.Mesh`."""
    _check_ids(ids)
    shard, _, group = _axis(mesh, axis_name)
    return allreduce_sum(partial_rows(table_block, ids, shard), group)


def sharded_gather_grouped(table_block: torch.Tensor, ids: torch.Tensor, mesh, feat_axes,
                           group_axis: str = "host", via: str = "scatter") -> torch.Tensor:
    """`sharded_gather` for id lists that DIFFER across ``group_axis`` (one
    of the table's striping axes, typically "host"): the lists are
    all-gathered over ``group_axis`` and gathered once for all groups; each
    rank gets the ``[W, D]`` rows of its own ``ids``.

    - ``via="scatter"`` (default): K13a's partial at the gathered width
      ``G * W``, its ``[G, W, D]`` slabs reduce-scattered over
      ``group_axis`` (`reduce_scatter_sum`: an all-to-all, then K13c's
      unpack), then summed over the other striping axes;
    - ``via="psum"``: the full sum over every striping axis at width
      ``G * W``, then this rank's slice.

    When ``group_axis`` is not a striping axis, every member of its group
    holds the same partials, so the psum spelling is the one that counts
    each row once. Both spellings give identical rows."""
    if via not in ("scatter", "psum"):
        raise ValueError(f"unknown via {via!r}")
    _check_ids(ids)
    axes = _axes(feat_axes)
    me, G, group = _axis(mesh, group_axis)
    all_ids = allgather(ids, group)  # [G, W], identical across the group
    w = ids.shape[0]
    if via == "psum" or group_axis not in axes:
        rows = sharded_gather(table_block, all_ids.reshape(-1), mesh, axes)
        return rows.view(G, w, -1)[me]
    shard, _, _ = _axis(mesh, axes)
    rows = partial_rows(table_block, all_ids.reshape(-1), shard)
    own = reduce_scatter_sum(rows.view(G, w, -1), group)
    other = tuple(a for a in axes if a != group_axis)
    if other:
        own = allreduce_sum(own, mesh.group(other))
    return own


def sharded_gather_a2a(table_block: torch.Tensor, ids: torch.Tensor, mesh,
                       axis_name: str = "ici") -> torch.Tensor:
    """Per-rank-request gather: each rank of ``axis_name`` asks for its own
    ``ids`` and receives only its own ``[W, D]`` rows, from a table striped
    over that one axis — `sharded_gather_grouped` with ``axis_name`` as both
    the striping and the group axis, which it delegates to."""
    return sharded_gather_grouped(table_block, ids, mesh, feat_axes=axis_name,
                                  group_axis=axis_name, via="scatter")


# -- K13d: the hot/cold gather ------------------------------------------------------------

def cold_budget_lanes(w: int, cold_budget) -> int:
    """The cold lanes of a gather of width ``w``: an int as it is, a float
    fraction of ``w`` in 256-lane granules and never above ``w``; a budget
    past ``w`` raises."""
    if isinstance(cold_budget, float):
        cold_budget = min(w, -(-int(w * cold_budget) // 256) * 256)
    cold_budget = int(cold_budget)
    if cold_budget > w:
        raise ValueError(f"cold_budget {cold_budget} exceeds gather width {w}")
    if cold_budget < 0:
        raise ValueError(f"cold_budget {cold_budget} is negative")
    return cold_budget


def cold_compact_plain(ids: torch.Tensor, lo: int, hi: int, budget: int):
    """Plain torch K13d compaction: the stable order of the cold flag (ids in
    ``[lo, hi)``) cut to ``budget`` lanes. Returns ``(sel [budget] int32,
    cold_local [budget] int32, counts [2] int32)``: the lanes in that order
    (cold lanes first, each part in lane order), ``ids[sel] - lo`` on the
    first ``n_cold`` lanes and -1 after them, and ``(n_cold, max(n_cold -
    budget, 0))``."""
    is_cold = (ids.to(torch.int64) >= lo) & (ids.to(torch.int64) < hi)
    n_cold = is_cold.sum(dtype=torch.int32)
    order = torch.argsort(torch.where(is_cold, 0, 1).to(torch.int32), stable=True)
    sel = order[:budget].to(torch.int32)
    lane_ok = torch.arange(budget, dtype=torch.int32, device=ids.device) < n_cold
    cold_local = torch.where(lane_ok, ids[sel.to(torch.int64)] - int(lo), -1).to(torch.int32)
    counts = torch.stack([n_cold, torch.clamp(n_cold - budget, min=0).to(torch.int32)])
    return sel, cold_local, counts


def cold_compact(ids: torch.Tensor, lo: int, hi: int, budget: int):
    """K13d's compaction of a gather's cold ids into ``budget`` lanes (see
    `cold_compact_plain`): kernel ``cold_compact`` (one cooperative launch:
    count, one grid barrier, fill) on CUDA tensors, the plain version on CPU
    tensors."""
    if ids.dim() != 1:
        raise ValueError(f"ids [W] expected; got {tuple(ids.shape)}")
    _check_ids(ids)
    if not 0 <= budget <= ids.shape[0]:
        raise ValueError(f"budget {budget} outside [0, {ids.shape[0]}]")
    if not ids.is_cuda:
        return cold_compact_plain(ids, lo, hi, budget)
    if ids.dtype != torch.int32:
        raise TypeError(f"the compaction kernel takes int32 ids; got {ids.dtype}")
    ids = ids.contiguous()
    W = ids.shape[0]
    sel = torch.empty(budget, dtype=torch.int32, device=ids.device)
    cold_local = torch.empty_like(sel)
    if not W:
        return sel, cold_local, torch.zeros(2, dtype=torch.int32, device=ids.device)
    counts = torch.empty(2, dtype=torch.int32, device=ids.device)  # the kernel writes both
    scratch = torch.empty(_kernels.cold_compact_scratch_len(W), dtype=torch.int32,
                          device=ids.device)
    _kernels.launch("cold_compact", ids.data_ptr(), W, int(lo), int(hi), budget, sel.data_ptr(),
                    cold_local.data_ptr(), counts.data_ptr(), scratch.data_ptr(),
                    _kernels.stream_of(ids))
    return sel, cold_local, counts


_MERGE_VARIANT = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def cold_merge_plain(hot: torch.Tensor, sel: torch.Tensor, cold_rows: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Plain torch K13d merge: ``hot`` with ``cold_rows[j]`` added at row
    ``sel[j]`` for the first ``n_cold`` budget lanes and a zero row added at
    the others (JAX's ``hot.at[sel].add(where(lane_ok, cold, 0))``), in
    float32 rounded once."""
    lane_ok = torch.arange(sel.shape[0], device=sel.device) < counts[0]
    add = torch.where(lane_ok[:, None], cold_rows.to(torch.float32), 0.0)
    out = hot.to(torch.float32).clone()
    s = sel.to(torch.int64)
    out[s] = out[s] + add  # sel holds distinct lanes
    return out.to(hot.dtype)


def cold_merge(hot: torch.Tensor, sel: torch.Tensor, cold_rows: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """K13d's merge of the budget's cold rows into the hot rows, in place on
    ``hot`` (`cold_merge_plain`'s values): kernel ``cold_merge`` (a warp a
    budget lane; ``sel`` holds distinct lanes, so no atomics) on CUDA
    tensors, the plain version (a new tensor) on CPU tensors."""
    if hot.dim() != 2 or cold_rows.shape != (sel.shape[0], hot.shape[1]):
        raise ValueError(f"hot [W, D], sel [B] and cold rows [B, D] expected; got "
                         f"{tuple(hot.shape)}, {tuple(sel.shape)}, {tuple(cold_rows.shape)}")
    if cold_rows.dtype != hot.dtype:
        raise TypeError(f"cold rows {cold_rows.dtype} and hot rows {hot.dtype} differ")
    if not hot.is_cuda:
        return cold_merge_plain(hot, sel, cold_rows, counts)
    variant = _MERGE_VARIANT.get(hot.dtype)
    if variant is None:
        raise TypeError(f"the merge kernel adds float32 or bfloat16 rows; got {hot.dtype}")
    if not hot.is_contiguous():
        raise ValueError("cold_merge adds into a contiguous tensor in place")
    cold_rows, sel = cold_rows.contiguous(), sel.contiguous()
    if sel.shape[0] and hot.shape[1]:
        _kernels.launch("cold_merge", hot.data_ptr(), hot.shape[1], sel.data_ptr(),
                        cold_rows.data_ptr(), counts.data_ptr(), sel.shape[0],
                        int(hot.dtype == torch.bfloat16), _kernels.stream_of(hot),
                        variant=variant)
    return hot


def sharded_gather_hot_cold(hot_block: torch.Tensor, cold_block: torch.Tensor,
                            ids: torch.Tensor, mesh, feat_axes, group_axis: str, hot_rows: int,
                            cold_budget):
    """Grouped gather with a per-host REPLICATED hot prefix — the analog of
    the reference's ``PartitionInfo.replicate`` hot set (its mag240m
    preprocess replicates the hottest rows on every host).

    The table is heat-ordered and split (`train.shard_feature_hot_cold`):
    rows ``< hot_rows`` are replicated per host and striped over the
    non-group feature axes (served by an ici-only `sharded_gather` at full
    width); rows ``>= hot_rows`` are striped over every feature axis. K13d's
    compaction puts the cold ids first, in lane order, and keeps
    ``cold_budget`` lanes (an int, or a float fraction of the width: see
    `cold_budget_lanes`); only those ride `sharded_gather_grouped`, and
    K13d's merge adds them back at their lanes. Ids outside the table
    (padding sentinels) are neither hot nor cold and give zero rows.

    Returns ``(rows [W, D], overflow)``: ``overflow`` (a 0-dim int32 tensor)
    counts the cold ids past the budget, whose rows come back ZERO."""
    axes = _axes(feat_axes)
    ici_axes = tuple(a for a in axes if a != group_axis)
    if not ici_axes:
        raise ValueError("hot/cold gather needs a non-group striping axis")
    _check_ids(ids)
    budget = cold_budget_lanes(ids.shape[0], cold_budget)
    hot_part = sharded_gather(hot_block, ids, mesh, ici_axes)
    n_cold_global = cold_block.shape[0] * mesh.axis_size(axes)
    sel, cold_local, counts = cold_compact(ids, hot_rows, hot_rows + n_cold_global, budget)
    cold_rows = sharded_gather_grouped(cold_block, cold_local, mesh, axes, group_axis)
    out = cold_merge(hot_part, sel, cold_rows, counts)
    return out, counts[1]


def replicated_psum(x: torch.Tensor, mesh, axis_name="dp") -> torch.Tensor:
    """``x`` summed over one mesh axis or a tuple of axes (in place), the JAX
    package's ``lax.psum``."""
    return allreduce_sum(x, _axis(mesh, axis_name)[2])


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad rows so a table splits evenly across shards (host-side helper)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return np.asarray(arr)
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(np.asarray(arr), pad_width)

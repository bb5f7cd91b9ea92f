"""Mesh collectives for sharded feature access — the port of
``quiver_tpu/parallel/collectives.py`` (``sharded_gather`` with
``_partial_rows``, ``replicated_psum``, ``pad_to_multiple``).

The feature table is row-striped over the mesh's ``ici`` axis: shard ``p``
holds rows ``[p * R, (p + 1) * R)`` as its ``[R, D]`` block. A gather by
global id builds each shard's partial (its own rows, zero rows elsewhere)
and one all-reduce over the striping group assembles the rows: exactly one
shard owns each id, so the sum is exact. The partial is kernel K13a
(``csrc/gather.cu``) on CUDA tensors and `partial_rows_plain` on CPU
tensors; the sum is the group's ``allreduce`` (`allreduce_sum`).

Everything here runs on one rank of a `parallel.train.Mesh`, inside
`parallel.train.run_ranks` (or one process per GPU under
``torch.distributed``): every rank of the group must make the same calls in
the same order, as every device of a JAX ``shard_map`` does.

Not ported yet (ROADMAP A16, the host axis): ``sharded_gather_grouped``,
``sharded_gather_a2a`` and ``sharded_gather_hot_cold``, which raise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels

HOST_AXIS_TODO = ("the host axis of the mesh is not ported yet (ROADMAP A16, its next slice: "
                  "the grouped, all-to-all and hot/cold gathers)")

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
    if t.dtype not in SUM_DTYPES:
        raise TypeError(f"allreduce_sum takes {SUM_DTYPES}; got {t.dtype}")
    if group.size() == 1:
        return t
    if not t.is_contiguous():
        raise ValueError("allreduce_sum sums a contiguous tensor in place")
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    group.allreduce([t], opts).wait()
    return t


def _axis(mesh, axis_name):
    """(shard index, shard count, group) of one mesh axis; a tuple of axes
    (a striping over the host axis too) is not ported yet."""
    if not isinstance(axis_name, str):
        names = tuple(axis_name)
        if len(names) != 1:
            raise NotImplementedError(f"striping over {names}: {HOST_AXIS_TODO}")
        axis_name = names[0]
    return mesh.index(axis_name), mesh.axis_size(axis_name), mesh.group(axis_name)


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


def sharded_gather(table_block: torch.Tensor, ids: torch.Tensor, mesh,
                   axis_name="ici") -> torch.Tensor:
    """Gather rows by *global* id from a row-striped table.

    table_block: this rank's ``[R, D]`` block of the table striped over
    ``axis_name`` (shard ``p`` holds rows ``[p * R, (p + 1) * R)``;
    `train.shard_feature_rows`); ids: ``[W]`` int32 global ids, identical on
    every rank of the axis. Returns the ``[W, D]`` rows, identical on every
    rank of the axis; ids no shard holds (padding sentinels, ids past the
    table) give zero rows. ``mesh`` is this rank's `train.Mesh`."""
    shard, _, group = _axis(mesh, axis_name)
    return allreduce_sum(partial_rows(table_block, ids, shard), group)


def sharded_gather_grouped(*args, **kwargs):
    """Not ported yet: the gather for id lists that differ across the host
    axis."""
    raise NotImplementedError(f"sharded_gather_grouped: {HOST_AXIS_TODO}")


def sharded_gather_a2a(*args, **kwargs):
    """Not ported yet: the per-rank-request gather (the grouped gather on
    one axis)."""
    raise NotImplementedError(f"sharded_gather_a2a: {HOST_AXIS_TODO}")


def sharded_gather_hot_cold(*args, **kwargs):
    """Not ported yet: the grouped gather with a replicated hot prefix."""
    raise NotImplementedError(f"sharded_gather_hot_cold: {HOST_AXIS_TODO}")


def replicated_psum(x: torch.Tensor, mesh, axis_name="dp") -> torch.Tensor:
    """``x`` summed over one mesh axis (in place), the JAX package's
    ``lax.psum``."""
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

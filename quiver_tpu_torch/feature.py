"""Feature row gather — the port of the gather in
``quiver_tpu/feature.py`` (``_padded_gather``, ``_padded_gather_ordered``)
and of the in-program gather of ``quiver_tpu/inference.py:make_serve_step``:
``ids -> clip(0, n-1) -> [index_map -> clip(0, R-1)] -> table row``.

On CUDA tensors `gather_rows` launches the kernel of ``csrc/gather.cu``;
on CPU tensors it runs `gather_rows_plain`. The tiered ``Feature`` class
comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernels


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    n = index_map.shape[0] if index_map is not None else table.shape[0]
    idx = torch.clamp(ids.to(torch.int64), 0, n - 1)
    if index_map is not None:
        idx = torch.clamp(index_map[idx].to(torch.int64), 0, table.shape[0] - 1)
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``table[clip(ids)]`` (through ``index_map`` when given) as a
    ``[len(ids), D]`` tensor, bit-equal copies."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table [R, D] and ids [n] expected; got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}")
    if index_map is not None and index_map.dim() != 1:
        raise ValueError("index_map must be [N]")
    devs = {table.device, ids.device} | ({index_map.device} if index_map is not None else set())
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    if not table.is_cuda:
        return gather_rows_plain(table, ids, index_map)
    if table.dtype != torch.float32:
        raise TypeError(f"the gather kernel takes a float32 table; got {table.dtype}")
    for t, name in ((ids, "ids"), (index_map, "index_map")):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"the gather kernel takes int32 {name}; got {t.dtype}")
    table, ids = table.contiguous(), ids.contiguous()
    if index_map is not None:
        index_map = index_map.contiguous()
    R, D = table.shape
    out = torch.empty((ids.shape[0], D), dtype=table.dtype, device=table.device)
    if ids.shape[0] == 0 or D == 0:
        return out
    n_clip = index_map.shape[0] if index_map is not None else R
    _kernels.launch(
        "gather_rows", table.data_ptr(), R, D, ids.data_ptr(), ids.shape[0], n_clip,
        index_map.data_ptr() if index_map is not None else None, out.data_ptr(),
        _kernels.stream_of(table),
    )
    return out

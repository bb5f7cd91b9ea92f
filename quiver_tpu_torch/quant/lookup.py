"""Fused dequant-on-gather lookups for quantized feature tables — the port
of ``quiver_tpu/quant/lookup.py`` (``gather_dequant``,
``quantized_tiered_lookup``, ``sharded_dequant_gather``,
``make_quantized_train_step``).

The gathers read encoded rows and their per-row side entries and decode
in registers (``csrc/dequant.cu``): the float32 table exists nowhere, not
in device memory and not on the host-to-device link. On CUDA tensors each
call is one launch (K9a, K9b) for the fp32, bf16 and int8 codecs; on CPU
tensors the plain versions run (any codec of the registry). The sharded
gather (K9c) packs the encoded rows with K13a, sums them over the mesh's
ici group in their storage width and decodes after the sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..train_programs import TrainPrograms, TrainStep, descend
from .codecs import get_codec

# codec name -> (the kernel's codec id, the payload dtype it decodes)
_KERNEL_CODECS = {"fp32": (0, torch.float32), "bf16": (1, torch.bfloat16),
                  "int8": (2, torch.int8)}


def _side_lookup(idx: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor):
    """Per-lane scale/zero from the full side tables, ``idx`` clipped into
    range (invalid lanes are masked by the caller)."""
    safe = torch.clamp(idx.to(torch.int64), 0, scale.shape[0] - 1)
    return scale[safe], zero[safe]


def _kernel_args(codec, payload: torch.Tensor, scale, zero, ints) -> int:
    """Check what the CUDA kernels take; returns the kernel's codec id."""
    entry = _KERNEL_CODECS.get(codec.name)
    if entry is None or payload.dtype != entry[1]:
        raise TypeError(f"the dequant kernels decode fp32, bf16 and int8 payloads; got codec "
                        f"{codec.name!r} over {payload.dtype}")
    if payload.dim() != 2:
        raise ValueError(f"payload must be [N, D]; got {tuple(payload.shape)}")
    if codec.name == "int8" and (scale is None or zero is None):
        raise ValueError("int8 dequant needs per-row scale and zero tables")
    for t in ((scale, zero) if scale is not None else ()):
        if t.dtype != torch.float32 or t.dim() != 1 or t.device != payload.device:
            raise TypeError("scale and zero must be [N] float32 tensors on the payload's device")
    for t, name in ints:
        if t is not None and (t.dtype != torch.int32 or t.device != payload.device):
            raise TypeError(f"the dequant kernels take int32 {name} on the payload's device")
    return entry[0]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gather_dequant_plain(codec, payload: torch.Tensor, ids: torch.Tensor, scale=None,
                         zero=None, index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of `gather_dequant`."""
    codec = get_codec(codec)
    ids = ids.to(torch.int64)
    if index_map is not None:
        ids = index_map[torch.clamp(ids, 0, index_map.shape[0] - 1)].to(torch.int64)
    q = payload[torch.clamp(ids, 0, payload.shape[0] - 1)]
    if scale is not None:
        return codec.dequant(q, *_side_lookup(ids, scale, zero))
    return codec.dequant(q)


def gather_dequant(codec, payload: torch.Tensor, ids: torch.Tensor, scale=None, zero=None,
                   index_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather and decode from a fully device-resident encoded table (K9a).

    payload: ``[N, D]`` encoded rows; scale/zero: ``[N]`` float32 side
    tables (None for codecs without them); ids: any shape, clipped into
    ``[0, N)`` (into the map first, then the table, when an
    ``index_map`` such as the feature order is given), the clipping of
    ``Feature.lookup_padded``. Returns float32 rows ``[*ids.shape, D]``.
    """
    codec = get_codec(codec)
    if not ids.is_cuda:
        return gather_dequant_plain(codec, payload, ids, scale, zero, index_map)
    kind = _kernel_args(codec, payload, scale, zero, ((ids, "ids"), (index_map, "index_map")))
    N, D = payload.shape
    flat = ids.reshape(-1).contiguous()
    out = torch.empty((flat.shape[0], D), dtype=torch.float32, device=payload.device)
    if flat.shape[0] and D:
        imap = None if index_map is None else index_map.contiguous()
        side = (None, None) if scale is None else (scale.contiguous(), zero.contiguous())
        _kernels.launch("gather_dequant", kind, payload.contiguous().data_ptr(), N, D,
                        flat.data_ptr(), flat.shape[0], N if imap is None else imap.shape[0],
                        _ptr(imap), _ptr(side[0]), _ptr(side[1]), out.data_ptr(),
                        _kernels.stream_of(payload), variant=codec.name)
    return out.reshape(*ids.shape, D)


def sharded_dequant_plain(codec, q: torch.Tensor, ids: torch.Tensor, scale=None,
                          zero=None) -> torch.Tensor:
    """Plain torch K9c decode: the codec's ``dequant`` of the summed payload
    ``q [W, D]`` with side entries at ``clip(ids)``, zeroed where ``ids``
    lies outside ``[0, N)`` (``N = len(scale)``); without side tables the
    plain decode."""
    codec = get_codec(codec)
    if scale is None:
        return codec.dequant(q)
    ok = (ids >= 0) & (ids < scale.shape[0])
    x = codec.dequant(q, *_side_lookup(ids, scale, zero))
    return x * ok[:, None].to(x.dtype)


def sharded_dequant(codec, q: torch.Tensor, ids: torch.Tensor, scale=None,
                    zero=None) -> torch.Tensor:
    """The decode after the sum of a sharded encoded gather (K9c,
    ``sharded_dequant``) on CUDA tensors, `sharded_dequant_plain` on CPU
    tensors: float32 rows ``[W, D]``."""
    codec = get_codec(codec)
    if q.dim() != 2 or ids.shape != q.shape[:1]:
        raise ValueError(f"q [W, D] and ids [W] expected; got {tuple(q.shape)}, "
                         f"{tuple(ids.shape)}")
    if not q.is_cuda:
        return sharded_dequant_plain(codec, q, ids, scale, zero)
    kind = _kernel_args(codec, q, scale, zero, ((ids, "ids"),))
    W, D = q.shape
    out = torch.empty((W, D), dtype=torch.float32, device=q.device)
    if W and D:
        side = (None, None) if scale is None else (scale.contiguous(), zero.contiguous())
        _kernels.launch("sharded_dequant", kind, q.contiguous().data_ptr(), W, D,
                        ids.contiguous().data_ptr(), _ptr(side[0]), _ptr(side[1]),
                        0 if scale is None else scale.shape[0], out.data_ptr(),
                        _kernels.stream_of(q), variant=codec.name)
    return out


def sharded_dequant_gather(codec, payload_block: torch.Tensor, ids: torch.Tensor, mesh,
                           axis_name="ici", scale=None, zero=None) -> torch.Tensor:
    """Global-id gather from an ENCODED table row-striped over ``axis_name``
    (one axis, or a tuple such as ``("host", "ici")`` indexed flat; this
    rank's ``[R, D]`` payload block, `parallel.train.shard_feature_rows` of
    the codec's payload): the quantized twin of
    `parallel.collectives.sharded_gather`. The sum rides the encoded payload
    in its storage width (int8 moves 4x fewer bytes than float32; fp32 and
    bf16 payloads sum as floats, int8 as int8: one shard owns each id, so the
    sum is exact), and the replicated ``[N]`` scale/zero tables apply after
    it (K9c). ``ids`` ``[W]`` int32, identical on every rank of the axis; ids
    outside ``[0, N)`` give zero rows. Returns float32 rows ``[W, D]``."""
    from ..parallel import collectives

    codec = get_codec(codec)
    shard, _, group = collectives._axis(mesh, axis_name)
    q = collectives.allreduce_sum(collectives.partial_rows(payload_block, ids, shard), group)
    return sharded_dequant(codec, q, ids, scale, zero)


def quantized_tiered_lookup_plain(codec, hot_payload: torch.Tensor, mapped: torch.Tensor,
                                  cold_payload: torch.Tensor, cold_pos: torch.Tensor,
                                  scale=None, zero=None) -> torch.Tensor:
    """Plain torch version of `quantized_tiered_lookup`."""
    codec = get_codec(codec)
    H, W = hot_payload.shape[0], mapped.shape[0]
    m = mapped.to(torch.int64)
    valid = m >= 0
    is_hot = valid & (m < H)
    q = torch.zeros((W, hot_payload.shape[1]), dtype=hot_payload.dtype, device=mapped.device)
    q[is_hot] = hot_payload[m[is_hot]]
    if cold_payload.shape[0]:
        p = cold_pos.to(torch.int64)
        keep = (p >= 0) & (p < W)
        q[p[keep]] = cold_payload[keep]
    x = codec.dequant(q, *_side_lookup(m, scale, zero)) if scale is not None else codec.dequant(q)
    return x * valid[:, None].to(x.dtype)


def quantized_tiered_lookup(codec, hot_payload: torch.Tensor, mapped: torch.Tensor,
                            cold_payload: torch.Tensor, cold_pos: torch.Tensor,
                            scale=None, zero=None) -> torch.Tensor:
    """The quantized twin of `pipeline.tiered_lookup` (K9b): the assembly
    stays encoded — hot rows gathered, the staged cold rows (storage dtype,
    from a `TieredFeaturePipeline` over a `QuantizedFeature`) scattered into
    their slots — and each merged row is decoded once, with side entries
    from the ``[N_stored]`` tables at ``clip(mapped)``; lanes with
    ``mapped < 0`` are zeroed. A lane past the hot prefix that no cold row
    covers decodes to the row's zero point (int8: ``-zero * scale``), not
    to 0, as in the reference; the pipeline always covers them."""
    codec = get_codec(codec)
    if mapped.dim() != 1 or cold_pos.dim() != 1 or cold_payload.shape[0] != cold_pos.shape[0]:
        raise ValueError("mapped [W], cold_payload [C, D] and cold_pos [C] expected")
    if not mapped.is_cuda:
        return quantized_tiered_lookup_plain(codec, hot_payload, mapped, cold_payload, cold_pos,
                                             scale, zero)
    kind = _kernel_args(codec, hot_payload, scale, zero, ((mapped, "mapped"),
                                                         (cold_pos, "cold_pos")))
    if cold_payload.dtype != hot_payload.dtype or cold_payload.device != hot_payload.device:
        raise TypeError("cold rows must share the hot table's dtype and device")
    if cold_payload.shape[0] and cold_payload.shape[1] != hot_payload.shape[1]:
        raise ValueError("cold rows and the hot table differ in width")
    W, D = mapped.shape[0], hot_payload.shape[1]
    out = torch.empty((W, D), dtype=torch.float32, device=mapped.device)
    if W and D:
        side = (None, None) if scale is None else (scale.contiguous(), zero.contiguous())
        _kernels.launch("quantized_tiered_lookup", kind, hot_payload.contiguous().data_ptr(),
                        hot_payload.shape[0], D, mapped.contiguous().data_ptr(), W,
                        cold_payload.contiguous().data_ptr(), cold_payload.shape[0],
                        cold_pos.contiguous().data_ptr(), _ptr(side[0]), _ptr(side[1]),
                        0 if scale is None else scale.shape[0], out.data_ptr(),
                        _kernels.stream_of(mapped), variant=codec.name)
    return out


def make_quantized_train_step(model, optimizer, labels, hot_payload: torch.Tensor,
                              scale=None, zero=None, codec="int8"):
    """The quantized twin of `pipeline.make_tiered_train_step`: the same
    ``step(batch, generator=None) -> loss`` over the same `TieredBatch`,
    its rows assembled and decoded by `quantized_tiered_lookup` (K9b), one
    captured graph a ``(W, C_b)`` on the card, eager on the CPU. The step
    carries ``.model`` and ``.optimizer``."""
    codec = get_codec(codec)
    labels = torch.as_tensor(labels).to(hot_payload.device, torch.int64)
    n = labels.shape[0]

    def body(inputs, host, generator):
        adjs, mapped, cold_rows, cold_pos, seeds = inputs
        x = quantized_tiered_lookup(codec, hot_payload, mapped, cold_rows, cold_pos, scale, zero)
        y = labels[torch.clamp(seeds.to(torch.int64), 0, n - 1)]
        return descend(model, optimizer, x, adjs, y, generator)

    programs = TrainPrograms(body, model, optimizer, hot_payload.device,
                             bound=lambda: (hot_payload, scale, zero, labels))

    def step(batch, generator: Optional[torch.Generator] = None):
        return programs((tuple(batch.ds.adjs), batch.mapped, batch.cold_rows, batch.cold_pos,
                         batch.seeds), generator=generator)

    return TrainStep(programs, step)

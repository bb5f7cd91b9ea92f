"""Feature codecs — per-row compression for the tiered feature store, the
port of ``quiver_tpu/quant/codecs.py`` (``QuantizedRows``, ``Codec``,
``Bf16Codec``, ``Int8Codec``, ``CODECS``, ``register_codec``,
``get_codec``).

A codec is a storage layout: every tier (device shard, pinned host tail,
the host-to-device copy) holds encoded rows, and training still consumes
float32 rows, decoded on the card inside the gathers of `quant.lookup`.

Codec contract (duck-typed; see `Codec`):

- ``name``: registry key;
- ``storage_dtype``: torch dtype of the encoded ``[N, D]`` payload (numpy
  has no bfloat16 without ``ml_dtypes``);
- ``bytes_per_elem``, ``side_bytes_per_row`` (int8: float32 scale + zero);
- ``encode(arr) -> QuantizedRows`` on the host, bytes equal to the
  reference's: int8 is numpy as in the reference, bf16 converts with
  ``Tensor.to(torch.bfloat16)`` (round to nearest even, as ``ml_dtypes``);
- ``decode(enc) -> np.ndarray`` the host oracle, float32;
- ``dequant(q, scale, zero)`` the decode on torch tensors. The int8
  decode is sub-then-mul, ``(q - zero) * scale``: a mul-then-add would be
  contracted into an FMA by a compiler and drift an ulp from the host
  decode, which the fused kernels must match bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from ..shard_tensor import normalize_dtype


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class QuantizedRows(NamedTuple):
    """Encoded rows and per-row side tables.

    payload: ``[N, D]`` in the codec's storage dtype (a numpy array, or a
    torch tensor for bfloat16); scale/zero: ``[N]`` float32 per-row affine
    tables, or None for codecs without side tables (fp32, bf16).
    """

    payload: Any
    scale: Optional[Any] = None
    zero: Optional[Any] = None


class Codec:
    """Base codec: the fp32 identity (the baseline row of every byte table
    and the template for custom codecs)."""

    name = "fp32"
    storage_dtype = torch.float32
    bytes_per_elem = 4.0
    side_bytes_per_row = 0.0

    def row_bytes(self, dim: int) -> float:
        """Stored bytes per row (payload + side tables): the unit of the
        hot-cache capacity accounting."""
        return self.bytes_per_elem * dim + self.side_bytes_per_row

    def capacity_multiplier(self, dim: int) -> float:
        """How many encoded rows fit where one fp32 row did."""
        return (4.0 * dim) / self.row_bytes(dim)

    def encode(self, arr) -> QuantizedRows:
        return QuantizedRows(np.ascontiguousarray(_np(arr), np.float32))

    def decode(self, enc: QuantizedRows) -> np.ndarray:
        return np.asarray(_np(enc.payload), np.float32)

    def dequant(self, q: torch.Tensor, scale=None, zero=None) -> torch.Tensor:
        """Decode gathered rows ``q [..., D]`` with per-row side entries
        ``scale``/``zero`` (``[...]``, or None) to float32."""
        return q.to(torch.float32)


class Bf16Codec(Codec):
    """bfloat16 cast: 2x capacity, no side tables, float32's exponent range
    (no overflow); the error is the mantissa rounding (relative ~2^-8)."""

    name = "bf16"
    storage_dtype = normalize_dtype("bfloat16")
    bytes_per_elem = 2.0
    side_bytes_per_row = 0.0

    def encode(self, arr) -> QuantizedRows:
        rows = torch.as_tensor(np.ascontiguousarray(_np(arr), np.float32))
        return QuantizedRows(rows.to(self.storage_dtype))

    def decode(self, enc: QuantizedRows) -> np.ndarray:
        return torch.as_tensor(enc.payload).to("cpu", torch.float32).numpy()


class Int8Codec(Codec):
    """Per-row affine int8: ``x ~ (q - zero) * scale``, q in [-127, 127]
    over the row's [min, max], float32 scale and q-space zero point. 4x
    payload compression; the error per element is about ``span / 508``
    plus a few ulps of the row's magnitude. Constant rows store q = 0,
    scale 1 and zero -value, and decode exactly."""

    name = "int8"
    storage_dtype = torch.int8
    bytes_per_elem = 1.0
    side_bytes_per_row = 8.0  # float32 scale + float32 zero point

    def encode(self, arr) -> QuantizedRows:
        arr = np.ascontiguousarray(_np(arr), np.float32)
        rmin = arr.min(axis=1)
        rmax = arr.max(axis=1)
        span = rmax - rmin
        pos = span > 0
        scale = np.where(pos, span / np.float32(254.0), np.float32(1.0)).astype(np.float32)
        with np.errstate(divide="ignore"):
            inv = np.where(pos, np.float32(254.0) / span, np.float32(0.0)).astype(np.float32)
        q = np.clip(np.rint((arr - rmin[:, None]) * inv[:, None]) - 127.0, -127, 127).astype(np.int8)
        # q-space zero point: decode(-127) lands on ~rmin
        zero = np.where(pos, np.float32(-127.0) - rmin / scale, -rmin).astype(np.float32)
        q[~pos] = 0
        return QuantizedRows(q, scale, zero)

    def decode(self, enc: QuantizedRows) -> np.ndarray:
        q = _np(enc.payload)
        scale = np.asarray(_np(enc.scale), np.float32)
        zero = np.asarray(_np(enc.zero), np.float32)
        return (q.astype(np.float32) - zero[..., None]) * scale[..., None]

    def dequant(self, q: torch.Tensor, scale=None, zero=None) -> torch.Tensor:
        if scale is None or zero is None:
            raise ValueError("int8 dequant needs per-row scale and zero tables")
        return (q.to(torch.float32) - zero[..., None]) * scale[..., None]


CODECS = {c.name: c for c in (Codec(), Bf16Codec(), Int8Codec())}


def register_codec(codec) -> None:
    """Add a custom codec to the registry (overwrites an existing name)."""
    CODECS[codec.name] = codec


def get_codec(codec: Union[str, Codec]):
    """Resolve a codec name (or pass an instance through)."""
    if isinstance(codec, str):
        try:
            return CODECS[codec]
        except KeyError:
            raise ValueError(f"unknown codec {codec!r}; registered: {sorted(CODECS)}") from None
    return codec

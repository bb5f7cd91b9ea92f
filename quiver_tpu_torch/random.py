"""Threefry-2x32 keys and uniforms, bit-equal to ``jax.random``.

The JAX package draws every sample from ``jax.random`` keys (default
``threefry2x32`` implementation with ``jax_threefry_partitionable=True``),
so a sampled batch can only match it bit for bit if this port reproduces
the same generator. A key is a pair of uint32 words held on the host as
Python ints; derivation (``key``, ``fold_in``, ``split``) is host work.
Bits and uniforms for a whole array are computed with plain torch ops
(``random_bits_32``, ``uniform``) on any device; the sampling kernel
computes its ``[k, W]`` uniforms in-kernel from the same two words
(``csrc/threefry.cuh``).

The algorithm follows ``jax/_src/prng.py`` (jax 0.9.0):

- ``threefry_2x32``: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16,
  24), key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``;
- ``key(seed)``: ``(0, seed & 0xFFFFFFFF)`` (x64 off);
- ``fold_in(key, d)``: the hash of the counter pair ``(0, d)``;
- ``split(key, n)``: key ``i`` is the hash pair of counter ``(0, i)``;
- 32-bit random bits at flat index ``i``: ``b1 ^ b2`` of the hash of
  ``(i >> 32, i & 0xFFFFFFFF)``;
- float32 uniform: ``bitcast(bits >> 9 | 0x3F800000) - 1``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """Threefry-2x32 hash of one counter pair, on Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_int(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` as two uint32 words. The JAX package runs
    with x64 off, where the seed is held in 32 bits: the high word is 0
    and the low word is ``seed mod 2**32``."""
    return 0, int(seed) & _M32


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32_int(k[0], k[1], 0, int(data) & _M32)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` as a list of keys."""
    return [threefry2x32_int(k[0], k[1], 0, i) for i in range(int(num))]


def key_data(k: Key) -> np.ndarray:
    """The two words of ``k`` as ``uint32[2]`` (``jax.random.key_data``)."""
    return np.asarray(k, np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k: Key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 over int64 tensors holding uint32 counter words."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def random_bits_32(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as an int64 tensor of uint32
    values (row-major flat counters, partitionable threefry)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` (float32 in ``[0, 1)``)."""
    bits = random_bits_32(k, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0

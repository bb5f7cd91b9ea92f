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
- float32 uniform: ``bitcast(bits >> 9 | 0x3F800000) - 1``, then
  ``max(minval, f * f32(maxval - minval) + minval)`` (``_uniform``), the
  multiply-add rounded once, as XLA contracts it.
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


def hop_keys(k, hops: int) -> list:
    """The sub-key of each hop of a ``hops``-hop draw: ``k, sub = split(k)``
    a hop, as every multi-hop sampler of the JAX package splits. ``k`` may
    instead be a ``[hops, 2]`` tensor of the hops' key words (see
    `hop_key_words`); its rows are then the sub-keys, views a draw kernel
    reads on the device (a captured serve step replays with new words)."""
    if isinstance(k, torch.Tensor):
        if tuple(k.shape) != (hops, 2):
            raise ValueError(f"hop key words must be [{hops}, 2]; got {tuple(k.shape)}")
        return [k[h] for h in range(hops)]
    subs = []
    for _ in range(int(hops)):
        k, sub = split(k)
        subs.append(sub)
    return subs


def hop_key_words(k: Key, hops: int) -> np.ndarray:
    """``uint32[hops, 2]``: the words of each hop's sub-key (`hop_keys`)."""
    return np.asarray(hop_keys(k, hops), np.uint32).reshape(int(hops), 2)


def host_key(k) -> Key:
    """A key as two Python ints: a host key as it is, or a ``uint32[2]``
    tensor of key words on the CPU (a plain draw reads its words; a tensor
    on the card goes to a device-key kernel instead)."""
    if isinstance(k, torch.Tensor):
        if k.is_cuda:
            raise ValueError("key words on the card go to the draw kernels, not the plain draws")
        w = k.reshape(-1).to(torch.int64) & _M32
        return int(w[0]), int(w[1])
    return k


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


def uniform(k: Key, shape: Sequence[int], device="cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=, maxval=)``: float32 in
    ``[minval, maxval)``, by jax's transform ``max(minval, f * f32(maxval -
    minval) + minval)`` of the ``[0, 1)`` value ``f``. XLA contracts the
    multiply-add into one rounding; here the product is exact in float64
    and the sum is rounded to float64, then to float32 (a second rounding
    can differ from a fused one about once in 2^29 values). The Gumbel draw
    of the weighted sampler uses ``minval=1e-20`` and ``maxval=1``, where
    every form is exact: it lifts only ``f == 0``."""
    bits = random_bits_32(k, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    fused = (f.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, fused)

"""Dedup + local-id rewrite ("reindex") — the port of
``quiver_tpu/ops/reindex.py`` (``local_reindex``, ``reindex_single``).

Contract (the JAX package's ``reindex.py:9-22``):

- ``n_id[:n_seed]`` holds the valid seeds verbatim, in order, duplicates
  included; a duplicate keeps its own slot while lookups resolve to the
  first slot holding the value;
- the neighbor values no valid seed holds follow, once each, ascending;
- sentinel ``iinfo(int32).max`` pads ``n_id`` to ``S * (1 + k)``;
- every valid neighbor is rewritten to the canonical local id of its
  value. Invalid lanes of ``local_nbrs`` hold 0 (the JAX package leaves
  unread garbage there).

On CUDA tensors `local_reindex` launches the hash-and-sort kernel of
``csrc/reindex.cu``; on CPU tensors it runs `local_reindex_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels


class ReindexResult(NamedTuple):
    n_id: torch.Tensor         # [S*(1+k)] valid seeds, then new uniques; sentinel pad
    count: torch.Tensor        # 0-dim int32: valid entries of n_id
    local_seeds: torch.Tensor  # [S] output slot of each seed (-1 where invalid)
    local_nbrs: torch.Tensor   # [S, k] canonical local id of each sampled neighbor
    nbr_valid: torch.Tensor    # [S, k] validity mask (from sampling)


def _check(seeds, seed_valid, nbrs, nbr_valid):
    if seeds.dim() != 1 or nbrs.dim() != 2 or nbrs.shape[0] != seeds.shape[0]:
        raise ValueError(f"seeds [S] and nbrs [S, k] expected; got {tuple(seeds.shape)}, "
                         f"{tuple(nbrs.shape)}")
    if seed_valid.shape != seeds.shape or nbr_valid.shape != nbrs.shape:
        raise ValueError("validity masks must match seeds and nbrs")
    if seed_valid.dtype != torch.bool or nbr_valid.dtype != torch.bool:
        raise TypeError("validity masks must be bool")
    if seeds.dtype != nbrs.dtype:
        raise TypeError(f"seeds {seeds.dtype} and nbrs {nbrs.dtype} must share a dtype")
    devs = {t.device for t in (seeds, seed_valid, nbrs, nbr_valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")


def local_reindex_plain(seeds, seed_valid, nbrs, nbr_valid) -> ReindexResult:
    """Plain torch version of the reindex contract."""
    S, k = nbrs.shape
    dev, dt = seeds.device, seeds.dtype
    sentinel = torch.iinfo(dt).max
    seed_slot = torch.cumsum(seed_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    local_seeds = torch.where(seed_valid, seed_slot, -1)
    seed_vals = seeds[seed_valid]
    n_seed = seed_vals.shape[0]
    nb = nbrs[nbr_valid]
    # first slot holding each value: stable sort keeps the lowest slot first
    sorted_vals, perm = torch.sort(seed_vals, stable=True)
    pos = torch.searchsorted(sorted_vals, nb)
    if n_seed:
        pos = pos.clamp(max=n_seed - 1)
        in_seed = sorted_vals[pos] == nb
        seed_id = perm[pos]
    else:
        in_seed = torch.zeros_like(nb, dtype=torch.bool)
        seed_id = pos
    new_vals = torch.unique(nb[~in_seed])  # ascending
    rank = torch.searchsorted(new_vals, nb)
    canon = torch.where(in_seed, seed_id, n_seed + rank).to(torch.int32)
    local_nbrs = torch.zeros((S, k), dtype=torch.int32, device=dev)
    local_nbrs[nbr_valid] = canon
    n_id = torch.full((S * (1 + k),), sentinel, dtype=dt, device=dev)
    n_id[:n_seed] = seed_vals
    n_id[n_seed:n_seed + new_vals.shape[0]] = new_vals
    count = torch.tensor(n_seed + new_vals.shape[0], dtype=torch.int32, device=dev)
    return ReindexResult(n_id, count, local_seeds, local_nbrs, nbr_valid)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _launch_reindex(seeds, seed_valid, nbrs, nbr_valid) -> ReindexResult:
    if seeds.dtype != torch.int32:
        raise TypeError(f"the reindex kernel takes int32 ids; got {seeds.dtype}")
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    nbrs, nbr_valid = nbrs.contiguous(), nbr_valid.contiguous()
    S, k = nbrs.shape
    dev = seeds.device
    W = S * (1 + k)
    H = _next_pow2(max(2 * W, 2))
    P = _next_pow2(max(S * k, 2))
    scratch = torch.empty(3 * H + 2, dtype=torch.int32, device=dev)
    uniq = torch.empty(P, dtype=torch.int32, device=dev)
    n_id = torch.empty(W, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    local_seeds = torch.empty(S, dtype=torch.int32, device=dev)
    local_nbrs = torch.empty((S, k), dtype=torch.int32, device=dev)
    if S == 0:
        count.zero_()
        return ReindexResult(n_id, count, local_seeds, local_nbrs, nbr_valid)
    _kernels.launch(
        "local_reindex", seeds.data_ptr(), seed_valid.data_ptr(), nbrs.data_ptr(),
        nbr_valid.data_ptr(), S, k, scratch.data_ptr(), H, uniq.data_ptr(), P,
        n_id.data_ptr(), count.data_ptr(), local_seeds.data_ptr(),
        local_nbrs.data_ptr(), _kernels.stream_of(seeds),
    )
    return ReindexResult(n_id, count, local_seeds, local_nbrs, nbr_valid)


def local_reindex(seeds, seed_valid, nbrs, nbr_valid) -> ReindexResult:
    """Dedup ``seeds [S]`` + ``nbrs [S, k]`` into ``n_id`` and rewrite the
    neighbors to canonical local ids (see the module docstring)."""
    _check(seeds, seed_valid, nbrs, nbr_valid)
    if seeds.is_cuda:
        return _launch_reindex(seeds, seed_valid, nbrs, nbr_valid)
    return local_reindex_plain(seeds, seed_valid, nbrs, nbr_valid)


def _as_ids(x, dev) -> torch.Tensor:
    return x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=dev)


def reindex_single(seeds, inputs, counts=None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's standalone ``reindex_single``: seeds ``[S]`` and
    their sampled neighbors give ``(n_id, count, local ids of the
    inputs)``. ``inputs`` is a padded ``[S, k]`` matrix (local ids
    ``[S*k]``, row-major) or the flat ragged concatenation, with
    ``counts`` (neighbors per seed) required unless its length divides
    into ``S`` equal rows; the local ids of a ragged input are those of
    its entries, in input order. Ids are cast to int32 when they fit (the
    dtype of K2). Runs on ``seeds``' device when it is a tensor, else on
    ``device`` (default CUDA)."""
    from ..utils import resolve_device

    dev = seeds.device if isinstance(seeds, torch.Tensor) else resolve_device(device)
    seeds, inputs = _as_ids(seeds, dev), _as_ids(inputs, dev)
    S = seeds.shape[0]
    filled = [t for t in (seeds, inputs) if t.numel()]
    lo = min((int(t.min()) for t in filled), default=0)
    hi = max((int(t.max()) for t in filled), default=0)
    dt = torch.int32 if -2**31 <= lo and hi < 2**31 - 1 else torch.int64
    seeds, inputs = seeds.to(dt), inputs.to(dt)
    ones = torch.ones(S, dtype=torch.bool, device=dev)
    if inputs.dim() == 2:
        res = local_reindex(seeds, ones, inputs, torch.ones(inputs.shape, dtype=torch.bool,
                                                            device=dev))
        return res.n_id, res.count, res.local_nbrs.reshape(-1)
    if counts is None:
        if inputs.shape[0] % S != 0:
            raise ValueError(
                f"flat ragged neighbor list (len {inputs.shape[0]}, {S} seeds): pass counts= "
                f"(neighbors per seed) — guessing a uniform [S, k] grid would mis-assign "
                f"neighbors")
        flat = inputs.reshape(S, -1)
        res = local_reindex(seeds, ones, flat, torch.ones(flat.shape, dtype=torch.bool,
                                                          device=dev))
        return res.n_id, res.count, res.local_nbrs.reshape(-1)
    counts = np.asarray(counts if not isinstance(counts, torch.Tensor) else counts.cpu(),
                        np.int64).reshape(-1)
    if counts.shape[0] != S or int(counts.sum()) != inputs.shape[0]:
        raise ValueError(f"counts {counts.shape}/{int(counts.sum())} inconsistent with {S} "
                         f"seeds and {inputs.shape[0]} flat neighbors")
    k = max(int(counts.max()), 1) if S else 1
    mask = torch.from_numpy(np.arange(k)[None, :] < counts[:, None]).to(dev)
    padded = torch.zeros((S, k), dtype=dt, device=dev)
    padded[mask] = inputs  # row-major mask order is the ragged concatenation's
    res = local_reindex(seeds, ones, padded, mask)
    return res.n_id, res.count, res.local_nbrs[mask]

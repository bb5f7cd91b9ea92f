"""Parity of the port's local_reindex (quiver_tpu_torch.ops.reindex) with
quiver_tpu.ops.reindex.local_reindex: n_id (sentinel padding included)
and count bit-equal, local_nbrs bit-equal where the neighbor is valid
(the JAX package leaves garbage in invalid lanes), local_seeds equal.
Cases cover duplicate seeds, invalid seeds, neighbors equal to seeds and
all-invalid rows. The kernel-versus-plain check is in
tests/test_torch_kernels.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quiver_tpu.ops.reindex import local_reindex as jreindex
from quiver_tpu_torch.ops import reindex as treindex

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)


def _case(S, k, n_nodes, seed, dup_seeds=True, invalid_seeds=True):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, n_nodes, S).astype(np.int32)
    if dup_seeds and S > 3:
        seeds[3] = seeds[1]
    seed_valid = np.ones(S, bool)
    if invalid_seeds and S > 5:
        seed_valid[S // 2:] = rng.random(S - S // 2) < 0.5
    nbrs = rng.integers(0, n_nodes, (S, k)).astype(np.int32)
    nbrs[0, 0] = seeds[1]  # a neighbor that a seed holds
    nbr_valid = rng.random((S, k)) < 0.8
    nbr_valid[~seed_valid] = False
    return seeds, seed_valid, nbrs, nbr_valid


def _compare(case):
    seeds, seed_valid, nbrs, nbr_valid = case
    j = jreindex(jnp.asarray(seeds), jnp.asarray(seed_valid), jnp.asarray(nbrs),
                 jnp.asarray(nbr_valid))
    t = treindex.local_reindex(torch.from_numpy(seeds), torch.from_numpy(seed_valid),
                               torch.from_numpy(nbrs), torch.from_numpy(nbr_valid))
    assert t.n_id.dtype == torch.int32 and t.count.dtype == torch.int32
    assert np.array_equal(np.asarray(j.n_id), t.n_id.numpy())
    assert int(j.count) == int(t.count)
    assert np.array_equal(np.asarray(j.local_seeds), t.local_seeds.numpy())
    assert np.array_equal(np.asarray(j.local_nbrs)[nbr_valid], t.local_nbrs.numpy()[nbr_valid])
    return t


@pytest.mark.parametrize("S,k,n_nodes,seed", [
    (8, 4, 30, 0),        # dense overlap: many repeats
    (64, 15, 5000, 1),    # the slice's first hop shape
    (37, 5, 200, 2),      # odd width
    (200, 4, 50, 3),      # more lanes than node ids
])
def test_local_reindex_matches_jax(S, k, n_nodes, seed):
    t = _compare(_case(S, k, n_nodes, seed))
    count = int(t.count)
    assert (t.n_id[count:] == torch.iinfo(torch.int32).max).all()


def test_local_reindex_no_invalid_seeds_and_all_invalid_neighbors():
    seeds, seed_valid, nbrs, nbr_valid = _case(16, 3, 40, 4, invalid_seeds=False)
    _compare((seeds, seed_valid, nbrs, nbr_valid))
    nbr_valid[:] = False
    t = _compare((seeds, seed_valid, nbrs, nbr_valid))
    assert int(t.count) == 16


def test_duplicate_seed_keeps_slot_and_neighbors_resolve_to_first():
    seeds = np.array([4, 9, 4, 2], np.int32)
    nbrs = np.array([[4, 7], [9, 2], [7, 11], [4, 100]], np.int32)
    t = _compare((seeds, np.ones(4, bool), nbrs, np.ones((4, 2), bool)))
    assert t.n_id[:6].tolist() == [4, 9, 4, 2, 7, 11] and t.n_id[6] == 100
    assert t.local_nbrs.tolist() == [[0, 4], [1, 3], [4, 5], [0, 6]]



@pytest.mark.parametrize("S,k", [(64, 32), (683, 3), (2049, 1)])
def test_local_reindex_matches_jax_across_sort_tiles(S, k):
    """S*k at 2,048 and 2,049 lanes, many of them new uniques (ids up to
    5,000): the card kernel's tiles of 1,024 new uniques."""
    t = _compare(_case(S, k, 5000, S + k))
    assert int(t.count) > 1025


def test_local_reindex_matches_jax_when_every_neighbor_is_a_seed():
    seeds, seed_valid, nbrs, nbr_valid = _case(300, 6, 100, 7)
    held = seeds[seed_valid]
    nbrs = held[np.random.default_rng(8).integers(0, held.shape[0], (300, 6))]
    t = _compare((seeds, seed_valid, nbrs, nbr_valid))
    assert int(t.count) == int(seed_valid.sum())


def test_local_reindex_matches_jax_next_to_the_sentinel():
    """Ids in the 40 values below INT32_MAX, and 0."""
    top = np.iinfo(np.int32).max
    seeds, seed_valid, nbrs, nbr_valid = _case(200, 5, 40, 9)
    seeds, nbrs = (top - 1 - seeds).astype(np.int32), (top - 1 - nbrs).astype(np.int32)
    seeds[:2] = (0, top - 1)
    nbrs[:2, 0] = (0, top - 1)
    t = _compare((seeds, seed_valid, nbrs, nbr_valid))
    count = int(t.count)
    assert t.n_id[count - 1] <= top - 1 and (t.n_id[count:] == top).all()

"""Parity of the port's one-hop samplers (quiver_tpu_torch.ops.sample)
with quiver_tpu.ops.sample: the same seeds and key must draw bit-equal
positions, neighbor ids and validity masks, flat and tiled. Inputs come
from numpy with a seed; JAX runs on its CPU backend, the port's plain
torch version on the CPU. The kernel-versus-plain checks run on a card
only (tests/test_torch_kernels.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu.ops import sample as jsample
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops import sample as tsample
from quiver_tpu_torch.utils import CSRTopo

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)


def _graph_with_edge_cases(seed=0):
    """Random graph plus rows of degree 0, degree == k and degree > 128
    (so a row crosses a tile boundary)."""
    rng = np.random.default_rng(seed)
    ei = make_random_graph(200, 2000, seed=seed)
    hub = np.stack([np.full(300, 5), rng.integers(0, 200, 300)])
    exact = np.stack([np.full(4, 7), rng.integers(0, 200, 4)])
    ei = np.concatenate([ei[:, (ei[0] != 5) & (ei[0] != 7) & (ei[0] != 9)], hub, exact], axis=1)
    return ei, 200  # node 9 keeps degree 0


def _key(seed, call):
    return (jax.random.fold_in(jax.random.key(seed), call),
            qrandom.fold_in(qrandom.key(seed), call))


@pytest.mark.parametrize("k", [1, 4, 15])
@pytest.mark.parametrize("B", [1, 7, 64])
def test_fisher_yates_positions_bit_equal(k, B):
    rng = np.random.default_rng(B * 100 + k)
    deg = rng.integers(0, 300, B).astype(np.int32)
    deg[0] = 0
    if B > 2:
        deg[1] = k
        deg[2] = 200
    jk, tk = _key(11, B + k)
    jp, jv = jsample.fisher_yates_positions(jk, jnp.asarray(deg), k)
    tp, tv = tsample.fisher_yates_positions(tk, torch.from_numpy(deg), k)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("k", [4, 15])
def test_one_hop_sample_bit_equal(layout, k):
    ei, n = _graph_with_edge_cases()
    rng = np.random.default_rng(k)
    seeds = rng.integers(0, n, 37).astype(np.int32)
    seeds[:4] = [5, 7, 9, 0]   # deg > 128, deg == k (k=4), deg 0
    seeds[4] = n + 50          # out of range: clipped like the reference
    valid = np.ones(37, bool)
    valid[5:8] = False         # invalid seeds draw nothing
    jk, tk = _key(3, k)
    jt, tt = JCSRTopo(edge_index=ei, num_nodes=n), CSRTopo(edge_index=ei, num_nodes=n)
    if layout == "flat":
        jg, tg = jt.to_device(), tt.to_device("cpu")
        jn, jv = jsample.sample_layer(*jg, jnp.asarray(seeds), jnp.asarray(valid), k, jk)
        tn, tv = tsample.sample_layer(*tg, torch.from_numpy(seeds), torch.from_numpy(valid), k, tk)
    else:
        jg, tg = jt.to_device_tiled(), tt.to_device_tiled("cpu")
        assert np.array_equal(np.asarray(jg[1]), tg[1].numpy())
        jn, jv = jsample.tiled_sample_layer(*jg, jnp.asarray(seeds), jnp.asarray(valid), k, jk)
        tn, tv = tsample.tiled_sample_layer(*tg, torch.from_numpy(seeds), torch.from_numpy(valid), k, tk)
    assert tn.dtype == torch.int32 and tv.dtype == torch.bool
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())  # invalid lanes too
    assert tv[0].all() and not tv[2].any() and not tv[5:8].any()


def test_flat_and_tiled_draw_identical():
    ei, n = _graph_with_edge_cases(1)
    topo = CSRTopo(edge_index=ei, num_nodes=n)
    seeds = torch.arange(0, 64, dtype=torch.int32)
    valid = torch.ones(64, dtype=torch.bool)
    key = qrandom.key(5)
    a, av = tsample.sample_layer(*topo.to_device("cpu"), seeds, valid, 10, key)
    b, bv = tsample.tiled_sample_layer(*topo.to_device_tiled("cpu"), seeds, valid, 10, key)
    assert torch.equal(av, bv) and torch.equal(a[av], b[bv])


def test_pad_widths_and_tile_build_match():
    assert tsample.pad_widths(64, [15, 10, 5]) == jsample.pad_widths(64, [15, 10, 5])
    assert tsample.pad_widths(8, [4, 4], [20, None]) == jsample.pad_widths(8, [4, 4], [20, None])
    ei, n = _graph_with_edge_cases(2)
    jt = JCSRTopo(edge_index=ei, num_nodes=n)
    bd, tiles = tsample.build_tiled_host(jt.indptr, jt.indices)
    jbd, jtiles = jsample.build_tiled_host(jt.indptr, jt.indices)
    assert np.array_equal(bd, jbd) and np.array_equal(tiles, jtiles)
    assert tiles.dtype == np.int32


def test_wrappers_reject_bad_inputs():
    topo = CSRTopo(edge_index=make_random_graph(20, 50), num_nodes=20)
    bd, tiles = topo.to_device_tiled("cpu")
    seeds = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsample.tiled_sample_layer(bd, tiles, seeds, torch.ones(4, dtype=torch.int32), 2, qrandom.key(0))
    with pytest.raises(ValueError):
        tsample.tiled_sample_layer(bd, tiles, seeds, torch.ones(3, dtype=torch.bool), 2, qrandom.key(0))


def test_topology_helpers_and_datasets_match_reference():
    from quiver_tpu import datasets as jdatasets
    from quiver_tpu.utils import _best_id_dtype as j_best, parse_size as j_parse
    from quiver_tpu_torch import datasets as tdatasets
    from quiver_tpu_torch.utils import _best_id_dtype, parse_size

    for sz in (4096, "200M", "1.5g", "4GB", 3.0):
        assert parse_size(sz) == j_parse(sz)
    with pytest.raises(ValueError):
        parse_size("12XB")
    assert _best_id_dtype(2**31 - 2) == j_best(2**31 - 2) == np.int32
    assert _best_id_dtype(2**31) == j_best(2**31) == np.int64
    ei, n = _graph_with_edge_cases(4)
    jt, tt = JCSRTopo(edge_index=ei, num_nodes=n + 3), CSRTopo(edge_index=ei, num_nodes=n + 3)
    assert np.array_equal(jt.indptr, tt.indptr) and np.array_equal(jt.indices, tt.indices)
    assert tt.node_count == n + 3 and tt.edge_count == ei.shape[1]
    assert np.array_equal(jt.degree, tt.degree)
    for a, b in zip(jdatasets.powerlaw_csr(500, 6000, seed=2), tdatasets.powerlaw_csr(500, 6000, seed=2)):
        assert np.array_equal(a, b)
    for a, b in zip(jdatasets.products_like(scale=2e-4, seed=1), tdatasets.products_like(scale=2e-4, seed=1)):
        assert np.array_equal(a, b)

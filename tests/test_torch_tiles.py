"""Parity of the port's tile build (K12's plain version, the row map, the
three tile tables of CSRTopo and TemporalTiledGraph) and of the uniform
draw at fanouts above 32 with quiver_tpu. Graphs come from numpy with a
seed, plus the JAX suite's degree mix of empty rows and hubs; JAX runs on
its CPU backend, the port's plain torch versions on the CPU. Every bar is
bit-equality (ids, float32 weights and timestamps, masks). The kernels
themselves are held against these plain versions on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu.ops import sample as jsample
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu.workloads.temporal import TemporalTiledGraph as JTemporalTiledGraph
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops import sample as tsample
from quiver_tpu_torch.utils import CSRTopo, show_tensor_info
from quiver_tpu_torch.workloads import TemporalTiledGraph

from conftest import make_random_graph

torch.set_num_threads(1)

# the JAX suite's degree mix (tests/test_sampler.py): empty rows, rows
# crossing tile boundaries and a hub of many tiles
DEGS = [0, 5, 0, 300, 1, 128, 129, 0, 1000, 2]


def _mixed_csr(seed=9):
    indptr = np.zeros(len(DEGS) + 1, np.int64)
    np.cumsum(DEGS, out=indptr[1:])
    rng = np.random.default_rng(seed)
    return indptr, rng.integers(0, len(DEGS), indptr[-1]).astype(np.int64)


def _random_csr(seed=3):
    topo = JCSRTopo(edge_index=make_random_graph(120, 1500, seed=seed))
    return np.asarray(topo.indptr, np.int64), np.asarray(topo.indices, np.int64)


def _empty_csr():
    return np.zeros(5, np.int64), np.zeros(0, np.int64)


CASES = {"random": _random_csr, "mixed": _mixed_csr, "empty": _empty_csr}


def _payloads(indices, seed):
    """int32 ids, float32 weights (some zero, some -0.0) and timestamps."""
    rng = np.random.default_rng(seed)
    w = rng.random(indices.shape[0], dtype=np.float32)
    w[::7] = 0.0
    w[3::11] = -0.0
    ts = rng.uniform(0.0, 50.0, indices.shape[0]).astype(np.float32)
    return {"ids": indices.astype(np.int32), "weights": w, "timestamps": ts}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowmap_bit_equal(case):
    indptr, _ = CASES[case]()
    js, jw = jsample.tiled_rowmap_host(indptr)
    ts, tw = tsample.tiled_rowmap_host(indptr)
    assert ts.dtype == np.int64 and tw.dtype == np.int32
    assert np.array_equal(js, ts) and np.array_equal(jw, tw)
    assert ts.shape[0] == tsample.tiled_base_host(indptr)[1]


def test_rowmap_hub_spans_its_tile_rows():
    indptr, _ = _mixed_csr()
    start, width = tsample.tiled_rowmap_host(indptr)
    bd, _ = tsample.tiled_base_host(indptr)
    base, n_rows = int(bd[8, 0]), -(-1000 // tsample.LANE)  # the 1000-edge hub
    assert np.array_equal(start[base:base + n_rows], indptr[8] + 128 * np.arange(n_rows))
    assert width[base:base + n_rows].tolist() == [128] * 7 + [1000 - 7 * 128]


@pytest.mark.parametrize("what", ["ids", "weights", "timestamps"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tiled_device_plain_bit_equal(case, what):
    indptr, indices = CASES[case]()
    src = _payloads(indices, 5)[what]
    start, width = tsample.tiled_rowmap_host(indptr)
    got = tsample.build_tiled_device(torch.from_numpy(src), torch.from_numpy(start),
                                     torch.from_numpy(width))
    assert got.dtype == torch.from_numpy(src).dtype and got.shape == (start.shape[0], 128)
    _, host = tsample.build_tiled_host(indptr, src, src.dtype)
    assert np.array_equal(_bits(got.numpy()), _bits(host))
    if src.shape[0]:  # jnp.take of an empty array has nothing to take
        jt = jsample.build_tiled_device(jnp.asarray(src), jnp.asarray(start.astype(np.int32)),
                                        jnp.asarray(width))
        assert np.array_equal(_bits(got.numpy()), _bits(jt))


def test_build_tiled_device_plain_chunks_and_clips(monkeypatch):
    """Chunked rows give the one-shot table; a start past the end clips to
    the last word as jnp.take's index does; an int64 source copies too."""
    indptr, indices = _mixed_csr(4)
    start, width = tsample.tiled_rowmap_host(indptr)
    args = (torch.from_numpy(indices), torch.from_numpy(start), torch.from_numpy(width))
    whole = tsample.build_tiled_device(*args)
    monkeypatch.setattr(tsample, "TILE_CHUNK", 3)
    assert torch.equal(tsample.build_tiled_device(*args), whole)
    _, host = tsample.build_tiled_host(indptr, indices, np.int64)
    assert np.array_equal(whole.numpy(), host)
    src = np.arange(10, dtype=np.int32)
    st, wd = np.array([8, 0], np.int64), np.array([4, 2], np.int32)
    out = tsample.build_tiled_device(torch.from_numpy(src), torch.from_numpy(st),
                                     torch.from_numpy(wd)).numpy()
    jt = np.asarray(jsample.build_tiled_device(jnp.asarray(src), jnp.asarray(st.astype(np.int32)),
                                               jnp.asarray(wd)))
    assert out[0, :4].tolist() == [8, 9, 9, 9] and out[1, :3].tolist() == [0, 1, 0]
    assert np.array_equal(out, jt)


def test_build_tiled_device_checks_its_arguments():
    src = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int64"):
        tsample.build_tiled_device(src, torch.zeros(2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_width"):
        tsample.build_tiled_device(src, torch.zeros(2, dtype=torch.int64),
                                   torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_csrtopo_tables_bit_equal_to_host_and_jax(case):
    indptr, indices = CASES[case]()
    pay = _payloads(indices, 6)
    topo = CSRTopo(indptr=indptr, indices=indices, edge_weights=pay["weights"])
    jtopo = JCSRTopo(indptr=indptr, indices=indices, edge_weights=pay["weights"])
    bd, tiles = topo.to_device_tiled("cpu")
    hbd, htiles = tsample.build_tiled_host(indptr, indices, np.int32)
    assert tiles.dtype == torch.int32 and np.array_equal(bd.numpy(), hbd)
    assert np.array_equal(tiles.numpy(), htiles)
    jbd, jtiles = jtopo.to_device_tiled()
    assert np.array_equal(np.asarray(jbd), bd.numpy())
    assert np.array_equal(np.asarray(jtiles), tiles.numpy())
    wt = topo.to_device_tiled_weights("cpu")
    _, hw = tsample.build_tiled_host(indptr, pay["weights"], np.float32)
    assert np.array_equal(_bits(wt.numpy()), _bits(hw))
    assert np.array_equal(_bits(np.asarray(jtopo.to_device_tiled_weights())), _bits(wt.numpy()))
    tg = TemporalTiledGraph(topo, pay["timestamps"], device="cpu")
    jtg = JTemporalTiledGraph(jtopo, pay["timestamps"])
    _, ht = tsample.build_tiled_host(indptr, pay["timestamps"], np.float32)
    assert np.array_equal(_bits(tg.temporal_graph()[2].numpy()), _bits(ht))
    assert np.array_equal(_bits(np.asarray(jtg.temporal_graph()[2])),
                          _bits(tg.temporal_graph()[2].numpy()))
    assert tg.temporal_graph()[1] is tiles  # the topology's cached layout


def test_tile_caches_share_one_rowmap_and_reuse_uploads():
    indptr, indices = _mixed_csr(2)
    pay = _payloads(indices, 2)
    topo = CSRTopo(indptr=indptr, indices=indices, edge_weights=pay["weights"])
    flat = topo.to_device("cpu")
    ids = topo.to_device_tiled("cpu")
    rowmap = topo.tile_map()
    w = topo.to_device_tiled_weights("cpu")
    assert topo.tile_map() is rowmap  # computed once
    assert topo.to_device_tiled("cpu") is ids and topo.to_device_tiled_weights("cpu") is w
    assert topo.to_device("cpu") is flat  # the cached flat arrays stay cached
    wide = topo.to_device_tiled("cpu", id_dtype=np.int64)  # another key, another table
    assert wide[1].dtype == torch.int64 and np.array_equal(wide[1].numpy(), ids[1].numpy())


def test_csrtopo_pickles_without_device_tensors():
    import pickle

    indptr, indices = _random_csr()
    topo = CSRTopo(indptr=indptr, indices=indices)
    topo.to_device("cpu")
    topo.to_device_tiled("cpu")
    assert topo.share_memory_() is topo
    back = pickle.loads(pickle.dumps(topo))
    assert back._flat_cache is None and back._tiled_cache is None
    assert np.array_equal(back.indices, topo.indices)
    assert np.array_equal(back.to_device_tiled("cpu")[1].numpy(),
                          topo.to_device_tiled("cpu")[1].numpy())


def test_show_tensor_info_names_the_tensor(capsys):
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    line = show_tensor_info(t, "ids")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("ids shape=(2, 3) dtype=torch.int32 device=cpu")
    assert f"data_ptr={t.data_ptr():#x}" in line and "pinned=False" in line
    assert "host=numpy" in show_tensor_info(np.zeros(3))


@pytest.mark.parametrize("k", [48, 64])
@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_wide_fanout_draw_bit_equal(layout, k):
    """K1 and K1b's plain versions at k > 32 (the kernels' shared-memory
    tables) against JAX's sample_layer and tiled_sample_layer."""
    indptr, indices = _mixed_csr(7)
    ei = make_random_graph(200, 6000, seed=k)
    topo = CSRTopo(edge_index=np.concatenate(
        [ei, np.stack([np.repeat(np.arange(10), DEGS), indices])], axis=1), num_nodes=200)
    jtopo = JCSRTopo(indptr=topo.indptr, indices=topo.indices)
    rng = np.random.default_rng(k)
    seeds = rng.integers(0, 200, 96).astype(np.int32)
    seeds[:10] = np.arange(10)  # the degree mix: 0, k-ish, hubs
    valid = np.ones(96, bool)
    valid[20:23] = False
    jk, tk = (jax.random.fold_in(jax.random.key(1), k), qrandom.fold_in(qrandom.key(1), k))
    sv_j, sv_t = jnp.asarray(valid), torch.from_numpy(valid)
    if layout == "flat":
        jn, jv = jsample.sample_layer(*jtopo.to_device(), jnp.asarray(seeds), sv_j, k, jk)
        tn, tv = tsample.sample_layer(*topo.to_device("cpu"), torch.from_numpy(seeds), sv_t, k,
                                      tk)
    else:
        jn, jv = jsample.tiled_sample_layer(*jtopo.to_device_tiled(), jnp.asarray(seeds), sv_j,
                                            k, jk)
        tn, tv = tsample.tiled_sample_layer(*topo.to_device_tiled("cpu"),
                                            torch.from_numpy(seeds), sv_t, k, tk)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())
    assert tv.sum(dim=1).max() == k  # some row draws a full k-subset

"""Parity of the port's host engine (`quiver_tpu_torch.ops.cpu_kernels`)
with quiver_tpu's (`quiver_tpu.ops.cpu_kernels`), on the CPU: the loader and
its build, `HostSampler.sample_layer` and `sample_multilayer` (uniform and
weighted, with caps), `host_reindex` (native, its plain version and the
JAX package's), and `gather_rows`.

Both packages' engines are compiled from one C++ source (the port keeps
its own copy) and loaded in this process; a seed's draws depend on the
host's core count, so the two are compared here, in one process, and never
against stored arrays. Bars: every draw, id, mask and row bit-equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quiver_tpu.ops import cpu_kernels as jck
from quiver_tpu.ops.reindex import local_reindex as j_local_reindex
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu_torch.ops import cpu_kernels as ck
from quiver_tpu_torch.utils import CSRTopo

from conftest import make_random_graph
from test_sampler import _pl_inclusion_probs

N_NODES = 150


def _graph(weights=False):
    ei = make_random_graph(N_NODES, 1800, seed=6)
    topo = CSRTopo(edge_index=ei)
    w = None
    if weights:  # zero weight on odd destinations, a spread elsewhere
        rng = np.random.default_rng(2)
        w = np.where(topo.indices % 2 == 0, rng.random(topo.edge_count) + 0.1,
                     0.0).astype(np.float32)
    return topo, w


def test_engine_builds_into_the_ports_build_dir_from_its_own_source():
    lib = ck._load_native()
    assert ck.native_available()
    path = ck.lib_path()
    assert path.exists() and path.parent == ck.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "quiver_tpu_torch"
    assert ck.SOURCE.parent.parent.name == "quiver_tpu_torch"
    for name in ck.ENTRY_POINTS:
        assert getattr(lib, name).restype is None
    # the copy differs from the JAX package's source only by its header
    ours = ck.SOURCE.read_text()
    theirs = (ck.SOURCE.parents[2] / "quiver_tpu" / "csrc" / "quiver_cpu.cpp").read_text()
    assert ours.endswith(theirs)


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """No library and a compiler that cannot run: the loader, a
    `HostSampler` and a host-mode sampler raise; nothing draws."""
    from quiver_tpu_torch import GraphSageSampler

    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(ck, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not be built"):
        ck._load_native()
    assert not ck.native_available()
    topo, _ = _graph()
    with pytest.raises(RuntimeError, match="host sampling engine"):
        ck.HostSampler(topo.indptr, topo.indices)
    sampler = GraphSageSampler(topo, [3], mode="HOST", device="cpu")
    with pytest.raises(RuntimeError, match="host sampling engine"):
        sampler.sample_dense(np.arange(4))
    # a compiler that fails says why
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ck, "CXX", "g++")
    monkeypatch.setattr(ck, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed to build"):
        ck._load_native()
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 4, 40])
def test_sample_layer_bit_equal(weighted, k):
    topo, w = _graph(weighted)
    seeds = np.random.default_rng(k).integers(-3, N_NODES + 3, 96)  # out-of-range rows too
    want = jck.HostSampler(topo.indptr, topo.indices, weights=w).sample_layer(seeds, k, 17)
    got = ck.HostSampler(topo.indptr, topo.indices, weights=w).sample_layer(seeds, k, 17)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    nbrs, valid = got
    assert not valid[(seeds < 0) | (seeds >= N_NODES)].any()
    if weighted:
        assert (nbrs[valid] % 2 == 0).all()  # a zero weight is never drawn


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("caps", [None, (40, None), (30, 60)])
def test_sample_multilayer_bit_equal(weighted, caps):
    topo, w = _graph(weighted)
    seeds = np.random.default_rng(3).choice(N_NODES, 24, replace=False)
    want = jck.HostSampler(topo.indptr, topo.indices, weights=w).sample_multilayer(
        seeds, (5, 4), 123, caps)
    got = ck.HostSampler(topo.indptr, topo.indices, weights=w).sample_multilayer(
        seeds, (5, 4), 123, caps)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[0].dtype == np.int64 and (got[0][got[1]:] == ck.SENTINEL).all()
    for a, b in zip(got[2], want[2]):
        assert sorted(a) == sorted(b) == ["cols", "mask", "n_dst", "n_src"]
        assert np.array_equal(a["cols"], b["cols"]) and a["cols"].dtype == np.int32
        assert np.array_equal(a["mask"], b["mask"])
        assert (a["n_src"], a["n_dst"]) == (b["n_src"], b["n_dst"])


def test_weighted_draw_matches_the_plackett_luce_oracle():
    """tests/test_sampler.py's weighted-engine oracle on the port: the
    inclusion frequencies of a weighted 2-subset of four edges."""
    w = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    hs = ck.HostSampler(np.array([0, 4]), np.arange(4), weights=w)
    nbrs, valid = hs.sample_layer(np.zeros(6000, np.int64), 2, seed=0)
    assert valid.all() and (nbrs[:, 0] != nbrs[:, 1]).all()
    freq = np.bincount(nbrs.reshape(-1), minlength=4) / 6000
    np.testing.assert_allclose(freq, _pl_inclusion_probs(w, 2), atol=0.03)


def test_weights_must_cover_every_edge():
    topo, _ = _graph()
    with pytest.raises(ValueError, match="entries for"):
        ck.HostSampler(topo.indptr, topo.indices, weights=np.ones(3, np.float32))


def test_sample_layer_plain_is_the_reference_numpy_path():
    topo, _ = _graph()
    seeds = np.random.default_rng(1).integers(-2, N_NODES + 2, 40)
    want = jck._np_sample_layer(topo.indptr, topo.indices, seeds, 4, 9)
    got = ck.sample_layer_plain(topo.indptr, topo.indices, seeds, 4, 9)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _reindex_case(seed, dup):
    rng = np.random.default_rng(seed)
    if dup:  # tests/test_reindex.py:76: duplicate seeds likely
        seeds = rng.integers(0, 50, 16).astype(np.int64)
        nbrs = rng.integers(0, 200, (16, 5)).astype(np.int64)
        mask = rng.random((16, 5)) < 0.7
    else:  # tests/test_reindex.py:90
        seeds = rng.choice(500, 12, replace=False).astype(np.int64)
        nbrs = rng.integers(0, 500, (12, 4)).astype(np.int64)
        mask = rng.random((12, 4)) < 0.8
    return seeds, nbrs, mask


@pytest.mark.parametrize("seed,dup", [(7, True), (5, False), (11, True)])
def test_host_reindex_native_plain_and_reference_agree(seed, dup):
    seeds, nbrs, mask = _reindex_case(seed, dup)
    S = seeds.shape[0]
    want = jck.host_reindex(seeds, S, nbrs, mask)
    d = j_local_reindex(jnp.asarray(seeds), jnp.ones(S, bool), jnp.asarray(nbrs),
                        jnp.asarray(mask))
    for got in (ck.host_reindex(seeds, S, nbrs, mask),
                ck.host_reindex_plain(seeds, S, nbrs, mask)):
        assert got[1] == want[1] == int(d.count)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[0], np.asarray(d.n_id)[: got[1]])
        assert got[2].dtype == np.int32
        assert np.array_equal(got[2][mask], want[2][mask])
        assert np.array_equal(got[2][mask], np.asarray(d.local_nbrs)[mask])
        assert (got[2][~mask] == 0).all()
    # a prefix of the seeds: the rest of the frontier is padding
    got = ck.host_reindex(seeds, S - 3, nbrs, mask)
    want = jck.host_reindex(seeds, S - 3, nbrs, mask)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8", "bfloat16"])
def test_gather_rows_any_dtype_with_out_of_range_ids(dtype):
    """tests/test_feature.py:249 on the port, against the JAX package's
    gather: out-of-range ids give zero rows in every dtype."""
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    rng = np.random.default_rng(0)
    table = (rng.standard_normal((10, 5)) * 20).astype(dt)
    ids = np.array([3, 0, 7, -1, 12, 5, 10, -10], np.int64)
    got = ck.gather_rows(table, ids)
    want = jck.gather_rows(table, ids)
    assert got.dtype == table.dtype and got.shape == (8, 5)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    for i, idx in enumerate(ids):
        if 0 <= idx < 10:
            assert np.array_equal(got[i].view(np.uint8), table[idx].view(np.uint8))
        else:
            assert not got[i].view(np.uint8).any()
    assert np.array_equal(ck.HostSampler(np.zeros(1), np.zeros(0)).gather_rows(table, ids)
                          .view(np.uint8), got.view(np.uint8))


def test_gather_rows_strided_and_zero_row_tables():
    """tests/test_feature.py:273 and :294 on the port: a non-contiguous
    table and a zero-row one keep the zero-row contract."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((10, 8)).astype(np.float32)[:, ::2]
    ids = np.array([2, -1, 9, 10, -3, 0], np.int64)
    got = ck.gather_rows(table, ids)
    assert np.array_equal(got, jck.gather_rows(table, ids))
    assert (got[[1, 3, 4]] == 0).all() and np.array_equal(got[0], table[2])
    for dtype in (np.float32, np.int32):
        got = ck.gather_rows(np.zeros((0, 5), dtype), np.array([0, 3, -1]))
        assert got.shape == (3, 5) and got.dtype == dtype and not got.any()
    with pytest.raises(TypeError, match="2-D table"):
        ck.gather_rows(np.zeros(4, np.float32), np.arange(2))


def test_float32_entry_point_equals_the_byte_gather():
    """``qt_gather_rows``, the float32 spelling of the byte-row gather."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 7)).astype(np.float32)
    ids = rng.integers(-5, 55, 33).astype(np.int64)
    out = np.empty((33, 7), np.float32)
    ck._load_native().qt_gather_rows(table.ctypes.data, 50, 7, ids.ctypes.data, 33,
                                     out.ctypes.data)
    assert np.array_equal(out, ck.gather_rows(table, ids))


def test_memmap_indices_stay_a_view(tmp_path):
    topo, _ = _graph()
    idx = np.memmap(tmp_path / "idx.i64", dtype=np.int64, mode="w+", shape=topo.indices.shape)
    idx[:] = topo.indices
    s = ck.HostSampler(topo.indptr, idx)
    assert np.shares_memory(s.indices, idx)
    t = CSRTopo(indptr=topo.indptr, indices=idx)
    assert np.shares_memory(t.indices, idx)
    seeds = np.arange(20)
    want = jck.HostSampler(JCSRTopo(indptr=topo.indptr, indices=topo.indices).indptr,
                           topo.indices).sample_layer(seeds, 3, 4)
    got = s.sample_layer(seeds, 3, 4)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

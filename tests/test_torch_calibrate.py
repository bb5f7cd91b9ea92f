"""Parity of the port's static-cap calibration, overflow ladder and ragged
PyG surface (quiver_tpu_torch.pyg, quiver_tpu_torch.ops.reindex) with
quiver_tpu on the JAX suite's graph (tests/test_sampler.py: 120 nodes,
1,500 edges, seed 3): probe counts, caps, cap_overflow and raw counts,
the auto_grow_caps ladder, sample()/dense_to_pyg, sample_layer, reindex
and reindex_single. JAX runs on its CPU backend, the port's plain torch
versions on the CPU. Every bar is bit-equality (ids, counts, caps,
masks)."""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu.ops.reindex import reindex_single as j_reindex_single
from quiver_tpu.pyg import sage_sampler as jss
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops.reindex import reindex_single
from quiver_tpu_torch.pyg import (
    Adj,
    GraphSageSampler,
    caps_from_counts,
    dense_to_pyg,
    probe_hop_counts,
    sample_dense_pure,
)
from quiver_tpu_torch.utils import CSRTopo

from conftest import make_random_graph

torch.set_num_threads(1)

SIZES = (4, 3)


@pytest.fixture(scope="module")
def topos():
    ei = make_random_graph(120, 1500, seed=3)
    return JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)


def _pair(topos, **kw):
    jt, tt = topos
    sizes = kw.pop("sizes", SIZES)
    return (jss.GraphSageSampler(jt, sizes=sizes, mode="TPU", **kw),
            GraphSageSampler(tt, sizes=sizes, device="cpu", **kw))


def _same_sample(jds, tds):
    assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
    assert int(jds.count) == int(tds.count)
    for ja, ta in zip(jds.adjs, tds.adjs):
        mask = np.asarray(ja.mask)
        assert np.array_equal(mask, ta.mask.numpy())
        assert (int(ja.n_src), int(ja.n_dst)) == (int(ta.n_src), int(ta.n_dst))
        if ja.cols is not None:
            assert np.array_equal(np.asarray(ja.cols)[mask], ta.cols.numpy()[mask])
    if jds.cap_overflow is not None:
        assert int(jds.cap_overflow) == int(tds.cap_overflow)
        assert np.array_equal(np.asarray(jds.raw_counts), tds.raw_counts.numpy())


def _same_pyg(jout, tout):
    (jn, jb, jadjs), (tn, tb, tadjs) = jout, tout
    assert jb == tb and np.array_equal(np.asarray(jn), tn.numpy())
    assert len(jadjs) == len(tadjs)
    for ja, ta in zip(jadjs, tadjs):
        assert isinstance(ta, Adj) and ta.edge_index.dtype == torch.int64
        assert np.array_equal(ja.edge_index, ta.edge_index.numpy())
        assert ja.size == ta.size and ta.e_id.numel() == 0


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_probe_hop_counts_bit_equal(topos, layout):
    jt, tt = topos
    seeds = np.random.default_rng(5).integers(0, 120, (6, 16)).astype(np.int32)
    jk, tk = jax.random.key(77), qrandom.key(77)
    if layout == "flat":
        want = jss.probe_hop_counts(*jt.to_device(), jk, jnp.asarray(seeds), SIZES)
        got = probe_hop_counts(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), SIZES)
    else:
        js, ts = _pair(topos)
        _, _, fn, _ = js._engine()
        want = jss.probe_hop_counts(None, None, jk, jnp.asarray(seeds), SIZES, sample_fn=fn)
        got = probe_hop_counts(None, None, tk, torch.from_numpy(seeds), SIZES,
                               sample_fn=ts._bind(ts.lazy_init_quiver()))
    assert got.shape == (6, 2) and np.array_equal(np.asarray(want), got)


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_calibrate_caps_bit_equal_and_bounds_fresh_counts(topos, layout):
    """tests/test_sampler.py::test_calibrate_caps_bounds_observed_counts on
    both packages: the same caps, installed, dominating fresh batches'
    counts; the worst case clips."""
    js, ts = _pair(topos, seed=0, layout=layout)
    rng = np.random.default_rng(5)
    probes = rng.integers(0, 120, (10, 16))
    caps = ts.calibrate_caps(probes, margin=1.2, granule=16)
    assert caps == js.calibrate_caps(probes, margin=1.2, granule=16)
    assert ts.caps == caps and (ts.cap_margin, ts.cap_granule) == (1.2, 16)
    fresh = torch.from_numpy(rng.integers(0, 120, (10, 16)).astype(np.int32))
    counts = probe_hop_counts(*topos[1].to_device("cpu"), qrandom.key(77), fresh, SIZES)
    for l in range(2):
        assert counts[:, l].max() <= caps[l]
    assert ts.calibrate_caps(list(probes[:8]), granule=16, set_caps=False) == \
        js.calibrate_caps(list(probes[:8]), granule=16, set_caps=False)
    assert ts.caps == caps  # set_caps=False leaves them
    big = caps_from_counts(np.full((3, 2), 10_000), 16, SIZES, margin=10, granule=16)
    assert list(big) == [16 * 5, 16 * 5 * 4]
    assert big == jss.caps_from_counts(np.full((3, 2), 10_000), 16, SIZES, margin=10,
                                       granule=16)
    with pytest.raises(ValueError, match=r"\[m, B\]"):
        ts.calibrate_caps(np.arange(16))
    # the calibration took one key: both streams continue in step
    _same_sample(js.sample_dense(np.arange(16)), ts.sample_dense(np.arange(16)))


def test_cap_overflow_counter_bit_equal(topos):
    """tests/test_sampler.py::test_cap_overflow_counter on both packages."""
    jt, tt = topos
    jk, tk = jax.random.key(3), qrandom.key(3)
    seeds = np.arange(24, dtype=np.int32)
    free = sample_dense_pure(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), SIZES)
    _same_sample(jss.sample_dense_pure(*jt.to_device(), jk, jnp.asarray(seeds), SIZES), free)
    raw = free.raw_counts.numpy()
    assert int(free.cap_overflow) == 0
    assert raw.tolist() == [int(a.n_src) for a in free.adjs[::-1]]
    cap0 = int(raw[0]) - 5
    capped = sample_dense_pure(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), SIZES,
                               caps=(cap0, None))
    _same_sample(jss.sample_dense_pure(*jt.to_device(), jk, jnp.asarray(seeds), SIZES,
                                       caps=(cap0, None)), capped)
    assert capped.raw_counts.numpy()[0] == raw[0]
    assert int(capped.cap_overflow) == int(raw[0]) - cap0 > 0


@pytest.mark.parametrize("caps,grown_hop1", [((8, 16), None), ((8, 512), 512),
                                             ((8, None), "none")])
def test_auto_grow_caps_ladder_bit_equal(topos, caps, grown_hop1):
    """tests/test_sampler.py's three ladder tests (restores semantics,
    never shrinks, preserves None) on both packages: the same caps after
    the ladder, the same final draw, nothing dropped."""
    js, ts = _pair(topos, seed=0, caps=caps, auto_grow_caps=True)
    for s in (js, ts):
        s.cap_margin, s.cap_granule = 1.1, 8
    jds, tds = js.sample_dense(np.arange(24)), ts.sample_dense(np.arange(24))
    _same_sample(jds, tds)
    assert ts.caps == js.caps and int(tds.cap_overflow) == 0
    assert ts.caps[0] > 8 and ts.cap_regrows >= 1
    assert ts._call == 1 + ts.cap_regrows  # one key a regrowth
    if grown_hop1 is None:
        assert int(tds.count) == int(tds.raw_counts.numpy()[-1])
    elif grown_hop1 == "none":
        assert ts.caps[1] is None
    else:
        assert ts.caps[1] == grown_hop1
    # no overflow now: the next batch draws once with the grown caps
    _same_sample(js.sample_dense(np.arange(24, 48)), ts.sample_dense(np.arange(24, 48)))


def test_auto_grow_caps_warns_when_the_ladder_is_spent(topos):
    js, ts = _pair(topos, seed=0, caps=(8, 16), auto_grow_caps=True)
    for s in (js, ts):
        s.cap_margin, s.cap_granule = 0.5, 1  # regrowth to half the demand never catches up
    with pytest.warns(RuntimeWarning, match="auto_grow_caps"):
        jds = js.sample_dense(np.arange(24))
    with pytest.warns(RuntimeWarning, match="auto_grow_caps"):
        tds = ts.sample_dense(np.arange(24))
    _same_sample(jds, tds)
    assert int(tds.cap_overflow) > 0 and ts.cap_regrows == len(SIZES) + 1
    assert ts.caps == js.caps


def test_no_ladder_without_the_flag(topos):
    _, ts = _pair(topos, seed=0, caps=(8, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ds = ts.sample_dense(np.arange(24))
    assert int(ds.cap_overflow) > 0 and ts.caps == (8, 16) and ts.cap_regrows == 0


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_sample_pyg_surface_bit_equal(topos, layout, dedup):
    """tests/test_sampler.py::test_pyg_compat_surface on both packages:
    (n_id, batch_size, [Adj]) equal, always through the dedup pipeline."""
    js, ts = _pair(topos, seed=5, layout=layout, dedup=dedup)
    tout = ts.sample(np.arange(16))
    _same_pyg(js.sample(np.arange(16)), tout)
    n_id, batch_size, adjs = tout
    assert batch_size == 16 and np.array_equal(n_id[:16].numpy(), np.arange(16))
    assert len(np.unique(n_id.numpy())) == n_id.shape[0]
    assert len(adjs) == 2 and adjs[-1].size[1] == 16 and adjs[0].size[0] >= adjs[0].size[1]
    moved = adjs[0].to("cpu")
    assert isinstance(moved, Adj) and torch.equal(moved.edge_index, adjs[0].edge_index)


def test_dense_to_pyg_bit_equal_both_layouts(topos):
    js, ts = _pair(topos, seed=2, dedup=False)  # structural adjs
    _same_pyg(jss.dense_to_pyg(js.sample_dense(np.arange(8))),
              dense_to_pyg(ts.sample_dense(np.arange(8))))
    js, ts = _pair(topos, seed=2)  # cols adjs
    jds, tds = js.sample_dense(np.arange(8)), ts.sample_dense(np.arange(8))
    _same_pyg(jss.dense_to_pyg(jds), dense_to_pyg(tds))


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_sample_layer_and_reindex_bit_equal(topos, layout):
    """tests/test_sampler.py::test_pyg_compat_reindex_ragged on both
    packages: the same ragged draw, the same (n_id, row, col), and (row,
    col) reproduce the ragged lists."""
    js, ts = _pair(topos, seed=4, sizes=[7], layout=layout)
    inputs = np.arange(40)
    jn, jc = js.sample_layer(inputs, 7)
    tn, tc = ts.sample_layer(inputs, 7)
    assert np.array_equal(jn, tn.numpy()) and np.array_equal(jc, tc.numpy())
    n_id, rows, cols = ts.reindex(inputs, tn, tc)
    for want, got in zip(js.reindex(inputs, jn, jc), (n_id, rows, cols)):
        assert np.array_equal(np.asarray(want), got.numpy())
    assert n_id[:40].tolist() == inputs.tolist()
    assert np.array_equal(n_id[cols.long()].numpy(), tn.numpy())
    assert np.array_equal(rows.numpy(), np.repeat(np.arange(40), tc.numpy()))
    assert len(np.unique(n_id.numpy())) == n_id.shape[0]


def test_ragged_surface_refuses_temporal_samplers(topos):
    from quiver_tpu_torch.workloads import TemporalTiledGraph

    tt = topos[1]
    s = GraphSageSampler(tt, SIZES, device="cpu", dedup=False)
    s.bind_temporal(TemporalTiledGraph(tt, np.zeros(tt.edge_count, np.float32), device="cpu"))
    for call in (lambda: s.sample(np.arange(4)), lambda: s.sample_layer(np.arange(4), 3)):
        with pytest.raises(TypeError, match="query times"):
            call()


def test_reindex_single_padded_and_ragged_bit_equal():
    """tests/test_reindex.py::test_reindex_single_counts_aware on both
    packages, with its errors."""
    seeds = np.array([10, 20, 30])
    flat = np.array([40, 41, 42, 10, 50, 20])
    counts = np.array([4, 1, 1])
    jn, jc, jl = j_reindex_single(jnp.asarray(seeds), jnp.asarray(flat), counts)
    n_id, count, local = reindex_single(torch.from_numpy(seeds), torch.from_numpy(flat), counts)
    assert n_id.dtype == torch.int32 and local.dtype == torch.int32
    assert np.array_equal(np.asarray(jn), n_id.numpy()) and int(jc) == int(count)
    assert np.array_equal(np.asarray(jl), local.numpy())
    valid = n_id[: int(count)].numpy()
    assert set(valid.tolist()) == {10, 20, 30, 40, 41, 42, 50} and valid[:3].tolist() == [10, 20,
                                                                                            30]
    assert np.array_equal(valid[local.numpy()], flat)
    with pytest.raises(ValueError, match="counts"):
        reindex_single(torch.from_numpy(seeds), torch.tensor([1, 2, 3, 4]))
    with pytest.raises(ValueError, match="inconsistent"):
        reindex_single(torch.from_numpy(seeds), torch.from_numpy(flat), np.array([4, 1, 2]))
    with pytest.raises(ValueError, match="inconsistent"):
        reindex_single(torch.from_numpy(seeds), torch.from_numpy(flat), np.array([5, 1]))
    mat = np.array([[40, 41], [50, 51], [60, 61]])
    jn2, jc2, jl2 = j_reindex_single(jnp.asarray(seeds), jnp.asarray(mat))
    n2, c2, l2 = reindex_single(torch.from_numpy(seeds), torch.from_numpy(mat))
    assert int(c2) == int(jc2) == 9
    assert np.array_equal(np.asarray(jn2), n2.numpy()) and np.array_equal(np.asarray(jl2),
                                                                          l2.numpy())
    even = np.array([40, 41, 50, 51, 60, 61])  # divides into 3 rows: gridded [3, 2]
    jn3, jc3, jl3 = j_reindex_single(jnp.asarray(seeds), jnp.asarray(even))
    n3, c3, l3 = reindex_single(torch.from_numpy(seeds), torch.from_numpy(even))
    assert np.array_equal(np.asarray(jn3), n3.numpy()) and np.array_equal(np.asarray(jl3),
                                                                          l3.numpy())


def test_reindex_single_keeps_int64_ids_that_do_not_fit():
    seeds = torch.tensor([3, 2**40], dtype=torch.int64)
    n_id, count, local = reindex_single(seeds, torch.tensor([[2**40, 7], [3, 7]]))
    assert n_id.dtype == torch.int64 and int(count) == 3
    assert n_id[:3].tolist() == [3, 2**40, 7] and local.tolist() == [1, 2, 0, 2]

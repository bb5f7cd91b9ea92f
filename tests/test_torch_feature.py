"""Parity of the port's tiered feature store with quiver_tpu's, on the CPU:
`reindex_by_config`, `ShardTensor`, `Feature[ids]`, `Feature.lookup_padded`
and their bookkeeping, plus the host helpers the training slice carries
over (`trace.timer`/`median_min_max`/`seps`, `datasets.load_npz`).

Shapes: the 200-node, 2,000-edge graph of tests/test_torch_sage.py,
DIM 16, caches of 0%, 20% and 100% of the table, with and without the
degree reorder. Bars: every gathered row bit-equal (pure copies), ids
outside [0, N) (negative, N and up, the sampler's INT32_MAX sentinel)
give zero rows in ``__getitem__`` and clipped rows in ``lookup_padded``
exactly as in the reference; tier bytes, stored rows and validation
errors equal."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import Feature as JFeature
from quiver_tpu import datasets as jdatasets
from quiver_tpu import trace as jtrace
from quiver_tpu.shard_tensor import ShardTensor as JShardTensor
from quiver_tpu.shard_tensor import ShardTensorConfig as JShardTensorConfig
from quiver_tpu.utils import reindex_by_config as j_reindex_by_config
from quiver_tpu_torch import CSRTopo, Feature, datasets, trace
from quiver_tpu_torch.feature import DeviceConfig, validate_lookup_ids
from quiver_tpu_torch.inference import lookup_features
from quiver_tpu_torch.shard_tensor import (
    CPU_DEVICE,
    ShardTensor,
    ShardTensorConfig,
    normalize_dtype,
    tiered_gather,
)
from quiver_tpu_torch.utils import reindex_by_config, reindex_feature

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM = 200, 16
ROW_BYTES = DIM * 4
INT32_MAX = 2**31 - 1


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal((N_NODES, DIM)).astype(np.float32)


def _edges():
    return make_random_graph(N_NODES, 2000, seed=0)


def _ids(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_NODES, 40)
    ids[:6] = [-1, -7, N_NODES, N_NODES + 5, INT32_MAX, 0]
    ids[6] = ids[7]  # a repeat
    return ids


def _pair(cache_frac, with_topo):
    cache = int(N_NODES * cache_frac) * ROW_BYTES
    edges = _edges()
    jf = JFeature(rank=0, device_list=[0], device_cache_size=cache,
                  csr_topo=JCSRTopo(edge_index=edges) if with_topo else None)
    tf = Feature(rank=0, device_list=[0], device_cache_size=cache,
                 csr_topo=CSRTopo(edge_index=edges) if with_topo else None, device="cpu")
    table = _table()
    jf.from_cpu_tensor(table)
    tf.from_cpu_tensor(table)
    return jf, tf


@pytest.mark.parametrize("portion", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("seed", [0, 5])
def test_reindex_by_config_bit_equal(portion, seed):
    edges, table = _edges(), _table()
    jfeat, jorder = j_reindex_by_config(JCSRTopo(edge_index=edges), table, portion, seed=seed)
    tfeat, torder = reindex_by_config(CSRTopo(edge_index=edges), table, portion, seed=seed)
    assert np.array_equal(jorder, torder) and torder.dtype == np.int64
    assert np.array_equal(np.asarray(jfeat), tfeat)
    _, order2 = reindex_feature(CSRTopo(edge_index=edges), None, portion, seed=seed)
    assert np.array_equal(order2, torder)
    with pytest.raises(ValueError):
        reindex_by_config(CSRTopo(edge_index=edges), table, 1.5)


@pytest.mark.parametrize("with_topo", [False, True])
@pytest.mark.parametrize("cache_frac", [0.0, 0.2, 1.0])
def test_feature_getitem_bit_equal(cache_frac, with_topo):
    jf, tf = _pair(cache_frac, with_topo)
    ids = _ids()
    want = np.asarray(jf[ids])
    assert not want[:5].any()  # out-of-range ids give zero rows
    assert np.array_equal(want, tf[ids].numpy())  # numpy int64 ids
    assert np.array_equal(want, tf[torch.from_numpy(ids.astype(np.int32))].numpy())
    assert np.array_equal(want, tf[torch.from_numpy(ids)].numpy())  # int64 tensor ids
    stored = tf.stored_rows_of(ids[6:])
    assert np.array_equal(np.asarray(jf.gather_stored(stored)), tf.gather_stored(stored).numpy())
    assert np.array_equal(jf.stored_rows_of(ids), tf.stored_rows_of(ids))
    assert np.array_equal(jf.node_ids_of_stored(np.arange(N_NODES)),
                          tf.node_ids_of_stored(np.arange(N_NODES)))
    assert jf.tier_bytes() == tf.tier_bytes()
    assert jf.shape == tf.shape and jf.dim == tf.dim and jf.size(0) == tf.size(0) == N_NODES
    if with_topo:
        assert np.array_equal(jf.feature_order, tf.feature_order)
        assert np.array_equal(tf.csr_topo.feature_order, tf.feature_order)


@pytest.mark.parametrize("with_topo", [False, True])
def test_lookup_padded_bit_equal_and_residency(with_topo):
    jf, tf = _pair(1.0, with_topo)
    ids = _ids(2)
    ids32 = ids.astype(np.int32)
    want = np.asarray(jf.lookup_padded(jnp.asarray(ids32)))
    assert np.array_equal(want, tf.lookup_padded(torch.from_numpy(ids32)).numpy())
    assert np.array_equal(want, tf.lookup_padded(torch.from_numpy(ids)).numpy())  # int64
    valid = np.arange(ids.shape[0]) % 3 != 0
    want_v = np.asarray(jf.lookup_padded(jnp.asarray(ids32), jnp.asarray(valid)))
    got_v = tf.lookup_padded(torch.from_numpy(ids32), torch.from_numpy(valid)).numpy()
    assert np.array_equal(want_v, got_v)
    assert tf.resident
    # lookup_features picks lookup_padded for a resident feature
    assert np.array_equal(lookup_features(tf, torch.from_numpy(ids32)).numpy(), want)
    jp, tp = _pair(0.2, with_topo)
    assert not tp.resident
    with pytest.raises(ValueError):
        jp.lookup_padded(jnp.asarray(ids32))
    with pytest.raises(ValueError):
        tp.lookup_padded(torch.from_numpy(ids32))
    # ... and the tiered __getitem__ (zero rows for sentinels) otherwise
    assert np.array_equal(lookup_features(tp, torch.from_numpy(ids32)).numpy(),
                          np.asarray(jp[ids]))


def test_validate_ids_errors_match():
    jf, tf = _pair(0.2, True)
    good = np.arange(10)
    assert np.array_equal(jf.validate_ids(good), tf.validate_ids(good))
    bad = np.array([3, -1, N_NODES, 4, N_NODES + 9])
    with pytest.raises(ValueError) as je:
        jf.validate_ids(bad)
    with pytest.raises(ValueError) as te:
        tf.validate_ids(bad)
    assert str(je.value) == str(te.value)
    with pytest.raises(ValueError):
        validate_lookup_ids([N_NODES], N_NODES)


def test_shard_tensor_budget_split_matches_reference():
    table = _table(3)
    budget = {0: 37 * ROW_BYTES + 5}
    jst = JShardTensor.new_from_cpu_tensor(table, JShardTensorConfig(budget))
    tst = ShardTensor.new_from_cpu_tensor(table, ShardTensorConfig(budget), current_device="cpu")
    assert jst.shape == tst.shape and jst.size == tst.size
    assert jst.device_ratio() == tst.device_ratio() == 37 / N_NODES
    assert jst.tier_bytes() == tst.tier_bytes()
    assert tst.cpu_offset.start == 37 and tst.cpu_tensor.shape == (N_NODES - 37, DIM)
    ids = _ids(4)
    assert np.array_equal(np.asarray(jst[ids]), tst[ids].numpy())


def test_tiered_gather_with_order_and_bad_stored_rows():
    """The gather function alone: an order that maps some ids past both
    tiers (a row no shard owns) gives zero rows, as the reference's shard
    book does."""
    table = torch.from_numpy(_table(5))
    dev_rows, host_rows = table[:30], table[30:]
    order = torch.arange(N_NODES, dtype=torch.int32).flip(0)
    order[3] = N_NODES + 4
    order[4] = -2
    ids = torch.tensor([0, 3, 4, 199, 170, -1, 200, 12], dtype=torch.int32)
    got = tiered_gather(dev_rows, host_rows, ids, N_NODES, order)
    want = torch.zeros((8, DIM))
    for r, i in enumerate(ids.tolist()):
        if 0 <= i < N_NODES and 0 <= int(order[i]) < N_NODES:
            want[r] = table[int(order[i])]
    assert torch.equal(got, want)
    assert torch.equal(tiered_gather(None, table, ids, N_NODES), tiered_gather(table, None, ids,
                                                                               N_NODES))


def test_shard_tensor_and_feature_refuse_what_is_not_ported():
    with pytest.raises(TypeError):
        normalize_dtype("float16")
    with pytest.raises(TypeError):
        ShardTensor("cpu", dtype=np.float16)
    st = ShardTensor("cpu")
    st.append(_table()[:10], 0)
    with pytest.raises(NotImplementedError):
        st.append(_table()[10:20], 1)  # a second device shard
    st.append(_table()[10:], CPU_DEVICE)
    with pytest.raises(ValueError):
        st.append(_table()[:3], CPU_DEVICE)
    with pytest.raises(ValueError):
        st.append(np.zeros((3, DIM + 1), np.float32), CPU_DEVICE)
    with pytest.raises(NotImplementedError):
        Feature(device="cpu", cache_policy="ici_replicate")
    with pytest.raises(ValueError):
        Feature(device="cpu", cache_policy="everywhere")
    assert DeviceConfig([0], "1M").device_cache_size == "1M"


def test_trace_helpers_match_reference():
    vals = [3.0, 1.0, 4.0, 1.5]
    assert trace.median_min_max(vals) == jtrace.median_min_max(vals)
    assert trace.seps(1000, 0.5) == jtrace.seps(1000, 0.5) == 2000.0
    with pytest.raises(ValueError):
        trace.median_min_max([])
    with trace.timer("x") as t:
        pass
    assert t.elapsed >= 0.0


def test_load_npz_matches_reference(tmp_path):
    path = str(tmp_path / "g.npz")
    edges = _edges()
    jdatasets.save_npz(path, edges, _table(), np.arange(N_NODES) % 3, np.arange(20),
                       test_idx=np.arange(20, 30))
    want, got = jdatasets.load_npz(path), datasets.load_npz(path)
    assert sorted(want) == sorted(got)
    assert all(np.array_equal(want[k], got[k]) for k in want)
    np.savez(str(tmp_path / "bad.npz"), edge_index=edges)
    with pytest.raises(ValueError):
        datasets.load_npz(str(tmp_path / "bad.npz"))

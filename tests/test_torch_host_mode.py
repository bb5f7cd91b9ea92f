"""Parity of the port's host-mode sampling with quiver_tpu's, on the CPU:
`GraphSageSampler` in HOST, CPU and UVA modes (``sample_dense``,
``sample_layer``, ``sample()``, ``calibrate_caps``, weighted draws, the
refusals), graphs past 2^31 edges (tests/test_int64_ids.py:49-84), the
community loop of tests/test_e2e.py in HOST mode, the HOST tiered pipeline
of tests/test_host_scale.py:25, the sampled train step and serve engine
over a host-mode sampler, and the example with ``--mode HOST``.

Both packages draw through one C++ engine source compiled into each
package's own library, in this process (the draws depend on the core
count). Bars: samples bit-equal (``n_id`` with its -1 padding, ``count``,
``cols``, masks, ``n_src``, ``n_dst``); Adam loss curves within 1e-4, the
bar of tests/test_torch_train.py and tests/test_torch_pipeline.py (torch
and XLA sum in different orders, and Adam divides by sqrt(v))."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import Feature as JFeature
from quiver_tpu.datasets import synthetic_powerlaw
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.ops.cpu_kernels import HostSampler as JHostSampler
from quiver_tpu.pipeline import TieredFeaturePipeline as JTieredFeaturePipeline
from quiver_tpu.pipeline import TrainPipeline as JTrainPipeline
from quiver_tpu.pipeline import make_tiered_train_step as j_make_step
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.pyg.sage_sampler import dense_to_pyg as j_dense_to_pyg
from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler, ServeConfig,
                              ServeEngine, sage_params_from_flax)
from quiver_tpu_torch.inference import batch_logits, lookup_features
from quiver_tpu_torch.ops.cpu_kernels import HostSampler
from quiver_tpu_torch.pipeline import TieredFeaturePipeline, TrainPipeline, make_tiered_train_step
from quiver_tpu_torch.train_programs import descend, make_sample_train_step

from conftest import make_random_graph
from test_e2e import make_community_graph
from test_int64_ids import _giant_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, SIZES, SEED = 150, [4, 3], 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _topos(weights=False):
    ei = make_random_graph(N_NODES, 1800, seed=6)
    w = None
    if weights:
        w = np.random.default_rng(1).random(ei.shape[1]).astype(np.float32)
        w[ei[1] % 3 == 0] = 0.0  # never drawn
    return JCSRTopo(edge_index=ei, edge_weights=w), CSRTopo(edge_index=ei, edge_weights=w)


def _assert_host_samples_equal(jds, tds):
    assert tds.n_id.dtype == torch.int32 and np.asarray(jds.n_id).dtype == np.int32
    assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
    count = int(tds.count)
    assert count == int(jds.count) and (tds.n_id[count:] == -1).all()
    assert jds.batch_size == tds.batch_size
    assert tds.cap_overflow is None and tds.raw_counts is None
    assert len(jds.adjs) == len(tds.adjs)
    for ja, ta in zip(jds.adjs, tds.adjs):
        assert np.array_equal(np.asarray(ja.cols), ta.cols.numpy())
        assert np.array_equal(np.asarray(ja.mask), ta.mask.numpy())
        assert int(ja.n_src) == int(ta.n_src) and int(ja.n_dst) == int(ta.n_dst)
        assert ta.n_src.dtype == ta.n_dst.dtype == torch.int32 and ta.n_src.dim() == 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("caps", [None, (40, 80)])
@pytest.mark.parametrize("mode", ["HOST", "CPU", "UVA"])
def test_sample_dense_bit_equal(mode, caps, weighted):
    jt, tt = _topos(weighted)
    js = JSampler(jt, SIZES, mode=mode, seed=SEED, caps=caps, weighted=weighted)
    ts = GraphSageSampler(tt, SIZES, mode=mode, seed=SEED, caps=caps, weighted=weighted,
                          device="cpu")
    assert ts.mode == js.mode and ts.on_host and ts._graph is None
    rng = np.random.default_rng(2)
    for _ in range(3):
        seeds = rng.choice(N_NODES, 20, replace=False)
        _assert_host_samples_equal(js.sample_dense(seeds), ts.sample_dense(seeds))
    # torch seeds, and a seed that repeats, sample alike
    seeds = np.array([3, 3, 9, 140])
    _assert_host_samples_equal(js.sample_dense(seeds), ts.sample_dense(torch.from_numpy(seeds)))
    assert ts._call == js._call == 4
    assert tt._flat_cache is None and tt._tiled_cache is None  # nothing bound to a device


def test_sample_layer_sample_and_calibrate_caps_match():
    jt, tt = _topos()
    js = JSampler(jt, SIZES, mode="HOST", seed=SEED)
    ts = GraphSageSampler(tt, SIZES, mode="HOST", seed=SEED, device="cpu")
    seeds = np.arange(0, 60, 3)
    jn, jc = js.sample_layer(seeds, 5)
    tn, tc = ts.sample_layer(seeds, 5)
    assert np.array_equal(jn, tn.numpy()) and np.array_equal(jc, tc.numpy())
    jn_id, jb, jadjs = js.sample(seeds)
    tn_id, tb, tadjs = ts.sample(seeds)
    assert jb == tb and np.array_equal(np.asarray(jn_id), tn_id.numpy())
    for ja, ta in zip(jadjs, tadjs):
        assert np.array_equal(np.asarray(ja.edge_index), ta.edge_index.numpy())
        assert ja.size == ta.size
    probes = np.random.default_rng(6).integers(0, N_NODES, (8, 16))
    caps = ts.calibrate_caps(probes, granule=16)
    assert caps == js.calibrate_caps(probes, granule=16) and ts.caps == caps
    assert ts._call == js._call == 10  # one call a probe batch
    _assert_host_samples_equal(js.sample_dense(seeds), ts.sample_dense(seeds))
    # sample() is dense_to_pyg of the same draw
    twin = GraphSageSampler(tt, SIZES, mode="HOST", seed=SEED, device="cpu", caps=caps)
    twin._call = ts._call
    a, b = j_dense_to_pyg(js.sample_dense(seeds)), twin.sample(seeds)
    assert np.array_equal(np.asarray(a[0]), b[0].numpy())


def test_modes_aliases_and_refusals(monkeypatch):
    _, tt = _topos()
    for mode, canon in (("UVA", "HOST"), ("ZERO_COPY", "HOST"), ("CPU", "CPU"),
                        ("DMA", "GPU"), ("TPU", "GPU"), ("GPU", "GPU")):
        assert GraphSageSampler(tt, SIZES, mode=mode, device="cpu").mode == canon
    assert JSampler.MODE_ALIASES["UVA"] == "HOST" and JSampler.MODE_ALIASES["DMA"] == "TPU"
    s = GraphSageSampler(tt, SIZES, mode="HOST", device="cpu", seed=1)
    with pytest.raises(TypeError, match="next_key"):
        s.next_key()
    with pytest.raises(TypeError, match="fused sampling"):
        s.fused_sample_spec()
    with pytest.raises(TypeError, match="device graph"):
        s.lazy_init_quiver()
    with pytest.raises(TypeError, match="streaming graph"):
        s.bind_stream(object())
    with pytest.raises(TypeError, match="bind_temporal"):
        s.bind_temporal(object())
    with pytest.raises(TypeError, match="t= is only"):
        s.sample_dense(np.arange(4), t=1.0)
    assert s._call == 0 and s.id_dtype == torch.int32
    # auto_grow_caps plays no part in a host mode, as in the JAX package
    g = GraphSageSampler(tt, SIZES, mode="HOST", device="cpu", seed=1, caps=(8, 8),
                         auto_grow_caps=True)
    ds = g.sample_dense(np.arange(16))
    assert ds.n_id.shape[0] == 8 and g.caps == (8, 8) and g._call == 1
    # node ids past int32 (ROADMAP B4)
    huge = types.SimpleNamespace(node_count=2**31, edge_weights=None)
    with pytest.raises(ValueError, match="B4"):
        GraphSageSampler(huge, SIZES, mode="HOST", device="cpu")
    with pytest.raises(ValueError, match="unsupported mode"):
        GraphSageSampler(tt, SIZES, mode="BAD_MODE", device="cpu")


def test_weighted_host_end_to_end():
    """tests/test_sampler.py:450-500 on the port: heavy edges dominate the
    frontier and zero-weight edges are never drawn."""
    jt, _ = _topos()
    indptr, indices = jt.indptr, jt.indices
    ew = np.where(indices % 2 == 0, 10.0, 1.0).astype(np.float32)
    s = GraphSageSampler(CSRTopo(indptr=indptr, indices=indices, edge_weights=ew), [3, 3],
                         mode="HOST", seed=0, weighted=True, device="cpu")
    rng = np.random.default_rng(0)
    even = odd = 0
    for _ in range(6):
        ds = s.sample_dense(rng.integers(0, N_NODES, 32))
        n_id = ds.n_id[32:int(ds.count)].numpy()
        even += int((n_id % 2 == 0).sum())
        odd += int((n_id % 2 == 1).sum())
    assert even > odd * 1.5, (even, odd)
    ew0 = np.where(indices % 2 == 0, 1.0, 0.0).astype(np.float32)
    s0 = GraphSageSampler(CSRTopo(indptr=indptr, indices=indices, edge_weights=ew0), [4],
                          mode="HOST", seed=0, weighted=True, max_deg=1, device="cpu")
    ds = s0.sample_dense(np.arange(32))
    assert (ds.n_id[32:int(ds.count)] % 2 == 0).all()


# -- graphs past 2^31 edges (tests/test_int64_ids.py:49-84) --------------------------

def test_host_sampler_above_2e31_edge_ids(tmp_path):
    indptr, idx, n, deg = _giant_graph(tmp_path)
    s = HostSampler(indptr, idx)
    assert np.shares_memory(s.indices, idx)  # no 17 GB copy
    nbrs, valid = s.sample_layer(np.arange(n), 3, seed=7)
    assert valid.all()
    for u in range(n):
        got = set(nbrs[u].tolist())
        assert got <= {(u + 1 + j) % n for j in range(deg)} and len(got) == 3
    want = JHostSampler(indptr, idx).sample_layer(np.arange(n), 3, seed=7)
    assert np.array_equal(nbrs, want[0]) and np.array_equal(valid, want[1])


def test_host_multilayer_above_2e31_edge_ids(tmp_path):
    indptr, idx, n, deg = _giant_graph(tmp_path)
    n_id, count, adjs = HostSampler(indptr, idx).sample_multilayer(np.arange(8), (3, 2), seed=1)
    assert 0 < count <= n_id.shape[0]
    assert (n_id[:count] >= 0).all() and (n_id[:count] < n).all()
    assert all(a["mask"].any() for a in adjs)
    want = JHostSampler(indptr, idx).sample_multilayer(np.arange(8), (3, 2), seed=1)
    assert np.array_equal(n_id, want[0]) and count == want[1]


def test_host_mode_sampler_surface_above_2e31(tmp_path):
    indptr, idx, n, deg = _giant_graph(tmp_path)
    topo = CSRTopo(indptr=indptr, indices=idx)
    assert np.shares_memory(topo.indices, idx) and topo.edge_count > 2**31
    s = GraphSageSampler(topo, sizes=[3, 2], mode="HOST", seed=0, device="cpu")
    ds = s.sample_dense(np.arange(8))
    n_id = ds.n_id[: int(ds.count)].numpy()
    assert (n_id >= 0).all() and (n_id < n).all()
    assert np.shares_memory(s._host().indices, idx)
    js = JSampler(JCSRTopo(indptr=indptr, indices=idx), sizes=[3, 2], mode="HOST", seed=0)
    s2 = GraphSageSampler(topo, sizes=[3, 2], mode="HOST", seed=0, device="cpu")
    _assert_host_samples_equal(js.sample_dense(np.arange(8)), s2.sample_dense(np.arange(8)))


# -- training over a host-mode sampler ----------------------------------------------

def _jax_loss_fn(jmodel, x, adjs, y):
    def loss_fn(p):
        logits = jmodel.apply(p, x, adjs)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    return loss_fn


def test_train_community_classification_host_mode_matches_jax():
    """tests/test_e2e.py's HOST community run on both packages from the
    same weights and draws: 60 Adam steps of batch 32, the loss curves
    within 1e-4 and halving, then a fresh batch classified above 0.9."""
    edge_index, feat_np, labels, n = make_community_graph()
    js = JSampler(JCSRTopo(edge_index=edge_index), sizes=[5, 5], mode="HOST", seed=0)
    ts = GraphSageSampler(CSRTopo(edge_index=edge_index), sizes=[5, 5], mode="HOST", seed=0,
                          device="cpu")
    jf = JFeature(rank=0, device_list=[0], device_cache_size=n * 16 * 4)
    jf.from_cpu_tensor(feat_np)
    tf = Feature(rank=0, device_list=[0], device_cache_size=n * 16 * 4, device="cpu")
    tf.from_cpu_tensor(feat_np)
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=4, num_layers=2, dropout=0.0)
    tx = optax.adam(5e-3)

    @jax.jit
    def jstep(params, state, x, adjs, y):
        loss, grads = jax.value_and_grad(_jax_loss_fn(jmodel, x, adjs, y))(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    rng = np.random.default_rng(0)
    batches = [rng.choice(n, 32, replace=False) for _ in range(60)]
    jds = js.sample_dense(batches[0])
    params = jmodel.init(jax.random.key(0), jf.lookup_padded(jds.n_id), jds.adjs)
    state = tx.init(params)
    model = GraphSAGE(16, 32, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    labels_t = torch.from_numpy(labels.astype(np.int64))
    jlosses, tlosses = [], []
    for i, seeds in enumerate(batches):
        if i:
            jds = js.sample_dense(seeds)
        tds = ts.sample_dense(seeds)
        params, state, jloss = jstep(params, state, jf.lookup_padded(jds.n_id), jds.adjs,
                                     jnp.asarray(labels[seeds]))
        loss = descend(model, opt, tf.lookup_padded(tds.n_id), tds.adjs,
                       labels_t[tds.n_id[:32].long()], None)
        jlosses.append(float(jloss))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert tlosses[-1] < tlosses[0] * 0.5
    seeds = rng.choice(n, 128, replace=False)
    ds = ts.sample_dense(seeds)
    with torch.no_grad():
        pred = model(tf.lookup_padded(ds.n_id), ds.adjs).argmax(-1).numpy()
    assert (pred == labels[seeds]).mean() > 0.9


def test_host_mode_tiered_pipeline_matches_jax():
    """tests/test_host_scale.py:25 at a small size: HOST sampling, 10% of
    the rows hot, the rest on the host, 10 batches through both packages'
    pipelines from the same weights: the curves within 1e-4, the cold tier
    carrying real traffic."""
    n, e, dim, ncls = 3_000, 45_000, 16, 4
    ei, feat, labels, train_idx = synthetic_powerlaw(n, e, dim=dim, classes=ncls, seed=3)
    budget = (n // 10) * dim * 4
    jf = JFeature(rank=0, device_list=[0], device_cache_size=budget,
                  cache_policy="device_replicate", csr_topo=JCSRTopo(edge_index=ei))
    jf.from_cpu_tensor(feat)
    tf = Feature(rank=0, device_list=[0], device_cache_size=budget,
                 csr_topo=CSRTopo(edge_index=ei), device="cpu")
    tf.from_cpu_tensor(feat)
    rng = np.random.default_rng(0)
    batches = [rng.choice(train_idx, 64, replace=False) for _ in range(10)]
    js = JSampler(JCSRTopo(edge_index=ei), sizes=[6, 5], mode="HOST", seed=0)
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=ncls, num_layers=2, dropout=0.0)
    tx = optax.adam(5e-3)
    jpipe = JTieredFeaturePipeline(jf)
    jstep = j_make_step(jmodel, tx, jnp.asarray(labels), jpipe.hot_table)
    ds0 = JSampler(JCSRTopo(edge_index=ei), sizes=[6, 5], mode="HOST", seed=0).sample_dense(
        batches[0])
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], dim)), ds0.adjs)
    jtp = JTrainPipeline(js, jf, jstep, tiered=jpipe)
    _, _, jlosses = jtp.run_epoch(batches, params, tx.init(params), jax.random.key(1))

    model = GraphSAGE(dim, 32, ncls, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    pipe = TieredFeaturePipeline(tf)
    step = make_tiered_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-3),
                                  labels, pipe.hot_table)
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=[6, 5], mode="HOST", seed=0,
                          device="cpu")
    tp = TrainPipeline(ts, tf, step, tiered=pipe)
    losses = tp.run_epoch(batches)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    assert np.isfinite(losses).all()
    assert tp.stats.cold_rows == jtp.stats.cold_rows > tp.stats.hot_rows / 4
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_sample_train_step_takes_the_split_path_on_a_host_sampler():
    """`make_sample_train_step` over a host-mode sampler: the sample and
    gather eager, the step after them (`make_train_step`'s), equal to the
    eager `descend` on the same draws; the in-step modes refuse."""
    jt, tt = _topos()
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((N_NODES, 8))
                             .astype(np.float32))
    labels = np.random.default_rng(1).integers(0, 3, N_NODES)

    def model_and_opt():
        m = GraphSAGE(8, 16, 3, num_layers=2, dropout=0.0)
        m.reset_parameters(torch.Generator().manual_seed(0))
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    m1, o1 = model_and_opt()
    s1 = GraphSageSampler(tt, SIZES, mode="HOST", seed=4, device="cpu")
    step = make_sample_train_step(s1, table, labels, m1, o1)
    assert not step.captures_sample
    m2, o2 = model_and_opt()
    s2 = GraphSageSampler(tt, SIZES, mode="HOST", seed=4, device="cpu")
    y = torch.from_numpy(labels)
    for i in range(4):
        seeds = np.arange(i * 16, i * 16 + 16)
        loss, edges = step(seeds)
        ds = s2.sample_dense(seeds)
        want = descend(m2, o2, lookup_features(table, ds.n_id), ds.adjs, y[seeds], None)
        assert torch.equal(loss, want)
        assert int(edges) == sum(int(a.mask.sum()) for a in ds.adjs)
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
    for mode in ("fused", "dedup"):
        with pytest.raises(TypeError, match="host-mode sampler"):
            make_sample_train_step(s1, table, labels, m1, o1, mode=mode)


def test_serve_engine_over_a_host_sampler_takes_the_split_path():
    """As the JAX package's engine does: no fused step (dispatch_mode
    'fused' refuses), the split path serves, and its rows replay through a
    fresh sampler bit for bit."""
    _, tt = _topos()
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((N_NODES, 8))
                             .astype(np.float32))
    model = GraphSAGE(8, 16, 3, num_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sampler = GraphSageSampler(tt, SIZES, mode="HOST", seed=2, device="cpu")
    with pytest.raises(ValueError, match="cannot fuse"):
        ServeEngine(model, None, sampler, table, ServeConfig(max_batch=8, dispatch_mode="fused"))
    eng = ServeEngine(model, None, sampler, table,
                      ServeConfig(max_batch=8, record_dispatches=True))
    assert eng._programs is None
    ids = np.arange(5, 21)
    out = eng.predict(ids)
    assert out.shape == (16, 3) and np.isfinite(out).all()
    twin = GraphSageSampler(tt, SIZES, mode="HOST", seed=2, device="cpu")
    served = dict(zip(ids.tolist(), out))
    for entry in eng.dispatch_log:
        padded, n_valid = entry[0], entry[1]
        rows = batch_logits(model, twin, table, padded).numpy()
        for i in range(n_valid):
            assert np.array_equal(rows[i], served[int(padded[i])])


def test_example_runs_and_learns_host_mode_on_cpu():
    """tests/test_torch_train.py's small run of the example with --mode
    HOST (and the aliases' refusal is gone)."""
    r = subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.examples.reddit_sage", "--device", "cpu",
         "--mode", "HOST", "--nodes", "3000", "--dim", "16", "--hidden", "32", "--epochs", "10",
         "--batch-size", "128", "--sizes", "8,5", "--lr", "0.01"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    for line in ("epoch 9:", "val acc:", "test acc:", "test acc (full inference):"):
        assert line in r.stdout, r.stdout
    assert float(r.stdout.split("test acc:")[1].split()[0]) > 0.5, r.stdout

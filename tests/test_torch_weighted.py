"""The port's weighted sampling (quiver_tpu_torch.ops.sample's Gumbel
top-k, K7's plain versions, CSRTopo(edge_weights=) and the weighted
GraphSageSampler) against quiver_tpu's, on the same numpy inputs and keys.

Bars. The port takes every log in float64 and rounds once; XLA-CPU's
float32 log is its own approximation, within an ULP. So: validity flags
bit-equal everywhere; positions and ids bit-equal on every valid lane
except near-ties, rows where the port's scores of the lanes that change
places lie within 2 ULP of each other, and at most 1 such row in 2,000
drawn (none is allowed below 2,000 rows); scores within 1e-4 of the JAX
package's where both are finite. Inside the port, flat and tiled draws
are equal when max_deg is a multiple of 128. A 5-step weighted training
loss curve stays within 1e-4 of the JAX loop's. The card-only checks
(kernel against plain version) are in tests/test_torch_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.ops import sample as jsample
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.inference import lookup_features
from quiver_tpu_torch.ops import sample as tsample

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, SEED = 300, 5


def _keys(seed, call=0):
    return (jax.random.fold_in(jax.random.key(seed), call),
            qrandom.fold_in(qrandom.key(seed), call))


def _ulp_close(vals, ulps=2):
    vals = np.asarray(vals, np.float32)
    return float(vals.max() - vals.min()) <= ulps * float(np.spacing(np.abs(vals).max()))


def assert_draws_agree(jpos, jvalid, tpos, tvalid, scores):
    """Flags bit-equal; positions bit-equal on valid lanes except counted
    near-ties (the lanes that change places score within 2 ULP in the
    port); at most one near-tie row in 2,000. Returns the near-tie
    count."""
    jpos, jvalid = np.asarray(jpos), np.asarray(jvalid)
    tpos, tvalid = np.asarray(tpos), np.asarray(tvalid)
    assert np.array_equal(jvalid, tvalid)
    differ = (jpos != tpos) & jvalid
    rows = np.nonzero(differ.any(axis=1))[0]
    for r in rows:
        lanes = set(jpos[r][differ[r]].tolist()) | set(tpos[r][differ[r]].tolist())
        assert _ulp_close(scores[r, sorted(lanes)]), (r, lanes, scores[r, sorted(lanes)])
    assert len(rows) <= jpos.shape[0] // 2000, f"{len(rows)} near-tie rows of {jpos.shape[0]}"
    return len(rows)


def _weighted_graph(seed=0, zero_frac=0.05):
    """Random graph with a hub of degree 600 (past max_deg 512 and across
    tile rows), a node of degree 0 and a node whose weights are all 0."""
    rng = np.random.default_rng(seed)
    ei = make_random_graph(N_NODES, 4000, seed=seed)
    ei = ei[:, (ei[0] != 5) & (ei[0] != 9) & (ei[0] != 11)]
    hub = np.stack([np.full(600, 5), rng.integers(0, N_NODES, 600)])
    zero = np.stack([np.full(20, 11), rng.integers(0, N_NODES, 20)])
    ei = np.concatenate([ei, hub, zero], axis=1)
    w = rng.uniform(0.0, 1.0, ei.shape[1]).astype(np.float32)
    w[rng.random(ei.shape[1]) < zero_frac] = 0.0
    w[ei[0] == 11] = 0.0
    return ei, w


# -- the uniform, the ordering, the Gumbel top-k ------------------------------------

@pytest.mark.parametrize("minval,maxval", [(1e-20, 1.0), (0.0, 1.0), (-2.5, 3.25), (0.3, 0.7)])
def test_uniform_with_minval_bit_equal(minval, maxval):
    want = np.asarray(jax.random.uniform(jax.random.key(4), (300, 77), minval=minval,
                                         maxval=maxval))
    got = qrandom.uniform(qrandom.key(4), (300, 77), minval=minval, maxval=maxval).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    assert got.min() >= np.float32(minval)


def test_topk_lane_order_matches_lax_top_k_on_ties_and_neg_inf():
    inf = np.inf
    row = np.array([[-inf, 1, -inf, 2, -inf, 1, -inf]], np.float32)
    _, pos = tsample.topk_lane_order(torch.from_numpy(row), 6)
    assert pos.tolist() == [[3, 1, 5, 0, 2, 4]]
    rng = np.random.default_rng(1)
    scores = rng.integers(-3, 3, (200, 40)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = -inf
    jv, jp = jax.lax.top_k(jnp.asarray(scores), 12)
    tv, tp = tsample.topk_lane_order(torch.from_numpy(scores), 12)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("W,k", [(128, 4), (512, 8)])
def test_gumbel_topk_positions_against_jax(W, k):
    rng = np.random.default_rng(W + k)
    B = 2000
    w = rng.uniform(0.0, 1.0, (B, W)).astype(np.float32)
    w[rng.random((B, W)) < 0.05] = 0.0
    w[0] = 0.0                        # a row of zero weights: nothing valid
    w[1, :3] = np.nan                 # NaN weights are never drawn
    deg = rng.integers(0, W + 1, B).astype(np.int32)
    deg[2], deg[3] = 0, min(k - 1, W)  # empty and copy-all rows
    w[3] = 0.5
    jk, tk = _keys(7, W)
    jpos, jvalid = jsample.gumbel_topk_positions(jk, jnp.asarray(deg), k, jnp.asarray(w))
    tpos, tvalid = tsample.gumbel_topk_positions(tk, torch.from_numpy(deg), k,
                                                 torch.from_numpy(w))
    assert tpos.dtype == torch.int32 and tvalid.dtype == torch.bool
    scores = tsample.gumbel_scores(tk, torch.from_numpy(deg), torch.from_numpy(w)).numpy()
    assert_draws_agree(jpos, jvalid, tpos, tvalid, scores)
    assert not tvalid[0].any() and not tvalid[2].any()
    assert int(tvalid[3].sum()) == min(k - 1, W)
    assert not np.isin(tpos[1][tvalid[1]].numpy(), [0, 1, 2]).any()
    # the scores themselves, where finite on both sides: JAX's float32 chain
    u = jax.random.uniform(jk, (B, W), minval=1e-20, maxval=1.0)
    jw = jnp.maximum(jnp.asarray(w), 0.0)
    jscores = np.asarray(jnp.log(jnp.maximum(jw, 1e-30)) - jnp.log(-jnp.log(u)))
    live = np.isfinite(scores)
    np.testing.assert_allclose(scores[live], jscores[live], atol=1e-4, rtol=0)


# -- the weighted layers -------------------------------------------------------------

def _layer_case(k, seed=3):
    ei, w = _weighted_graph()
    rng = np.random.default_rng(seed + k)
    seeds = rng.integers(0, N_NODES, 257).astype(np.int32)
    seeds[:4] = [5, 9, 11, 0]            # hub, degree 0, all-zero weights
    seeds[4] = N_NODES + 40               # out of range: clipped
    valid = np.ones(seeds.shape[0], bool)
    valid[5:9] = False
    return ei, w, seeds, valid


def _window(topo, seeds, valid, max_deg, layout):
    """``(deg, weight rows)`` of the window a layer draws over, as numpy:
    lanes past a row's degree hold other rows' weights, which the draw
    masks, so the flat lanes give the tiled window's scores too."""
    s = np.clip(seeds.astype(np.int64), 0, N_NODES - 1)
    ptr = topo.indptr[s]
    deg = np.where(valid, np.minimum(topo.indptr[s + 1] - ptr, max_deg), 0).astype(np.int32)
    W = tsample.gumbel_window(max_deg, layout)
    lanes = np.clip(ptr[:, None] + np.arange(W)[None, :], 0, topo.edge_count - 1)
    return deg, topo.edge_weights[lanes]


@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("max_deg,k", [(128, 4), (512, 8)])
def test_weighted_layers_against_jax(layout, max_deg, k):
    ei, w, seeds, valid = _layer_case(k)
    jt = JCSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    tt = CSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    jk, tk = _keys(SEED, k)
    js, jv = jnp.asarray(seeds), jnp.asarray(valid)
    ts, tv = torch.from_numpy(seeds), torch.from_numpy(valid)
    if layout == "flat":
        jn, jval = jsample.weighted_sample_layer(*jt.to_device(), jnp.asarray(jt.edge_weights),
                                                 js, jv, k, jk, max_deg=max_deg)
        tn, tval = tsample.weighted_sample_layer(*tt.to_device("cpu"), tt.to_device_weights("cpu"),
                                                 ts, tv, k, tk, max_deg=max_deg)
    else:
        jn, jval = jsample.tiled_weighted_sample_layer(
            *jt.to_device_tiled(), jt.to_device_tiled_weights(), js, jv, k, jk, max_deg=max_deg)
        tn, tval = tsample.tiled_weighted_sample_layer(
            *tt.to_device_tiled("cpu"), tt.to_device_tiled_weights("cpu"), ts, tv, k, tk,
            max_deg=max_deg)
    jn, jval = np.asarray(jn), np.asarray(jval)
    assert tn.dtype == torch.int32 and tval.dtype == torch.bool
    # the same window's positions on both sides: flags equal, near-ties counted
    deg, rows = _window(tt, seeds, valid, max_deg, layout)
    jpos, jpv = jsample.gumbel_topk_positions(jk, jnp.asarray(deg), k, jnp.asarray(rows))
    tpos, tpv = tsample.gumbel_topk_positions(tk, torch.from_numpy(deg), k, torch.from_numpy(rows))
    scores = tsample.gumbel_scores(tk, torch.from_numpy(deg), torch.from_numpy(rows)).numpy()
    assert_draws_agree(jpos, jpv, tpos, tpv, scores)
    assert np.array_equal(tpv.numpy(), tval.numpy()) and np.array_equal(jval, tval.numpy())
    # ids differ only on the rows whose positions differ
    same_pos = ((np.asarray(jpos) == tpos.numpy()) | ~jval).all(axis=1)
    assert ((jn == tn.numpy()) | ~jval)[same_pos].all()
    tval = tval.numpy()
    assert not tval[1].any() and not tval[2].any() and not tval[5:9].any()
    assert tval[0].all()  # the hub draws k of its first max_deg edges


def test_weighted_copy_all_and_zero_weight():
    indptr = torch.tensor([0, 2, 5], dtype=torch.int32)
    indices = torch.tensor([7, 8, 1, 2, 3], dtype=torch.int32)
    weights = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0])
    seeds = torch.tensor([0, 1] * 200, dtype=torch.int32)
    nbrs, valid = tsample.weighted_sample_layer(indptr, indices, weights, seeds,
                                                torch.ones(400, dtype=torch.bool), 3,
                                                qrandom.key(1), 8)
    nbrs, valid = nbrs.numpy(), valid.numpy()
    assert set(nbrs[::2][valid[::2]].tolist()) == {7, 8}
    assert valid[::2].sum(axis=1).max() == 2
    r1 = nbrs[1::2][valid[1::2]]
    assert 2 not in set(r1.tolist()) and set(r1.tolist()) == {1, 3}
    jn, jv = jsample.weighted_sample_layer(jnp.asarray(indptr.numpy()), jnp.asarray(indices.numpy()),
                                           jnp.asarray(weights.numpy()), jnp.asarray(seeds.numpy()),
                                           jnp.ones((400,), bool), 3, jax.random.key(1), 8)
    assert np.array_equal(np.asarray(jv), valid)
    assert np.array_equal(np.asarray(jn)[np.asarray(jv)], nbrs[valid])


@pytest.mark.parametrize("max_deg", [128, 512])
def test_flat_and_tiled_weighted_draws_are_equal(max_deg):
    ei, w, seeds, valid = _layer_case(8, seed=9)
    tt = CSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    ts, tv = torch.from_numpy(seeds), torch.from_numpy(valid)
    key = qrandom.key(21)
    fn, fv = tsample.weighted_sample_layer(*tt.to_device("cpu"), tt.to_device_weights("cpu"),
                                           ts, tv, 8, key, max_deg)
    tn, tval = tsample.tiled_weighted_sample_layer(*tt.to_device_tiled("cpu"),
                                                   tt.to_device_tiled_weights("cpu"), ts, tv, 8,
                                                   key, max_deg)
    assert torch.equal(fv, tval) and torch.equal(fn[fv], tn[tval])


def test_weighted_layers_refuse_what_the_kernel_does_not_take():
    ei, w, seeds, valid = _layer_case(4)
    tt = CSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    ts, tv = torch.from_numpy(seeds), torch.from_numpy(valid)
    with pytest.raises(ValueError):  # seeds and flags of different shapes
        tsample.weighted_sample_layer(*tt.to_device("cpu"), tt.to_device_weights("cpu"),
                                      ts, tv[:-1], 4, qrandom.key(0))
    with pytest.raises(ValueError):  # a graph tensor on another device than the seeds
        tsample.tiled_weighted_sample_layer(*tt.to_device_tiled("cpu"),
                                            tt.to_device_tiled_weights("cpu"),
                                            ts.to("meta"), tv.to("meta"), 4, qrandom.key(0))


# -- CSRTopo(edge_weights=) and the weighted sampler ------------------------------------

def test_csr_topo_edge_weights_follow_the_stable_sort():
    ei, w = _weighted_graph(seed=2)
    jt = JCSRTopo(edge_index=ei, edge_weights=w)
    tt = CSRTopo(edge_index=ei, edge_weights=w)
    assert tt.edge_weights.dtype == np.float32
    assert np.array_equal(jt.edge_weights, tt.edge_weights)
    assert np.array_equal(np.asarray(jt.to_device_tiled_weights()),
                          tt.to_device_tiled_weights("cpu").numpy())
    assert tt.to_device_tiled_weights("cpu") is tt.to_device_tiled_weights("cpu")  # cached
    direct = CSRTopo(indptr=tt.indptr, indices=tt.indices, edge_weights=tt.edge_weights)
    assert np.array_equal(direct.edge_weights, tt.edge_weights)
    with pytest.raises(ValueError):
        CSRTopo(edge_index=ei, edge_weights=w[:-1])
    with pytest.raises(ValueError):
        CSRTopo(indptr=tt.indptr, indices=tt.indices, edge_weights=w[:-1])
    with pytest.raises(ValueError):
        CSRTopo(edge_index=ei).to_device_tiled_weights("cpu")


def _samplers(layout, dedup=True, max_deg=128):
    ei, w = _weighted_graph(seed=4)
    kw = dict(sizes=[4, 3], seed=SEED, dedup=dedup, weighted=True, max_deg=max_deg,
              layout=layout)
    return (JSampler(JCSRTopo(edge_index=ei, edge_weights=w), mode="TPU", **kw),
            GraphSageSampler(CSRTopo(edge_index=ei, edge_weights=w), device="cpu", **kw))


@pytest.mark.parametrize("layout,dedup", [("tiled", True), ("flat", True), ("tiled", False)])
def test_weighted_sampler_sample_dense_bit_equal(layout, dedup):
    js, ts = _samplers(layout, dedup)
    rng = np.random.default_rng(6)
    for _ in range(3):
        seeds = rng.choice(N_NODES, 24, replace=False)
        jds, tds = js.sample_dense(seeds), ts.sample_dense(seeds)
        assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
        assert int(jds.count) == int(tds.count)
        for ja, ta in zip(jds.adjs, tds.adjs):
            assert np.array_equal(np.asarray(ja.mask), ta.mask.numpy())
            if ja.cols is not None:
                m = np.asarray(ja.mask)
                assert np.array_equal(np.asarray(ja.cols)[m], ta.cols.numpy()[m])


def test_weighted_sampler_needs_weights_and_fuses():
    ei, _ = _weighted_graph()
    with pytest.raises(ValueError):
        GraphSageSampler(CSRTopo(edge_index=ei), [4], device="cpu", weighted=True)
    js, ts = _samplers("tiled", dedup=False)
    graph, bind, id_dtype = ts.fused_sample_spec()
    assert len(graph) == 3 and graph[2].dtype == torch.float32 and id_dtype == torch.int32
    seeds = torch.arange(10, dtype=torch.int32)
    key = qrandom.key(3)
    n1, v1 = bind(graph)(seeds, torch.ones(10, dtype=torch.bool), 4, key)
    n2, v2 = tsample.tiled_weighted_sample_layer(*graph, seeds, torch.ones(10, dtype=torch.bool),
                                                 4, key, ts.max_deg)
    assert torch.equal(n1, n2) and torch.equal(v1, v2)


def test_weighted_train_loss_curve_matches_jax():
    """Five Adam steps from identical weights on the weighted sampler's
    batches: the port's losses within 1e-4 of the optax loop's."""
    js, ts = _samplers("tiled", dedup=True)
    dim, classes = 12, 4
    table = np.random.default_rng(0).standard_normal((N_NODES, dim)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, classes, N_NODES)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=classes, num_layers=2, dropout=0.0)
    rng = np.random.default_rng(11)
    batches = [rng.choice(N_NODES, 16, replace=False) for _ in range(5)]
    jds = [js.sample_dense(b) for b in batches]
    jxs = [jnp.take(jnp.asarray(table), jnp.clip(d.n_id, 0, N_NODES - 1), axis=0) for d in jds]
    jparams = jmodel.init(jax.random.key(0), jxs[0], jds[0].adjs)
    model = GraphSAGE(dim, 16, classes, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    tx, opt = optax.adam(5e-3), torch.optim.Adam(model.parameters(), lr=5e-3)
    jstate = tx.init(jparams)
    feat = torch.from_numpy(table)
    jl, tl = [], []
    for b, d, x in zip(batches, jds, jxs):
        y = labels[b]

        def loss_fn(p):
            logits = jmodel.apply(p, x, d.adjs)
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

        loss, grads = jax.value_and_grad(loss_fn)(jparams)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tds = ts.sample_dense(b)
        tloss = F.cross_entropy(model(lookup_features(feat, tds.n_id), tds.adjs, train=True),
                                torch.from_numpy(y))
        opt.zero_grad()
        tloss.backward()
        opt.step()
        jl.append(float(loss))
        tl.append(float(tloss.detach()))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert np.isfinite(tl).all()

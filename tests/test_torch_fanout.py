"""Fanouts above 32 in the port against quiver_tpu, on the CPU: the
neighbor mean and its gradient, the weighted and temporal draws and a
GraphSAGE step at k = 33 and 64, on the same numpy inputs and keys. On the
card the same calls run the kernels, whose lanes are taken 32 at a time
above k = 32; tests/test_torch_kernels.py holds those against these plain
versions.

Bars: the mean, its gradient (``jax.vjp`` against the port's autograd),
one step's loss and every parameter gradient within atol = rtol = 1e-5
(torch and XLA sum in different orders); samples bit-equal; the Gumbel
draws' flags bit-equal and their positions and ids bit-equal except the
near-ties that tests/test_torch_weighted.py counts (at most 1 row in
2,000)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.models.sage import masked_mean_aggregate as j_mean
from quiver_tpu.ops import sample as jsample
from quiver_tpu.pyg import sage_sampler as jss
from quiver_tpu.pyg.sage_sampler import DenseAdj as JDenseAdj
from quiver_tpu.workloads import TemporalTiledGraph as JTemporalTiledGraph
from quiver_tpu_torch import CSRTopo, GraphSAGE, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.inference import lookup_features
from quiver_tpu_torch.models.sage import masked_mean_aggregate
from quiver_tpu_torch.ops import sample as tsample
from quiver_tpu_torch.pyg import sage_sampler as tss
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj
from quiver_tpu_torch.workloads import TemporalTiledGraph

from test_torch_weighted import N_NODES, _weighted_graph, assert_draws_agree

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
DIM, CLASSES = 16, 5


# -- the neighbor mean and its gradient -----------------------------------------------

@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("structural", [False, True])
def test_masked_mean_and_gradient_match_jax_at_wide_fanouts(k, structural):
    rng = np.random.default_rng(k)
    W = 24
    mask = rng.random((W, k)) < 0.6
    mask[0] = False                   # a target with no valid neighbor
    mask[1] = True                    # a target with all k
    w_src = W * (1 + k) + 3
    cols = None
    if not structural:
        w_src = 300
        cols = rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)  # clipped both ends
        cols[2] = 7                   # one target names row 7 k times
    x = rng.standard_normal((w_src, DIM)).astype(np.float32)
    R = rng.standard_normal((W, DIM)).astype(np.float32)
    z = np.zeros((), np.int32)
    jadj = JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)
    want, vjp = jax.vjp(lambda v: j_mean(v, jadj), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(R))
    tadj = DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    None, None)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = masked_mean_aggregate(xt, tadj)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), **TOL)
    assert not got[0].detach().any() and np.asarray(want_grad).any()


# -- the weighted and temporal draws ----------------------------------------------------

def _draw_case(k):
    ei, w = _weighted_graph()
    rng = np.random.default_rng(40 + k)
    seeds = rng.integers(0, N_NODES, 257).astype(np.int32)
    seeds[:4] = [5, 9, 11, 0]            # hub, degree 0, all-zero weights
    seeds[4] = N_NODES + 40               # out of range: clipped
    valid = np.ones(seeds.shape[0], bool)
    valid[5:9] = False
    return ei, w, seeds, valid


@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("layer", ["flat", "tiled", "temporal"])
def test_gumbel_layers_match_jax_at_wide_fanouts(k, layer):
    max_deg = 128
    ei, w, seeds, valid = _draw_case(k)
    jt = JCSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    tt = CSRTopo(edge_index=ei, num_nodes=N_NODES, edge_weights=w)
    jk = jax.random.fold_in(jax.random.key(13), k)
    tk = qrandom.fold_in(qrandom.key(13), k)
    js, jv = jnp.asarray(seeds), jnp.asarray(valid)
    ts, tv = torch.from_numpy(seeds), torch.from_numpy(valid)
    s = np.clip(seeds.astype(np.int64), 0, N_NODES - 1)
    deg = np.where(valid, np.minimum(tt.indptr[s + 1] - tt.indptr[s], max_deg), 0).astype(np.int32)
    if layer == "flat":
        jn, jval = jsample.weighted_sample_layer(*jt.to_device(), jnp.asarray(jt.edge_weights),
                                                 js, jv, k, jk, max_deg=max_deg)
        tn, tval = tsample.weighted_sample_layer(*tt.to_device("cpu"), tt.to_device_weights("cpu"),
                                                 ts, tv, k, tk, max_deg=max_deg)
    elif layer == "tiled":
        jn, jval = jsample.tiled_weighted_sample_layer(
            *jt.to_device_tiled(), jt.to_device_tiled_weights(), js, jv, k, jk, max_deg=max_deg)
        tn, tval = tsample.tiled_weighted_sample_layer(
            *tt.to_device_tiled("cpu"), tt.to_device_tiled_weights("cpu"), ts, tv, k, tk,
            max_deg=max_deg)
    else:
        edge_ts = np.random.default_rng(11).uniform(0.0, 50.0, tt.edge_count).astype(np.float32)
        jg = JTemporalTiledGraph(jt, edge_ts).temporal_graph()
        tg = TemporalTiledGraph(tt, edge_ts, device="cpu").temporal_graph()
        tq = np.random.default_rng(12).uniform(0.0, 60.0, seeds.shape[0]).astype(np.float32)
        tq[0] = np.inf
        jn, jval = jsample.tiled_temporal_sample_layer(*jg, js, jv, k, jk, jnp.asarray(tq),
                                                       max_deg=max_deg, recency=0.02)
        tn, tval = tsample.tiled_temporal_sample_layer(*tg, ts, tv, k, tk, torch.from_numpy(tq),
                                                       max_deg=max_deg, recency=0.02)
    # the window both sides draw over, as numpy
    W = tsample.gumbel_window(max_deg, "flat" if layer == "flat" else "tiled")
    lanes = np.clip(tt.indptr[s][:, None] + np.arange(W)[None, :], 0, tt.edge_count - 1)
    if layer == "temporal":
        rows = tsample.temporal_weight_rows(torch.from_numpy(edge_ts[lanes]),
                                            torch.from_numpy(tq), 0.02).numpy()
    else:
        rows = tt.edge_weights[lanes]
    jpos, jpv = jsample.gumbel_topk_positions(jk, jnp.asarray(deg), k, jnp.asarray(rows))
    tpos, tpv = tsample.gumbel_topk_positions(tk, torch.from_numpy(deg), k,
                                              torch.from_numpy(rows))
    scores = tsample.gumbel_scores(tk, torch.from_numpy(deg), torch.from_numpy(rows)).numpy()
    assert_draws_agree(jpos, jpv, tpos, tpv, scores)
    jn, jval, tval = np.asarray(jn), np.asarray(jval), tval.numpy()
    assert tn.shape == (seeds.shape[0], k)
    assert np.array_equal(tpv.numpy(), tval) and np.array_equal(jval, tval)
    same_pos = ((np.asarray(jpos) == tpos.numpy()) | ~jval).all(axis=1)
    assert ((jn == tn.numpy()) | ~jval)[same_pos].all()
    assert not tval[1].any() and not tval[5:9].any()  # degree 0, invalid seeds
    if layer != "temporal":  # all-zero weights; the hub draws k of its first max_deg edges
        assert not tval[2].any() and tval[0].all()


# -- a GraphSAGE step ---------------------------------------------------------------------

def _hub_graph():
    rng = np.random.default_rng(3)
    n = 300
    src, dst = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    hub = np.stack([np.full(150, 4), rng.integers(0, n, 150)])
    return np.concatenate([np.stack([src, dst]), hub], axis=1), n


@pytest.mark.parametrize("sizes", [(33, 5), (64, 5)])
def test_graphsage_step_matches_jax_at_wide_fanouts(sizes):
    """A 2-layer GraphSAGE forward and backward on the flat sampler's dense
    sample, from the JAX model's weights carried over: the sample bit-equal,
    the loss and every parameter gradient within 1e-5."""
    ei, n = _hub_graph()
    jt, tt = JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)
    table = np.random.default_rng(0).standard_normal((n, DIM)).astype(np.float32)
    labels = np.random.default_rng(7).integers(0, CLASSES, n).astype(np.int32)
    seeds = (np.arange(16) * 19 % n).astype(np.int32)
    seeds[0] = 4  # the hub: k of its 150+ neighbors
    jk = jax.random.fold_in(jax.random.key(5), 0)
    tk = qrandom.fold_in(qrandom.key(5), 0)
    jds = jss.sample_dense_pure(*jt.to_device(), jk, jnp.asarray(seeds), sizes)
    tds = tss.sample_dense_pure(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), sizes)
    assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
    for ja, ta in zip(jds.adjs, tds.adjs):
        assert np.array_equal(np.asarray(ja.mask), ta.mask.numpy())
    assert tds.adjs[-1].mask.shape == (16, sizes[0]) and bool(tds.adjs[-1].mask[0].all())
    jx = jnp.take(jnp.asarray(table), jnp.clip(jds.n_id, 0, n - 1), axis=0)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    jparams = jmodel.init(jax.random.key(0), jx, jds.adjs)
    y = labels[seeds]

    def loss_fn(p):
        logits = jmodel.apply(p, jx, jds.adjs)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    tx = lookup_features(torch.from_numpy(table), tds.n_id)
    loss = F.cross_entropy(model(tx, tds.adjs, train=True), torch.from_numpy(y.astype(np.int64)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL, err_msg=name)

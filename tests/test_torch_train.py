"""Parity of the port's training slice with quiver_tpu's, on the CPU: the
neighbor-mean gradient, the two sample-and-gather pipelines, one training
step, an Adam loss curve, the community-classification loop of
tests/test_e2e.py, full-neighbor inference, sampled eval and the example.

Shapes: the 200-node, 2,000-edge graph of tests/test_torch_sage.py (DIM
16, sizes [4, 4], seed 3) and tests/test_e2e.py's community graph. Inputs
come from seeded numpy and go through both packages. Bars:
- samples and gathered rows bit-equal (integer outputs and pure copies);
- the mean's gradient, one step's loss and every parameter gradient, the
  full-neighbor mean and full inference within atol = rtol = 1e-5: torch
  and XLA sum in different orders;
- the 20-step Adam loss curve within 1e-4: Adam divides each update by
  sqrt(v), so a last-bit difference in a near-zero gradient element moves
  that element by up to lr, and the curves drift apart slowly;
- sampled eval and full-inference accuracy equal.
Dropout is 0 in every parity test (flax's dropout bits cannot be
matched); the dropout path is tested for its generator discipline."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.inference import full_inference_accuracy as j_full_acc
from quiver_tpu.inference import full_mean_aggregate as j_full_mean
from quiver_tpu.inference import sage_full_inference as j_full_inference
from quiver_tpu.inference import sampled_eval as j_sampled_eval
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.models.sage import masked_mean_aggregate as j_mean
from quiver_tpu.pyg import sage_sampler as jss
from quiver_tpu.pyg.sage_sampler import DenseAdj as JDenseAdj
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.inference import (
    bind_params,
    full_inference_accuracy,
    full_mean_aggregate,
    lookup_features,
    sage_full_inference,
    sampled_eval,
)
from quiver_tpu_torch.models.sage import masked_mean_aggregate, masked_mean_backward
from quiver_tpu_torch.pyg import sage_sampler as tss
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj

from conftest import make_random_graph
from test_e2e import make_community_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, CLASSES = 200, 16, (4, 4), 3, 5
TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _topos():
    ei = make_random_graph(N_NODES, 2000, seed=0)
    return JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)


def _table():
    return np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(jparams, hidden=16, out=CLASSES, layers=2):
    model = GraphSAGE(DIM, hidden, out, num_layers=layers, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(_np_tree(jparams)))
    return model


def _grads_as_torch(jgrads):
    """A flax gradient tree in the port's state_dict layout."""
    return sage_params_from_flax(_np_tree(jgrads))


# -- the neighbor mean's gradient ------------------------------------------------

def _grad_case(structural, W=12, k=5, w_src=40, seed=4):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, k)) < 0.6
    mask[0] = False                       # a target with cnt = 0
    cols = None
    if not structural:
        cols = rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)  # clipped both ends
        cols[1] = 7                       # one target names row 7 k times
        cols[2, :2] = 7                   # ... and another names it twice
        mask[1] = True
    else:
        w_src = W * (1 + k) + 3           # rows past the structural block get nothing
    x = rng.standard_normal((w_src, DIM)).astype(np.float32)
    R = rng.standard_normal((W, DIM)).astype(np.float32)
    return x, mask, cols, R


@pytest.mark.parametrize("structural", [False, True])
def test_masked_mean_gradient_matches_jax(structural):
    x, mask, cols, R = _grad_case(structural)
    z = np.zeros((), np.int32)
    jadj = JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)
    want = np.asarray(jax.grad(lambda v: jnp.sum(j_mean(v, jadj) * R))(jnp.asarray(x)))
    tadj = DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    None, None)
    xt = torch.from_numpy(x).requires_grad_(True)
    (masked_mean_aggregate(xt, tadj) * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)
    assert want.any()
    # the function alone, as the autograd backward calls it
    direct = masked_mean_backward(torch.from_numpy(R), tadj.mask, tadj.cols, x.shape[0])
    np.testing.assert_allclose(direct.numpy(), want, **TOL)


def test_masked_mean_needs_no_gradient_from_a_constant_table():
    x, mask, cols, _ = _grad_case(False)
    adj = DenseAdj(torch.from_numpy(cols), torch.from_numpy(mask), None, None)
    out = masked_mean_aggregate(torch.from_numpy(x), adj)
    assert not out.requires_grad


# -- sample-and-gather -----------------------------------------------------------

def _assert_samples_equal(jds, tds):
    assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
    assert int(jds.count) == int(tds.count) and jds.batch_size == tds.batch_size
    for ja, ta in zip(jds.adjs, tds.adjs):
        mask = np.asarray(ja.mask)
        assert np.array_equal(mask, ta.mask.numpy())
        assert int(ja.n_src) == int(ta.n_src) and int(ja.n_dst) == int(ta.n_dst)
        assert (ja.cols is None) == (ta.cols is None)
        if ja.cols is not None:
            assert np.array_equal(np.asarray(ja.cols)[mask], ta.cols.numpy()[mask])


@pytest.mark.parametrize("fn,caps", [("sample_and_gather_fused", None),
                                     ("sample_and_gather_dedup", None),
                                     ("sample_and_gather_dedup", (20, None))])
def test_sample_and_gather_bit_equal(fn, caps):
    jt, tt = _topos()
    table = _table()
    seeds = (np.arange(8) * 23 % N_NODES).astype(np.int32)
    seeds[1] = seeds[0]
    jk = jax.random.fold_in(jax.random.key(SEED), 2)
    tk = qrandom.fold_in(qrandom.key(SEED), 2)
    kw = {} if caps is None else dict(caps=caps)
    jds, jx = getattr(jss, fn)(*jt.to_device(), jnp.asarray(table), jk, jnp.asarray(seeds),
                               SIZES, **kw)
    tds, tx = getattr(tss, fn)(*tt.to_device("cpu"), torch.from_numpy(table), tk,
                               torch.from_numpy(seeds), SIZES, **kw)
    _assert_samples_equal(jds, tds)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    if jds.cap_overflow is not None:
        assert int(jds.cap_overflow) == int(tds.cap_overflow)
        assert np.array_equal(np.asarray(jds.raw_counts), tds.raw_counts.numpy())


# -- training --------------------------------------------------------------------

def _labels():
    return np.random.default_rng(7).integers(0, CLASSES, N_NODES).astype(np.int32)


def _jax_loss_fn(jmodel, x, adjs, y):
    def loss_fn(p):
        logits = jmodel.apply(p, x, adjs)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    return loss_fn


@pytest.mark.parametrize("pipeline", ["sample_dense", "fused", "dedup"])
def test_one_training_step_loss_and_gradients_match(pipeline):
    """One step from identical weights through each sampling pipeline:
    the structural layout (fused), the cols layout (sample_dense) and
    both (dedup) feed the backward."""
    jt, tt = _topos()
    table, labels = _table(), _labels()
    seeds = (np.arange(8) * 31 % N_NODES).astype(np.int32)
    jk = jax.random.fold_in(jax.random.key(SEED), 0)
    tk = qrandom.fold_in(qrandom.key(SEED), 0)
    if pipeline == "sample_dense":
        jds = jss.sample_dense_pure(*jt.to_device(), jk, jnp.asarray(seeds), SIZES)
        tds = tss.sample_dense_pure(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), SIZES)
        jx = jnp.take(jnp.asarray(table), jnp.clip(jds.n_id, 0, N_NODES - 1), axis=0)
        tx = lookup_features(torch.from_numpy(table), tds.n_id)
    else:
        fn = "sample_and_gather_" + pipeline
        jds, jx = getattr(jss, fn)(*jt.to_device(), jnp.asarray(table), jk, jnp.asarray(seeds),
                                   SIZES)
        tds, tx = getattr(tss, fn)(*tt.to_device("cpu"), torch.from_numpy(table), tk,
                                   torch.from_numpy(seeds), SIZES)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    jparams = jmodel.init(jax.random.key(0), jx, jds.adjs)
    y = labels[seeds]
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodel, jx, jds.adjs, jnp.asarray(y)))(jparams)
    model = _port_model(jparams)
    loss = F.cross_entropy(model(tx, tds.adjs, train=True), torch.from_numpy(y.astype(np.int64)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = _grads_as_torch(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **TOL, err_msg=name)


def test_adam_loss_curve_matches_optax():
    jt, tt = _topos()
    table, labels = _table(), _labels()
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(tt, sizes=list(SIZES), mode="TPU", seed=SEED, device="cpu")
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    rng = np.random.default_rng(11)
    batches = [rng.choice(N_NODES, 16, replace=False) for _ in range(20)]
    jds0 = js.sample_dense(batches[0])
    jx0 = jnp.take(jnp.asarray(table), jnp.clip(jds0.n_id, 0, N_NODES - 1), axis=0)
    jparams = jmodel.init(jax.random.key(0), jx0, jds0.adjs)
    tx_opt = optax.adam(5e-3)
    jstate = tx_opt.init(jparams)
    model = _port_model(jparams)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    feat = torch.from_numpy(table)

    @jax.jit
    def jstep(params, state, x, adjs, y):
        loss, grads = jax.value_and_grad(_jax_loss_fn(jmodel, x, adjs, y))(params)
        updates, state = tx_opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    jlosses, tlosses = [], []
    for i, seeds in enumerate(batches):
        jds = jds0 if i == 0 else js.sample_dense(seeds)
        tds = ts.sample_dense(seeds)
        jx = jnp.take(jnp.asarray(table), jnp.clip(jds.n_id, 0, N_NODES - 1), axis=0)
        y = labels[seeds]
        jparams, jstate, jloss = jstep(jparams, jstate, jx, jds.adjs, jnp.asarray(y))
        loss = F.cross_entropy(model(lookup_features(feat, tds.n_id), tds.adjs, train=True),
                               torch.from_numpy(y.astype(np.int64)))
        opt.zero_grad()
        loss.backward()
        opt.step()
        jlosses.append(float(jloss))
        tlosses.append(float(loss.detach()))
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["GPU", "TPU"])
def test_train_community_classification(mode):
    """tests/test_e2e.py::test_train_community_classification on the port:
    60 Adam steps of batch 32 halve the loss, and a fresh batch is
    classified with accuracy above 0.9."""
    edge_index, feat_np, labels, n = make_community_graph()
    topo = CSRTopo(edge_index=edge_index)
    sampler = GraphSageSampler(topo, sizes=[5, 5], mode=mode, seed=0, device="cpu")
    feature = Feature(rank=0, device_list=[0], device_cache_size=n * 16 * 4, device="cpu")
    feature.from_cpu_tensor(feat_np)
    model = GraphSAGE(16, 32, 4, num_layers=2, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    labels_t = torch.from_numpy(labels.astype(np.int64))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        ds = sampler.sample_dense(rng.choice(n, 32, replace=False))
        x = feature.lookup_padded(ds.n_id)
        loss = F.cross_entropy(model(x, ds.adjs, train=True), labels_t[ds.n_id[:32].long()])
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.5, losses
    seeds = rng.choice(n, 128, replace=False)
    ds = sampler.sample_dense(seeds)
    with torch.no_grad():
        pred = model(feature.lookup_padded(ds.n_id), ds.adjs).argmax(-1).numpy()
    assert (pred == labels[seeds]).mean() > 0.9


def test_dropout_draws_from_the_given_generator_only():
    _, tt = _topos()
    ts = GraphSageSampler(tt, sizes=list(SIZES), seed=SEED, device="cpu")
    ds = ts.sample_dense(np.arange(8))
    x = lookup_features(torch.from_numpy(_table()), ds.n_id)
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.5)
    model.reset_parameters(torch.Generator().manual_seed(0))
    a = model(x, ds.adjs, train=True, generator=torch.Generator().manual_seed(9))
    torch.manual_seed(123)  # the global RNG plays no part
    b = model(x, ds.adjs, train=True, generator=torch.Generator().manual_seed(9))
    c = model(x, ds.adjs, train=True, generator=torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(x, ds.adjs), model(x, ds.adjs, train=False))
    with pytest.raises(ValueError):
        model(x, ds.adjs, train=True)


# -- full-neighbor inference and eval ---------------------------------------------

def _graph_with_isolated_node():
    ei = make_random_graph(N_NODES, 2000, seed=1)
    ei = ei[:, ei[0] != 7]  # node 7 keeps in-edges but has degree 0
    return JCSRTopo(edge_index=ei, num_nodes=N_NODES), CSRTopo(edge_index=ei,
                                                                num_nodes=N_NODES)


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_full_mean_aggregate_matches_jax(id_dtype):
    jt, tt = _graph_with_isolated_node()
    h = np.random.default_rng(2).standard_normal((N_NODES, 24)).astype(np.float32)
    want = np.asarray(j_full_mean(*jt.to_device(), jnp.asarray(h), edge_chunk=512))
    got = full_mean_aggregate(*tt.to_device("cpu", id_dtype=id_dtype), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tt.degree[7] == 0 and not got[7].any()


def test_sage_full_inference_and_accuracy_match_jax():
    jt, tt = _graph_with_isolated_node()
    table = _table()
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    jds = js.sample_dense(np.arange(8))
    jparams = jmodel.init(jax.random.key(1), jnp.zeros((jds.n_id.shape[0], DIM)), jds.adjs)
    want = np.asarray(j_full_inference(jmodel, jparams, *jt.to_device(), jnp.asarray(table)))
    model = bind_params(_port_model(jparams), None, "cpu")
    got = sage_full_inference(model, *tt.to_device("cpu"), table)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    labels, nodes = _labels(), np.arange(0, N_NODES, 3)
    assert full_inference_accuracy(model, tt, table, labels, nodes) == j_full_acc(
        jmodel, jparams, jt, table, labels, nodes)


def test_sampled_eval_equals_jax():
    jt, tt = _topos()
    table, labels = _table(), _labels()
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(tt, sizes=list(SIZES), mode="TPU", seed=SEED, device="cpu")
    jds = js.sample_dense(np.arange(8))
    jparams = jmodel.init(jax.random.key(2), jnp.zeros((jds.n_id.shape[0], DIM)), jds.adjs)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)  # fresh key stream
    nodes = np.random.default_rng(4).choice(N_NODES, 21, replace=False)  # 8 + 8 + 5
    want = j_sampled_eval(jmodel, jparams, js, table, labels, nodes, batch_size=8)
    model = bind_params(_port_model(jparams), None, "cpu")
    got = sampled_eval(model, ts, torch.from_numpy(table), labels, nodes, batch_size=8)
    assert got == want and ts._call == 3


def test_example_runs_and_learns_on_cpu():
    """tests/test_examples.py's small sage run of the example, on the port
    with --device cpu."""
    r = subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.examples.reddit_sage", "--device", "cpu",
         "--nodes", "3000", "--dim", "16", "--hidden", "32", "--epochs", "10",
         "--batch-size", "128", "--sizes", "8,5", "--lr", "0.01"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    for line in ("epoch 9:", "val acc:", "test acc:", "test acc (full inference):"):
        assert line in r.stdout, r.stdout
    assert float(r.stdout.split("test acc:")[1].split()[0]) > 0.5, r.stdout
    assert float(r.stdout.split("(full inference):")[1].split()[0]) > 0.5, r.stdout

"""Parity of the port's multi-hop samplers, feature gather, neighbor mean
and GraphSAGE with quiver_tpu, at the tiny shapes of tests/test_serve.py
(200 nodes, 2,000 edges, DIM 16, sizes [4, 4], seed 3).

Bars: samplers and gather bit-equal (n_id, masks, cols on valid lanes,
counts, rows); the masked mean and the logits within atol = rtol = 1e-5,
because XLA-CPU and torch-CPU sum in different orders. The
kernel-versus-plain checks are in tests/test_torch_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.feature import _padded_gather, _padded_gather_ordered
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.models.sage import masked_mean_aggregate as j_mean
from quiver_tpu.pyg.sage_sampler import DenseAdj as JDenseAdj
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch.feature import gather_rows
from quiver_tpu_torch.inference import bind_params, forward_logits
from quiver_tpu_torch.models.sage import masked_mean_aggregate
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED = 200, 16, [4, 4], 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _topos():
    ei = make_random_graph(N_NODES, 2000, seed=0)
    return JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)


def _pair_samplers(**kw):
    jt, tt = _topos()
    return (JSampler(jt, sizes=SIZES, mode="TPU", seed=SEED, **kw),
            GraphSageSampler(tt, sizes=SIZES, mode="TPU", seed=SEED, device="cpu", **kw))


def _assert_samples_equal(jds, tds):
    assert np.array_equal(np.asarray(jds.n_id), tds.n_id.numpy())
    assert int(jds.count) == int(tds.count)
    assert jds.batch_size == tds.batch_size
    for ja, ta in zip(jds.adjs, tds.adjs):
        mask = np.asarray(ja.mask)
        assert np.array_equal(mask, ta.mask.numpy())
        assert int(ja.n_src) == int(ta.n_src) and int(ja.n_dst) == int(ta.n_dst)
        assert (ja.cols is None) == (ta.cols is None)
        if ja.cols is not None:
            assert np.array_equal(np.asarray(ja.cols)[mask], ta.cols.numpy()[mask])


@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("dedup", [True, False])
def test_multihop_samplers_bit_equal(layout, dedup):
    js, ts = _pair_samplers(layout=layout, dedup=dedup)
    rng = np.random.default_rng(1)
    for B in (8, 5):  # same call index sequence on both
        seeds = rng.integers(0, N_NODES, B)
        seeds[1] = seeds[0]  # duplicate seed
        _assert_samples_equal(js.sample_dense(seeds), ts.sample_dense(seeds))
    assert ts.sample_dense(np.arange(3)).n_id.dtype == torch.int32  # int64 seeds cast


@pytest.mark.parametrize("fn", ["sample_dense_pure", "sample_dense_fused"])
def test_sample_dense_functions_on_flat_csr_bit_equal(fn):
    from quiver_tpu.pyg import sage_sampler as jss
    from quiver_tpu_torch import random as qrandom
    from quiver_tpu_torch.pyg import sage_sampler as tss

    jt, tt = _topos()
    seeds = (np.arange(8) * 23 % N_NODES).astype(np.int32)
    jk = jax.random.fold_in(jax.random.key(SEED), 2)
    tk = qrandom.fold_in(qrandom.key(SEED), 2)
    jds = getattr(jss, fn)(*jt.to_device(), jk, jnp.asarray(seeds), tuple(SIZES))
    tds = getattr(tss, fn)(*tt.to_device("cpu"), tk, torch.from_numpy(seeds), tuple(SIZES))
    _assert_samples_equal(jds, tds)


def test_sampler_caps_and_modes():
    js, ts = _pair_samplers(caps=(20, 40))
    seeds = np.arange(8)
    jds, tds = js.sample_dense(seeds), ts.sample_dense(seeds)
    _assert_samples_equal(jds, tds)
    assert int(jds.cap_overflow) == int(tds.cap_overflow)
    assert np.array_equal(np.asarray(jds.raw_counts), tds.raw_counts.numpy())
    with pytest.raises(ValueError):
        GraphSageSampler(_topos()[1], SIZES, device="cpu", mode="HOST")
    with pytest.raises(ValueError):
        GraphSageSampler(_topos()[1], SIZES, device="cpu", layout="csr")


def test_next_key_matches_call_stream():
    _, ts = _pair_samplers()
    _, twin = _pair_samplers()
    twin.next_key()
    seeds = np.arange(6)
    ts.sample_dense(seeds)
    a, b = ts.sample_dense(seeds), twin.sample_dense(seeds)
    assert torch.equal(a.n_id, b.n_id)


@pytest.mark.parametrize("with_map", [False, True])
def test_gather_rows_bit_equal(with_map):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, DIM)).astype(np.float32)
    ids = rng.integers(-5, 70, 33).astype(np.int32)  # clipped both ends
    if with_map:
        imap = rng.integers(-3, 60, 80).astype(np.int32)
        want = np.asarray(_padded_gather_ordered(jnp.asarray(table), jnp.asarray(imap),
                                                 jnp.asarray(ids)))
        got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(imap))
    else:
        want = np.asarray(_padded_gather(jnp.asarray(table), jnp.asarray(ids)))
        got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert np.array_equal(want, got.numpy())


def _adj_case(structural, W=12, k=5, w_src=80, seed=4):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, k)) < 0.6
    mask[0] = False  # a target with no valid neighbor
    cols = None if structural else rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)
    x = rng.standard_normal((max(w_src, W * (1 + k)), DIM)).astype(np.float32)
    return x, mask, cols


@pytest.mark.parametrize("structural", [False, True])
def test_masked_mean_matches_jax(structural):
    x, mask, cols = _adj_case(structural)
    z = np.zeros((), np.int32)
    jadj = JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)
    tadj = DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    torch.tensor(0), torch.tensor(0))
    want = np.asarray(j_mean(jnp.asarray(x), jadj))
    got = masked_mean_aggregate(torch.from_numpy(x), tadj).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()


def test_graphsage_logits_from_flax_params_match():
    js, ts = _pair_samplers()
    feat = np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)
    seeds = np.arange(8)
    jds, tds = js.sample_dense(seeds), ts.sample_dense(seeds)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.5)
    jx = jnp.take(jnp.asarray(feat), jnp.clip(jds.n_id, 0, N_NODES - 1), axis=0)
    params = jmodel.init(jax.random.key(0), jx, jds.adjs)
    want = np.asarray(jmodel.apply(params, jx, jds.adjs))
    model = bind_params(GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.5),
                        sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = forward_logits(model, torch.from_numpy(feat), tds).numpy()
    assert got.shape == want.shape == (8, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_sage_params_from_flax_rejects_empty_tree():
    with pytest.raises(ValueError):
        sage_params_from_flax({"params": {}})



def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    from quiver_tpu_torch import _kernels

    _kernels.reset_counts()
    _, ts = _pair_samplers()
    feat = torch.from_numpy(np.random.default_rng(1).standard_normal((N_NODES, DIM)).astype(np.float32))
    model = bind_params(GraphSAGE(DIM, 16, 5, num_layers=2), None, "cpu")
    out = forward_logits(model, feat, ts.sample_dense(np.arange(8)))
    assert out.shape == (8, 5) and torch.isfinite(out).all()
    assert set(_kernels.counts().values()) == {0}


@pytest.mark.parametrize("fan_in", [256, 100])
def test_init_matches_flax_dense_statistics(fan_in):
    """GraphSAGE.reset_parameters draws flax nn.Dense's init: lecun-normal
    kernels (a normal cut at +-2 sigma_raw, variance 1/fan_in) and zero
    biases, the same weights from the same generator seed."""
    import flax.linen as fnn

    from quiver_tpu_torch.models.sage import TRUNC_NORMAL_STD

    model = GraphSAGE(fan_in, 256, 256, num_layers=1)
    model.reset_parameters(torch.Generator().manual_seed(7))
    lin_l, lin_r = model.convs[0].lin_l, model.convs[0].lin_r
    flax_w = np.asarray(fnn.Dense(256).init(jax.random.key(7), jnp.zeros((1, fan_in)))
                        ["params"]["kernel"])
    sigma_raw = (1.0 / fan_in) ** 0.5 / TRUNC_NORMAL_STD
    for w in (lin_l.weight.detach().numpy(), lin_r.weight.detach().numpy(), flax_w):
        assert abs(w.std() / fan_in ** -0.5 - 1.0) < 0.03
        assert np.abs(w).max() <= 2.0 * sigma_raw
        assert abs(w.mean()) < 4.0 / (16 * fan_in)  # 4 standard errors of a 256 x fan_in mean
    assert lin_r.bias is None and torch.count_nonzero(lin_l.bias) == 0
    again = GraphSAGE(fan_in, 256, 256, num_layers=1)
    again.reset_parameters(torch.Generator().manual_seed(7))
    assert torch.equal(again.convs[0].lin_l.weight, lin_l.weight)
    assert torch.equal(again.convs[0].lin_r.weight, lin_r.weight)

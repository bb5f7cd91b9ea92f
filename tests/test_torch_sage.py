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
        GraphSageSampler(_topos()[1], SIZES, device="cpu", mode="BAD_MODE")
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


@pytest.mark.parametrize("D", [47, 257])
@pytest.mark.parametrize("structural", [False, True])
def test_masked_mean_matches_jax_at_narrow_access_widths(D, structural):
    """Row widths whose stride is no multiple of 16 bytes (the card
    kernel's one-element accesses), one of them past 8 warps' columns."""
    x, mask, cols = _adj_case(structural, W=20, k=33, w_src=300, seed=D)
    x = np.random.default_rng(D).standard_normal((x.shape[0], D)).astype(np.float32)
    z = np.zeros((), np.int32)
    jadj = JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)
    tadj = DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    torch.tensor(0), torch.tensor(0))
    want = np.asarray(j_mean(jnp.asarray(x), jadj))
    got = masked_mean_aggregate(torch.from_numpy(x), tadj).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("structural", [False, True])
def test_bf16_masked_mean_at_d100_matches_jax(structural):
    """bfloat16 rows at D = 100 (200-byte rows: the card kernel's 8-byte
    accesses): the port sums in float32 and rounds once, so it lies within
    one bfloat16 rounding (2**-7 relative) of the JAX package's float32
    mean of the same bfloat16 values rounded to bfloat16."""
    x, mask, cols = _adj_case(structural, W=30, k=15, w_src=200, seed=11)
    x = np.random.default_rng(11).standard_normal((x.shape[0], 100)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    z = np.zeros((), np.int32)
    jadj = JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)
    tadj = DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    torch.tensor(0), torch.tensor(0))
    want = np.asarray(j_mean(xb.astype(jnp.float32), jadj).astype(jnp.bfloat16).astype(jnp.float32))
    got = masked_mean_aggregate(torch.from_numpy(x).to(torch.bfloat16), tadj)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)
    assert not got[0].any()


@pytest.mark.parametrize("W,k,D,elem,align,want", [
    (11264, 5, 100, 4, 256, (4, 1, 1)),    # a flush's first layer: many targets
    (1024, 10, 256, 4, 256, (4, 2, 1)),    # its second: 2,048 warps, no split
    (64, 15, 256, 4, 256, (4, 2, 4)),      # its third: 64 targets, 8 warps each
    (64, 10, 256, 4, 256, (4, 2, 2)),      # split while the parts keep 4 lanes
    (1024, 64, 256, 4, 256, (4, 2, 1)),    # k = 64 over 1,024 targets
    (64, 15, 256, 2, 256, (8, 1, 4)),      # bfloat16: 16 bytes = 8 columns, float32's split
    (180224, 5, 100, 2, 256, (4, 1, 1)),   # 200-byte bfloat16 rows: 8-byte accesses
    (64, 33, 47, 4, 256, (1, 2, 4)),       # 188-byte rows: one element a thread
    (64, 33, 257, 2, 256, (1, 8, 1)),      # 9 column slices: 8 warps walk them
    (64, 64, 256, 4, 8, (2, 4, 2)),        # 8-byte-aligned pointers: 8-byte accesses
    (5, 1, 1, 2, 256, (1, 1, 1)),
])
def test_mean_launch_plan(W, k, D, elem, align, want):
    from quiver_tpu_torch.models.sage import MEAN_BLOCK_WARPS, mean_launch_plan

    vec, col_warps, split = mean_launch_plan(W, k, D, elem, align)
    assert (vec, col_warps, split) == want
    assert D % vec == 0 and (vec * elem) in (1, 2, 4, 8, 16) and align % (vec * elem) == 0
    assert col_warps * split <= MEAN_BLOCK_WARPS and split & (split - 1) == 0
    if elem == 2:  # bfloat16 adds in float32's order: the same split
        assert mean_launch_plan(W, k, D, 4, align)[2] == split


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

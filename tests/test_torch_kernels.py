"""The port's CUDA kernels against their plain torch versions, on the card
(marker ``cuda``; they skip where there is no card). This file imports
torch and numpy only, so it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bars: the sampling kernel (tiled and flat), the reindex kernel (n_id,
count, local_seeds; local_nbrs on valid lanes) and the gather kernel are
bit-equal to the plain versions, and to the plain versions run on the
CPU; the neighbor mean is within atol = rtol = 1e-5 (a different sum
order). Shapes are the slice's: B = 64, sizes [15, 10, 5], D = 100 and
256."""

import numpy as np
import pytest
import torch

from quiver_tpu_torch import GraphSAGE, GraphSageSampler, _kernels
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.feature import gather_rows, gather_rows_plain
from quiver_tpu_torch.inference import bind_params, forward_logits
from quiver_tpu_torch.models.sage import masked_mean_aggregate, masked_mean_aggregate_plain
from quiver_tpu_torch.ops import reindex, sample
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj
from quiver_tpu_torch.utils import CSRTopo

from torch_fixtures import cuda_device  # noqa: F401 (fixture)

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

HOPS = ((64, 15), (1024, 10), (11264, 5))


def _graph(n=3000, e=60000, seed=0):
    """Random graph with a degree-0 row (9), a degree-15 row (7) and a
    500-neighbor hub (5) that crosses tile boundaries."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    src[np.isin(src, (5, 7, 9))] = 11
    src = np.concatenate([src, np.full(500, 5), np.full(15, 7)])
    dst = rng.integers(0, n, src.shape[0])
    return CSRTopo(edge_index=np.stack([src, dst]), num_nodes=n), n


def _same(a, b):
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
def test_sample_kernel_matches_plain(cuda_device, layout):
    topo, n = _graph()
    rng = np.random.default_rng(1)
    for W, k in HOPS:
        seeds = torch.from_numpy(rng.integers(-3, n + 3, W).astype(np.int32))
        seeds[:3] = torch.tensor([5, 7, 9], dtype=torch.int32)
        valid = torch.from_numpy(rng.random(W) < 0.9)
        key = qrandom.split(qrandom.key(W))[1]
        if layout == "tiled":
            g = topo.to_device_tiled(cuda_device)
            fn, plain = sample.tiled_sample_layer, sample.tiled_sample_layer_plain
        else:
            g = topo.to_device(cuda_device)
            fn, plain = sample.sample_layer, sample.sample_layer_plain
        args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
        got, want = fn(*g, *args), plain(*g, *args)
        cpu = plain(*(t.cpu() for t in g), seeds, valid, k, key)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, cpu):
            assert _same(a, b) and _same(a, c)


@pytest.mark.cuda
def test_reindex_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    for S, k in HOPS + ((3000, 7),):
        seeds = rng.integers(0, 2_000_000, S).astype(np.int32)
        seeds[3] = seeds[1]
        seed_valid = np.ones(S, bool)
        seed_valid[S // 2:] = rng.random(S - S // 2) < 0.7
        nbrs = rng.integers(0, 2_000_000, (S, k)).astype(np.int32)
        nbrs[0, 0] = seeds[1]
        nbrs[1] = rng.integers(0, 50, k)  # repeats
        nbr_valid = rng.random((S, k)) < 0.8
        case = [torch.from_numpy(a).to(cuda_device) for a in (seeds, seed_valid, nbrs, nbr_valid)]
        got = reindex.local_reindex(*case)
        want = reindex.local_reindex_plain(*case)
        again = reindex.local_reindex(*case)
        torch.cuda.synchronize()
        valid = case[3]
        assert _same(got.n_id, want.n_id) and _same(got.count, want.count)
        assert _same(got.local_seeds, want.local_seeds)
        assert _same(got.local_nbrs[valid], want.local_nbrs[valid])
        assert _same(again.n_id, got.n_id) and _same(again.local_nbrs, got.local_nbrs)


@pytest.mark.cuda
def test_gather_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((5000, 100)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(-5, 5100, 67584).astype(np.int32)).to(cuda_device)
    imap = torch.from_numpy(rng.integers(-2, 5002, 6000).astype(np.int32)).to(cuda_device)
    assert _same(gather_rows(table, ids), gather_rows_plain(table, ids))
    assert _same(gather_rows(table, ids, imap), gather_rows_plain(table, ids, imap))
    odd = table[:, :99].contiguous()  # width not a multiple of 4: scalar copy
    assert _same(gather_rows(odd, ids), gather_rows_plain(odd, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("structural", [False, True])
def test_mean_kernel_matches_plain(cuda_device, structural):
    rng = np.random.default_rng(4)
    for (W, k), D in zip(reversed(HOPS), (100, 256, 256)):
        w_src = W * (1 + k)
        mask = torch.from_numpy(rng.random((W, k)) < 0.7)
        mask[0] = False
        cols = None if structural else torch.from_numpy(
            rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)).to(cuda_device)
        x = torch.from_numpy(rng.standard_normal((w_src, D)).astype(np.float32)).to(cuda_device)
        adj = DenseAdj(cols, mask.to(cuda_device), None, None)
        got, want = masked_mean_aggregate(x, adj), masked_mean_aggregate_plain(x, adj)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert not got[0].any()


@pytest.mark.cuda
def test_sampled_forward_on_card_matches_cpu(cuda_device):
    """The whole split path, kernels on the card against plain torch on
    the CPU: same n_id and masks, logits within 1e-4 (float32 products in
    another order)."""
    topo, n = _graph(seed=5)
    feat = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 100)).astype(np.float32))
    torch.manual_seed(0)
    model = GraphSAGE(100, 256, 47, num_layers=3)
    samplers = [GraphSageSampler(topo, [15, 10, 5], device=d, seed=3) for d in ("cpu", cuda_device)]
    seeds = np.arange(64) * 37 % n
    ds_cpu, ds_dev = (s.sample_dense(seeds) for s in samplers)
    assert _same(ds_cpu.n_id, ds_dev.n_id) and _same(ds_cpu.count, ds_dev.count)
    for a, b in zip(ds_cpu.adjs, ds_dev.adjs):
        assert _same(a.mask, b.mask) and _same(a.cols[a.mask], b.cols[b.mask])
    out_cpu = forward_logits(bind_params(model, None, "cpu"), feat, ds_cpu)
    dev_model = bind_params(model, model.state_dict(), cuda_device)
    out_dev = forward_logits(dev_model, feat.to(cuda_device), ds_dev)
    torch.testing.assert_close(out_dev.cpu(), out_cpu, atol=1e-4, rtol=1e-4)
    assert sum(_kernels.counts().values()) > 0

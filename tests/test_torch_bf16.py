"""The bfloat16 compute path of the port's three models against
quiver_tpu's, on the CPU, at tests/test_models_bf16.py's shapes (200
nodes, 3,000 edges, sizes [5, 4], 32 seeds, 16 features).

The recipe is flax's: parameters stay float32, every layer computes in
bfloat16, logits come back float32, gradients land in float32. Bars, at
tests/test_models_bf16.py's 0.05 of the logits' scale (bfloat16 keeps 8
bits, and the two frameworks round at different places): the port's
bfloat16 logits against JAX's bfloat16 logits and against the port's own
float32 logits from the same converted weights. The bfloat16 plain
versions of K4, K4b and K14b compute in float32 and round once, so they
equal the float32 plain versions' results rounded to bfloat16, bit for
bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GAT as JGAT
from quiver_tpu.models import GCN as JGCN
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg import GraphSageSampler as JSampler
from quiver_tpu_torch import GAT, GCN, GraphSAGE
from quiver_tpu_torch.convert import (
    gat_params_from_flax,
    gcn_params_from_flax,
    sage_params_from_flax,
)
from quiver_tpu_torch.models.sage import masked_mean_aggregate, masked_mean_backward
from quiver_tpu_torch.ops.gather_src import gather_src_backward
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

BAR = 0.05
BF16 = torch.bfloat16

MODELS = {
    # name: (JAX model for a dtype, port model for a dtype, converter)
    "sage": (lambda dt: JGraphSAGE(hidden_dim=32, out_dim=5, num_layers=2, dropout=0.0, dtype=dt),
             lambda dt: GraphSAGE(16, 32, 5, num_layers=2, dropout=0.0, dtype=dt),
             sage_params_from_flax),
    "gcn": (lambda dt: JGCN(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0, norm="both",
                            dtype=dt),
            lambda dt: GCN(16, 16, 5, num_layers=2, dropout=0.0, norm="both", dtype=dt),
            gcn_params_from_flax),
    "gat": (lambda dt: JGAT(hidden_dim=16, out_dim=5, heads=2, num_layers=2, dropout=0.0,
                            dtype=dt),
            lambda dt: GAT(16, 16, 5, heads=2, num_layers=2, dropout=0.0, dtype=dt),
            gat_params_from_flax),
}


def _batch(seed):
    """tests/test_models_bf16.py's batch; the port gets the same hops."""
    topo = JCSRTopo(edge_index=make_random_graph(200, 3000, seed=seed))
    ds = JSampler(topo, sizes=[5, 4], mode="TPU", seed=1).sample_dense(np.arange(32))
    x = np.random.default_rng(0).standard_normal((int(ds.n_id.shape[0]), 16)).astype(np.float32)
    adjs = [DenseAdj(torch.from_numpy(np.array(a.cols)), torch.from_numpy(np.array(a.mask)),
                     None, None) for a in ds.adjs]
    return ds, x, adjs


def _within(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    assert err <= BAR, f"{what}: {err} of scale > {BAR}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_logits_match_jax_bf16_and_port_f32(name):
    make_jax, make_port, convert = MODELS[name]
    ds, x, adjs = _batch(seed=3 if name == "gat" else 0)
    jx = jnp.asarray(x)
    params = jax.jit(make_jax(None).init)(jax.random.key(0), jx, ds.adjs)
    want16 = np.asarray(jax.jit(make_jax(jnp.bfloat16).apply)(params, jx, ds.adjs))
    sd = convert(jax.tree_util.tree_map(np.asarray, params))
    port32, port16 = make_port(None), make_port(BF16)
    port32.load_state_dict(sd)
    port16.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    xt = torch.from_numpy(x)
    out32 = port32(xt, adjs).detach()
    out16 = port16(xt.clone().requires_grad_(True), adjs)
    assert out16.dtype == torch.float32
    _within(out16.detach().numpy(), want16, "port bf16 vs JAX bf16")
    _within(out16.detach().numpy(), out32.numpy(), "port bf16 vs port f32")
    assert not torch.equal(out16.detach(), out32)  # the compute really was bfloat16
    (out16 ** 2).mean().backward()
    for n, p in port16.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), n


def _lanes(W=24, k=5, w_src=60, seed=2):
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((W, k)) < 0.7)
    cols = torch.from_numpy(rng.integers(0, w_src, (W, k)).astype(np.int32))
    return mask, cols, w_src


def test_bf16_mean_and_gradients_round_the_float32_result_once():
    """K4, K4b and K14b on bfloat16 rows: the float32 result of the same
    (bfloat16-valued) inputs, rounded once."""
    mask, cols, w_src = _lanes()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((w_src, 20)).astype(np.float32)).to(BF16)
    adj = DenseAdj(cols, mask, None, None)
    mean = masked_mean_aggregate(x, adj)
    assert mean.dtype == BF16
    assert torch.equal(mean, masked_mean_aggregate(x.float(), adj).to(BF16))
    g = torch.from_numpy(rng.standard_normal((mask.shape[0], 20)).astype(np.float32)).to(BF16)
    gx = masked_mean_backward(g, mask, cols, w_src)
    assert gx.dtype == BF16
    assert torch.equal(gx, masked_mean_backward(g.float(), mask, cols, w_src).to(BF16))
    gl = torch.from_numpy(rng.standard_normal(tuple(mask.shape) + (2, 8)).astype(np.float32))
    gl = gl.to(BF16)
    gs = gather_src_backward(gl, mask, cols, w_src)
    assert gs.dtype == BF16 and gs.shape == (w_src, 2, 8)
    assert torch.equal(gs, gather_src_backward(gl.float(), mask, cols, w_src).to(BF16))

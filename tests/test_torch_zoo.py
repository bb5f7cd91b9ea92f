"""Parity of the port's GCN, GAT and hop-source gather with quiver_tpu, on
the CPU: the gather (K14) and its gradient (K14b), GCN's block out-degree
(K14c), the GCN and GAT forwards and gradients on converted weights, a
5-step Adam loss curve of each model against the JAX model and optax, the
init distributions, sampled eval and the example.

Shapes: the 200-node, 2,000-edge graph of tests/test_torch_sage.py (DIM
16, sizes [4, 4], seed 3); inputs from seeded numpy through both packages.
Bars:
- the gather, the gradient's plain version and the out-degree bit-equal to
  JAX (a copy, and sums of the same float32 terms in the same order: JAX's
  scatter adds the +-0 cotangents of the masked lanes, which change no bit);
- forwards within 1e-5 and gradients within 1e-4 of each tensor's largest
  magnitude: torch and XLA sum in different orders, and a gradient sums
  more terms than a forward;
- the 5-step Adam curves within 1e-4 (as tests/test_torch_train.py's: Adam
  divides each update by sqrt(v), so last-bit differences grow slowly);
- sampled eval equal.
Dropout is 0 in every parity test."""

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
from quiver_tpu.inference import sampled_eval as j_sampled_eval
from quiver_tpu.models import GAT as JGAT
from quiver_tpu.models import GCN as JGCN
from quiver_tpu.models import GCNConv as JGCNConv
from quiver_tpu.pyg import sage_sampler as jss
from quiver_tpu.pyg.sage_sampler import DenseAdj as JDenseAdj
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import GAT, GCN, CSRTopo, GraphSageSampler
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.convert import gat_params_from_flax, gcn_params_from_flax
from quiver_tpu_torch.inference import bind_params, forward_logits, lookup_features, sampled_eval
from quiver_tpu_torch.models import GATConv, GCNConv
from quiver_tpu_torch.models.sage import TRUNC_NORMAL_STD
from quiver_tpu_torch.ops.gather_src import (
    block_out_degree,
    block_out_degree_plain,
    gather_src,
    gather_src_backward,
    gather_src_backward_plain,
)
from quiver_tpu_torch.pyg import sage_sampler as tss
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, CLASSES = 200, 16, (4, 4), 3, 5
FWD_TOL, GRAD_TOL, CURVE_TOL = 1e-5, 1e-4, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {
    # name: (JAX model, port model, converter)
    "gcn_right": (lambda: JGCN(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0),
                  lambda: GCN(DIM, 16, CLASSES, num_layers=2, dropout=0.0),
                  gcn_params_from_flax),
    "gcn_both": (lambda: JGCN(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0,
                              norm="both"),
                 lambda: GCN(DIM, 16, CLASSES, num_layers=2, dropout=0.0, norm="both"),
                 gcn_params_from_flax),
    "gat": (lambda: JGAT(hidden_dim=8, out_dim=CLASSES, heads=2, num_layers=2, dropout=0.0),
            lambda: GAT(DIM, 8, CLASSES, heads=2, num_layers=2, dropout=0.0),
            gat_params_from_flax),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_scaled(got, want, tol, what=""):
    """``|got - want| <= tol * max|want|`` elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _topos():
    ei = make_random_graph(N_NODES, 2000, seed=0)
    return JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)


def _table():
    return np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)


def _samples(layout):
    """The same sample in both packages: ``(jds, tds)`` of 8 seeds, in the
    cols layout (sample_dense_pure) or the structural one (sample_dense_fused)."""
    jt, tt = _topos()
    fn = "sample_dense_pure" if layout == "cols" else "sample_dense_fused"
    seeds = (np.arange(8) * 31 % N_NODES).astype(np.int32)
    jds = getattr(jss, fn)(*jt.to_device(), jax.random.fold_in(jax.random.key(SEED), 0),
                           jnp.asarray(seeds), SIZES)
    tds = getattr(tss, fn)(*tt.to_device("cpu"), qrandom.fold_in(qrandom.key(SEED), 0),
                           torch.from_numpy(seeds), SIZES)
    return jds, tds


def _features(jds):
    x = np.take(_table(), np.clip(np.asarray(jds.n_id), 0, N_NODES - 1), axis=0)
    return x, jnp.asarray(x), torch.from_numpy(x)


# -- K14, K14b, K14c: the plain versions against the JAX package ---------------------

def _lane_case(W=12, k=5, w_src=40, seed=4):
    """A hop whose masked lanes all name one real source row (as the
    sampler's padding does), with cols clipped at both ends, a row named by
    many valid lanes and a target with no valid lane."""
    rng = np.random.default_rng(seed)
    mask = rng.random((W, k)) < 0.6
    mask[0] = False
    cols = rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)
    cols[1] = 7
    cols[2, :2] = 7
    mask[1] = True
    cols[~mask] = 11
    return mask, cols


def _jadj(cols, mask):
    z = np.zeros((), np.int32)
    return JDenseAdj(None if cols is None else jnp.asarray(cols), jnp.asarray(mask), z, z)


def _tadj(cols, mask):
    return DenseAdj(None if cols is None else torch.from_numpy(cols), torch.from_numpy(mask),
                    None, None)


@pytest.mark.parametrize("layout", ["cols", "structural"])
@pytest.mark.parametrize("rows", [(DIM,), (3, 4), (1,)])
def test_gather_src_bit_equal_to_jax(layout, rows):
    """K14's plain version (and the structural view) against JAX's
    gather_src, over [W_src, D], [W_src, H, D] and [W_src, 1] sources."""
    mask, cols = _lane_case()
    W, k = mask.shape
    w_src = 40 if layout == "cols" else W * (1 + k) + 3
    cols = cols if layout == "cols" else None
    x = np.random.default_rng(5).standard_normal((w_src,) + rows).astype(np.float32)
    want = np.asarray(_jadj(cols, mask).gather_src(jnp.asarray(x)))
    got = _tadj(cols, mask).gather_src(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (W, k) + rows
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows", [(DIM,), (3, 4)])
def test_gather_src_gradient_bit_equal_to_jax_vjp(rows):
    """K14b's plain version, called alone and through autograd, against
    jax.vjp of gather_src with a cotangent zeroed on the masked lanes, as
    every caller's is."""
    mask, cols = _lane_case()
    W, k = mask.shape
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40,) + rows).astype(np.float32)
    ct = rng.standard_normal((W, k) + rows).astype(np.float32)
    zeros = np.zeros_like(ct[~mask])
    zeros[..., ::2] = -0.0  # signed zeros, as a product with the mask gives
    ct[~mask] = zeros
    _, vjp = jax.vjp(_jadj(cols, mask).gather_src, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tmask, tcols = torch.from_numpy(mask), torch.from_numpy(cols)
    direct = gather_src_backward(torch.from_numpy(ct), tmask, tcols, 40)
    assert np.array_equal(direct.numpy(), want)
    assert np.array_equal(gather_src_backward_plain(torch.from_numpy(ct), tmask, tcols, 40).numpy(),
                          want)
    xt = torch.from_numpy(x).requires_grad_(True)
    (gather_src(xt, tmask, tcols) * torch.from_numpy(ct)).sum().backward()
    assert np.array_equal(xt.grad.numpy(), want)
    assert want[7].any() and not want[11].any()  # row 11 only has masked lanes


def test_gather_src_gradient_drops_masked_lanes():
    """The deliberate difference: a cotangent on a masked lane is not
    scattered (JAX's transpose would add it)."""
    mask, cols = _lane_case()
    ct = np.ones(mask.shape + (2,), np.float32)
    got = gather_src_backward_plain(torch.from_numpy(ct), torch.from_numpy(mask),
                                    torch.from_numpy(cols), 40).numpy()
    want = np.zeros((40, 2), np.float32)
    np.add.at(want, np.clip(cols[mask], 0, 39), 1.0)
    assert np.array_equal(got, want)


def test_block_out_degree_bit_equal_to_gcn_count():
    """K14c's plain version against gcn.py:69-71's scatter count: a
    negative col counts from the end, cols outside [-W_src, W_src) drop."""
    mask, cols = _lane_case()
    cols[3] = [-1, -40, -41, 40, 45]
    mask[3] = True
    w_src = 40
    jcols, jmask = jnp.asarray(cols), jnp.asarray(mask)
    want = np.asarray(jnp.zeros(w_src, jnp.float32).at[jcols.reshape(-1)].add(
        jmask.reshape(-1).astype(jnp.float32), mode="drop"))
    tmask, tcols = torch.from_numpy(mask), torch.from_numpy(cols)
    for fn in (block_out_degree_plain, block_out_degree):
        got = fn(tmask, tcols, w_src)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert want[39] >= 1 and want[0] >= 1  # -1 and -40 counted, -41 and 40 dropped


# the edge cases of K14c's card paths (csrc/aggregate.cu): (W, k, W_src, masked share)
K14C_EDGE_CASES = {
    "no lanes": (0, 5, 40, 0.4),
    "every lane masked out": (12, 5, 40, 1.0),
    "one source": (12, 5, 1, 0.4),
    "negative and dropped cols": (64, 10, 30, 0.0),
    "one hub": (200, 15, 500, 0.2),
}


@pytest.mark.parametrize("name", sorted(K14C_EDGE_CASES))
def test_block_out_degree_plain_at_edge_cases(name):
    """K14c's plain version (the card kernel's reference) against
    gcn.py:69-71's scatter count at the card tests' edge cases: no lanes,
    every lane masked out, W_src = 1, cols in [-W_src - 3, W_src + 3)
    (negative ones count from the end, the rest past the source drop) and
    a hub named by half the lanes."""
    W, k, w_src, masked = K14C_EDGE_CASES[name]
    rng = np.random.default_rng(len(name))
    mask = rng.random((W, k)) >= masked
    cols = rng.integers(-w_src - 3, w_src + 3, (W, k)).astype(np.int32)
    if name == "one hub":
        cols[rng.random((W, k)) < 0.5] = 17
    want = np.asarray(jnp.zeros(w_src, jnp.float32).at[jnp.asarray(cols).reshape(-1)].add(
        jnp.asarray(mask).reshape(-1).astype(jnp.float32), mode="drop"))
    got = block_out_degree_plain(torch.from_numpy(mask), torch.from_numpy(cols), w_src)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if name in ("no lanes", "every lane masked out"):
        assert not want.any()


# -- GCN and GAT against the JAX models ----------------------------------------------

def _init_pair(name, jds, jx):
    make_jax, make_port, convert = MODELS[name]
    jmodel, tmodel = make_jax(), make_port()
    jparams = jmodel.init(jax.random.key(0), jx, jds.adjs)
    tmodel.load_state_dict(convert(_np_tree(jparams)))
    return jmodel, jparams, tmodel, convert


def _jax_logits_and_grads(jmodel, jparams, jx, adjs, R):
    """The logits and the gradients of sum(logits * R) to the parameters
    and the input, in one jitted program."""
    def loss(p, x):
        logits = jmodel.apply(p, x, adjs)
        return jnp.sum(logits * R), logits

    (_, logits), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jparams, jx)
    return np.asarray(logits), gp, gx


@pytest.mark.parametrize("layout", ["cols", "structural"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_gradients_match_jax(name, layout):
    """Logits, every parameter gradient and the input gradient of
    sum(logits * R) from identical weights."""
    jds, tds = _samples(layout)
    _, jx, tx = _features(jds)
    jmodel, jparams, model, convert = _init_pair(name, jds, jx)
    R = np.random.default_rng(8).standard_normal((8, CLASSES)).astype(np.float32)

    want, jgp, jgx = _jax_logits_and_grads(jmodel, jparams, jx, jds.adjs, R)
    tx = tx.clone().requires_grad_(True)
    out = model(tx, tds.adjs)
    assert out.dtype == torch.float32
    _assert_scaled(out.detach().numpy(), want, FWD_TOL, "logits")
    (out * torch.from_numpy(R)).sum().backward()
    want_g = convert(_np_tree(jgp))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want_g) == sorted(got_g)
    for n in want_g:
        _assert_scaled(got_g[n].numpy(), want_g[n].numpy(), GRAD_TOL, n)
    _assert_scaled(tx.grad.numpy(), np.asarray(jgx), GRAD_TOL, "input")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_adam_loss_curve_matches_optax(name):
    """5 Adam steps on fresh cols-layout samples, the same weights and
    batches through both packages."""
    jt, tt = _topos()
    table = _table()
    labels = np.random.default_rng(7).integers(0, CLASSES, N_NODES).astype(np.int32)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(tt, sizes=list(SIZES), mode="TPU", seed=SEED, device="cpu")
    rng = np.random.default_rng(11)
    batches = [rng.choice(N_NODES, 16, replace=False) for _ in range(5)]
    jds = [js.sample_dense(b) for b in batches]
    tds = [ts.sample_dense(b) for b in batches]
    jxs = [jnp.take(jnp.asarray(table), jnp.clip(d.n_id, 0, N_NODES - 1), axis=0) for d in jds]
    jmodel, jparams, model, _ = _init_pair(name, jds[0], jxs[0])
    tx_opt = optax.adam(5e-3)
    jstate = tx_opt.init(jparams)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    feat = torch.from_numpy(table)

    @jax.jit
    def jstep(params, state, x, adjs, y):
        def loss_fn(p):
            logits = jmodel.apply(p, x, adjs)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx_opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    jlosses, tlosses = [], []
    for b, jd, td, jx in zip(batches, jds, tds, jxs):
        y = labels[b]
        jparams, jstate, jl = jstep(jparams, jstate, jx, jd.adjs, jnp.asarray(y))
        loss = F.cross_entropy(model(lookup_features(feat, td.n_id), td.adjs, train=True),
                               torch.from_numpy(y.astype(np.int64)))
        opt.zero_grad()
        loss.backward()
        opt.step()
        jlosses.append(float(jl))
        tlosses.append(float(loss.detach()))
    np.testing.assert_allclose(tlosses, jlosses, atol=CURVE_TOL, rtol=CURVE_TOL)


@pytest.mark.parametrize("name", ["gcn_both", "gat"])
def test_sampled_eval_and_forward_logits_equal_jax(name):
    """inference.sampled_eval and forward_logits take the other models:
    the same accuracy as the JAX package's sampled_eval, logits within the
    forward bar."""
    jt, tt = _topos()
    table = _table()
    labels = np.random.default_rng(7).integers(0, CLASSES, N_NODES).astype(np.int32)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(tt, sizes=list(SIZES), mode="TPU", seed=SEED, device="cpu")
    jds, tds = js.sample_dense(np.arange(8)), ts.sample_dense(np.arange(8))
    jx = jnp.take(jnp.asarray(table), jnp.clip(jds.n_id, 0, N_NODES - 1), axis=0)
    jmodel, jparams, model, convert = _init_pair(name, jds, jx)
    bound = bind_params(MODELS[name][1](), convert(_np_tree(jparams)), "cpu")
    _assert_scaled(forward_logits(bound, torch.from_numpy(table), tds).numpy(),
                   np.asarray(jmodel.apply(jparams, jx, jds.adjs)), FWD_TOL, "logits")
    nodes = np.random.default_rng(4).choice(N_NODES, 21, replace=False)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(tt, sizes=list(SIZES), mode="TPU", seed=SEED, device="cpu")
    want = j_sampled_eval(jmodel, jparams, js, table, labels, nodes, batch_size=8)
    assert sampled_eval(bound, ts, torch.from_numpy(table), labels, nodes, batch_size=8) == want


def test_gcn_right_norm_is_the_masked_mean_with_self():
    """tests/test_gcn.py's numpy oracle, on the port's GCNConv."""
    _, tds = _samples("cols")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (tds.n_id.shape[0], DIM)).astype(np.float32))
    adj = tds.adjs[0]
    conv = GCNConv(DIM, 8, norm="right", bias=False)
    out = conv(x, adj).detach().numpy()
    cols, mask, xs = adj.cols.numpy(), adj.mask.numpy(), x.numpy()
    agg = np.stack([(xs[i] + xs[cols[i][mask[i]]].sum(0)) / (mask[i].sum() + 1)
                    for i in range(mask.shape[0])])
    np.testing.assert_allclose(out, agg @ conv.lin.weight.detach().numpy().T, rtol=2e-4,
                               atol=2e-5)


def test_unknown_norm_raises_like_jax():
    _, tds = _samples("cols")
    with pytest.raises(ValueError, match="unknown norm"):
        GCNConv(DIM, 4, norm="bogus")
    with pytest.raises(ValueError, match="unknown norm"):
        GCN(DIM, 8, 4, norm="bogus")
    jds, _ = _samples("cols")
    with pytest.raises(ValueError, match="unknown norm"):
        JGCNConv(out_dim=4, norm="bogus").init(jax.random.key(0), jnp.zeros((1, DIM)),
                                               jds.adjs[0])


# -- initialisation ----------------------------------------------------------------

def test_init_matches_flax_statistics():
    """GCN and GAT draw flax's init: lecun-normal kernels cut at +-2 sigma
    (variance 1/fan_in), zero GCN biases, and GAT's attention vectors from
    glorot_uniform with flax's fans of a (1, H, D) shape, H and D: uniform
    in +-sqrt(6 / (H + D)). The same generator seed gives the same weights."""
    import flax.linen as fnn

    H, D, fan_in = 4, 256, 256
    gen = torch.Generator().manual_seed(7)
    gcn = GCN(fan_in, 256, 256, num_layers=2)
    gcn.reset_parameters(gen)
    gat = GAT(fan_in, D, 47, heads=H, num_layers=2)
    gat.reset_parameters(gen)
    sigma_raw = (1.0 / fan_in) ** 0.5 / TRUNC_NORMAL_STD
    for w in (gcn.convs[0].lin.weight, gat.convs[0].lin.weight):
        w = w.detach().numpy()
        assert abs(w.std() / fan_in ** -0.5 - 1.0) < 0.03
        assert np.abs(w).max() <= 2.0 * sigma_raw
    assert all(torch.count_nonzero(c.lin.bias) == 0 for c in gcn.convs)
    fan_in_1 = H * D  # GAT's second layer takes the concatenated heads
    w1 = gat.convs[1].lin.weight.detach().numpy()
    assert abs(w1.std() / fan_in_1 ** -0.5 - 1.0) < 0.05
    limit = (6.0 / (H + D)) ** 0.5
    flax_att = np.asarray(fnn.initializers.glorot_uniform()(jax.random.key(7), (1, H, D)))
    for a in (gat.convs[0].att_src, gat.convs[0].att_dst, torch.from_numpy(flax_att.copy())):
        a = a.detach().numpy()
        assert a.shape == (1, H, D)
        assert np.abs(a).max() <= limit and np.abs(a).max() > 0.95 * limit
        assert abs(a.std() / (limit / 3 ** 0.5) - 1.0) < 0.06
    # the last layer: one head of 47, limit sqrt(6 / 48)
    assert np.abs(gat.convs[1].att_src.detach().numpy()).max() <= (6.0 / 48) ** 0.5
    again = GAT(fan_in, D, 47, heads=H, num_layers=2)
    again.reset_parameters(torch.Generator().manual_seed(7))
    first = GAT(fan_in, D, 47, heads=H, num_layers=2)
    first.reset_parameters(torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), first.parameters()))
    assert isinstance(gat.convs[0], GATConv) and gat.convs[1].heads == 1


# -- the example ---------------------------------------------------------------------

@pytest.mark.parametrize("model,hidden,bf16", [("gat", "16", False), ("gcn", "32", False),
                                               ("gcn", "32", True)])
def test_example_models_and_bf16_learn_on_cpu(model, hidden, bf16):
    """tests/test_examples.py's small runs of the example with --model gat
    and gcn (and --bf16), on the port with --device cpu."""
    argv = [sys.executable, "-m", "quiver_tpu_torch.examples.reddit_sage", "--device", "cpu",
            "--model", model, "--nodes", "3000", "--dim", "16", "--hidden", hidden,
            "--epochs", "10", "--batch-size", "128", "--sizes", "8,5", "--lr", "0.01"]
    r = subprocess.run(argv + (["--bf16"] if bf16 else []), capture_output=True, text=True,
                       cwd=REPO, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "test acc:" in r.stdout, r.stdout
    assert float(r.stdout.split("test acc:")[1].split()[0]) > 0.5, r.stdout
    assert ("(full inference)" in r.stdout) == (model == "sage"), r.stdout

"""Parity of the port's multi-device slice with quiver_tpu's, on the CPU:
the mesh shape, the topology shard builds, the sharded row gather (K13a's
plain version and the sum over the ici group), the owner-masked sharded
sample (K13b's), the encoded sharded gather (K9c's), the collective byte
models, one step of each train step on a dp 2 x ici 2 mesh, short learning
runs, the example, and the error contracts.

The port's ranks are threads of this process (`local_meshes(...,
device="cpu")` over gloo, driven by `run_ranks`); the JAX side runs on the
suite's 8 virtual CPU devices (tests/conftest.py). Inputs are made from a
numpy seed. Bars:
- shard builds, gathered rows (their bits: -0.0 too), draws and decodes
  bit-equal;
- one train step's loss within 1e-5 absolute and every updated parameter
  within 1e-5 absolute of the JAX step's: torch and XLA sum the gradients
  in different orders (the single-device step's 1e-5 bar), and Adam's first
  step moves each element by lr * g / (|g| + eps), which a difference of a
  few ulps in g changes by far less;
- after a step, every rank's parameters bit-equal."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.datasets import synthetic_powerlaw as j_powerlaw
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.parallel import collectives as jcol
from quiver_tpu.parallel import topology as jtop
from quiver_tpu.parallel import train as jtrain
from quiver_tpu.pyg.sage_sampler import sample_dense_pure as j_dense_pure
from quiver_tpu.quant.lookup import sharded_dequant_gather as j_sharded_dequant
from quiver_tpu.utils import shard_map_compat

from __graft_entry__ import _community_graph
from quiver_tpu_torch import CSRTopo, GraphSAGE, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops.sample import sample_layer, tiled_sample_layer
from quiver_tpu_torch.parallel import (
    build_tiled_topology_shards,
    build_topology_shards,
    gather_comm_bytes,
    local_meshes,
    make_mesh,
    make_mesh_shape,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    partition_rows_by_edges,
    replicated_psum,
    resolve_topology_layout,
    run_ranks,
    sampling_comm_bytes,
    shard_feature_hot_cold,
    shard_feature_rows,
    shard_topology_rows,
    sharded_gather,
    sharded_gather_a2a,
    sharded_gather_grouped,
    sharded_gather_hot_cold,
    sharded_sample_layer,
    tiled_sharded_sample_layer,
)
from quiver_tpu_torch.quant import get_codec, sharded_dequant_gather
from torch_parallel_case import rank_work

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES, LR, HIDDEN = (4, 4), 1e-2, 16
TIMEOUT_S = 60.0


def _meshes(n=4, dp=None, timeout_s=TIMEOUT_S):
    return local_meshes(n, dp=dp, device="cpu", timeout_s=timeout_s)


def _bits(a) -> np.ndarray:
    """The bytes of an array or tensor, so -0.0 and +0.0 differ."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _graph_with_isolated_rows(n=500, seed=0):
    """tests/test_topology_shard.py's graph: a power-law graph plus 5
    degree-0 tail nodes, in both packages."""
    edge_index, _, _, _ = j_powerlaw(n - 5, (n - 5) * 12, seed=seed)
    return (JCSRTopo(edge_index=edge_index, num_nodes=n),
            CSRTopo(edge_index=edge_index, num_nodes=n), n)


def _hub_graph():
    """tests/test_topology_shard.py's hub graph: one row owns 90% of the
    edges, so 4 shards leave empty row ranges."""
    rng = np.random.default_rng(2)
    edge_index = np.stack([
        np.concatenate([np.zeros(900, np.int64), rng.integers(1, 40, 100)]),
        np.concatenate([rng.integers(1, 40, 900), rng.integers(1, 40, 100)]),
    ])
    return (JCSRTopo(edge_index=edge_index, num_nodes=40),
            CSRTopo(edge_index=edge_index, num_nodes=40), 40)


# -- the mesh ------------------------------------------------------------------------

def test_make_mesh_shape_matches_jax():
    for n in range(1, 9):
        for dp in [None] + [d for d in range(1, n + 1) if n % d == 0]:
            assert make_mesh_shape(n, dp) == jtrain.make_mesh_shape(n, dp), (n, dp)
        for bad in (0, -1, n + 1) + ((3,) if n % 3 else ()):
            with pytest.raises(ValueError, match="does not divide"):
                make_mesh_shape(n, bad)


def test_local_meshes_follow_the_jax_device_order():
    meshes = _meshes(8)
    jmesh = jtrain.make_mesh(8)
    assert meshes[0].shape == dict(jmesh.shape)
    ici = meshes[0].ici
    for r, m in enumerate(meshes):
        assert (m.rank, m.dp_idx, m.ici_idx) == (r, r // ici, r % ici)
        assert m.dp_group.size() == m.dp and m.ici_group.size() == ici
        assert jmesh.devices[m.dp_idx, m.ici_idx] == jax.devices()[r]


# -- shard builds ----------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_builds_bit_equal_to_jax(shards):
    jt, tt, _ = _graph_with_isolated_rows()
    indptr, indices = np.asarray(tt.indptr), np.asarray(tt.indices).astype(np.int32)
    assert np.array_equal(partition_rows_by_edges(indptr, shards),
                          jtop.partition_rows_by_edges(np.asarray(jt.indptr), shards))
    for port, ref in ((build_topology_shards, jtop.build_topology_shards),
                      (build_tiled_topology_shards, jtop.build_tiled_topology_shards)):
        got, want = port(indptr, indices, shards), ref(indptr, indices, shards)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_each_rank_holds_its_block_built_on_its_device(layout):
    """shard_topology_rows gives each rank its own block: the tiled one built
    on the device from the block's edges (K12's plain version here), equal
    to the host build's block; no rank holds the whole graph."""
    _, tt, _ = _graph_with_isolated_rows()
    indptr, indices = np.asarray(tt.indptr), np.asarray(tt.indices).astype(np.int32)
    build = build_tiled_topology_shards if layout == "tiled" else build_topology_shards
    a, b, rs = build(indptr, indices, 2)
    blocks = run_ranks(lambda m: shard_topology_rows(m, tt, layout=layout), _meshes(4, dp=2))
    for r, blk in enumerate(blocks):
        p = r % 2
        assert blk.layout == layout and np.array_equal(blk.row_start.numpy(), rs)
        got = (blk.bd, blk.tiles) if layout == "tiled" else (blk.indptr, blk.indices)
        assert np.array_equal(got[0].numpy(), a[p]) and np.array_equal(got[1].numpy(), b[p])
        if layout == "flat":
            assert got[1].shape[0] < indices.shape[0]
    assert resolve_topology_layout(None, "cpu") == "flat"
    assert resolve_topology_layout(None, "cuda") == "tiled"


# -- the sharded gather (K13a) ------------------------------------------------------------

def _jax_gather(jmesh, table, ids):
    f = shard_map_compat(lambda b, i: jcol.sharded_gather(b, i, "ici"), mesh=jmesh,
                         in_specs=(P("ici", None), P()), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(f)(jtrain.shard_feature_rows(jmesh, table),
                                 jtrain.replicate(jmesh, ids)))


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_gather_bit_equal_to_jax(dp):
    """ici 4 (dp 1) and dp 2 x ici 2, as tests/test_parallel.py:48 and :73:
    rows bit-equal to JAX's shard_map of sharded_gather on every rank,
    including a -0.0 (summed to +0.0 across shards, as XLA's psum does) and
    ids past the table, in its padding, negative or the padding sentinel,
    which give zero rows."""
    rng = np.random.default_rng(dp)
    table = rng.standard_normal((63, 8)).astype(np.float32)
    table[5, 3] = -0.0
    ids = np.concatenate([rng.integers(0, 63, 33), [5, -1, 63, 64, 2**31 - 1]]).astype(np.int32)
    want = _jax_gather(jtrain.make_mesh(4, dp=dp), table, ids)
    assert (want[-4:] == 0).all() and np.array_equal(want[:-4], table[ids[:-4]])
    got = run_ranks(lambda m: sharded_gather(shard_feature_rows(m, table), torch.from_numpy(ids),
                                             m), _meshes(4, dp=dp))
    for g in got:
        assert np.array_equal(_bits(g), _bits(want))


# -- the sharded sample (K13b) --------------------------------------------------------------

def _jax_sample(jmesh, stopo, cur, valid, k, key):
    _, feat_axes, _ = jtrain.mesh_axes(jmesh)
    tiled = isinstance(stopo, jtop.TiledShardedTopology)

    def f(stopo, cur, valid):
        if tiled:
            return jtop.tiled_sharded_sample_layer(stopo.bd[0], stopo.tiles[0], stopo.row_start,
                                                   cur, valid, k, key, feat_axes)
        return jtop.sharded_sample_layer(stopo.indptr[0], stopo.indices[0], stopo.row_start,
                                         cur, valid, k, key, feat_axes)

    out = jax.jit(shard_map_compat(f, mesh=jmesh, in_specs=(stopo.specs(feat_axes), P(), P()),
                                   out_specs=(P(), P()), check_vma=False))(
        stopo, jtrain.replicate(jmesh, cur), jtrain.replicate(jmesh, valid))
    return tuple(np.asarray(o) for o in out)


def _port_sample(meshes, tt, layout, cur, valid, k, key):
    def rank(m):
        st = shard_topology_rows(m, tt, layout=layout)
        if layout == "tiled":
            return tiled_sharded_sample_layer(st.bd, st.tiles, st.row_start, cur, valid, k, key, m)
        return sharded_sample_layer(st.indptr, st.indices, st.row_start, cur, valid, k, key, m)
    return run_ranks(rank, meshes)


@pytest.mark.parametrize("graph", ["isolated_rows", "hub"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_sample_bit_equal_to_jax_and_unsharded(graph, n_shards):
    """Flat and tiled, 2 and 4 shards, with degree-0 frontier rows and (the
    hub graph at 4 shards) empty shard ranges, as
    tests/test_topology_shard.py:320 and :361: the assembled (nbrs, valid)
    bit-equal to JAX's, and on the valid lanes to the port's unsharded draw
    with the same key (invalid lanes hold neighbor 0)."""
    jt, tt, n = _graph_with_isolated_rows() if graph == "isolated_rows" else _hub_graph()
    rng = np.random.default_rng(n_shards)
    cur_np = rng.integers(0, n, 64).astype(np.int32)
    if graph == "isolated_rows":
        cur_np[:3] = [n - 1, n - 3, n - 5]  # degree-0 rows
    valid_np = rng.random(64) < 0.9
    k = 6
    jkey, key = jax.random.key(11), qrandom.key(11)
    if graph == "hub" and n_shards == 4:
        assert (np.diff(partition_rows_by_edges(np.asarray(tt.indptr), 4)) == 0).any()
    cur, valid = torch.from_numpy(cur_np), torch.from_numpy(valid_np)
    ref_n, ref_v = sample_layer(*tt.to_device("cpu"), cur, valid, k, key)
    t_n, t_v = tiled_sample_layer(*tt.to_device_tiled("cpu"), cur, valid, k, key)
    assert torch.equal(t_v, ref_v) and torch.equal(t_n[ref_v], ref_n[ref_v])
    jmesh = jtrain.make_mesh(n_shards, dp=1)
    meshes = _meshes(n_shards, dp=1)
    for layout in ("flat", "tiled"):
        want = _jax_sample(jmesh, jtop.shard_topology_rows(jmesh, jt, layout=layout),
                           jnp.asarray(cur_np), jnp.asarray(valid_np), k, jkey)
        for nbrs, v in _port_sample(meshes, tt, layout, cur, valid, k, key):
            assert np.array_equal(v.numpy(), want[1]) and np.array_equal(nbrs.numpy(), want[0])
            assert torch.equal(v, ref_v) and torch.equal(nbrs[ref_v], ref_n[ref_v])
            assert not nbrs[~ref_v].any()


# -- the encoded sharded gather (K9c) ---------------------------------------------------

def _jax_payload(payload):
    if isinstance(payload, torch.Tensor):  # bfloat16: the same bits as ml_dtypes'
        return payload.view(torch.int16).numpy().view(jnp.bfloat16)
    return payload


@pytest.mark.parametrize("codec", ["int8", "bf16", "fp32"])
def test_sharded_dequant_gather_bit_equal_to_jax(codec):
    """As tests/test_quant.py:307 on an ici 4 mesh: the encoded rows summed
    over the stripes and decoded after the sum, bit-equal to JAX's, ids
    outside [0, N) (and in the stripes' padding) zero rows; with side
    tables (int8) and without (bf16, fp32)."""
    c = get_codec(codec)
    rng = np.random.default_rng(7)
    table = (rng.standard_normal((301, 12)) * 3).astype(np.float32)
    enc = c.encode(table)
    ids = np.array([0, 37, 150, 300, 7, -1, 301, 303, 999], np.int32)
    jmesh = jtrain.make_mesh(4, dp=1)
    side = () if enc.scale is None else (enc.scale, enc.zero)
    jblock = jtrain.shard_feature_rows(jmesh, _jax_payload(enc.payload))

    def f(blk, i, *sz):
        return j_sharded_dequant(c.name, blk, i, "ici", *sz)

    specs = (P("ici", None), P()) + (P(),) * len(side)
    want = np.asarray(jax.jit(shard_map_compat(f, mesh=jmesh, in_specs=specs, out_specs=P(),
                                               check_vma=False))(
        jblock, jnp.asarray(ids), *(jnp.asarray(s) for s in side)))
    assert not want[5:].any()
    payload = torch.as_tensor(enc.payload)
    tside = tuple(torch.from_numpy(s) for s in side)
    got = run_ranks(lambda m: sharded_dequant_gather(
        c, shard_feature_rows(m, payload), torch.from_numpy(ids), m, "ici", *tside),
        _meshes(4, dp=1))
    for g in got:
        assert g.dtype == torch.float32 and np.array_equal(_bits(g), _bits(want))


# -- collective byte models ---------------------------------------------------------

@pytest.mark.parametrize("n,dp", [(4, 2), (8, 2), (4, 1)])
def test_comm_byte_models_equal_jax(n, dp):
    jmesh, mesh = jtrain.make_mesh(n, dp=dp), _meshes(n, dp=dp)[0]
    for width, dim in ((512, 32), (1000, 100)):
        assert gather_comm_bytes(mesh, width, dim) == jtop.gather_comm_bytes(jmesh, width, dim)
    for layout in ("flat", "tiled"):
        for caps in (None, (40, None)):
            for fd in (0, 32):
                kw = dict(feature_dim=fd, caps=caps, layout=layout)
                assert (sampling_comm_bytes(mesh, SIZES, 8, **kw)
                        == jtop.sampling_comm_bytes(jmesh, SIZES, 8, **kw))


def test_comm_byte_models_host_options_equal_jax_without_hosts():
    """The JAX models' ``cold_budget``, ``id_bytes`` and ``via`` options act
    on the host axis only: on a mesh without one the port's models give the
    JAX package's bytes with them too (the host terms: tests/test_torch_hosts.py)."""
    jmesh, mesh = jtrain.make_mesh(4, dp=2), _meshes(4, dp=2)[0]
    for kw in (dict(cold_budget=64), dict(id_bytes=8), dict(via="psum"), dict(feat_bytes=2)):
        assert gather_comm_bytes(mesh, 512, 32, **kw) == jtop.gather_comm_bytes(jmesh, 512, 32,
                                                                                 **kw)
    assert (sampling_comm_bytes(mesh, SIZES, 8, via="psum")
            == jtop.sampling_comm_bytes(jmesh, SIZES, 8, via="psum"))
    assert (gather_comm_bytes(mesh, 512, 32, feat_bytes=2)["ici_bytes"] * 2
            == gather_comm_bytes(mesh, 512, 32)["ici_bytes"])


def _counting_sums(monkeypatch):
    """Wrap `parallel.collectives.allreduce_sum` (the one name every sum of
    the port goes through) with a recorder of (group size, dtype, ndim)."""
    from quiver_tpu_torch.parallel import collectives

    seen, orig = [], collectives.allreduce_sum

    def counted(t, group):
        seen.append((group.size(), t.dtype, t.dim()))
        return orig(t, group)

    monkeypatch.setattr(collectives, "allreduce_sum", counted)
    return seen


def test_encoded_gather_sums_through_allreduce_sum(monkeypatch):
    """sharded_dequant_gather's int8 sum goes through
    `collectives.allreduce_sum`: once a rank, over the ici group."""
    seen = _counting_sums(monkeypatch)
    c = get_codec("int8")
    enc = c.encode(np.random.default_rng(3).standard_normal((40, 6)).astype(np.float32))
    side = (torch.from_numpy(enc.scale), torch.from_numpy(enc.zero))
    run_ranks(lambda m: sharded_dequant_gather(c, shard_feature_rows(m, torch.as_tensor(
        enc.payload)), torch.arange(40, dtype=torch.int32), m, "ici", *side), _meshes(4, dp=2))
    assert seen == [(2, torch.int8, 2)] * 4


# -- the train steps ---------------------------------------------------------------

def _flax_params(edge_index, feat_dim):
    """flax GraphSAGE(hidden 16, 4 classes, 2 layers) weights from key(1),
    initialised on a sample of the graph (tests/sharded_train_case.py)."""
    jt = JCSRTopo(edge_index=edge_index)
    jmodel = JGraphSAGE(hidden_dim=HIDDEN, out_dim=4, num_layers=2, dropout=0.0)
    ip, ix = (jnp.asarray(a.astype(np.int32)) for a in (jt.indptr, jt.indices))
    ds0 = j_dense_pure(ip, ix, jax.random.key(0), jnp.arange(8, dtype=jnp.int32), SIZES)
    x0 = jnp.zeros((ds0.n_id.shape[0], feat_dim), jnp.float32)
    return jt, jmodel, jmodel.init(jax.random.key(1), x0, ds0.adjs)


def _case():
    """tests/sharded_train_case.py's graph and model, on dp 2 x ici 2."""
    edge_index, feat, labels, n = _community_graph()
    jt, jmodel, jparams = _flax_params(edge_index, feat.shape[1])
    return dict(feat=feat, labels=labels, n=n, jt=jt, tt=CSRTopo(edge_index=edge_index),
                jmodel=jmodel, jparams=jparams)


def _jax_step(case, topology, pipeline, seeds, step_key, jmodel=None):
    jmodel = jmodel or case["jmodel"]
    jmesh = jtrain.make_mesh(4)
    tx = optax.adam(LR)
    params = jtrain.replicate(jmesh, case["jparams"])
    opt_state = jax.device_put(tx.init(params), NamedSharding(jmesh, P()))
    feat = jtrain.shard_feature_rows(jmesh, case["feat"])
    labels = jtrain.replicate(jmesh, case["labels"])
    seeds = jax.device_put(seeds, NamedSharding(jmesh, P("dp")))
    if topology == "replicated":
        step = jtrain.make_sharded_train_step(jmesh, jmodel, tx, sizes=SIZES, pipeline=pipeline)
        jt = case["jt"]
        graph = tuple(jtrain.replicate(jmesh, a.astype(np.int32)) for a in (jt.indptr, jt.indices))
    else:
        step = jtrain.make_sharded_topo_train_step(jmesh, jmodel, tx, sizes=SIZES,
                                                   pipeline=pipeline, layout=topology)
        graph = (jtop.shard_topology_rows(jmesh, case["jt"], layout=topology),)
    params, _, loss = step(params, opt_state, step_key, *graph, feat, labels, seeds)
    return float(loss), sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _port_rank_step(case, topology, pipeline, seeds, key, steps=1, dtype=None):
    """Run ``steps`` steps on every rank of dp 2 x ici 2; returns each rank's
    (losses, state_dict)."""
    def rank(m):
        model = GraphSAGE(case["feat"].shape[1], HIDDEN, 4, num_layers=2, dropout=0.0,
                          dtype=dtype)
        model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                           case["jparams"])))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        block = shard_feature_rows(m, case["feat"])
        labels = torch.from_numpy(case["labels"])
        if topology == "replicated":
            step = make_sharded_train_step(m, model, opt, SIZES, pipeline=pipeline)
            graph = tuple(torch.from_numpy(np.asarray(a).astype(np.int32))
                          for a in (case["tt"].indptr, case["tt"].indices))
        else:
            step = make_sharded_topo_train_step(m, model, opt, SIZES, pipeline=pipeline,
                                                layout=topology)
            graph = (shard_topology_rows(m, case["tt"], layout=topology),)
        losses = []
        for i in range(steps):
            s = seeds if steps == 1 else seeds[i]
            losses.append(float(step(key if steps == 1 else qrandom.key(i), *graph, block, labels,
                                     torch.from_numpy(s))))
        return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}

    return run_ranks(rank, _meshes(4, dp=2))


STEP_CASES = [("replicated", "dedup"), ("replicated", "fused"), ("flat", "dedup"),
              ("tiled", "fused")]


@pytest.mark.parametrize("topology,pipeline", STEP_CASES)
def test_one_step_matches_the_jax_step(topology, pipeline):
    """One step of make_sharded_train_step (replicated graph) or
    make_sharded_topo_train_step (flat or tiled blocks) on dp 2 x ici 2,
    from flax's weights (dropout 0): the mean loss over dp within 1e-5 and
    every updated parameter within 1e-5 of the JAX step on 4 virtual
    devices; every rank's parameters bit-equal after the step."""
    case = _case()
    seeds = np.random.default_rng(5).choice(case["n"], 16, replace=False).astype(np.int32)
    want_loss, want = _jax_step(case, topology, pipeline, seeds, jax.random.key(3))
    results = _port_rank_step(case, topology, pipeline, seeds, qrandom.key(3))
    (loss0,), params0 = results[0]
    np.testing.assert_allclose(loss0, want_loss, atol=1e-5, rtol=0)
    assert sorted(params0) == sorted(want)
    for name in want:
        np.testing.assert_allclose(params0[name].numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not torch.equal(params0[name], torch.from_numpy(np.asarray(
            sage_params_from_flax(jax.tree_util.tree_map(np.asarray, case["jparams"]))[name])))
    for losses, params in results[1:]:
        assert losses == [loss0]
        for name, p in params.items():
            assert torch.equal(p, params0[name]), name


@pytest.mark.parametrize("topology,pipeline", [("replicated", "dedup"), ("flat", "fused")])
def test_every_sum_of_a_step_goes_through_allreduce_sum(monkeypatch, topology, pipeline):
    """A step's sums all go through `collectives.allreduce_sum`, so a
    wrapper there sees them all (chip_smoke.py's collective clock is one):
    the float32 feature sums over ici, with a sharded graph one int32 sum a
    hop over ici of the draw's stacked [2, W, k] neighbors and flags, and
    one float32 gradient-and-loss sum over dp a rank. With the wrapper in
    place the step gives the same parameters."""
    case = _case()
    seeds = np.random.default_rng(5).choice(case["n"], 16, replace=False).astype(np.int32)
    plain = _port_rank_step(case, topology, pipeline, seeds, qrandom.key(3))
    seen = _counting_sums(monkeypatch)
    counted = _port_rank_step(case, topology, pipeline, seeds, qrandom.key(3))
    for (l0, p0), (l1, p1) in zip(plain, counted):
        assert l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    # dp and ici groups are both of size 2 here; the dp sum is the one 1-D sum
    rows = sum(1 for s in seen if s == (2, torch.float32, 2))
    draws = sum(1 for s in seen if s == (2, torch.int32, 3))
    grads = sum(1 for s in seen if s == (2, torch.float32, 1))
    assert rows >= 4 and grads == 4
    assert draws == (0 if topology == "replicated" else 4 * len(SIZES))
    assert len(seen) == rows + draws + grads


@pytest.mark.parametrize("topology,pipeline", [("replicated", "dedup"), ("tiled", "fused")])
def test_bf16_step_matches_the_jax_step(topology, pipeline):
    """A bfloat16 GraphSAGE (float32 parameters and logits) through one step
    of each step factory: the loss within 0.05 of the JAX bf16 step's (the
    bar of tests/test_models_bf16.py: the port's mean sums in float32 and
    rounds once, JAX's in bfloat16), and every rank's parameters bit-equal."""
    case = _case()
    seeds = np.random.default_rng(6).choice(case["n"], 16, replace=False).astype(np.int32)
    jmodel = JGraphSAGE(hidden_dim=HIDDEN, out_dim=4, num_layers=2, dropout=0.0,
                        dtype=jnp.bfloat16)
    want_loss, _ = _jax_step(case, topology, pipeline, seeds, jax.random.key(3), jmodel)
    results = _port_rank_step(case, topology, pipeline, seeds, qrandom.key(3),
                              dtype=torch.bfloat16)
    (loss0,), params0 = results[0]
    assert abs(loss0 - want_loss) <= 0.05, (loss0, want_loss)
    for losses, params in results[1:]:
        assert losses == [loss0] and all(torch.equal(p, params0[k]) for k, p in params.items())


@pytest.mark.parametrize("topology,pipeline", STEP_CASES)
def test_sharded_train_steps_learn(topology, pipeline):
    """30 steps of batch 8 per dp group on the community graph of
    tests/test_e2e.py, as tests/test_parallel.py:93 and
    tests/test_topology_shard.py:133: the loss falls below 0.7 of its first
    value, and the replicas stay bit-equal."""
    from test_e2e import make_community_graph

    edge_index, feat, labels, n = make_community_graph(per_comm=40)
    case = dict(feat=feat, labels=labels.astype(np.int32), tt=CSRTopo(edge_index=edge_index),
                jparams=_flax_params(edge_index, feat.shape[1])[2])
    rng = np.random.default_rng(3)
    seeds = [rng.choice(n, 16, replace=False).astype(np.int32) for _ in range(30)]
    results = _port_rank_step(case, topology, pipeline, seeds, None, steps=30)
    losses = results[0][0]
    assert losses[-1] < losses[0] * 0.7, losses
    for other, params in results[1:]:
        assert other == losses
        assert all(torch.equal(p, results[0][1][k]) for k, p in params.items())


# -- the example --------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_products_multichip_example_learns_on_cpu(bf16):
    """The example on 4 rank threads (dp 2 x ici 2) at a small size (4
    classes), the graph row-sharded (the flat blocks, the CPU's default) and
    the fused pipeline, in float32 and bfloat16 compute: it trains, and its
    test accuracy is far above chance (0.25)."""
    from quiver_tpu_torch.examples import products_multichip

    res = products_multichip.main(["--device", "cpu", "--nodes", "2000", "--dim", "16",
                                   "--hidden", "32", "--classes", "4", "--sizes", "5,5",
                                   "--epochs", "6", "--steps-per-epoch", "10",
                                   "--batch-per-dp", "64", "--topology", "sharded",
                                   "--pipeline", "fused"] + ["--bf16"] * bf16)
    assert np.isfinite(res["loss"]) and res["test_acc"] > 0.5, res


# -- error contracts -----------------------------------------------------------------

def test_what_still_raises():
    """int64 ids (tables past 2^31 rows, ROADMAP A3) raise in every sharded
    gather; the JAX package's ValueErrors hold: hosts that do not divide
    the ranks, hot/cold without a host axis (also through the example's
    --hot-frac without --hosts), caps on the fused pipeline; make_mesh
    needs an initialised process group."""
    from quiver_tpu_torch.examples import products_multichip

    m = _meshes(2, dp=1)[0]
    wide = torch.zeros(3, dtype=torch.int64)
    block = torch.zeros(4, 2)
    for call in (lambda: sharded_gather(block, wide, m),
                 lambda: sharded_gather_grouped(block, wide, m, "ici", "ici"),
                 lambda: sharded_gather_a2a(block, wide, m),
                 lambda: sharded_gather_hot_cold(block, block, wide, m, ("dp", "ici"), "dp", 2,
                                                 2)):
        with pytest.raises(TypeError, match="ROADMAP A3"):
            call()
    with pytest.raises(ValueError, match="hosts=3 does not divide 4"):
        local_meshes(4, device="cpu", hosts=3)
    with pytest.raises(ValueError, match="multi-host"):
        make_sharded_train_step(m, None, None, SIZES, hot_rows=10, cold_budget=0.5)
    with pytest.raises(ValueError, match="multi-host"):
        shard_feature_hot_cold(m, np.zeros((10, 2), np.float32), 4)
    with pytest.raises(ValueError, match="multi-host"):
        products_multichip.main(["--device", "cpu", "--devices", "2", "--hot-frac", "0.1",
                                 "--nodes", "300", "--epochs", "1"])
    with pytest.raises(ValueError, match="caps only apply"):
        make_sharded_train_step(m, None, None, SIZES, caps=(8, 8), pipeline="fused")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(hosts=2)


def test_a_failing_rank_ends_the_run_within_its_timeout():
    """Rank 2 raises before its first collective: the others' gathers time
    out after 3 s instead of hanging, and run_ranks re-raises rank 2's
    error."""
    meshes = _meshes(4, dp=2, timeout_s=3.0)
    table = np.ones((8, 2), np.float32)

    def rank(m):
        if m.rank == 2:
            raise ValueError("rank 2 gave up")
        return sharded_gather(shard_feature_rows(m, table),
                              torch.arange(8, dtype=torch.int32), m)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 gave up"):
        run_ranks(rank, meshes)
    assert time.monotonic() - t0 < 30


def test_make_mesh_over_a_gloo_world_of_four_processes(tmp_path):
    """make_mesh (one process a rank, torch.distributed) on the CPU: four
    processes over gloo build the dp 2 x ici 2 mesh and then, in the same
    world, the host 2 x dp 1 x ici 2 mesh; on each, a sharded gather and one
    replicated-graph step (the grouped gathers on the host mesh) give every
    rank the rows and parameters the rank threads of local_meshes give."""
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for tag, meshes in (("", _meshes(4, dp=2)),
                        ("hosts", local_meshes(4, hosts=2, device="cpu", timeout_s=TIMEOUT_S))):
        ref = run_ranks(rank_work, meshes)
        for r in range(4):
            got = torch.load(tmp_path / f"rank{r}{tag}.pt")
            assert torch.equal(got["rows"], ref[r]["rows"])
            assert all(torch.equal(got["params"][k], v) for k, v in ref[r]["params"].items())


RANK_SCRIPT = """
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, %r)
torch.set_num_threads(1)
from torch_parallel_case import rank_work
from quiver_tpu_torch.parallel import make_mesh, run_ranks
dist.init_process_group("gloo")
m = make_mesh(dp=2, device="cpu", timeout_s=60)
out = run_ranks(rank_work, [m])[0]
torch.save(out, f"{sys.argv[1]}/rank{dist.get_rank()}.pt")
m = make_mesh(hosts=2, device="cpu", timeout_s=60)
assert m.shape == {"host": 2, "dp": 1, "ici": 2}
out = run_ranks(rank_work, [m])[0]
torch.save(out, f"{sys.argv[1]}/rank{dist.get_rank()}hosts.pt")
dist.destroy_process_group()
""" % os.path.dirname(os.path.abspath(__file__))


def test_parallel_modules_load_no_jax_or_reference_package():
    code = (
        "import sys; before = set(sys.modules); import quiver_tpu_torch.parallel, "
        "quiver_tpu_torch.parallel.train, quiver_tpu_torch.parallel.topology, "
        "quiver_tpu_torch.parallel.collectives, quiver_tpu_torch.quant.lookup, "
        "quiver_tpu_torch.examples.products_multichip, quiver_tpu_torch.multiprocessing, "
        "quiver_tpu_torch.comm; "
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'quiver_tpu', 'quiver')); print(repr(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_take_the_card_unless_cpu_is_asked(monkeypatch):
    from quiver_tpu_torch.examples import products_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_meshes(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        products_multichip.main(["--nodes", "300", "--epochs", "1"])
    assert all(m.device.type == "cpu" for m in local_meshes(2, device="cpu"))


def test_rank_threads_under_fast_thread_switching():
    """Eight rank threads (dp 2 x ici 4), more than this box's cores, with
    the interpreter switching threads every microsecond: twenty sharded
    gathers of different ids and a replicated-psum of each rank's index, all
    exact on every rank (a lost or crossed collective would break them)."""
    meshes = _meshes(8, dp=2)
    rng = np.random.default_rng(9)
    table = rng.standard_normal((101, 3)).astype(np.float32)
    idss = [rng.integers(-2, 104, 50).astype(np.int32) for _ in range(20)]

    def rank(m):
        block = shard_feature_rows(m, table)
        rows = [sharded_gather(block, torch.from_numpy(ids), m) for ids in idss]
        total = replicated_psum(torch.tensor([m.rank], dtype=torch.int32), m, "dp")
        return rows, int(total)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = run_ranks(rank, meshes, timeout_s=120)
    finally:
        sys.setswitchinterval(old)
    for r, (rows, total) in enumerate(results):
        assert total == sum(rr for rr in range(8) if rr % 4 == r % 4)
        for ids, got in zip(idss, rows):
            ok = (ids >= 0) & (ids < 101)
            assert np.array_equal(got.numpy()[ok], table[ids[ok]]) and not got.numpy()[~ok].any()

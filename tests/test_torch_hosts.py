"""Parity of the port's host axis with quiver_tpu's, on the CPU: the
(host, dp, ici) mesh, the grouped and all-to-all gathers (K13c's plain
unpack), the replicated-hot/cold gather (K13d's plain compaction and
merge), the grouped samplers (K13e), the hot/cold placement and budget
calibration, the byte models' host terms, one step of each host layout
against the JAX step, a learning run, the example, the collective wrappers
and the error contracts.

The port's ranks are threads of this process (`local_meshes(8, hosts=2,
device="cpu")`: host 2 x dp 2 x ici 2 over gloo, driven by `run_ranks`);
the JAX side runs `make_mesh(8, hosts=2)` on the suite's 8 virtual CPU
devices (tests/conftest.py). Inputs are made from a numpy seed. Bars, as in
tests/test_torch_parallel.py:
- gathered rows (their bits: -0.0 too), overflows and draws bit-equal;
- one train step's loss and every updated parameter within 1e-5 absolute of
  the JAX step's (torch and XLA sum the gradients in different orders);
- after a step, every rank's parameters bit-equal."""

import re
from pathlib import Path

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
from quiver_tpu.pyg import GraphSageSampler as JGraphSageSampler
from quiver_tpu.pyg.sage_sampler import sample_dense_fused as j_dense_fused
from quiver_tpu.pyg.sage_sampler import sample_dense_pure as j_dense_pure
from quiver_tpu.utils import heat_reorder as j_heat_reorder
from quiver_tpu.utils import shard_map_compat

from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops.sample import sample_layer
from quiver_tpu_torch.parallel import (
    calibrate_cold_budget,
    collectives,
    gather_comm_bytes,
    local_meshes,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    mesh_axes,
    run_ranks,
    sampling_comm_bytes,
    shard_feature_hot_cold,
    shard_feature_rows,
    shard_topology_rows,
    sharded_gather_a2a,
    sharded_gather_grouped,
    sharded_gather_hot_cold,
    sharded_sample_layer,
    sharded_sample_layer_grouped,
    tiled_sharded_sample_layer,
    tiled_sharded_sample_layer_grouped,
)
from quiver_tpu_torch.parallel.topology import (
    build_tiled_topology_shards,
    build_topology_shards,
    sample_layer_partial_plain,
    sample_layer_partial_slab,
    tiled_sample_layer_partial_plain,
    tiled_sample_layer_partial_slab,
)
from quiver_tpu_torch.parallel.train import stripe_rows
from quiver_tpu_torch.utils import heat_reorder

torch.set_num_threads(1)

SIZES, LR, HIDDEN = (4, 4), 1e-2, 16
TIMEOUT_S = 60.0
HOT = 32  # tests/test_hot_cold.py's hot prefix


def _meshes(n=8, hosts=2, timeout_s=TIMEOUT_S):
    return local_meshes(n, hosts=hosts, device="cpu", timeout_s=timeout_s)


def _jmesh(n=8):
    return jtrain.make_mesh(n, hosts=2)


def _bits(a) -> np.ndarray:
    """The bytes of an array or tensor, so -0.0 and +0.0 differ."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _group(m) -> int:
    return m.index(("host", "dp"))


# -- the mesh ------------------------------------------------------------------------

def test_host_mesh_follows_the_jax_device_order():
    meshes = _meshes()
    jmesh = _jmesh()
    assert meshes[0].shape == dict(jmesh.shape) == {"host": 2, "dp": 2, "ici": 2}
    assert mesh_axes(meshes[0]) == jtrain.mesh_axes(jmesh)[:2] + (4,)
    for r, m in enumerate(meshes):
        h, d, i = m.host_idx, m.dp_idx, m.ici_idx
        assert m.rank == r == (h * 2 + d) * 2 + i
        assert jmesh.devices[h, d, i] == jax.devices()[r]
        assert m.index(("host", "dp")) == h * 2 + d and m.index(("host", "ici")) == h * 2 + i
        sizes = {axes: m.group(axes).size() for axes in
                 ("dp", "ici", "host", ("host", "dp"), ("host", "ici"))}
        assert sizes == {"dp": 2, "ici": 2, "host": 2, ("host", "dp"): 4, ("host", "ici"): 4}
        assert m.dp_group is m.group("dp") and m.ici_group is m.group(("ici",))
    with pytest.raises(ValueError, match="no group over"):
        meshes[0].group(("dp", "ici"))


def test_host_mesh_groups_rank_their_members_flat():
    """Each group's rank of a member is its flat index over the group's
    axes: an all-gather of the flat rank over each group lists its members
    in that order."""
    def rank(m):
        me = torch.tensor([m.rank], dtype=torch.int32)
        return {axes: collectives.allgather(me, m.group(axes)).reshape(-1).tolist()
                for axes in ("host", ("host", "dp"), ("host", "ici"))}

    for r, got in enumerate(run_ranks(rank, _meshes())):
        h, d, i = r // 4, (r // 2) % 2, r % 2
        assert got["host"] == [(hh * 2 + d) * 2 + i for hh in range(2)]
        assert got[("host", "dp")] == [(hh * 2 + dd) * 2 + i for hh in range(2) for dd in range(2)]
        assert got[("host", "ici")] == [(hh * 2 + d) * 2 + ii for hh in range(2)
                                        for ii in range(2)]


@pytest.mark.parametrize("n,hosts", [(8, 3), (8, 0), (6, 4)])
def test_hosts_must_divide_the_ranks(n, hosts):
    with pytest.raises(ValueError, match=f"hosts={hosts} does not divide {n}"):
        jtrain.make_mesh(n, hosts=hosts)
    with pytest.raises(ValueError, match=f"hosts={hosts} does not divide {n}"):
        local_meshes(n, hosts=hosts, device="cpu")


# -- the grouped gathers (K13c) -------------------------------------------------------

def _grouped_inputs(seed, n=64, d=4, w=12):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    table[5, 1] = -0.0
    ids = rng.integers(0, n, (4, w)).astype(np.int32)  # distinct per data group
    ids[:, 0] = 5
    ids[0, 1:4] = [-1, n, 2**31 - 1]
    ids[3, -2:] = [n + 3, -7]  # past the table, in the stripes' padding
    return table, ids


def _jax_grouped(jmesh, table, ids, feat_axes, via):
    data_axes = ("host", "dp")
    f = shard_map_compat(lambda b, i: jcol.sharded_gather_grouped(b, i, feat_axes, "host",
                                                                  via=via),
                         mesh=jmesh, in_specs=(P(feat_axes, None), P(data_axes)),
                         out_specs=P(data_axes), check_vma=False)
    block = jax.device_put(jnp.asarray(jcol.pad_to_multiple(
        table, int(np.prod([jmesh.shape[a] for a in feat_axes])))),
        NamedSharding(jmesh, P(feat_axes, None)))
    ids_dev = jax.device_put(jnp.asarray(ids.reshape(-1)), NamedSharding(jmesh, P(data_axes)))
    return np.asarray(jax.jit(f)(block, ids_dev)).reshape(ids.shape + (-1,))


@pytest.mark.parametrize("feat_axes,via", [(("host", "ici"), "scatter"),
                                           (("host", "ici"), "psum"),
                                           (("ici",), "scatter")])
def test_grouped_gather_bit_equal_to_jax(feat_axes, via):
    """Both via spellings over (host, ici) stripes, and the branch where the
    table is not striped over the group axis (ici stripes, replicated per
    host), as tests/test_parallel.py:253: each data group's own rows, bit
    for bit (a -0.0 summed to +0.0; ids outside the table zero rows)."""
    table, ids = _grouped_inputs(1)
    want = _jax_grouped(_jmesh(), table, ids, feat_axes, via)
    ok = (ids >= 0) & (ids < table.shape[0])
    assert np.array_equal(want[ok], table[ids[ok]]) and not want[~ok].any()

    def rank(m):
        block = stripe_rows(table, m.axis_size(feat_axes), m.index(feat_axes))
        return sharded_gather_grouped(torch.from_numpy(block), torch.from_numpy(ids[_group(m)]),
                                      m, feat_axes, "host", via=via)

    for m, got in zip(_meshes(), run_ranks(rank, _meshes())):
        assert np.array_equal(_bits(got), _bits(want[_group(m)]))


def test_a2a_gather_bit_equal_to_jax():
    """sharded_gather_a2a over ici (stripes over ici, every rank its own
    ids), against JAX's on the host mesh."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((30, 3)).astype(np.float32)
    ids = rng.integers(-2, 33, (8, 10)).astype(np.int32)
    jmesh = _jmesh()
    every = ("host", "dp", "ici")
    f = shard_map_compat(lambda b, i: jcol.sharded_gather_a2a(b, i, "ici", 2), mesh=jmesh,
                         in_specs=(P("ici", None), P(every)), out_specs=P(every),
                         check_vma=False)
    want = np.asarray(jax.jit(f)(
        jax.device_put(jnp.asarray(jcol.pad_to_multiple(table, 2)),
                       NamedSharding(jmesh, P("ici", None))),
        jax.device_put(jnp.asarray(ids.reshape(-1)), NamedSharding(jmesh, P(every))),
    )).reshape(8, 10, 3)
    got = run_ranks(lambda m: sharded_gather_a2a(torch.from_numpy(stripe_rows(table, 2, m.ici_idx)),
                                                 torch.from_numpy(ids[m.rank]), m, "ici"),
                    _meshes())
    for r, g in enumerate(got):
        assert np.array_equal(_bits(g), _bits(want[r]))


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_encoded_gather_over_host_and_ici_bit_equal_to_jax(codec):
    """sharded_dequant_gather over the tuple ("host", "ici") (the payload
    striped four ways, the same ids on every rank), as JAX's over the same
    axes: decoded rows bit-equal, ids outside [0, N) zero rows."""
    from quiver_tpu.quant.lookup import sharded_dequant_gather as j_sharded_dequant

    from quiver_tpu_torch.quant import get_codec, sharded_dequant_gather

    c = get_codec(codec)
    rng = np.random.default_rng(7)
    enc = c.encode((rng.standard_normal((203, 12)) * 3).astype(np.float32))
    ids = np.array([0, 37, 150, 202, 7, -1, 203, 205, 999], np.int32)
    jmesh = _jmesh()
    feat = ("host", "ici")
    side = () if enc.scale is None else (enc.scale, enc.zero)
    payload = enc.payload if isinstance(enc.payload, np.ndarray) else \
        enc.payload.view(torch.int16).numpy().view(jnp.bfloat16)
    jblock = jax.device_put(jnp.asarray(jcol.pad_to_multiple(payload, 4)),
                            NamedSharding(jmesh, P(feat, None)))
    want = np.asarray(jax.jit(shard_map_compat(
        lambda blk, i, *sz: j_sharded_dequant(c.name, blk, i, feat, *sz), mesh=jmesh,
        in_specs=(P(feat, None), P()) + (P(),) * len(side), out_specs=P(), check_vma=False))(
        jblock, jnp.asarray(ids), *(jnp.asarray(x) for x in side)))
    tpayload = torch.as_tensor(enc.payload)
    tside = tuple(torch.from_numpy(x) for x in side)
    got = run_ranks(lambda m: sharded_dequant_gather(c, shard_feature_rows(m, tpayload),
                                                     torch.from_numpy(ids), m, feat, *tside),
                    _meshes())
    assert not want[5:].any()
    for g in got:
        assert np.array_equal(_bits(g), _bits(want))


# -- the hot/cold gather (K13d) -------------------------------------------------------------

def _jax_hot_cold(jmesh, table, hot_rows, ids, budget):
    """tests/test_hot_cold.py:36's shard_map of sharded_gather_hot_cold."""
    _, feat_axes, _ = jtrain.mesh_axes(jmesh)
    hot_dev, cold_dev = jtrain.shard_feature_hot_cold(jmesh, table, hot_rows)

    def f(hot, cold, i):
        rows, overflow = jcol.sharded_gather_hot_cold(hot, cold, i[0], feat_axes, "host",
                                                      hot_rows, budget)
        return rows[None], overflow[None]

    data = P(("host", "dp"))
    rows, overflow = jax.jit(shard_map_compat(
        f, mesh=jmesh, in_specs=(P(("ici",), None), P(feat_axes, None), data),
        out_specs=(data, data), check_vma=False))(
        hot_dev, cold_dev, jax.device_put(jnp.asarray(ids), NamedSharding(jmesh, data)))
    return np.asarray(rows), np.asarray(overflow)


def _port_hot_cold(table, hot_rows, ids, budget):
    def rank(m):
        hot, cold = shard_feature_hot_cold(m, table, hot_rows)
        return sharded_gather_hot_cold(hot, cold, torch.from_numpy(ids[_group(m)]), m,
                                       ("host", "ici"), "host", hot_rows, budget)
    return _meshes(), run_ranks(rank, _meshes())


def _hot_cold_ids(rng, w=32, hot_share=0.75, n=100):
    return np.where(rng.random(w) < hot_share, rng.integers(0, HOT, w),
                    rng.integers(HOT, n, w)).astype(np.int32)


@pytest.mark.parametrize("case", ["generous", "overflow", "fraction"])
def test_hot_cold_gather_bit_equal_to_jax(case):
    """A generous int budget (no overflow; the rows are the table's, as
    tests/test_hot_cold.py:67), an all-cold batch past a budget of 4 (the
    overflow counted, 4 rows served, the rest zero, as :90), and a float
    budget (a fraction of the width in 256-lane granules); with -1,
    past-the-end and sentinel ids, which are neither hot nor cold, and a
    -0.0 element: rows and overflow bit-equal to JAX's on every rank."""
    rng = np.random.default_rng({"generous": 0, "overflow": 1, "fraction": 2}[case])
    table = rng.standard_normal((100, 8)).astype(np.float32)
    table[HOT + 3, 2] = -0.0
    table[7, 0] = -0.0
    if case == "overflow":
        ids = np.stack([np.arange(HOT + g, HOT + g + 8, dtype=np.int32) for g in range(4)])
        budget = 4
    else:
        ids = np.stack([_hot_cold_ids(rng) for _ in range(4)])
        ids[:, 0] = [7, HOT + 3, -1, 100]
        ids[1, 1:3] = [2**31 - 1, 101]
        budget = 16 if case == "generous" else 0.3
    want_rows, want_over = _jax_hot_cold(_jmesh(), table, HOT, ids, budget)
    if case == "overflow":
        assert (want_over == 4).all() and ((np.abs(want_rows).sum(-1) > 0).sum(-1) == 4).all()
    else:
        assert (want_over == 0).all()
        ok = (ids >= 0) & (ids < 100)
        assert np.array_equal(want_rows[ok], table[ids[ok]]) and not want_rows[~ok].any()
    meshes, got = _port_hot_cold(table, HOT, ids, budget)
    for m, (rows, over) in zip(meshes, got):
        g = _group(m)
        assert over.dtype == torch.int32 and int(over) == int(want_over[g])
        assert np.array_equal(_bits(rows), _bits(want_rows[g]))


def test_cold_compaction_and_merge_plain_versions():
    """K13d's plain compaction against the stable argsort it replaces, with
    n_cold below, at and above the budget, W not a multiple of the kernel's
    1,024-lane tile and out-of-range ids; the plain merge against
    index_add_ of the masked rows (a -0.0 hot element plus the zero row of
    a lane past n_cold is +0.0, as JAX's scatter-add)."""
    rng = np.random.default_rng(3)
    W = 2500
    ids = rng.integers(-5, 1200, W).astype(np.int32)
    ids[:3] = [2**31 - 1, -1, 1000]
    lo, hi = 400, 1000
    cold = (ids >= lo) & (ids < hi)
    n_cold = int(cold.sum())
    order = np.argsort(np.where(cold, 0, 1), kind="stable")
    for budget in (n_cold - 100, n_cold, n_cold + 37, W):
        sel, local, counts = collectives.cold_compact(torch.from_numpy(ids), lo, hi, budget)
        assert np.array_equal(sel.numpy(), order[:budget])
        ok = np.arange(budget) < n_cold
        assert np.array_equal(local.numpy(), np.where(ok, ids[order[:budget]] - lo, -1))
        assert counts.tolist() == [n_cold, max(n_cold - budget, 0)]
    hot = torch.from_numpy(rng.standard_normal((W, 5)).astype(np.float32))
    hot[order[n_cold + 1], 2] = -0.0
    budget = n_cold + 5
    sel, _, counts = collectives.cold_compact(torch.from_numpy(ids), lo, hi, budget)
    rows = torch.from_numpy(rng.standard_normal((budget, 5)).astype(np.float32))
    got = collectives.cold_merge(hot.clone(), sel, rows, counts)
    want = hot.clone().index_add_(0, sel.long(), torch.where(
        torch.arange(budget)[:, None] < n_cold, rows, torch.zeros(())))
    assert np.array_equal(_bits(got), _bits(want))
    assert _bits(got[order[n_cold + 1], 2:3]).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="exceeds gather width"):
        collectives.cold_budget_lanes(10, 11)
    assert collectives.cold_budget_lanes(1000, 0.3) == 512
    assert collectives.cold_budget_lanes(100, 0.3) == 100


@pytest.mark.parametrize("W", [1, 1023, 1024, 1025])
@pytest.mark.parametrize("cold", ["none", "all", "some"])
def test_cold_compaction_plain_at_edge_cases(W, cold):
    """K13d's plain compaction (the card kernel's reference) against
    collectives.py:210-215's stable argsort at the card tests' edge cases:
    n_cold = 0, n_cold = W and a third cold, budgets 0, n_cold and W (and
    either side of n_cold), W = 1 and one 1,024-lane tile and either side."""
    rng = np.random.default_rng(W + len(cold))
    lo, hi = 400, 1000
    share = {"none": 0.0, "all": 1.0, "some": 1 / 3}[cold]
    ids = np.where(rng.random(W) < share, rng.integers(lo, hi, W),
                   rng.integers(-3, lo, W)).astype(np.int32)
    if cold == "some":
        ids[rng.random(W) < 0.05] = 2**31 - 1  # a padding sentinel: neither hot nor cold
    jids = jnp.asarray(ids)
    is_cold = (jids >= lo) & (jids < hi)
    n_cold = int(is_cold.sum().astype(jnp.int32))
    assert n_cold == {"none": 0, "all": W}.get(cold, n_cold)
    order = jnp.argsort(jnp.where(is_cold, 0, 1), stable=True)
    for budget in sorted({0, max(n_cold - 1, 0), n_cold, min(n_cold + 1, W), W}):
        sel = order[:budget]
        lane_ok = jnp.arange(budget, dtype=jnp.int32) < n_cold
        cold_local = jnp.where(lane_ok, jnp.take(jids, sel) - lo, -1)
        got = collectives.cold_compact(torch.from_numpy(ids), lo, hi, budget)
        assert all(t.dtype == torch.int32 for t in got)
        assert np.array_equal(got[0].numpy(), np.asarray(sel))
        assert np.array_equal(got[1].numpy(), np.asarray(cold_local))
        assert got[2].tolist() == [n_cold, max(n_cold - budget, 0)]


def test_grouped_unpack_plain_sums_in_group_order():
    """K13c's plain unpack: floats summed in float32 (bf16 rounded once), a
    -0.0 owner plus +0.0 is +0.0, int8 and int32 exact (the grouped draw's
    neighbor and valid slabs)."""
    a = torch.tensor([[[-0.0, 1.5], [2.0, 0.0]], [[0.0, 0.0], [0.0, -3.25]]])
    got = collectives.grouped_unpack(a)
    assert _bits(got).tolist() == _bits(torch.tensor([[0.0, 1.5], [2.0, -3.25]])).tolist()
    assert torch.equal(collectives.grouped_unpack(a.to(torch.bfloat16)), got.to(torch.bfloat16))
    for dt in (torch.int8, torch.int32):
        s = torch.tensor([[[-7, 0]], [[0, 100]], [[0, 0]]], dtype=dt)
        assert torch.equal(collectives.grouped_unpack(s), torch.tensor([[-7, 100]], dtype=dt))
    nbrs = torch.tensor([[[3, 0]], [[0, 4]]], dtype=torch.int32)  # a grouped draw's [G, W, k]
    assert collectives.grouped_unpack(nbrs).tolist() == [[3, 4]]


# -- the grouped samplers (K13e) ------------------------------------------------------------

def _graph_with_isolated_rows(n=500, seed=0):
    edge_index, _, _, _ = j_powerlaw(n - 5, (n - 5) * 12, seed=seed)
    return (JCSRTopo(edge_index=edge_index, num_nodes=n),
            CSRTopo(edge_index=edge_index, num_nodes=n), n)


@pytest.mark.parametrize("via", ["scatter", "psum"])
def test_grouped_samplers_bit_equal_to_jax_and_unsharded(via):
    """Flat and tiled, both via spellings, hosts carrying distinct frontiers
    with a degree-0 row (tests/test_topology_shard.py:394): each rank's
    (nbrs, valid) bit-equal to JAX's, and on the valid lanes to the port's
    unsharded draw of the host-concatenated frontier (neighbor 0
    elsewhere)."""
    jt, tt, n = _graph_with_isolated_rows()
    w, k = 24, 5
    rng = np.random.default_rng(3)
    all_cur = rng.integers(0, n, 2 * w).astype(np.int32)
    all_cur[0] = n - 1
    all_valid = rng.random(2 * w) < 0.9
    jkey, key = jax.random.key(9), qrandom.key(9)
    ref_n, ref_v = sample_layer(*tt.to_device("cpu"), torch.from_numpy(all_cur),
                                torch.from_numpy(all_valid), k, key)
    jmesh = _jmesh()
    feat_axes = ("host", "ici")
    meshes = _meshes()
    for layout in ("flat", "tiled"):
        stopo = jtop.shard_topology_rows(jmesh, jt, layout=layout)
        tiled = layout == "tiled"

        def f(stopo, cur, valid_in):
            blk = (stopo.bd[0], stopo.tiles[0]) if tiled else (stopo.indptr[0],
                                                               stopo.indices[0])
            fn = (jtop.tiled_sharded_sample_layer_grouped if tiled
                  else jtop.sharded_sample_layer_grouped)
            return fn(*blk, stopo.row_start, cur, valid_in, k, jkey, feat_axes, "host", via=via)

        hs = NamedSharding(jmesh, P(("host",)))
        want_n, want_v = (np.asarray(o) for o in jax.jit(shard_map_compat(
            f, mesh=jmesh, in_specs=(stopo.specs(feat_axes), P(("host",)), P(("host",))),
            out_specs=(P(("host",), None), P(("host",), None)), check_vma=False))(
            stopo, jax.device_put(jnp.asarray(all_cur), hs),
            jax.device_put(jnp.asarray(all_valid), hs)))

        def rank(m):
            st = shard_topology_rows(m, tt, layout=layout)
            blk = (st.bd, st.tiles) if tiled else (st.indptr, st.indices)
            fn = tiled_sharded_sample_layer_grouped if tiled else sharded_sample_layer_grouped
            h = m.host_idx
            return fn(*blk, st.row_start, torch.from_numpy(all_cur[h * w:(h + 1) * w]),
                      torch.from_numpy(all_valid[h * w:(h + 1) * w]), k, key, m, feat_axes,
                      "host", via=via)

        for m, (nbrs, valid) in zip(meshes, run_ranks(rank, meshes)):
            sl = slice(m.host_idx * w, (m.host_idx + 1) * w)
            assert np.array_equal(valid.numpy(), want_v[sl]), layout
            assert np.array_equal(nbrs.numpy(), want_n[sl]), layout
            rv = ref_v[sl]
            assert torch.equal(valid, rv) and torch.equal(nbrs[rv], ref_n[sl][rv])
            assert not nbrs[~rv].any()


def _counting_collectives(monkeypatch):
    """Wrap every collective of `parallel.collectives.COLLECTIVES` with a
    recorder of (wrapper, group size); returns the record."""
    seen = []
    for name in collectives.COLLECTIVES:
        orig = getattr(collectives, name)

        def counted(t, group, _orig=orig, _name=name):
            seen.append((_name, group.size()))
            return _orig(t, group)

        monkeypatch.setattr(collectives, name, counted)
    return seen


@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("via", ["scatter", "psum", "ungrouped"])
def test_a_sharded_hop_exchanges_one_stacked_slab(monkeypatch, layout, via):
    """One hop of a sharded draw moves its neighbors and int32 flags as one
    stacked slab: a grouped hop makes its two frontier all-gathers, then one
    all-to-all and one ici all-reduce (``via="scatter"``) or one all-reduce
    over (host, ici) and no all-to-all (``via="psum"``); an ungrouped hop
    (one frontier on every rank) one all-reduce over (host, ici). The draws stay the unsharded draw on the valid
    lanes, neighbor 0 elsewhere."""
    _, tt, n = _graph_with_isolated_rows()
    w, k = 24, 5
    rng = np.random.default_rng(4)
    all_cur = rng.integers(0, n, 2 * w).astype(np.int32)
    all_valid = rng.random(2 * w) < 0.9
    key = qrandom.key(11)
    meshes = _meshes()
    blocks = {m.rank: shard_topology_rows(m, tt, layout=layout) for m in meshes}
    seen = _counting_collectives(monkeypatch)

    def rank(m):
        st = blocks[m.rank]
        blk = (st.bd, st.tiles) if layout == "tiled" else (st.indptr, st.indices)
        if via == "ungrouped":
            fn = tiled_sharded_sample_layer if layout == "tiled" else sharded_sample_layer
            return fn(*blk, st.row_start, torch.from_numpy(all_cur[:w]),
                      torch.from_numpy(all_valid[:w]), k, key, m, ("host", "ici"))
        fn = (tiled_sharded_sample_layer_grouped if layout == "tiled"
              else sharded_sample_layer_grouped)
        h = m.host_idx
        return fn(*blk, st.row_start, torch.from_numpy(all_cur[h * w:(h + 1) * w]),
                  torch.from_numpy(all_valid[h * w:(h + 1) * w]), k, key, m, ("host", "ici"),
                  "host", via=via)

    results = run_ranks(rank, meshes)
    calls = {}
    for name, size in seen:
        calls[name, size] = calls.get((name, size), 0) + 1
    R = len(meshes)
    want = {"ungrouped": {("allreduce_sum", 4): R},
            "scatter": {("allgather", 2): 2 * R, ("all_to_all", 2): R,
                        ("allreduce_sum", 2): R},
            "psum": {("allgather", 2): 2 * R, ("allreduce_sum", 4): R}}[via]
    assert calls == want, calls
    # a grouped hop draws at the gathered width, an ungrouped one at its own
    n_in = w if via == "ungrouped" else 2 * w
    ref_n, ref_v = sample_layer(*tt.to_device("cpu"), torch.from_numpy(all_cur[:n_in]),
                                torch.from_numpy(all_valid[:n_in]), k, key)
    for m, (nbrs, valid) in zip(meshes, results):
        h = 0 if via == "ungrouped" else m.host_idx
        rv = ref_v[h * w:(h + 1) * w]
        assert valid.dtype == torch.bool and nbrs.dtype == torch.int32
        assert torch.equal(valid, rv) and torch.equal(nbrs[rv], ref_n[h * w:(h + 1) * w][rv])
        assert not nbrs[~rv].any()


@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_stacked_slab_halves_equal_the_pair_and_jax(layout, groups):
    """K13b's stacked slab ``[G, 2, w, k]`` (`sample_layer_partial_slab`):
    group g's first half is its rows of the plain path's neighbor slab, its
    second half their int32 flags, and both equal the JAX package's
    per-shard partial (`_sample_layer_partial`, `_tiled_sample_layer_partial`
    in the suite's `shard_map`) on every (host, ici) shard."""
    jt, tt, n = _graph_with_isolated_rows()
    w, k = 12, 5
    W = groups * w
    rng = np.random.default_rng(groups)
    cur = rng.integers(0, n, W).astype(np.int32)
    cur[0] = n - 1
    valid_in = rng.random(W) < 0.9
    jkey, key = jax.random.key(8), qrandom.key(8)
    jmesh = _jmesh()
    feat_axes = ("host", "ici")
    tiled = layout == "tiled"
    stopo = jtop.shard_topology_rows(jmesh, jt, layout=layout)

    def f(stopo, c, v):
        blk = (stopo.bd[0], stopo.tiles[0]) if tiled else (stopo.indptr[0], stopo.indices[0])
        fn = jtop._tiled_sample_layer_partial if tiled else jtop._sample_layer_partial
        nb, va = fn(*blk, stopo.row_start, c, v, k, jkey, feat_axes)
        return nb[None], va[None]

    every = P(("host", "dp", "ici"))
    jn, jv = (np.asarray(o) for o in jax.jit(shard_map_compat(
        f, mesh=jmesh, in_specs=(stopo.specs(feat_axes), P(), P()),
        out_specs=(every, every), check_vma=False))(stopo, jnp.asarray(cur),
                                                    jnp.asarray(valid_in)))
    if tiled:
        a, b, rs = build_tiled_topology_shards(tt.indptr, tt.indices.astype(np.int32), 4)
        slab_fn, pair_fn = tiled_sample_layer_partial_slab, tiled_sample_layer_partial_plain
    else:
        a, b, rs = build_topology_shards(tt.indptr, tt.indices.astype(np.int32), 4)
        slab_fn, pair_fn = sample_layer_partial_slab, sample_layer_partial_plain
    for p in range(4):
        args = (torch.from_numpy(a[p]), torch.from_numpy(b[p]), int(rs[p]), int(rs[p + 1]),
                torch.from_numpy(cur), torch.from_numpy(valid_in), k, key)
        slab = slab_fn(*args, groups=groups)
        nbrs, valid = pair_fn(*args)
        assert slab.shape == (groups, 2, w, k) and slab.dtype == torch.int32
        assert torch.equal(slab[:, 0].reshape(W, k), nbrs)
        assert torch.equal(slab[:, 1].reshape(W, k), valid)
        d = (p // 2) * 4 + p % 2  # device (host, dp = 0, ici) of shard (host, ici)
        assert np.array_equal(slab[:, 0].reshape(W, k).numpy(), jn[d])
        assert np.array_equal(slab[:, 1].reshape(W, k).numpy(), jv[d])
    with pytest.raises(ValueError, match="does not split into"):
        slab_fn(*args, groups=5)


# -- placement, calibration, byte models --------------------------------------------------

def test_hot_cold_blocks_and_calibrated_budget_equal_jax():
    """shard_feature_hot_cold gives every rank JAX's device blocks (hot
    striped over ici and replicated per host, cold striped over (host, ici),
    both zero-padded); calibrate_cold_budget over the same probes on the
    same heat-ordered graph equals JAX's (tests/test_hot_cold.py:196), and
    bounds fresh batches' cold share."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((101, 3)).astype(np.float32)
    jmesh = _jmesh()
    jhot, jcold = jtrain.shard_feature_hot_cold(jmesh, table, 37)

    def by_device(arr):
        return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}

    jh, jc = by_device(jhot), by_device(jcold)
    for m, (hot, cold) in zip(_meshes(), run_ranks(lambda m: shard_feature_hot_cold(
            m, table, 37), _meshes())):
        dev = jmesh.devices[m.host_idx, m.dp_idx, m.ici_idx].id
        assert np.array_equal(hot.numpy(), jh[dev]) and np.array_equal(cold.numpy(), jc[dev])

    from test_e2e import make_community_graph

    edge_index, _, _, n = make_community_graph(per_comm=40)
    edge_r = j_heat_reorder(edge_index, n)[0]
    assert np.array_equal(edge_r, heat_reorder(edge_index, n)[0])
    probes = [np.random.default_rng(0).choice(n, 32, replace=False) for _ in range(6)]
    hot = n // 4
    want = jtrain.calibrate_cold_budget(
        JGraphSageSampler(JCSRTopo(edge_index=edge_r), sizes=[4, 4], mode="TPU", seed=0),
        probes, hot, margin=1.3)
    sampler = GraphSageSampler(CSRTopo(edge_index=edge_r), [4, 4], device="cpu", seed=0)
    got = calibrate_cold_budget(sampler, probes, hot, margin=1.3)
    assert isinstance(got, float) and got == want and 0 < got <= 1.0
    fresh = np.random.default_rng(1)
    for _ in range(4):
        ds = sampler.sample_dense(fresh.choice(n, 32, replace=False))
        n_id = ds.n_id[: int(ds.count)]
        assert float((n_id >= hot).double().mean()) <= got


@pytest.mark.parametrize("n", [8, 4])
def test_byte_models_with_host_terms_equal_jax(n):
    """gather_comm_bytes (grouped, hot/cold, both via, id and feature
    widths) and sampling_comm_bytes (both via, layouts, caps, the fused
    gathers) on (n, hosts=2) meshes equal the JAX package's."""
    jmesh = jtrain.make_mesh(n, hosts=2)
    mesh = local_meshes(n, hosts=2, device="cpu", timeout_s=TIMEOUT_S)[0]
    assert jmesh.shape == mesh.shape
    for width, dim in ((512, 32), (1000, 100)):
        for kw in ({}, dict(cold_budget=256), dict(via="psum"), dict(id_bytes=8, feat_bytes=2),
                   dict(cold_budget=128, via="psum")):
            got, want = gather_comm_bytes(mesh, width, dim, **kw), jtop.gather_comm_bytes(
                jmesh, width, dim, **kw)
            assert got == want and got["dcn_bytes"] > 0, kw
    for layout in ("flat", "tiled"):
        for caps in (None, (40, None)):
            for fd in (0, 32):
                for via in ("scatter", "psum"):
                    kw = dict(feature_dim=fd, caps=caps, layout=layout, via=via)
                    assert (sampling_comm_bytes(mesh, SIZES, 8, **kw)
                            == jtop.sampling_comm_bytes(jmesh, SIZES, 8, **kw)), kw


# -- the train steps ---------------------------------------------------------------

def _flax_params(jt, feat_dim, fused):
    """flax GraphSAGE(hidden 16, 4 classes, 2 layers) weights from key(1),
    initialised on a sample of the graph (tests/test_hot_cold.py:149)."""
    jmodel = JGraphSAGE(hidden_dim=HIDDEN, out_dim=4, num_layers=2, dropout=0.0)
    ip, ix = (jnp.asarray(np.asarray(a).astype(np.int32)) for a in (jt.indptr, jt.indices))
    ds0 = (j_dense_fused if fused else j_dense_pure)(ip, ix, jax.random.key(0),
                                                     jnp.arange(8, dtype=jnp.int32), SIZES)
    x0 = jnp.zeros((ds0.n_id.shape[0], feat_dim), jnp.float32)
    return jmodel, jmodel.init(jax.random.key(1), x0, ds0.adjs)


def _case(pipeline):
    """tests/test_hot_cold.py's community graph, heat-ordered."""
    from test_e2e import make_community_graph

    edge_index, feat, labels, n = make_community_graph(per_comm=40)
    edge_r, feat_r, labels_r, _, _, _ = heat_reorder(edge_index, n, feat, labels)
    jt = JCSRTopo(edge_index=edge_r)
    jmodel, jparams = _flax_params(jt, feat.shape[1], pipeline == "fused")
    return dict(feat=feat_r.astype(np.float32), labels=labels_r.astype(np.int32), n=n, jt=jt,
                tt=CSRTopo(edge_index=edge_r), jmodel=jmodel, jparams=jparams,
                hot_rows=n // 4)


def _jax_step(case, topology, pipeline, hot_cold, seeds, key):
    jmesh = _jmesh()
    tx = optax.adam(LR)
    params = jtrain.replicate(jmesh, case["jparams"])
    opt_state = jax.device_put(tx.init(params), NamedSharding(jmesh, P()))
    kw = dict(hot_rows=case["hot_rows"], cold_budget=0.5) if hot_cold else {}
    feat = (jtrain.shard_feature_hot_cold(jmesh, case["feat"], case["hot_rows"]) if hot_cold
            else jtrain.shard_feature_rows(jmesh, case["feat"]))
    labels = jtrain.replicate(jmesh, case["labels"])
    seeds = jax.device_put(seeds, NamedSharding(jmesh, P(("host", "dp"))))
    if topology == "replicated":
        step = jtrain.make_sharded_train_step(jmesh, case["jmodel"], tx, sizes=SIZES,
                                              pipeline=pipeline, **kw)
        graph = tuple(jtrain.replicate(jmesh, np.asarray(a).astype(np.int32))
                      for a in (case["jt"].indptr, case["jt"].indices))
    else:
        step = jtrain.make_sharded_topo_train_step(jmesh, case["jmodel"], tx, sizes=SIZES,
                                                   pipeline=pipeline, layout=topology, **kw)
        graph = (jtop.shard_topology_rows(jmesh, case["jt"], layout=topology),)
    out = step(params, opt_state, key, *graph, feat, labels, seeds)
    overflow = int(out[3]) if hot_cold else None
    return float(out[2]), sage_params_from_flax(jax.tree_util.tree_map(np.asarray, out[0])), \
        overflow


def _port_steps(case, topology, pipeline, hot_cold, batches, keys, cold_budget=0.5):
    """Run one step a batch on every rank of host 2 x dp 2 x ici 2; returns
    each rank's (losses, overflows, state_dict)."""
    def rank(m):
        model = GraphSAGE(case["feat"].shape[1], HIDDEN, 4, num_layers=2, dropout=0.0)
        model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                           case["jparams"])))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        kw = dict(hot_rows=case["hot_rows"], cold_budget=cold_budget) if hot_cold else {}
        feat = (shard_feature_hot_cold(m, case["feat"], case["hot_rows"]) if hot_cold
                else shard_feature_rows(m, case["feat"]))
        labels = torch.from_numpy(case["labels"])
        if topology == "replicated":
            step = make_sharded_train_step(m, model, opt, SIZES, pipeline=pipeline, **kw)
            graph = tuple(torch.from_numpy(np.asarray(a).astype(np.int32))
                          for a in (case["tt"].indptr, case["tt"].indices))
        else:
            step = make_sharded_topo_train_step(m, model, opt, SIZES, pipeline=pipeline,
                                                layout=topology, **kw)
            graph = (shard_topology_rows(m, case["tt"], layout=topology),)
        losses, overflows = [], []
        for seeds, key in zip(batches, keys):
            out = step(key, *graph, feat, labels, torch.from_numpy(seeds))
            loss, over = out if hot_cold else (out, None)
            losses.append(float(loss))
            overflows.append(None if over is None else int(over))
        return losses, overflows, {k: v.detach().clone() for k, v in model.state_dict().items()}

    return run_ranks(rank, _meshes())


HOST_STEP_CASES = [("replicated", "dedup", False), ("tiled", "fused", False),
                   ("replicated", "dedup", True), ("flat", "dedup", True)]


@pytest.mark.parametrize("topology,pipeline,hot_cold", HOST_STEP_CASES)
def test_one_host_step_matches_the_jax_step(topology, pipeline, hot_cold):
    """One step on host 2 x dp 2 x ici 2 of the four host layouts —
    replicated dedup, sharded tiled fused, hot/cold replicated dedup and
    hot/cold sharded flat (a cold budget of half of each gather) — from
    flax's weights (dropout 0): the mean loss over the 4 data groups within
    1e-5, every updated parameter within 1e-5 of the JAX step on 8 virtual
    devices, the overflow equal; every rank's parameters bit-equal."""
    case = _case(pipeline)
    seeds = np.random.default_rng(5).choice(case["n"], 32, replace=False).astype(np.int32)
    want_loss, want, want_over = _jax_step(case, topology, pipeline, hot_cold, seeds,
                                           jax.random.key(3))
    results = _port_steps(case, topology, pipeline, hot_cold, [seeds], [qrandom.key(3)])
    ([loss0], [over0], params0) = results[0]
    np.testing.assert_allclose(loss0, want_loss, atol=1e-5, rtol=0)
    assert over0 == want_over
    assert sorted(params0) == sorted(want)
    for name in want:
        np.testing.assert_allclose(params0[name].numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    for losses, overs, params in results[1:]:
        assert losses == [loss0] and overs == [over0]
        assert all(torch.equal(p, params0[k]) for k, p in params.items())


def test_hot_cold_train_step_learns():
    """30 hot/cold steps of batch 8 a data group on the heat-ordered
    community graph, the graph row-sharded (tiled) and a generous budget, as
    tests/test_hot_cold.py:149 and :216: no overflow, the loss falls below
    0.7 of its first value, the replicas stay bit-equal."""
    case = _case("dedup")
    rng = np.random.default_rng(3)
    batches = [rng.choice(case["n"], 32, replace=False).astype(np.int32) for _ in range(30)]
    results = _port_steps(case, "tiled", "dedup", True, batches,
                          [qrandom.key(i) for i in range(30)], cold_budget=1.0)
    losses, overs, params0 = results[0]
    assert set(overs) == {0} and losses[-1] < losses[0] * 0.7, losses
    for other, _, params in results[1:]:
        assert other == losses and all(torch.equal(p, params0[k]) for k, p in params.items())


def test_products_multichip_example_learns_with_hosts_on_cpu():
    """The example with --hosts 2 --hot-frac 0.25 on 8 rank threads (host 2
    x dp 2 x ici 2) at a small size (4 classes), the graph row-sharded and
    the fused pipeline: it calibrates a cold budget, trains with no
    overflow, and its test accuracy is far above chance (0.25)."""
    from quiver_tpu_torch.examples import products_multichip

    res = products_multichip.main(["--device", "cpu", "--devices", "8", "--hosts", "2",
                                   "--hot-frac", "0.25", "--nodes", "2000", "--dim", "16",
                                   "--hidden", "32", "--classes", "4", "--sizes", "5,5",
                                   "--epochs", "4", "--steps-per-epoch", "8",
                                   "--batch-per-dp", "32", "--topology", "sharded",
                                   "--pipeline", "fused"])
    assert np.isfinite(res["loss"]) and res["test_acc"] > 0.5, res
    assert res["cold_overflow"] == 0 and 0 < res["cold_budget"] <= 1.0, res


# -- collectives and error contracts -----------------------------------------------------

def test_every_collective_goes_through_the_wrappers(monkeypatch):
    """A hot/cold sharded step's exchanges all go through the module-level
    wrappers of parallel.collectives (chip_smoke.py's collective clock
    patches them): the host all-gathers of ids and frontiers, the
    all-to-alls of the grouped gathers and draws, the ici and data-group
    sums and the overflow's max; with the wrappers in place the step gives
    the same parameters. No other module of the port calls a process group
    itself."""
    case = _case("dedup")
    seeds = np.random.default_rng(5).choice(case["n"], 32, replace=False).astype(np.int32)
    plain = _port_steps(case, "flat", "dedup", True, [seeds], [qrandom.key(3)])
    seen = {name: 0 for name in collectives.COLLECTIVES}
    for name in collectives.COLLECTIVES:
        orig = getattr(collectives, name)

        def counted(t, group, _orig=orig, _name=name):
            seen[_name] += 1
            return _orig(t, group)

        monkeypatch.setattr(collectives, name, counted)
    counted_run = _port_steps(case, "flat", "dedup", True, [seeds], [qrandom.key(3)])
    for (l0, o0, p0), (l1, o1, p1) in zip(plain, counted_run):
        assert l0 == l1 and o0 == o1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    # a rank: 2 hops x (2 all-gathers, 1 all-to-all and 1 ici sum of the
    # stacked neighbor and flag slab); 2 gathers x (1 ici sum hot, 1
    # all-gather + 1 all-to-all + 1 ici sum cold); 1 data sum; 1 max
    assert seen == {"allgather": 8 * (4 + 2), "all_to_all": 8 * (2 + 2),
                    "allreduce_sum": 8 * (2 + 4 + 1), "allreduce_max": 8}, seen
    root = Path(__file__).resolve().parent.parent / "quiver_tpu_torch"
    calls = re.compile(r"(?<!collectives)\.(allreduce|_allgather_base|allgather|alltoall_base|"
                       r"alltoall|reduce_scatter|_reduce_scatter_base|broadcast)\(")
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py") if calls.search(
        p.read_text()))
    assert users == ["parallel/collectives.py"], users


def test_host_axis_validation_errors_match_jax():
    """tests/test_hot_cold.py:196 and tests/test_parallel.py:245: hot/cold
    without a host axis, hot_rows without cold_budget and a hot/cold
    placement on a mesh without hosts raise the JAX package's errors; as do
    a budget wider than the gather, an unknown via and int64 ids."""
    flat = local_meshes(8, device="cpu", timeout_s=TIMEOUT_S)[0]
    host = _meshes()[0]
    for fn in (make_sharded_train_step, make_sharded_topo_train_step):
        with pytest.raises(ValueError, match="multi-host"):
            fn(flat, None, None, [4], hot_rows=8, cold_budget=4)
        with pytest.raises(ValueError, match="cold_budget missing"):
            fn(host, None, None, [4], hot_rows=8)
    with pytest.raises(ValueError, match="multi-host"):
        jtrain.shard_feature_hot_cold(jtrain.make_mesh(8), np.zeros((10, 2), np.float32), 4)
    with pytest.raises(ValueError, match="multi-host"):
        shard_feature_hot_cold(flat, np.zeros((10, 2), np.float32), 4)
    with pytest.raises(ValueError, match="out of range"):
        shard_feature_hot_cold(host, np.zeros((10, 2), np.float32), 10)
    block = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="exceeds gather width"):
        sharded_gather_hot_cold(block, block, torch.zeros(8, dtype=torch.int32), host,
                                ("host", "ici"), "host", 4, 9)
    with pytest.raises(ValueError, match="unknown via"):
        sharded_gather_grouped(block, torch.zeros(3, dtype=torch.int32), host, ("host", "ici"),
                               via="ring")
    with pytest.raises(TypeError, match="int32 ids"):
        sharded_gather_grouped(block, torch.zeros(3, dtype=torch.int64), host, ("host", "ici"))
    with pytest.raises(ValueError, match="non-group striping axis"):
        sharded_gather_hot_cold(block, block, torch.zeros(8, dtype=torch.int32), host,
                                ("host",), "host", 4, 2)


def test_host_rank_threads_under_fast_thread_switching():
    """Eight rank threads (host 2 x dp 2 x ici 2), more than this box's
    cores, with the interpreter switching threads every microsecond: twenty
    grouped gathers of each data group's own ids and a max over the data
    group of each rank's flat rank, all exact on every rank (a lost or
    crossed collective would break them)."""
    import sys

    meshes = _meshes()
    rng = np.random.default_rng(9)
    table = rng.standard_normal((101, 3)).astype(np.float32)
    idss = [rng.integers(-2, 104, (4, 30)).astype(np.int32) for _ in range(20)]

    def rank(m):
        block = shard_feature_rows(m, table)
        rows = [sharded_gather_grouped(block, torch.from_numpy(ids[_group(m)]), m,
                                       ("host", "ici")) for ids in idss]
        top = collectives.allreduce_max(torch.tensor([m.rank], dtype=torch.int32),
                                        m.group(("host", "dp")))
        return rows, int(top)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = run_ranks(rank, meshes, timeout_s=120)
    finally:
        sys.setswitchinterval(old)
    for m, (rows, top) in zip(meshes, results):
        assert top == 6 + m.ici_idx  # the data group's largest rank: host 1, dp 1
        for ids, got in zip(idss, rows):
            mine = ids[_group(m)]
            ok = (mine >= 0) & (mine < 101)
            assert np.array_equal(got.numpy()[ok], table[mine[ok]]) and not got.numpy()[~ok].any()

"""The port's graph lifecycle (quiver_tpu_torch.lifecycle and the stream
and engine operations it drives: deletions, sliding-window expiry,
compaction, reserve provisioning) against quiver_tpu's, at the tiny
shapes of tests/test_lifecycle.py (200 nodes, 1,400 edges, timestamps
uniform in [0, 50), DIM 12, sizes [3, 3], max_deg 128, sampler seed 5).

Bars. The policies' decisions equal the JAX package's. Inside the port,
bit for bit: a deletion against a stream that never had the edge and
against a table built over the updated graph; expiry at a cutoff against
the unexpired stream queried through the ``cutoff < ts`` band; draws
before and after a compaction (planned with relocations, and planned
before a commit that makes it stale); a provisioned stream against a
table built over its graph; serving with and without compaction at
max_in_flight 1 and 2, with a pass racing an in-flight flush. Through
both packages' temporal engines (retention at each commit and off the
commit path, an automatic provisioning retried once): dispatch logs,
epoch stamps and counters equal, rows within atol = rtol = 1e-5."""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import lifecycle as jlifecycle
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import ServeConfig as JServeConfig
from quiver_tpu.stream import GraphDelta as JGraphDelta
from quiver_tpu.stream import StreamingTiledGraph as JStreamingTiledGraph
from quiver_tpu.workloads import TemporalServeEngine as JTemporalServeEngine
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, ServeConfig, ServeEngine
from quiver_tpu_torch import lifecycle
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch import sage_params_from_flax
from quiver_tpu_torch.lifecycle import (
    CompactionPolicy,
    ProvisionPolicy,
    RetentionPolicy,
    retention_cutoff,
)
from quiver_tpu_torch.ops.sample import tiled_sample_layer, tiled_temporal_sample_layer
from quiver_tpu_torch.stream import GraphDelta, StreamCapacityError, StreamingTiledGraph
from quiver_tpu_torch.workloads import TemporalServeEngine, TemporalTiledGraph

from conftest import make_random_graph
from torch_fixtures import DispatchGate

torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, MAXD = 200, 12, [3, 3], 5, 128
TOL = dict(atol=1e-5, rtol=1e-5)
EDGE_INDEX = make_random_graph(N_NODES, 1400, seed=0)
TOPO = CSRTopo(edge_index=EDGE_INDEX)
BASE_TS = np.random.default_rng(11).uniform(0.0, 50.0, TOPO.edge_count).astype(np.float32)


def make_topo():
    return CSRTopo(edge_index=EDGE_INDEX)


def make_temporal_stream(**kw):
    kw.setdefault("reserve_frac", 0.5)
    return StreamingTiledGraph(make_topo(), edge_ts=BASE_TS.copy(), device="cpu", **kw)


@pytest.fixture(scope="module")
def setup():
    feat = np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    js = JSampler(JCSRTopo(edge_index=EDGE_INDEX), sizes=SIZES, mode="TPU", seed=SEED,
                  dedup=False, max_deg=MAXD)
    ds0 = js.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return dict(feat=feat, jmodel=jmodel, params=params, tparams=tparams)


def _model():
    return GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)


def make_engine(s, stream, **cfg):
    cfg = dict(dict(max_batch=8, buckets=(8,), max_delay_ms=1e9, record_dispatches=True), **cfg)
    sampler = GraphSageSampler(make_topo(), SIZES, seed=SEED, device="cpu", dedup=False,
                               max_deg=MAXD).bind_temporal(stream, recency=0.02)
    return TemporalServeEngine(_model(), s["tparams"], sampler, s["feat"], ServeConfig(**cfg),
                               t_quantum=4.0)


def make_jengine(s, reserve_kw, **cfg):
    cfg = dict(dict(max_batch=8, buckets=(8,), max_delay_ms=1e9, record_dispatches=True), **cfg)
    jt = JCSRTopo(edge_index=EDGE_INDEX)
    stream = JStreamingTiledGraph(jt, edge_ts=BASE_TS.copy(), **reserve_kw)
    sampler = JSampler(jt, sizes=SIZES, mode="TPU", seed=SEED, dedup=False,
                       max_deg=MAXD).bind_temporal(stream, recency=0.02)
    return JTemporalServeEngine(s["jmodel"], s["params"], sampler, s["feat"],
                                JServeConfig(**cfg), t_quantum=4.0)


def temporal_draws(triple, seeds, t, k=4, seed=99, cutoff=None):
    """One temporal hop as numpy, ids zeroed outside the valid lanes."""
    bd, tiles, tt = triple
    B = len(seeds)
    nb, vl = tiled_temporal_sample_layer(
        bd, tiles, tt, torch.as_tensor(np.asarray(seeds), dtype=torch.int32),
        torch.ones(B, dtype=torch.bool), k, qrandom.key(seed),
        torch.full((B,), float(t), dtype=torch.float32), max_deg=MAXD, recency=0.02,
        cutoff=cutoff)
    nb, vl = nb.numpy(), vl.numpy()
    return np.where(vl, nb, 0), vl


def uniform_draws(pair, seed=3):
    seeds = torch.arange(48, dtype=torch.int32) % N_NODES
    nb, vl = tiled_sample_layer(*pair, seeds, torch.ones(48, dtype=torch.bool), 4,
                                qrandom.key(seed))
    return torch.where(vl, nb, 0).numpy(), vl.numpy()


# -- the policies ----------------------------------------------------------------

def test_policies_match_reference():
    for args in ((80.0, 30.0), (3e7 + 1.0, 1.0), (77.7, 30.3)):
        assert retention_cutoff(*args) == jlifecycle.retention_cutoff(*args)
    p, jp = RetentionPolicy(window=30.0), jlifecycle.RetentionPolicy(window=30.0)
    for t in (None, 80.0, "mark", 79.0, 80.0, 90.0, "mark", 95.0, 121.0):
        if t == "mark":
            p.mark_expired(p.cutoff_for())
            jp.mark_expired(jp.cutoff_for())
            continue
        assert p.cutoff_for(t) == jp.cutoff_for(t)
        assert p.state() == jp.state()
    with pytest.raises(ValueError):
        RetentionPolicy(window=0.0)
    for report in ({"reclaimable_tiles": 7, "reserve_free": 3},
                   {"reclaimable_tiles": 8, "reserve_free": 4}, {}):
        assert (CompactionPolicy(min_reclaimable=8).should_compact(report)
                == jlifecycle.CompactionPolicy(min_reclaimable=8).should_compact(report))
        assert (ProvisionPolicy(64, min_free_tiles=4).should_provision(report)
                == jlifecycle.ProvisionPolicy(64, min_free_tiles=4).should_provision(report))
    with pytest.raises(ValueError):
        ProvisionPolicy(bank_tiles=0)
    assert lifecycle.__all__ == sorted(jlifecycle.__all__)


# -- deletion, expiry, compaction, provisioning (draw grain) ----------------------

def test_delete_then_replay_equals_never_added():
    a = StreamingTiledGraph(make_topo(), reserve_frac=0.5, device="cpu")
    a.apply(GraphDelta([3, 3, 3, 9], [60, 61, 62, 11]))
    rm = GraphDelta()
    rm.remove_edge(3, 61)
    assert a.apply(rm)["edges_deleted"] == 1
    b = StreamingTiledGraph(make_topo(), reserve_frac=0.5, device="cpu")
    b.apply(GraphDelta([3, 3, 9], [60, 62, 11]))
    for x, y in zip(uniform_draws(a.graph()), uniform_draws(b.graph())):
        assert np.array_equal(x, y)
    assert a.neighbors(3).tolist() == b.neighbors(3).tolist()
    u = int(np.argmax(TOPO.degree))
    rm2 = GraphDelta()
    rm2.remove_edge(u, int(TOPO.indices[TOPO.indptr[u]]))
    a.apply(rm2)
    rebuilt = a.to_csr_topo().to_device_tiled("cpu")
    for x, y in zip(uniform_draws(a.graph()), uniform_draws(rebuilt)):
        assert np.array_equal(x, y)


def test_retention_expiry_equals_the_band_mask():
    t_commit, W = np.float32(77.7), np.float32(30.3)
    cut = retention_cutoff(t_commit, W)
    rng = np.random.default_rng(21)
    d = GraphDelta(rng.integers(0, N_NODES, 64), rng.integers(0, N_NODES, 64),
                   ts=rng.uniform(40.0, 77.0, 64).astype(np.float32))
    frozen, live = make_temporal_stream(), make_temporal_stream()
    frozen.apply(d)
    live.apply(d)
    exp = live.expire_edges(cut)
    assert exp["edges_expired"] > 0 and exp["nodes"] > 0
    seeds = rng.integers(0, N_NODES, 64)
    for key_seed in (0, 7):
        le = temporal_draws(live.temporal_graph(), seeds, t_commit, seed=key_seed)
        fr = temporal_draws(frozen.temporal_graph(), seeds, t_commit, seed=key_seed,
                            cutoff=cut)
        assert np.array_equal(le[0], fr[0]) and np.array_equal(le[1], fr[1])


def test_dead_lanes_are_reused_in_place():
    stream = make_temporal_stream()
    u = int(np.argmax(TOPO.degree))
    deg0 = stream.degree(u)
    assert stream.expire_edges(np.float32(60.0))["edges_expired"] > 0
    rep = stream.reserve_report()
    assert rep["dead_lane_frac"] > 0
    free0 = stream.free_rows
    n = min(deg0, 8)
    out = stream.apply(GraphDelta(np.full(n, u), (u + 1 + np.arange(n)) % N_NODES,
                                  ts=61.0 + np.arange(n, dtype=np.float32)))
    assert out["lanes_reused"] == n and stream.free_rows == free0
    assert stream.degree(u) == deg0
    assert stream.reserve_report()["dead_lane_frac"] < rep["dead_lane_frac"]


@pytest.mark.parametrize("max_moves", [0, 4])
def test_compaction_reclaims_and_changes_no_draw(max_moves):
    stream = make_temporal_stream(reserve_frac=2.0)
    rng = np.random.default_rng(6)
    d = GraphDelta(np.full(300, 7), rng.integers(0, N_NODES, 300),
                   ts=np.linspace(60, 90, 300).astype(np.float32))
    stream.apply(d)
    sel = np.arange(0, 300, 2)
    rm = GraphDelta()
    rm.remove_edges(np.full(sel.size, 7), d.edges()[1][sel])
    stream.apply(rm)
    rep0 = stream.reserve_report()
    assert rep0["reclaimable_tiles"] > 0 and rep0["fragmented_lanes"] > 0
    seeds = rng.integers(0, N_NODES, 48)
    before = temporal_draws(stream.temporal_graph(), seeds, 95.0)
    free0, ver0 = stream.free_rows, stream.version
    out = stream.apply_compaction(stream.plan_compaction(max_moves=max_moves))
    assert out["tiles_reclaimed"] > 0 and stream.free_rows > free0 and stream.version == ver0
    after = temporal_draws(stream.temporal_graph(), seeds, 95.0)
    assert np.array_equal(before[0], after[0]) and np.array_equal(before[1], after[1])
    assert stream.reserve_report()["reclaimable_tiles"] < rep0["reclaimable_tiles"]
    assert stream.compact()["tiles_reclaimed"] == 0


def test_stale_compaction_plan_is_skipped():
    stream = make_temporal_stream(reserve_frac=2.0)
    rng = np.random.default_rng(6)
    d = GraphDelta(np.full(200, 7), rng.integers(0, N_NODES, 200),
                   ts=np.full(200, 60.0, np.float32))
    stream.apply(d)
    rm = GraphDelta()
    rm.remove_edges(np.full(150, 7), d.edges()[1][:150])
    stream.apply(rm)
    plan = stream.plan_compaction(max_moves=2)
    assert plan["trims"] or plan["moves"]
    stream.apply(GraphDelta(np.full(130, 7), rng.integers(0, N_NODES, 130),
                            ts=np.full(130, 61.0, np.float32)))
    seeds = rng.integers(0, N_NODES, 48)
    before = temporal_draws(stream.temporal_graph(), seeds, 95.0)
    stream.apply_compaction(plan)
    after = temporal_draws(stream.temporal_graph(), seeds, 95.0)
    assert np.array_equal(before[0], after[0]) and np.array_equal(before[1], after[1])


def test_provisioning_grows_the_bank_and_keeps_draws():
    stream = make_temporal_stream(reserve_tiles=2)
    big = GraphDelta(np.full(384, 9), (10 + np.arange(384)) % N_NODES,
                     ts=np.full(384, 61.0, np.float32))
    with pytest.raises(StreamCapacityError, match="provision_reserve"):
        stream.apply(big)
    assert stream.degree(9) == int(TOPO.degree[9])  # refused whole
    shapes = [tuple(t.shape) for t in stream.temporal_graph()]
    assert stream.provision_reserve(8)["reserve_free"] >= 8
    assert [tuple(t.shape) for t in stream.temporal_graph()][1][0] == shapes[1][0] + 8
    stream.apply(big)
    assert stream.degree(9) == int(TOPO.degree[9]) + 384
    t2, ts2 = stream.adj.to_temporal()
    tg = TemporalTiledGraph(t2, ts2, device="cpu")
    seeds = np.arange(48) % N_NODES
    a = temporal_draws(stream.temporal_graph(), seeds, 95.0)
    b = temporal_draws(tg.temporal_graph(), seeds, 95.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# -- the engines ------------------------------------------------------------------

def _assert_same_logs(je, pe):
    assert len(je.dispatch_log) == len(pe.dispatch_log)
    for a, b in zip(je.dispatch_log, pe.dispatch_log):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    assert je.dispatch_graph_versions == pe.dispatch_graph_versions


def _retention_run(eng):
    rows = [eng.predict([3, 9], t=55.0)]
    eng.stage_edges([1, 2, 3, 3, 9], [4, 5, 60, 61, 62], ts=[60.0, 80.0, 56.0, 57.0, 58.0])
    first = eng.update_graph()
    eng.stage_removals([3], [61])
    eng.update_graph()
    none = eng.expire_edges()
    later = eng.expire_edges(200.0)
    rows.append(eng.predict([1, 3, 9, 61], t=100.0))
    return np.concatenate(rows), first, none, later


@pytest.mark.parametrize("fenced", [True, False])
def test_engine_retention_matches_reference(setup, fenced):
    je = make_jengine(setup, dict(reserve_frac=0.5), stream_retention_window=30.0,
                      fenced_commits=fenced)
    pe = make_engine(setup, make_temporal_stream(), stream_retention_window=30.0,
                     fenced_commits=fenced)
    jrows, jfirst, jnone, jlater = _retention_run(je)
    prows, pfirst, pnone, plater = _retention_run(pe)
    np.testing.assert_allclose(jrows, prows, **TOL)
    assert pfirst["edges_expired"] == jfirst["edges_expired"] > 0
    assert pfirst["retention_cutoff"] == jfirst["retention_cutoff"] == retention_cutoff(80, 30)
    assert pnone["edges_expired"] == jnone["edges_expired"] == 0
    assert plater["edges_expired"] == jlater["edges_expired"] > 0
    assert plater["cache_invalidated"] == jlater["cache_invalidated"]
    assert pe.graph_version == je.graph_version == 3
    for name in ("edges_deleted", "edges_expired", "delta_cache_invalidated", "graph_deltas"):
        assert getattr(pe.stats, name) == getattr(je.stats, name), name
    _assert_same_logs(je, pe)


@pytest.mark.parametrize("mif", [1, 2])
def test_engine_compaction_changes_no_served_row(setup, mif):
    def run(compact):
        eng = make_engine(setup, make_temporal_stream(reserve_frac=2.0), max_in_flight=mif,
                          stream_compact_min_reclaim=1)
        rows = []
        rng = np.random.default_rng(13)
        for step in range(3):
            d = GraphDelta(np.full(150, 7 + step), rng.integers(0, N_NODES, 150),
                           ts=np.full(150, 60.0 + step, np.float32))
            eng.update_graph(d)
            rm = GraphDelta()
            rm.remove_edges(np.full(100, 7 + step), d.edges()[1][:100])
            eng.update_graph(rm)
            if compact:
                assert eng.compact_graph(max_moves=2)["tiles_reclaimed"] >= 0
            rows.append(eng.predict([7 + step, 3, 9, 11], t=70.0 + step))
        return np.concatenate(rows), eng

    (rows_off, eng_off), (rows_on, eng_on) = run(False), run(True)
    assert np.array_equal(rows_off, rows_on)
    assert eng_on.stats.compactions == 3 and eng_on.stats.tiles_reclaimed > 0
    _assert_same_logs(eng_off, eng_on)


@pytest.mark.parametrize("fenced", [True, False])
def test_compaction_racing_an_inflight_flush(setup, fenced):
    """A compaction while a flush sits in its dispatch stage (drained
    first when fenced, flipped beside it when zero-stall) leaves the
    served row as a race-free run serves it."""
    def run(race):
        stream = StreamingTiledGraph(make_topo(), reserve_frac=2.0, device="cpu")
        eng = ServeEngine(_model(), setup["tparams"],
                          GraphSageSampler(make_topo(), SIZES, seed=SEED,
                                           device="cpu").bind_stream(stream),
                          setup["feat"],
                          ServeConfig(max_batch=4, buckets=(4,), max_delay_ms=1e9,
                                      max_in_flight=2, record_dispatches=True,
                                      fenced_commits=fenced))
        eng.warmup()
        rng = np.random.default_rng(3)
        d = GraphDelta(np.full(300, 7), rng.integers(0, N_NODES, 300))
        eng.update_graph(d)
        rm = GraphDelta()
        rm.remove_edges(np.full(200, 7), d.edges()[1][:200])
        eng.update_graph(rm)
        if not race:
            row = eng.predict([7])[0]
            eng.compact_graph()
            return row
        gate = DispatchGate(eng)
        h = eng.submit(7)
        t_fl = threading.Thread(target=eng.flush)
        t_fl.start()
        gate.wait_arrived(1)
        out = {}
        t_c = threading.Thread(target=lambda: out.update(eng.compact_graph()))
        t_c.start()
        if not fenced:
            t_c.join(30)  # the zero-stall flip does not wait for the flush
            assert out["tiles_reclaimed"] > 0
        gate.open()
        t_fl.join(30)
        t_c.join(30)
        assert out["tiles_reclaimed"] > 0
        return h.result(60)

    assert np.array_equal(run(True), run(False))


def test_engine_provisions_once_and_retries(setup):
    big = np.full(384, 9), (10 + np.arange(384)) % N_NODES, np.full(384, 61.0, np.float32)
    je = make_jengine(setup, dict(reserve_tiles=2), stream_provision_tiles=64)
    stream = make_temporal_stream(reserve_tiles=2)
    pe = make_engine(setup, stream, stream_provision_tiles=64)
    je.warmup()
    pe.warmup()
    cap0 = stream.m_cap
    jout, pout = je.update_graph(JGraphDelta(*big[:2], ts=big[2])), \
        pe.update_graph(GraphDelta(*big[:2], ts=big[2]))
    assert pout["provisioned"] is jout["provisioned"] is True
    assert stream.m_cap == cap0 + 64 == je._sampler.stream.m_cap
    assert pe._programs.sealed and pe._programs.buckets == (8,)
    np.testing.assert_allclose(je.predict([9, 4], t=100.0), pe.predict([9, 4], t=100.0), **TOL)
    _assert_same_logs(je, pe)
    bare = make_engine(setup, make_temporal_stream(reserve_tiles=2))
    with pytest.raises(StreamCapacityError):
        bare.update_graph(GraphDelta(*big[:2], ts=big[2]))
    assert bare.graph_version == 0

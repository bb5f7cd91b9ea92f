"""The port's streaming graphs (quiver_tpu_torch.stream, the stream half of
the serve engine, the cache's graph-version floors, `delta_interleaved_
trace`) against quiver_tpu's, at the tiny shapes of tests/test_stream.py
and tests/test_zerostall_commits.py (200 nodes, 1,200 edges, DIM 16,
sizes [4, 4], sampler seed 3).

Bars. Bit-equal to the JAX package: `GraphDelta` staging, the trace, the
adjacency's closures and materialized graphs, and a `StreamingTiledGraph`
driven through one change sequence (appends that spill, removals,
timestamp updates, installs, expiry, compaction with moves, provisioning,
a refused batch): host mirrors, device arrays, the free ranges,
`reserve_report`, `stats`, `node_version` and every commit's summary.
Served through both packages' engines under one `delta_interleaved_trace`
(node) or timestamped commits with a retention window (temporal), at
max_in_flight 1 and 2, fenced and zero-stall: dispatch logs, epoch stamps
(``dispatch_graph_versions``) and cache-invalidation counts equal, rows
within atol = rtol = 1e-5 (XLA-CPU and torch-CPU sum in other orders).
Inside the port, bit for bit: draws from the streamed arrays against a
table built over the updated graph, the fenced twin against the
zero-stall one, a flush held between assemble and seal against a twin
that never saw the commit, and `BucketPrograms` replaying a binding
sealed before a commit against that commit's epoch."""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import EmbeddingCache as JEmbeddingCache
from quiver_tpu.serve import ServeConfig as JServeConfig
from quiver_tpu.serve import ServeEngine as JServeEngine
from quiver_tpu.serve import delta_interleaved_trace as j_delta_trace
from quiver_tpu.stream import GraphDelta as JGraphDelta
from quiver_tpu.stream import StreamCapacityError as JStreamCapacityError
from quiver_tpu.stream import StreamingAdjacency as JStreamingAdjacency
from quiver_tpu.stream import StreamingTiledGraph as JStreamingTiledGraph
from quiver_tpu.workloads import TemporalServeEngine as JTemporalServeEngine
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, ServeConfig, ServeEngine
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch import sage_params_from_flax
from quiver_tpu_torch.inference import BucketPrograms, bind_params
from quiver_tpu_torch.ops.sample import tiled_sample_layer
from quiver_tpu_torch.serve import EmbeddingCache, delta_interleaved_trace
from quiver_tpu_torch.stream import (
    GraphDelta,
    StreamCapacityError,
    StreamingAdjacency,
    StreamingTiledGraph,
)
from quiver_tpu_torch.workloads import TemporalServeEngine

from conftest import make_random_graph

torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED = 200, 16, [4, 4], 3
TOL = dict(atol=1e-5, rtol=1e-5)
EDGE_INDEX = make_random_graph(N_NODES, 1200, seed=0)
BASE_TS = np.random.default_rng(7).uniform(0.0, 50.0, EDGE_INDEX.shape[1]).astype(np.float32)


def topos():
    return JCSRTopo(edge_index=EDGE_INDEX), CSRTopo(edge_index=EDGE_INDEX)


@pytest.fixture(scope="module")
def setup():
    feat = np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    js = JSampler(topos()[0], sizes=SIZES, mode="TPU", seed=SEED)
    ds0 = js.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return dict(feat=feat, jmodel=jmodel, params=params, tparams=tparams)


def _model():
    return GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)


def _deltas(delta_cls, ops):
    """One GraphDelta a step of ``ops``: ``(kind, src, dst, ts)`` tuples."""
    d = delta_cls()
    for kind, src, dst, ts in ops:
        if kind == "add":
            d.add_edges(src, dst, ts=ts)
        elif kind == "remove":
            d.remove_edges(src, dst)
        else:
            d.update_edges(src, dst, ts)
    return d


# -- deltas, traces, the adjacency --------------------------------------------

def test_graph_delta_matches_reference():
    ops = [("add", [1, 2, 3], [4, 5, 6], [1.0, 2.0, 3.0]), ("remove", [2], [5], None),
           ("update", [1, 7], [4, 8], [9.5, 0.25]), ("add", [9], [10], [4.0])]
    jd, td = _deltas(JGraphDelta, ops), _deltas(GraphDelta, ops)
    for name in ("edges", "removals", "updates", "sources"):
        a, b = getattr(jd, name)(), getattr(td, name)()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(jd.edges_ts(), td.edges_ts())
    assert (len(jd), jd.max_ts()) == (len(td), td.max_ts())
    jd.extend(_deltas(JGraphDelta, ops[:1]))
    td.extend(_deltas(GraphDelta, ops[:1]))
    assert len(jd) == len(td) and np.array_equal(jd.edges()[0], td.edges()[0])
    with pytest.raises(ValueError, match="mixed timestamped"):
        td.add_edges([1], [2])
    with pytest.raises(ValueError, match="non-finite"):
        GraphDelta().update_edges([1], [2], [np.inf])
    td.clear()
    assert len(td) == 0 and td.max_ts() is None and td.edges_ts() is None


def test_delta_interleaved_trace_matches_reference():
    for kw in (dict(edge_every=8, edges_per_event=2), dict(alpha=0.6, seed=4)):
        a, b = j_delta_trace(N_NODES, 100, **kw), delta_interleaved_trace(N_NODES, 100, **kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert [(e[0], np.asarray(e[1]).tolist(), np.asarray(e[2]).tolist()) for e in a.events()] \
            == [(e[0], np.asarray(e[1]).tolist(), np.asarray(e[2]).tolist()) for e in b.events()]


@pytest.mark.parametrize("temporal", [False, True])
def test_adjacency_closures_and_rebuild_match_reference(temporal):
    jt, tt = topos()
    ts = BASE_TS if temporal else None
    ja = JStreamingAdjacency(jt, edge_ts=ts)
    ta = StreamingAdjacency(tt, edge_ts=ts, device="cpu")
    rng = np.random.default_rng(3)
    for a in (ja, ta):
        src, dst = rng.integers(0, N_NODES, 40), rng.integers(0, N_NODES, 40)
        a.add_edges(src, dst, ts=np.linspace(50, 60, 40).astype(np.float32) if temporal else None)
        for u, v in zip(src[:6], dst[:6]):
            a.remove_one(int(u), int(v))
        if temporal:
            a.update_one(int(src[10]), int(dst[10]), 55.5)
            a.expire_node(int(src[11]), 58.0)
            a.replace_at(int(src[11]), 0, 3, ts=59.0)
        rng = np.random.default_rng(3)
    for node in range(N_NODES):
        assert np.array_equal(ja.neighbors(node), ta.neighbors(node))
        assert ja.degree(node) == ta.degree(node)
    seeds = [0, 5, 17, 199]
    for hops in (0, 1, 2):
        assert np.array_equal(ja.forward_closure(seeds, hops), ta.forward_closure(seeds, hops))
        assert np.array_equal(ja.reverse_closure(seeds, hops), ta.reverse_closure(seeds, hops))
    jr, tr = ja.to_csr_topo(), ta.to_csr_topo()
    assert np.array_equal(jr.indptr, tr.indptr) and np.array_equal(jr.indices, tr.indices)
    if temporal:
        (_, jts), (_, tts) = ja.to_temporal(), ta.to_temporal()
        assert np.array_equal(jts, tts)


# -- StreamingTiledGraph through a lifecycle, bit for bit ----------------------

def _stream_state(st):
    """Everything a StreamingTiledGraph holds, as numpy / plain values."""
    arrays = st.temporal_graph() if st.temporal else st.graph()
    dev = [np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a) for a in arrays]
    return dict(bd=st.bd.copy(), tiles=st.tiles.copy(),
                ttiles=None if st.ttiles is None else st.ttiles.copy(),
                alloc=st.alloc_rows.copy(), dev=dev, free=[list(r) for r in st._free_ranges],
                min_ts=None if st._min_ts is None else st._min_ts.copy(),
                dead={u: list(p) for u, p in st._dead.items()}, dead_lanes=st._dead_lanes,
                retired=list(st._retired), node_version=st.node_version.copy(),
                version=st.version, stats=dict(st.stats), report=st.reserve_report(),
                m_cap=st.m_cap)


def _assert_same_state(a, b):
    sa, sb = _stream_state(a), _stream_state(b)
    for k in ("bd", "tiles", "ttiles", "alloc", "node_version", "min_ts"):
        if sa[k] is None:
            assert sb[k] is None
            continue
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k
    assert len(sa["dev"]) == len(sb["dev"])
    for x, y in zip(sa["dev"], sb["dev"]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for k in ("free", "retired", "version", "stats", "report", "m_cap", "dead", "dead_lanes"):
        assert sa[k] == sb[k], k


def _same_summary(a, b):
    a, b = dict(a), dict(b)
    sa, sb = a.pop("sources", None), b.pop("sources", None)
    assert a == b
    if sa is not None:
        assert np.array_equal(sa, sb)


@pytest.mark.parametrize("temporal", [False, True])
def test_stream_state_bit_equal_through_lifecycle(temporal):
    jt, tt = topos()
    ts = BASE_TS.copy() if temporal else None
    js = JStreamingTiledGraph(jt, reserve_tiles=24, edge_ts=ts)
    ps = StreamingTiledGraph(tt, reserve_tiles=24, edge_ts=ts, device="cpu")
    _assert_same_state(js, ps)
    rng = np.random.default_rng(5)
    hub = int(np.argmax(tt.degree))
    zero = int(np.nonzero(tt.degree == 0)[0][0]) if (tt.degree == 0).any() else None

    def step(fn):
        _same_summary(fn(js, JGraphDelta), fn(ps, GraphDelta))
        _assert_same_state(js, ps)

    def stamps(n, lo):
        return np.linspace(lo, lo + 1, n).astype(np.float32) if temporal else None

    # pad-lane appends, then enough onto one node to spill twice
    src30, dst30 = rng.integers(0, N_NODES, 30), rng.integers(0, N_NODES, 30)
    step(lambda s, D: s.apply(D(src30, dst30, ts=stamps(30, 51))))
    big_dst = np.arange(300) % N_NODES
    step(lambda s, D: s.apply(D(np.full(300, 7), big_dst, ts=stamps(300, 52))))
    # removals (a base edge and appended ones) and timestamp updates
    u, v = hub, int(tt.indices[tt.indptr[hub]])
    ops = [("remove", [u, 7, 7], [v, 0, 1], None)]
    if temporal:
        ops.append(("update", [7, u], [2, int(tt.indices[tt.indptr[hub] + 1])], [57.0, 58.0]))
    step(lambda s, D: s.apply(_deltas(D, ops)))
    # an install on a degree-0 row
    if zero is not None:
        row = (zero, np.array([1, 2, 3]), np.array([60.0, 61.0, 62.0], np.float32)) \
            if temporal else (zero, np.array([1, 2, 3]))
        step(lambda s, D: s.install_rows([row]))
    if temporal:
        step(lambda s, D: s.expire_edges(30.0))
        # appends reuse the dead lanes of the hub
        step(lambda s, D: s.apply(D(np.full(5, u), np.arange(5), ts=stamps(5, 63))))
    # a batch the reserve cannot hold is refused, atomically, alike
    with pytest.raises(JStreamCapacityError):
        js.apply(JGraphDelta(np.full(2000, 9), np.arange(2000) % N_NODES, ts=stamps(2000, 70)))
    with pytest.raises(StreamCapacityError):
        ps.apply(GraphDelta(np.full(2000, 9), np.arange(2000) % N_NODES, ts=stamps(2000, 70)))
    _assert_same_state(js, ps)
    # compaction: plans equal, then applied with moves
    jp, pp = js.plan_compaction(max_moves=4), ps.plan_compaction(max_moves=4)
    assert jp == pp
    step(lambda s, D: s.apply_compaction(s.plan_compaction(max_moves=4)))
    step(lambda s, D: s.provision_reserve(200))
    step(lambda s, D: s.apply(D(np.full(2000, 9), np.arange(2000) % N_NODES,
                                ts=stamps(2000, 70))))
    delta = GraphDelta(np.array([1, 2]), np.array([3, 4]), ts=stamps(2, 80))
    jdelta = JGraphDelta(np.array([1, 2]), np.array([3, 4]), ts=stamps(2, 80))
    assert js.preflight(jdelta) == ps.preflight(delta)
    # a deferred commit leaves graph() alone until publish
    before = [t.clone() for t in ps.graph()]
    ps.apply(delta, defer_publish=True)
    js.apply(jdelta, defer_publish=True)
    assert all(torch.equal(a, b) for a, b in zip(before, ps.graph()))
    assert ps.publish() and js.publish() and not ps.publish()
    _assert_same_state(js, ps)
    # the reverse closure (a commit's invalidation set) agrees
    assert np.array_equal(js.affected_seeds([7, u], 1), ps.affected_seeds([7, u], 1))


def test_streamed_draws_equal_a_rebuilt_table():
    """Appends (pad lanes and spills) and deletions keep a row's lane
    order: a draw from the streamed arrays equals one from the tile table
    of `to_csr_topo`, on one key."""
    _, tt = topos()
    st = StreamingTiledGraph(tt, reserve_frac=1.0, device="cpu")
    st.apply(GraphDelta(np.r_[np.full(200, 11), [3, 3, 3]], np.r_[np.arange(200), [60, 61, 62]]))
    rm = GraphDelta()
    rm.remove_edges([3, 11], [61, 5])
    st.apply(rm)
    seeds = torch.arange(64, dtype=torch.int32) % N_NODES
    valid = torch.ones(64, dtype=torch.bool)
    rebuilt = st.to_csr_topo().to_device_tiled("cpu")
    for k, seed in ((4, 1), (40, 2)):
        key = qrandom.key(seed)
        a = tiled_sample_layer(*st.graph(), seeds, valid, k, key)
        b = tiled_sample_layer(*rebuilt, seeds, valid, k, key)
        assert torch.equal(a[1], b[1]) and torch.equal(torch.where(a[1], a[0], 0),
                                                       torch.where(b[1], b[0], 0))


def test_streaming_adjacency_takes_the_card_unless_cpu_is_asked(monkeypatch):
    """`StreamingAdjacency`, a public entry point, runs on the card by
    default: without one it raises the error that names device='cpu'."""
    _, tt = topos()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingAdjacency(tt)
    assert StreamingAdjacency(tt, device="cpu").device.type == "cpu"


def test_stream_copies_on_write_and_refuses_wrong_arity():
    _, tt = topos()
    st = StreamingTiledGraph(tt, reserve_frac=0.5, device="cpu")
    old = st.graph()
    snap = [t.clone() for t in old]
    st.apply(GraphDelta([1], [2]))
    assert all(torch.equal(a, b) for a, b in zip(old, snap))  # the old epoch is untouched
    assert not torch.equal(st.graph()[0], old[0])
    with pytest.raises(ValueError, match="non-temporal"):
        st.apply(GraphDelta([1], [2], ts=[1.0]))
    with pytest.raises(ValueError, match="temporal stream"):
        st.expire_edges(1.0)
    tst = StreamingTiledGraph(tt, reserve_frac=0.5, edge_ts=BASE_TS, device="cpu")
    with pytest.raises(ValueError, match="one timestamp"):
        tst.apply(GraphDelta([1], [2]))


# -- the engines: node traffic -------------------------------------------------

SCHEDULE_ARGS = dict(alpha=1.1, seed=21, edge_every=8, edges_per_event=2)


def _node_engines(s, mif, fenced):
    jt, tt = topos()
    js = JSampler(jt, sizes=SIZES, mode="TPU", seed=SEED)
    js.bind_stream(JStreamingTiledGraph(jt, reserve_frac=1.0))
    ps = GraphSageSampler(tt, SIZES, seed=SEED, device="cpu")
    ps.bind_stream(StreamingTiledGraph(tt, reserve_frac=1.0, device="cpu"))
    cfg = dict(max_batch=8, buckets=(8,), max_delay_ms=1e9, record_dispatches=True,
               max_in_flight=mif, fenced_commits=fenced)
    je = JServeEngine(s["jmodel"], s["params"], js, s["feat"], JServeConfig(**cfg))
    pe = ServeEngine(_model(), s["tparams"], ps, s["feat"], ServeConfig(**cfg))
    return je, pe


def _drive(eng, trace):
    """The schedule in order: commits as they come, each request flushed
    alone (its rows, the serve-time graph version)."""
    rows, vers = [], []
    for ev in trace.events():
        if ev[0] == "edges":
            eng.stage_edges(ev[1], ev[2])
            eng.update_graph()
        else:
            h = eng.submit(int(ev[2]))
            while eng._pending:
                eng.flush()
            rows.append(np.asarray(h.result(60)))
            vers.append(eng.graph_version)
    return rows, vers


def _assert_same_logs(je, pe):
    assert len(je.dispatch_log) == len(pe.dispatch_log)
    for a, b in zip(je.dispatch_log, pe.dispatch_log):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    assert je.dispatch_graph_versions == pe.dispatch_graph_versions
    assert len(pe.dispatch_graph_versions) == len(pe.dispatch_log)


@pytest.mark.parametrize("fenced", [True, False])
@pytest.mark.parametrize("mif", [1, 2])
def test_node_engine_commits_match_reference(setup, mif, fenced):
    je, pe = _node_engines(setup, mif, fenced)
    je.warmup()
    pe.warmup()
    jrows, jvers = _drive(je, j_delta_trace(N_NODES, 40, **SCHEDULE_ARGS))
    prows, pvers = _drive(pe, delta_interleaved_trace(N_NODES, 40, **SCHEDULE_ARGS))
    assert jvers == pvers and pe.graph_version == je.graph_version > 0
    for a, b in zip(jrows, prows):
        np.testing.assert_allclose(a, b, **TOL)
    _assert_same_logs(je, pe)
    for name in ("graph_deltas", "delta_edges", "delta_tile_writes", "delta_tile_spills",
                 "delta_cache_invalidated"):
        assert getattr(je.stats, name) == getattr(pe.stats, name), name
    assert je.cache.invalidations == pe.cache.invalidations
    assert je.cache.keys() == pe.cache.keys()  # the LRU order too
    assert pe.stats.commit_stall.snapshot()["count"] == pe.stats.graph_deltas
    _assert_same_state(je._sampler.stream, pe._sampler.stream)


@pytest.mark.parametrize("mif", [1, 2])
def test_fenced_and_zero_stall_serve_the_same_bits(setup, mif):
    trace = delta_interleaved_trace(N_NODES, 40, **SCHEDULE_ARGS)
    runs = []
    for fenced in (True, False):
        _, pe = _node_engines(setup, mif, fenced)
        pe.warmup()
        runs.append((pe, *_drive(pe, trace)))
    (fe, frows, fvers), (ze, zrows, zvers) = runs
    assert fvers == zvers
    assert all(a.tobytes() == b.tobytes() for a, b in zip(frows, zrows))
    _assert_same_logs(fe, ze)


def test_commit_blocks_between_assemble_and_seal(setup):
    """Assemble and seal share one ``_seq`` hold and the zero-stall flip
    takes ``_seq``: a commit arriving between them waits for the seal, and
    the flush is wholly of the pre-commit epoch, bit-equal to a twin that
    never saw the commit."""
    def engine():
        _, pe = _node_engines(setup, 2, False)
        pe.warmup()
        pe.update_graph(GraphDelta([11], [13]))
        return pe

    eng = engine()
    assembled, proceed, committed = threading.Event(), threading.Event(), threading.Event()
    orig_seal = eng._seal_assembled

    def held_seal(fl):
        assembled.set()
        proceed.wait(10.0)
        return orig_seal(fl)

    eng._seal_assembled = held_seal
    h = eng.submit(3)
    flusher = threading.Thread(target=eng.flush)
    flusher.start()
    assert assembled.wait(10.0)

    def committer():
        eng.update_graph(GraphDelta([3], [7]))
        committed.set()

    tc = threading.Thread(target=committer)
    tc.start()
    assert not committed.wait(0.5) and eng.graph_version == 1
    proceed.set()
    flusher.join(30)
    tc.join(30)
    assert committed.is_set() and eng.graph_version == 2
    assert eng.dispatch_graph_versions[-1] == 1
    twin = engine()
    h_t = twin.submit(3)
    twin.flush()
    assert np.array_equal(h.result(60), h_t.result(60))


def test_provisioning_over_a_staged_commit_uploads_its_rows():
    """A provisioning between a deferred apply and its publish drops the
    staged arrays and uploads every table from the host mirrors, the
    staged commit's ``bd`` rows included."""
    _, tt = topos()
    st = StreamingTiledGraph(tt, reserve_frac=0.5, device="cpu")
    st.apply(GraphDelta([5, 5, 9], [6, 7, 10]), defer_publish=True)
    assert not np.array_equal(st.graph()[0].numpy(), st.bd)  # staged, not yet live
    st.provision_reserve(16)
    assert not st.publish()
    bd, tiles = st.graph()
    assert np.array_equal(bd.numpy(), st.bd) and np.array_equal(tiles.numpy(), st.tiles)


def test_provisioning_waits_for_a_zero_stall_flip(setup):
    """The engine's provisioning takes the commit lock: held between a
    zero-stall commit's deferred apply and its flip, the commit finishes
    first, and the live arrays then equal the host mirrors."""
    _, pe = _node_engines(setup, 2, False)
    pe.warmup()
    built, proceed, provisioned = threading.Event(), threading.Event(), threading.Event()
    orig_flip = pe._flip

    def held_flip(stream, version):
        built.set()
        proceed.wait(10.0)
        return orig_flip(stream, version)

    pe._flip = held_flip
    tc = threading.Thread(target=pe.update_graph, args=(GraphDelta([3, 3], [7, 8]),))
    tc.start()
    assert built.wait(10.0)

    def provisioner():
        pe.provision_reserve(32)
        provisioned.set()

    tp = threading.Thread(target=provisioner)
    tp.start()
    assert not provisioned.wait(0.5)
    proceed.set()
    tc.join(30)
    tp.join(30)
    assert provisioned.is_set() and pe.graph_version == 1
    st = pe._sampler.stream
    bd, tiles = st.graph()
    assert np.array_equal(bd.numpy(), st.bd) and np.array_equal(tiles.numpy(), st.tiles)
    assert st.bd[3, 1] == st.degree(3)


def test_programs_replay_a_sealed_binding_against_its_epoch(setup):
    """`BucketPrograms` over a streaming graph: a binding taken before a
    commit serves that epoch after the commit's rebind, which keeps the
    programs (no capture anew), and the new binding serves the new epoch,
    equal to programs built over the rebuilt graph."""
    _, tt = topos()
    st = StreamingTiledGraph(tt, reserve_frac=1.0, device="cpu")
    sampler = GraphSageSampler(tt, SIZES, seed=SEED, device="cpu").bind_stream(st)
    model = bind_params(_model(), setup["tparams"])
    progs = BucketPrograms(sampler, setup["feat"])
    progs.compile_bucket(8, model)
    key, seeds = qrandom.key(9), np.array([3, 11, 7, 7, 7, 7, 7, 7])
    before = progs(8, model, key, seeds)
    sealed = progs.binding()
    st.apply(GraphDelta(np.full(40, 3), np.arange(40)))
    progs.rebind(graph=sampler.fused_graph_arrays())
    assert progs.binding().captures is sealed.captures
    assert np.array_equal(progs(8, model, key, seeds, binding=sealed), before)
    after = progs(8, model, key, seeds)
    fresh = GraphSageSampler(st.to_csr_topo(), SIZES, seed=SEED, device="cpu")
    fresh_progs = BucketPrograms(fresh, setup["feat"])
    assert np.array_equal(fresh_progs(8, model, key, seeds), after)
    assert not np.array_equal(after, before)


# -- the engines: temporal traffic ---------------------------------------------

def _temporal_engines(s, mif, fenced, window):
    jt, tt = topos()
    js = JSampler(jt, sizes=SIZES, mode="TPU", seed=SEED, dedup=False, max_deg=256)
    js.bind_temporal(JStreamingTiledGraph(jt, reserve_frac=1.0, edge_ts=BASE_TS), recency=0.02)
    ps = GraphSageSampler(tt, SIZES, seed=SEED, device="cpu", dedup=False, max_deg=256)
    ps.bind_temporal(StreamingTiledGraph(tt, reserve_frac=1.0, edge_ts=BASE_TS, device="cpu"),
                     recency=0.02)
    cfg = dict(max_batch=8, buckets=(8,), max_delay_ms=1e9, record_dispatches=True,
               max_in_flight=mif, fenced_commits=fenced, stream_retention_window=window)
    je = JTemporalServeEngine(s["jmodel"], s["params"], js, s["feat"], JServeConfig(**cfg),
                              t_quantum=0.05)
    pe = TemporalServeEngine(_model(), s["tparams"], ps, s["feat"], ServeConfig(**cfg),
                             t_quantum=0.05)
    return je, pe


def _drive_temporal(eng):
    """Timestamped commits between (node, t) queries, as in the
    reference's temporal parity matrix (with removals and updates)."""
    rng = np.random.default_rng(7)
    qry = np.random.default_rng(5).integers(0, N_NODES, 24)
    esrc = np.random.default_rng(6).integers(0, N_NODES, 12)
    edst = rng.integers(0, N_NODES, 12)
    rows = []
    for k in range(3):
        tq = 50.0 + k + 0.5
        hs = [eng.submit(int(x), t=tq) for x in qry[k * 8:(k + 1) * 8]]
        while eng._pending:
            eng.flush()
        rows.extend(np.asarray(h.result(60)) for h in hs)
        lo = k * 4
        ts_k = (50.0 + k + (np.arange(4) + 1.0) / 4.0).astype(np.float32)
        eng.stage_edges(esrc[lo:lo + 4], edst[lo:lo + 4], ts=ts_k)
        if k:
            eng.stage_removals(esrc[lo - 4:lo - 2], edst[lo - 4:lo - 2])
            eng.stage_updates(esrc[lo - 2:lo - 1], edst[lo - 2:lo - 1], [50.0 + k])
        eng.update_graph()
    return rows


@pytest.mark.parametrize("fenced", [True, False])
@pytest.mark.parametrize("mif", [1, 2])
def test_temporal_engine_commits_match_reference(setup, mif, fenced):
    je, pe = _temporal_engines(setup, mif, fenced, window=20.0)
    je.warmup()
    pe.warmup()
    jrows, prows = _drive_temporal(je), _drive_temporal(pe)
    for a, b in zip(jrows, prows):
        np.testing.assert_allclose(a, b, **TOL)
    _assert_same_logs(je, pe)
    assert je.graph_version == pe.graph_version == 3
    assert je.stats.edges_expired == pe.stats.edges_expired > 0
    assert je.stats.delta_cache_invalidated == pe.stats.delta_cache_invalidated
    assert je.retention.state() == pe.retention.state()
    _assert_same_state(je._sampler.stream, pe._sampler.stream)


# -- the cache's graph-version floors ------------------------------------------

def _apply_cache_ops(c):
    vals = {k: np.full(3, k, np.float32) for k in range(6)}
    for k in range(6):
        c.put(k, 1, vals[k])
    c.get(1, 1)
    out = [c.invalidate_nodes([2, 4]), list(c.keys())]
    ct = type(c)(capacity=8)
    ct.put((5, 1.0), 1, vals[0])
    ct.put((5, 2.0), 1, vals[1])
    ct.put((6, 1.0), 1, vals[2], gv=1)
    out += [ct.invalidate_nodes([5]), ct.keys(), ct.raise_floor([6, 7], 2),
            ct.graph_floor(6), ct.graph_floor(9), ct.invalidations]
    c.put(7, 1, vals[0], gv=0)
    out += [c.raise_floor([7], 1), c.get(7, 1), c.graph_floor(7)]
    c.put(7, 1, vals[1], gv=0)  # a late writeback from epoch 0: refused
    out.append(c.get(7, 1))
    c.put(7, 1, vals[2], gv=1)
    out += [c.entry_graph_version(7), c.entry_version(7), c.raise_floor([7], 1),
            c.invalidate_keys([0, 99]), c.keys(), c.invalidations, len(c)]
    return out


def test_cache_floors_and_node_index_match_reference():
    a, b = _apply_cache_ops(JEmbeddingCache(8)), _apply_cache_ops(EmbeddingCache(8))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y
    small = EmbeddingCache(capacity=3)
    for k in (10, 11, 12):
        small.put(k, 1, np.zeros(1))
    small.get(10, 1)
    small.invalidate_nodes([12])
    small.put(13, 1, np.zeros(1))
    small.put(14, 1, np.zeros(1))
    assert small.keys() == [10, 13, 14]


# -- refusals --------------------------------------------------------------------

def test_graph_operations_need_a_stream_and_valid_staging(setup):
    _, tt = topos()
    frozen = ServeEngine(_model(), setup["tparams"],
                         GraphSageSampler(tt, SIZES, seed=SEED, device="cpu"), setup["feat"])
    with pytest.raises(ValueError, match="stream-bound sampler"):
        frozen.update_graph(GraphDelta([1], [2]))
    with pytest.raises(ValueError, match="outside"):
        frozen.stage_edges([1], [N_NODES])
    _, pe = _node_engines(setup, 1, False)
    with pytest.raises(ValueError, match="non-temporal"):
        pe.stage_edges([1], [2], ts=[1.0])
    with pytest.raises(ValueError, match="temporal stream"):
        pe.stage_updates([1], [2], [1.0])
    assert pe.update_graph() == {"edges": 0, "installs": 0, "cache_invalidated": 0,
                                 "affected_seeds": 0, "graph_version": 0}
    pe.stage_removals([0], [N_NODES - 1])
    with pytest.raises(ValueError, match="absent edge"):
        pe.update_graph()
    assert len(pe.pending_delta) == 1 and pe.graph_version == 0  # re-staged, nothing moved
    for name, value in (("stream_compact_every_s", 1.0), ("stream_retention_every_s", 2.0),
                        ("stream_retention_clock", lambda: 0.0)):
        with pytest.raises(ValueError, match="A14, second part"):
            ServeConfig(**{name: value})
    sampler = GraphSageSampler(tt, SIZES, seed=SEED, device="cpu", layout="flat")
    with pytest.raises(TypeError, match="layout='tiled'"):
        sampler.bind_stream(StreamingTiledGraph(tt, device="cpu"))

"""The port's temporal sampling and temporal / link-prediction serving
(quiver_tpu_torch.workloads, K8's and K8w's plain versions) against
quiver_tpu.workloads, at the tiny shapes of tests/test_temporal.py (200
nodes, 1,400 edges, timestamps uniform in [0, 50), sizes [3, 3], max_deg
128 and 512).

Bars. Against the JAX package: validity flags bit-equal; ids bit-equal
on valid lanes except near-ties (the lanes that change places score
within 2 ULP in the port; at most 1 row in 2,000, so none here), since
XLA's float32 exp and log are its own approximations; dispatch logs
``(padded seeds, n_valid, padded t)`` equal under one submit sequence and
one clock; served logits within atol = rtol = 1e-5 (another sum order);
traces and the t quantizer byte-equal; the dot pair head within 1e-6 and
the MLP head, with the JAX head's weights carried over, within 1e-5.
Inside the port, bit for bit: a tiled draw against the host-masked
oracle, a draw at t = +inf against the weighted draw over the recency
weight tiles, the same (key, seeds, t) against itself, replayed dispatch
logs against the served rows, and a temporal engine at recency 0 and
t = +inf against a plain engine over unit weights. Late admission under
the gated trace (`torch_fixtures.gated_late_run`) writes the JAX engine's
dispatch log and counts at max_in_flight 1 and 2, and serves rows
bit-equal to a late-off engine fed the same final batches; `submit_many`
writes the dispatch log of scalar submits."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.ops import sample as jsample
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import ServeConfig as JServeConfig
from quiver_tpu.serve import lp_trace as j_lp_trace
from quiver_tpu.serve import temporal_trace as j_temporal_trace
from quiver_tpu.serve.trace_gen import poisson_arrivals as j_poisson
from quiver_tpu.workloads import PairHead as JPairHead
from quiver_tpu.workloads import TemporalServeEngine as JTemporalServeEngine
from quiver_tpu.workloads import TemporalTiledGraph as JTemporalTiledGraph
from quiver_tpu.workloads import host_masked_oracle as j_host_masked_oracle
from quiver_tpu.workloads import quantize_t as j_quantize_t
from quiver_tpu.workloads import temporal_sample_dense as j_temporal_sample_dense
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, ServeConfig, ServeEngine
from quiver_tpu_torch import pair_head_params_from_jax, sage_params_from_flax
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.ops import sample as tsample
from quiver_tpu_torch.serve import lp_trace, poisson_arrivals, temporal_trace
from quiver_tpu_torch.stream import StreamingTiledGraph
from quiver_tpu_torch.workloads import (
    LinkPredictor,
    PairHead,
    TemporalServeEngine,
    TemporalTiledGraph,
    host_masked_oracle,
    quantize_t,
    quantize_t_many,
    replay_temporal_log,
    temporal_sample_dense,
)

from conftest import make_random_graph
from torch_fixtures import gated_late_run
from test_torch_weighted import assert_draws_agree

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, MAXD = 200, 12, [3, 3], 5, 128
TOL = dict(atol=1e-5, rtol=1e-5)
EDGE_INDEX = make_random_graph(N_NODES, 1400, seed=0)
TOPO, JTOPO = CSRTopo(edge_index=EDGE_INDEX), JCSRTopo(edge_index=EDGE_INDEX)
BASE_TS = np.random.default_rng(11).uniform(0.0, 50.0, TOPO.edge_count).astype(np.float32)


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _keys(seed):
    return jax.random.key(seed), qrandom.key(seed)


def _graphs():
    return JTemporalTiledGraph(JTOPO, BASE_TS), TemporalTiledGraph(TOPO, BASE_TS, device="cpu")


def _sampler(recency=0.02, max_deg=MAXD):
    s = GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED, dedup=False, max_deg=max_deg)
    return s.bind_temporal(TemporalTiledGraph(TOPO, BASE_TS, device="cpu"), recency=recency)


def _jsampler(recency=0.02):
    s = JSampler(JTOPO, sizes=SIZES, mode="TPU", seed=SEED, dedup=False, max_deg=MAXD)
    return s.bind_temporal(JTemporalTiledGraph(JTOPO, BASE_TS), recency=recency)


@pytest.fixture(scope="module")
def setup():
    feat = np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    ds0 = _jsampler().sample_dense(np.arange(8, dtype=np.int64), t=100.0)
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return dict(feat=feat, jmodel=jmodel, params=params, tparams=tparams)


def _model():
    return GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)


def _engine(s, recency=0.02, t_quantum=4.0, **cfg):
    cfg = dict(dict(max_batch=8, buckets=(4, 8), max_delay_ms=1e9, record_dispatches=True),
               **cfg)
    return TemporalServeEngine(_model(), s["tparams"], _sampler(recency), s["feat"],
                               ServeConfig(**cfg), t_quantum=t_quantum)


# -- the temporal layer -------------------------------------------------------------

@pytest.mark.parametrize("recency,cutoff,max_deg", [(0.0, None, 128), (0.05, None, 128),
                                                    (0.05, 20.0, 128), (0.02, None, 512)])
def test_temporal_layer_against_jax(recency, cutoff, max_deg):
    rng = np.random.default_rng(1)
    B, k = 96, 4
    (jbd, jtiles, jtt), (bd, tiles, tt) = _graphs()[0].temporal_graph(), _graphs()[1].temporal_graph()
    seeds = rng.integers(0, N_NODES, B).astype(np.int32)
    valid = np.ones(B, bool)
    valid[-3:] = False
    tvals = rng.uniform(0.0, 60.0, B).astype(np.float32)
    tvals[0] = np.inf
    jk, tk = _keys(7)
    kw = dict(max_deg=max_deg, recency=recency)
    jn, jv = jsample.tiled_temporal_sample_layer(
        jbd, jtiles, jtt, jnp.asarray(seeds), jnp.asarray(valid), k, jk, jnp.asarray(tvals),
        cutoff=None if cutoff is None else jnp.float32(cutoff), **kw)
    tn, tv = tsample.tiled_temporal_sample_layer(
        bd, tiles, tt, torch.from_numpy(seeds), torch.from_numpy(valid), k, tk,
        torch.from_numpy(tvals), cutoff=cutoff, **kw)
    # positions over the same window on both sides (flags equal, near-ties counted)
    base = bd[torch.from_numpy(seeds).long(), 0]
    deg = torch.where(torch.from_numpy(valid), torch.clamp(bd[torch.from_numpy(seeds).long(), 1],
                                                           max=max_deg), 0)
    rows = tsample.temporal_weight_rows(tsample._tiled_payload_window(base, tt, max_deg),
                                        torch.from_numpy(tvals), recency, cutoff)
    jrows = jsample.temporal_weight_rows(jnp.asarray(tsample._tiled_payload_window(
        base, tt, max_deg).numpy()), jnp.asarray(tvals), recency, cutoff=cutoff)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6, atol=0)
    assert np.array_equal(rows.numpy() > 0, np.asarray(jrows) > 0)
    jpos, jpv = jsample.gumbel_topk_positions(jk, jnp.asarray(deg.numpy()), k, jnp.asarray(rows.numpy()))
    tpos, tpv = tsample.gumbel_topk_positions(tk, deg, k, rows)
    assert_draws_agree(jpos, jpv, tpos, tpv, tsample.gumbel_scores(tk, deg, rows).numpy())
    jv = np.asarray(jv)
    assert np.array_equal(jv, tv.numpy()) and np.array_equal(jpv, jv)
    same = ((np.asarray(jpos) == tpos.numpy()) | ~jv).all(axis=1)
    assert ((np.asarray(jn) == tn.numpy()) | ~jv)[same].all()
    # every drawn edge lies in the band (cutoff, t] of its row
    for b in np.nonzero(tv.numpy().any(axis=1))[0]:
        lo, hi = TOPO.indptr[seeds[b]], TOPO.indptr[seeds[b] + 1]
        ts = BASE_TS[lo:hi][:max_deg]
        ok = (ts <= tvals[b]) & ((ts > cutoff) if cutoff is not None else True)
        assert set(tn[b][tv[b]].tolist()) <= set(TOPO.indices[lo:hi][:max_deg][ok].tolist())


@pytest.mark.parametrize("recency,cutoff", [(0.0, None), (0.05, None), (0.05, 15.0)])
def test_tiled_draw_equals_the_host_masked_oracle(recency, cutoff):
    rng = np.random.default_rng(1)
    B, k = 64, 4
    bd, tiles, tt = _graphs()[1].temporal_graph()
    seeds = rng.integers(0, N_NODES, B)
    valid = np.ones(B, bool)
    valid[-3:] = False
    tvals = rng.uniform(0.0, 60.0, B).astype(np.float32)
    key = qrandom.key(7)
    nb, vl = tsample.tiled_temporal_sample_layer(
        bd, tiles, tt, torch.from_numpy(seeds.astype(np.int32)), torch.from_numpy(valid), k, key,
        torch.from_numpy(tvals), max_deg=MAXD, recency=recency, cutoff=cutoff)
    onb, ovl = host_masked_oracle(TOPO.indptr, TOPO.indices, BASE_TS, seeds, valid, k, key, tvals,
                                  max_deg=MAXD, recency=recency, cutoff=cutoff)
    assert np.array_equal(vl.numpy(), ovl)
    assert np.array_equal(nb.numpy()[ovl], onb[ovl])
    # and the JAX package's oracle agrees on the same inputs
    jnb, jvl = j_host_masked_oracle(TOPO.indptr, TOPO.indices, BASE_TS, seeds, valid, k,
                                    jax.random.key(7), tvals, max_deg=MAXD, recency=recency,
                                    cutoff=cutoff)
    assert np.array_equal(jvl, ovl) and np.array_equal(jnb[jvl], onb[ovl])


@pytest.mark.parametrize("recency", [0.0, 0.05])
def test_t_inf_draw_equals_the_weighted_draw_over_recency_tiles(recency):
    rng = np.random.default_rng(3)
    B, k = 80, 5
    tg = _graphs()[1]
    bd, tiles, tt = tg.temporal_graph()
    seeds = torch.from_numpy(rng.integers(0, N_NODES, B).astype(np.int32))
    valid = torch.ones(B, dtype=torch.bool)
    key = qrandom.key(9)
    nb_t, vl_t = tsample.tiled_temporal_sample_layer(bd, tiles, tt, seeds, valid, k, key,
                                                     torch.full((B,), math.inf), max_deg=MAXD,
                                                     recency=recency)
    wt = tg.recency_wtiles(recency)
    nb_w, vl_w = tsample.tiled_weighted_sample_layer(bd, tiles, wt, seeds, valid, k, key,
                                                     max_deg=MAXD)
    assert torch.equal(vl_t, vl_w) and torch.equal(nb_t, nb_w)
    jt = JTemporalTiledGraph(JTOPO, BASE_TS)
    np.testing.assert_allclose(wt.numpy(), np.asarray(jt.recency_wtiles(recency)), rtol=1e-6)


def test_temporal_layer_and_dense_sample_are_deterministic():
    bd, tiles, tt = _graphs()[1].temporal_graph()
    seeds = torch.arange(16, dtype=torch.int32)
    t = torch.full((16,), 25.0)
    a = tsample.tiled_temporal_sample_layer(bd, tiles, tt, seeds, torch.ones(16, dtype=torch.bool),
                                            4, qrandom.key(1), t, max_deg=MAXD)
    b = tsample.tiled_temporal_sample_layer(bd, tiles, tt, seeds, torch.ones(16, dtype=torch.bool),
                                            4, qrandom.key(1), t, max_deg=MAXD)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g = _graphs()[1].temporal_graph()
    tv = torch.from_numpy(np.linspace(5, 45, 6).astype(np.float32))
    da = temporal_sample_dense(g, qrandom.key(2), seeds[:6], tv, SIZES, recency=0.01,
                               max_deg=MAXD)
    db = temporal_sample_dense(g, qrandom.key(2), seeds[:6], tv, SIZES, recency=0.01,
                               max_deg=MAXD)
    assert torch.equal(da.n_id, db.n_id)
    assert all(torch.equal(x.mask, y.mask) for x, y in zip(da.adjs, db.adjs))


def test_per_seed_t_lineage_in_multihop():
    g = _graphs()[1].temporal_graph()
    seeds = torch.tensor([3, 7], dtype=torch.int32)
    key = qrandom.key(4)
    mixed = temporal_sample_dense(g, key, seeds, torch.tensor([10.0, 45.0]), SIZES, max_deg=MAXD)
    other = temporal_sample_dense(g, key, seeds, torch.tensor([10.0, 999.0]), SIZES, max_deg=MAXD)
    # seed 0 keeps t = 10 in both runs: its hop-1 draws (positions 2 + 2j) agree
    m_mixed, m_other = mixed.adjs[-1].mask, other.adjs[-1].mask
    assert torch.equal(m_mixed[0], m_other[0])
    for j in range(SIZES[0]):
        if m_mixed[0, j]:
            assert mixed.n_id[2 + 2 * j] == other.n_id[2 + 2 * j]


def test_temporal_sample_dense_against_jax():
    jg, tg = _graphs()
    seeds = np.arange(12, dtype=np.int32) * 13 % N_NODES
    t = np.linspace(3, 55, 12).astype(np.float32)
    jds = j_temporal_sample_dense(jg.temporal_graph(), jax.random.key(2), jnp.asarray(seeds),
                                  jnp.asarray(t), tuple(SIZES), recency=0.02, max_deg=MAXD)
    tds = temporal_sample_dense(tg.temporal_graph(), qrandom.key(2), torch.from_numpy(seeds),
                                torch.from_numpy(t), SIZES, recency=0.02, max_deg=MAXD)
    assert int(jds.count) == int(tds.count)
    valid = np.concatenate([np.ones(12, bool)] + [np.asarray(a.mask).T.reshape(-1)
                                                  for a in jds.adjs[::-1]])
    assert np.array_equal(np.asarray(jds.n_id)[valid], tds.n_id.numpy()[valid])
    for ja, ta in zip(jds.adjs, tds.adjs):
        assert np.array_equal(np.asarray(ja.mask), ta.mask.numpy())


def test_binding_validation():
    tg = TemporalTiledGraph(TOPO, BASE_TS, device="cpu")
    with pytest.raises(TypeError):  # dedup pipelines cannot carry t
        GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED).bind_temporal(tg)
    topo_w = CSRTopo(edge_index=EDGE_INDEX, edge_weights=np.ones(EDGE_INDEX.shape[1], np.float32))
    with pytest.raises(TypeError):  # weighted samplers conflict
        GraphSageSampler(topo_w, SIZES, device="cpu", dedup=False,
                         weighted=True).bind_temporal(tg)
    with pytest.raises(TypeError):  # the flat layout has no payload lanes
        GraphSageSampler(TOPO, SIZES, device="cpu", dedup=False, layout="flat").bind_temporal(tg)
    s = GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED, dedup=False)
    with pytest.raises(TypeError, match="edge_ts"):  # a stream without timestamps
        s.bind_temporal(StreamingTiledGraph(TOPO, device="cpu"))
    stream = StreamingTiledGraph(TOPO, edge_ts=BASE_TS, device="cpu")
    bound = GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED, dedup=False)
    assert bound.bind_temporal(stream).stream is stream  # a streaming temporal graph binds both
    with pytest.raises(TypeError):  # t on a non-temporal sampler
        s.sample_dense(np.arange(4), t=1.0)
    s.bind_temporal(tg)
    with pytest.raises(TypeError):  # a temporal sample needs t
        s.sample_dense(np.arange(4))
    with pytest.raises(ValueError):
        TemporalTiledGraph(TOPO, BASE_TS[:-1], device="cpu")


# -- quantizer and traces ---------------------------------------------------------

def test_quantize_t_and_many_equal_the_reference_over_the_float32_grid():
    rng = np.random.default_rng(0)
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 2.0 ** 53, -(2.0 ** 53), 1e300])
    for q in (0.0, 1e-3, 0.05, 1.0, 8.0, 3600.0):
        pools = [rng.uniform(0.0, 100.0, 64), specials]
        if q > 0:
            j = rng.integers(0, 5000, 64)
            pools += [j.astype(np.float64) * q, (j + 1000).astype(np.float64) * q,
                      rng.uniform(900.0, 1100.0, 64) * q]
        for arr in pools:
            arr = np.asarray(arr, np.float64)
            want = np.array([j_quantize_t(float(t), q) for t in arr], np.float64)
            assert np.array_equal(quantize_t_many(arr, q), want, equal_nan=True), q
            got = np.array([quantize_t(float(t), q) for t in arr], np.float64)
            assert np.array_equal(got, want, equal_nan=True), q
    qv = quantize_t(17.3, 5.0)
    assert qv == 15.0 and quantize_t(float(np.float32(qv)), 5.0) == qv


def test_temporal_and_lp_traces_byte_equal():
    a = temporal_trace(N_NODES, 300, seed=3, qps=40.0, t0=10.0, edge_every=20)
    b = j_temporal_trace(N_NODES, 300, seed=3, qps=40.0, t0=10.0, edge_every=20)
    for fa, fb in zip(a, b):
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
    assert a.n_events == b.n_events and (np.diff(a.t_query) > 0).all()
    assert np.array_equal(poisson_arrivals(50, 40.0, seed=2), j_poisson(50, 40.0, seed=2))
    la, lb = lp_trace(TOPO, 120, seed=7, pos_frac=0.6), j_lp_trace(JTOPO, 120, seed=7, pos_frac=0.6)
    for fa, fb in zip(la, lb):
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
    assert 0 < int(la.label.sum()) < 120


# -- the temporal serve engine --------------------------------------------------------

def _drive(engine, clock, nodes, ts):
    handles = []
    for i, (node, t) in enumerate(zip(nodes.tolist(), ts.tolist())):
        clock.t += 0.001
        handles.append(engine.submit(node, t=t))
        engine.pump()
        if i % 7 == 6:
            engine.flush()
    while engine.flush():
        pass
    return np.stack([h.result(timeout=30) for h in handles])


def test_engine_dispatch_log_and_logits_match_reference(setup):
    s = setup
    rng = np.random.default_rng(13)
    nodes = rng.integers(0, N_NODES, 60)
    ts = rng.uniform(0, 60, 60)
    nodes[::6], ts[::6] = 7, 12.5  # repeats: coalescing and cache hits
    cfg = dict(max_batch=8, buckets=(4, 8), max_delay_ms=2.5, cache_entries=32,
               record_dispatches=True)
    jclock, tclock = ManualClock(), ManualClock()
    jeng = JTemporalServeEngine(s["jmodel"], s["params"], _jsampler(), s["feat"],
                                JServeConfig(clock=jclock, **cfg), t_quantum=4.0)
    teng = TemporalServeEngine(_model(), s["tparams"], _sampler(), s["feat"],
                               ServeConfig(clock=tclock, **cfg), t_quantum=4.0)
    want = _drive(jeng, jclock, nodes, ts)
    got = _drive(teng, tclock, nodes, ts)
    assert len(jeng.dispatch_log) == len(teng.dispatch_log) > 5
    for (jp, jn, jt), (tp, tn, tt) in zip(jeng.dispatch_log, teng.dispatch_log):
        assert jn == tn and np.array_equal(jp, tp)
        assert jt.dtype == tt.dtype == np.float32 and np.array_equal(jt, tt)
    for field in ("requests", "coalesced", "dispatches", "dispatched_seeds", "padded_seeds"):
        assert getattr(jeng.stats, field) == getattr(teng.stats, field), field
    assert jeng.stats.cache.hits == teng.stats.cache.hits > 0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mif", [1, 2])
def test_temporal_engine_replay_parity(setup, mif):
    eng = _engine(setup, max_in_flight=mif)
    eng.warmup()
    assert eng.dispatch_log == [] and eng._sampler._call == 0  # warmup consumed no key
    rng = np.random.default_rng(13)
    nodes = rng.integers(0, N_NODES, 24)
    tq = rng.uniform(0, 60, 24)
    rows = eng.predict(nodes, t=tq, timeout=60)
    oracle = replay_temporal_log(eng.dispatch_log, _model(), setup["tparams"], _sampler(),
                                 setup["feat"])
    for node, t, row in zip(nodes, tq, rows):
        k = (int(node), float(np.float32(quantize_t(t, 4.0))))
        assert any(np.array_equal(row, c) for c in oracle.get(k, [])), k


def test_composite_cache_keys_and_coalescing_by_t_bucket(setup):
    eng = _engine(setup, t_quantum=10.0)
    eng.warmup()
    r1 = eng.predict([7], t=12.0)[0]        # bucket 10: computed
    hits = eng.stats.cache.hits
    r2 = eng.predict([7], t=17.0)[0]        # same bucket: a cache hit
    assert eng.stats.cache.hits == hits + 1 and np.array_equal(r1, r2)
    d0 = eng.stats.dispatches
    eng.predict([7], t=23.0)                # bucket 20: a new computation
    assert eng.stats.dispatches == d0 + 1
    eng.update_params(setup["tparams"])     # a version bump drops every entry
    assert len(eng.cache) == 0
    h1, h2, h3 = eng.submit(5, t=11.0), eng.submit(5, t=14.0), eng.submit(5, t=27.0)
    assert eng.stats.coalesced == 1         # 11 and 14 share bucket 10; 27 does not
    eng.flush_inline(lambda: False)
    assert np.array_equal(h1.result(30), h2.result(30)) and h3.result(30) is not None


def test_plain_engine_refuses_a_temporal_sampler_and_the_temporal_one_a_plain(setup):
    with pytest.raises(TypeError):
        ServeEngine(_model(), setup["tparams"], _sampler(), setup["feat"], ServeConfig(max_batch=8))
    plain = GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED, dedup=False)
    with pytest.raises(TypeError):
        TemporalServeEngine(_model(), setup["tparams"], plain, setup["feat"])
    with pytest.raises(ValueError):
        TemporalServeEngine(_model(), setup["tparams"], _sampler(), setup["feat"],
                            ServeConfig(max_batch=8, dispatch_mode="split"))
    eng = ServeEngine(_model(), setup["tparams"], plain, setup["feat"], ServeConfig(max_batch=8))
    with pytest.raises(TypeError):
        eng.submit_many([1], t=[3.0])


def test_t_inf_engine_bit_equal_plain_engine_over_unit_weights(setup):
    topo_w = CSRTopo(edge_index=EDGE_INDEX, edge_weights=np.ones(EDGE_INDEX.shape[1], np.float32))
    sw = GraphSageSampler(topo_w, SIZES, device="cpu", seed=SEED, dedup=False, weighted=True,
                          max_deg=MAXD)
    eng_w = ServeEngine(_model(), setup["tparams"], sw, setup["feat"],
                        ServeConfig(max_batch=8, buckets=(4, 8), max_delay_ms=1e9,
                                    record_dispatches=True))
    eng_w.warmup()
    eng_t = _engine(setup, recency=0.0, t_quantum=0.0)
    eng_t.warmup()
    nodes = np.random.default_rng(17).integers(0, N_NODES, 20)
    rows_w = eng_w.predict(nodes, timeout=60)
    rows_t = eng_t.predict(nodes, t=None, timeout=60)
    assert np.array_equal(rows_w, rows_t)
    assert len(eng_w.dispatch_log) == len(eng_t.dispatch_log)
    for (pw, nw), (pt, nt, tv) in zip(eng_w.dispatch_log, eng_t.dispatch_log):
        assert nw == nt and np.array_equal(pw, pt) and np.isinf(tv).all()


# -- link prediction ------------------------------------------------------------

def test_submit_pair_coalesces_shared_endpoints(setup):
    eng = _engine(setup, t_quantum=10.0)
    eng.warmup()
    p1 = eng.submit_pair(2, 3, t=15.0)
    p2 = eng.submit_pair(2, 4, t=12.0)      # endpoint 2 coalesces (bucket 10)
    assert eng.stats.requests == 4 and eng.stats.coalesced == 1
    eng.flush_inline(lambda: p1.done() and p2.done())
    s1, s2 = p1.result(30), p2.result(30)
    assert 0.0 <= s1 <= 1.0 and 0.0 <= s2 <= 1.0 and p1.error() is None
    hu, hv = p1.rows()
    assert np.float32(eng.pair_head.score(hu[None], hv[None])[0]) == np.float32(s1)
    scores = eng.predict_pairs([[2, 3], [5, 6]], t=[15.0, 40.0])
    assert scores.shape == (2,) and np.float32(scores[0]) == np.float32(s1)


def test_pair_head_modes_against_jax():
    rng = np.random.default_rng(23)
    hu = rng.standard_normal((9, 5)).astype(np.float32)
    hv = rng.standard_normal((9, 5)).astype(np.float32)
    dot = PairHead("dot")
    assert np.array_equal(dot.score(hu, hv), dot.score(hu, hv))
    np.testing.assert_allclose(dot.score(hu, hv), JPairHead("dot").score(hu, hv), atol=1e-6)
    jm = JPairHead("mlp", dim=5, seed=4)
    mine = PairHead("mlp", dim=5, params=pair_head_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    np.testing.assert_allclose(mine.score(hu, hv), jm.score(hu, hv), atol=1e-5, rtol=1e-5)
    m1, m2, m3 = PairHead("mlp", dim=5, seed=4), PairHead("mlp", dim=5, seed=4), PairHead(
        "mlp", dim=5, seed=9)
    assert np.array_equal(m1.score(hu, hv), m2.score(hu, hv))
    assert not np.array_equal(m1.score(hu, hv), m3.score(hu, hv))
    with pytest.raises(ValueError):
        PairHead("mlp")
    with pytest.raises(ValueError):
        PairHead("cosine")
    with pytest.raises(ValueError):
        pair_head_params_from_jax({"w1": np.zeros((15, 32))})


def test_linkpredictor_on_a_plain_engine(setup):
    s = GraphSageSampler(TOPO, SIZES, device="cpu", seed=SEED)
    eng = ServeEngine(_model(), setup["tparams"], s, setup["feat"],
                      ServeConfig(max_batch=8, buckets=(4, 8), max_delay_ms=1e9))
    eng.warmup()
    lp = LinkPredictor(eng)
    assert lp.predict_pairs([[1, 2], [3, 4]]).shape == (2,)
    with pytest.raises(TypeError):
        lp.submit_pair(1, 2, t=5.0)  # a plain engine takes no query time


# -- late admission -------------------------------------------------------------------

# (node, t) requests, t_quantum 4: the keys are (node, the 4-wide t bucket)
T_PRE = [(40, 21.0), (41, 21.0)]
T_STALLED = [[(0, 1.0), (1, 2.0), (2, 3.0)], [(30, 1.0), (31, 2.0), (32, 3.0)]]
T_WAITING = [(10, 5.0), (11, 5.0), (12, 9.0), (13, 13.0), (14, 17.0)]  # bucket 8
# (20, 4), (21, 4) and (20, 8) fill the slack; (20, 6.5), (11, 7.9) and (1, 3.5)
# coalesce by t bucket; (23, 0) waits; (40, 22.0) hits the cache
T_LATE = [(20, 5.0), (21, 6.0), (20, 6.5), (11, 7.9), (1, 3.5), (20, 9.0), (23, 1.0),
          (40, 22.0)]


def _tsubmit(eng, reqs):
    return [eng.submit(n, t=t) for n, t in reqs]


def _tsubmit_many(eng, reqs):
    return list(eng.submit_many([n for n, _ in reqs], t=[t for _, t in reqs]))


def _tkey(n, t):
    return int(n), float(np.float32(quantize_t(t, 4.0)))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mif", [1, 2])
def test_gated_late_admission_matches_reference(setup, mif, batched):
    s = setup
    cfg = dict(max_batch=8, buckets=(4, 8), max_delay_ms=1e9, max_in_flight=mif,
               cache_entries=64, record_dispatches=True)
    jeng = JTemporalServeEngine(s["jmodel"], s["params"], _jsampler(), s["feat"],
                                JServeConfig(**cfg), t_quantum=4.0)
    teng = _engine(s, **cfg)
    rows = []
    for eng in (jeng, teng):
        _tsubmit(eng, T_PRE)
        eng.flush()
        hs = gated_late_run(eng, _tsubmit, mif, T_STALLED, T_WAITING, T_LATE,
                            submit_late=_tsubmit_many if batched else None)
        rows.append(np.stack([h.result(timeout=60) for h in hs]))
    keys = [[(int(n), float(t)) for n, t in zip(p[:nv], tt[:nv])]
            for p, nv, tt in teng.dispatch_log]
    assert keys[-2:] == [[_tkey(*r) for r in T_WAITING] + [(20, 4.0), (21, 4.0), (20, 8.0)],
                         [(23, 0.0)]]
    assert len(jeng.dispatch_log) == len(teng.dispatch_log) == 3 + mif
    for (jp, jn, jt), (tp, tn, tt) in zip(jeng.dispatch_log, teng.dispatch_log):
        assert jn == tn and np.array_equal(jp, tp) and np.array_equal(jt, tt)
    for field in ("requests", "coalesced", "late_admitted", "dispatches", "padded_seeds"):
        assert getattr(jeng.stats, field) == getattr(teng.stats, field), field
    assert teng.stats.late_admitted == 3 and teng.stats.coalesced == 3
    assert jeng.stats.cache.hits == teng.stats.cache.hits == 1
    np.testing.assert_allclose(rows[1], rows[0], **TOL)
    # bit-equal to a late-off engine fed the same final batches
    ref = _engine(s, cache_entries=64, late_admission=False)
    ref_rows = {}
    for p, nv, tt in teng.dispatch_log:
        hs = ref.submit_many(p[:nv], t=tt[:nv])
        ref.flush()
        for n, t, h in zip(p[:nv], tt[:nv], hs):
            ref_rows[(int(n), float(t))] = h.result(timeout=60)
    assert ref.stats.late_admitted == 0 and len(ref.dispatch_log) == len(teng.dispatch_log)
    requests = [r for b in T_STALLED[:mif] for r in b] + T_WAITING + T_LATE
    for r, row in zip(requests, rows[1]):
        assert np.array_equal(row, ref_rows[_tkey(*r)]), r


@pytest.mark.parametrize("cache", [0, 32])
def test_submit_many_dispatch_log_bit_equal_scalar_submits(setup, cache):
    """`submit_many` in chunks of 4 over (node, t_bucket) keys, with the
    cache off and on, against scalar submits: rows, dispatch log and
    counts bit-equal."""
    rng = np.random.default_rng(17)
    nodes = rng.integers(0, 10, 40)  # repeats within a t bucket coalesce
    ts = rng.uniform(0, 12, 40)
    a, b = (_engine(setup, cache_entries=cache) for _ in range(2))
    ha = _tsubmit(a, list(zip(nodes.tolist(), ts.tolist())))
    hb = [h for j in range(0, 40, 4) for h in b.submit_many(nodes[j:j + 4], t=ts[j:j + 4])]
    for eng in (a, b):
        while eng.flush():
            pass
    assert np.array_equal(np.stack([h.result(30) for h in ha]),
                          np.stack([h.result(30) for h in hb]))
    assert len(a.dispatch_log) == len(b.dispatch_log) >= 3
    for (pa, na, ta), (pb, nb, tb) in zip(a.dispatch_log, b.dispatch_log):
        assert na == nb and np.array_equal(pa, pb) and np.array_equal(ta, tb)
    for field in ("requests", "coalesced", "dispatches"):
        assert getattr(a.stats, field) == getattr(b.stats, field), field
    assert a.stats.coalesced > 0

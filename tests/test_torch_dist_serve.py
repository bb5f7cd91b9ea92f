"""The port's routed fleet (quiver_tpu_torch.serve.dist) against
quiver_tpu.serve.dist, on the N = 200 graph of tests/test_serve_dist.py
(2,000 edges, DIM 16, sizes [4, 4], sampler seed 3) with the GraphSAGE
weights converted from the flax init, all on the CPU (the port's rank
threads over gloo, the JAX package's 8 virtual devices).

- The partitioning (``contiguous_partition``, the closure masks, the shard
  CSRs, ``topo_stats``) is bit-equal to JAX's.
- Pumped from one thread under one manual clock, the router's and every
  owner's dispatch logs equal JAX's at hosts 1 and 2 and max_in_flight 1
  and 2, and the logits agree within atol = rtol = 1e-5 (XLA-CPU and
  torch-CPU sum in different orders).
- Inside the port everything is bit-equal: each served row to the replay of
  its owner's log through a full-graph sampler, ``hosts=1`` to the
  single-host `ServeEngine` (logits, dispatch log, cache counts), host mode
  to collective mode, and the closure residency to the exchange residency.
  Threaded clients are held against the replay oracle alone.
- A failing owner fails only its own requests in host mode, and the whole
  flush (an OwnerAnswerError naming it) in collective mode.
- Late admission under the gated trace (`torch_fixtures.gated_late_run`:
  routed flushes held in their dispatch stage with every window permit,
  one waiting for a permit, late seeds of both owners arriving) gives the
  JAX router's and owners' logs and counts at max_in_flight 1 and 2, and
  rows bit-equal to the owners' replays; `submit_many` routes as scalar
  submits do.

Each JAX fleet is built once per module (the ``jax_runs`` fixture)."""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import DistServeConfig as JDistServeConfig
from quiver_tpu.serve import DistServeEngine as JDistServeEngine
from quiver_tpu.serve import dist as jdist
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch.serve import (
    DistServeConfig,
    DistServeEngine,
    ServeConfig,
    ServeEngine,
    closure_masks,
    contiguous_partition,
    replay_fleet_oracle,
    replay_shard_oracle,
    shard_topology_by_owner,
    shard_topology_for_seeds,
    zipfian_trace,
)
from quiver_tpu_torch.utils import resolve_device

from conftest import make_random_graph
from torch_fixtures import gated_late_run

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED = 200, 16, [4, 4], 3
EDGE_INDEX = make_random_graph(N_NODES, 2000, seed=0)
TOL = dict(atol=1e-5, rtol=1e-5)


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((N_NODES, DIM)).astype(np.float32)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    js = JSampler(JCSRTopo(edge_index=EDGE_INDEX), sizes=SIZES, mode="TPU", seed=SEED)
    ds0 = js.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return dict(feat=feat, jmodel=jmodel, params=params, tparams=tparams)


def _model():
    return GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)


def _full_sampler():
    return GraphSageSampler(CSRTopo(edge_index=EDGE_INDEX), SIZES, seed=SEED, device="cpu")


def _port_dist(s, hosts, **cfg):
    cfg.setdefault("max_batch", 8)
    cfg.setdefault("max_delay_ms", 1e9)
    cfg.setdefault("record_dispatches", True)
    cfg.setdefault("cache_entries", 512)
    return DistServeEngine.build(_model(), s["tparams"], CSRTopo(edge_index=EDGE_INDEX),
                                 s["feat"], SIZES, hosts=hosts,
                                 config=DistServeConfig(hosts=hosts, **cfg), sampler_seed=SEED,
                                 device="cpu")


def _drive(dist, clock, trace):
    """One request per clock tick (1 ms), the flush policy pumped after each,
    a forced flush every 9 requests, a drain at the end."""
    handles = []
    for i, node in enumerate(trace.tolist()):
        clock.t += 0.001
        handles.append(dist.submit(node))
        dist.pump()
        if i % 9 == 8:
            dist.flush()
    while dist.flush():
        pass
    return np.stack([h.result(timeout=60) for h in handles])


DRIVE_TRACE = zipfian_trace(N_NODES, 90, alpha=0.99, seed=5)
DRIVE_CFG = dict(max_batch=8, max_delay_ms=2.5, cache_entries=16, record_dispatches=True)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """(hosts, max_in_flight) -> the JAX fleet after `_drive` over
    DRIVE_TRACE, and its served rows; each built once."""
    runs = {}

    def get(hosts, mif):
        if (hosts, mif) not in runs:
            clock = ManualClock()
            jd = JDistServeEngine.build(
                setup["jmodel"], setup["params"], JCSRTopo(edge_index=EDGE_INDEX), setup["feat"],
                SIZES, hosts=hosts, sampler_seed=SEED,
                config=JDistServeConfig(hosts=hosts, max_in_flight=mif, clock=clock, **DRIVE_CFG))
            runs[hosts, mif] = (jd, _drive(jd, clock, DRIVE_TRACE))
        return runs[hosts, mif]

    return get


# -- partitioning -----------------------------------------------------------------------

def _two_communities(per=20):
    src, dst = [], []
    for u in range(2 * per):
        base = (u // per) * per
        for v in range(3):
            src.append(u)
            dst.append(base + (u + v + 1) % per)
    return np.stack([np.array(src), np.array(dst)]), (np.arange(2 * per) // per).astype(np.int32)


def _same_csr(a, b):
    return (np.array_equal(np.asarray(a.indptr), np.asarray(b.indptr))
            and np.array_equal(np.asarray(a.indices), np.asarray(b.indices)))


@pytest.mark.parametrize("graph", ["random", "communities"])
def test_partitioning_bit_equal_to_reference(graph):
    """contiguous_partition, closure_masks at every depth, the owner shards
    with their feature closures and stats, and the seed-set shards."""
    for n, h in ((10, 3), (4, 1), (N_NODES, 2), (N_NODES, 3), (7, 7)):
        assert np.array_equal(contiguous_partition(n, h), jdist.contiguous_partition(n, h))
    with pytest.raises(ValueError):
        contiguous_partition(0, 2)
    if graph == "random":
        ei, g2h = EDGE_INDEX, contiguous_partition(N_NODES, 2)
    else:
        ei, g2h = _two_communities()
    topo, jtopo = CSRTopo(edge_index=ei), JCSRTopo(edge_index=ei)
    indptr, indices = np.asarray(topo.indptr, np.int64), np.asarray(topo.indices, np.int64)
    seed_mask = np.zeros(indptr.shape[0] - 1, bool)
    seed_mask[[3, 17, 19]] = True
    for hops, feat_hops in ((0, 0), (0, 1), (1, 2), (2, 3), (3, 3)):
        got = closure_masks(indptr, indices, seed_mask, hops, feat_hops)
        want = jdist.closure_masks(indptr, indices, seed_mask, hops, feat_hops)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for host in range(int(g2h.max()) + 1):
        for hops, closure_hops in ((1, None), (1, 2), (2, None)):
            shard, st, closure = shard_topology_by_owner(topo, g2h, host, hops, True, closure_hops)
            jshard, jst, jclosure = jdist.shard_topology_by_owner(jtopo, g2h, host, hops, True,
                                                                  closure_hops)
            assert st == jst and np.array_equal(closure, jclosure) and _same_csr(shard, jshard)
    if graph == "communities":  # k-hop closed: each shard keeps exactly its edges
        _, st = shard_topology_by_owner(topo, g2h, 0, hops=1)
        assert st["closure_nodes"] == st["owned_nodes"] == 20
        assert st["edges_kept"] * 2 == st["edges_total"]
    seeds = np.array([3, 17, 19], np.int64)
    got = shard_topology_for_seeds(topo, seeds, hops=1, closure_hops=2)
    want = jdist.shard_topology_for_seeds(jtopo, seeds, hops=1, closure_hops=2)
    assert got[1] == want[1] and np.array_equal(got[2], want[2]) and _same_csr(got[0], want[0])
    with pytest.raises(ValueError):
        shard_topology_for_seeds(topo, np.array([indptr.shape[0] + 5]), hops=1)


# -- the fleet against the JAX fleet ------------------------------------------------------

@pytest.mark.parametrize("hosts,mif", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_router_and_owner_logs_match_reference(setup, jax_runs, hosts, mif):
    jd, want = jax_runs(hosts, mif)
    clock = ManualClock()
    td = _port_dist(setup, hosts, max_in_flight=mif, clock=clock, **DRIVE_CFG)
    assert td.exchange_mode == jd.exchange_mode == "collective"
    got = _drive(td, clock, DRIVE_TRACE)
    assert len(td.dispatch_log) == len(jd.dispatch_log) > 5
    for (ta, tsplit), (ja, jsplit) in zip(td.dispatch_log, jd.dispatch_log):
        assert np.array_equal(ta, ja)
        assert [h for h, _ in tsplit] == [h for h, _ in jsplit]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(tsplit, jsplit))
    for h in range(hosts):
        tlog, jlog = td.engines[h].dispatch_log, jd.engines[h].dispatch_log
        assert len(tlog) == len(jlog) > 0
        for (tp, tn), (jp, jn) in zip(tlog, jlog):
            assert tn == jn and np.array_equal(tp, jp)
    for name in ("requests", "coalesced", "router_dispatches", "routed_seeds",
                 "exchange_id_bytes", "exchange_logit_bytes", "sub_batches", "sub_batch_seeds"):
        assert getattr(td.stats, name) == getattr(jd.stats, name), name
    assert td.stats.router_cache.hits == jd.stats.router_cache.hits > 0
    assert td.shard_topo_stats == jd.shard_topo_stats
    np.testing.assert_allclose(got, want, **TOL)


# -- inside the port: bit-equal ------------------------------------------------------------

@pytest.mark.parametrize("hosts,mif", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_served_rows_bit_equal_to_replay_oracle(setup, hosts, mif):
    trace = zipfian_trace(N_NODES, 40, alpha=1.1, seed=7)
    dist = _port_dist(setup, hosts, max_in_flight=mif)
    out = dist.predict(trace)
    oracle = replay_shard_oracle(dist, _model(), setup["tparams"], _full_sampler, setup["feat"])
    fleet = replay_fleet_oracle(dist, _model(), setup["tparams"], _full_sampler, setup["feat"])
    for i, nid in enumerate(trace.tolist()):
        assert np.array_equal(out[i], oracle[nid])
        assert any(np.array_equal(out[i], c) for c in fleet[nid])
    widths = dist.stats.mean_sub_batch_width()
    assert set(widths) == set(range(hosts))
    assert sum(dist.stats.sub_batch_seeds.values()) == dist.stats.routed_seeds
    H, L, C = hosts, dist._budget, dist.out_dim
    assert dist.stats.exchange_id_bytes == dist.stats.router_dispatches * H * H * L * 4
    assert dist.stats.exchange_logit_bytes == dist.stats.router_dispatches * H * H * L * C * 4


@pytest.mark.parametrize("mif", [1, 2])
def test_hosts1_bit_equal_single_host_engine(setup, mif):
    """hosts=1 reproduces the port's ServeEngine on the full graph: served
    logits, the dispatch log (the key stream) and the cache's behaviour."""
    trace = zipfian_trace(N_NODES, 40, alpha=1.1, seed=7)
    plain = ServeEngine(_model(), setup["tparams"], _full_sampler(), setup["feat"],
                        ServeConfig(max_batch=8, max_delay_ms=1e9, record_dispatches=True,
                                    cache_entries=512, max_in_flight=mif))
    out_plain = plain.predict(trace)
    dist = _port_dist(setup, 1, max_in_flight=mif)
    out_dist = dist.predict(trace)
    assert np.array_equal(out_plain, out_dist)
    log0 = dist.engines[0].dispatch_log
    assert len(plain.dispatch_log) == len(log0) == dist.stats.router_dispatches
    for (p0, n0), (p1, n1) in zip(plain.dispatch_log, log0):
        assert n0 == n1 and np.array_equal(p0, p1)
    assert dist.stats.router_cache.hits == plain.stats.cache.hits > 0
    assert dist.stats.coalesced == plain.stats.coalesced
    assert dist.engines[0]._feature.gather_spec("cpu")[1] is None  # the identity map drops


@pytest.mark.parametrize("exchange,residency", [("host", "closure"), ("collective", "exchange"),
                                                ("host", "exchange")])
def test_exchange_modes_and_residencies_bit_equal(setup, exchange, residency):
    """Host mode serves what the collective exchange serves, and the
    exchange residency (own rows plus a feature exchange, the split step)
    what the closure residency (the fused step) serves: rows and logs."""
    trace = zipfian_trace(N_NODES, 30, alpha=0.9, seed=11)
    ref = _port_dist(setup, 2)
    dist = _port_dist(setup, 2, exchange=exchange, feature_residency=residency)
    assert dist.exchange_mode == exchange
    assert np.array_equal(ref.predict(trace), dist.predict(trace))
    for h in (0, 1):
        for (a, n), (b, m) in zip(ref.engines[h].dispatch_log, dist.engines[h].dispatch_log):
            assert n == m and np.array_equal(a, b)
    assert (dist.stats.exchange_id_bytes == 0) == (exchange == "host")
    merged = dist.aggregate_stats()["shards_merged"]
    fused = residency == "closure"
    assert all((e._programs is not None) == fused for e in dist.engines.values())
    assert merged["execute_calls"] == (1 if fused else 2) * merged["dispatches"] > 0
    for h, eng in ref.engines.items():
        st = ref.shard_topo_stats[h]
        assert st["feature_closure_nodes"] >= st["closure_nodes"] >= st["owned_nodes"]
        assert eng._feature.resident_rows == st["feature_closure_nodes"]
    with pytest.raises(ValueError, match="feature_residency"):
        _port_dist(setup, 2, feature_residency="teleport")


def test_repeat_trace_hits_router_cache_without_routing(setup):
    dist = _port_dist(setup, 2)
    trace = zipfian_trace(N_NODES, 30, alpha=0.99, seed=11)
    out1 = dist.predict(trace)
    routed, xbytes = dist.stats.routed_seeds, dist.stats.exchange_id_bytes
    out2 = dist.predict(trace)
    assert np.array_equal(out1, out2)
    assert dist.stats.routed_seeds == routed and dist.stats.exchange_id_bytes == xbytes
    assert dist.stats.router_cache.hits >= len(trace)


def test_update_params_fences_router_and_owners(setup):
    dist = _port_dist(setup, 2)
    node = 17
    v0 = dist.predict([node])[0]
    dist.update_params({k: v + 0.25 for k, v in setup["tparams"].items()})
    assert dist.params_version == 1
    assert all(e.params_version == 1 for e in dist.engines.values())
    assert all(len(e.cache) == 0 for e in dist.engines.values()) and len(dist.cache) == 0
    v1 = dist.predict([node])[0]
    assert not np.array_equal(v0, v1)
    routed = dist.stats.routed_seeds
    assert np.array_equal(dist.predict([node])[0], v1) and dist.stats.routed_seeds == routed


def test_aggregate_stats_merges_owner_views(setup):
    dist = _port_dist(setup, 2)
    trace = zipfian_trace(N_NODES, 40, alpha=0.9, seed=5)
    dist.predict(trace)
    agg = dist.aggregate_stats()
    merged, per = agg["shards_merged"], agg["per_shard"]
    for name in ("dispatches", "requests", "dispatched_seeds", "execute_calls"):
        assert merged[name] == sum(s[name] for s in per.values()) > 0
    assert merged["latency"]["count"] == sum(s["latency"]["count"] for s in per.values())
    assert merged["cache"]["misses"] == sum(s["cache"]["misses"] for s in per.values())
    assert agg["router"]["latency"]["count"] == len(trace)
    assert agg["topology"].keys() == {0, 1} and 0 < agg["topology"][0]["edge_frac"] <= 1.0
    dist.reset_stats()
    assert dist.stats.requests == 0 and all(e.stats.requests == 0 for e in dist.engines.values())


def test_threaded_clients_match_replay_oracle(setup):
    dist = _port_dist(setup, 2, max_delay_ms=2.0, max_in_flight=2)
    dist.warmup()
    assert all(e.dispatch_log == [] for e in dist.engines.values())
    trace = zipfian_trace(N_NODES, 48, alpha=1.1, seed=13)
    results, errors = {}, []

    def client(tid):
        try:
            ids = trace[tid * 4: (tid + 1) * 4]
            results[tid] = (ids, dist.predict(ids, timeout=120))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    with dist:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    assert not errors and not any(t.is_alive() for t in threads)
    assert dist.stats.requests == len(trace)
    assert (dist.stats.router_cache.hits + dist.stats.coalesced + dist.stats.routed_seeds
            == len(trace))
    oracle = replay_shard_oracle(dist, _model(), setup["tparams"], _full_sampler, setup["feat"])
    for ids, out in results.values():
        for nid, row in zip(ids.tolist(), out):
            assert np.array_equal(row, oracle[nid])


@pytest.mark.parametrize("exchange", ["host", "collective"])
def test_owner_failure_fails_its_requests(setup, exchange):
    """Host mode: a failing owner resolves only its own sub-batch's slots
    with the error, the flush returns, and the other owner's rows are
    served (and cached). Collective mode: the exchange is one launch, so the
    whole flush fails with an OwnerAnswerError naming the owner."""
    from quiver_tpu_torch.comm import OwnerAnswerError

    dist = _port_dist(setup, 2, exchange=exchange, max_batch=64)

    def down(ids, *a, **k):
        raise KeyError("owner 1 down")

    dist.engines[1].predict = down
    nodes = [3, 150, 7, 160]  # owners 0, 1, 0, 1
    handles = dist.submit_many(nodes)
    if exchange == "host":
        assert dist.flush() == 4
        for h, node in zip(handles, nodes):
            if node < N_NODES // 2:
                assert h.result(timeout=10).shape == (5,)
            else:
                assert isinstance(h.error(), KeyError)
        assert dist.stats.request_errors == 2 and len(dist.cache) == 2
    else:
        with pytest.raises(OwnerAnswerError) as err:
            dist.flush()
        assert err.value.host == 1
        assert all(isinstance(h.error(), OwnerAnswerError) for h in handles)
        assert dist.stats.request_errors == 4 and len(dist.cache) == 0


# -- late admission at the router -----------------------------------------------------------

R_PRE = [40, 141]                          # 40 and 141 hit the router cache later
R_STALLED = [[0, 101, 2], [130, 31, 132]]  # owners 0 and 1 alike
R_WAITING = [10, 11, 112, 113, 14]         # 3 seeds of room to max_batch 8
# 20, 121, 122 join the waiting flush; repeats of 20, 11 and 101 coalesce;
# 23 waits; 141 hits the router cache
R_LATE = [20, 121, 20, 11, 101, 122, 23, 141]


def _submit(dist, reqs):
    return [dist.submit(int(n)) for n in reqs]


def _submit_many(dist, reqs):
    return list(dist.submit_many(reqs))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mif", [1, 2])
def test_gated_late_admission_matches_reference(setup, mif, batched):
    cfg = dict(max_batch=8, max_delay_ms=1e9, max_in_flight=mif, cache_entries=64,
               record_dispatches=True)
    jd = JDistServeEngine.build(setup["jmodel"], setup["params"], JCSRTopo(edge_index=EDGE_INDEX),
                                setup["feat"], SIZES, hosts=2, sampler_seed=SEED,
                                config=JDistServeConfig(hosts=2, **cfg))
    td = _port_dist(setup, 2, **cfg)
    assert td.config.late_admission and td.engines[0].config.late_admission
    rows = []
    for dist in (jd, td):
        dist.predict(R_PRE)
        hs = gated_late_run(dist, _submit, mif, R_STALLED, R_WAITING, R_LATE,
                            submit_late=_submit_many if batched else None)
        rows.append(np.stack([h.result(timeout=60) for h in hs]))
    flat = [[int(x) for x in a] for a, _ in td.dispatch_log]
    assert flat == [R_PRE, *R_STALLED[:mif], R_WAITING + [20, 121, 122], [23]]
    assert len(td.dispatch_log) == len(jd.dispatch_log)
    for (ta, tsplit), (ja, jsplit) in zip(td.dispatch_log, jd.dispatch_log):
        assert np.array_equal(ta, ja) and [h for h, _ in tsplit] == [h for h, _ in jsplit]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(tsplit, jsplit))
    for h in range(2):
        tlog, jlog = td.engines[h].dispatch_log, jd.engines[h].dispatch_log
        assert len(tlog) == len(jlog) > 0
        for (tp, tn), (jp, jn) in zip(tlog, jlog):
            assert tn == jn and np.array_equal(tp, jp)
        assert td.engines[h].stats.late_admitted == jd.engines[h].stats.late_admitted
    for name in ("requests", "coalesced", "late_admitted", "router_dispatches", "routed_seeds",
                 "sub_batch_seeds"):
        assert getattr(td.stats, name) == getattr(jd.stats, name), name
    assert td.stats.late_admitted == 3 and td.stats.coalesced == 3
    assert td.stats.snapshot()["late_admitted"] == 3
    assert td.stats.router_cache.hits == jd.stats.router_cache.hits == 1
    np.testing.assert_allclose(rows[1], rows[0], **TOL)
    oracle = replay_shard_oracle(td, _model(), setup["tparams"], _full_sampler, setup["feat"])
    requests = [n for b in R_STALLED[:mif] for n in b] + R_WAITING + R_LATE
    for node, row in zip(requests, rows[1]):
        assert np.array_equal(row, oracle[node]), node


@pytest.mark.parametrize("router_cache", [0, 64])
def test_router_submit_many_bit_equal_scalar_submits(setup, router_cache):
    """The router's batch admission routes as scalar submits, with its
    result cache off and on: router and owner logs and rows bit-equal."""
    trace = zipfian_trace(N_NODES, 40, alpha=0.9, seed=13)
    a, b = (_port_dist(setup, 2, router_cache_entries=router_cache) for _ in range(2))
    ha = _submit(a, trace)
    hb = [h for j in range(0, 40, 4) for h in b.submit_many(trace[j:j + 4])]
    for dist in (a, b):
        while dist.flush():
            pass
    assert np.array_equal(np.stack([h.result(60) for h in ha]),
                          np.stack([h.result(60) for h in hb]))
    assert len(a.dispatch_log) == len(b.dispatch_log) >= 3
    for (ra, sa), (rb, sb) in zip(a.dispatch_log, b.dispatch_log):
        assert np.array_equal(ra, rb) and len(sa) == len(sb)
        assert all(h0 == h1 and np.array_equal(i0, i1) for (h0, i0), (h1, i1) in zip(sa, sb))
    for h in range(2):
        for (p0, n0), (p1, n1) in zip(a.engines[h].dispatch_log, b.engines[h].dispatch_log):
            assert n0 == n1 and np.array_equal(p0, p1)
    assert (a.stats.requests, a.stats.coalesced) == (b.stats.requests, b.stats.coalesced)
    assert a.stats.coalesced > 0


@pytest.mark.parametrize("name,value,item", [
    ("tenant_weights", {"a": 1.0}, "A12"),
    ("journal_events", 64, "A12"), ("tier_prefetch", True, "A12"),
    ("replicate_top_k", 4, "A16"), ("hedge_deadline_ms", 5.0, "A16"),
    ("full_graph_fallback", True, "A16"), ("fault_injector", object(), "A16"),
    ("rebalance_every_s", 1.0, "A16"), ("streaming", True, "A14"),
])
def test_unported_config_fields_raise(name, value, item):
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP {item}"):
        DistServeConfig(**{name: value})
    DistServeConfig(sequential_legs=True)  # accepted: the legs run in turn either way


def test_build_refuses_without_a_card_unless_cpu_is_asked(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        DistServeEngine.build(_model(), setup["tparams"], CSRTopo(edge_index=EDGE_INDEX),
                              setup["feat"], SIZES, hosts=2)
    dist = _port_dist(setup, 2)
    assert all(e.device.type == "cpu" for e in dist.engines.values())
    assert dist.comm.device.type == "cpu"
    with pytest.raises(ValueError, match="outside"):
        dist.submit(N_NODES)

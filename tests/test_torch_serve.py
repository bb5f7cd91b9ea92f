"""The port's serving path against quiver_tpu's, at the tiny shapes of
tests/test_serve.py (200 nodes, 2,000 edges, DIM 16, sizes [4, 4],
sampler seed 3): both ServeEngines driven synchronously on one Zipf trace
under one deterministic clock must write equal dispatch logs, and serve
logits within atol = rtol = 1e-5 (XLA-CPU and torch-CPU sum in different
orders). Late admission under a gated trace (`torch_fixtures.
gated_late_run`: flushes held in their dispatch stage with every window
permit, a flush waiting for one, late seeds arriving) gives the JAX
engine's dispatch log and counts at max_in_flight 1 and 2, and rows
bit-equal to a late-off engine fed the same final batches; `submit_many`
writes the dispatch log of N scalar submits. Also: a threaded predict
smoke with replay parity, weight updates, warmup leaving the key stream
alone, the package's import isolation, and entry points refusing to run
without a card unless asked for the CPU; a same-shaped rebind while a
flush is held in its dispatch stage leaves that flush on the old table.
The cuda-marked tests run the gated trace on the card and the captured
serve step (one CUDA graph a bucket): replays at every bucket bit-equal
to the eager step on the same key for the tiled, flat, weighted and
temporal samplers, two threads flushing one bucket's graph at once, a
weight update that captures nothing anew and equals a fresh engine, a
post-seal miss, and a rebind during an in-flight flush (`python -m pytest
--noconftest -m cuda tests/test_torch_serve.py`; this file imports
without JAX there)."""

import subprocess
import sys
import threading

import numpy as np
import pytest

import torch

from quiver_tpu_torch import (
    CSRTopo,
    GraphSAGE,
    GraphSageSampler,
    ServeConfig,
    ServeEngine,
    sage_params_from_flax,
)
from quiver_tpu_torch import Feature, _kernels
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.examples import reddit_sage
from quiver_tpu_torch.inference import (
    batch_logits,
    bind_params,
    full_mean_aggregate,
    full_mean_aggregate_plain,
    make_serve_step,
    make_temporal_serve_step,
)
from quiver_tpu_torch.shard_tensor import ShardTensor
from quiver_tpu_torch.serve import default_buckets, zipfian_trace
from quiver_tpu_torch.utils import resolve_device

from torch_fixtures import DispatchGate, cuda_device, gated_late_run  # noqa: F401 (a fixture)

try:
    import jax
    import jax.numpy as jnp

    from quiver_tpu import CSRTopo as JCSRTopo
    from quiver_tpu.models import GraphSAGE as JGraphSAGE
    from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
    from quiver_tpu.serve import ServeConfig as JServeConfig
    from quiver_tpu.serve import ServeEngine as JServeEngine
    from quiver_tpu.serve import zipfian_trace as jzipf
    from conftest import make_random_graph
except ImportError:  # the card's machine has no JAX: only the cuda tests run there
    jax = None

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED = 200, 16, [4, 4], 3
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
    edge_index = make_random_graph(N_NODES, 2000, seed=0)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    js = JSampler(JCSRTopo(edge_index=edge_index), sizes=SIZES, mode="TPU", seed=SEED)
    ds0 = js.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return dict(feat=feat, edge_index=edge_index, jmodel=jmodel, params=params,
                tparams=tparams)


def _port_sampler(s):
    return GraphSageSampler(CSRTopo(edge_index=s["edge_index"]), SIZES, mode="TPU",
                            seed=SEED, device="cpu")


def _port_engine(s, **cfg):
    cfg.setdefault("record_dispatches", True)
    return ServeEngine(GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0), s["tparams"],
                       _port_sampler(s), s["feat"], ServeConfig(**cfg))


def _drive(engine, clock, trace):
    """Submit one request per clock tick, pump the flush policy after each,
    force a flush every 9 requests, drain at the end."""
    handles = []
    for i, node in enumerate(trace.tolist()):
        clock.t += 0.001
        handles.append(engine.submit(node))
        engine.pump()
        if i % 9 == 8:
            engine.flush()
    while engine.flush():
        pass
    return np.stack([h.result(timeout=30) for h in handles])


def test_zipfian_trace_matches_reference():
    assert np.array_equal(zipfian_trace(1000, 500, seed=7), jzipf(1000, 500, seed=7))
    assert default_buckets(6) == (1, 2, 4, 6)


def test_engine_dispatch_log_and_logits_match_reference(setup):
    s = setup
    trace = zipfian_trace(N_NODES, 90, alpha=0.99, seed=5)
    cfg = dict(max_batch=8, max_delay_ms=2.5, cache_entries=16, record_dispatches=True)
    jclock, tclock = ManualClock(), ManualClock()
    jeng = JServeEngine(s["jmodel"], s["params"],
                        JSampler(JCSRTopo(edge_index=s["edge_index"]), sizes=SIZES,
                                 mode="TPU", seed=SEED),
                        s["feat"], JServeConfig(clock=jclock, **cfg))
    teng = _port_engine(s, clock=tclock, **cfg)
    want = _drive(jeng, jclock, trace)
    got = _drive(teng, tclock, trace)
    assert len(jeng.dispatch_log) == len(teng.dispatch_log) > 5
    for (jp, jn), (tp, tn) in zip(jeng.dispatch_log, teng.dispatch_log):
        assert jn == tn and jp.dtype == tp.dtype and np.array_equal(jp, tp)
    for field in ("requests", "coalesced", "dispatches", "dispatched_seeds", "padded_seeds"):
        assert getattr(jeng.stats, field) == getattr(teng.stats, field), field
    assert jeng.stats.cache.hits == teng.stats.cache.hits > 0
    assert jeng.stats.dispatch_buckets == teng.stats.dispatch_buckets
    np.testing.assert_allclose(got, want, **TOL)


def _replay(s, engine):
    """node -> logits row, replaying the dispatch log through a fresh
    sampler on the split path."""
    model = bind_params(GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0), s["tparams"])
    sampler = _port_sampler(s)
    served = {}
    for padded, nvalid in engine.dispatch_log:
        logits = batch_logits(model, sampler, s["feat"], padded).numpy()
        for i in range(nvalid):
            served.setdefault(int(padded[i]), logits[i])
    return served


def test_threaded_predict_smoke_replays_bit_equal(setup):
    eng = _port_engine(setup, max_batch=8, max_delay_ms=1.0, max_in_flight=2)
    eng.warmup()
    assert eng.dispatch_log == [] and eng._sampler._call == 0  # no key consumed
    trace = zipfian_trace(N_NODES, 96, seed=9)
    out = {}

    def client(chunk):
        for j in range(0, len(chunk), 3):
            rows = eng.predict(chunk[j:j + 3], timeout=60)
            for node, row in zip(chunk[j:j + 3].tolist(), rows):
                out.setdefault(node, []).append(row)

    with eng:
        threads = [threading.Thread(target=client, args=(c,)) for c in np.array_split(trace, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert eng.stats.requests == 96 and eng.stats.dispatches == len(eng.dispatch_log)
    assert eng.stats.coalesced + eng.stats.cache.hits + eng.stats.dispatched_seeds >= 96
    oracle = _replay(setup, eng)
    for node, rows in out.items():
        for row in rows:
            assert np.array_equal(row, oracle[node])


def test_update_params_invalidates_and_recomputes(setup):
    eng = _port_engine(setup, max_batch=4)
    before = eng.predict([3, 4, 5])
    assert eng.stats.dispatches == 1 and len(eng.cache) == 3
    row = eng.submit(3).result()  # a cache hit: the shared, read-only row
    assert eng.stats.cache.hits == 1 and not row.flags.writeable
    scaled = {k: v * 2 for k, v in setup["tparams"].items()}
    eng.update_params(scaled)
    assert eng.params_version == 1 and len(eng.cache) == 0
    after = eng.predict([3, 4, 5])
    assert eng.stats.dispatches == 2 and not np.allclose(before, after)


def test_split_and_fused_engines_bit_equal_and_sealed_buckets(setup):
    fused = _port_engine(setup, max_batch=4, dispatch_mode="fused")
    split = _port_engine(setup, max_batch=4, dispatch_mode="split")
    fused.warmup(buckets=[4])
    split.warmup()
    nodes = [7, 8, 9, 10, 11, 12, 13, 14, 7]
    assert np.array_equal(fused.predict(nodes), split.predict(nodes))
    assert fused.stats.execute_calls == fused.stats.dispatches
    assert split.stats.execute_calls == 2 * split.stats.dispatches
    with pytest.raises(RuntimeError):
        fused.predict([50])  # bucket 1 was never warmed
    with pytest.raises(ValueError):
        _port_engine(setup, dispatch_mode="fast")


def test_split_warmup_twin_shares_graph_and_leaves_keys(setup):
    eng = _port_engine(setup, max_batch=4, dispatch_mode="split")
    eng._sampler.next_key()  # the twin's stream starts at call 0 all the same
    twin = eng._warmup_sampler()
    assert twin._call == 0 and eng._sampler._call == 1
    assert all(a is b for a, b in zip(twin._graph, eng._sampler._graph))
    eng.warmup()
    assert eng._sampler._call == 1 and eng.dispatch_log == []


def test_import_loads_no_jax_or_reference_package():
    code = (
        "import sys; before = set(sys.modules); import quiver_tpu_torch.serve.engine, "
        "quiver_tpu_torch.datasets, quiver_tpu_torch.convert, quiver_tpu_torch.shard_tensor, "
        "quiver_tpu_torch.feature, quiver_tpu_torch.inference, "
        "quiver_tpu_torch.examples.reddit_sage, quiver_tpu_torch.pipeline, "
        "quiver_tpu_torch.checkpoint, quiver_tpu_torch.quant, quiver_tpu_torch.tiers, "
        "quiver_tpu_torch.partition, quiver_tpu_torch.workloads, quiver_tpu_torch.models.gcn, "
        "quiver_tpu_torch.models.gat, quiver_tpu_torch.ops.gather_src, "
        "quiver_tpu_torch.comm, quiver_tpu_torch.serve.dist, "
        "quiver_tpu_torch.multiprocessing, quiver_tpu_torch.multiprocessing.reductions; "
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'quiver_tpu', 'quiver')); print(repr(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_refuse_without_a_card_unless_cpu_is_asked(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = CSRTopo(edge_index=setup["edge_index"])
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        GraphSageSampler(topo, SIZES)
    with pytest.raises(RuntimeError):
        topo.to_device()
    with pytest.raises(RuntimeError):
        Feature()
    with pytest.raises(RuntimeError):
        ShardTensor()
    with pytest.raises(RuntimeError):
        reddit_sage.main(["--nodes", "300", "--epochs", "1"])
    assert GraphSageSampler(topo, SIZES, device="cpu").device.type == "cpu"
    assert Feature(device="cpu").device.type == "cpu"
    # full_mean_aggregate has no device of its own: it follows its inputs,
    # and on CPU tensors it takes the plain version and launches nothing
    indptr, indices = topo.to_device("cpu")
    h = torch.from_numpy(np.random.default_rng(SEED).standard_normal((N_NODES, 4),
                                                                     dtype=np.float32))
    before = _kernels.counts()["full_mean"]
    out = full_mean_aggregate(indptr, indices, h)
    assert torch.equal(out, full_mean_aggregate_plain(indptr, indices, h))
    assert _kernels.counts()["full_mean"] == before


# -- late admission -------------------------------------------------------------------

STALLED = [[0, 1, 2], [30, 31, 32]]  # the flushes held with a window permit each
WAITING = [10, 11, 12, 13, 14]       # drained into bucket 8: 3 lanes of slack
PRE = [40, 41]                       # served first: 40 is a cache hit later
# 20, 21, 22 fill the slack; a repeat of 20, of a waiting seed (11) and of
# a held one (1) coalesce; 23 finds no slack and waits; 40 hits the cache
LATE = [20, 21, 20, 11, 1, 22, 23, 40]


def _submit(eng, reqs):
    return [eng.submit(int(n)) for n in reqs]


def _submit_many(eng, reqs):
    return list(eng.submit_many(reqs))


def _late_off_rows(make_engine, log, batch_of, submit_batch):
    """{key: row} from a late-admission-off engine fed ``log``'s final
    batches one flush each, and its dispatch log."""
    ref = make_engine()
    rows = {}
    for entry in log:
        keys = batch_of(entry)
        hs = submit_batch(ref, entry)
        ref.flush()
        for k, h in zip(keys, hs):
            rows[k] = h.result(timeout=60)
    assert ref.stats.late_admitted == 0
    return rows, ref.dispatch_log


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mif", [1, 2])
def test_gated_late_admission_matches_reference(setup, mif, batched):
    s = setup
    cfg = dict(max_batch=8, max_delay_ms=1e9, max_in_flight=mif, cache_entries=64,
               record_dispatches=True)
    jeng = JServeEngine(s["jmodel"], s["params"],
                        JSampler(JCSRTopo(edge_index=s["edge_index"]), sizes=SIZES, mode="TPU",
                                 seed=SEED), s["feat"], JServeConfig(**cfg))
    teng = _port_engine(s, **cfg)
    assert teng.config.late_admission and teng.config.submit_stripes == 8
    rows = []
    for eng in (jeng, teng):
        eng.predict(PRE)
        hs = gated_late_run(eng, _submit, mif, STALLED, WAITING, LATE,
                            submit_late=_submit_many if batched else None)
        rows.append(np.stack([h.result(timeout=60) for h in hs]))
    flat = [[int(x) for x in p[:n]] for p, n in teng.dispatch_log]
    assert flat == [PRE, *STALLED[:mif], WAITING + [20, 21, 22], [23]]
    assert len(jeng.dispatch_log) == len(teng.dispatch_log)
    for (jp, jn), (tp, tn) in zip(jeng.dispatch_log, teng.dispatch_log):
        assert jn == tn and np.array_equal(jp, tp)
    for field in ("requests", "coalesced", "late_admitted", "dispatches", "dispatched_seeds",
                  "padded_seeds"):
        assert getattr(jeng.stats, field) == getattr(teng.stats, field), field
    assert teng.stats.late_admitted == 3 and teng.stats.coalesced == 3
    assert jeng.stats.cache.hits == teng.stats.cache.hits == 1
    assert teng.stats.snapshot()["late_admitted"] == 3
    np.testing.assert_allclose(rows[1], rows[0], **TOL)
    # bit-equal to a late-off engine fed the same final batches
    ref_rows, ref_log = _late_off_rows(
        lambda: _port_engine(s, max_batch=8, max_delay_ms=1e9, cache_entries=64,
                             late_admission=False),
        teng.dispatch_log, lambda e: [int(x) for x in e[0][:e[1]]],
        lambda eng, e: _submit_many(eng, e[0][:e[1]]))
    assert all(np.array_equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(ref_log, teng.dispatch_log))
    requests = [n for b in STALLED[:mif] for n in b] + WAITING + LATE
    assert len(requests) == rows[1].shape[0]
    for node, row in zip(requests, rows[1]):
        assert np.array_equal(row, ref_rows[node]), node


@pytest.mark.parametrize("chunk", [48, 4])
@pytest.mark.parametrize("cache", [0, 64])
@pytest.mark.parametrize("late", [True, False])
def test_submit_many_dispatch_log_bit_equal_scalar_submits(setup, late, cache, chunk):
    """One `submit_many` a chunk (inline fills mid-chunk where a chunk
    overruns ``max_batch``) against the same ids through scalar `submit`:
    rows, dispatch log and counts bit-equal."""
    trace = zipfian_trace(N_NODES, 48, alpha=0.9, seed=11)
    cfg = dict(max_batch=8, max_delay_ms=1e9, late_admission=late, cache_entries=cache)
    a, b = _port_engine(setup, **cfg), _port_engine(setup, **cfg)
    ha = _submit(a, trace)
    hb = [h for j in range(0, len(trace), chunk) for h in b.submit_many(trace[j:j + chunk])]
    for eng in (a, b):
        while eng.flush():
            pass
    assert np.array_equal(np.stack([h.result(30) for h in ha]),
                          np.stack([h.result(30) for h in hb]))
    assert len(a.dispatch_log) == len(b.dispatch_log) > 3
    for (pa, na), (pb, nb) in zip(a.dispatch_log, b.dispatch_log):
        assert na == nb and np.array_equal(pa, pb)
    for field in ("requests", "coalesced", "late_admitted", "dispatches"):
        assert getattr(a.stats, field) == getattr(b.stats, field), field
    assert (a.stats.cache.hits, a.stats.cache.misses) == (b.stats.cache.hits, b.stats.cache.misses)
    assert a.stats.coalesced > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mif", [1, 2])
def test_gated_late_admission_on_the_card_replays_bit_equal(cuda_device, mif):
    """The gated trace on the card (fused step: K1, K2, K3, K4): three
    seeds ride the waiting flush's pad lanes, and every served row is
    bit-equal to a late-off engine fed the same final batches."""
    rng = np.random.default_rng(0)
    edge_index = np.stack([rng.integers(0, N_NODES, 2000), rng.integers(0, N_NODES, 2000)])
    feat = torch.from_numpy(rng.standard_normal((N_NODES, DIM)).astype(np.float32))
    torch.manual_seed(0)
    model = GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    topo = CSRTopo(edge_index=edge_index)

    def engine(**cfg):
        return ServeEngine(model, params, GraphSageSampler(topo, SIZES, seed=SEED,
                                                           device=cuda_device),
                           feat.to(cuda_device),
                           ServeConfig(max_batch=8, max_delay_ms=1e9, cache_entries=64,
                                       record_dispatches=True, **cfg))

    eng = engine(max_in_flight=mif)
    eng.warmup()
    eng.predict(PRE)
    hs = gated_late_run(eng, _submit, mif, STALLED, WAITING, LATE)
    assert eng.stats.late_admitted == 3 and eng.stats.coalesced == 3
    assert [[int(x) for x in p[:n]] for p, n in eng.dispatch_log][-2:] == \
        [WAITING + [20, 21, 22], [23]]
    ref_rows, ref_log = _late_off_rows(
        lambda: engine(late_admission=False), eng.dispatch_log,
        lambda e: [int(x) for x in e[0][:e[1]]], lambda r, e: _submit_many(r, e[0][:e[1]]))
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(ref_log, eng.dispatch_log))
    requests = [n for b in STALLED[:mif] for n in b] + WAITING + LATE
    for node, h in zip(requests, hs):
        assert np.array_equal(h.result(timeout=60), ref_rows[node]), node


# -- the captured serve step: bindings, weights, concurrency -------------------------


def _rebind_in_flight(eng, table2, submit_nodes):
    """Hold one flush of ``submit_nodes`` in its dispatch stage (sealed: its
    key drawn, its `binding()` recorded), rebind the programs to the
    same-shaped ``table2`` meanwhile, then let it run; a second flush of the
    same nodes runs after. Returns both flushes' rows."""
    gate = DispatchGate(eng)
    hs = [eng.submit(int(n)) for n in submit_nodes]
    t = threading.Thread(target=eng.flush, daemon=True)
    t.start()
    gate.wait_arrived(1)
    eng._programs.rebind(table=table2)
    gate.release()
    t.join(timeout=60)
    held = np.stack([h.result(timeout=60) for h in hs])
    gate.open()
    eng.cache.invalidate()
    after = eng.predict(list(submit_nodes))
    return held, after


def _replayed(engine_of, log, table):
    """Rows of a fresh engine over ``table`` fed each logged batch in turn:
    the dispatch-index key stream replayed."""
    ref = engine_of(table)
    out = []
    for padded, n in log:
        out.append(ref.predict([int(x) for x in padded[:n]]))
        ref.cache.invalidate()
    return out


def test_rebind_during_an_in_flight_flush_keeps_its_binding(setup):
    """The flush sealed before a same-shaped rebind runs against the old
    table; the next one against the new (the CPU eager path; the card test
    below runs the captured graphs)."""
    s = setup
    table2 = torch.from_numpy((s["feat"] * 3.0 - 1.0).astype(np.float32))

    def engine_of(table):
        return ServeEngine(GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0), s["tparams"],
                           _port_sampler(s), table,
                           ServeConfig(max_batch=8, max_delay_ms=1e9, record_dispatches=True))

    eng = engine_of(torch.from_numpy(s["feat"]))
    eng.warmup()
    held, after = _rebind_in_flight(eng, table2, [3, 14, 15, 92, 65])
    old, _ = _replayed(engine_of, eng.dispatch_log, torch.from_numpy(s["feat"]))
    _, new = _replayed(engine_of, eng.dispatch_log, table2)
    assert np.array_equal(held, old) and np.array_equal(after, new)
    assert not np.allclose(held, after)


def _card_engine(kind, dev, **cfg):
    """A small engine on the card: the tiled (dedup), flat (no dedup),
    weighted (tiled, dedup) or temporal sampler over a random graph."""
    rng = np.random.default_rng(0)
    edge_index = np.stack([rng.integers(0, N_NODES, 2000), rng.integers(0, N_NODES, 2000)])
    weights = rng.uniform(0.0, 1.0, 2000).astype(np.float32)
    feat = torch.from_numpy(rng.standard_normal((N_NODES, DIM)).astype(np.float32))
    torch.manual_seed(0)
    model = GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    topo = CSRTopo(edge_index=edge_index, edge_weights=weights if kind == "weighted" else None)
    sampler = GraphSageSampler(topo, SIZES, seed=SEED, device=dev,
                               layout="flat" if kind == "flat" else "tiled",
                               dedup=kind in ("tiled", "weighted"), weighted=kind == "weighted")
    config = ServeConfig(**{**dict(max_batch=8, max_delay_ms=1e9, record_dispatches=True),
                            **cfg})
    if kind == "temporal":
        from quiver_tpu_torch.workloads import TemporalServeEngine, TemporalTiledGraph

        ts = rng.uniform(0.0, 50.0, topo.edge_count).astype(np.float32)
        sampler.bind_temporal(TemporalTiledGraph(topo, ts, device=dev), recency=0.02)
        return TemporalServeEngine(model, params, sampler, feat.to(dev), config)
    return ServeEngine(model, params, sampler, feat.to(dev), config)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiled", "flat", "weighted", "temporal"])
def test_captured_replays_equal_the_eager_step_at_every_bucket(cuda_device, kind):
    """Each warmed bucket's graph, replayed with fresh keys and seeds, is
    bit-equal to the same step run eagerly (by-value keys) on the same key;
    the replays launch the draws' device-key forms, counted as replays x
    the graph's launches."""
    eng = _card_engine(kind, cuda_device)
    eng.warmup()
    progs = eng._programs
    assert progs.sealed and progs.buckets == default_buckets(8)
    temporal = kind == "temporal"
    step = (make_temporal_serve_step if temporal else make_serve_step)(eng._sampler)[0]
    table, index_map, graph = progs.binding()
    rng = np.random.default_rng(1)
    progs.reset_replays()
    for b in default_buckets(8) * 2:
        key = eng._sampler.next_key()
        seeds = rng.integers(0, N_NODES, b)
        extra = (rng.uniform(10.0, 60.0, b).astype(np.float32),) if temporal else ()
        got = progs(b, eng._model, key, seeds, *extra)
        with torch.inference_mode():
            want = step(eng._model, key, eng._sampler.as_seeds(seeds), table, index_map, graph,
                        *(torch.from_numpy(e).to(cuda_device) for e in extra))
        assert np.array_equal(got, want.cpu().numpy()), (kind, b)
    stats = progs.graph_stats()
    assert stats["graphs"] == len(default_buckets(8)) == stats["captured"]
    assert stats["replays"] == 2 * len(default_buckets(8)) and stats["pool_bytes"] > 0
    assert all(k > 0 for k in stats["kernels"].values())
    draw = {"tiled": "sample_tiled", "flat": "sample_flat", "weighted": "weighted_sample_tiled",
            "temporal": "temporal_sample_tiled"}[kind]
    launches = progs.replayed_launches()
    assert launches[draw] == launches[f"{draw}/device_key"] == stats["replays"] * len(SIZES)


@pytest.mark.cuda
def test_two_threads_flushing_one_bucket_each_get_their_own_rows(cuda_device):
    """max_in_flight=2, two clients flushing full buckets of distinct ids
    at once through the one graph of bucket 8: every row equals the split
    path's replay of its own dispatch."""
    eng = _card_engine("tiled", cuda_device, max_in_flight=2, cache_entries=0)
    eng.warmup()
    out = {}

    def client(ids):
        for j in range(0, len(ids), 8):
            for node, row in zip(ids[j:j + 8], eng.predict(ids[j:j + 8], timeout=60)):
                out[int(node)] = row

    ids = np.random.default_rng(2).permutation(N_NODES)[:160]
    threads = [threading.Thread(target=client, args=(c,)) for c in (ids[:80], ids[80:])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(out) == 160
    assert set(eng.stats.dispatch_buckets) == {8}
    sampler = GraphSageSampler(eng._sampler.csr_topo, SIZES, seed=SEED, device=cuda_device)
    for padded, n in eng.dispatch_log:
        rows = batch_logits(eng._model, sampler, eng._feature, padded).cpu().numpy()
        for i in range(n):
            assert np.array_equal(out[int(padded[i])], rows[i])
    # the bucket's graph called from two threads at once, 40 calls each
    progs, step = eng._programs, make_serve_step(eng._sampler)[0]
    table, index_map, graph = progs.binding()
    calls = [[(qrandom.fold_in(qrandom.key(t), i), np.random.default_rng(10 * t + i)
               .integers(0, N_NODES, 8)) for i in range(40)] for t in (1, 2)]
    got = [[None] * 40, [None] * 40]

    def caller(t):
        for i, (key, seeds) in enumerate(calls[t]):
            got[t][i] = progs(8, eng._model, key, seeds)

    threads = [threading.Thread(target=caller, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    with torch.inference_mode():
        for t in (0, 1):
            for (key, seeds), row in zip(calls[t], got[t]):
                want = step(eng._model, key, eng._sampler.as_seeds(seeds), table, index_map,
                            graph)
                assert np.array_equal(row, want.cpu().numpy())


@pytest.mark.cuda
def test_update_params_keeps_the_graphs_and_equals_a_fresh_engine(cuda_device):
    eng = _card_engine("tiled", cuda_device)
    eng.warmup()
    captured = eng._programs.graph_stats()["captured"]
    nodes = [3, 4, 5, 6, 7]
    before = eng.predict(nodes)
    scaled = {k: v * 2 for k, v in eng._model.state_dict().items()}
    eng.update_params(scaled)
    after = eng.predict(nodes)
    assert eng._programs.graph_stats()["captured"] == captured
    fresh = _card_engine("tiled", cuda_device)
    fresh.update_params(scaled)
    fresh.warmup()
    fresh._sampler.next_key()  # the updated engine served one flush first
    assert np.array_equal(after, fresh.predict(nodes)) and not np.allclose(before, after)


@pytest.mark.cuda
def test_a_post_seal_miss_raises_on_the_card(cuda_device):
    eng = _card_engine("tiled", cuda_device, buckets=(4, 8))
    eng.warmup(buckets=[8])
    assert eng._programs.sealed and eng._programs.buckets == (8,)
    with pytest.raises(RuntimeError):
        eng.predict([1, 2, 3])  # bucket 4 was never captured


@pytest.mark.cuda
def test_rebind_during_an_in_flight_flush_keeps_its_graph_on_the_card(cuda_device):
    """The held flush replays the graphs captured against the old table;
    the rebind captured every warmed bucket anew against the new one."""
    eng = _card_engine("tiled", cuda_device)
    eng.warmup()
    table = eng._programs.binding()[0]
    table2 = table * 3.0 - 1.0
    captured = eng._programs.graph_stats()["captured"]
    held, after = _rebind_in_flight(eng, table2, [3, 14, 15, 92, 65])
    assert eng._programs.graph_stats()["captured"] == captured + len(default_buckets(8))
    old, _ = _replayed(lambda t: _card_engine_over(eng, t), eng.dispatch_log, table)
    _, new = _replayed(lambda t: _card_engine_over(eng, t), eng.dispatch_log, table2)
    assert np.array_equal(held, old) and np.array_equal(after, new)


def _card_engine_over(eng, table):
    """A split-path twin of ``eng`` over ``table``: a fresh sampler of the
    same seed and the same weights."""
    sampler = GraphSageSampler(eng._sampler.csr_topo, SIZES, seed=SEED, device=eng.device)
    return ServeEngine(eng._model, None, sampler, table,
                       ServeConfig(max_batch=8, max_delay_ms=1e9, dispatch_mode="split"))

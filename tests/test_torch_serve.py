"""The port's serving path against quiver_tpu's, at the tiny shapes of
tests/test_serve.py (200 nodes, 2,000 edges, DIM 16, sizes [4, 4],
sampler seed 3): both ServeEngines driven synchronously on one Zipf trace
under one deterministic clock must write equal dispatch logs, and serve
logits within atol = rtol = 1e-5 (XLA-CPU and torch-CPU sum in different
orders). Also: a threaded predict smoke with replay parity, weight
updates, warmup leaving the key stream alone, the package's import
isolation, and entry points refusing to run without a card unless asked
for the CPU."""

import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import ServeConfig as JServeConfig
from quiver_tpu.serve import ServeEngine as JServeEngine
from quiver_tpu.serve import zipfian_trace as jzipf
from quiver_tpu_torch import (
    CSRTopo,
    GraphSAGE,
    GraphSageSampler,
    ServeConfig,
    ServeEngine,
    sage_params_from_flax,
)
from quiver_tpu_torch.inference import batch_logits, bind_params
from quiver_tpu_torch.serve import default_buckets, zipfian_trace
from quiver_tpu_torch.utils import resolve_device

from conftest import make_random_graph

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
        "quiver_tpu_torch.datasets, quiver_tpu_torch.convert; "
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
    assert GraphSageSampler(topo, SIZES, device="cpu").device.type == "cpu"

"""Parity of the port's staged tiered train pipeline with quiver_tpu's, on
the CPU: `tiered_lookup` (K5's plain version), `TieredFeaturePipeline`'s
host staging, `TrainPipeline` (loss curve, depth, spans, the mid-epoch
error contract, checkpoint and resume), `AsyncReadPool`, `PipelineStats`,
the trace helpers it uses and `CheckpointManager`.

Shapes: the community graph of tests/test_pipeline.py (160 nodes, DIM 16,
half the table on the device), sizes [5, 5], batches of 32. Inputs come
from seeded numpy and go through both packages. Bars:
- staged ids, slots and rows (``mapped``, ``rows``, ``pos``) and the
  looked-up rows bit-equal;
- a 12-batch Adam loss curve (dropout 0, the JAX model's weights carried
  by ``sage_params_from_flax``) within 1e-4 of the JAX pipeline's: torch
  and XLA sum in different orders and Adam divides by sqrt(v), so the
  curves drift apart slowly (the bar of tests/test_torch_train.py);
- depth 2 equal to depth 1 exactly (same draws, same arithmetic)."""

import json
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import Feature as JFeature
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pipeline import AsyncReadPool as JAsyncReadPool
from quiver_tpu.pipeline import TieredFeaturePipeline as JTieredFeaturePipeline
from quiver_tpu.pipeline import TrainPipeline as JTrainPipeline
from quiver_tpu.pipeline import make_tiered_train_step as j_make_step
from quiver_tpu.pipeline import tiered_lookup as j_tiered_lookup
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch import trace
from quiver_tpu_torch.checkpoint import (
    CheckpointManager,
    load_partition_artifacts,
    save_partition_artifacts,
)
from quiver_tpu_torch.pipeline import (
    AsyncReadPool,
    PipelineStats,
    TieredFeaturePipeline,
    TrainPipeline,
    make_tiered_train_step,
    tiered_lookup,
    tiered_lookup_plain,
)
from quiver_tpu_torch.utils import round_up_pow2

from test_pipeline import community_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

SIZES, BATCH, LR = [5, 5], 32, 5e-3


def _features(reorder=True, frac=0.5):
    edge_index, feat, labels, n = community_graph()
    budget = int(n * frac) * feat.shape[1] * 4
    jf = JFeature(rank=0, device_list=[0], device_cache_size=budget,
                  csr_topo=JCSRTopo(edge_index=edge_index) if reorder else None)
    jf.from_cpu_tensor(feat)
    tf = Feature(rank=0, device_list=[0], device_cache_size=budget,
                 csr_topo=CSRTopo(edge_index=edge_index) if reorder else None, device="cpu")
    tf.from_cpu_tensor(feat)
    return edge_index, feat, labels, n, jf, tf


def _batches(n, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, BATCH).astype(np.int64) for _ in range(count)]


# -- the lookup and the staging ----------------------------------------------------

def test_round_up_pow2_matches_reference():
    from quiver_tpu.comm import round_up_pow2 as j_round_up_pow2

    for n in (0, 1, 16, 17, 255, 256, 257, 100_000):
        assert round_up_pow2(n) == j_round_up_pow2(n)
        assert round_up_pow2(n, floor=256) == j_round_up_pow2(n, floor=256)


def test_tiered_lookup_matches_reference():
    """tests/test_pipeline.py's dense case: hot lanes, cold lanes, ids -5
    and 200 (invalid), a padded bucket with slot W."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((100, 8)).astype(np.float32)
    ids = np.array([3, 77, 59, 60, 99, -5, 200, 0], np.int64)
    W = ids.shape[0]
    mapped = np.where((ids < 0) | (ids >= 100), -1, ids).astype(np.int32)
    cold_sel = np.nonzero(mapped >= 60)[0]
    pos = np.full(4, W, np.int32)
    pos[: cold_sel.size] = cold_sel
    rows = np.zeros((4, 8), np.float32)
    rows[: cold_sel.size] = table[mapped[cold_sel]]
    want = np.asarray(j_tiered_lookup(jnp.asarray(table[:60]), jnp.asarray(mapped),
                                      jnp.asarray(rows), jnp.asarray(pos)))
    args = [torch.from_numpy(a) for a in (table[:60], mapped, rows, pos)]
    got = tiered_lookup(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tiered_lookup_plain(*args))
    empty = tiered_lookup(args[0], args[1], torch.zeros((0, 8)), torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(j_tiered_lookup(
        jnp.asarray(table[:60]), jnp.asarray(mapped), jnp.zeros((0, 8)), jnp.zeros(0, jnp.int32))))


@pytest.mark.parametrize("reorder", [True, False])
def test_prepare_host_bit_equal_and_lookup_matches_feature(reorder):
    _, feat, _, n, jf, tf = _features(reorder)
    jp, tp = JTieredFeaturePipeline(jf), TieredFeaturePipeline(tf)
    assert tp.hot_rows == jp.hot_rows and tp.cold_np is not None
    ids = np.array([0, 5, n - 1, n // 2, 3, 3, n + 7, -1, -5, 77, 120, 150], np.int64)
    for vc in (None, 10):
        want, got = jp.prepare_host(ids, valid_count=vc), tp.prepare_host(ids, valid_count=vc)
        np.testing.assert_array_equal(got.mapped.numpy(), want.mapped)
        assert got.mapped.dtype == torch.int32
        np.testing.assert_array_equal(got.pos.numpy(), want.pos)
        np.testing.assert_array_equal(got.rows.numpy(), want.rows)
        assert got.rows.shape[0] == round_up_pow2(int((want.mapped >= jp.hot_rows).sum()), 256)
    assert (tp.rows_seen, tp.cold_rows_seen) == (jp.rows_seen, jp.cold_rows_seen)
    out = tiered_lookup(tp.hot_table, *tp.prepare(torch.from_numpy(ids)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jf[ids]))
    np.testing.assert_array_equal(out.numpy(), tf[ids].numpy())
    # a hot-only batch stages no cold rows at all
    hot_only = tp.prepare_host(np.asarray(tf.node_ids_of_stored(np.arange(4))))
    assert hot_only.rows is None and hot_only.pos is None


def test_fully_resident_pipeline_and_refusals():
    _, feat, _, n, _, tf = _features(frac=1.0)
    tp = TieredFeaturePipeline(tf)
    assert tp.cold_np is None and tp.hot_rows == n
    mapped, cold_rows, cold_pos = tp.prepare(np.array([1, -1, n]))
    assert mapped.tolist() == [int(tf.feature_order[1]), -1, -1]
    assert cold_rows.shape == (0, feat.shape[1]) and cold_pos.shape == (0,)
    assert tp.prefetch(np.arange(3)) == 0 and tp.cancel_prefetch() == 0
    assert tp.prefetch_stats == {}
    # flush-ahead prefetch serves a disk tier; on an all-DRAM store it is
    # inert, as in the reference
    inert = TieredFeaturePipeline(tf, prefetch=True)
    assert inert.mode == "dram" and inert.prefetch(np.arange(3)) == 0
    assert inert.prefetch_stats == {}
    with pytest.raises(ValueError, match="not built"):
        TieredFeaturePipeline(Feature(device="cpu"))
    with pytest.raises(NotImplementedError, match="A12"):
        PipelineStats().register_metrics()


# -- the train pipeline ------------------------------------------------------------

def _jax_run(edge_index, feat, labels, n, jf, batches, depth=1, seed=1):
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=4, num_layers=2, dropout=0.0)
    tx = optax.adam(LR)
    pipe = JTieredFeaturePipeline(jf)
    step_fn = j_make_step(jmodel, tx, jnp.asarray(labels), pipe.hot_table)
    topo = JCSRTopo(edge_index=edge_index)
    boot = JSampler(topo, sizes=SIZES, mode="TPU", seed=99)
    ds0 = boot.sample_dense(batches[0])
    x0 = jnp.zeros((ds0.n_id.shape[0], feat.shape[1]), jnp.float32)
    params = jmodel.init(jax.random.key(0), x0, ds0.adjs)
    tp = JTrainPipeline(JSampler(topo, sizes=SIZES, mode="TPU", seed=seed), jf, step_fn,
                        depth=depth, tiered=pipe)
    _, _, losses = tp.run_epoch(batches, params, tx.init(params), jax.random.key(1))
    return params, losses, tp


def _port_pipeline(edge_index, feat, labels, tf, params, depth=1, seed=1, **kw):
    model = GraphSAGE(feat.shape[1], 32, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    pipe = TieredFeaturePipeline(tf)
    step = make_tiered_train_step(model, opt, labels, pipe.hot_table)
    sampler = GraphSageSampler(CSRTopo(edge_index=edge_index), SIZES, mode="TPU", seed=seed,
                               device="cpu")
    return TrainPipeline(sampler, tf, step, depth=depth, tiered=pipe, **kw)


def test_train_pipeline_loss_curve_matches_jax_and_depth2_equals_depth1():
    edge_index, feat, labels, n, jf, tf = _features()
    batches = _batches(n, 12)
    params, jlosses, jtp = _jax_run(edge_index, feat, labels, n, jf, batches)
    tp = _port_pipeline(edge_index, feat, labels, tf, params)
    losses = tp.run_epoch(batches)
    assert len(losses) == 12 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert tp.stats.cold_rows == jtp.stats.cold_rows > 0
    assert (tp.stats.batches, tp.stats.hot_rows) == (jtp.stats.batches, jtp.stats.hot_rows)
    assert {s for s, _, _ in tp.stats.spans} == {"sample", "gather", "upload", "step_dispatch"}
    assert len(tp.stats.spans) == 4 * 12
    summary = tp.stats.overlap_summary()
    assert 0.0 <= summary["overlap_frac"] <= 1.0
    assert 0.0 <= summary["hidden_frac_measured"] <= 0.75  # <= (S - 1) / S
    deep = _port_pipeline(edge_index, feat, labels, tf, params, depth=2).run_epoch(batches)
    assert deep == losses
    measured = _port_pipeline(edge_index, feat, labels, tf, params, measure_overlap=True)
    assert measured.run_epoch(batches[:3]) == losses[:3]
    assert {s for s, _, _ in measured.stats.spans} == {"sample", "gather", "upload", "step"}


def _stage_threads():
    """The pipeline's own stage threads (other owners' pools, such as disk
    read pools of features built elsewhere in the process, are not)."""
    return {t for t in threading.enumerate()
            if t.name.startswith(("qt-sample", "qt-gather", "qt-upload"))}


def test_stage_error_reraises_and_the_pipeline_still_trains():
    stages_before = _stage_threads()
    edge_index, feat, labels, n, jf, tf = _features()
    batches = _batches(n, 6)
    params = _jax_run(edge_index, feat, labels, n, jf, batches[:1])[0]
    tp = _port_pipeline(edge_index, feat, labels, tf, params, depth=2)

    def exploding():
        yield tp.sampler.sample_dense(batches[0])
        yield tp.sampler.sample_dense(batches[1])
        raise RuntimeError("sampler exploded mid-epoch")

    with pytest.raises(RuntimeError, match="sampler exploded mid-epoch"):
        tp.run_epoch_iter(exploding())

    def bad_step(batch, generator=None):
        raise RuntimeError("step exploded")

    bad = TrainPipeline(tp.sampler, tf, bad_step, depth=2, tiered=tp.tiered)
    with pytest.raises(RuntimeError, match="step exploded"):
        bad.run_epoch(batches)
    assert not _stage_threads() - stages_before  # both failed epochs joined their stages
    losses = tp.run_epoch(batches[:3])
    assert len(losses) == 3 and all(np.isfinite(losses))
    # run_epoch_iter takes bare samples and (task, sample) pairs; seeds are
    # the n_id prefix
    more = tp.run_epoch_iter([tp.sampler.sample_dense(batches[3]),
                              (0, tp.sampler.sample_dense(batches[4]))])
    assert len(more) == 2 and all(np.isfinite(more))


def test_checkpoint_and_resume_numbering(tmp_path):
    edge_index, feat, labels, n, jf, tf = _features()
    batches = _batches(n, 6)
    params = _jax_run(edge_index, feat, labels, n, jf, batches[:1])[0]
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    tp = _port_pipeline(edge_index, feat, labels, tf, params, checkpoint=mgr, checkpoint_every=2)
    tp.run_epoch(batches)
    assert tp.global_step == 6 and mgr.latest_step() == 6 and mgr.all_steps() == [4, 6]
    state = mgr.restore()
    model = tp.step_fn.model
    for name, value in model.state_dict().items():
        assert torch.equal(state["model"][name], value)
    assert state["optimizer"]["state"][0]["step"] == 6
    # a fresh pipeline restores the latest state and numbers on from it
    tp2 = _port_pipeline(edge_index, feat, labels, tf, params, checkpoint=mgr, checkpoint_every=2)
    assert tp2.global_step == 6
    tp2.step_fn.model.load_state_dict(state["model"])
    tp2.step_fn.optimizer.load_state_dict(state["optimizer"])
    assert all(np.isfinite(tp2.run_epoch(batches[:2])))
    assert tp2.global_step == 8 and mgr.latest_step() == 8
    mgr.close()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_6.pt", "step_8.pt"]
    with pytest.raises(ValueError, match="checkpoint_every"):
        TrainPipeline(tp.sampler, tf, tp.step_fn, tiered=tp.tiered, checkpoint=object())
    with pytest.raises(ValueError, match="no checkpoint manager"):
        TrainPipeline(tp.sampler, tf, tp.step_fn, tiered=tp.tiered, checkpoint_every=5)
    with pytest.raises(ValueError, match="make_tiered_train_step"):
        TrainPipeline(tp.sampler, tf, lambda b, g=None: 0.0, tiered=tp.tiered, checkpoint=mgr,
                      checkpoint_every=1)
    with pytest.raises(NotImplementedError, match="A12"):
        tp.register_metrics()


def test_checkpoint_manager_saves_copies_and_reports_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    w = torch.ones(3)
    mgr.save(1, {"w": w, "meta": [1, (2.0, "x")]}, wait=False)
    w.add_(1.0)  # the save copied the tensor before it returned
    mgr.flush()
    got = mgr.restore(1)
    assert torch.equal(got["w"], torch.ones(3)) and got["meta"] == [1, (2.0, "x")]
    mgr.save(2, {"w": w})
    assert mgr.all_steps() == [2] and not [f for f in os.listdir(tmp_path) if "tmp" in f]
    mgr.save(3, {"bad": threading.Lock()}, wait=False)  # torch.save cannot pickle a lock
    with pytest.raises(Exception):
        mgr.flush()
    assert mgr.latest_step() == 2
    mgr.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    save_partition_artifacts(str(tmp_path / "arts"), order=np.arange(4), book=[1, 2])
    arts = load_partition_artifacts(str(tmp_path / "arts"))
    assert arts["order"].tolist() == [0, 1, 2, 3] and arts["book"].tolist() == [1, 2]


# -- the read pool, the stats and the trace helpers --------------------------------------

@pytest.mark.parametrize("n,workers,chunk_rows", [(10, 4, 4096), (50, 2, 8), (0, 2, 8)])
def test_async_read_pool_chunks_like_the_reference(n, workers, chunk_rows):
    ids = np.arange(n, dtype=np.int64) * 3
    seen = {}

    def read(kind):
        def fn(chunk):
            seen.setdefault(kind, []).append(chunk.tolist())
            return np.stack([chunk, chunk * 2], axis=1) if chunk.size else np.zeros((0, 2))
        return fn

    jpool, pool = JAsyncReadPool(workers, chunk_rows), AsyncReadPool(workers, chunk_rows)
    try:
        np.testing.assert_array_equal(pool.gather(read("t"), ids), jpool.gather(read("j"), ids))
        assert sorted(seen["t"]) == sorted(seen["j"])
        assert pool.stats()["reads"] == jpool.stats()["reads"]
        assert pool.stats()["rows"] == jpool.stats()["rows"] == n
        np.testing.assert_array_equal(pool.submit(read("t"), ids[:3]).result(), ids[:3, None]
                                      * np.array([1, 2]))
    finally:
        pool.shutdown()
        jpool.shutdown()
    with pytest.raises(ValueError):
        AsyncReadPool(0)


def test_async_read_pool_error_contract():
    calls = []
    lock = threading.Lock()

    def read(chunk):
        with lock:
            calls.append(int(chunk[0]))
        if chunk[0] >= 8:
            raise OSError(f"bad block at {chunk[0]}")
        return chunk[:, None].astype(np.float32)

    with AsyncReadPool(workers=2, chunk_rows=4) as pool:
        with pytest.raises(OSError, match="bad block at 8"):
            pool.gather(read, np.arange(40))
        assert pool.stats()["errors"] == 1
        out = pool.gather(read, np.arange(8))  # the pool keeps serving
        np.testing.assert_array_equal(out[:, 0], np.arange(8))


def test_overlap_summary_math_and_chrome_trace(tmp_path):
    st = PipelineStats()
    st.record("a", 0.0, 1.0)
    st.record("b", 0.0, 1.0)
    s = st.overlap_summary()
    assert s["overlap_frac"] == 1.0 and s["hidden_frac_measured"] == 0.5
    st3 = PipelineStats()
    st3.record("a", 0.0, 2.0)
    st3.record("b", 1.0, 3.0)
    s3 = st3.overlap_summary()
    assert abs(s3["overlap_frac"] - 1 / 3) < 1e-3 and abs(s3["hidden_frac_measured"] - 0.25) < 1e-3
    assert PipelineStats().overlap_summary() == {}
    from quiver_tpu.trace import SpanRecorder as JSpanRecorder
    from quiver_tpu.trace import export_chrome_trace as j_export

    jr = JSpanRecorder()
    for span in st3.spans:
        jr.record(*span)
    jr.record("a", 0.5, 2.5)
    st3.spans.merge([("a", 0.5, 2.5)])
    path = str(tmp_path / "t.json")
    doc = trace.export_chrome_trace(path, [("train_pipeline", st3.spans)], {"k": 1})
    assert doc == j_export("", [("train_pipeline", jr)], {"k": 1})
    assert json.load(open(path)) == doc
    assert len(st3.spans) == 3 and bool(st3.spans)
    st3.spans.clear()
    assert not st3.spans and len(st3.spans) == 0


def test_trace_scope_aggregates_when_enabled(monkeypatch):
    from quiver_tpu import trace as jtrace

    trace.trace_report(reset=True)
    with trace.trace_scope("off"):
        pass
    assert "off" not in trace.trace_report()
    monkeypatch.setenv(jtrace.TRACE_ENV, "1")
    for _ in range(3):
        with trace.trace_scope("pipeline.x") as box:
            box.sync = torch.ones(2)
    count, total = trace.trace_report(reset=True)["pipeline.x"]
    assert count == 3 and total >= 0.0 and trace.trace_report() == {}

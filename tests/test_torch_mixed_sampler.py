"""Parity of the port's hybrid device + CPU sampler
(`quiver_tpu_torch.pyg.MixedGraphSageSampler`) with quiver_tpu's, on the CPU,
with tests/test_mixed_sampler.py as the oracle: `TrainSampleJob`, the mode
spellings, `decide_task_num` and `suggest_num_workers`, the weighted
max-degree guard, first-epoch samples task by task against the JAX mixed
sampler (GPU_CPU_MIXED and CPU_ONLY) and against a replay in this process,
worker-death recovery with its clean-up, and `TrainPipeline.run_epoch_iter`'s
stats feedback.

Workers are spawned processes that import torch, a few seconds each, so
these tests start few of them. Bars: every sample bit-equal (device tasks
as tests/test_torch_sage.py compares the device samplers, CPU tasks as
tests/test_torch_host_mode.py compares host samples)."""

import os
import time

import numpy as np
import pytest

import torch

from quiver_tpu.pyg import MixedGraphSageSampler as JMixed
from quiver_tpu.pyg import TrainSampleJob as JTrainSampleJob
from quiver_tpu.utils import CSRTopo as JCSRTopo
from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, GraphSageSampler
from quiver_tpu_torch.ops.cpu_kernels import HostSampler
from quiver_tpu_torch.pipeline import TieredFeaturePipeline, TrainPipeline, make_tiered_train_step
from quiver_tpu_torch.pyg import MixedGraphSageSampler, TrainSampleJob, host_dense_sample

from conftest import make_random_graph
from test_torch_host_mode import _assert_host_samples_equal
from test_torch_sage import _assert_samples_equal

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

SIZES = (4, 3)


def _topos(weights=None):
    ei = make_random_graph(150, 1800, seed=6)
    return JCSRTopo(edge_index=ei, edge_weights=weights), CSRTopo(edge_index=ei,
                                                                  edge_weights=weights)


def _first_epoch(sampler):
    try:
        return dict(iter(sampler))
    finally:
        sampler.shutdown()


def _shm_gone(names):
    return not any(os.path.exists(os.path.join("/dev/shm", n.lstrip("/"))) for n in names)


def test_train_sample_job_matches_reference():
    jj, tj = JTrainSampleJob(np.arange(50), 16, seed=3), TrainSampleJob(np.arange(50), 16, seed=3)
    assert len(tj) == len(jj) == 4 and [len(tj[i]) for i in range(4)] == [16, 16, 16, 2]
    for _ in range(3):
        jj.shuffle()
        tj.shuffle()
        for i in range(4):
            assert np.array_equal(jj[i], tj[i])


def test_mode_spellings():
    _, tt = _topos()
    job = TrainSampleJob(np.arange(32), 8)
    for mode, canon in (("GPU_CPU_MIXED", "GPU_CPU_MIXED"), ("TPU_CPU_MIXED", "GPU_CPU_MIXED"),
                        ("HOST_CPU_MIXED", "HOST_CPU_MIXED"),
                        ("UVA_CPU_MIXED", "HOST_CPU_MIXED"), ("GPU_ONLY", "GPU_ONLY"),
                        ("TPU_ONLY", "GPU_ONLY"), ("UVA_ONLY", "GPU_ONLY"),
                        ("CPU_ONLY", "CPU_ONLY")):
        s = MixedGraphSageSampler(job, tt, SIZES, num_workers=1, mode=mode, device="cpu")
        assert s.mode == canon
        if canon == "CPU_ONLY":
            assert s.device_sampler is None
        else:
            want = "HOST" if canon.startswith("HOST") else "GPU"
            assert s.device_sampler.mode == want
        assert s.num_workers == (0 if canon == "GPU_ONLY" else 1)
    # the reference's mapping: UVA_ONLY is the device-only mode, while
    # GraphSageSampler's "UVA" samples on the host
    assert JMixed.MODE_ALIASES["UVA_ONLY"] == "TPU_ONLY"
    assert JMixed.MODE_ALIASES["UVA_CPU_MIXED"] == "HOST_CPU_MIXED"
    assert GraphSageSampler(tt, SIZES, mode="UVA", device="cpu").mode == "HOST"
    with pytest.raises(ValueError, match="unsupported mode"):
        MixedGraphSageSampler(job, tt, SIZES, mode="BAD_MODE", device="cpu")
    with pytest.raises(ValueError, match="num_workers"):
        MixedGraphSageSampler(job, tt, SIZES, num_workers=0, mode="CPU_ONLY", device="cpu")


@pytest.mark.parametrize("workers,dev,cpu,total", [
    (2, 0.0, 0.0, 8), (2, 0.001, 1.0, 8), (2, 1.0, 0.001, 8), (2, 0.01, 0.02, 1000),
    (1, 0.01, 0.02, 1000), (2, 0.1, 0.02, 1000), (3, 0.013, 0.071, 97)])
def test_decide_task_num_and_suggest_num_workers_match(workers, dev, cpu, total):
    jt, tt = _topos()
    job = TrainSampleJob(np.arange(64), 8)
    j = JMixed(JTrainSampleJob(np.arange(64), 8), jt, list(SIZES), num_workers=workers)
    t = MixedGraphSageSampler(job, tt, SIZES, num_workers=workers, device="cpu")
    for s in (j, t):
        s.avg_device_time, s.avg_cpu_time = dev, cpu
    assert t.decide_task_num(total) == j.decide_task_num(total)
    for target in (None, 0.0, 0.2, 0.5, 0.9):
        for cap in (None, 32):
            assert t.suggest_num_workers(target, cap) == j.suggest_num_workers(target, cap)
    for mode, want in (("CPU_ONLY", 0), ("GPU_ONLY", total)):
        assert MixedGraphSageSampler(job, tt, SIZES, num_workers=workers, mode=mode,
                                     device="cpu").decide_task_num(total) == want


def test_weighted_max_degree_guard():
    jt, _ = _topos()
    ew = np.ones(jt.edge_count, np.float32)
    topo = CSRTopo(indptr=jt.indptr, indices=jt.indices, edge_weights=ew)
    job = TrainSampleJob(np.arange(32), 8)
    max_deg = int(np.max(np.diff(topo.indptr)))
    with pytest.raises(ValueError, match="max_deg"):
        MixedGraphSageSampler(job, topo, SIZES, num_workers=1, mode="GPU_CPU_MIXED",
                              weighted=True, max_deg=max_deg - 1, device="cpu")
    # the host engine weights all edges on both halves: no window to guard
    MixedGraphSageSampler(job, topo, SIZES, num_workers=1, mode="HOST_CPU_MIXED",
                          weighted=True, max_deg=max_deg - 1, device="cpu").shutdown()
    s = MixedGraphSageSampler(job, topo, SIZES, num_workers=0, mode="GPU_CPU_MIXED",
                              weighted=True, max_deg=max_deg - 1, device="cpu")
    assert s.device_sampler.max_deg == max_deg - 1 and s.device_sampler.weighted
    with pytest.raises(ValueError, match="edge_weights"):
        MixedGraphSageSampler(job, _topos()[1], SIZES, weighted=True, device="cpu")


def _replay_cpu_task(tt, job_seed, train, batch, seed, slot, t, device_num, epoch=1,
                     weights=None, workers=2):
    """A CPU task replayed in this process: the worker's engine seeded as
    the worker seeds it (its spawn count is its slot + 1 in a first pool;
    tasks go round-robin from the first CPU task)."""
    job = TrainSampleJob(train, batch, seed=job_seed)
    for _ in range(epoch):
        job.shuffle()
    spawn = (t - device_num) % workers + 1 if slot is None else slot + 1
    eng = HostSampler(tt.indptr, tt.indices, weights=weights)
    n_id, count, adjs = eng.sample_multilayer(np.asarray(job[t], np.int64), SIZES,
                                              seed + 7919 * spawn + epoch * 1009 + t)
    return host_dense_sample(n_id, count, adjs, len(job[t]), torch.device("cpu"))


def test_gpu_cpu_mixed_first_epoch_matches_reference_task_by_task():
    jt, tt = _topos()
    train = np.arange(150)
    j = JMixed(JTrainSampleJob(train, 16, seed=1), jt, list(SIZES), num_workers=2,
               mode="GPU_CPU_MIXED", seed=2)
    t = MixedGraphSageSampler(TrainSampleJob(train, 16, seed=1), tt, SIZES, num_workers=2,
                              mode="GPU_CPU_MIXED", seed=2, device="cpu")
    want, got = _first_epoch(j), _first_epoch(t)
    total = 10
    assert sorted(got) == sorted(want) == list(range(total))
    assert t.last_device_share == j.last_device_share == 0.5
    assert t.avg_device_time > 0 and t.avg_cpu_time > 0
    device_num = total // 2
    twin = GraphSageSampler(tt, SIZES, seed=2, device="cpu")
    job = TrainSampleJob(train, 16, seed=1)
    job.shuffle()
    for task in range(total):
        if task < device_num:
            _assert_samples_equal(want[task], got[task])
            _assert_samples_equal(want[task], twin.sample_dense(job[task]))
        else:
            _assert_host_samples_equal(want[task], got[task])
            replay = _replay_cpu_task(tt, 1, train, 16, 2, None, task, device_num)
            assert torch.equal(replay.n_id, got[task].n_id)
            for a, b in zip(replay.adjs, got[task].adjs):
                assert torch.equal(a.cols, b.cols) and torch.equal(a.mask, b.mask)


@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_only_first_epoch_matches_reference(weighted):
    w = None
    if weighted:  # only even-id destinations carry weight (tests/test_mixed_sampler.py)
        w = np.where(make_random_graph(150, 1800, seed=6)[1] % 2 == 0, 1.0, 0.0).astype(
            np.float32)
    jt, tt = _topos(w)
    train = np.arange(100)
    j = JMixed(JTrainSampleJob(train, 25, seed=0), jt, list(SIZES), num_workers=1,
               mode="CPU_ONLY", seed=3, weighted=weighted)
    t = MixedGraphSageSampler(TrainSampleJob(train, 25, seed=0), tt, SIZES, num_workers=1,
                              mode="CPU_ONLY", seed=3, weighted=weighted, device="cpu")
    want, got = _first_epoch(j), _first_epoch(t)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert t.last_device_share == 0.0 and t.avg_cpu_time > 0 and t.avg_device_time == 0
    for task in range(4):
        _assert_host_samples_equal(want[task], got[task])
        if weighted:
            ds = got[task]
            assert (ds.n_id[ds.batch_size:int(ds.count)] % 2 == 0).all()
    replay = _replay_cpu_task(tt, 0, train, 25, 3, 0, 2, 0,
                              weights=tt.edge_weights if weighted else None)
    assert torch.equal(replay.n_id, got[2].n_id)


def test_worker_death_recovery_and_clean_up():
    """Killing one of two workers mid-epoch: its tasks go to the survivor
    and the epoch yields every task once; shutdown unlinks the shared
    memory and ends the drainers it can."""
    _, tt = _topos()
    job = TrainSampleJob(np.arange(150), 10, seed=0)
    s = MixedGraphSageSampler(job, tt, [4], num_workers=2, mode="CPU_ONLY", device="cpu")
    try:
        it = iter(s)
        seen = [next(it)[0]]
        names = [m.name for m in s._shms]
        assert len(names) == 2 and not _shm_gone(names)
        s._workers[0].terminate()
        s._workers[0].join(timeout=10)
        seen += [task for task, _ in it]
    finally:
        s.shutdown()
    assert sorted(seen) == list(range(len(job)))
    assert _shm_gone(names) and s._shms == [] and s._workers == []


def test_dead_pool_fails_fast_then_heals():
    _, tt = _topos()
    job = TrainSampleJob(np.arange(40), 10, seed=0)
    s = MixedGraphSageSampler(job, tt, [4], num_workers=1, mode="CPU_ONLY", device="cpu")
    try:
        s.lazy_init()
        orig = s.lazy_init

        def killing_lazy():
            orig()
            for p in s._workers:
                p.terminate()
                p.join(timeout=10)

        s.lazy_init = killing_lazy
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="workers died"):
            for _ in s:
                pass
        assert time.monotonic() - t0 < 30
        assert s._workers == [] and s._shms == []  # the failed epoch shut the pool down
        s.lazy_init = orig
        assert sorted(task for task, _ in s) == list(range(4))
    finally:
        s.shutdown()
    assert s._drainers == []  # every drainer thread it started has ended


def test_run_epoch_iter_carries_the_mixed_measurements():
    _, tt = _topos()
    n = tt.node_count
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    f = Feature(rank=0, device_list=[0], device_cache_size="1G", device="cpu")
    f.from_cpu_tensor(feat)
    mixed = MixedGraphSageSampler(TrainSampleJob(np.arange(64), 16, seed=0), tt, SIZES,
                                  num_workers=1, mode="GPU_CPU_MIXED", device="cpu")
    model = GraphSAGE(8, 8, 3, num_layers=2, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    pipe = TieredFeaturePipeline(f)
    step = make_tiered_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-2), labels,
                                  pipe.hot_table)
    tp = TrainPipeline(GraphSageSampler(tt, SIZES, device="cpu"), f, step, tiered=pipe)
    try:
        losses = tp.run_epoch_iter(mixed)
    finally:
        mixed.shutdown()
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert tp.stats.device_share == mixed.last_device_share == 0.5
    assert tp.stats.avg_device_sample_s == mixed.avg_device_time > 0
    assert tp.stats.avg_cpu_sample_s == mixed.avg_cpu_time > 0

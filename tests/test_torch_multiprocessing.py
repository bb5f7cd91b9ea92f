"""The port's process hand-off (quiver_tpu_torch.multiprocessing, the
``share_ipc`` pairs of Feature, ShardTensor and GraphSageSampler, and
``CSRTopo.share_memory_``) against the JAX package, on the CPU.

Each test passes a port object to one ``spawn`` child through
``ForkingPickler`` (the child's arguments, or a queue), the child
(`torch_mp_children`, which imports no jax) reads rows or draws from it, and
the parent holds them bit for bit to the JAX package's on the same seeded
inputs, as tests/test_reductions.py does for the JAX package itself:

- a Feature whose rows all lie on the device, one with a cache budget (a
  device shard and a shared host tail) and one reordered by its topology:
  the child's ``feat[ids]`` equals JAX's ``Feature[ids]``;
- a sampler in the tiled and flat device layouts and in the CPU and HOST
  modes, after the parent drew twice: the child's ``sample(np.arange(8))``
  equals a fresh JAX sampler's (the child's key stream starts at call 0),
  and a device-mode child binds the parent's graph from shared memory; a
  weighted one's equals a fresh port sampler's;
- a disk-tier Feature re-opens its file by path;
- the handles of a 1M-edge graph's sampler and a [100_000, 16] feature
  pickle to under 64 KB: shared memory crosses, the bytes do not; a plain
  pickle of the topology still carries them;
- a stream-bound or temporal-bound sampler, an adaptive store and an
  allocator of expandable segments are refused, and the package installs
  its reducers and loads no jax.

Every ``get`` and ``join`` has its own timeout."""

import multiprocessing as mp
import pickle
import subprocess
import sys
from multiprocessing.reduction import ForkingPickler

import numpy as np
import pytest
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import Feature as JFeature
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler

import quiver_tpu_torch.multiprocessing as qmp
from quiver_tpu_torch import CSRTopo, Feature, GraphSageSampler
from quiver_tpu_torch.stream import StreamingTiledGraph
from quiver_tpu_torch.utils import refuse_unexportable_allocator
from quiver_tpu_torch.workloads import TemporalTiledGraph

import torch_mp_children as children
from conftest import make_random_graph
from torch_fixtures import run_in_child

torch.set_num_threads(1)

N, DIM = 200, 8
EDGES = make_random_graph(N, 2000, seed=2)
TABLE = np.random.default_rng(0).standard_normal((N, DIM)).astype(np.float32)
IDS = np.array([0, 7, 63, 199, 120, 5, 7, 150])
SIZES = [4, 3]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- Feature -------------------------------------------------------------------------------

FEATURES = {
    # name -> (device_cache_size, with the topology's degree reorder)
    "replicated": (N * DIM * 4, False),
    "tiered": (60 * DIM * 4, False),
    "tiered-reordered": (60 * DIM * 4, True),
}


@pytest.mark.parametrize("case", sorted(FEATURES))
def test_feature_crosses_a_spawn(case):
    cache, reorder = FEATURES[case]
    feat = Feature(device="cpu", device_cache_size=cache,
                   csr_topo=CSRTopo(edge_index=EDGES) if reorder else None)
    feat.from_cpu_tensor(TABLE)
    jfeat = JFeature(rank=0, device_list=[0], device_cache_size=cache,
                     csr_topo=JCSRTopo(edge_index=EDGES) if reorder else None)
    jfeat.from_cpu_tensor(TABLE)
    rows, tail_shared = run_in_child(children.feature_rows, {"feature": feat}, IDS)
    assert _same(rows, np.asarray(jfeat[IDS]))
    assert tail_shared
    assert (feat.shard_tensor.cpu_tensor is None) == (case == "replicated")
    # the parent's store still gathers the same rows, and so does a twin
    # built in this process from a handle
    assert _same(feat[IDS].numpy(), rows)
    twin = Feature.new_from_ipc_handle(0, feat.share_ipc())
    assert _same(twin[IDS].numpy(), rows)


def test_feature_crosses_a_queue():
    feat = Feature(device="cpu", device_cache_size=60 * DIM * 4,
                   csr_topo=CSRTopo(edge_index=EDGES))
    feat.from_cpu_tensor(TABLE)
    ctx = mp.get_context("spawn")
    in_q = ctx.Queue()
    in_q.put(feat)
    rows = run_in_child(children.feature_rows_from_queue, in_q, IDS)
    assert _same(rows, feat[IDS].numpy())
    assert _same(rows, TABLE[IDS])


def test_disk_tier_feature_reopens_by_path(tmp_path):
    kw = dict(device_cache_size=40 * DIM * 4, host_memory_budget=50 * DIM * 4,
              disk_path=str(tmp_path / "rows.npy"))
    feat = Feature(device="cpu", **kw)
    feat.from_cpu_tensor(TABLE)
    assert feat.tier_bytes()["disk"] > 0
    handle = feat.share_ipc()
    assert handle["shard_ipc"]["disk"][0] == kw["disk_path"]
    rows, _ = run_in_child(children.feature_rows, {"feature": feat}, IDS)
    jfeat = JFeature(rank=0, device_list=[0], **dict(kw, disk_path=str(tmp_path / "j.npy")))
    jfeat.from_cpu_tensor(TABLE)
    assert _same(rows, np.asarray(jfeat[IDS]))
    assert _same(rows, TABLE[IDS])
    feat.close()


# -- GraphSageSampler ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tiled", "flat", "weighted", "CPU", "HOST"])
def test_sampler_crosses_a_spawn(mode):
    """The parent draws twice first; the child's first draw equals a fresh
    JAX sampler's (a weighted one's, whose float64 scores may order
    near-ties apart from XLA's, equals a fresh port sampler's)."""
    w = np.random.default_rng(6).random(EDGES.shape[1]).astype(np.float32) + 0.1
    topo = CSRTopo(edge_index=EDGES, edge_weights=w)
    if mode in ("tiled", "flat", "weighted"):
        kw = dict(layout="flat" if mode == "flat" else "tiled", weighted=mode == "weighted")
        sampler = GraphSageSampler(topo, SIZES, device="cpu", seed=3, **kw)
        ref = (GraphSageSampler(CSRTopo(edge_index=EDGES, edge_weights=w), SIZES, device="cpu",
                                seed=3, **kw) if mode == "weighted" else
               JSampler(JCSRTopo(edge_index=EDGES), sizes=SIZES, mode="TPU", seed=3, **kw))
    else:
        sampler = GraphSageSampler(topo, SIZES, device="cpu", mode=mode, seed=3)
        ref = JSampler(JCSRTopo(edge_index=EDGES), sizes=SIZES, mode=mode, seed=3)
    for _ in range(2):
        sampler.sample(np.arange(8))
    n_id, bs, adjs, graph_shared, topo_shared = run_in_child(children.sampler_draw,
                                                             {"sampler": sampler})
    jn, jb, jadjs = ref.sample(np.arange(8))
    assert bs == jb == 8 and _same(n_id, np.asarray(jn))
    assert len(adjs) == len(jadjs) == len(SIZES)
    for (edge_index, size), ja in zip(adjs, jadjs):
        assert _same(edge_index, np.asarray(ja.edge_index)) and size == ja.size
    assert topo_shared and graph_shared is (None if mode in ("CPU", "HOST") else True)


def test_handles_carry_shared_memory_not_bytes():
    """A 1M-edge graph and a [100_000, 16] table: their samplers' and the
    feature's ForkingPickler bytes stay under 64 KB, while a plain pickle of
    the shared topology still carries its arrays and round-trips by value
    with the device caches left behind."""
    n, e = 100_000, 1_000_000
    topo = CSRTopo(edge_index=make_random_graph(n, e, seed=4))
    table = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    feat = Feature(device="cpu", device_cache_size=n * 16 * 2, csr_topo=topo)
    feat.from_cpu_tensor(table)
    host = GraphSageSampler(topo, SIZES, device="cpu", mode="HOST", seed=0)
    tiled = GraphSageSampler(topo, SIZES, device="cpu", seed=0)
    sizes = {name: len(ForkingPickler.dumps(obj))
             for name, obj in (("feature", feat), ("host sampler", host),
                               ("tiled sampler", tiled))}
    assert max(sizes.values()) < 64 << 10, sizes
    plain = pickle.dumps(topo)
    assert len(plain) > topo.indices.nbytes
    back = pickle.loads(plain)
    assert _same(back.indptr, topo.indptr) and _same(back.indices, topo.indices)
    assert _same(back.feature_order, topo.feature_order)
    assert back._tiled_cache is None and back._tile_map is None


def test_csr_topo_share_memory_is_idempotent_and_keeps_the_arrays():
    w = np.random.default_rng(5).random(EDGES.shape[1]).astype(np.float32)
    topo = CSRTopo(edge_index=EDGES, edge_weights=w)
    ref = CSRTopo(edge_index=EDGES, edge_weights=w)
    topo.feature_order = np.arange(N)[::-1]
    arrays = (topo.indptr, topo.indices, topo.edge_weights, topo.feature_order)
    assert topo.share_memory_() is topo
    ptrs = [t.data_ptr() for t in topo._shared.values()]
    assert sorted(topo._shared) == ["_feature_order", "edge_weights", "indices", "indptr"]
    assert all(t.is_shared() for t in topo._shared.values())
    for old, new in zip(arrays, (topo.indptr, topo.indices, topo.edge_weights,
                                 topo.feature_order)):
        assert _same(old, new)
    topo.share_memory_()
    assert [t.data_ptr() for t in topo._shared.values()] == ptrs
    assert _same(topo.to_device("cpu")[1].numpy(), ref.to_device("cpu")[1].numpy())
    assert len(ForkingPickler.dumps(topo)) < 4096


# -- refusals and the package --------------------------------------------------------------

def _stream_sampler():
    topo = CSRTopo(edge_index=EDGES)
    return GraphSageSampler(topo, SIZES, device="cpu", seed=0).bind_stream(
        StreamingTiledGraph(topo, reserve_frac=1.0, device="cpu"))


def _temporal_sampler():
    topo = CSRTopo(edge_index=EDGES)
    ts = np.arange(EDGES.shape[1], dtype=np.float32)
    return GraphSageSampler(topo, SIZES, device="cpu", seed=0, dedup=False).bind_temporal(
        TemporalTiledGraph(topo, ts, device="cpu"))


def _adaptive_feature(tmp_path):
    feat = Feature(device="cpu", device_cache_size=40 * DIM * 4, adaptive_tiers=True,
                   disk_path=str(tmp_path / "adaptive.npy"))
    feat.from_cpu_tensor(TABLE)
    return feat


@pytest.mark.parametrize("case,error,match", [
    ("stream", TypeError, "ROADMAP A14"),
    ("temporal", TypeError, "timestamp tiles"),
    ("adaptive", NotImplementedError, "adaptive tier store"),
])
def test_bindings_that_cannot_cross_are_refused(case, error, match, tmp_path):
    obj = {"stream": _stream_sampler, "temporal": _temporal_sampler,
           "adaptive": lambda: _adaptive_feature(tmp_path)}[case]()
    with pytest.raises(error, match=match):
        ForkingPickler.dumps(obj)
    if case == "adaptive":
        obj.close()


@pytest.mark.parametrize("var", ["PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"])
def test_expandable_segments_are_refused(var, monkeypatch):
    """Device tensors cross by CUDA IPC, which the port does not do for
    expandable segments: the setting is refused, naming itself."""
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.delenv("PYTORCH_ALLOC_CONF", raising=False)
    refuse_unexportable_allocator()
    monkeypatch.setenv(var, "max_split_size_mb:64, expandable_segments:True")
    with pytest.raises(RuntimeError, match=f"{var}=.*expandable_segments"):
        refuse_unexportable_allocator()


def test_import_installs_the_reducers_and_loads_no_jax():
    code = (
        "import sys; before = set(sys.modules); import quiver_tpu_torch.multiprocessing as m; "
        "from multiprocessing.reduction import ForkingPickler as F; "
        "from quiver_tpu_torch import Feature, GraphSageSampler; "
        "assert F._extra_reducers[Feature] is m.reduce_feature; "
        "assert F._extra_reducers[GraphSageSampler] is m.reduce_pyg_sampler; "
        "bad = sorted(k for k in set(sys.modules) - before if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'quiver_tpu', 'quiver')); print(repr(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    assert ForkingPickler._extra_reducers[Feature] is qmp.reduce_feature

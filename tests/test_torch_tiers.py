"""Parity of the port's disk tier and adaptive placement with quiver_tpu's,
on the CPU: `tiers` (`DiskShard`, the O_DIRECT and page-cache helpers,
`PrefetchBuffer`, `TierPlacement`, `plan_adaptive`, `TierStore`, K6's plain
version `set_rows_plain`), the disk tail of `ShardTensor`, the tier options
of `Feature` and `QuantizedFeature`, and the "disk" and "adaptive" modes of
`TieredFeaturePipeline` with flush-ahead prefetch, under `TrainPipeline`.

Shapes: a few hundred nodes, D <= 16, a few dozen rows a tier. Inputs come
from seeded numpy and go through both packages. Bars:
- disk bytes, gathered rows, staged ``(mapped, rows, pos)``, placement maps
  and table bytes bit-equal to the JAX package's;
- a 12-batch Adam loss curve through the disk tier within 1e-4 of the JAX
  pipeline's (torch and XLA sum in different orders; the bar of
  tests/test_torch_pipeline.py) and bit-equal to the port's own all-DRAM
  epoch (placement and prefetch never change a byte)."""

import gc
import threading
import time

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
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.quant import QuantizedFeature as JQuantizedFeature
from quiver_tpu.shard_tensor import ShardTensor as JShardTensor
from quiver_tpu import tiers as jtiers
from quiver_tpu_torch import (
    CSRTopo,
    Feature,
    GraphSAGE,
    GraphSageSampler,
    QuantizedFeature,
    sage_params_from_flax,
)
from quiver_tpu_torch import tiers
from quiver_tpu_torch.pipeline import (
    AsyncReadPool,
    TieredFeaturePipeline,
    TrainPipeline,
    make_tiered_train_step,
    tiered_lookup,
)
from quiver_tpu_torch.quant import get_codec, quantized_tiered_lookup
from quiver_tpu_torch.shard_tensor import CPU_DEVICE, ShardTensor

from test_pipeline import community_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

DIM = 16
ROW = DIM * 4
HBM, HOST = 24, 48  # rows of the device and host tiers (the rest on disk)
SIZES, BATCH, LR = [5, 5], 32, 5e-3


def _table(n=200, seed=0):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _pair(tmp_path, feat, name, adaptive, edge_index=None, hbm=HBM, host=HOST, **kw):
    """The same four-tier store in both packages."""
    opts = dict(device_cache_size=hbm * ROW, host_memory_budget=host * ROW,
                adaptive_tiers=adaptive, **kw)
    jf = JFeature(rank=0, disk_path=str(tmp_path / f"j_{name}.npy"),
                  read_pool=JAsyncReadPool(2, chunk_rows=16),
                  csr_topo=None if edge_index is None else JCSRTopo(edge_index=edge_index),
                  **opts)
    jf.from_cpu_tensor(feat)
    tf = Feature(rank=0, disk_path=str(tmp_path / f"t_{name}.npy"),
                 read_pool=AsyncReadPool(2, chunk_rows=16), device="cpu",
                 csr_topo=None if edge_index is None else CSRTopo(edge_index=edge_index),
                 **opts)
    tf.from_cpu_tensor(feat)
    return jf, tf


def _ids(n, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, n, 150), [-1, -7, n, n + 3, 0, n - 1]]).astype(np.int64)


# -- the disk shard and its helpers ------------------------------------------------

def test_disk_shard_roundtrip_and_pool_reads_equal_plain_reads(tmp_path):
    rows = _table(300)
    sh = tiers.DiskShard.create(str(tmp_path / "rows"), rows)
    jsh = jtiers.DiskShard.create(str(tmp_path / "jrows"), rows)
    assert sh.path.endswith(".npy") and sh.shape == (300, DIM)
    assert (sh.nbytes, sh.row_bytes, sh.dtype) == (jsh.nbytes, jsh.row_bytes, jsh.dtype)
    with open(sh.path, "rb") as a, open(jsh.path, "rb") as b:
        assert a.read() == b.read()
    ids = np.random.default_rng(2).integers(0, 300, 500)
    plain = sh.read_rows(ids)
    np.testing.assert_array_equal(plain, rows[ids])
    with AsyncReadPool(3, chunk_rows=32) as pool:
        np.testing.assert_array_equal(sh.read_rows(ids, pool=pool), plain)
        np.testing.assert_array_equal(sh.read_rows(np.empty(0, np.int64), pool=pool),
                                      jsh.read_rows(np.empty(0, np.int64)))
    for bad in ([300], [-1]):
        with pytest.raises(ValueError, match="corrupt placement"):
            sh.read_block(np.asarray(bad))


def test_o_direct_and_drop_cache_helpers_answer_bools(tmp_path):
    rows = _table(128)
    sh = tiers.DiskShard.create(str(tmp_path / "d"), rows)
    missing = str(tmp_path / "missing")
    assert tiers.drop_page_cache(missing) is False
    assert isinstance(sh.drop_cache(), bool)
    assert sh.drop_cache() == jtiers.drop_page_cache(sh.path)
    supported = tiers.o_direct_supported(sh.path)
    assert supported == jtiers.o_direct_supported(sh.path)
    assert tiers.o_direct_supported(missing) is False
    if not supported:
        with pytest.raises(OSError):
            tiers.DiskShard(sh.path, direct=True)
        return
    dsh = tiers.DiskShard(sh.path, direct=True)
    ids = np.random.default_rng(3).integers(0, 128, 200)
    np.testing.assert_array_equal(dsh.read_block(ids), rows[ids])
    with AsyncReadPool(2, chunk_rows=16) as pool:
        np.testing.assert_array_equal(dsh.read_rows(ids, pool=pool), rows[ids])


# -- PrefetchBuffer -----------------------------------------------------------------

def test_prefetch_buffer_issue_take_cancel_like_the_reference(tmp_path):
    rows = _table(300)
    out = []
    for mod, pool_cls, name in ((tiers, AsyncReadPool, "t"), (jtiers, JAsyncReadPool, "j")):
        sh = mod.DiskShard.create(str(tmp_path / name), rows)
        events = []
        with pool_cls(2, chunk_rows=32) as pool:
            pf = mod.PrefetchBuffer(sh.read_block, pool, max_rows=64)
            pf.listener = lambda kind, n: events.append((kind, n))
            issued = [pf.issue(np.arange(20)), pf.issue(np.arange(30))]
            mask = pf.staged_mask(np.asarray([0, 29, 30, 250])).tolist()
            ids = np.asarray([5, 250, 7, 290])
            pos, got = pf.take(ids)
            order = np.argsort(pos)
            np.testing.assert_array_equal(got[order], rows[ids[pos[order]]])
            issued.append(pf.issue(np.arange(100, 300)))
            both = pf.take_or_read(np.asarray([100, 299, 101]), sh.read_block)
            np.testing.assert_array_equal(both, rows[[100, 299, 101]])
            cancelled = pf.cancel()
            empty = pf.take(np.arange(10))[1]
            out.append((issued, mask, sorted(pos.tolist()), cancelled, empty, events,
                        pf.stats()))
    assert out[0] == out[1]
    assert out[0][0] == [20, 10, 36] and out[0][2] == [0, 2]


def test_prefetch_buffer_failed_read_error_parity():
    def flaky(ids):
        if (ids >= 8).any():
            raise OSError("injected read failure")
        return np.ones((ids.shape[0], 4), np.float32)

    stats = []
    for mod, pool_cls in ((tiers, AsyncReadPool), (jtiers, JAsyncReadPool)):
        with pool_cls(2, chunk_rows=4) as pool:
            pf = mod.PrefetchBuffer(flaky, pool, max_rows=64)
            pf.issue(np.arange(12))  # chunks [0..3] [4..7] [8..11]
            pos, got = pf.take(np.arange(12))
            assert sorted(pos.tolist()) == list(range(8)) and np.all(got == 1.0)
            with pytest.raises(OSError, match="injected read failure"):
                pf.take_or_read(np.arange(8, 12), lambda i: pool.gather(flaky, i))
            stats.append(pf.stats())
    assert stats[0] == stats[1] and stats[0]["errors"] == 4
    with pytest.raises(ValueError, match="AsyncReadPool"):
        tiers.PrefetchBuffer(lambda ids: ids, None)


# -- ShardTensor and Feature ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_shard_tensor_disk_tail_matches_reference(tmp_path, dtype):
    rng = np.random.default_rng(4)
    table = (rng.standard_normal((120, DIM)) * 20).astype(dtype)
    jst = JShardTensor(0, dtype=dtype)
    jst.append(table[:30], 0)
    jst.append(table[30:70], CPU_DEVICE)
    jst.append_disk(table[70:], str(tmp_path / "j"), read_pool=JAsyncReadPool(2, chunk_rows=8))
    st = ShardTensor("cpu", dtype=dtype)
    st.append(table[:30], 0)
    st.append(table[30:70], CPU_DEVICE)
    st.append_disk(table[70:], str(tmp_path / "t"), read_pool=AsyncReadPool(2, chunk_rows=8))
    assert st.tier_bytes() == jst.tier_bytes() and st.shape == jst.shape
    ids = np.concatenate([rng.integers(0, 120, 90), [-1, 120, 200, 119, 70, 69]])
    np.testing.assert_array_equal(st[ids].numpy(), np.asarray(jst[ids]))
    with pytest.raises(ValueError, match="final tier"):
        st.append(table[:3], CPU_DEVICE)
    with pytest.raises(ValueError, match="already set"):
        st.append_disk(table[:3], str(tmp_path / "again"))


def test_bfloat16_rows_round_trip_through_the_disk_tail(tmp_path):
    table = _table(60)
    st = ShardTensor("cpu", dtype="bfloat16")
    st.append(table[:10], 0)
    st.append_disk(table[10:], str(tmp_path / "bf"))
    assert st.disk_shard.dtype == np.int16  # the bfloat16 bits
    ids = np.arange(60)[::-1].copy()
    want = torch.from_numpy(table).to(torch.bfloat16)[torch.from_numpy(ids)]
    assert torch.equal(st[ids], want)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("reorder", [False, True])
def test_feature_disk_gathers_match_reference(tmp_path, adaptive, reorder):
    feat = _table(200)
    ei = np.random.default_rng(5).integers(0, 200, (2, 1500)) if reorder else None
    jf, tf = _pair(tmp_path, feat, "f", adaptive, edge_index=ei)
    assert (tf.tier_store is not None) == adaptive and tf.read_pool is not None
    assert tf.tier_bytes() == jf.tier_bytes()
    ids = _ids(200)
    np.testing.assert_array_equal(tf[ids].numpy(), np.asarray(jf[ids]))
    stored = np.arange(-2, 203)
    np.testing.assert_array_equal(tf.gather_stored(np.clip(stored, 0, 199)).numpy(),
                                  np.asarray(jf.gather_stored(np.clip(stored, 0, 199))))
    assert not tf.resident
    with pytest.raises(ValueError, match="device-resident"):
        tf.lookup_padded(torch.arange(4))


def test_feature_refuses_bad_tier_options(tmp_path):
    with pytest.raises(ValueError, match="disk_path"):
        Feature(device="cpu", adaptive_tiers=True)
    with pytest.raises(ValueError, match="device_replicate"):
        Feature(device="cpu", disk_path=str(tmp_path / "x.npy"),
                cache_policy="p2p_clique_replicate")
    # no disk path: the budget is ignored and the host tail holds the rest
    f = Feature(device="cpu", device_cache_size=10 * ROW, host_memory_budget=ROW)
    f.from_cpu_tensor(_table(50))
    assert f.tier_bytes() == {"device": 10 * ROW, "host": 40 * ROW, "disk": 0, "row": ROW}
    # a zero host budget sends the misses straight to disk
    g = Feature(device="cpu", device_cache_size=10 * ROW, disk_path=str(tmp_path / "z.npy"))
    g.from_cpu_tensor(_table(50))
    assert g.tier_bytes() == {"device": 10 * ROW, "host": 0, "disk": 40 * ROW, "row": ROW}
    np.testing.assert_array_equal(g[np.arange(50)].numpy(), _table(50))


# -- placement -------------------------------------------------------------------------

def _weights(n, seed):
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.5, n).astype(np.float64)
    return np.arange(n), counts, lambda ids: counts[ids] * 0.5


def test_tier_store_reads_split_and_prefetch_match_reference(tmp_path):
    feat = _table(200)
    jf, tf = _pair(tmp_path, feat, "s", True)
    js, ts = jf.tier_store, tf.tier_store
    ids = np.random.default_rng(6).integers(0, 200, 120)
    np.testing.assert_array_equal(ts.gather_np(ids), js.gather_np(ids))
    np.testing.assert_array_equal(ts.gather(ids).numpy(), np.asarray(js.gather(ids)))
    assert ts.tier_split(ids) == js.tier_split(ids)
    assert ts.prefetch_rows(ids) == 0 and ts.cancel_prefetch() == 0  # no buffer yet
    for s in (ts, js):
        s.enable_prefetch(max_rows=32)
    assert ts.prefetch_rows(ids) == js.prefetch_rows(ids) > 0
    assert ts.tier_split(ids) == js.tier_split(ids) and "disk_prefetched" in ts.tier_split(ids)
    np.testing.assert_array_equal(ts.gather(ids).numpy(), np.asarray(js.gather(ids)))
    assert ts.prefetch.stats() == js.prefetch.stats()
    assert (ts.n_rows, ts.placement_version) == (js.n_rows, js.placement_version)


@pytest.mark.parametrize("max_moves", [8, 64])
def test_plan_and_apply_match_reference(tmp_path, max_moves):
    feat = _table(200)
    jf, tf = _pair(tmp_path, feat, f"p{max_moves}", True)
    js, ts = jf.tier_store, tf.tier_store
    for rnd in range(3):
        hot, w, resident = _weights(200, seed=10 + rnd)
        jplan = jtiers.plan_adaptive(js.placement, hot, w, resident, max_moves=max_moves)
        tplan = tiers.plan_adaptive(ts.placement, hot, w, resident, max_moves=max_moves)
        assert tplan.moves == jplan.moves and len(tplan) > 0
        jsum, tsum = js.apply(jplan), ts.apply(tplan)
        np.testing.assert_array_equal(tsum.pop("moved_stored"), jsum.pop("moved_stored"))
        assert tsum == jsum
        for attr in ("tier_of", "slot_of", "hbm_slots", "host_slots"):
            np.testing.assert_array_equal(getattr(ts.placement, attr),
                                          getattr(js.placement, attr))
        ts.placement.check()
        np.testing.assert_array_equal(ts.hbm_table.numpy(), np.asarray(js.hbm_table))
        np.testing.assert_array_equal(ts.host_cache.numpy(), js.host_cache)
        assert (ts.rows_promoted, ts.rows_demoted) == (js.rows_promoted, js.rows_demoted)
        assert tf.tier_bytes() == jf.tier_bytes()
        ids = _ids(200, seed=rnd)
        np.testing.assert_array_equal(tf[ids].numpy(), feat[np.clip(ids, 0, 199)] *
                                      ((ids >= 0) & (ids < 200))[:, None])
    assert tiers.PlacementPlan().moves == [] and len(tiers.plan_adaptive(
        ts.placement, np.arange(3), np.zeros(3), lambda i: np.zeros(len(i)))) == 0


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_set_rows_plain_matches_reference(dtype):
    rng = np.random.default_rng(7)
    H, b = 40, 16
    table = (rng.standard_normal((H, DIM)) * 30).astype(np.float32)
    rows = (rng.standard_normal((b, DIM)) * 30).astype(np.float32)
    slots = np.concatenate([rng.permutation(H)[:12], [H, H, H + 3, H]]).astype(np.int64)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    want = np.asarray(jtiers._set_rows(jnp.asarray(table).astype(jdt), jnp.asarray(slots),
                                       jnp.asarray(rows).astype(jdt)).astype(jnp.float32))
    tdt = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}[dtype]
    t_table = torch.from_numpy(table).to(tdt) if dtype != "int8" else \
        torch.from_numpy(table.astype(np.int8))
    t_rows = torch.from_numpy(rows).to(tdt) if dtype != "int8" else \
        torch.from_numpy(rows.astype(np.int8))
    before = t_table.clone()
    got = tiers.set_rows(t_table, torch.from_numpy(slots), t_rows)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    assert torch.equal(t_table, before)  # copy-on-write: the input is untouched
    assert torch.equal(tiers.set_rows_plain(t_table, torch.from_numpy(slots), t_rows), got)
    with pytest.raises(ValueError):
        tiers.set_rows(t_table, torch.from_numpy(slots[:3]), t_rows)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_set_rows_plain_takes_the_later_of_repeated_slots(dtype):
    """A slot given two or more times takes the later row, as the JAX
    package's scatter does, on tables of feature rows and of int32 tile
    rows; padding slots past the table and negative ones are dropped."""
    rng = np.random.default_rng(11)
    H, b = 30, 400
    table = (rng.standard_normal((H, DIM)) * 30).astype(dtype)
    rows = (rng.standard_normal((b, DIM)) * 30).astype(dtype)
    slots = rng.integers(-3, H + 3, b).astype(np.int64)
    keep = (slots >= 0) & (slots < H)
    want = np.asarray(jtiers._set_rows(jnp.asarray(table), jnp.asarray(np.where(keep, slots, H)),
                                       jnp.asarray(rows)))
    got = tiers.set_rows(torch.from_numpy(table), torch.from_numpy(slots), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    last = {int(s): i for i, s in enumerate(slots) if 0 <= s < H}
    assert all(np.array_equal(got[s].numpy(), rows[i]) for s, i in last.items())


def test_pinned_snapshot_keeps_the_victims_bytes_after_apply(tmp_path):
    """An adaptive pipeline built before an apply still reads the bytes its
    snapshot placed in the HBM slots the apply gave to promoted rows."""
    feat = _table(200)
    _, tf = _pair(tmp_path, feat, "snap", True)
    store = tf.tier_store
    old = TieredFeaturePipeline(tf)
    old_table = old.hot_table
    victims = np.arange(8)                 # HBM residents, slots 0..7
    promoted = np.arange(150, 158)         # disk residents
    plan = tiers.PlacementPlan()
    for v in victims:
        plan.demote(int(v), tiers.TIER_DISK)
    for p in promoted:
        plan.promote(int(p), tiers.TIER_HBM)
    summary = store.apply(plan)
    assert summary["promoted_hbm"] == 8
    assert store.hbm_table is not old_table
    np.testing.assert_array_equal(store.placement.slot_of[promoted], np.arange(8))
    np.testing.assert_array_equal(store.hbm_table[:8].numpy(), feat[promoted])
    np.testing.assert_array_equal(old_table[:8].numpy(), feat[victims])  # untouched
    ids = np.concatenate([victims, promoted, np.arange(40, 60)])
    for pipe in (old, TieredFeaturePipeline(tf)):
        out = tiered_lookup(pipe.hot_table, *pipe.prepare(ids))
        np.testing.assert_array_equal(out.numpy(), feat[ids])


# -- the pipeline's disk and adaptive modes --------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True])
def test_prepare_host_and_prefetch_match_reference(tmp_path, adaptive):
    feat = _table(200)
    ei = np.random.default_rng(8).integers(0, 200, (2, 1500))
    jf, tf = _pair(tmp_path, feat, "prep", adaptive, edge_index=ei)
    mode = "adaptive" if adaptive else "disk"
    ids = _ids(200, seed=9)
    for prefetch in (False, True):
        jp = JTieredFeaturePipeline(jf, prefetch=prefetch)
        tp = TieredFeaturePipeline(tf, prefetch=prefetch)
        assert tp.mode == jp.mode == mode and tp.hot_rows == jp.hot_rows
        for vc in (None, 100):
            assert tp.prefetch(ids, valid_count=vc) == jp.prefetch(ids, valid_count=vc)
            want, got = jp.prepare_host(ids, valid_count=vc), tp.prepare_host(ids, valid_count=vc)
            np.testing.assert_array_equal(got.mapped.numpy(), want.mapped)
            np.testing.assert_array_equal(got.pos.numpy(), want.pos)
            np.testing.assert_array_equal(got.rows.numpy(), want.rows)
        assert tp.prefetch_stats == jp.prefetch_stats
        assert (tp.rows_seen, tp.cold_rows_seen, tp.disk_rows_seen) == \
            (jp.rows_seen, jp.cold_rows_seen, jp.disk_rows_seen)
        assert tp.disk_rows_seen > 0
        if prefetch:
            assert tp.prefetch_stats["hits"] > 0
        out = tiered_lookup(tp.hot_table, *tp.prepare(ids))
        np.testing.assert_array_equal(out.numpy(), tf[ids].numpy())
        assert tp.cancel_prefetch() == jp.cancel_prefetch()


def test_dram_pipeline_ignores_prefetch_and_static_prefetch_needs_a_pool(tmp_path):
    f = Feature(device="cpu", device_cache_size=10 * ROW)
    f.from_cpu_tensor(_table(50))
    tp = TieredFeaturePipeline(f, prefetch=True)
    assert tp.mode == "dram" and tp.prefetch(np.arange(50)) == 0 and tp.prefetch_stats == {}
    g = Feature(device="cpu", device_cache_size=10 * ROW, disk_path=str(tmp_path / "g.npy"))
    g.from_cpu_tensor(_table(50))
    g.shard_tensor.read_pool = None
    with pytest.raises(ValueError, match="AsyncReadPool"):
        TieredFeaturePipeline(g, prefetch=True)


def _community(tmp_path, name, disk, adaptive=False):
    """The community graph's store in both packages: four tiers, or (no
    ``disk``) the all-DRAM layout."""
    edge_index, feat, labels, n = community_graph()
    kw = dict(device_cache_size=HBM * ROW)
    if disk:
        kw.update(host_memory_budget=HOST * ROW, adaptive_tiers=adaptive)
    jf = JFeature(rank=0, disk_path=str(tmp_path / f"j{name}.npy") if disk else None,
                  read_pool=JAsyncReadPool(2, chunk_rows=32) if disk else None, **kw)
    jf.from_cpu_tensor(feat)
    tf = Feature(rank=0, device="cpu", disk_path=str(tmp_path / f"{name}.npy") if disk else None,
                 read_pool=AsyncReadPool(2, chunk_rows=32) if disk else None, **kw)
    tf.from_cpu_tensor(feat)
    return edge_index, feat, labels, n, jf, tf


def _batches(n, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, BATCH).astype(np.int64) for _ in range(count)]


def _jax_epoch(edge_index, feat, labels, jf, batches, prefetch):
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=4, num_layers=2, dropout=0.0)
    tx = optax.adam(LR)
    pipe = JTieredFeaturePipeline(jf, prefetch=prefetch)
    step_fn = j_make_step(jmodel, tx, jnp.asarray(labels), pipe.hot_table)
    topo = JCSRTopo(edge_index=edge_index)
    ds0 = JSampler(topo, sizes=SIZES, mode="TPU", seed=99).sample_dense(batches[0])
    x0 = jnp.zeros((ds0.n_id.shape[0], feat.shape[1]), jnp.float32)
    params = jmodel.init(jax.random.key(0), x0, ds0.adjs)
    tp = JTrainPipeline(JSampler(topo, sizes=SIZES, mode="TPU", seed=1), jf, step_fn,
                        tiered=pipe)
    _, _, losses = tp.run_epoch(batches, params, tx.init(params), jax.random.key(1))
    return params, losses


def _port_pipeline(edge_index, feat, labels, tf, params, prefetch=False, depth=1):
    model = GraphSAGE(feat.shape[1], 32, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    pipe = TieredFeaturePipeline(tf, prefetch=prefetch)
    step = make_tiered_train_step(model, opt, labels, pipe.hot_table)
    sampler = GraphSageSampler(CSRTopo(edge_index=edge_index), SIZES, seed=1, device="cpu")
    return TrainPipeline(sampler, tf, step, depth=depth, tiered=pipe)


@pytest.mark.parametrize("adaptive", [False, True])
def test_loss_curve_through_the_disk_matches_reference_and_dram(tmp_path, adaptive):
    edge_index, feat, labels, n, jf, tf = _community(tmp_path, "d", True, adaptive)
    _, _, _, _, _, dram = _community(tmp_path, "dram", False)
    batches = _batches(n, 12)
    params, jlosses = _jax_epoch(edge_index, feat, labels, jf, batches, prefetch=True)
    tp = _port_pipeline(edge_index, feat, labels, tf, params, prefetch=True)
    losses = tp.run_epoch(batches)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    assert tp.tiered.mode == ("adaptive" if adaptive else "disk")
    assert tp.tiered.disk_rows_seen > 0
    st = tp.tiered.prefetch_stats
    assert st["hits"] > 0 and st["issued"] >= st["hits"]
    dram_losses = _port_pipeline(edge_index, feat, labels, dram, params).run_epoch(batches)
    assert losses == dram_losses  # bit-equal: the tiers change no byte
    off = _port_pipeline(edge_index, feat, labels, tf, params, depth=2).run_epoch(batches)
    assert off == losses


def test_mid_epoch_disk_error_surfaces_and_cancels_after_the_pools_drain(tmp_path):
    edge_index, feat, labels, n, jf, tf = _community(tmp_path, "err", True)
    batches = _batches(n, 8)
    params = _jax_epoch(edge_index, feat, labels, jf, batches[:1], prefetch=False)[0]
    tp = _port_pipeline(edge_index, feat, labels, tf, params, prefetch=True, depth=2)
    tp.run_epoch(batches[:2])  # the read pool's workers start on first use
    shard = tf.shard_tensor.disk_shard
    orig, calls = shard.read_block, [0]

    def failing(ids):
        calls[0] += 1
        if calls[0] > 2:
            raise OSError("disk died mid-epoch")
        return orig(ids)

    before = sorted(t.name for t in threading.enumerate())
    shard.read_block = failing
    try:
        t0 = time.perf_counter()
        with pytest.raises(OSError, match="disk died mid-epoch"):
            tp.run_epoch(batches)
        assert time.perf_counter() - t0 < 30.0  # surfaced, not hung
    finally:
        shard.read_block = orig
    assert len(tp.tiered._prefetch) == 0  # nothing staged after the unwind
    assert sorted(t.name for t in threading.enumerate()) == before
    losses = tp.run_epoch(batches[:3])
    assert len(losses) == 3 and all(np.isfinite(losses))


# -- the quantized store's disk tier ---------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True])
def test_int8_disk_rows_match_reference_and_decode_bit_exact(tmp_path, adaptive):
    feat = _table(200)
    ei = np.random.default_rng(11).integers(0, 200, (2, 1500))
    opts = dict(device_cache_size=200 * 8 + HBM * DIM, host_memory_budget=HOST * DIM,
                adaptive_tiers=adaptive)
    jq = JQuantizedFeature("int8", csr_topo=JCSRTopo(edge_index=ei),
                           disk_path=str(tmp_path / "jq.npy"), read_pool=JAsyncReadPool(2), **opts)
    jq.from_cpu_tensor(feat)
    tq = QuantizedFeature("int8", csr_topo=CSRTopo(edge_index=ei), device="cpu",
                          disk_path=str(tmp_path / "tq.npy"), read_pool=AsyncReadPool(2), **opts)
    tq.from_cpu_tensor(feat)
    assert tq.tier_bytes() == jq.tier_bytes() and tq.hot_rows == jq.hot_rows
    assert (tq.tier_store is not None) == adaptive
    disk_file = (tq.tier_store.backing if adaptive else tq.shard_tensor.disk_shard).path
    jdisk_file = (jq.tier_store.backing if adaptive else jq.shard_tensor.disk_shard).path
    np.testing.assert_array_equal(np.load(disk_file), np.load(jdisk_file))
    ids = _ids(200, seed=12)
    np.testing.assert_array_equal(tq[ids].numpy(), np.asarray(jq[ids]))
    np.testing.assert_array_equal(tq.decode_rows(ids), np.asarray(jq.decode_rows(ids)))
    if adaptive:
        # K9b reads the side tables by stored row, and an adaptive batch's
        # mapped carries HBM slots: the port refuses the pair
        with pytest.raises(NotImplementedError, match="adaptive"):
            TieredFeaturePipeline(tq)
        return
    tp = TieredFeaturePipeline(tq, prefetch=True)
    tp.prefetch(ids)
    mapped, cold_rows, cold_pos = tp.prepare(ids)
    out = quantized_tiered_lookup(get_codec("int8"), tp.hot_table, mapped, cold_rows, cold_pos,
                                  tq.scale, tq.zero)
    valid = (ids >= 0) & (ids < 200)
    np.testing.assert_array_equal(out.numpy()[valid], tq[ids].numpy()[valid])
    assert tp.disk_rows_seen > 0


def test_disk_read_threads_end_with_their_owner(tmp_path):
    """With the cyclic collector off: a feature's own read pool stops at
    `Feature.close` or when the feature is released, and a pool handed to
    an adaptive store with its prefetch buffer on stops when the feature
    goes (no cycle keeps the store, its pool or their threads)."""
    def pool_threads():
        return {t for t in threading.enumerate() if t.name.startswith("qt-diskread")}

    before = pool_threads()
    gc.disable()
    try:
        for i, (adaptive, close) in enumerate(((False, True), (False, False), (True, False))):
            f = Feature(rank=0, disk_path=str(tmp_path / f"own{i}.npy"),
                        device_cache_size=HBM * ROW, host_memory_budget=HOST * ROW,
                        adaptive_tiers=adaptive, device="cpu",
                        read_pool=AsyncReadPool(2) if adaptive else None, disk_read_workers=2)
            f.from_cpu_tensor(_table(200))
            if adaptive:
                f.tier_store.enable_prefetch()
                f.tier_store.prefetch_rows(np.arange(200))
            f[_ids(200)]
            new = pool_threads() - before
            assert new, "the gather used no pool thread"
            if close:
                f.close()
            del f
            for t in new:
                t.join(timeout=10)
            assert not [t for t in new if t.is_alive()], (adaptive, close)
    finally:
        gc.enable()

"""Parity of the port's quantized feature store with quiver_tpu's, on the
CPU: the codecs, `gather_dequant` and `quantized_tiered_lookup` (the plain
versions of K9a and K9b), `QuantizedFeature` and the quantized train
pipeline.

Shapes: the 304 x 12 table of tests/test_quant.py (a constant row 7 takes
the span-0 encode path), the rows of its large-offset case, and the
community graph of tests/test_pipeline.py. Inputs come from seeded numpy
and go through both packages. Bars:
- encoded bytes (payload, scale, zero) bit-equal;
- decoded and looked-up rows bit-equal (the decode is sub-then-mul in
  both, so no FMA changes a bit);
- the int8 pipeline's loss curve meets tests/test_quant.py's own bar
  against the fp32 one (step by step within 0.25, last four within 0.1)
  and is within 1e-4 of the JAX int8 pipeline's (the bar of
  tests/test_torch_pipeline.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import Feature as JFeature
from quiver_tpu import QuantizedFeature as JQuantizedFeature
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pipeline import TieredFeaturePipeline as JTieredFeaturePipeline
from quiver_tpu.pipeline import TrainPipeline as JTrainPipeline
from quiver_tpu.pipeline import make_tiered_train_step as j_make_step
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.quant import gather_dequant as j_gather_dequant
from quiver_tpu.quant import get_codec as j_get_codec
from quiver_tpu.quant import make_quantized_train_step as j_make_qstep
from quiver_tpu.quant import quantized_tiered_lookup as j_qlookup
from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch.pipeline import TieredFeaturePipeline, TrainPipeline, make_tiered_train_step
from quiver_tpu_torch.quant import (
    QuantizedFeature,
    QuantizedRows,
    gather_dequant,
    get_codec,
    make_quantized_train_step,
    quantized_tiered_lookup,
    register_codec,
)
from quiver_tpu_torch.quant.lookup import gather_dequant_plain, quantized_tiered_lookup_plain
from quiver_tpu_torch.shard_tensor import normalize_dtype

from conftest import make_random_graph
from test_pipeline import community_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

CODECS = ["fp32", "bf16", "int8"]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(11)
    t = (rng.standard_normal((304, 12)) * 3).astype(np.float32)
    t[7, :] = 2.5  # constant row: span-0 encode path
    return t


def _offset_rows():
    """tests/test_quant.py's rows whose offset dwarfs their span."""
    rng = np.random.default_rng(5)
    rows = []
    for expo in range(0, 9):
        for _ in range(4):
            off = 10.0 ** expo * rng.uniform(0.5, 2)
            span = off * 10.0 ** -rng.uniform(0, 6)
            rows.append(off + rng.uniform(0, 1, 32) * span)
    return np.array(rows, dtype=np.float32)


def _bits(x) -> np.ndarray:
    """Raw bytes of a payload: a torch tensor (bfloat16 included) or a
    numpy array (the reference's bfloat16 is an ml_dtypes array)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


def _side(enc):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in (enc.scale, enc.zero)]


def _payload(enc):
    p = enc.payload
    return p if isinstance(p, torch.Tensor) else torch.from_numpy(np.asarray(p))


# -- codecs ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
def test_codec_encode_bit_equal_and_decode_equal(table, name):
    for arr in (table, _offset_rows()):
        want, got = j_get_codec(name).encode(arr), get_codec(name).encode(arr)
        np.testing.assert_array_equal(_bits(got.payload), _bits(want.payload))
        for a, b in zip(got[1:], want[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        np.testing.assert_array_equal(get_codec(name).decode(got), j_get_codec(name).decode(want))
    assert normalize_dtype(get_codec(name).storage_dtype) == get_codec(name).storage_dtype


def test_codec_registry_and_capacity():
    c8, cb, cf = get_codec("int8"), get_codec("bf16"), get_codec("fp32")
    assert get_codec(c8) is c8
    with pytest.raises(ValueError, match="unknown codec"):
        get_codec("int4")
    for c in (c8, cb, cf):
        jc = j_get_codec(c.name)
        assert c.capacity_multiplier(100) == jc.capacity_multiplier(100)
        assert c.row_bytes(12) == jc.row_bytes(12)
    with pytest.raises(ValueError, match="scale and zero"):
        c8.dequant(torch.zeros((2, 3), dtype=torch.int8))


# -- fused dequant-on-gather ------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
def test_gather_dequant_bit_equal(table, name):
    for arr in (table, _offset_rows()):
        enc = get_codec(name).encode(arr)
        jenc = j_get_codec(name).encode(arr)
        n = arr.shape[0]
        ids = np.array([0, 7, n // 2, n - 1, 42 % n, -3, n + 5], np.int32)
        want = np.asarray(jax.jit(lambda p, i, s, z: j_gather_dequant(name, p, i, s, z))(
            jnp.asarray(jenc.payload), jnp.asarray(ids),
            None if jenc.scale is None else jnp.asarray(jenc.scale),
            None if jenc.zero is None else jnp.asarray(jenc.zero)))
        got = gather_dequant(name, _payload(enc), torch.from_numpy(ids), *_side(enc))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), j_get_codec(name).decode(jenc)[
            np.clip(ids, 0, n - 1)])
        # ids of another shape, and the feature order as an index map
        order = torch.from_numpy(np.random.default_rng(3).permutation(n).astype(np.int32))
        grid = torch.from_numpy(ids[:6].reshape(2, 3))
        mapped = gather_dequant(name, _payload(enc), grid, *_side(enc), index_map=order)
        flat = order[torch.clamp(grid.reshape(-1).long(), 0, n - 1)]
        assert mapped.shape == (2, 3, arr.shape[1])
        assert torch.equal(mapped.reshape(6, -1), gather_dequant_plain(name, _payload(enc),
                                                                       flat, *_side(enc)))


@pytest.mark.parametrize("name", CODECS)
def test_quantized_tiered_lookup_bit_equal_through_the_pipeline(table, name):
    """tests/test_quant.py's tiered case: a hot prefix under the
    side-table-first budget, encoded cold rows staged by the pipeline,
    decode after scatter; ids -3 and 1000 invalid."""
    c = get_codec(name)
    budget = int(300 * c.side_bytes_per_row + 120 * 12 * c.bytes_per_elem)
    jq = JQuantizedFeature(name, rank=0, device_cache_size=budget)
    jq.from_cpu_tensor(table[:300])
    tq = QuantizedFeature(name, rank=0, device_cache_size=budget, device="cpu")
    tq.from_cpu_tensor(table[:300])
    assert tq.hot_rows == jq.hot_rows == 120
    jp, tp = JTieredFeaturePipeline(jq), TieredFeaturePipeline(tq)
    assert tp.cold_np.dtype == c.storage_dtype
    req = np.array([0, 119, 120, 299, 5, -3, 1000, 42, 7], np.int64)
    jh, th = jp.prepare_host(req), tp.prepare_host(req)
    np.testing.assert_array_equal(th.mapped.numpy(), jh.mapped)
    np.testing.assert_array_equal(th.pos.numpy(), jh.pos)
    np.testing.assert_array_equal(_bits(th.rows), _bits(jh.rows))
    want = np.asarray(j_qlookup(name, jp.hot_table, *jp.upload(jh), jq.scale, jq.zero))
    got = quantized_tiered_lookup(name, tp.hot_table, *tp.upload(th), tq.scale, tq.zero)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tq.decode_rows(req))
    ok = (req >= 0) & (req < 300)
    assert (got.numpy()[~ok] == 0).all()
    # a cold lane no cold row covers decodes to the zero point, as in the reference
    m = torch.tensor([0, 200, -1], dtype=torch.int32)
    empty, none = th.rows[:0], torch.zeros(0, dtype=torch.int32)
    got2 = quantized_tiered_lookup(name, tp.hot_table, m, empty, none, tq.scale, tq.zero)
    want2 = np.asarray(j_qlookup(name, jp.hot_table, jnp.asarray(m.numpy()),
                                 jnp.zeros((0, 12), jh.rows.dtype), jnp.zeros(0, jnp.int32),
                                 jq.scale, jq.zero))
    np.testing.assert_array_equal(got2.numpy(), want2)
    assert torch.equal(got2, quantized_tiered_lookup_plain(name, tp.hot_table, m, empty, none,
                                                           tq.scale, tq.zero))


# -- QuantizedFeature ---------------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("reorder", [False, True])
def test_quantized_feature_lookups_equal_reference(table, name, reorder):
    c = get_codec(name)
    budget = int(304 * c.side_bytes_per_row + 100 * 12 * c.bytes_per_elem)
    kw = dict(rank=0, device_cache_size=budget)
    edges = make_random_graph(304, 3000, seed=3)
    jq = JQuantizedFeature(name, csr_topo=JCSRTopo(edge_index=edges) if reorder else None, **kw)
    jq.from_cpu_tensor(table)
    tq = QuantizedFeature(name, csr_topo=CSRTopo(edge_index=edges) if reorder else None,
                          device="cpu", **kw)
    tq.from_cpu_tensor(table)
    assert tq.hot_rows == jq.hot_rows == 100
    assert (tq.feature_order is None) == (not reorder)
    if reorder:
        np.testing.assert_array_equal(tq.feature_order, jq.feature_order)
    ids = np.array([5, 100, 250, 303, 0, 7, -1, 999])
    np.testing.assert_array_equal(tq[ids].numpy(), np.asarray(jq[ids]))
    np.testing.assert_array_equal(tq[torch.from_numpy(ids)].numpy(), np.asarray(jq[ids]))
    np.testing.assert_array_equal(tq.decode_rows(ids), jq.decode_rows(ids))
    assert tq.tier_bytes() == jq.tier_bytes()
    assert tq.side_table_bytes() == jq.side_table_bytes()
    np.testing.assert_array_equal(tq.stored_rows_of(ids), jq.stored_rows_of(ids))
    np.testing.assert_array_equal(tq.node_ids_of_stored(np.arange(5)),
                                  jq.node_ids_of_stored(np.arange(5)))
    assert tq.shape == jq.shape and tq.dim == 12 and tq.size(0) == 304
    with pytest.raises(ValueError, match="2 of 8"):
        tq.validate_ids(ids)
    with pytest.raises(ValueError, match="device-resident"):
        tq.lookup_padded(torch.from_numpy(ids))
    # fully resident: lookup_padded (K9a's plain version) clips ids
    full = int(304 * c.side_bytes_per_row + 304 * 12 * c.bytes_per_elem)
    jr = JQuantizedFeature(name, rank=0, device_cache_size=full,
                           csr_topo=JCSRTopo(edge_index=edges) if reorder else None)
    jr.from_cpu_tensor(table)
    tr = QuantizedFeature(name, rank=0, device_cache_size=full, device="cpu",
                          csr_topo=CSRTopo(edge_index=edges) if reorder else None)
    tr.from_cpu_tensor(table)
    padded = np.array([0, 13, 303, -1, 400, 77], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    want = np.asarray(jr.lookup_padded(jnp.asarray(padded), jnp.asarray(valid)))
    got = tr.lookup_padded(torch.from_numpy(padded), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tr.lookup_padded(padded.astype(np.int64)).numpy(),
                                  np.asarray(jr.lookup_padded(jnp.asarray(padded))))


def test_capacity_accounting_and_refusals(table):
    c8 = get_codec("int8")
    budget = 100 * 12 * 4
    q8 = QuantizedFeature("int8", device_cache_size=budget, device="cpu")
    q8.from_cpu_tensor(table)
    assert q8.hot_rows == 197  # (4800 - 2432) // 12
    tb = q8.tier_bytes()
    assert tb["row"] == 12 and tb["device"] == 197 * 12
    assert q8.side_table_bytes() == 304 * c8.side_bytes_per_row
    assert tb["device"] + q8.side_table_bytes() <= budget
    assert q8.dtype == torch.int8 and q8.shard_tensor.cpu_tensor.dtype == torch.int8
    with pytest.raises(ValueError, match="side tables"):
        QuantizedFeature("int8", device_cache_size=304 * 8 - 1, device="cpu").from_cpu_tensor(
            table)
    allcold = QuantizedFeature("int8", device_cache_size=0, device="cpu")
    allcold.from_cpu_tensor(table)
    assert allcold.hot_rows == 0
    np.testing.assert_array_equal(allcold[np.arange(5)].numpy(),
                                  allcold.decode_rows(np.arange(5)))
    for policy in ("p2p_clique_replicate", "ici_replicate"):
        with pytest.raises(NotImplementedError):
            QuantizedFeature("int8", cache_policy=policy, device="cpu")

    class F16Codec:
        name, storage_dtype = "f16-test", np.dtype(np.float16)
        bytes_per_elem, side_bytes_per_row = 2.0, 0.0

        def encode(self, arr):
            return QuantizedRows(np.asarray(arr, np.float32).astype(np.float16))

    register_codec(F16Codec())
    with pytest.raises(TypeError, match="not ported"):
        QuantizedFeature("f16-test", device="cpu").from_cpu_tensor(table)


def test_feature_stores_int8_and_bf16_rows(table):
    """A `Feature` of int8 or bfloat16 keeps the stored dtype in both tiers;
    gather_stored returns it, bit-equal to the reference's."""
    for name in ("int8", "bfloat16"):
        enc = get_codec("int8" if name == "int8" else "bf16").encode(table).payload
        jenc = j_get_codec("int8" if name == "int8" else "bf16").encode(table).payload
        jf = JFeature(rank=0, device_list=[0], device_cache_size=100 * 12 * (1 if name == "int8"
                                                                              else 2),
                      dtype=name)
        jf.from_cpu_tensor(jenc)
        tf = Feature(device_cache_size=100 * 12 * (1 if name == "int8" else 2), dtype=name,
                     device="cpu")
        tf.from_cpu_tensor(enc)
        st = tf.shard_tensor
        assert st.device_rows.dtype == st.cpu_tensor.dtype == normalize_dtype(name)
        assert tf.tier_bytes() == jf.tier_bytes()
        stored = np.array([0, 99, 100, 303, -1, 304])
        np.testing.assert_array_equal(_bits(tf.gather_stored(stored)),
                                      _bits(np.asarray(jf.gather_stored(stored))))
        with pytest.raises(TypeError, match="float32"):
            tf[np.arange(3)]
    bf = Feature(device_cache_size=0, dtype="bf16", device="cpu")
    bf.from_cpu_tensor(table)  # a float32 table rounds to bfloat16 on ingest
    np.testing.assert_array_equal(_bits(bf.gather_stored(np.arange(304))),
                                  _bits(j_get_codec("bf16").encode(table).payload))


# -- the quantized pipeline ----------------------------------------------------------------

def _run(feature_pair, step_makers, edge_index, labels, batches):
    """One epoch of the JAX pipeline and of the port's over the same
    feature pair, from the JAX model's weights; returns both curves."""
    jfeat, tfeat = feature_pair
    jmake, tmake = step_makers
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=4, num_layers=2, dropout=0.0)
    tx = optax.adam(5e-3)
    jpipe = JTieredFeaturePipeline(jfeat)
    topo = JCSRTopo(edge_index=edge_index)
    boot = JSampler(topo, sizes=[5, 5], mode="TPU", seed=1)
    ds0 = boot.sample_dense(batches[0])
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], 16)), ds0.adjs)
    jtp = JTrainPipeline(JSampler(topo, sizes=[5, 5], mode="TPU", seed=1), jfeat,
                         jmake(jmodel, tx, jpipe), tiered=jpipe)
    _, _, jlosses = jtp.run_epoch(batches, params, tx.init(params), jax.random.key(1))
    model = GraphSAGE(16, 32, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    tpipe = TieredFeaturePipeline(tfeat)
    sampler = GraphSageSampler(CSRTopo(edge_index=edge_index), [5, 5], mode="TPU", seed=1,
                               device="cpu")
    tp = TrainPipeline(sampler, tfeat, tmake(model, opt, tpipe), tiered=tpipe)
    return np.asarray(jlosses), np.asarray(tp.run_epoch(batches)), tp.stats


def test_int8_pipeline_meets_the_fp32_bar_and_tracks_jax():
    """tests/test_quant.py's probe on the port: identical draws and init,
    fp32 tiered pipeline vs int8 quantized pipeline with real cold
    (encoded) traffic."""
    edge_index, feat, labels, n = community_graph()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, n, 32).astype(np.int64) for _ in range(12)]
    f32 = (JFeature(rank=0, device_list=[0], device_cache_size=(n // 2) * 16 * 4),
           Feature(device_cache_size=(n // 2) * 16 * 4, device="cpu"))
    for f in f32:
        f.from_cpu_tensor(feat)
    jl_f, losses_f, _ = _run(
        f32, (lambda m, tx, p: j_make_step(m, tx, jnp.asarray(labels), p.hot_table),
              lambda m, o, p: make_tiered_train_step(m, o, labels, p.hot_table)),
        edge_index, labels, batches)
    budget = int(n * 8 + (n // 2) * 16)
    q8 = (JQuantizedFeature("int8", rank=0, device_cache_size=budget),
          QuantizedFeature("int8", device_cache_size=budget, device="cpu"))
    for f in q8:
        f.from_cpu_tensor(feat)
    jl_q, losses_q, stats = _run(
        q8, (lambda m, tx, p: j_make_qstep(m, tx, jnp.asarray(labels), p.hot_table, q8[0].scale,
                                           q8[0].zero, codec="int8"),
             lambda m, o, p: make_quantized_train_step(m, o, labels, p.hot_table, q8[1].scale,
                                                       q8[1].zero, codec="int8")),
        edge_index, labels, batches)
    assert stats.cold_rows > 0 and np.isfinite(losses_q).all()
    assert np.abs(losses_q - losses_f).max() < 0.25
    assert abs(np.mean(losses_q[-4:]) - np.mean(losses_f[-4:])) < 0.1
    assert np.mean(losses_q[-4:]) < np.mean(losses_q[:4])
    np.testing.assert_allclose(losses_f, jl_f, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(losses_q, jl_q, atol=1e-4, rtol=1e-4)

"""The port's `inference.BucketPrograms` against quiver_tpu's, on the CPU,
at the tiny shapes of tests/test_torch_serve.py (200 nodes, 2,000 edges,
DIM 16, sizes [4, 4]) and tests/test_torch_temporal.py (timestamps
uniform in [0, 50), max_deg 128): both packages' programs over the same
graph, converted params and key stream.

Bars: logits at every warmed bucket within atol = rtol = 1e-5 (XLA-CPU and
torch-CPU sum in different orders), for the tiled dedup, flat no-dedup and
temporal steps; `rebind` refuses a shape change with ValueError in both;
after a same-shaped `rebind`, a call with the old `binding()` snapshot
gives the old arrays' logits and a call without it the new ones', in
both; `reprovision` returns the same count in both, with `sealed` equal
before and after, and a sealed table it emptied misses hard in both;
`time_eval_split` takes as many sampler keys as the JAX one. The port's
call reads its hop keys as words from its input buffer (`random.
hop_key_words`), the layout a captured graph reads on the card; the
plain draws read them back bit-equal (`test_hop_key_words_*`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import inference as jinf
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.workloads import TemporalTiledGraph as JTemporalTiledGraph
from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler, sage_params_from_flax
from quiver_tpu_torch import inference as tinf
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.pyg.sage_sampler import sample_dense_fused, sample_dense_pure
from quiver_tpu_torch.workloads import TemporalTiledGraph

from conftest import make_random_graph

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, MAXD = 200, 16, [4, 4], 3, 128
BUCKETS = (1, 2, 4, 8)
TOL = dict(atol=1e-5, rtol=1e-5)
EDGE_INDEX = make_random_graph(N_NODES, 2000, seed=0)
BASE_TS = np.random.default_rng(11).uniform(0.0, 50.0, 4000).astype(np.float32)
# the step kinds: (layout, dedup, temporal)
KINDS = {"tiled-dedup": ("tiled", True, False), "flat": ("flat", False, False),
         "temporal": ("tiled", False, True)}


@pytest.fixture(scope="module")
def setup():
    feat = np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=5, num_layers=2, dropout=0.0)
    js = JSampler(JCSRTopo(edge_index=EDGE_INDEX), sizes=SIZES, mode="TPU", seed=SEED)
    ds0 = js.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], DIM)), ds0.adjs)
    tparams = sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model = tinf.bind_params(GraphSAGE(DIM, 16, 5, num_layers=2, dropout=0.0), tparams, "cpu")
    return dict(feat=feat, jmodel=jmodel, params=params, model=model)


def _samplers(kind, edge_index=EDGE_INDEX):
    """The JAX and the port sampler of one step kind over one graph."""
    layout, dedup, temporal = KINDS[kind]
    jtopo, ttopo = JCSRTopo(edge_index=edge_index), CSRTopo(edge_index=edge_index)
    js = JSampler(jtopo, sizes=SIZES, mode="TPU", seed=SEED, layout=layout, dedup=dedup,
                  max_deg=MAXD)
    ts = GraphSageSampler(ttopo, SIZES, device="cpu", seed=SEED, layout=layout, dedup=dedup,
                          max_deg=MAXD)
    if temporal:
        ts_edges = BASE_TS[: ttopo.edge_count]
        js.bind_temporal(JTemporalTiledGraph(jtopo, ts_edges), recency=0.02)
        ts.bind_temporal(TemporalTiledGraph(ttopo, ts_edges, device="cpu"), recency=0.02)
    return js, ts


def _programs(s, kind, feat=None):
    js, ts = _samplers(kind)
    feat = s["feat"] if feat is None else feat
    return (jinf.BucketPrograms(s["jmodel"], js, feat), tinf.BucketPrograms(ts, feat),
            js, ts)


def _inputs(bucket, i, temporal):
    """Padded seeds, the i-th key of both packages and the query times."""
    rng = np.random.default_rng(100 + 7 * bucket + i)
    seeds = rng.integers(0, N_NODES, bucket).astype(np.int64)
    extra = (rng.uniform(10.0, 60.0, bucket).astype(np.float32),) if temporal else ()
    jkey = jax.random.fold_in(jax.random.key(SEED), i)
    tkey = qrandom.fold_in(qrandom.key(SEED), i)
    return seeds, jkey, tkey, extra


def _both(s, jp, tp, bucket, i, temporal, **kw):
    seeds, jkey, tkey, extra = _inputs(bucket, i, temporal)
    jb = {"binding": kw["jbinding"]} if "jbinding" in kw else {}
    tb = {"binding": kw["tbinding"]} if "tbinding" in kw else {}
    want = np.asarray(jp(bucket, s["params"], jkey, seeds, *extra, **jb))
    got = tp(bucket, s["model"], tkey, seeds, *extra, **tb)
    assert isinstance(got, np.ndarray) and got.shape == (bucket, 5)
    return want, got


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logits_match_reference_at_every_warmed_bucket(setup, kind):
    temporal = KINDS[kind][2]
    jp, tp, _, ts = _programs(setup, kind)
    for b in BUCKETS:
        jp.compile_bucket(b, setup["params"])
        tp.compile_bucket(b, setup["model"])
    jp.seal()
    tp.seal()
    assert tp.buckets == jp.buckets == BUCKETS and tp.sealed and jp.sealed
    assert ts._call == 0  # warming took no key of the sampler
    for i, b in enumerate(BUCKETS * 2):
        want, got = _both(setup, jp, tp, b, i, temporal)
        np.testing.assert_allclose(got, want, **TOL)
    for p, params in ((jp, setup["params"]), (tp, setup["model"])):
        with pytest.raises(RuntimeError):  # a post-seal miss is hard in both
            seeds, jkey, tkey, extra = _inputs(16, 0, temporal)
            p(16, params, jkey if p is jp else tkey, seeds, *extra)


def test_fused_call_equals_the_split_path_bit_for_bit(setup):
    """The port's call (hop key words through its input buffer) against
    `sample_batch` + `forward_logits` on the same key (split path)."""
    _, tp, _, ts = _programs(setup, "tiled-dedup")
    for i, b in enumerate(BUCKETS):
        seeds, _, _, _ = _inputs(b, i, False)
        got = tp(b, setup["model"], ts.next_key(), seeds)
        ts._call -= 1
        want = tinf.batch_logits(setup["model"], ts, setup["feat"], seeds).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("which", ["graph", "table"])
def test_rebind_refuses_a_shape_change_in_both(setup, which):
    jp, tp, _, _ = _programs(setup, "tiled-dedup")
    jbig, tbig = _samplers("tiled-dedup", make_random_graph(N_NODES + 60, 2600, seed=1))
    jtable, jmap, jgraph = jp.binding()
    ttable, tmap, tgraph = tp.binding()
    if which == "graph":
        jargs = dict(graph=jinf.make_serve_step(setup["jmodel"], jbig)[1])
        targs = dict(graph=tinf.make_serve_step(tbig)[1])
    else:
        jargs = dict(table=jnp.zeros((N_NODES, DIM + 1), jnp.float32))
        targs = dict(table=torch.zeros((N_NODES, DIM + 1)))
    with pytest.raises(ValueError):
        jp.rebind(**jargs)
    with pytest.raises(ValueError):
        tp.rebind(**targs)
    # an index map where none is bound is refused too
    with pytest.raises(ValueError):
        jp.rebind(index_map=jnp.zeros((N_NODES,), jnp.int32))
    with pytest.raises(ValueError):
        tp.rebind(index_map=torch.zeros((N_NODES,), dtype=torch.int32))
    assert jp.binding()[0] is jtable and tp.binding()[0] is ttable


@pytest.mark.parametrize("kind", ["tiled-dedup", "temporal"])
def test_binding_snapshot_runs_the_old_arrays_after_a_rebind(setup, kind):
    temporal = KINDS[kind][2]
    jp, tp, _, _ = _programs(setup, kind)
    for b in (4, 8):
        jp.compile_bucket(b, setup["params"])
        tp.compile_bucket(b, setup["model"])
    jp.seal()
    tp.seal()
    jold, told = jp.binding(), tp.binding()
    before = _both(setup, jp, tp, 8, 1, temporal)
    table2 = (setup["feat"] * 2.0 + 1.0).astype(np.float32)
    jp.rebind(table=jnp.asarray(table2))
    tp.rebind(table=torch.from_numpy(table2))
    assert tp.binding() is not told and tp.buckets == (4, 8) and tp.sealed
    old = _both(setup, jp, tp, 8, 1, temporal, jbinding=jold, tbinding=told)
    new = _both(setup, jp, tp, 8, 1, temporal)
    for want, got in (before, old, new):
        np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(old[1], before[1]) and np.array_equal(old[0], before[0])
    assert not np.allclose(new[1], old[1])
    # the new arrays give a fresh programs' logits over the new table
    _, fresh, _, _ = _programs(setup, kind, feat=table2)
    seeds, _, tkey, extra = _inputs(8, 1, temporal)
    assert np.array_equal(new[1], fresh(8, setup["model"], tkey, seeds, *extra))
    with pytest.raises(TypeError):  # binding= takes a snapshot of these programs
        tp(8, setup["model"], tkey, seeds, *extra, binding=tuple(told))


def test_reprovision_count_and_sealed_match_reference(setup):
    jp, tp, _, _ = _programs(setup, "tiled-dedup")
    for b in (2, 8):
        jp.compile_bucket(b, setup["params"])
        tp.compile_bucket(b, setup["model"])
    jp.seal()
    tp.seal()
    # the same shapes: a content rebind, nothing rebuilt
    assert jp.reprovision(jp.binding()[2], setup["params"]) == \
        tp.reprovision(tp.binding()[2], setup["model"]) == 0
    assert jp.sealed and tp.sealed and jp.buckets == tp.buckets == (2, 8)
    # a grown graph: every warmed bucket rebuilt, still sealed
    grown = make_random_graph(N_NODES + 60, 2600, seed=1)
    jbig, tbig = _samplers("tiled-dedup", grown)
    jg = jinf.make_serve_step(setup["jmodel"], jbig)[1]
    tg = tinf.make_serve_step(tbig)[1]
    assert jp.reprovision(jg, setup["params"]) == tp.reprovision(tg, setup["model"]) == 2
    assert jp.sealed and tp.sealed and jp.buckets == tp.buckets == (2, 8)
    want, got = _both(setup, jp, tp, 8, 3, False)
    np.testing.assert_allclose(got, want, **TOL)
    # without weights the table is left empty: sealed, the next call misses hard
    jp2, tp2, _, _ = _programs(setup, "tiled-dedup")
    for p, params in ((jp2, setup["params"]), (tp2, setup["model"])):
        p.compile_bucket(4, params)
        p.seal()
    assert jp2.reprovision(jg) == tp2.reprovision(tg) == 1
    assert jp2.buckets == tp2.buckets == () and jp2.sealed and tp2.sealed
    seeds, jkey, tkey, _ = _inputs(4, 0, False)
    with pytest.raises(RuntimeError):
        jp2(4, setup["params"], jkey, seeds)
    with pytest.raises(RuntimeError):
        tp2(4, setup["model"], tkey, seeds)


def test_time_eval_split_takes_the_reference_keys(setup):
    js, ts = _samplers("tiled-dedup")
    batch = np.arange(8, dtype=np.int64)
    jt = jinf.time_eval_split(setup["jmodel"].apply, setup["params"], js, setup["feat"], batch,
                              iters=3)
    tt = tinf.time_eval_split(setup["model"], ts, setup["feat"], batch, iters=3)
    assert js._call == ts._call == 4
    assert all(isinstance(x, float) and x > 0 for x in (*jt, *tt))


@pytest.mark.parametrize("dedup", [True, False])
def test_hop_key_words_give_the_split_keys_draws(setup, dedup):
    """A multi-hop draw from the hops' key words (a uint32 [hops, 2]
    tensor, as the captured step reads them) equals the draw from the host
    key it was split from, bit for bit."""
    _, ts = _samplers("tiled-dedup" if dedup else "flat")
    sample_fn = ts._bind(ts.lazy_init_quiver())
    key = qrandom.fold_in(qrandom.key(SEED), 9)
    words = torch.from_numpy(qrandom.hop_key_words(key, len(SIZES)).view(np.int32))
    seeds = ts.as_seeds(np.arange(6))
    run = ((lambda k: sample_dense_pure(None, None, k, seeds, SIZES, sample_fn=sample_fn))
           if dedup else
           (lambda k: sample_dense_fused(None, None, k, seeds, SIZES, sample_fn=sample_fn)))
    a, b = run(key), run(words.view(torch.uint32))
    assert torch.equal(a.n_id, b.n_id) and torch.equal(a.count, b.count)
    for x, y in zip(a.adjs, b.adjs):
        assert torch.equal(x.mask, y.mask)
        assert (x.cols is None and y.cols is None) or torch.equal(x.cols, y.cols)
    assert qrandom.hop_keys(key, 2) == [qrandom.host_key(r) for r in
                                        qrandom.hop_keys(words.view(torch.uint32), 2)]
    with pytest.raises(ValueError):
        qrandom.hop_keys(words.view(torch.uint32), 3)

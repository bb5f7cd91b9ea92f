"""The captured training steps (`quiver_tpu_torch.train_programs`, the
tiered and quantized pipeline steps) against the JAX package's jitted train
steps on the CPU, and the captured graphs against the eager steps on the
card.

CPU (the steps' CPU form, which runs the step body eagerly on the same
staged inputs): `make_train_step` against the JAX example's jitted
``train_step`` (rebuilt here from the JAX package's `GraphSAGE` and
``optax.adam``); `make_sample_train_step` in each mode against the JAX
package's `sample_dense` or ``sample_and_gather_*`` and the jitted step, the
draws (ids, masks, counts, gathered rows) bit-equal; the staged key words
and the key stream; the ``auto_grow_caps`` split; the tiered and quantized
steps against ``make_tiered_train_step`` and ``make_quantized_train_step``;
the refusals. Shapes: a 200-node random graph, DIM 16, sizes [4, 4],
batches of 16. Losses within 1e-4 (the bar of
``test_torch_train.py::test_adam_loss_curve_matches_optax``: torch and XLA
sum in different orders and Adam divides by sqrt(v)).

The card (marked ``cuda``, skipped here): each mode and GCN and GAT,
captured against the eager step bit for bit at dropout 0; the refused
non-capturable optimizer; a recapture after ``load_state_dict``, still
bit-equal; dropout masks that differ from replay to replay. Run them on
the H100 with ``python -m pytest --noconftest -m cuda
tests/test_torch_train_programs.py``; this file imports without JAX there."""

import copy

import numpy as np
import pytest
import torch

from quiver_tpu_torch import GAT, GCN, CSRTopo, Feature, GraphSAGE, GraphSageSampler
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch import train_programs
from quiver_tpu_torch.inference import lookup_features
from quiver_tpu_torch.models.sage import dropout
from quiver_tpu_torch.pipeline import TieredBatch, TieredFeaturePipeline, make_tiered_train_step
from quiver_tpu_torch.quant import QuantizedFeature, make_quantized_train_step
from quiver_tpu_torch.train_programs import (TrainPrograms, descend, make_sample_train_step,
                                             make_train_step)

from torch_fixtures import cuda_device  # noqa: F401 (a fixture)

try:
    import jax
    import jax.numpy as jnp
    import optax

    from quiver_tpu import CSRTopo as JCSRTopo
    from quiver_tpu import Feature as JFeature
    from quiver_tpu.models import GraphSAGE as JGraphSAGE
    from quiver_tpu.pipeline import TieredBatch as JTieredBatch
    from quiver_tpu.pipeline import TieredFeaturePipeline as JTieredFeaturePipeline
    from quiver_tpu.pipeline import make_tiered_train_step as j_make_tiered_step
    from quiver_tpu.pyg import sage_sampler as jss
    from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
    from quiver_tpu.quant import QuantizedFeature as JQuantizedFeature
    from quiver_tpu.quant import make_quantized_train_step as j_make_quantized_step
    from quiver_tpu_torch import sage_params_from_flax
except ImportError:  # the card's machine has no JAX: only the cuda tests run there
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is the CPU reference")

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N_NODES, DIM, SIZES, SEED, CLASSES, BATCH, LR = 200, 16, (4, 4), 3, 5, 16, 5e-3
CURVE = dict(atol=1e-4, rtol=1e-4)


def _edges():
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, N_NODES, 2000), rng.integers(0, N_NODES, 2000)])


def _table():
    return np.random.default_rng(0).standard_normal((N_NODES, DIM)).astype(np.float32)


def _labels():
    return np.random.default_rng(7).integers(0, CLASSES, N_NODES).astype(np.int32)


def _batches(count, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.choice(N_NODES, BATCH, replace=False) for _ in range(count)]


# -- the JAX side: the example's jitted train_step ----------------------------------

def _jax_setup(x0, adjs0):
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=CLASSES, num_layers=2, dropout=0.0)
    params = jmodel.init(jax.random.key(0), x0, adjs0)
    tx = optax.adam(LR)

    @jax.jit
    def train_step(params, opt_state, key, x, adjs, y):
        def loss_fn(p):
            logits = jmodel.apply(p, x, adjs, train=True, rngs={"dropout": key})
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jmodel, params, tx, train_step


def _port_model(jparams, dropout=0.0):
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=dropout)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    return model


def _jtake(table, n_id):
    return jnp.take(jnp.asarray(table), jnp.clip(n_id, 0, N_NODES - 1), axis=0)


@needs_jax
def test_train_step_cpu_form_matches_the_jax_example_step():
    ei, table, labels = _edges(), _table(), _labels()
    js = JSampler(JCSRTopo(edge_index=ei), sizes=list(SIZES), mode="TPU", seed=SEED)
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu")
    batches = _batches(10)
    jds = js.sample_dense(batches[0])
    _, jparams, tx, jstep = _jax_setup(_jtake(table, jds.n_id), jds.adjs)
    jstate = tx.init(jparams)
    model = _port_model(jparams)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR), device="cpu")
    assert step.model is model and not step.programs.graph_stats()["graphs"]
    jl, tl = [], []
    for i, seeds in enumerate(batches):
        jds = jds if i == 0 else js.sample_dense(seeds)
        tds = ts.sample_dense(seeds)
        y = labels[seeds]
        jparams, jstate, jloss = jstep(jparams, jstate, jax.random.key(i),
                                       _jtake(table, jds.n_id), jds.adjs, jnp.asarray(y))
        tloss = step(lookup_features(torch.from_numpy(table), tds.n_id), tds.adjs,
                     torch.from_numpy(y))
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, **CURVE)
    assert np.mean(tl[-3:]) < np.mean(tl[:3])


def _recording(monkeypatch):
    """Record the gathered rows and hops each step hands to `descend`."""
    seen = []
    real = train_programs.descend

    def descend_and_record(model, optimizer, x, adjs, y, generator):
        seen.append((x.clone(), adjs, y.clone()))
        return real(model, optimizer, x, adjs, y, generator)

    monkeypatch.setattr(train_programs, "descend", descend_and_record)
    return seen


def _jax_leg(mode, js, jt, table, jfeat, seeds, call, caps):
    """The JAX package's sample of one batch (the sampler's draw for
    "dense", the call's key for the sample-and-gather modes) and its rows."""
    if mode == "dense":
        jds = js.sample_dense(seeds)
        x = jfeat.lookup_padded(jds.n_id) if jfeat is not None else _jtake(table, jds.n_id)
        return jds, x
    key = jax.random.fold_in(jax.random.key(SEED), call)
    fn = getattr(jss, "sample_and_gather_" + mode)
    kw = {} if mode == "fused" else {"caps": caps}
    return fn(*jt.to_device(), jnp.asarray(table), key, jnp.asarray(seeds.astype(np.int32)),
              SIZES, **kw)


@needs_jax
@pytest.mark.parametrize("mode,source,caps", [("dense", "table", None),
                                              ("dense", "feature", None),
                                              ("dense", "table", (40, None)),
                                              ("fused", "table", None),
                                              ("dedup", "table", None),
                                              ("dedup", "table", (40, None))])
def test_sample_train_step_draws_bit_equal_and_losses_match_jax(monkeypatch, mode, source, caps):
    ei, table, labels = _edges(), _table(), _labels()
    jt, tt = JCSRTopo(edge_index=ei), CSRTopo(edge_index=ei)
    js = JSampler(jt, sizes=list(SIZES), mode="TPU", seed=SEED, caps=caps)
    # the sample-and-gather functions draw over the flat CSR they are given
    # (tiled draws are the same, but their invalid lanes name node 0)
    ts = GraphSageSampler(tt, sizes=list(SIZES), seed=SEED, device="cpu", caps=caps,
                          layout="tiled" if mode == "dense" else "flat")
    jfeat, tsrc = None, torch.from_numpy(table)
    if source == "feature":
        jfeat = JFeature(rank=0, device_list=[0], device_cache_size="1M", csr_topo=jt)
        jfeat.from_cpu_tensor(table)
        tsrc = Feature(rank=0, device_list=[0], device_cache_size="1M", csr_topo=tt,
                       device="cpu")
        tsrc.from_cpu_tensor(table)
    batches = _batches(6)
    jds, jx = _jax_leg(mode, js, jt, table, jfeat, batches[0], 0, caps)
    _, jparams, tx, jstep = _jax_setup(jx, jds.adjs)
    jstate = tx.init(jparams)
    model = _port_model(jparams)
    seen = _recording(monkeypatch)
    step = make_sample_train_step(ts, tsrc, labels, model,
                                  torch.optim.Adam(model.parameters(), lr=LR), mode=mode)
    assert step.captures_sample
    jl, tl = [], []
    for i, seeds in enumerate(batches):
        if i:
            jds, jx = _jax_leg(mode, js, jt, table, jfeat, seeds, i, caps)
        jparams, jstate, jloss = jstep(jparams, jstate, jax.random.key(i), jx, jds.adjs,
                                       jnp.asarray(labels[seeds]))
        tloss, edges = step(seeds)
        x, adjs, y = seen[-1]
        assert np.array_equal(x.numpy(), np.asarray(jx))  # the gathered rows: the ids
        assert np.array_equal(y.numpy(), labels[seeds])
        for ja, ta in zip(jds.adjs, adjs):
            mask = np.asarray(ja.mask)
            assert np.array_equal(mask, ta.mask.numpy())
            assert int(ja.n_src) == int(ta.n_src) and int(ja.n_dst) == int(ta.n_dst)
            assert (ja.cols is None) == (ta.cols is None)
            if ja.cols is not None:
                assert np.array_equal(np.asarray(ja.cols)[mask], ta.cols.numpy()[mask])
        assert int(edges) == sum(int(np.asarray(a.mask).sum()) for a in jds.adjs)
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, **CURVE)
    assert ts._call == len(batches)


@pytest.mark.parametrize("mode,drawn,at", [("dense", "sample_dense_pure", 2),
                                           ("fused", "sample_and_gather_fused", 3),
                                           ("dedup", "sample_and_gather_dedup", 3)])
def test_staged_key_words_are_the_eager_keys_and_the_stream_advances_alike(monkeypatch, mode,
                                                                           drawn, at):
    ei, table = _edges(), torch.from_numpy(_table())
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu")
    twin = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu")
    keys = []
    real = getattr(train_programs, drawn)

    def record(*args, **kw):
        keys.append(args[at].clone())  # the key argument
        return real(*args, **kw)

    monkeypatch.setattr(train_programs, drawn, record)
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.0)
    step = make_sample_train_step(ts, table, _labels(), model,
                                  torch.optim.Adam(model.parameters(), lr=LR), mode=mode)
    for seeds in _batches(4):
        step(seeds)
        twin.sample_dense(seeds)
        want = qrandom.hop_key_words(qrandom.fold_in(qrandom.key(SEED), twin._call - 1),
                                     len(SIZES))
        assert keys[-1].dtype == torch.uint32
        assert np.array_equal(keys[-1].numpy().view(np.uint32), want)
    assert ts._call == twin._call == 4


@needs_jax
def test_auto_grow_caps_regrows_outside_the_step_and_the_losses_match(monkeypatch):
    ei, table, labels = _edges(), _table(), _labels()
    caps = (24, 40)
    js = JSampler(JCSRTopo(edge_index=ei), sizes=list(SIZES), mode="TPU", seed=SEED, caps=caps,
                  auto_grow_caps=True)
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu",
                          caps=caps, auto_grow_caps=True)
    for s in (js, ts):
        s.cap_margin, s.cap_granule = 1.1, 8
    batches = _batches(5)
    jds = js.sample_dense(batches[0])
    _, jparams, tx, jstep = _jax_setup(_jtake(table, jds.n_id), jds.adjs)
    jstate = tx.init(jparams)
    model = _port_model(jparams)
    seen = _recording(monkeypatch)
    step = make_sample_train_step(ts, torch.from_numpy(table), labels, model,
                                  torch.optim.Adam(model.parameters(), lr=LR))
    assert not step.captures_sample
    jl, tl = [], []
    for i, seeds in enumerate(batches):
        jds = jds if i == 0 else js.sample_dense(seeds)
        regrows = ts.cap_regrows
        tloss, _ = step(seeds)
        if ts.cap_regrows > regrows:  # the ladder ran before the step saw its batch
            assert seen[-1][1][0].mask.shape[0] == ts.caps[0]
        jparams, jstate, jloss = jstep(jparams, jstate, jax.random.key(i),
                                       _jtake(table, jds.n_id), jds.adjs,
                                       jnp.asarray(labels[seeds]))
        assert np.array_equal(seen[-1][0].numpy(), np.asarray(_jtake(table, jds.n_id)))
        jl.append(float(jloss))
        tl.append(float(tloss))
    assert ts.cap_regrows >= 1 and ts.caps == js.caps
    assert ts._call == len(batches) + ts.cap_regrows
    np.testing.assert_allclose(tl, jl, **CURVE)


def _community():
    rng = np.random.default_rng(0)
    n, per = 160, 40
    src = np.repeat(np.arange(n), 6)
    dst = (src // per) * per + rng.integers(0, per, src.shape[0])
    feat = rng.standard_normal((n, 16)).astype(np.float32)
    return np.stack([src, dst]), feat, (np.arange(n) // per).astype(np.int32), n


@needs_jax
@pytest.mark.parametrize("codec", ["fp32", "int8", "bf16"])
def test_tiered_and_quantized_steps_cpu_form_match_jax(codec):
    edge_index, feat, labels, n = _community()
    if codec == "fp32":
        budget = (n // 2) * 16 * 4
        jf = JFeature(rank=0, device_list=[0], device_cache_size=budget)
        tf = Feature(device_cache_size=budget, device="cpu")
    else:
        budget = int(n * 8 + (n // 2) * 16)
        jf = JQuantizedFeature(codec, rank=0, device_cache_size=budget)
        tf = QuantizedFeature(codec, device_cache_size=budget, device="cpu")
    jf.from_cpu_tensor(feat)
    tf.from_cpu_tensor(feat)
    jpipe, tpipe = JTieredFeaturePipeline(jf), TieredFeaturePipeline(tf)
    js = JSampler(JCSRTopo(edge_index=edge_index), sizes=[5, 5], mode="TPU", seed=1)
    ts = GraphSageSampler(CSRTopo(edge_index=edge_index), [5, 5], seed=1, device="cpu")
    jmodel = JGraphSAGE(hidden_dim=32, out_dim=4, num_layers=2, dropout=0.0)
    tx = optax.adam(LR)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, n, 32).astype(np.int64) for _ in range(6)]
    jds0 = js.sample_dense(batches[0])
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((jds0.n_id.shape[0], 16)), jds0.adjs)
    jstate = tx.init(jparams)
    model = GraphSAGE(16, 32, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sage_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    if codec == "fp32":
        jstep = j_make_tiered_step(jmodel, tx, jnp.asarray(labels), jpipe.hot_table)
        step = make_tiered_train_step(model, opt, labels, tpipe.hot_table)
    else:
        jstep = j_make_quantized_step(jmodel, tx, jnp.asarray(labels), jpipe.hot_table,
                                      jf.scale, jf.zero, codec=codec)
        step = make_quantized_train_step(model, opt, labels, tpipe.hot_table, tf.scale, tf.zero,
                                         codec=codec)
    jl, tl = [], []
    for i, seeds in enumerate(batches):
        jds = jds0 if i == 0 else js.sample_dense(seeds)
        tds = ts.sample_dense(seeds)
        jm, jc, jp = jpipe.prepare(jds.n_id, int(jds.count))
        tm, tc, tpos = tpipe.prepare(tds.n_id, int(tds.count))
        assert np.array_equal(np.asarray(jm), tm.numpy()) and tc.shape == jc.shape
        jparams, jstate, jloss = jstep(jparams, jstate, jax.random.key(i), JTieredBatch(
            ds=jds, mapped=jm, cold_rows=jc, cold_pos=jp, seeds=jnp.asarray(seeds)))
        tloss = step(TieredBatch(ds=tds, mapped=tm, cold_rows=tc, cold_pos=tpos,
                                 seeds=torch.from_numpy(seeds.astype(np.int32))))
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, **CURVE)


def test_a_card_step_without_a_card_names_the_cpu_form(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))


def test_a_card_step_refuses_a_non_capturable_optimizer_naming_the_fix():
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2)
    for opt in (torch.optim.Adam(model.parameters(), lr=LR),
                torch.optim.SGD(model.parameters(), lr=LR)):
        with pytest.raises(ValueError, match=r"capturable=True"):
            TrainPrograms(lambda inputs, host, g: None, model, opt, "cuda")


def test_sample_train_step_refusals():
    ei, table = _edges(), torch.from_numpy(_table())
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu")
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    with pytest.raises(ValueError, match="unknown mode"):
        make_sample_train_step(ts, table, _labels(), model, opt, mode="host")
    feat = Feature(device_cache_size="1M", device="cpu")
    feat.from_cpu_tensor(_table())
    with pytest.raises(TypeError, match="table tensor"):
        make_sample_train_step(ts, feat, _labels(), model, opt, mode="fused")
    with pytest.raises(ValueError, match="live on cpu"):
        TrainPrograms(lambda inputs, host, g: None, model, opt, "meta")


def test_cpu_form_dropout_draws_from_the_given_generator_only():
    ei, table = _edges(), torch.from_numpy(_table())

    def run(gen_seed):
        ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED,
                              device="cpu")
        model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.5)
        model.reset_parameters(torch.Generator().manual_seed(0))
        step = make_sample_train_step(ts, table, _labels(), model,
                                      torch.optim.Adam(model.parameters(), lr=LR))
        gen = torch.Generator().manual_seed(gen_seed)
        return [float(step(s, gen)[0]) for s in _batches(3)]

    torch.manual_seed(0)
    a = run(1)
    torch.manual_seed(5)  # the global RNG plays no part
    assert run(1) == a and run(2) != a
    ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED, device="cpu")
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.5)
    step = make_sample_train_step(ts, table, _labels(), model,
                                  torch.optim.Adam(model.parameters(), lr=LR))
    with pytest.raises(ValueError, match="torch.Generator"):
        step(_batches(1)[0])


def test_cpu_form_checkpoint_resume_through_the_step_is_exact():
    ei, table = _edges(), torch.from_numpy(_table())
    batches = _batches(6)

    def fresh():
        ts = GraphSageSampler(CSRTopo(edge_index=ei), sizes=list(SIZES), seed=SEED,
                              device="cpu")
        model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=0.0)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return ts, make_sample_train_step(ts, table, _labels(), model,
                                          torch.optim.Adam(model.parameters(), lr=LR))

    ts, step = fresh()
    losses = [float(step(s)[0]) for s in batches[:3]]
    state = {"model": copy.deepcopy(step.model.state_dict()),
             "optimizer": copy.deepcopy(step.optimizer.state_dict())}
    losses += [float(step(s)[0]) for s in batches[3:]]
    ts2, step2 = fresh()
    step2.load_state_dict(state)
    ts2._call = 3
    assert [float(step2(s)[0]) for s in batches[3:]] == losses[3:]
    for a, b in zip(step.model.parameters(), step2.model.parameters()):
        assert torch.equal(a, b)


# -- the card: captured against eager ------------------------------------------------

def _card_graph(dev):
    ei = _edges()
    return CSRTopo(edge_index=ei), torch.from_numpy(_table()).to(dev)


def _card_model(kind, dev, dropout=0.0):
    if kind == "gcn":
        model = GCN(DIM, 16, CLASSES, num_layers=2, dropout=dropout)
    elif kind == "gat":
        model = GAT(DIM, 8, CLASSES, heads=2, num_layers=2, dropout=dropout)
    else:
        model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout=dropout)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(dev)


def _eager_leg(sampler, table, labels, model, opt, mode, seeds, gen=None):
    """The eager step of a mode: the sampler's draw, the rows, `descend`."""
    s = sampler.as_seeds(seeds)
    if mode == "dense":
        ds = sampler.sample_dense(seeds)
        x = lookup_features(table, ds.n_id)
    else:
        graph, bind, _ = sampler.fused_sample_spec()
        fn = getattr(train_programs, "sample_and_gather_" + mode)
        kw = {} if mode == "fused" else {"caps": sampler.caps}
        ds, x = fn(None, None, table, sampler.next_key(), s, SIZES, sample_fn=bind(graph), **kw)
    return descend(model, opt, x, ds.adjs, labels[s.long()], gen)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kind", [("dense", "sage"), ("fused", "sage"), ("dedup", "sage"),
                                       ("dense", "gcn"), ("dense", "gat")])
def test_captured_step_bit_equal_to_the_eager_step(cuda_device, mode, kind):
    dev = cuda_device
    topo, table = _card_graph(dev)
    labels = torch.from_numpy(_labels().astype(np.int64)).to(dev)
    eager_model = _card_model(kind, dev)
    model = copy.deepcopy(eager_model)
    eager_opt = torch.optim.Adam(eager_model.parameters(), lr=LR, capturable=True)
    eager_s = GraphSageSampler(topo, sizes=list(SIZES), seed=SEED, device=dev)
    step = make_sample_train_step(GraphSageSampler(topo, sizes=list(SIZES), seed=SEED,
                                                   device=dev),
                                  table, labels, model,
                                  torch.optim.Adam(model.parameters(), lr=LR, capturable=True),
                                  mode=mode)
    for seeds in _batches(5):
        want = _eager_leg(eager_s, table, labels, eager_model, eager_opt, mode, seeds)
        got, _ = step(seeds)
        assert torch.equal(got, want)
    for a, b in zip(eager_model.parameters(), model.parameters()):
        assert torch.equal(a, b)
    stats = step.programs.graph_stats()
    assert stats["graphs"] == 1 and stats["replays"] == 5 and stats["pool_bytes"] > 0
    assert step.programs.replayed_launches()["sample_tiled/device_key"] == 5 * len(SIZES)
    step.reset()
    assert step.programs.graph_stats()["graphs"] == 0


@pytest.mark.cuda
def test_card_step_refuses_a_non_capturable_optimizer(cuda_device):
    model = _card_model("sage", cuda_device)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR), cuda_device)


@pytest.mark.cuda
def test_recapture_after_load_state_dict_stays_bit_equal(cuda_device):
    dev = cuda_device
    topo, table = _card_graph(dev)
    batches = _batches(6)
    model = _card_model("sage", dev)
    sampler = GraphSageSampler(topo, sizes=list(SIZES), seed=SEED, device=dev)
    step = make_sample_train_step(sampler, table, _labels(), model,
                                  torch.optim.Adam(model.parameters(), lr=LR, capturable=True))
    first = [step(s)[0] for s in batches[:3]]
    state = {"model": copy.deepcopy(model.state_dict()),
             "optimizer": copy.deepcopy(step.optimizer.state_dict())}
    rest = [step(s)[0] for s in batches[3:]]
    after = [p.detach().clone() for p in model.parameters()]
    step.optimizer.load_state_dict(state["optimizer"])  # replaces the state the graph reads
    with pytest.raises(RuntimeError, match="invalidate"):
        step(batches[3])
    step.load_state_dict(state)
    sampler._call = 3
    again = [step(s)[0] for s in batches[3:]]
    assert all(torch.equal(a, b) for a, b in zip(again, rest)) and first
    assert all(torch.equal(a, b) for a, b in zip(after, model.parameters()))
    assert step.programs.graph_stats()["captured"] == 2


@pytest.mark.cuda
def test_dropout_masks_differ_from_replay_to_replay(cuda_device):
    dev = cuda_device
    model = _card_model("sage", dev, dropout=0.5)
    seen = []

    def body(inputs, host, generator):  # a step body of one dropout draw
        (x,) = inputs
        return dropout(x, 0.5, generator)

    gen = torch.Generator(device=dev).manual_seed(1)
    programs = TrainPrograms(body, model, torch.optim.Adam(
        [torch.zeros(1, device=dev, requires_grad=True)], lr=LR, capturable=True), dev)
    x = torch.ones(64, 64, device=dev)
    for _ in range(3):
        seen.append(programs((x,), generator=gen))
    assert programs.graph_stats()["replays"] == 3
    masks = [s > 0 for s in seen]
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[1], masks[2])
    # the replays draw what eager draws from the same generator state
    eager = torch.Generator(device=dev).manual_seed(1)
    for s in seen:
        assert torch.equal(dropout(x, 0.5, eager), s)

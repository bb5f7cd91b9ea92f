"""The port's multi-process `TorchComm` — one process a host over gloo on
the CPU, each holding only its own block or answerer — against the JAX
package's single-controller `TpuComm` and the port's own single-controller
exchange on the same inputs. (The JAX package's two-process tests,
tests/test_comm_multiprocess.py, skip on this jax: its CPU backend runs no
multi-process computation.)

Each test launches tests/torch_comm_worker.py twice, as
tests/test_torch_parallel.py launches its gloo world: a free port, a
``communicate(timeout=120)`` a process, and a kill on timeout.

- ``exchange``: tests/dist_worker.py's base mode over seeded blocks: two
  exchanges and `DistFeature` lookups, bit-equal to JAX's single-controller
  `TpuComm.exchange` and `DistFeature` with every block registered.
- ``serve``: its serve mode on its community graph: each owner's
  `ServeEngine` answers the rows routed to it; bit-equal to the port's
  single-controller `exchange_serve_all` over rank threads with the same
  engines, and within tests/test_torch_dist_serve.py's tolerance of JAX's;
  a tenant list is dropped, as in the JAX package.
- ``no_budget``, ``refusals``, ``bad_answer``: the reference's refusals
  (ValueError without a budget, ``host2ts``, a missing answerer or block,
  ``allreduce``) and a raising answerer: `OwnerAnswerError` naming its
  host, the peer failing within the groups' timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import quiver_tpu.comm as jcomm
from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu.feature import DistFeature as JDistFeature
from quiver_tpu.feature import Feature as JFeature
from quiver_tpu.feature import PartitionInfo as JPartitionInfo
from quiver_tpu.models import GraphSAGE as JGraphSAGE
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.serve import ServeConfig as JServeConfig
from quiver_tpu.serve import ServeEngine as JServeEngine
from quiver_tpu.serve import shard_topology_by_owner as j_shard_by_owner
import torch

from quiver_tpu_torch import sage_params_from_flax
from quiver_tpu_torch.comm import exchange_serve_all
from quiver_tpu_torch.parallel import local_meshes

import torch_comm_worker as worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_comm_worker.py")
TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_dist_serve.py's


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(mode, out_dir, timeout=120):
    """Both host processes of ``mode``; returns what each wrote."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(port), str(out_dir)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {mode} workers did not end within {timeout} s:\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r} OK" in out, f"worker {r}:\n{out}"
    # written by the workers above
    return [torch.load(os.path.join(out_dir, f"{mode}{r}.pt"), weights_only=False)
            for r in range(2)]


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _same_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _same(g, w)


def test_two_process_exchange_and_dist_feature(tmp_path):
    got = run_workers("exchange", tmp_path)
    blocks = worker.blocks()
    mesh = Mesh(np.array(jax.devices()[:2]), ("host",))
    g2h = (np.arange(2 * worker.R) // worker.R).astype(np.int32)
    for r in range(2):
        jc = jcomm.TpuComm(rank=r, world_size=2, hosts=2, mesh=mesh)
        jc.static_budget = 8
        for h in range(2):
            jc.register_local_table(h, blocks[h])  # single controller: every block
        want = jc.exchange(worker.requests(r))
        _same_lists(got[r]["first"], want)
        _same_lists(got[r]["second"], want)
        jfeat = JFeature(rank=0, device_list=[0], device_cache_size=worker.R * worker.D * 4)
        jfeat.from_cpu_tensor(blocks[r])
        jfeat.set_local_order(np.arange(r * worker.R, (r + 1) * worker.R))
        jdist = JDistFeature(jfeat, JPartitionInfo(device=0, host=r, hosts=2, global2host=g2h),
                             jc)
        assert _same(got[r]["dist"], jdist[worker.lookup_ids()])
        assert _same(got[r]["local"], blocks[r][:3])


@pytest.fixture(scope="module")
def serve_params():
    """The JAX GraphSAGE init of tests/dist_worker.py's serve mode, and the
    port's state_dict of it."""
    edge_index, _, _ = worker.community_graph()
    jmodel = JGraphSAGE(hidden_dim=16, out_dim=worker.OUT_DIM, num_layers=2, dropout=0.0)
    s0 = JSampler(JCSRTopo(edge_index=edge_index), sizes=worker.SIZES, mode="TPU",
                  seed=worker.SAMPLER_SEED)
    ds0 = s0.sample_dense(np.arange(8, dtype=np.int64))
    params = jmodel.init(jax.random.key(0), jnp.zeros((ds0.n_id.shape[0], worker.FEAT_DIM)),
                         ds0.adjs)
    return jmodel, params, sage_params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _jax_engine(jmodel, params, host):
    edge_index, feat_full, g2h = worker.community_graph()
    shard, _ = j_shard_by_owner(JCSRTopo(edge_index=edge_index), g2h, host,
                                hops=len(worker.SIZES) - 1)
    feat = np.zeros_like(feat_full)
    owned = np.nonzero(g2h == host)[0]
    feat[owned] = feat_full[owned]
    sampler = JSampler(shard, sizes=worker.SIZES, mode="TPU", seed=worker.SAMPLER_SEED)
    return JServeEngine(jmodel, params, sampler, feat,
                        JServeConfig(max_batch=16, max_delay_ms=1e9, record_dispatches=True))


def _jax_answerer(engine, budget):
    def answer(recv_ids, *_, **__):
        out = np.zeros((recv_ids.shape[0], budget, worker.OUT_DIM), np.float32)
        for req in range(recv_ids.shape[0]):
            valid = recv_ids[req] >= 0
            if valid.any():
                out[req, valid] = np.asarray(engine.predict(recv_ids[req][valid].astype(np.int64)))
        return out
    return answer


def test_two_process_serve_exchange(tmp_path, serve_params):
    jmodel, params, tparams = serve_params
    torch.save(tparams, tmp_path / "params.pt")
    got = run_workers("serve", tmp_path)
    L = worker.SERVE_BUDGET
    req = np.full((2, 2, L), -1, np.int64)
    for r in range(2):
        for h, ids in enumerate(worker.serve_requests(r)):
            req[r, h, : len(ids)] = ids
    # the port's single controller over rank threads, with the same engines
    # fed in the same order (two rounds), and the JAX package's
    engines = {h: worker.serve_engine(h, tparams) for h in range(2)}
    meshes = local_meshes(2, hosts=2, device="cpu", timeout_s=60)
    jengines = {h: _jax_engine(jmodel, params, h) for h in range(2)}
    jmesh = Mesh(np.array(jax.devices()[:2]), ("host",))
    for key in ("rows", "tenant_rows"):
        port_sc = exchange_serve_all(
            meshes, req, lambda host, recv: worker.answerer_of(engines[host], L)(recv),
            worker.OUT_DIM)
        jax_sc = np.asarray(jcomm.exchange_serve_all(
            jmesh, "host", req,
            lambda host, recv, *a, **k: _jax_answerer(jengines[host], L)(recv), worker.OUT_DIM))
        for r in range(2):
            for h, ids in enumerate(worker.serve_requests(r)):
                rows = got[r][key][h]
                if not len(ids):
                    assert rows is None
                    continue
                assert _same(rows, port_sc[r, h, : len(ids)])
                np.testing.assert_allclose(rows, jax_sc[r, h, : len(ids)], **TOL)


def test_two_process_exchange_needs_an_agreed_budget(tmp_path):
    run_workers("no_budget", tmp_path)


def test_two_process_refusals(tmp_path):
    """host2ts, a missing answerer, a missing block and allreduce."""
    run_workers("refusals", tmp_path)


def test_a_raising_answerer_fails_both_hosts_within_the_timeout(tmp_path):
    got = run_workers("bad_answer", tmp_path)
    assert got[1]["failed"] == "OwnerAnswerError"
    assert got[0]["failed"] != "OwnerAnswerError"
    assert max(g["seconds"] for g in got) < 4 * worker.BAD_ANSWER_TIMEOUT_S

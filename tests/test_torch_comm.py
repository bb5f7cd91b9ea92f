"""The port's exchange layer (quiver_tpu_torch.comm, feature.PartitionInfo,
feature.DistFeature) against quiver_tpu.comm and quiver_tpu.feature: the
JAX package on its 8 virtual CPU devices (tests/conftest.py), the port on
rank threads of ``local_meshes(H, hosts=H, device="cpu")`` over gloo.

Everything here moves or copies ids and rows, so every bar is bit-equality:
the host bookkeeping (`HostRankTable`, `round_up_pow2`, `schedule`), the
int32 refusal, the owner gather's plain version (K13f, `exchange_rows_plain`)
and the port's `exchange_all` against JAX's `exchange_all` — -1 pads, ids
past a block (JAX clamps them to its last row), an empty request, blocks of
unequal rows, D of 1, 3 and 16 — `TorchComm.exchange` against
`TpuComm.exchange`, `exchange_serve_all` against JAX's under one
deterministic answerer, and `PartitionInfo` and `DistFeature` with and
without replication."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import quiver_tpu.comm as jcomm
from quiver_tpu.feature import DistFeature as JDistFeature
from quiver_tpu.feature import Feature as JFeature
from quiver_tpu.feature import PartitionInfo as JPartitionInfo
import torch

from quiver_tpu_torch import comm
from quiver_tpu_torch.comm import (
    HostRankTable,
    NcclComm,
    OwnerAnswerError,
    TorchComm,
    TpuComm,
    exchange_all,
    exchange_rows,
    exchange_rows_plain,
    exchange_serve_all,
    round_up_pow2,
    schedule,
)
from quiver_tpu_torch.feature import DistFeature, Feature, PartitionInfo
from quiver_tpu_torch.parallel import local_meshes
from quiver_tpu_torch.trace import SpanRecorder

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    """H -> (the port's H rank meshes, the JAX host mesh of H devices)."""
    made = {}

    def get(h):
        if h not in made:
            made[h] = (local_meshes(h, hosts=h, device="cpu", timeout_s=60),
                       Mesh(np.array(jax.devices()[:h]), ("host",)))
        return made[h]

    return get


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- host bookkeeping ---------------------------------------------------------------------

@pytest.mark.parametrize("hosts,per", [(3, 4), (1, 1), (4, 2)])
def test_host_rank_table_and_helpers_match_reference(hosts, per):
    t, j = HostRankTable(hosts, per), jcomm.HostRankTable(hosts, per)
    assert t.world_size == j.world_size
    for r in range(t.world_size):
        assert (t.rank2host(r), t.rank2local(r)) == (j.rank2host(r), j.rank2local(r))
    for h in range(hosts):
        assert t.ranks_of(h) == j.ranks_of(h)
        assert [t.host2rank(h, k) for k in range(per)] == [j.host2rank(h, k) for k in range(per)]
    for n in (0, 1, 15, 16, 17, 64, 65, 1000, 67584):
        assert round_up_pow2(n) == jcomm.round_up_pow2(n)
        assert round_up_pow2(n, floor=1) == jcomm.round_up_pow2(n, floor=1)
    rng = np.random.default_rng(hosts * 10 + per)
    for _ in range(5):
        mat = rng.integers(0, 2, (hosts + 3, hosts + 3))
        assert schedule(mat) == jcomm.schedule(mat)
    assert TpuComm is TorchComm and NcclComm is TorchComm and comm.ID_PAD == -1


def test_exchange_refuses_ids_past_int32_like_the_reference(ranks):
    meshes, mesh = ranks(4)
    req = np.full((4, 4, 4), -1, np.int64)
    req[0, 0, 0] = 2**31 + 5
    tables = np.zeros((4, 8, 3), np.float32)
    with pytest.raises(ValueError, match="2\\^31"):
        jcomm.exchange_all(mesh, "host", req, tables)
    with pytest.raises(ValueError, match="2\\^31"):
        exchange_all(meshes, req, tables)
    with pytest.raises(ValueError, match="2\\^31"):
        exchange_serve_all(meshes, req, lambda h, r: None, 2)


# -- K13f and the id -> rows exchange -------------------------------------------------------

def _requests(rng, h, budget, rows, past=True):
    """-1-padded [H, H, L] requests of random length, some ids past the
    block (the clamp), one empty request."""
    req = np.full((h, h, budget), -1, np.int64)
    lens = rng.integers(0, budget + 1, (h, h))
    lens[0, h - 1] = 0
    for i in range(h):
        for j in range(h):
            hi = rows + 3 if past else rows
            req[i, j, : lens[i, j]] = rng.integers(0, hi, lens[i, j])
    return req


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("D", [1, 3, 16])
def test_exchange_all_and_owner_gather_bit_equal_to_reference(ranks, h, D):
    meshes, mesh = ranks(h)
    rng = np.random.default_rng(h * 100 + D)
    rows, budget = 10, 8
    tables = rng.standard_normal((h, rows, D)).astype(np.float32)
    tables[:, -1] = -0.0  # the clamped ids read the last row, bits and all
    req = _requests(rng, h, budget, rows)
    want = np.asarray(jcomm.exchange_all(mesh, "host", req, tables))
    got = exchange_all(meshes, req, tables)
    assert _same(got, want)
    plain = torch.stack([torch.stack([exchange_rows_plain(torch.from_numpy(tables[j]),
                                                          torch.from_numpy(req[i, j]).int())
                                      for j in range(h)]) for i in range(h)])
    assert _same(plain, want)
    # on CPU tensors the wrapper is the plain version, at any id shape
    ids = torch.from_numpy(req[:, 1].astype(np.int32))
    assert _same(exchange_rows(torch.from_numpy(tables[1]), ids),
                 exchange_rows_plain(torch.from_numpy(tables[1]), ids))
    assert exchange_rows_plain(torch.zeros((0, D)), ids).abs().sum() == 0  # an empty block


@pytest.mark.parametrize("asker", [0, 2])
def test_torch_comm_exchange_bit_equal_to_tpu_comm(ranks, asker):
    """Blocks of unequal rows (the stack pads with zeros), an empty request
    (None), repeats, and ids past a block, which clamp into its padding."""
    meshes, mesh = ranks(4)
    rng = np.random.default_rng(1 + asker)
    tables = [rng.standard_normal((n, 5)).astype(np.float32) for n in (12, 5, 12, 9)]
    tcomm = TorchComm(rank=asker, world_size=4, hosts=4, meshes=meshes)
    jc = jcomm.TpuComm(rank=asker, world_size=4, hosts=4, mesh=mesh)
    for i, t in enumerate(tables):
        tcomm.register_local_table(i, t)
        jc.register_local_table(i, t)
    host2ids = [np.array([0, 5]), np.array([], np.int64), np.array([11, 30]),
                np.array([3, 3, 7, 10, 11])]
    rec = comm.record_exchange_spans(SpanRecorder())
    try:
        got = tcomm.exchange(host2ids)
    finally:
        comm.record_exchange_spans(None)
    want = jc.exchange(host2ids)
    assert [len(s) for s in rec] == [3] and next(iter(rec))[0] == "comm.exchange"
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _same(g, w)
    assert not got[3][3:].any()  # past host 3's 9 rows: its zero padding
    with pytest.raises(ValueError, match="budget"):
        tcomm.exchange(host2ids, budget=4)
    with pytest.raises(RuntimeError, match="register_local_table"):
        TorchComm(rank=0, world_size=4, hosts=4, meshes=meshes).exchange(host2ids)


def _answer(host, recv_ids, C=3):
    """A deterministic answerer encoding (owner, id); zeros on pad lanes."""
    out = np.zeros(recv_ids.shape + (C,), np.float32)
    valid = recv_ids >= 0
    out[valid] = (100.0 * host + recv_ids[valid].astype(np.float32))[:, None] + np.arange(
        C, dtype=np.float32)
    return out


@pytest.mark.parametrize("h", [2, 4])
def test_exchange_serve_all_bit_equal_to_reference(ranks, h):
    meshes, mesh = ranks(h)
    req = _requests(np.random.default_rng(h), h, 8, 50, past=False)
    seen, jseen = {}, {}

    def recording(log):
        def answer(host, r):
            log[host] = r.copy()
            return _answer(host, r)
        return answer

    got = exchange_serve_all(meshes, req, recording(seen), 3)
    want = np.asarray(jcomm.exchange_serve_all(mesh, "host", req, recording(jseen), 3))
    assert _same(got, want)
    for host in range(h):
        assert _same(seen[host], jseen[host])

    def bad(host, r):
        if host == h - 1:
            raise KeyError("owner down")
        return _answer(host, r)

    with pytest.raises(OwnerAnswerError) as err:
        exchange_serve_all(meshes, req, bad, 3)
    assert err.value.host == h - 1 and isinstance(err.value.__cause__, KeyError)
    with pytest.raises(ValueError, match="returned"):
        exchange_serve_all(meshes, req, lambda host, r: np.zeros((1, 1, 3)), 3)
    with pytest.raises(NotImplementedError, match="A12"):
        exchange_serve_all(meshes, req, _answer, 3, tenant_requests=np.zeros_like(req))


def test_torch_comm_exchange_serve_and_refusals(ranks):
    meshes, mesh = ranks(2)
    tcomm = TorchComm(rank=1, world_size=2, hosts=2, meshes=meshes)
    jc = jcomm.TpuComm(rank=1, world_size=2, hosts=2, mesh=mesh)
    with pytest.raises(RuntimeError, match="missing"):
        tcomm.exchange_serve([np.array([1]), np.array([2])], out_dim=3)
    for host in range(2):
        tcomm.register_serve_answerer(host, lambda r, host=host: _answer(host, r))
        jc.register_serve_answerer(host, lambda r, host=host: _answer(host, r))
    host2ids = [np.array([4, 9, 4]), np.array([], np.int64)]
    got, want = tcomm.exchange_serve(host2ids, 3), jc.exchange_serve(host2ids, 3)
    assert got[1] is None and want[1] is None and _same(got[0], want[0])
    with pytest.raises(NotImplementedError, match="A16"):
        tcomm.exchange_serve(host2ids, 3, host2ts=[[0.0, 0.0, 0.0], []])
    with pytest.raises(NotImplementedError):
        tcomm.send()
    with pytest.raises(NotImplementedError, match="A16"):
        TorchComm(rank=0, world_size=2, hosts=2, meshes=meshes[:1]).exchange(host2ids)
    assert torch.equal(tcomm.allreduce([1.0, 2.0]), torch.tensor([1.0, 2.0]))


# -- PartitionInfo and DistFeature -------------------------------------------------------

@pytest.mark.parametrize("replicate", [False, True])
def test_partition_info_matches_reference(replicate):
    n, hosts = 40, 4
    rng = np.random.default_rng(2)
    g2h = rng.integers(0, hosts, n).astype(np.int32)
    rep = np.nonzero(g2h != 1)[0][:5] if replicate else None
    for host in range(hosts):
        t = PartitionInfo(device="cpu", host=host, hosts=hosts, global2host=g2h, replicate=rep)
        j = JPartitionInfo(device=0, host=host, hosts=hosts, global2host=g2h, replicate=rep)
        assert _same(t.global2local, j.global2local) and _same(t.local_ids, j.local_ids)
        assert _same(t.local_mask, j.local_mask)
        ids = rng.integers(0, n, 16)
        for a, b in zip(t.dispatch(ids), j.dispatch(ids)):
            if isinstance(a, list):
                assert all(_same(x, y) for x, y in zip(a, b))
            else:
                assert _same(a, b)


def _features(full, g2h, hosts, owner, rep=None, local_order=False):
    """(port Feature, JAX Feature) of host ``owner``'s rows (plus ``rep``)."""
    owned = np.nonzero(g2h == owner)[0]
    ids = owned if rep is None else np.concatenate([owned, rep])
    rows = full[ids] if ids.size else np.zeros((1, full.shape[1]), np.float32)
    t = Feature(device="cpu", device_cache_size="1M")
    j = JFeature(rank=0, device_list=[0], device_cache_size="1M")
    t.from_cpu_tensor(rows)
    j.from_cpu_tensor(rows)
    if local_order:
        t.set_local_order(ids)
        j.set_local_order(ids)
    return t, j


@pytest.mark.parametrize("case", ["random", "replicated", "local_order", "all_local"])
def test_dist_feature_bit_equal_to_reference(ranks, case):
    meshes, mesh = ranks(4)
    n, dim, hosts = 64, 8, 4
    rng = np.random.default_rng(3)
    full = rng.standard_normal((n, dim)).astype(np.float32)
    g2h = rng.integers(0, hosts, n).astype(np.int32)
    rep = np.nonzero(g2h != 0)[0][:3] if case == "replicated" else None
    tcomm = TorchComm(rank=0, world_size=hosts, hosts=hosts, meshes=meshes)
    jc = jcomm.TpuComm(rank=0, world_size=hosts, hosts=hosts, mesh=mesh)
    for h in range(hosts):
        owned = np.nonzero(g2h == h)[0]
        block = full[owned] if owned.size else np.zeros((1, dim), np.float32)
        tcomm.register_local_table(h, block)
        jc.register_local_table(h, block)
    tf, jf = _features(full, g2h, hosts, 0, rep, local_order=case == "local_order")
    info = PartitionInfo(device="cpu", host=0, hosts=hosts, global2host=g2h, replicate=rep)
    jinfo = JPartitionInfo(device=0, host=0, hosts=hosts, global2host=g2h, replicate=rep)
    ids = (np.nonzero(g2h == 0)[0][:6] if case == "all_local"
           else np.concatenate([rng.integers(0, n, 20), rep if rep is not None else []])
           .astype(np.int64))
    got = DistFeature(tf, info, tcomm)[ids]
    want = np.asarray(JDistFeature(jf, jinfo, jc)[ids])
    assert _same(got, want) and _same(got, full[ids])
    if case == "local_order":  # global ids this host does not own read zero rows
        other = np.nonzero(g2h != 0)[0][:4]
        assert not tf[other].any() and _same(tf[np.nonzero(g2h == 0)[0][:2]],
                                             full[np.nonzero(g2h == 0)[0][:2]])

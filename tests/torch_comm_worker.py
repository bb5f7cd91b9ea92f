"""One host process of tests/test_torch_comm_multiprocess.py: the port's
multi-process `TorchComm`, one process a host over gloo on the CPU. This
file imports torch, numpy and the port only (no jax).

usage: python torch_comm_worker.py <mode> <rank> <port> <out_dir>

Each process joins a two-process gloo world at ``tcp://127.0.0.1:<port>``,
takes its rank of ``make_mesh(hosts=2, device="cpu")`` and holds only its
own block or answerer. It writes what it got to ``<out_dir>/<mode><rank>.pt``
and prints ``worker <rank> OK`` when every check of its mode held.

modes:
- ``exchange``: `TorchComm.exchange` twice (tests/dist_worker.py's base
  mode, over seeded blocks), then `DistFeature` lookups of global ids;
- ``serve``: `TorchComm.exchange_serve` with each host's `ServeEngine`
  over its owner shard of tests/dist_worker.py's community graph as the
  answerer (weights from ``<out_dir>/params.pt``), then the same with a
  tenant list, which the multi-process path drops;
- ``no_budget``: with no static budget, `exchange`, `DistFeature` and
  `exchange_serve` raise ValueError before any collective;
- ``refusals``: ``host2ts`` raises, a missing answerer or block raises,
  ``allreduce`` raises naming parallel.collectives, and ``make_mesh`` with
  no ``device=`` raises where ``LOCAL_RANK`` names no card;
- ``bad_answer``: host 1's answerer raises; host 1 gets `OwnerAnswerError`
  naming it, host 0's call fails within the groups' timeout
  (``BAD_ANSWER_TIMEOUT_S``).
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quiver_tpu_torch.comm import OwnerAnswerError, TorchComm  # noqa: E402
from quiver_tpu_torch.feature import DistFeature, Feature, PartitionInfo  # noqa: E402
from quiver_tpu_torch.parallel import make_mesh  # noqa: E402

R, D = 16, 5  # rows a host, row width (the exchange modes)
BAD_ANSWER_TIMEOUT_S = 5.0

# the community graph of tests/dist_worker.py's serve mode
PER, INTRA, FEAT_DIM, SIZES, SAMPLER_SEED, OUT_DIM, SERVE_BUDGET = 40, 6, 8, [4, 4], 5, 6, 8
SERVE_TRACES = {0: np.array([3, PER + 5, 7, PER + 9], np.int64),
                1: np.array([PER + 1, 2, PER + 11, 6], np.int64)}


def blocks() -> np.ndarray:
    """Both hosts' ``[R, D]`` blocks, from one seed (each process keeps its
    own only)."""
    return np.random.default_rng(11).standard_normal((2, R, D)).astype(np.float32)


def requests(rank: int):
    """Host ``rank``'s owner-LOCAL row requests to hosts 0 and 1: mixed,
    with a repeat and an empty list (host 0 asks nothing of itself)."""
    if rank == 0:
        return [np.array([], np.int64), np.array([1, 3, 15, 3], np.int64)]
    return [np.array([2, 5, 7, 0, 11], np.int64), np.array([4, 9], np.int64)]


def lookup_ids() -> np.ndarray:
    """Global ids every host looks up through `DistFeature` (host h owns
    ``[h * R, (h + 1) * R)``)."""
    return np.array([1, R + 2, 3, 2 * R - 1, 0, R, R + 2], np.int64)


def community_graph():
    """(edge_index, features, global2host) of the serve mode: two
    communities, each closed under sampling, so each owner's shard is
    exactly its own community."""
    rng = np.random.default_rng(7)
    n = 2 * PER
    src, dst = [], []
    for u in range(n):
        cu = u // PER
        for v in rng.choice(PER, INTRA, replace=False) + cu * PER:
            src.append(u)
            dst.append(int(v))
    feat = np.random.default_rng(8).standard_normal((n, FEAT_DIM)).astype(np.float32)
    return np.stack([np.array(src), np.array(dst)]), feat, (np.arange(n) // PER).astype(np.int32)


def serve_engine(host: int, params):
    """Owner ``host``'s engine: a sampler over its shard of the community
    graph (seed SAMPLER_SEED) and its own feature rows only."""
    from quiver_tpu_torch import CSRTopo, GraphSAGE, GraphSageSampler
    from quiver_tpu_torch.serve import ServeConfig, ServeEngine, shard_topology_by_owner

    edge_index, feat_full, g2h = community_graph()
    shard, _ = shard_topology_by_owner(CSRTopo(edge_index=edge_index), g2h, host,
                                       hops=len(SIZES) - 1)
    feat = np.zeros_like(feat_full)
    owned = np.nonzero(g2h == host)[0]
    feat[owned] = feat_full[owned]
    model = GraphSAGE(FEAT_DIM, 16, OUT_DIM, num_layers=2, dropout=0.0)
    sampler = GraphSageSampler(shard, SIZES, device="cpu", seed=SAMPLER_SEED)
    return ServeEngine(model, params, sampler, feat,
                       ServeConfig(max_batch=16, max_delay_ms=1e9, record_dispatches=True))


def answerer_of(engine, budget: int):
    """The owner's serve answerer: each requester's valid ids through the
    engine, requester-major."""
    def answer(recv_ids):
        out = np.zeros((recv_ids.shape[0], budget, OUT_DIM), np.float32)
        for req in range(recv_ids.shape[0]):
            valid = recv_ids[req] >= 0
            if valid.any():
                out[req, valid] = engine.predict(recv_ids[req][valid].astype(np.int64))
        return out
    return answer


def serve_requests(rank: int):
    _, _, g2h = community_graph()
    trace = SERVE_TRACES[rank]
    return [trace[g2h[trace] == h] for h in range(2)]


def run(mode: str, rank: int, out_dir: str) -> dict:
    timeout = BAD_ANSWER_TIMEOUT_S if mode == "bad_answer" else 60.0
    mesh = make_mesh(hosts=2, device="cpu", timeout_s=timeout)
    assert mesh.shape == {"host": 2, "dp": 1, "ici": 1}
    comm = TorchComm(rank=rank, world_size=2, meshes=[mesh])
    assert comm.multiprocess and comm.host == rank
    out = {}
    if mode == "exchange":
        comm.static_budget = 8
        comm.register_local_table(rank, blocks()[rank])  # its own block only
        out["first"] = comm.exchange(requests(rank))
        out["second"] = comm.exchange(requests(rank))
        feat = Feature(device="cpu", device_cache_size=R * D * 4)
        feat.from_cpu_tensor(blocks()[rank])
        feat.set_local_order(np.arange(rank * R, (rank + 1) * R))
        info = PartitionInfo(device="cpu", host=rank, hosts=2,
                             global2host=(np.arange(2 * R) // R).astype(np.int32))
        out["dist"] = DistFeature(feat, info, comm)[lookup_ids()]
        # a lookup of this host's own rows only still enters the collective
        out["local"] = DistFeature(feat, info, comm)[np.arange(rank * R, rank * R + 3)]
    elif mode == "serve":
        params = torch.load(os.path.join(out_dir, "params.pt"))
        engine = serve_engine(rank, params)
        comm.static_budget = SERVE_BUDGET
        comm.register_serve_answerer(rank, answerer_of(engine, SERVE_BUDGET))
        host2ids = serve_requests(rank)
        out["rows"] = comm.exchange_serve(host2ids, out_dim=OUT_DIM)
        tenants = [np.zeros(len(ids), np.int32) for ids in host2ids]
        out["tenant_rows"] = comm.exchange_serve(host2ids, out_dim=OUT_DIM, host2tenants=tenants)
    elif mode == "no_budget":
        comm.register_local_table(rank, blocks()[rank])
        comm.register_serve_answerer(rank, lambda ids: None)
        for call in (lambda: comm.exchange(requests(rank)),
                     lambda: comm.exchange_serve(requests(rank), out_dim=OUT_DIM)):
            try:
                call()
            except ValueError as exc:
                assert "static_budget" in str(exc), exc
            else:
                raise AssertionError("a multi-process exchange ran without a budget")
        feat = Feature(device="cpu", device_cache_size=R * D * 4)
        feat.from_cpu_tensor(blocks()[rank])
        feat.set_local_order(np.arange(rank * R, (rank + 1) * R))
        info = PartitionInfo(device="cpu", host=rank, hosts=2,
                             global2host=(np.arange(2 * R) // R).astype(np.int32))
        try:
            DistFeature(feat, info, comm)[lookup_ids()]
        except ValueError:
            pass
        else:
            raise AssertionError("DistFeature exchanged without a budget")
    elif mode == "refusals":
        comm.static_budget = 8
        for call, error, text in (
                (lambda: comm.exchange_serve(requests(rank), OUT_DIM,
                                             host2ts=[[0.0] * len(i) for i in requests(rank)]),
                 NotImplementedError, "host2ts"),
                (lambda: comm.exchange_serve(requests(rank), OUT_DIM), RuntimeError,
                 "register_serve_answerer"),
                (lambda: comm.exchange(requests(rank)), RuntimeError, "register_local_table"),
                (lambda: comm.allreduce(np.ones(2)), NotImplementedError,
                 "parallel.collectives"),
                # no card here: the default cuda:LOCAL_RANK names none
                (lambda: make_mesh(hosts=2), ValueError, "pass device=")):
            try:
                call()
            except error as exc:
                assert text in str(exc), exc
            else:
                raise AssertionError(f"no {error.__name__} naming {text}")
    elif mode == "bad_answer":
        comm.static_budget = SERVE_BUDGET

        def answer(recv_ids):
            if rank == 1:
                raise KeyError("owner 1 lost its engine")
            return np.zeros((2, SERVE_BUDGET, OUT_DIM), np.float32)

        comm.register_serve_answerer(rank, answer)
        t0 = time.monotonic()
        try:
            comm.exchange_serve([np.array([1, 2]), np.array([PER + 1])], out_dim=OUT_DIM)
        except OwnerAnswerError as exc:
            assert rank == 1 and exc.host == 1 and isinstance(exc.__cause__, KeyError), exc
            out["failed"] = "OwnerAnswerError"
        except RuntimeError as exc:  # the peer's collective gave up
            assert rank == 0, exc
            out["failed"] = type(exc).__name__
        else:
            raise AssertionError("the failing answerer went unnoticed")
        out["seconds"] = time.monotonic() - t0
        assert out["seconds"] < 4 * BAD_ANSWER_TIMEOUT_S, out
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out


def main() -> None:
    mode, rank, port, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    out = run(mode, rank, out_dir)
    torch.save(out, os.path.join(out_dir, f"{mode}{rank}.pt"))
    print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
    main()

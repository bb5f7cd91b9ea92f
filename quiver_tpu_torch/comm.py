"""Cross-host communication over a mesh of ranks — the port of
``quiver_tpu/comm.py`` (``HostRankTable``, ``schedule``, ``round_up_pow2``,
``exchange_all``, ``exchange_serve_all``, ``TpuComm``/``NcclComm``).

Hosts are the ranks of a `parallel.train.Mesh` host group: by default
``local_meshes(H, hosts=H)``, one rank thread a host, each with its own gloo
groups (on one card the ranks share it, as in PRs 8-9). The id -> rows
exchange is one `parallel.train.run_ranks` call in which every rank
all_to_alls its ``[H, L]`` int32 request slab over the host group, answers
the ids it received from its own table block (kernel K13f, `exchange_rows`:
``csrc/collective.cu`` on the card, `exchange_rows_plain` on the CPU) and
all_to_alls the ``[H, L, D]`` rows back — JAX's ``_exchange_jit``. The
serve-shaped exchange keeps JAX's split into two launches with host compute
between them: the id all_to_all, then each owner's answerer on the CALLING
thread, host by host, then the row all_to_all. An answerer may itself
exchange (an owner's `feature.DistFeature` lookup under the fleet's exchange
residency): it runs on the thread that holds the process-wide collective
lock, which is re-entrant, and each comm owns its own meshes, so a nested
exchange never shares a gloo group with the one around it.

Only the single-controller mode is ported: one process drives every host's
rank. The multi-process paths (one process a host, each holding only its own
block and answerer) raise ``NotImplementedError`` naming ROADMAP A16.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .parallel import collectives
from .parallel import train as _train
from .utils import round_up_pow2

ID_PAD = -1


class OwnerAnswerError(RuntimeError):
    """An owner's serve answerer raised inside a collective `exchange_serve`
    round; ``host`` names the owner (the original exception chains via
    ``__cause__``)."""

    def __init__(self, host: int, exc: BaseException):
        super().__init__(f"serve answerer for host {host} failed: {exc!r}")
        self.host = int(host)


# Collective launches from one process are serialized: every rank of a group
# must issue its collectives in the same order, and two threads launching
# exchanges at once could interleave them. Re-entrant because an owner's
# serve answerer may itself exchange on the same thread.
_SC_COLLECTIVE_LOCK = threading.RLock()

# Optional exchange spans (observe-only): with a recorder installed,
# `TorchComm.exchange` / `exchange_serve` record ("comm.exchange" /
# "comm.exchange_serve", t0, t1) on `_EXCHANGE_CLOCK`, which must be the
# clock of the engines whose timeline the spans join.
EXCHANGE_SPANS = None
_EXCHANGE_CLOCK = time.monotonic


def record_exchange_spans(recorder, clock=time.monotonic):
    """Install (or, with ``None``, remove) the process-wide exchange-span
    recorder, typically a `trace.SpanRecorder`, stamped on ``clock``.
    Returns the recorder."""
    global EXCHANGE_SPANS, _EXCHANGE_CLOCK
    EXCHANGE_SPANS = recorder
    _EXCHANGE_CLOCK = clock
    return recorder


def _ids_to_int32(arr) -> np.ndarray:
    """The exchange ships int32 row ids; ids >= 2^31 raise instead of
    wrapping into wrong rows."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) >= 2**31:
        raise ValueError(
            f"exchange ids must be owner-LOCAL row indices < 2^31 (got max {int(arr.max())}); "
            "the collective ships int32 — split the per-host table below 2^31 rows"
        )
    return arr.astype(np.int32, copy=False)


class HostRankTable:
    """global rank <-> (host, local rank) mapping."""

    def __init__(self, hosts: int, ranks_per_host: int):
        self.hosts = hosts
        self.ranks_per_host = ranks_per_host
        self.world_size = hosts * ranks_per_host

    def rank2host(self, rank: int) -> int:
        return rank // self.ranks_per_host

    def rank2local(self, rank: int) -> int:
        return rank % self.ranks_per_host

    def host2rank(self, host: int, local: int = 0) -> int:
        return host * self.ranks_per_host + local

    def ranks_of(self, host: int) -> List[int]:
        base = host * self.ranks_per_host
        return list(range(base, base + self.ranks_per_host))


def schedule(comm_mat: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Greedy pairwise exchange plan: ``comm_mat[i, j] != 0`` means hosts i
    and j must talk; returns steps of disjoint (i, j) pairs. An analysis
    utility — the exchange itself is one all_to_all."""
    comm_mat = np.asarray(comm_mat).copy()
    n = comm_mat.shape[0]
    pending = {(i, j) for i in range(n) for j in range(i + 1, n)
               if comm_mat[i, j] or comm_mat[j, i]}
    steps: List[List[Tuple[int, int]]] = []
    while pending:
        busy = set()
        step = []
        for (i, j) in sorted(pending):
            if i in busy or j in busy:
                continue
            step.append((i, j))
            busy.add(i)
            busy.add(j)
        pending -= set(step)
        steps.append(step)
    return steps


# -- K13f: the owner gather ------------------------------------------------------------

def exchange_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain torch K13f: ``where(ids >= 0, table[clip(ids, 0, R - 1)], 0)``,
    ``ids.shape + (D,)`` — ``_exchange_jit``'s owner gather (ids past the
    block clamp to its last row; only negative ids give zero rows)."""
    R, D = table.shape
    if R == 0:
        return torch.zeros(tuple(ids.shape) + (D,), dtype=table.dtype, device=table.device)
    flat = ids.reshape(-1).to(torch.int64)
    rows = table.index_select(0, torch.clamp(flat, 0, R - 1))
    rows = torch.where((flat >= 0)[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))
    return rows.view(tuple(ids.shape) + (D,))


def exchange_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One owner's answer to the ids it received, ``ids.shape + (D,)``:
    kernel K13f (``exchange_rows``) on CUDA tensors, `exchange_rows_plain`
    on CPU tensors. ``table`` ``[R, D]`` float32, ``ids`` int32 (-1 pads)."""
    if table.dim() != 2:
        raise ValueError(f"table [R, D] expected; got {tuple(table.shape)}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device} but the table on {table.device}")
    if not table.is_cuda:
        return exchange_rows_plain(table, ids)
    if table.dtype != torch.float32:
        raise TypeError(f"the exchange gather kernel copies float32 rows; got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"the exchange gather kernel takes int32 ids; got {ids.dtype}")
    table = table.contiguous()
    flat = ids.reshape(-1).contiguous()
    R, D = table.shape
    out = torch.empty((flat.shape[0], D), dtype=table.dtype, device=table.device)
    if flat.shape[0] and D:
        _kernels.launch("exchange_rows", table.data_ptr(), R, D, flat.data_ptr(), flat.shape[0],
                        out.data_ptr(), _kernels.stream_of(table))
    return out.view(tuple(ids.shape) + (D,))


# -- the single-controller exchanges ---------------------------------------------------

def _by_host(meshes, axis: str) -> list:
    """The meshes in host order, one rank a host."""
    h = meshes[0].axis_size(axis)
    if len(meshes) != h:
        raise ValueError(f"the exchange takes one rank a host: {len(meshes)} meshes for "
                         f"{h} hosts")
    return sorted(meshes, key=lambda m: m.index(axis))


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _all_to_all_ranks(meshes, axis: str, slabs: torch.Tensor, per_rank=None) -> torch.Tensor:
    """One `run_ranks` call: host ``h`` all_to_alls ``slabs[h]`` over the host
    group (then, with ``per_rank``, answers what it received with
    ``per_rank(h, recv)`` and all_to_alls that back); the results stacked in
    host order."""

    def rank(m):
        h, group = m.index(axis), m.group(axis)
        recv = collectives.all_to_all(slabs[h], group)
        if per_rank is None:
            return recv
        return collectives.all_to_all(per_rank(h, recv), group)

    return torch.stack(_train.run_ranks(rank, meshes))


def exchange_all(meshes, requests: np.ndarray, tables, axis: str = "host") -> torch.Tensor:
    """The id -> rows exchange for every host at once (single controller):
    ``requests[i, j]`` are the -1-padded owner-LOCAL row ids host i wants
    from host j, ``tables[i]`` host i's ``[R, D]`` block (an ``[H, R, D]``
    array or tensor). Returns ``[H, H, L, D]`` float32 on the meshes'
    device: ``out[i, j]`` are the rows host i received from host j."""
    meshes = _by_host(meshes, axis)
    dev = meshes[0].device
    req = _on(_ids_to_int32(requests), dev)
    if req.dim() != 3 or req.shape[0] != len(meshes) or req.shape[1] != len(meshes):
        raise ValueError(f"requests must be [H, H, L] with H = {len(meshes)}; got "
                         f"{tuple(req.shape)}")
    tab = torch.as_tensor(tables, dtype=torch.float32).to(dev)
    if tab.dim() != 3 or tab.shape[0] != len(meshes):
        raise ValueError(f"tables must be [H, R, D] with H = {len(meshes)}; got "
                         f"{tuple(tab.shape)}")
    return _all_to_all_ranks(meshes, axis, req, lambda h, recv: exchange_rows(tab[h], recv))


def exchange_serve_all(meshes, requests: np.ndarray, answer_fn, out_dim: int,
                       axis: str = "host", tenant_requests=None, ts_requests=None) -> np.ndarray:
    """The serve-shaped exchange (single controller): ship seed ids to their
    owners, run each owner's ``answer_fn(host, recv_ids)`` — ``recv_ids``
    ``[H, L]`` int32 numpy, requester-major; it returns ``[H, L, out_dim]``
    float32 answers, zero where the id is -1 — and ship the answers back.
    Returns ``[H, H, L, out_dim]`` numpy: ``out[i, j]`` are the rows host i
    got back from host j. The answerers run on the calling thread, host by
    host, between the two launches, under the collective lock."""
    if tenant_requests is not None:
        raise NotImplementedError("tenant_requests (owner-side tenant quotas) are not ported "
                                  "yet (ROADMAP A12)")
    if ts_requests is not None:
        raise NotImplementedError("ts_requests (the temporal fleet) are not ported yet "
                                  "(ROADMAP A16)")
    meshes = _by_host(meshes, axis)
    h = len(meshes)
    dev = meshes[0].device
    with _SC_COLLECTIVE_LOCK:
        req = _on(_ids_to_int32(requests), dev)
        if req.dim() != 3 or req.shape[:2] != (h, h):
            raise ValueError(f"requests must be [H, H, L] with H = {h}; got {tuple(req.shape)}")
        recv = _all_to_all_ranks(meshes, axis, req).cpu().numpy()
        L = recv.shape[2]
        rows = np.zeros((h, h, L, out_dim), np.float32)
        for host in range(h):
            try:
                ans = np.asarray(answer_fn(host, recv[host]), np.float32)
            except OwnerAnswerError:
                raise
            except Exception as exc:
                raise OwnerAnswerError(host, exc) from exc
            if ans.shape != (h, L, out_dim):
                raise ValueError(f"answer_fn(host={host}) returned {ans.shape}, expected "
                                 f"{(h, L, out_dim)}")
            rows[host] = ans
        return _all_to_all_ranks(meshes, axis, _on(rows, dev)).cpu().numpy()


class TorchComm:
    """The port of ``TpuComm`` / the reference's ``NcclComm``: one handle
    per host process, whose ``exchange`` every host calls together. In the
    single-controller mode ported here one process simulates the pod: it
    registers every host's table block and serve answerer, and ``rank``
    picks which host's answers a call returns. ``meshes`` default to
    ``local_meshes(hosts, hosts=hosts, device=device)`` (the card unless the
    caller asks for the CPU): one rank thread a host, gloo groups of this
    comm's own."""

    def __init__(self, rank: int, world_size: int, nccl_id=None, hosts: Optional[int] = None,
                 ranks_per_host: int = 1, meshes=None, axis: str = "host", device=None):
        del nccl_id  # the reference passes the NCCL unique id here
        self.rank = rank
        self.world_size = world_size
        self.table = HostRankTable(hosts or world_size, ranks_per_host)
        if meshes is None:
            meshes = _train.local_meshes(self.table.hosts, hosts=self.table.hosts,
                                         device=device)
        self.meshes = list(meshes)
        self.axis = axis
        self.device = self.meshes[0].device
        # one process a host (make_mesh over torch.distributed): each holds
        # only its own block and answerer — not ported
        self.multiprocess = len(self.meshes) < self.table.hosts
        # a request budget every host agrees on without communicating
        self.static_budget: Optional[int] = None
        self._local_tables = {}
        self._table_stack_dev: Optional[torch.Tensor] = None
        self._serve_answerers = {}

    @property
    def host(self) -> int:
        return self.table.rank2host(self.rank)

    def _refuse_multiprocess(self, what: str) -> None:
        if self.multiprocess:
            raise NotImplementedError(f"multi-process {what} (one process a host) is not "
                                      "ported yet (ROADMAP A16)")

    def _budget(self, host2ids, budget: Optional[int]) -> int:
        if budget is not None:
            return budget
        if self.static_budget is not None:
            return self.static_budget
        return round_up_pow2(max((len(i) for i in host2ids), default=1))

    def _request(self, host2ids, budget: int, what: str) -> np.ndarray:
        """The global ``[H, H, budget]`` request: this host's lists in row
        ``self.host``, -1 elsewhere."""
        h = self.table.hosts
        req = np.full((h, h, budget), ID_PAD, np.int64)
        for j, ids in enumerate(host2ids):
            ids = np.asarray(ids, np.int64)
            if ids.shape[0] > budget:
                raise ValueError(f"{what} to host {j} ({ids.shape[0]} ids) exceeds the exchange "
                                 f"budget {budget}; raise static_budget")
            req[self.host, j, : ids.shape[0]] = ids
        return req

    def exchange(self, host2ids: Sequence[np.ndarray],
                 budget: Optional[int] = None) -> List[Optional[torch.Tensor]]:
        """Rows for per-host lists of owner-LOCAL row ids (`DistFeature`
        localizes global ids before calling), from the blocks registered with
        `register_local_table`: one ``[len(ids), D]`` tensor on the comm's
        device per host, None where nothing was asked."""
        rec = EXCHANGE_SPANS
        t_span0 = _EXCHANGE_CLOCK() if rec is not None else 0.0
        self._refuse_multiprocess("exchange")
        budget = self._budget(host2ids, budget)
        req = self._request(host2ids, budget, "request")
        with _SC_COLLECTIVE_LOCK:
            out = exchange_all(self.meshes, req, self._tables_for_exchange(self.table.hosts),
                               self.axis)
        mine = self._my_rows(out)
        res: List[Optional[torch.Tensor]] = [mine[j, :len(ids)] if len(ids) else None
                                             for j, ids in enumerate(host2ids)]
        if rec is not None:
            rec.record("comm.exchange", t_span0, _EXCHANGE_CLOCK())
        return res

    def _my_rows(self, out):
        """This host's slice of an ``[H, H, L, ...]`` exchange result."""
        return out[self.host]

    def _tables_for_exchange(self, h: int) -> torch.Tensor:
        """The ``[H, R, D]`` float32 stack of the registered blocks on the
        comm's device, zero-padded to the largest block; built once and
        dropped by `register_local_table`."""
        if self._table_stack_dev is not None:
            return self._table_stack_dev
        if not self._local_tables:
            raise RuntimeError("register_local_table(host, rows) must be called before exchange")
        rows = max(b.shape[0] for b in self._local_tables.values())
        dim = next(iter(self._local_tables.values())).shape[1]
        stack = torch.zeros((h, rows, dim), dtype=torch.float32, device=self.device)
        for host, b in self._local_tables.items():
            stack[host, : b.shape[0]] = b.to(self.device)
        self._table_stack_dev = stack
        return stack

    def register_local_table(self, host: int, rows) -> None:
        """Host ``host``'s ``[R, D]`` row block (numpy or a tensor)."""
        self._local_tables[host] = torch.as_tensor(rows, dtype=torch.float32)
        self._table_stack_dev = None

    # -- the serve-shaped exchange (seed ids out, logits back) ---------------------

    def register_serve_answerer(self, host: int, fn) -> None:
        """``host``'s answer callback for `exchange_serve`: ``fn(recv_ids [H,
        L] int32, -1-padded, requester-major) -> [H, L, C] float32``."""
        self._serve_answerers[host] = fn

    def exchange_serve(self, host2ids: Sequence[np.ndarray], out_dim: int,
                       budget: Optional[int] = None, host2tenants=None,
                       host2ts=None) -> List[Optional[np.ndarray]]:
        """Ship per-owner seed-id lists out, run each owner's registered
        answerer, get logits back: one ``[len(ids), out_dim]`` float32 array
        per owner (None where nothing was asked), in ``host2ids`` order."""
        rec = EXCHANGE_SPANS
        t_span0 = _EXCHANGE_CLOCK() if rec is not None else 0.0
        if host2tenants is not None:
            raise NotImplementedError("host2tenants (owner-side tenant quotas) is not ported "
                                      "yet (ROADMAP A12)")
        if host2ts is not None:
            raise NotImplementedError("host2ts (the temporal fleet) is not ported yet "
                                      "(ROADMAP A16)")
        self._refuse_multiprocess("exchange_serve")
        budget = self._budget(host2ids, budget)
        h = self.table.hosts
        missing = [j for j in range(h) if j not in self._serve_answerers]
        if missing:
            raise RuntimeError("single-controller exchange_serve needs every host's answerer "
                               f"registered (missing {missing}); call register_serve_answerer "
                               "per host")
        req = self._request(host2ids, budget, "serve request")
        answerers = self._serve_answerers
        out = exchange_serve_all(self.meshes, req,
                                 lambda host, recv_ids: answerers[host](recv_ids), out_dim,
                                 self.axis)
        mine = self._my_rows(out)
        res = [mine[j, :len(ids)] if len(ids) else None for j, ids in enumerate(host2ids)]
        if rec is not None:
            rec.record("comm.exchange_serve", t_span0, _EXCHANGE_CLOCK())
        return res

    # the reference's raw verbs
    def allreduce(self, x):
        self._refuse_multiprocess("allreduce (sum inside the step: parallel.collectives)")
        return torch.as_tensor(x)  # single controller: already global

    def send(self, *_a, **_k):
        raise NotImplementedError("point-to-point send/recv is not part of the port; use "
                                  "exchange() (one all_to_all)")

    recv = send


# the reference's names
TpuComm = TorchComm
NcclComm = TorchComm

__all__ = ["HostRankTable", "ID_PAD", "NcclComm", "OwnerAnswerError", "TorchComm", "TpuComm",
           "exchange_all", "exchange_rows", "exchange_rows_plain", "exchange_serve_all",
           "record_exchange_spans", "round_up_pow2", "schedule"]

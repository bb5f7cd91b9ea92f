"""Data-parallel training over a (dp, ici) mesh of ranks — the port of
``quiver_tpu/parallel/train.py`` (``make_mesh_shape``, ``make_mesh``,
``mesh_axes``, ``make_sharded_train_step``, ``make_sharded_topo_train_step``,
``shard_feature_rows``, ``replicate``), on the mesh with no host axis.

The JAX package runs one jitted ``shard_map`` program over a device mesh.
The port runs one rank a device slot, each with its own `Mesh`: the ranks
whose ``dp_idx`` is equal form an ``ici`` group, over which the feature table
(and, with `make_sharded_topo_train_step`, the graph) is row-striped; the
ranks whose ``ici_idx`` is equal form a ``dp`` group, which splits the seeds
and averages the gradients (one all-reduce of the flattened gradients and
the loss, divided by dp, in place of ``lax.pmean``). Every rank then applies
the same ``torch.optim.Adam`` update, so the replicas stay bit-equal.

Two ways to build the meshes:

- `local_meshes` — ``n`` ranks in one process, each a thread with its own
  gloo groups over an in-process store and, on the card, its own CUDA
  stream; `run_ranks` runs a function on every rank. This is the
  counterpart of the JAX package's virtual device mesh, and on one GPU the
  only way to run several ranks (NCCL refuses two ranks on one device).
- `make_mesh` — one process a GPU under ``torch.distributed`` (``torchrun``):
  the default world, split by ``dist.new_group``. Unverified: the port has
  been run on one card only.

Not ported yet (ROADMAP A16, the host axis): ``hosts=``, ``hot_rows`` /
``cold_budget``, `shard_feature_hot_cold` and `calibrate_cold_budget`, which
raise.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import random as qrandom
from ..pyg.sage_sampler import sample_and_gather_dedup, sample_and_gather_fused
from ..utils import resolve_device
from . import collectives
from .collectives import HOST_AXIS_TODO, pad_to_multiple, sharded_gather

# how long a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0


class Mesh:
    """One rank's view of a ``(dp, ici)`` mesh: its indices on the two axes,
    the group of each axis (``dp_group`` links the ranks that share its
    ``ici_idx``, ``ici_group`` those that share its ``dp_idx``), its device
    and, on the card, the CUDA stream its work runs on. The flat rank is
    ``dp_idx * ici + ici_idx``, the order of the JAX mesh's devices."""

    axis_names = ("dp", "ici")

    def __init__(self, dp: int, ici: int, dp_idx: int, ici_idx: int, dp_group, ici_group,
                 device, stream=None, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.dp, self.ici = int(dp), int(ici)
        self.dp_idx, self.ici_idx = int(dp_idx), int(ici_idx)
        self.dp_group, self.ici_group = dp_group, ici_group
        self.device = torch.device(device)
        self.stream = stream
        self.timeout_s = float(timeout_s)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "ici": self.ici}

    @property
    def rank(self) -> int:
        return self.dp_idx * self.ici + self.ici_idx

    @property
    def size(self) -> int:
        return self.dp * self.ici

    def index(self, axis: str) -> int:
        return {"dp": self.dp_idx, "ici": self.ici_idx}[self._check(axis)]

    def axis_size(self, axis: str) -> int:
        return self.shape[self._check(axis)]

    def group(self, axis: str):
        return {"dp": self.dp_group, "ici": self.ici_group}[self._check(axis)]

    def _check(self, axis: str) -> str:
        if axis == "host":
            raise NotImplementedError(f"mesh axis 'host': {HOST_AXIS_TODO}")
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; the mesh has {self.axis_names}")
        return axis

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, ici={self.ici}, dp_idx={self.dp_idx}, "
                f"ici_idx={self.ici_idx}, device={self.device})")


def make_mesh_shape(n: int, dp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, ici) factorization: ici takes the largest power-of-two factor."""
    if dp is None:
        dp = 1
        m = n
        while m % 2 == 0 and dp < m // 2:
            dp *= 2
            m //= 2
    if dp <= 0 or n % dp != 0:
        raise ValueError(f"make_mesh: dp={dp} does not divide device count {n}")
    return dp, n // dp


def _no_hosts(hosts):
    if hosts is not None:
        raise NotImplementedError(f"make_mesh(hosts={hosts}): {HOST_AXIS_TODO}")


def _gloo_group(store, prefix: str, rank: int, size: int, timeout_s: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, size, opts)


def local_meshes(n: int, dp: Optional[int] = None, device=None, hosts=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Mesh]:
    """``n`` ranks of a ``make_mesh_shape(n, dp)`` mesh in this process, all
    on ``device`` (the card unless the caller asks for the CPU), in rank
    order. Each rank gets its own gloo groups over one in-process store,
    with ``timeout_s`` on every collective, and on a CUDA device its own
    stream; drive them with `run_ranks`. On one card the ranks of an
    ``ici`` stripe may share a tensor (they only read it)."""
    _no_hosts(hosts)
    dp, ici = make_mesh_shape(n, dp)
    dev = resolve_device(device)
    store = dist.HashStore()
    groups = [None] * n
    errors = []

    def build(r):
        try:
            dp_idx, ici_idx = divmod(r, ici)
            groups[r] = (_gloo_group(store, f"dp/{ici_idx}", dp_idx, dp, timeout_s),
                         _gloo_group(store, f"ici/{dp_idx}", ici_idx, ici, timeout_s))
        except Exception as exc:  # the joining thread re-raises it
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if errors or any(g is None for g in groups):
        raise RuntimeError(f"local_meshes: building the gloo groups failed: {errors}") from (
            errors[0] if errors else None)
    meshes = []
    for r in range(n):
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        meshes.append(Mesh(dp, ici, *divmod(r, ici), *groups[r], dev, stream, timeout_s))
    return meshes


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, hosts=None,
              device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of a ``(dp, ici)`` mesh over the default
    ``torch.distributed`` world (one process a GPU, e.g. under ``torchrun``;
    the caller has run ``init_process_group``). Every rank must call it, in
    the same order as its other ``new_group`` calls. ``device`` defaults to
    ``cuda:LOCAL_RANK``. Unverified on several GPUs."""
    _no_hosts(hosts)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first; "
                           "use local_meshes for ranks in one process")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: requested {n} devices but the world has {world} ranks")
    dp, ici = make_mesh_shape(n, dp)
    timeout = datetime.timedelta(seconds=timeout_s)
    dp_groups = [dist.new_group([d * ici + i for d in range(dp)], timeout=timeout)
                 for i in range(ici)]
    ici_groups = [dist.new_group([d * ici + i for i in range(ici)], timeout=timeout)
                  for d in range(dp)]
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    dp_idx, ici_idx = divmod(rank, ici)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    return Mesh(dp, ici, dp_idx, ici_idx, dp_groups[ici_idx], ici_groups[dp_idx], dev,
                stream, timeout_s)


def mesh_axes(mesh: Mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """(data_axes, feature_axes, n_data_groups) for a port mesh: seeds and
    gradients span ``("dp",)``, the feature table stripes over ``("ici",)``."""
    return ("dp",), ("ici",), mesh.dp


def run_ranks(fn: Callable[[Mesh], object], meshes: Sequence[Mesh],
              timeout_s: Optional[float] = None) -> list:
    """Run ``fn(mesh)`` for every rank of ``meshes`` at once, one thread a
    rank (on the card inside the rank's device and stream), and return the
    results in rank order. When a rank raises, the others fail at their next
    collective within the groups' timeout; the exception of the rank that
    failed first is re-raised. A run still going after ``timeout_s`` (default:
    twice the groups' timeout) raises ``TimeoutError``. Each rank's stream
    first waits for the work the caller has queued on its own current stream
    of that device (the rank streams do not wait for it by themselves)."""
    meshes = list(meshes)
    results = [None] * len(meshes)
    failures = []  # (time, rank, exception)
    queued = {}  # device -> event at the end of the caller's queued work
    for m in meshes:
        if m.device.type == "cuda" and m.device not in queued:
            queued[m.device] = torch.cuda.Event()
            queued[m.device].record(torch.cuda.current_stream(m.device))

    def body(r, mesh):
        try:
            if mesh.device.type == "cuda":
                mesh.stream.wait_event(queued[mesh.device])
                with torch.cuda.device(mesh.device), torch.cuda.stream(mesh.stream):
                    results[r] = fn(mesh)
                    mesh.stream.synchronize()
            else:
                results[r] = fn(mesh)
        except BaseException as exc:  # re-raised by the caller's thread below
            failures.append((time.monotonic(), r, exc))

    if timeout_s is None:
        timeout_s = 2 * max(m.timeout_s for m in meshes)
    threads = [threading.Thread(target=body, args=(r, m), daemon=True, name=f"rank{r}")
               for r, m in enumerate(meshes)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    if failures:
        _, r, exc = min(failures, key=lambda f: f[0])
        others = sorted(rr for _, rr, _ in failures if rr != r)
        exc.add_note(f"run_ranks: rank {r} failed first"
                     + (f"; ranks {others} failed after it" if others else ""))
        raise exc
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise TimeoutError(f"run_ranks: {alive} still running after {timeout_s} s")
    return results


# -- the train steps ---------------------------------------------------------------

def _validate_step_config(pipeline, caps, hot_rows, cold_budget):
    """Shared precondition checks of both step factories."""
    if pipeline not in ("dedup", "fused"):
        raise ValueError(f"unknown pipeline: {pipeline!r}")
    if pipeline == "fused" and caps is not None:
        raise ValueError(
            "caps only apply to the dedup pipeline: the fused layout is "
            "structural (width is exactly B*prod(1+k), not cappable)"
        )
    if hot_rows is not None or cold_budget is not None:
        raise NotImplementedError(f"hot_rows/cold_budget: {HOST_AXIS_TODO}")


def _fold_group_key(key, mesh: Mesh):
    """Distinct sample stream per data-parallel group, identical within an
    ici group."""
    return qrandom.fold_in(key, mesh.dp_idx)


def _dp_shard(seeds, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the global seed batch (the JAX step's
    ``P("dp")`` split): ``[B]`` int32 on the rank's device."""
    seeds = torch.as_tensor(seeds)
    if seeds.dim() != 1 or seeds.shape[0] == 0 or seeds.shape[0] % mesh.dp:
        raise ValueError(f"seeds must be [dp * B] with dp = {mesh.dp}; got {tuple(seeds.shape)}")
    b = seeds.shape[0] // mesh.dp
    return seeds[mesh.dp_idx * b:(mesh.dp_idx + 1) * b].to(mesh.device, torch.int32)


def _dropout_generator(key, device) -> torch.Generator:
    """A generator seeded from a host key: the same on every rank of an ici
    group (their replicas must see the same dropout masks), distinct
    across dp groups."""
    return torch.Generator(device=device).manual_seed((int(key[0]) << 32) | int(key[1]))


def _loss_and_update(model, optimizer, mesh: Mesh, train: bool, dropout_key, ds, x, labels,
                     batch: int) -> torch.Tensor:
    """Shared tail of both steps: the objective, one all-reduce of the
    flattened gradients and the loss over the dp group divided by dp (the
    JAX step's ``pmean``), and the optimizer update. Returns the mean loss
    over the dp groups (a 0-dim float32 tensor)."""
    n = labels.shape[0]
    y = labels[torch.clamp(ds.n_id[:batch].to(torch.int64), 0, n - 1)].to(torch.int64)
    gen = _dropout_generator(dropout_key, mesh.device) if train else None
    logits = model(x, ds.adjs, train=train, generator=gen)
    loss = F.cross_entropy(logits.float(), y)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [loss.detach().reshape(1)]).to(torch.float32)
    collectives.allreduce_sum(flat, mesh.dp_group)
    flat = flat / mesh.dp
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()
    optimizer.step()
    return flat[-1]


def _train_step(mesh: Mesh, model, optimizer, train: bool, sample_and_gather):
    """``step(key, *inputs, labels, seeds) -> loss`` over
    ``sample_and_gather(key, *inputs, seeds) -> (ds, x)``: the sample and
    gather with the step's key, then `_loss_and_update` with its dropout
    key. The step carries ``sample_and_gather``."""
    def step(key, *args):
        *inputs, labels, seeds = args
        dropout_key = qrandom.split(_fold_group_key(key, mesh))[1]
        ds, x = sample_and_gather(key, *inputs, seeds)
        return _loss_and_update(model, optimizer, mesh, train, dropout_key, ds, x, labels,
                                ds.batch_size)

    step.sample_and_gather = sample_and_gather
    return step


def make_sharded_train_step(
    mesh: Mesh,
    model,
    optimizer,
    sizes: Sequence[int],
    caps: Optional[Sequence[Optional[int]]] = None,
    train: bool = True,
    pipeline: str = "dedup",
    hot_rows: Optional[int] = None,
    cold_budget=None,
):
    """Build this rank's ``step(key, indptr, indices, feat_block, labels,
    seeds) -> loss``, which updates ``model`` (this rank's replica) through
    ``optimizer`` in place.

    Layout (the JAX step's sharding contract):
      - indptr/indices/labels: replicated (the whole graph on every rank, as
        int32 tensors on the rank's device; `make_sharded_topo_train_step`
        row-shards it instead);
      - feat_block: this rank's stripe of the table over ici
        (`shard_feature_rows`), the same on every rank of a dp group;
      - seeds: the global ``[dp * B]`` batch, of which the rank takes its dp
        group's slice;
      - the model and optimizer: one replica a rank, from the same weights;
        gradients and the loss are averaged over dp.

    ``key`` is a host key (`quiver_tpu_torch.random.key`); each dp group
    samples with ``fold_in(key, dp_idx)``. ``pipeline`` is "dedup" or
    "fused", as in the JAX package; every feature gather is the sharded
    gather over ici. The returned loss is the mean over the dp groups.
    ``step.sample_and_gather(key, indptr, indices, feat_block, seeds)``
    returns the step's ``(ds, x)`` without training.
    """
    _validate_step_config(pipeline, caps, hot_rows, cold_budget)
    sizes = tuple(int(k) for k in sizes)

    def gather_rows(tab, ids):
        return sharded_gather(tab, ids, mesh, "ici")

    def sample_and_gather(key, indptr, indices, feat_block, seeds):
        local = _dp_shard(seeds, mesh)
        key = qrandom.split(_fold_group_key(key, mesh))[0]
        if pipeline == "fused":
            return sample_and_gather_fused(indptr, indices, feat_block, key, local, sizes,
                                           gather_fn=gather_rows)
        return sample_and_gather_dedup(indptr, indices, feat_block, key, local, sizes, caps,
                                       gather_fn=gather_rows)

    return _train_step(mesh, model, optimizer, train, sample_and_gather)


def make_sharded_topo_train_step(
    mesh: Mesh,
    model,
    optimizer,
    sizes: Sequence[int],
    caps: Optional[Sequence[Optional[int]]] = None,
    train: bool = True,
    pipeline: str = "dedup",
    hot_rows: Optional[int] = None,
    cold_budget=None,
    layout: Optional[str] = None,
):
    """`make_sharded_train_step` with the GRAPH row-sharded over ici: build
    this rank's ``step(key, stopo, feat_block, labels, seeds) -> loss``.

    ``stopo`` is this rank's block (`topology.shard_topology_rows`, the same
    ``layout``): each rank holds only the CSR rows of its ici shard, and each
    hop's draw is the owner-masked sample (K13b) summed over the ici group
    (`topology.sharded_sample_layer`, `tiled_sharded_sample_layer`): the same
    neighbors as the unsharded draw with the same key, in either layout.
    ``layout`` None resolves as `topology.resolve_topology_layout` does for
    the rank's device. Per-step collective bytes: `topology.sampling_comm_bytes`.
    ``step.sample_and_gather(key, stopo, feat_block, seeds)`` returns the
    step's ``(ds, x)`` without training.
    """
    from .topology import resolve_topology_layout, sharded_sample_layer, tiled_sharded_sample_layer

    layout = resolve_topology_layout(layout, mesh.device)
    _validate_step_config(pipeline, caps, hot_rows, cold_budget)
    sizes = tuple(int(k) for k in sizes)

    def gather_rows(tab, ids):
        return sharded_gather(tab, ids, mesh, "ici")

    def sample_fn_of(stopo):
        if stopo.layout != layout:
            raise ValueError(f"the step was built for the {layout} layout; stopo is {stopo.layout}")
        if layout == "tiled":
            def sample_fn(cur, cur_valid, k, sub):
                return tiled_sharded_sample_layer(stopo.bd, stopo.tiles, stopo.row_start, cur,
                                                  cur_valid, k, sub, mesh, "ici")
        else:
            def sample_fn(cur, cur_valid, k, sub):
                return sharded_sample_layer(stopo.indptr, stopo.indices, stopo.row_start, cur,
                                            cur_valid, k, sub, mesh, "ici")
        return sample_fn

    def sample_and_gather(key, stopo, feat_block, seeds):
        local = _dp_shard(seeds, mesh)
        key = qrandom.split(_fold_group_key(key, mesh))[0]
        sample_fn = sample_fn_of(stopo)
        if pipeline == "fused":
            return sample_and_gather_fused(None, None, feat_block, key, local, sizes,
                                           gather_fn=gather_rows, sample_fn=sample_fn)
        return sample_and_gather_dedup(None, None, feat_block, key, local, sizes, caps,
                                       gather_fn=gather_rows, sample_fn=sample_fn)

    return _train_step(mesh, model, optimizer, train, sample_and_gather)


def stripe_rows(table, shards: int, p: int):
    """Rows ``[p * R, (p + 1) * R)`` of ``table`` padded with zero rows to a
    multiple of ``shards`` (``R = ceil(N / shards)``): stripe ``p`` of
    `shard_feature_rows`. A torch table stays on its device, and a stripe
    that needs no padding is a view of it (no copy)."""
    n = table.shape[0]
    r = -(-n // shards)
    lo, hi = min(p * r, n), min((p + 1) * r, n)
    if isinstance(table, torch.Tensor):
        part = table[lo:hi]
        if hi - lo == r:
            return part
        pad = torch.zeros((r - (hi - lo),) + tuple(table.shape[1:]), dtype=table.dtype,
                          device=table.device)
        return torch.cat([part, pad])
    return pad_to_multiple(np.asarray(table), shards)[p * r:(p + 1) * r]


def shard_feature_rows(mesh: Mesh, table) -> torch.Tensor:
    """This rank's ``[ceil(N / ici), D]`` stripe of a ``[N, D]`` table (numpy
    or torch) row-striped over ici and replicated over dp, on the rank's
    device; N is padded with zero rows to a multiple of ici. On one card the
    ranks of a dp group may pass the same stripe tensor: the steps only
    read it."""
    block = stripe_rows(table, mesh.ici, mesh.ici_idx)
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device)


def shard_feature_hot_cold(*args, **kwargs):
    """Not ported yet: the replicated-hot placement of a multi-host mesh."""
    raise NotImplementedError(f"shard_feature_hot_cold: {HOST_AXIS_TODO}")


def calibrate_cold_budget(*args, **kwargs):
    """Not ported yet: the cold-lane budget of the hot/cold gather."""
    raise NotImplementedError(f"calibrate_cold_budget: {HOST_AXIS_TODO}")


def replicate(mesh: Mesh, x):
    """Place ``x`` on the rank's device, replicated: a tensor or numpy array
    moves there (one tensor serves every rank of a device, which only read
    it); an ``nn.Module`` is copied, since each rank updates its own
    replica; lists, tuples and dicts recurse."""
    if isinstance(x, torch.nn.Module):
        import copy

        return copy.deepcopy(x).to(mesh.device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    if isinstance(x, dict):
        return {k: replicate(mesh, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(mesh, v) for v in x)
    return x

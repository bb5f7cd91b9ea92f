"""Data-parallel training over a (dp, ici) or (host, dp, ici) mesh of
ranks — the port of ``quiver_tpu/parallel/train.py`` (``make_mesh_shape``,
``make_mesh``, ``mesh_axes``, ``make_sharded_train_step``,
``make_sharded_topo_train_step``, ``shard_feature_rows``,
``shard_feature_hot_cold``, ``calibrate_cold_budget``, ``replicate``).

The JAX package runs one jitted ``shard_map`` program over a device mesh.
The port runs one rank a device slot, each with its own `Mesh`: the ranks
whose ``dp_idx`` (and ``host_idx``) are equal form an ``ici`` group, over
which the feature table (and, with `make_sharded_topo_train_step`, the
graph) is row-striped; the ranks whose ``ici_idx`` (and ``host_idx``) are
equal form a ``dp`` group. On a host mesh (``hosts=``) the seeds and the
gradients span the data axes ``("host", "dp")`` and the table stripes over
the feature axes ``("host", "ici")``, as in the JAX package (`mesh_axes`);
hosts sample different seeds, so the feature gathers and the sharded draws
become the grouped ones. Each step sums the flattened gradients and the loss
over the data group in one all-reduce and divides by the number of data
groups (``lax.pmean``); every rank then applies the same
``torch.optim.Adam`` update, so the replicas stay bit-equal.

Two ways to build the meshes:

- `local_meshes` — ``n`` ranks in one process, each a thread with its own
  gloo groups over an in-process store and, on the card, its own CUDA
  stream; `run_ranks` runs a function on every rank. This is the
  counterpart of the JAX package's virtual device mesh, and on one GPU the
  only way to run several ranks (NCCL refuses two ranks on one device).
- `make_mesh` — one process a GPU under ``torch.distributed`` (``torchrun``):
  the default world, split by ``dist.new_group``. Unverified: the port has
  been run on one card only.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import random as qrandom
from ..pyg.sage_sampler import sample_and_gather_dedup, sample_and_gather_fused
from ..utils import resolve_device
from . import collectives
from .collectives import pad_to_multiple

# how long a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0

# the group families a mesh builds, in the order every rank builds them:
# name -> the axes a group spans (its members differ on those axes only)
GROUP_AXES = {"dp": ("dp",), "ici": ("ici",), "host": ("host",), "data": ("host", "dp"),
              "feat": ("host", "ici")}


class Mesh:
    """One rank's view of a ``(dp, ici)`` mesh, or with ``hosts`` of a
    ``(host, dp, ici)`` mesh: its index on each axis, the group of each axis
    and, on a host mesh, of the data axes ``("host", "dp")`` and the feature
    axes ``("host", "ici")``; its device and, on the card, the CUDA stream its
    work runs on. The flat rank is ``(host_idx * dp + dp_idx) * ici +
    ici_idx``, the order of the JAX mesh's devices.

    ``index``, ``axis_size`` and ``group`` take an axis or a tuple of axes
    (indexed flat, major to minor). ``groups`` maps each `GROUP_AXES` family
    the mesh has to this rank's group of it."""

    def __init__(self, dp: int, ici: int, dp_idx: int, ici_idx: int, groups: Dict[str, object],
                 device, stream=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 hosts: Optional[int] = None, host_idx: int = 0):
        self.dp, self.ici = int(dp), int(ici)
        self.dp_idx, self.ici_idx = int(dp_idx), int(ici_idx)
        self.hosts = None if hosts is None else int(hosts)
        self.host_idx = int(host_idx)
        self.axis_names = ("dp", "ici") if hosts is None else ("host", "dp", "ici")
        self._groups = {GROUP_AXES[name]: g for name, g in groups.items()}
        self.device = torch.device(device)
        self.stream = stream
        self.timeout_s = float(timeout_s)

    @property
    def shape(self) -> dict:
        out = {"dp": self.dp, "ici": self.ici}
        return out if self.hosts is None else {"host": self.hosts, **out}

    @property
    def rank(self) -> int:
        return self.index(self.axis_names)

    @property
    def size(self) -> int:
        return self.axis_size(self.axis_names)

    @property
    def dp_group(self):
        return self.group("dp")

    @property
    def ici_group(self):
        return self.group("ici")

    def _names(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"unknown mesh axis {a!r}; the mesh has {self.axis_names}")
        return names

    def index(self, axes) -> int:
        own = {"host": self.host_idx, "dp": self.dp_idx, "ici": self.ici_idx}
        idx = 0
        for a in self._names(axes):
            idx = idx * self.shape[a] + own[a]
        return idx

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._names(axes):
            n *= self.shape[a]
        return n

    def group(self, axes):
        names = self._names(axes)
        if names not in self._groups:
            raise ValueError(f"the mesh builds no group over {names}; it has "
                             f"{sorted(self._groups)}")
        return self._groups[names]

    def __repr__(self) -> str:
        host = "" if self.hosts is None else f"host={self.hosts}, host_idx={self.host_idx}, "
        return (f"Mesh({host}dp={self.dp}, ici={self.ici}, dp_idx={self.dp_idx}, "
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


def _mesh_layout(n: int, dp: Optional[int], hosts: Optional[int]):
    """(hosts or None, dp, ici, families): the JAX package's ``make_mesh``
    shapes — ``(H, *make_mesh_shape(n // H, dp))`` with ``hosts`` — and the
    group families the mesh builds."""
    if hosts is None:
        return (None, *make_mesh_shape(n, dp), ("dp", "ici"))
    if hosts <= 0 or n % hosts != 0:
        raise ValueError(f"make_mesh: hosts={hosts} does not divide {n}")
    return (hosts, *make_mesh_shape(n // hosts, dp), tuple(GROUP_AXES))


def _coords(r: int, dp: int, ici: int) -> Tuple[int, int, int]:
    """(host_idx, dp_idx, ici_idx) of flat rank ``r``."""
    h, rest = divmod(r, dp * ici)
    return (h, *divmod(rest, ici))


def _family_members(family: str, h: int, d: int, i: int, hosts: int, dp: int, ici: int):
    """(key, ranks) of rank (h, d, i)'s group of ``family``: the ranks that
    share its coordinates off the family's axes, in the order of those axes
    (flat, major to minor: a rank's place in the list is its index there)."""
    axes = GROUP_AXES[family]
    coords = {"host": range(hosts), "dp": range(dp), "ici": range(ici)}
    fixed = {"host": h, "dp": d, "ici": i}
    ranks = []
    for hh in (coords["host"] if "host" in axes else (h,)):
        for dd in (coords["dp"] if "dp" in axes else (d,)):
            for ii in (coords["ici"] if "ici" in axes else (i,)):
                ranks.append((hh * dp + dd) * ici + ii)
    key = "/".join(str(fixed[a]) for a in ("host", "dp", "ici") if a not in axes)
    return key, ranks


def _gloo_group(store, prefix: str, rank: int, size: int, timeout_s: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, size, opts)


def local_meshes(n: int, dp: Optional[int] = None, device=None, hosts: Optional[int] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Mesh]:
    """``n`` ranks of the ``make_mesh(n, dp, hosts)`` mesh in this process,
    all on ``device`` (the card unless the caller asks for the CPU), in rank
    order. Each rank gets its own gloo groups over one in-process store
    (every family of the mesh, built in one order by every rank, each group
    under a prefix of its own), with ``timeout_s`` on every collective, and
    on a CUDA device its own stream; drive them with `run_ranks`. On one card
    the ranks of a stripe may share a tensor (they only read it)."""
    hosts, dp, ici, families = _mesh_layout(n, dp, hosts)
    dev = resolve_device(device)
    store = dist.HashStore()
    groups: List[Optional[dict]] = [None] * n
    errors = []

    def build(r):
        try:
            h, d, i = _coords(r, dp, ici)
            built = {}
            for fam in families:
                key, ranks = _family_members(fam, h, d, i, hosts or 1, dp, ici)
                built[fam] = _gloo_group(store, f"{fam}/{key}", ranks.index(r), len(ranks),
                                         timeout_s)
            groups[r] = built
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
        h, d, i = _coords(r, dp, ici)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        meshes.append(Mesh(dp, ici, d, i, groups[r], dev, stream, timeout_s, hosts, h))
    return meshes


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              hosts: Optional[int] = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of the ``(dp, ici)`` mesh, or with ``hosts`` of
    the ``(host, dp, ici)`` mesh, over the default ``torch.distributed``
    world (one process a GPU, e.g. under ``torchrun``; the caller has run
    ``init_process_group``). Every rank must call it, in the same order as
    its other ``new_group`` calls: it makes every group of every family
    (``dist.new_group`` is collective). ``device`` defaults to
    ``cuda:LOCAL_RANK``. Unverified on several GPUs."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first; "
                           "use local_meshes for ranks in one process")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: requested {n} devices but the world has {world} ranks")
    hosts, dp, ici, families = _mesh_layout(n, dp, hosts)
    timeout = datetime.timedelta(seconds=timeout_s)
    h, d, i = _coords(rank, dp, ici)
    mine = {}
    for fam in families:
        seen = set()
        for r in range(n):  # every group of the family, each once, in one order
            key, ranks = _family_members(fam, *_coords(r, dp, ici), hosts or 1, dp, ici)
            if key in seen:
                continue
            seen.add(key)
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine[fam] = g
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    return Mesh(dp, ici, d, i, mine, dev, stream, timeout_s, hosts, h)


def mesh_axes(mesh: Mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """(data_axes, feature_axes, n_data_groups) for a port mesh — the one
    place the layout conventions live, as in the JAX package: seeds and
    gradients span ``data_axes`` (``("host", "dp")`` on a host mesh, else
    ``("dp",)``), the feature table stripes over ``feature_axes``
    (``("host", "ici")``, else ``("ici",)``)."""
    has_host = "host" in mesh.axis_names
    data_axes = ("host", "dp") if has_host else ("dp",)
    feat_axes = ("host", "ici") if has_host else ("ici",)
    return data_axes, feat_axes, mesh.axis_size(data_axes)


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

def _validate_step_config(mesh: Mesh, pipeline, caps, hot_rows, cold_budget):
    """Shared precondition checks and layout facts of both step factories,
    with the JAX package's errors. Returns (has_host, feat_axes, hot_cold)."""
    if pipeline not in ("dedup", "fused"):
        raise ValueError(f"unknown pipeline: {pipeline!r}")
    if pipeline == "fused" and caps is not None:
        raise ValueError(
            "caps only apply to the dedup pipeline: the fused layout is "
            "structural (width is exactly B*prod(1+k), not cappable)"
        )
    has_host = "host" in mesh.axis_names
    hot_cold = hot_rows is not None
    if hot_cold and not has_host:
        raise ValueError(
            "hot_rows/cold_budget need a multi-host mesh: on a single host "
            "the plain ici-sharded gather already pays no DCN cost"
        )
    if hot_cold and cold_budget is None:
        raise ValueError("hot_rows set but cold_budget missing")
    return has_host, mesh_axes(mesh)[1], hot_cold


def _make_gather_rows(mesh: Mesh, hot_cold, hot_rows, cold_budget, overflow_acc):
    """The per-step feature gather both factories share: the plain sharded
    gather, the host-grouped one (hosts sample different seeds), or the
    replicated-hot/cold one (appending each call's overflow to
    ``overflow_acc``)."""
    feat_axes = mesh_axes(mesh)[1]
    has_host = "host" in feat_axes

    def gather_rows(tab, ids):
        if hot_cold:
            hot_block, cold_block = tab
            rows, overflow = collectives.sharded_gather_hot_cold(
                hot_block, cold_block, ids, mesh, feat_axes, "host", hot_rows, cold_budget)
            overflow_acc.append(overflow)
            return rows
        if not has_host:
            return collectives.sharded_gather(tab, ids, mesh, feat_axes)
        return collectives.sharded_gather_grouped(tab, ids, mesh, feat_axes, "host")

    return gather_rows


def _fold_group_key(key, mesh: Mesh):
    """Distinct sample stream per data-parallel group (``host_idx * dp +
    dp_idx``), identical within an ici group."""
    return qrandom.fold_in(key, mesh.index(mesh_axes(mesh)[0]))


def _dp_shard(seeds, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the global seed batch (the JAX step's
    ``P(data_axes)`` split): ``[B]`` int32 on the rank's device."""
    data_axes, _, groups = mesh_axes(mesh)
    seeds = torch.as_tensor(seeds)
    if seeds.dim() != 1 or seeds.shape[0] == 0 or seeds.shape[0] % groups:
        raise ValueError(f"seeds must be [groups * B] with {groups} data groups; got "
                         f"{tuple(seeds.shape)}")
    b = seeds.shape[0] // groups
    g = mesh.index(data_axes)
    return seeds[g * b:(g + 1) * b].to(mesh.device, torch.int32)


def _dropout_generator(key, device) -> torch.Generator:
    """A generator seeded from a host key: the same on every rank of an ici
    group (their replicas must see the same dropout masks), distinct
    across data groups."""
    return torch.Generator(device=device).manual_seed((int(key[0]) << 32) | int(key[1]))


def _loss_and_update(model, optimizer, mesh: Mesh, train: bool, dropout_key, ds, x, labels,
                     batch: int) -> torch.Tensor:
    """Shared tail of both steps: the objective, one all-reduce of the
    flattened gradients and the loss over the data group divided by the
    number of data groups (the JAX step's ``pmean``), and the optimizer
    update. Returns the mean loss over the data groups (a 0-dim float32
    tensor)."""
    data_axes, _, groups = mesh_axes(mesh)
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
    collectives.allreduce_sum(flat, mesh.group(data_axes))
    flat = flat / groups
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()
    optimizer.step()
    return flat[-1]


def _train_step(mesh: Mesh, model, optimizer, train: bool, sample_and_gather, hot_cold: bool):
    """``step(key, *inputs, labels, seeds) -> loss`` over
    ``sample_and_gather(key, *inputs, seeds, overflow_acc) -> (ds, x)``: the
    sample and gather with the step's key, then `_loss_and_update` with its
    dropout key. On hot/cold layouts the step returns ``(loss, overflow)``:
    the cold ids past the budget summed over the step's gathers, the most
    over the data groups (``allreduce_max``), a 0-dim int32 tensor. The step
    carries ``sample_and_gather(key, *inputs, seeds) -> (ds, x)``."""
    def step(key, *args):
        *inputs, labels, seeds = args
        dropout_key = qrandom.split(_fold_group_key(key, mesh))[1]
        overflow_acc = []
        ds, x = sample_and_gather(key, *inputs, seeds, overflow_acc)
        loss = _loss_and_update(model, optimizer, mesh, train, dropout_key, ds, x, labels,
                                ds.batch_size)
        if not hot_cold:
            return loss
        overflow = torch.stack(overflow_acc).sum(dtype=torch.int32).reshape(1)
        collectives.allreduce_max(overflow, mesh.group(mesh_axes(mesh)[0]))
        return loss, overflow[0]

    step.sample_and_gather = lambda key, *args: sample_and_gather(key, *args, [])
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
      - feat_block: this rank's stripe of the table over the feature axes
        (`shard_feature_rows`), the same on every rank of a dp group;
      - seeds: the global ``[groups * B]`` batch, of which the rank takes its
        data group's slice (``host_idx * dp + dp_idx``);
      - the model and optimizer: one replica a rank, from the same weights;
        gradients and the loss are averaged over the data groups.

    ``key`` is a host key (`quiver_tpu_torch.random.key`); each data group
    samples with ``fold_in(key, group)``. ``pipeline`` is "dedup" or
    "fused", as in the JAX package. Every feature gather is the sharded
    gather over ici, or on a host mesh the grouped gather over ``("host",
    "ici")``. The returned loss is the mean over the data groups.

    ``hot_rows``/``cold_budget`` (host meshes only) switch the gathers to
    the replicated-hot layout (`collectives.sharded_gather_hot_cold`):
    ``feat_block`` is then the ``(hot_block, cold_block)`` pair from
    `shard_feature_hot_cold`, ``cold_budget`` an int or a float fraction of
    each gather's width (`calibrate_cold_budget`), and the step returns
    ``(loss, overflow)``: the cold ids past the budget this step (their rows
    came back zero), the most over the data groups.
    ``step.sample_and_gather(key, indptr, indices, feat_block, seeds)``
    returns the step's ``(ds, x)`` without training.
    """
    _, _, hot_cold = _validate_step_config(mesh, pipeline, caps, hot_rows, cold_budget)
    sizes = tuple(int(k) for k in sizes)

    def sample_and_gather(key, indptr, indices, feat_block, seeds, overflow_acc):
        gather_rows = _make_gather_rows(mesh, hot_cold, hot_rows, cold_budget, overflow_acc)
        local = _dp_shard(seeds, mesh)
        key = qrandom.split(_fold_group_key(key, mesh))[0]
        if pipeline == "fused":
            return sample_and_gather_fused(indptr, indices, feat_block, key, local, sizes,
                                           gather_fn=gather_rows)
        return sample_and_gather_dedup(indptr, indices, feat_block, key, local, sizes, caps,
                                       gather_fn=gather_rows)

    return _train_step(mesh, model, optimizer, train, sample_and_gather, hot_cold)


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
    """`make_sharded_train_step` with the GRAPH row-sharded over the feature
    axes: build this rank's ``step(key, stopo, feat_block, labels, seeds) ->
    loss`` (``(loss, overflow)`` on hot/cold layouts).

    ``stopo`` is this rank's block (`topology.shard_topology_rows`, the same
    ``layout``): each rank holds only the CSR rows of its shard, and each
    hop's draw is the owner-masked sample (K13b) summed over the striping
    group (`topology.sharded_sample_layer`, `tiled_sharded_sample_layer`),
    or on a host mesh the grouped draw over the host-gathered frontier
    (`topology.sharded_sample_layer_grouped` and its tiled form): the same
    neighbors as the unsharded draw with the same key, in either layout.
    ``layout`` None resolves as `topology.resolve_topology_layout` does for
    the rank's device. Per-step collective bytes: `topology.sampling_comm_bytes`.
    ``step.sample_and_gather(key, stopo, feat_block, seeds)`` returns the
    step's ``(ds, x)`` without training.
    """
    from . import topology

    layout = topology.resolve_topology_layout(layout, mesh.device)
    has_host, feat_axes, hot_cold = _validate_step_config(mesh, pipeline, caps, hot_rows,
                                                          cold_budget)
    sizes = tuple(int(k) for k in sizes)

    def sample_fn_of(stopo):
        if stopo.layout != layout:
            raise ValueError(f"the step was built for the {layout} layout; stopo is {stopo.layout}")
        blk = (stopo.bd, stopo.tiles) if layout == "tiled" else (stopo.indptr, stopo.indices)
        if has_host:
            fn = (topology.tiled_sharded_sample_layer_grouped if layout == "tiled"
                  else topology.sharded_sample_layer_grouped)

            def sample_fn(cur, cur_valid, k, sub):
                return fn(*blk, stopo.row_start, cur, cur_valid, k, sub, mesh, feat_axes, "host")
        else:
            fn = (topology.tiled_sharded_sample_layer if layout == "tiled"
                  else topology.sharded_sample_layer)

            def sample_fn(cur, cur_valid, k, sub):
                return fn(*blk, stopo.row_start, cur, cur_valid, k, sub, mesh, feat_axes)
        return sample_fn

    def sample_and_gather(key, stopo, feat_block, seeds, overflow_acc):
        gather_rows = _make_gather_rows(mesh, hot_cold, hot_rows, cold_budget, overflow_acc)
        local = _dp_shard(seeds, mesh)
        key = qrandom.split(_fold_group_key(key, mesh))[0]
        sample_fn = sample_fn_of(stopo)
        if pipeline == "fused":
            return sample_and_gather_fused(None, None, feat_block, key, local, sizes,
                                           gather_fn=gather_rows, sample_fn=sample_fn)
        return sample_and_gather_dedup(None, None, feat_block, key, local, sizes, caps,
                                       gather_fn=gather_rows, sample_fn=sample_fn)

    return _train_step(mesh, model, optimizer, train, sample_and_gather, hot_cold)


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


def _on_rank(mesh: Mesh, block) -> torch.Tensor:
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device)


def shard_feature_rows(mesh: Mesh, table) -> torch.Tensor:
    """This rank's ``[ceil(N / S), D]`` stripe of a ``[N, D]`` table (numpy
    or torch) row-striped over the feature axes (S stripes: ``ici``, or
    ``host * ici`` on a host mesh, stripe ``host_idx * ici + ici_idx``) and
    replicated over dp, on the rank's device; N is padded with zero rows to
    a multiple of S. On one card the ranks of a dp group may pass the same
    stripe tensor: the steps only read it."""
    _, feat_axes, _ = mesh_axes(mesh)
    return _on_rank(mesh, stripe_rows(table, mesh.axis_size(feat_axes), mesh.index(feat_axes)))


def hot_cold_stripes(table, hot_rows: int, hosts: int, ici: int, host_idx: int, ici_idx: int):
    """Stripe ``(host_idx, ici_idx)``'s ``(hot_block, cold_block)`` of a
    heat-ordered ``[N, D]`` table (numpy or torch; a torch table stays on its
    device): rows ``< hot_rows`` zero-padded to a multiple of ``ici`` and
    striped over ici (the same on every host), the rest zero-padded to a
    multiple of ``hosts * ici`` and striped over ``(host, ici)``."""
    if not 0 < hot_rows < table.shape[0]:
        raise ValueError(f"hot_rows {hot_rows} out of range for {tuple(table.shape)}")
    hot = stripe_rows(table[:hot_rows], ici, ici_idx)
    cold = stripe_rows(table[hot_rows:], hosts * ici, host_idx * ici + ici_idx)
    return hot, cold


def shard_feature_hot_cold(mesh: Mesh, table, hot_rows: int):
    """Split a heat-ordered ``[N, D]`` table for
    `collectives.sharded_gather_hot_cold`: this rank's ``(hot_block,
    cold_block)`` on its device (`hot_cold_stripes`) — the hot prefix
    replicated per host and striped over ici, the cold rows striped over
    ``(host, ici)``, both zero-padded (the hot padding rows must be zero:
    cold ids landing there rely on it). Order the table by heat first
    (`utils.heat_reorder`): the analog of the reference's replicate-hottest
    preprocessing."""
    _, feat_axes, _ = mesh_axes(mesh)
    if "host" not in feat_axes:
        raise ValueError("hot/cold placement needs a multi-host mesh")
    hot, cold = hot_cold_stripes(table, hot_rows, mesh.hosts, mesh.ici, mesh.host_idx,
                                 mesh.ici_idx)
    return _on_rank(mesh, hot), _on_rank(mesh, cold)


def calibrate_cold_budget(sampler, probe_seeds, hot_rows: int, margin: float = 1.3) -> float:
    """Cold-lane budget FRACTION for `collectives.sharded_gather_hot_cold`,
    calibrated like the sampler caps: the largest cold share of the sampled
    id space over the probe batches (``sampler.sample_dense`` of each) times
    ``margin``, at most 1.0. A fraction because the steps gather at several
    widths a step; the gather scales it to each call's width. The id space
    must be heat-ordered (rows ``< hot_rows`` are the replicated tier).
    Prefix-valid (dedup) samples count their real lanes only; structural
    samples every lane, the conservative choice there."""
    shares = []
    for seeds in probe_seeds:
        ds = sampler.sample_dense(np.asarray(seeds))
        n_id = ds.n_id
        if all(a.cols is not None for a in ds.adjs):
            n_id = n_id[: int(ds.count)]
        if n_id.shape[0]:
            shares.append(int((n_id >= hot_rows).sum()) / n_id.shape[0])
    if not shares:
        raise ValueError("calibrate_cold_budget needs at least one probe batch")
    return float(min(max(shares) * margin, 1.0))


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

"""Streaming graph deltas — the port of ``quiver_tpu/stream.py``: serve
on a graph that changes under live traffic.

The 128-lane tile layout (`ops.sample.build_tiled_host`) leaves ``cap -
deg`` pad lanes in every node's last tile row, lanes the degree mask
already keeps out of every draw. So an edge append is a pad-lane write and
a ``(base, deg)`` write, and a node whose rows are full spills: it moves to
fresh rows from a reserve at the table's tail (its old rows copied, its
``base`` moved), the old rows becoming dead padding. An exhausted reserve
raises `StreamCapacityError`: the tables keep their shapes for the life of
the stream unless `StreamingTiledGraph.provision_reserve` grows them by a
whole bank.

Deltas gather on the host in a `GraphDelta` and reach the card as one
bounded row scatter a table a commit (B1, `tiers.set_rows`: ``csrc/
gather.cu``'s K6 body at int32 for the tile and ``(base, deg)`` rows, at
float32 for the timestamp tiles). The scatter copies on write: the
committed arrays are new tensors, and a flush that sealed against the
old ones keeps reading them (epoch pinning). A draw from the streamed
``(bd, tiles)`` is bit-equal to one from a tile table built afresh over
the updated graph (`StreamingAdjacency.to_csr_topo`): appends keep each
row's lane order (base edges first, arrivals after), and a draw reads
positions through ``base``, so a relocation changes no drawn bit.

Lifecycle (`quiver_tpu_torch.lifecycle`), three disciplines:

- a deletion (`GraphDelta.remove_edges`) shifts the row's surviving lanes
  left, so the stream stays bit-equal to a graph built without the edge;
  a timestamp update (`GraphDelta.update_edges`) rewrites one lane;
- expiry (`StreamingTiledGraph.expire_edges`) never shifts a lane: it
  sets an expired edge's timestamp to ``+inf``, which no finite query
  time reaches, and later appends to that node reuse the dead lane;
- compaction (`plan_compaction`/`apply_compaction`) moves whole rows
  through the ``base`` indirection and changes no draw.

`StreamingAdjacency` is the host bookkeeping: the base CSR and the
appended edges, forward k-hop closures, and reverse k-hop closures (the
cache invalidation set of a commit). `StreamingTiledGraph` keeps the host
mirrors and the device tensors. The serve engine drives both through
``update_graph`` (`serve.engine.ServeEngine`).

On the card the host mirrors start as a copy of the tile table that K12
builds there (`CSRTopo.tiles_on_device`); the JAX package builds them with
`build_tiled_host` on the host. The tables are bit-equal either way
(``tests/test_torch_stream.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.sample import LANE
from .tiers import set_rows
from .utils import _best_id_dtype, resolve_device

__all__ = ["GraphArrays", "GraphDelta", "StreamCapacityError", "StreamingAdjacency",
           "StreamingTiledGraph", "validate_edge_ids"]

# rows a spill grants a node beyond the ones it holds
GROW_TILES = 1


class StreamCapacityError(RuntimeError):
    """The stream's reserved tile rows are exhausted. The remedy is
    capacity planning (a larger ``reserve_frac``/``reserve_tiles``),
    compaction, or `StreamingTiledGraph.provision_reserve`: a silent growth
    would change the tables' shapes under the serve engine's captured
    steps."""


def validate_edge_ids(src, dst, n: Optional[int] = None,
                      what: str = "delta") -> Tuple[np.ndarray, np.ndarray]:
    """Flatten an edge batch to matched int64 ``(src, dst)`` arrays and,
    when ``n`` is given, check every id lies in ``[0, n)``, so a bad edge
    raises where it is staged and never reaches a pending buffer."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} / dst {dst.shape} mismatch")
    if n is not None:
        bad = (src < 0) | (src >= n) | (dst < 0) | (dst >= n)
        if bad.any():
            raise ValueError(f"{what} edge ids outside [0, {n}): "
                             f"{np.stack([src[bad], dst[bad]], 1)[:4].tolist()}")
    return src, dst


class GraphDelta:
    """A host buffer of staged graph changes, as numpy chunks in arrival
    order: appends ``(src, dst)`` (with a float32 timestamp each on a
    temporal stream: every chunk or none), removals and timestamp updates.
    A commit applies installs, then appends, then removals, then updates.
    Two buffers fed the same changes apply identically."""

    __slots__ = ("_src", "_dst", "_ts", "_n", "_rsrc", "_rdst", "_usrc", "_udst", "_uts")

    def __init__(self, src=None, dst=None, ts=None):
        self._src: List[np.ndarray] = []
        self._dst: List[np.ndarray] = []
        self._ts: List[np.ndarray] = []
        self._n = 0
        self._rsrc: List[np.ndarray] = []
        self._rdst: List[np.ndarray] = []
        self._usrc: List[np.ndarray] = []
        self._udst: List[np.ndarray] = []
        self._uts: List[np.ndarray] = []
        if src is not None or dst is not None:
            if (src is None) != (dst is None):
                raise ValueError("src/dst lengths differ")
            self.add_edges(src, dst, ts=ts)

    def add_edge(self, src: int, dst: int, ts: Optional[float] = None) -> None:
        self.add_edges(np.asarray([src], np.int64), np.asarray([dst], np.int64),
                       ts=None if ts is None else np.asarray([ts], np.float32))

    def add_edges(self, src, dst, ts=None) -> None:
        src, dst = validate_edge_ids(src, dst)
        if src.size:
            if ts is not None:
                ts = np.asarray(ts, np.float32).reshape(-1)
                if ts.shape != src.shape:
                    raise ValueError(f"ts {ts.shape} does not match edges {src.shape}")
            if self._n and (bool(self._ts) != (ts is not None)):
                raise ValueError("mixed timestamped and untimestamped edges in one GraphDelta "
                                 "— a temporal stream needs a ts per edge")
            # copies: a caller may reuse its buffers, and `extend` shares chunks
            self._src.append(src.copy())
            self._dst.append(dst.copy())
            if ts is not None:
                self._ts.append(ts.copy())
            self._n += int(src.size)

    def remove_edge(self, src: int, dst: int) -> None:
        self.remove_edges(np.asarray([src], np.int64), np.asarray([dst], np.int64))

    def remove_edges(self, src, dst) -> None:
        """Stage deletions: each ``(src, dst)`` removes the first lane-order
        occurrence of that edge at commit. All or none: one absent edge
        fails the whole commit before anything moves."""
        src, dst = validate_edge_ids(src, dst)
        if src.size:
            self._rsrc.append(src.copy())
            self._rdst.append(dst.copy())

    def update_edge(self, src: int, dst: int, ts: float) -> None:
        self.update_edges(np.asarray([src], np.int64), np.asarray([dst], np.int64),
                          np.asarray([ts], np.float32))

    def update_edges(self, src, dst, ts) -> None:
        """Stage timestamp updates (temporal streams): each pair's first
        lane-order occurrence gets the new, finite timestamp (``+inf`` is
        the expiry mark)."""
        src, dst = validate_edge_ids(src, dst)
        if ts is None:
            raise ValueError("update_edges needs a timestamp per edge — the ts lane is the "
                             "only mutable per-edge payload")
        ts = np.asarray(ts, np.float32).reshape(-1)
        if ts.shape != src.shape:
            raise ValueError(f"ts {ts.shape} != edges {src.shape}")
        if ts.size and not np.isfinite(ts).all():
            raise ValueError("non-finite edge timestamps staged — +inf is reserved as the "
                             "retention expiry sentinel")
        if src.size:
            self._usrc.append(src.copy())
            self._udst.append(dst.copy())
            self._uts.append(ts.copy())

    def extend(self, other: "GraphDelta") -> None:
        if self._n and other._n and bool(self._ts) != bool(other._ts):
            raise ValueError("cannot merge timestamped and untimestamped GraphDeltas")
        self._src.extend(other._src)
        self._dst.extend(other._dst)
        self._ts.extend(other._ts)
        self._n += other._n
        self._rsrc.extend(other._rsrc)
        self._rdst.extend(other._rdst)
        self._usrc.extend(other._usrc)
        self._udst.extend(other._udst)
        self._uts.extend(other._uts)

    def __len__(self) -> int:
        """Staged operations: appends, removals and updates."""
        return self._n + sum(c.size for c in self._rsrc) + sum(c.size for c in self._usrc)

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(src, dst)`` int64 appends in arrival order."""
        if not self._src:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return np.concatenate(self._src), np.concatenate(self._dst)

    def edges_ts(self) -> Optional[np.ndarray]:
        """The appends' float32 timestamps, or None when staged without."""
        if not self._ts:
            return None
        return np.concatenate(self._ts)

    def removals(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._rsrc:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return np.concatenate(self._rsrc), np.concatenate(self._rdst)

    def updates(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._usrc:
            return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32)
        return (np.concatenate(self._usrc), np.concatenate(self._udst),
                np.concatenate(self._uts))

    def max_ts(self):
        """The largest staged timestamp (appends and updates), or None: the
        commit clock `lifecycle.RetentionPolicy` advances on."""
        parts = [c for c in self._ts if c.size] + [c for c in self._uts if c.size]
        if not parts:
            return None
        return float(max(float(c.max()) for c in parts))

    def sources(self) -> np.ndarray:
        """Sorted unique sources of every staged change: the rows whose
        draws change (a destination is a new leaf and changes no row)."""
        parts = self._src + self._rsrc + self._usrc
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    def clear(self) -> None:
        for chunks in (self._src, self._dst, self._ts, self._rsrc, self._rdst, self._usrc,
                       self._udst, self._uts):
            chunks.clear()
        self._n = 0


class StreamingAdjacency:
    """Host bookkeeping of a streaming graph: an immutable base CSR, per
    node appended-edge lists, and the reverse CSR built once. It answers a
    node's current neighbors in tile-lane order, forward k-hop closures
    over the updated graph, and reverse k-hop closures (the invalidation
    set). A row touched by a deletion, expiry or update moves whole into an
    override list; the reverse side never shrinks, so reverse closures
    become supersets, which only over-invalidates. ``device``: where the
    reverse CSR is built and kept and the closures run, as torch tensors
    (the results are the same anywhere; on the card a products-sized graph
    sorts in well under a second, where numpy takes about half a minute,
    and a closure's passes over most of the graph release the
    interpreter's lock while the serve engine's threads run); the card
    unless the caller asks for another (`utils.resolve_device`)."""

    def __init__(self, csr_topo, edge_ts=None, device=None):
        self.indptr = np.asarray(csr_topo.indptr, np.int64)
        self.indices = np.asarray(csr_topo.indices, np.int64)
        self.n = self.indptr.shape[0] - 1
        self.edge_ts = None if edge_ts is None else np.asarray(edge_ts, np.float32).reshape(-1)
        if self.edge_ts is not None and self.edge_ts.shape[0] != self.indices.shape[0]:
            raise ValueError(f"edge_ts has {self.edge_ts.shape[0]} entries for "
                             f"{self.indices.shape[0]} edges")
        self._extra: Dict[int, List[int]] = {}
        self._extra_ts: Dict[int, List[float]] = {}
        self._rev_extra: Dict[int, List[int]] = {}
        # a lifecycle-touched row's whole lane list (int64) and timestamps
        # (float32) as arrays (the JAX package: Python lists; equal values)
        self._override: Dict[int, np.ndarray] = {}
        self._override_ts: Dict[int, np.ndarray] = {}
        # the reverse CSR (a stable sort of the edges by destination), and
        # the forward one once a forward closure asks, as tensors on device
        self.device = dev = resolve_device(device)
        dst = torch.from_numpy(self.indices).to(dev)
        rev_indptr = torch.zeros(self.n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(dst, minlength=self.n), 0, out=rev_indptr[1:])
        src_per_edge = torch.repeat_interleave(
            torch.arange(self.n, device=dev),
            torch.from_numpy(self.indptr[1:] - self.indptr[:-1]).to(dev),
            output_size=self.indices.shape[0])
        self.rev_indptr = rev_indptr
        self.rev_indices = src_per_edge[torch.sort(dst, stable=True).indices]
        self._fwd = None

    def add_edges(self, src, dst, ts=None) -> None:
        src, dst = validate_edge_ids(src, dst, self.n)
        if self.edge_ts is not None:
            if ts is None:
                raise ValueError("temporal adjacency (edge_ts set) needs a timestamp per "
                                 "appended edge")
            ts = np.asarray(ts, np.float32).reshape(-1)
            if ts.shape != src.shape:
                raise ValueError(f"ts {ts.shape} != edges {src.shape}")
        for i, (u, v) in enumerate(zip(src, dst)):
            self._append_one(int(u), int(v),
                             ts=None if self.edge_ts is None else float(ts[i]))

    def _append_one(self, u: int, v: int, ts: Optional[float] = None) -> None:
        if u in self._override:
            self._override[u] = np.append(self._override[u], np.int64(v))
            if self.edge_ts is not None:
                self._override_ts[u] = np.append(self._override_ts[u], np.float32(ts))
        else:
            self._extra.setdefault(u, []).append(v)
            if self.edge_ts is not None:
                self._extra_ts.setdefault(u, []).append(float(ts))
        self._rev_extra.setdefault(v, []).append(u)

    def _materialize(self, u: int) -> np.ndarray:
        """Fold ``u``'s base slice and extras into its override array
        (idempotent, lane order kept)."""
        ov = self._override.get(u)
        if ov is not None:
            return ov
        lo, hi = self.indptr[u], self.indptr[u + 1]
        ov = np.concatenate([self.indices[lo:hi], np.asarray(self._extra.pop(u, []), np.int64)])
        self._override[u] = ov
        if self.edge_ts is not None:
            self._override_ts[u] = np.concatenate(
                [self.edge_ts[lo:hi], np.asarray(self._extra_ts.pop(u, []), np.float32)])
        return ov

    def _lane_of(self, u: int, v: int) -> int:
        """The first lane of ``(u, v)`` in ``u``'s materialized row."""
        hits = np.flatnonzero(self._materialize(u) == v)
        if hits.size == 0:
            raise ValueError(f"edge ({u}, {v}) not present")
        return int(hits[0])

    def remove_one(self, u: int, v: int) -> int:
        """Delete the first lane-order occurrence of ``(u, v)``; returns its
        lane. Raises ValueError when the edge is absent."""
        p = self._lane_of(u, v)
        self._override[u] = np.delete(self._override[u], p)
        if self.edge_ts is not None:
            self._override_ts[u] = np.delete(self._override_ts[u], p)
        return p

    def update_one(self, u: int, v: int, ts: float) -> int:
        """Give the first lane-order occurrence of ``(u, v)`` timestamp
        ``ts``; returns its lane."""
        if self.edge_ts is None:
            raise ValueError("adjacency was built without edge_ts")
        p = self._lane_of(u, v)
        self._override_ts[u][p] = ts
        return p

    def replace_at(self, u: int, p: int, v: int, ts: Optional[float] = None) -> None:
        """Write a new edge into lane ``p`` of ``u`` (a dead lane's reuse)."""
        ov = self._materialize(u)
        ov[p] = v
        if self.edge_ts is not None:
            self._override_ts[u][p] = ts
        self._rev_extra.setdefault(v, []).append(u)

    def expire_node(self, u: int, cutoff: float) -> np.ndarray:
        """Set every timestamp of ``u`` at or below ``cutoff`` to ``+inf``
        (no lane moves); returns the lanes, ascending."""
        if self.edge_ts is None:
            raise ValueError("adjacency was built without edge_ts")
        self._materialize(u)
        tsl = self._override_ts[u]
        pos = np.flatnonzero(tsl <= cutoff)
        tsl[pos] = np.inf
        return pos

    def neighbors(self, node: int) -> np.ndarray:
        """``node``'s current neighbors in tile-lane order."""
        node = int(node)
        ov = self._override.get(node)
        if ov is not None:
            return ov.copy()
        base = self.indices[self.indptr[node]:self.indptr[node + 1]]
        extra = self._extra.get(node)
        if not extra:
            return base.copy()
        return np.concatenate([base, np.asarray(extra, np.int64)])

    def neighbors_ts(self, node: int) -> np.ndarray:
        """The timestamps of `neighbors(node)`, in the same order."""
        if self.edge_ts is None:
            raise ValueError("adjacency was built without edge_ts")
        node = int(node)
        ov = self._override_ts.get(node)
        if ov is not None:
            return ov.copy()
        base = self.edge_ts[self.indptr[node]:self.indptr[node + 1]]
        extra = self._extra_ts.get(node)
        if not extra:
            return base.copy()
        return np.concatenate([base, np.asarray(extra, np.float32)])

    def degree(self, node: int) -> int:
        node = int(node)
        ov = self._override.get(node)
        if ov is not None:
            return len(ov)
        return int(self.indptr[node + 1] - self.indptr[node]) + len(self._extra.get(node, ()))

    def forward_closure(self, seeds, hops: int) -> np.ndarray:
        """Bool ``[N]`` mask of the nodes within ``hops`` hops of ``seeds``
        over the updated graph, seeds included."""
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        if seeds.size == 0:
            return np.zeros(self.n, bool)
        if self._fwd is None:
            self._fwd = (torch.from_numpy(self.indptr).to(self.device),
                         torch.from_numpy(self.indices).to(self.device))
        return self._closure(seeds, hops, *self._fwd, self._extra, self._override).cpu().numpy()

    def reverse_closure(self, srcs, hops: int) -> np.ndarray:
        """Sorted ids of every node within ``hops`` reverse hops of
        ``srcs``, srcs included: the seeds whose samples can reach a
        changed row."""
        srcs = np.unique(np.asarray(srcs, np.int64).reshape(-1))
        if srcs.size == 0:
            return srcs
        mask = self._closure(srcs, hops, self.rev_indptr, self.rev_indices, self._rev_extra)
        return mask.nonzero().flatten().cpu().numpy()

    def _closure(self, seeds, hops, indptr, indices, extra, override=None) -> torch.Tensor:
        """Bool ``[N]`` mask (on the adjacency's device) of the nodes within
        ``hops`` BFS hops of the sorted unique ``seeds``."""
        mask = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        frontier = torch.from_numpy(seeds).to(self.device)
        mask[frontier] = True
        for _ in range(max(int(hops), 0)):
            if frontier.numel() == 0:
                break
            nxt = self._expand(frontier, indptr, indices, extra, override)
            nxt = nxt[~mask[nxt]]
            if nxt.numel() == 0:
                break
            mask[nxt] = True
            frontier = nxt
        return mask

    def _expand(self, frontier, indptr, indices, extra, override=None) -> torch.Tensor:
        """One BFS hop: the sorted distinct neighbors of ``frontier`` — base
        rows by one ragged gather, appended edges from the per node lists,
        overridden rows (forward only) from their lists — deduplicated by a
        mark a node (the JAX package: ``np.unique``, the same ids)."""
        dev = self.device
        member = torch.zeros(self.n, dtype=torch.bool, device=dev)
        member[frontier] = True
        rows, lists = frontier, []
        if override:
            ov = torch.tensor(list(override), dtype=torch.int64, device=dev)
            ov = ov[member[ov]]
            lists += [override[u] for u in ov.tolist()]
            keep = member.clone()
            keep[ov] = False
            rows = frontier[keep[frontier]]
        if extra:
            inside = member[torch.tensor(list(extra), dtype=torch.int64, device=dev)].tolist()
            lists += [vs for (u, vs), m in zip(extra.items(), inside)
                      if m and not (override and u in override)]
        hit = torch.zeros(self.n, dtype=torch.bool, device=dev)
        starts = indptr[rows]
        lens = indptr[rows + 1] - starts
        total = int(lens.sum())
        if total:
            offs = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens), lens,
                                           output_size=total)
            hit[indices[offs + torch.arange(total, device=dev)]] = True
        listed = np.concatenate([np.asarray(vs, np.int64) for vs in lists]) if lists else []
        if len(listed):
            hit[torch.from_numpy(listed).to(dev)] = True
        return hit.nonzero().flatten()

    def _rebuilt(self, base_vals, extra_vals, override_vals, dtype, new_indptr):
        """The updated graph's flat edge array of ``base_vals`` (aligned
        with the base CSR) with each row's extras after its base edges and
        each overridden row written whole."""
        base_deg = self.indptr[1:] - self.indptr[:-1]
        out = np.zeros(int(new_indptr[-1]), dtype)
        src_per_edge = np.repeat(np.arange(self.n, dtype=np.int64), base_deg)
        pos_in_row = (np.arange(self.indices.shape[0], dtype=np.int64)
                      - np.repeat(self.indptr[:-1], base_deg))
        sel = slice(None)
        if self._override:
            keep = np.ones(self.n, bool)
            keep[np.fromiter(self._override.keys(), np.int64, len(self._override))] = False
            sel = keep[src_per_edge]
        out[new_indptr[src_per_edge[sel]] + pos_in_row[sel]] = base_vals[sel]
        for u, vs in extra_vals.items():
            lo = int(new_indptr[u] + base_deg[u])
            out[lo:lo + len(vs)] = np.asarray(vs, dtype)
        for u, vs in override_vals.items():
            lo = int(new_indptr[u])
            out[lo:lo + len(vs)] = np.asarray(vs, dtype)
        return out

    def _new_indptr(self) -> np.ndarray:
        new_deg = self.indptr[1:] - self.indptr[:-1]
        new_deg = new_deg.copy()
        for u, vs in self._extra.items():
            new_deg[u] += len(vs)
        for u, vs in self._override.items():
            new_deg[u] = len(vs)
        new_indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(new_deg, out=new_indptr[1:])
        return new_indptr

    def to_csr_topo(self):
        """The updated graph as a fresh `CSRTopo`, base edges first in each
        row and arrivals after (the tile-lane order): a sampler built over
        it draws what the streamed tiles draw. The replay surface."""
        from .utils import CSRTopo

        if not self._extra and not self._override:
            return CSRTopo(indptr=self.indptr.copy(), indices=self.indices.copy())
        new_indptr = self._new_indptr()
        return CSRTopo(indptr=new_indptr,
                       indices=self._rebuilt(self.indices, self._extra, self._override,
                                             np.int64, new_indptr))

    def to_temporal(self):
        """``(CSRTopo, edge_ts)`` of the updated graph, the timestamps in
        `to_csr_topo`'s edge order (expired lanes read ``+inf``)."""
        if self.edge_ts is None:
            raise ValueError("adjacency was built without edge_ts")
        topo = self.to_csr_topo()
        if not self._extra and not self._override:
            return topo, self.edge_ts.copy()
        extra_ts = {u: self._extra_ts.get(u, []) for u in self._extra}
        return topo, self._rebuilt(self.edge_ts, extra_ts, self._override_ts, np.float32,
                                   np.asarray(topo.indptr, np.int64))


def _bucket(n: int, floor: int = 64) -> int:
    """The power of two at or above ``n`` (at least ``floor``)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def _bucketed(idx: np.ndarray, rows: np.ndarray, sentinel: int,
              floor: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """A row-swap batch padded to a power-of-two bucket: positions
    ``sentinel`` (the table's row count, dropped by the scatter) and zero
    rows after the batch. The JAX package buckets so that its jitted
    scatter compiles once a bucket; here it keeps the commits' scatter
    shapes, and the padding the scatter drops, the same."""
    b = _bucket(idx.shape[0], floor=floor)
    pos = np.full(b, sentinel, np.int64)
    pos[: idx.shape[0]] = idx
    padded = np.zeros((b,) + rows.shape[1:], rows.dtype)
    padded[: idx.shape[0]] = rows
    return pos, padded


class GraphArrays(tuple):
    """One epoch's device ``(bd, tiles)`` or ``(bd, tiles, ttiles)`` of a
    `StreamingTiledGraph`. ``ready`` is the CUDA event recorded after the
    commit's scatters that wrote them (None on the CPU and for the first
    epoch): a reader on another stream waits on it."""

    def __new__(cls, arrays, ready=None):
        g = super().__new__(cls, arrays)
        g.ready = ready
        return g


class StreamingTiledGraph:
    """The delta layer over the 128-lane tile layout: host ``(bd, tiles)``
    (and ``ttiles``) mirrors with reserve rows, pad-lane appends, spills,
    removals and timestamp updates, and one bounded device row scatter a
    table a commit (B1).

    Parameters
    ----------
    csr_topo : the ingest-time `CSRTopo`; appended edges live in the stream.
    reserve_tiles : spare tile rows for spills (default ``ceil(reserve_frac
        * M)``, at least 8). A spill moves a node to ``rows + GROW_TILES``
        fresh rows; an exhausted reserve raises `StreamCapacityError`.
    id_dtype : the tiles' dtype (default: int32 when the ids fit).
    edge_ts : per-edge float32 timestamps aligned with ``csr_topo.indices``:
        a temporal stream, its timestamps in a second tile table on the
        same map.
    device : where the device tensors live (default CUDA; "cpu" runs every
        scatter's plain version).

    `apply` and `install_rows` mutate under one lock; the serve engine
    orders commits against its flushes itself."""

    def __init__(self, csr_topo, reserve_tiles: Optional[int] = None,
                 reserve_frac: float = 0.5, id_dtype=None, edge_ts=None, device=None):
        self.csr_topo = csr_topo
        self.device = resolve_device(device)
        self.adj = StreamingAdjacency(csr_topo, edge_ts=edge_ts, device=self.device)
        self.n = self.adj.n
        if id_dtype is None:
            id_dtype = _best_id_dtype(self.n + 1)
        # the tile table of the base graph, built where the device tensors
        # live (K12 on the card) and copied down as the host mirror
        bd = np.ascontiguousarray(csr_topo.tile_map()[0])
        flat = torch.from_numpy(self.adj.indices.astype(id_dtype)).to(self.device)
        tiles = csr_topo.tiles_on_device(flat)
        m = tiles.shape[0]
        if reserve_tiles is None:
            reserve_tiles = max(8, int(np.ceil(float(reserve_frac) * m)))
        self.m_base = m
        self.m_cap = m + int(reserve_tiles)
        self.bd = bd.copy()  # [N, 2] int32 (base, deg)
        self.tiles = np.zeros((self.m_cap, LANE), np.dtype(id_dtype))
        self.tiles[:m] = tiles.cpu().numpy()
        # timestamps in a second table on the same tile map: a committed
        # edge and its timestamp land in one commit
        self.ttiles: Optional[np.ndarray] = None
        ttiles = None
        if edge_ts is not None:
            ttiles = csr_topo.tiles_on_device(torch.from_numpy(self.adj.edge_ts).to(self.device))
            self.ttiles = np.zeros((self.m_cap, LANE), np.float32)
            self.ttiles[:m] = ttiles.cpu().numpy()
        deg = self.bd[:, 1].astype(np.int64)
        self.alloc_rows = (-(-deg // LANE)).astype(np.int32)  # rows each node holds
        # free rows as a sorted list of [start, count] ranges, taken first
        # fit from the lowest start; compaction and provisioning add to it
        self._free_ranges: List[List[int]] = [[m, self.m_cap - m]] if self.m_cap > m else []
        # rows a spill vacated, counted as used until a compaction frees them
        self._retired: List[Tuple[int, int]] = []
        self._retired_rows = 0
        # expired lanes of each node, ascending: appends reuse the lowest
        self._dead: Dict[int, List[int]] = {}
        self._dead_lanes = 0
        # each node's least finite timestamp (+inf when none): expiry scans
        # only the nodes that can expire
        self._min_ts: Optional[np.ndarray] = None
        if edge_ts is not None:
            self._min_ts = np.full(self.n, np.inf, np.float32)
            rows = np.nonzero(self.adj.indptr[1:] > self.adj.indptr[:-1])[0]
            if rows.size:  # one segment a non-empty row (a min is exact in any order)
                self._min_ts[rows] = np.minimum.reduceat(self.adj.edge_ts,
                                                         self.adj.indptr[rows])
        self.version = 0
        # the graph version at which each node's row last changed
        self.node_version = np.zeros(self.n, np.int64)
        self.stats = {"pad_writes": 0, "tile_spills": 0, "installs": 0,
                      "tile_rows_swapped": 0, "bd_rows_swapped": 0, "edges": 0,
                      "edges_deleted": 0, "edges_expired": 0, "ts_updates": 0,
                      "lanes_reused": 0, "tiles_reclaimed": 0, "compactions": 0,
                      "provisions": 0}
        self._lock = threading.Lock()
        # the live device arrays (what `graph()` serves) and, for a commit
        # with defer_publish=True, the staged ones `publish` flips live
        self._staged: Optional[GraphArrays] = None
        tiles_dev = torch.zeros((self.m_cap, LANE), dtype=tiles.dtype, device=self.device)
        tiles_dev[:m] = tiles
        arrays = [torch.from_numpy(self.bd).to(self.device, copy=True), tiles_dev]
        if ttiles is not None:
            tt_dev = torch.zeros((self.m_cap, LANE), dtype=torch.float32, device=self.device)
            tt_dev[:m] = ttiles
            arrays.append(tt_dev)
        self._live = GraphArrays(arrays, self._record_ready())

    # -------------------------------------------------- row allocator
    @staticmethod
    def _take(ranges: List[List[int]], k: int) -> Optional[int]:
        """First fit of ``k`` contiguous rows from the lowest-start free
        range; None when no range holds them."""
        for r in ranges:
            if r[1] >= k:
                start = r[0]
                r[0] += k
                r[1] -= k
                if r[1] == 0:
                    ranges.remove(r)
                return start
        return None

    @staticmethod
    def _put(ranges: List[List[int]], start: int, k: int) -> None:
        """Return ``k`` rows at ``start`` to a free list, sorted and
        coalesced."""
        if k <= 0:
            return
        i = 0
        while i < len(ranges) and ranges[i][0] < start:
            i += 1
        ranges.insert(i, [start, k])
        if i + 1 < len(ranges) and ranges[i][0] + ranges[i][1] == ranges[i + 1][0]:
            ranges[i][1] += ranges[i + 1][1]
            del ranges[i + 1]
        if i > 0 and ranges[i - 1][0] + ranges[i - 1][1] == ranges[i][0]:
            ranges[i - 1][1] += ranges[i][1]
            del ranges[i]

    def _release_locked(self, start: int, k: int) -> None:
        """Free ``k`` rows at ``start`` and zero their host mirror (the
        device rows keep stale bytes until reused; no draw reads them)."""
        if k <= 0:
            return
        self.tiles[start:start + k] = 0
        if self.ttiles is not None:
            self.ttiles[start:start + k] = 0
        self._put(self._free_ranges, start, k)

    # ------------------------------------------------------------ reads
    @property
    def free_rows(self) -> int:
        return sum(r[1] for r in self._free_ranges)

    def _reserve_report_locked(self) -> Dict[str, object]:
        free = self.free_rows
        used = max((self.m_cap - self.m_base) - free, 0)
        commits = self.version
        per_commit = used / commits if commits else 0.0
        deg = self.bd[:, 1].astype(np.int64)
        tight = -(-deg // LANE)
        alloc = self.alloc_rows.astype(np.int64)
        deg_sum = int(deg.sum())
        return {
            "tiles_base": self.m_base,
            "tiles_cap": self.m_cap,
            "reserve_tiles": self.m_cap - self.m_base,
            "reserve_used": used,
            "reserve_free": free,
            "commits": commits,
            "rows_per_commit": per_commit,
            "projected_commits_to_exhaustion": free / per_commit if per_commit > 0 else None,
            "tile_spills": self.stats["tile_spills"],
            "installs": self.stats["installs"],
            "fragmented_lanes": int(alloc.sum()) * LANE - deg_sum,
            "reclaimable_tiles": self._retired_rows + int(np.maximum(alloc - tight, 0).sum()),
            "dead_lane_frac": self._dead_lanes / deg_sum if deg_sum else 0.0,
        }

    def reserve_report(self) -> Dict[str, object]:
        """The reserve budget: rows used and free, rows a commit, the
        commits of runway left at that rate (None before any use), and the
        lifecycle's fragmented lanes, reclaimable rows and dead-lane share."""
        with self._lock:
            return self._reserve_report_locked()

    def _capacity_error(self, prefix: str) -> StreamCapacityError:
        r = self._reserve_report_locked()
        proj = r["projected_commits_to_exhaustion"]
        return StreamCapacityError(
            f"{prefix} — reserve {r['reserve_used']}/{r['reserve_tiles']} rows used over "
            f"{r['commits']} commit(s) ({r['rows_per_commit']:.2f} rows/commit"
            + (f", ~{proj:.0f} commits of runway were left" if proj is not None else "")
            + "); reclaim rows with compaction (plan_compaction/apply_compaction), grow the "
            "bank with provision_reserve (one capture of every serve bucket), or rebuild the "
            "stream with a larger reserve_frac/reserve_tiles")

    @property
    def temporal(self) -> bool:
        """True when the stream carries per-edge timestamps."""
        return self.ttiles is not None

    def graph(self) -> GraphArrays:
        """The current device ``(bd, tiles)``: new tensors at every commit,
        the same shapes until a provisioning."""
        return GraphArrays(self._live[:2], self._live.ready)

    def temporal_graph(self) -> GraphArrays:
        """The current device ``(bd, tiles, ttiles)`` of a temporal stream."""
        if not self.temporal:
            raise ValueError("stream was built without edge_ts (no timestamp payload)")
        return self._live

    def neighbors(self, node: int) -> np.ndarray:
        return self.adj.neighbors(node)

    def degree(self, node: int) -> int:
        return self.adj.degree(node)

    def to_csr_topo(self):
        return self.adj.to_csr_topo()

    def affected_seeds(self, srcs, hops: int) -> np.ndarray:
        """The invalidation set of changed rows ``srcs``: every node whose
        ``hops``-hop expansion reaches one (``len(sizes) - 1`` hops for a
        sampler of ``len(sizes)`` layers: the last frontier is gathered,
        never expanded)."""
        return self.adj.reverse_closure(srcs, hops)

    # ----------------------------------------------------------- writes
    def preflight(self, delta: Optional[GraphDelta] = None,
                  installs: Optional[Sequence[Tuple[int, np.ndarray]]] = None) -> int:
        """Check a whole batch (ids, installs, removals and updates against
        the adjacency, reserve capacity with spills simulated in apply
        order) without changing anything. Returns the reserve rows it would
        take; raises where `apply` would."""
        src, dst = delta.edges() if delta is not None else (np.array([], np.int64),
                                                             np.array([], np.int64))
        ts = delta.edges_ts() if delta is not None else None
        removals = delta.removals() if delta is not None else None
        updates = delta.updates() if delta is not None else None
        installs = self._normalize_installs(installs)
        with self._lock:
            return self._preflight_locked(src, dst, installs, ts, removals, updates)

    @staticmethod
    def _normalize_installs(installs):
        """Install entries as ``(node, nbrs, ts_row | None)``."""
        out = []
        for entry in installs or ():
            if len(entry) == 2:
                node, nbrs = entry
                ts_row = None
            else:
                node, nbrs, ts_row = entry
            nbrs = np.asarray(nbrs, np.int64)
            if ts_row is not None:
                ts_row = np.asarray(ts_row, np.float32).reshape(-1)
            out.append((int(node), nbrs, ts_row))
        return out

    def _check_ts(self, src, ts, installs) -> None:
        """A temporal stream takes one timestamp per appended or installed
        edge, a plain stream none; timestamps are finite."""
        if self.temporal:
            if src.size and (ts is None or ts.shape != src.shape):
                raise ValueError("temporal stream (edge_ts set) needs one timestamp per appended "
                                 "edge — stage with GraphDelta.add_edges(src, dst, ts=...)")
            for node, nbrs, ts_row in installs:
                if nbrs.size and (ts_row is None or ts_row.shape[0] != nbrs.shape[0]):
                    raise ValueError(f"temporal install for node {node} needs one timestamp "
                                     "per neighbor")
        elif ts is not None or any(t is not None for _, _, t in installs):
            raise ValueError("edge timestamps staged into a non-temporal stream — build "
                             "StreamingTiledGraph(edge_ts=...) to carry them")
        if ts is not None and ts.size and not np.isfinite(ts).all():
            raise ValueError("non-finite appended timestamps — +inf is reserved as the "
                             "retention expiry sentinel (expire_edges)")
        for node, _nbrs, ts_row in installs:
            if ts_row is not None and ts_row.size and not np.isfinite(ts_row).all():
                raise ValueError(f"non-finite install timestamps for node {node} — +inf is "
                                 "reserved as the retention expiry sentinel")

    def _preflight_locked(self, src, dst, installs, ts=None, removals=None,
                          updates=None) -> int:
        if src.size:
            validate_edge_ids(src, dst, self.n)
        self._check_ts(src, ts, installs)
        rsrc, rdst = removals if removals is not None else (np.empty(0, np.int64),
                                                            np.empty(0, np.int64))
        usrc, udst, _ = updates if updates is not None else (
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32))
        if rsrc.size:
            validate_edge_ids(rsrc, rdst, self.n, what="removal")
        if usrc.size:
            validate_edge_ids(usrc, udst, self.n, what="update")
            if not self.temporal:
                raise ValueError("timestamp updates staged into a non-temporal stream — "
                                 "streamed tiles carry no weight payload; the ts lane "
                                 "(edge_ts=...) is the one mutable per-edge field")
        # removals and updates must find their edges, counted in apply
        # order (installs, appends, removals, updates): all or none
        if rsrc.size or usrc.size:
            pairs = set(zip(rsrc.tolist(), rdst.tolist())) | set(zip(usrc.tolist(),
                                                                     udst.tolist()))
            inst_rows = {node: nbrs for node, nbrs, _ in installs}
            avail: Dict[Tuple[int, int], int] = {}
            rows_cache: Dict[int, np.ndarray] = {}
            for (u, v) in pairs:
                if u not in rows_cache:
                    rows_cache[u] = inst_rows[u] if u in inst_rows else self.adj.neighbors(u)
                avail[(u, v)] = int((rows_cache[u] == v).sum())
            for u, v in zip(src.tolist(), dst.tolist()):
                if (u, v) in avail:
                    avail[(u, v)] += 1
            for u, v in zip(rsrc.tolist(), rdst.tolist()):
                avail[(u, v)] -= 1
                if avail[(u, v)] < 0:
                    raise ValueError(f"removal of absent edge ({u}, {v}) — the whole batch is "
                                     "rejected (all-or-none), nothing was applied")
            for u, v in zip(usrc.tolist(), udst.tolist()):
                if avail[(u, v)] <= 0:
                    raise ValueError(f"timestamp update of absent edge ({u}, {v}) — the whole "
                                     "batch is rejected (all-or-none), nothing was applied")
        # reserve capacity: the allocator's own first-fit walk on a copy of
        # the free ranges, so a fragmented pool fails here, not mid-commit
        need = 0
        sim_ranges = [r[:] for r in self._free_ranges]
        sim_alloc: Dict[int, int] = {}
        sim_deg: Dict[int, int] = {}
        sim_dead: Dict[int, int] = {}
        for node, nbrs, _ts_row in installs:
            if not 0 <= node < self.n:
                raise ValueError(f"install node {node} outside [0, {self.n})")
            if nbrs.size and ((nbrs < 0) | (nbrs >= self.n)).any():
                raise ValueError(f"install neighbors of node {node} outside [0, {self.n}): "
                                 f"{nbrs[(nbrs < 0) | (nbrs >= self.n)][:4].tolist()}")
            if node in sim_deg:
                raise ValueError(f"duplicate install for node {node} in one batch")
            if int(self.bd[node, 1]) != 0:
                raise ValueError(f"install_rows targets degree-0 rows only (node {node} has "
                                 f"degree {int(self.bd[node, 1])}); use apply() appends for "
                                 "materialized rows")
            if nbrs.size == 0:
                sim_deg[node] = 0
                sim_alloc[node] = int(self.alloc_rows[node])
                continue
            old = int(self.alloc_rows[node])
            if old:
                self._put(sim_ranges, int(self.bd[node, 0]), old)
            rows = -(-int(nbrs.size) // LANE)
            need += rows
            if self._take(sim_ranges, rows) is None:
                raise self._capacity_error(
                    f"tile reserve exhausted: install of node {node} needs {rows} contiguous "
                    f"rows, {sum(r[1] for r in sim_ranges)} free")
            sim_alloc[node] = rows
            sim_deg[node] = int(nbrs.size)
            sim_dead[node] = 0
        for u in src:
            u = int(u)
            dead = sim_dead.get(u, len(self._dead.get(u, ())))
            if dead > 0:  # reuses an expired lane: no growth, no spill
                sim_dead[u] = dead - 1
                continue
            sim_dead[u] = 0
            d = sim_deg.get(u, int(self.bd[u, 1]))
            a = sim_alloc.get(u, int(self.alloc_rows[u]))
            if d >= a * LANE:
                a += GROW_TILES
                need += a
                if self._take(sim_ranges, a) is None:
                    raise self._capacity_error(
                        f"tile reserve exhausted: batch needs {need} rows ({a} contiguous for "
                        f"node {u}), {sum(r[1] for r in sim_ranges)} free")
                sim_alloc[u] = a
            sim_deg[u] = d + 1
        return need

    def apply(self, delta: GraphDelta,
              installs: Optional[Sequence[Tuple[int, np.ndarray]]] = None,
              defer_publish: bool = False) -> Dict[str, int]:
        """Commit one batch: host pad-lane writes, spills, installs,
        removals and updates, then one device row scatter a table. Atomic:
        the whole batch is preflighted first, so a raising apply leaves the
        stream untouched. With ``defer_publish`` the new device arrays are
        staged and `graph()` keeps serving the old ones until `publish`.
        Returns the commit's summary."""
        src, dst = delta.edges() if delta is not None else (np.array([], np.int64),
                                                             np.array([], np.int64))
        ts = delta.edges_ts() if delta is not None else None
        removals = delta.removals() if delta is not None else (np.empty(0, np.int64),
                                                               np.empty(0, np.int64))
        updates = delta.updates() if delta is not None else (
            np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32))
        rsrc, rdst = removals
        usrc, udst, uts = updates
        installs = self._normalize_installs(installs)
        if src.size == 0 and not installs and rsrc.size == 0 and usrc.size == 0:
            return {"edges": 0, "pad_writes": 0, "tile_spills": 0, "installs": 0,
                    "tile_rows_swapped": 0, "bd_rows_swapped": 0, "free_rows": self.free_rows,
                    "version": self.version, "edges_deleted": 0, "ts_updates": 0,
                    "lanes_reused": 0}
        with self._lock:
            self._preflight_locked(src, dst, installs, ts, removals, updates)
            touched_tiles: set = set()
            touched_bd: set = set()
            pad_writes = spills = reused = 0
            for node, nbrs, ts_row in installs:
                self._install_locked(node, nbrs, touched_tiles, touched_bd, ts_row=ts_row)
            # adjacency and tiles advance together, edge by edge (a reused
            # dead lane replaces its adjacency entry in place)
            for i, (u, v) in enumerate(zip(src, dst)):
                p, s, r = self._append_locked(int(u), int(v), touched_tiles, touched_bd,
                                              ts=None if ts is None else float(ts[i]))
                pad_writes += p
                spills += s
                reused += r
            if rsrc.size:
                for u, v in zip(rsrc, rdst):
                    self.adj.remove_one(int(u), int(v))
                for u in np.unique(rsrc):
                    self._rewrite_node_locked(int(u), touched_tiles, touched_bd)
            for u, v, t in zip(usrc, udst, uts):
                self._update_one_locked(int(u), int(v), float(t), touched_tiles, touched_bd)
            self.version += 1
            changed = np.fromiter(touched_bd, np.int64, len(touched_bd))
            self.node_version[changed] = self.version
            n_tiles, n_bd = self._sync_device_locked(touched_tiles, touched_bd,
                                                     defer=defer_publish)
            self.stats["pad_writes"] += pad_writes
            self.stats["tile_spills"] += spills
            self.stats["installs"] += len(installs)
            self.stats["edges"] += int(src.size)
            self.stats["edges_deleted"] += int(rsrc.size)
            self.stats["ts_updates"] += int(usrc.size)
            self.stats["lanes_reused"] += reused
            self.stats["tile_rows_swapped"] += n_tiles
            self.stats["bd_rows_swapped"] += n_bd
            return {"edges": int(src.size), "pad_writes": pad_writes, "tile_spills": spills,
                    "installs": len(installs), "tile_rows_swapped": n_tiles,
                    "bd_rows_swapped": n_bd, "free_rows": self.free_rows,
                    "version": self.version, "edges_deleted": int(rsrc.size),
                    "ts_updates": int(usrc.size), "lanes_reused": reused}

    def install_rows(self, rows: Sequence[Tuple[int, np.ndarray]]) -> Dict[str, int]:
        """Write whole adjacency rows for nodes of degree 0 (the fleet
        router's closure growth), as one commit like `apply`."""
        return self.apply(None, installs=rows)

    # -------------------------------------------------------- lifecycle
    def expire_edges(self, cutoff, defer_publish: bool = False) -> Dict[str, object]:
        """Expire every edge with ``ts <= cutoff`` (``cutoff`` snapped to
        float32): its timestamp lane becomes ``+inf``, no lane moves, so
        the expired stream equals the unexpired one queried through a
        ``cutoff < ts`` band. One scatter of the timestamp tiles; the
        version bumps and the touched nodes are stamped."""
        if not self.temporal:
            raise ValueError("expire_edges needs a temporal stream (edge_ts=...) — a plain "
                             "stream has no timestamps to retire")
        cutoff = np.float32(cutoff)
        with self._lock:
            cand = np.nonzero(self._min_ts <= cutoff)[0]
            if cand.size == 0:
                return {"edges_expired": 0, "nodes": 0, "version": self.version,
                        "tile_rows_swapped": 0, "sources": np.empty(0, np.int64)}
            touched_tiles: set = set()
            touched_bd: set = set()
            n_exp = 0
            for u in cand:
                u = int(u)
                pos = self.adj.expire_node(u, cutoff)
                if pos.size:
                    rows = int(self.bd[u, 0]) + pos // LANE
                    self.ttiles[rows, pos % LANE] = np.inf
                    touched_tiles.update(rows.tolist())
                    touched_bd.add(u)
                    n_exp += int(pos.size)
                self._reindex_node_ts_locked(u, self.adj.neighbors_ts(u))
            self.version += 1
            changed = np.fromiter(touched_bd, np.int64, len(touched_bd))
            self.node_version[changed] = self.version
            n_tiles, n_bd = self._sync_device_locked(touched_tiles, touched_bd,
                                                     defer=defer_publish)
            self.stats["edges_expired"] += n_exp
            self.stats["tile_rows_swapped"] += n_tiles
            self.stats["bd_rows_swapped"] += n_bd
            return {"edges_expired": n_exp, "nodes": len(touched_bd), "version": self.version,
                    "tile_rows_swapped": n_tiles, "sources": np.sort(changed)}

    def plan_compaction(self, max_moves: int = 0) -> Dict[str, object]:
        """A reclamation plan, read under the stream's lock only: retired
        ranges to free, over-allocated tails to trim, and up to
        ``max_moves`` relocations (highest base first). Each node entry
        carries its version stamp, and `apply_compaction` skips one that a
        commit changed meanwhile."""
        with self._lock:
            plan: Dict[str, object] = {"retired": [tuple(r) for r in self._retired],
                                       "planned_at": self.version}
            deg = self.bd[:, 1].astype(np.int64)
            slack = self.alloc_rows.astype(np.int64) - (-(-deg // LANE))
            plan["trims"] = [(int(u), int(self.node_version[u]))
                             for u in np.nonzero(slack > 0)[0]]
            moves: List[Tuple[int, int]] = []
            if max_moves:
                for u in np.argsort(self.bd[:, 0], kind="stable")[::-1]:
                    if len(moves) >= int(max_moves):
                        break
                    u = int(u)
                    if self.alloc_rows[u] and int(self.bd[u, 0]):
                        moves.append((u, int(self.node_version[u])))
            plan["moves"] = moves
            return plan

    def apply_compaction(self, plan: Dict[str, object],
                         defer_publish: bool = False) -> Dict[str, int]:
        """Apply a `plan_compaction` plan: free retired ranges, trim tails,
        move planned nodes down (whole rows through ``base``). Changes no
        draw: no version bump, no node stamps."""
        with self._lock:
            freed = trims = 0
            touched_tiles: set = set()
            touched_bd: set = set()
            for rng in plan.get("retired", ()):
                rng = (int(rng[0]), int(rng[1]))
                if rng in self._retired:
                    self._retired.remove(rng)
                    self._retired_rows -= rng[1]
                    self._release_locked(rng[0], rng[1])
                    freed += rng[1]
            for u, ver in plan.get("trims", ()):
                u = int(u)
                if int(self.node_version[u]) != int(ver):
                    continue  # a commit changed the row: the next plan retries
                tight = -(-int(self.bd[u, 1]) // LANE)
                alloc = int(self.alloc_rows[u])
                if alloc > tight:
                    self._release_locked(int(self.bd[u, 0]) + tight, alloc - tight)
                    self.alloc_rows[u] = tight
                    freed += alloc - tight
                    trims += 1
            moved = 0
            for u, ver in plan.get("moves", ()):
                u = int(u)
                if int(self.node_version[u]) != int(ver):
                    continue
                rows = int(self.alloc_rows[u])
                base = int(self.bd[u, 0])
                if rows == 0:
                    continue
                new = self._take(self._free_ranges, rows)
                if new is None or new >= base:
                    if new is not None:  # no downward fit: give the trial back
                        self._put(self._free_ranges, new, rows)
                    continue
                self.tiles[new:new + rows] = self.tiles[base:base + rows]
                if self.ttiles is not None:
                    self.ttiles[new:new + rows] = self.ttiles[base:base + rows]
                self.bd[u, 0] = new
                self._release_locked(base, rows)
                touched_tiles.update(range(new, new + rows))
                touched_bd.add(u)
                moved += 1
            n_tiles, n_bd = self._sync_device_locked(touched_tiles, touched_bd,
                                                     defer=defer_publish)
            self.stats["tiles_reclaimed"] += freed
            self.stats["compactions"] += 1
            self.stats["tile_rows_swapped"] += n_tiles
            self.stats["bd_rows_swapped"] += n_bd
            return {"tiles_reclaimed": freed, "trims": trims, "moves": moved,
                    "tile_rows_swapped": n_tiles, "free_rows": self.free_rows}

    def compact(self, max_moves: int = 0) -> Dict[str, int]:
        """`plan_compaction` then `apply_compaction`."""
        return self.apply_compaction(self.plan_compaction(max_moves))

    def provision_reserve(self, tiles: int) -> Dict[str, object]:
        """Grow the tile tables by a bank of ``tiles`` rows, the one shape
        change: the host mirrors grow, the bank joins the free rows, the
        device tables are uploaded anew (any staged arrays dropped). A
        serve engine's steps then take the new shapes once
        (`inference.BucketPrograms.reprovision`). The upload takes ``bd``
        from its host mirror, so a staged commit's rows go live with it.
        Returns the reserve report."""
        bank = int(tiles)
        if bank <= 0:
            raise ValueError(f"provision_reserve needs tiles > 0, got {tiles}")
        with self._lock:
            old_cap = self.m_cap
            self.m_cap = old_cap + bank
            new_tiles = np.zeros((self.m_cap, LANE), self.tiles.dtype)
            new_tiles[:old_cap] = self.tiles
            self.tiles = new_tiles
            if self.ttiles is not None:
                new_tt = np.zeros((self.m_cap, LANE), np.float32)
                new_tt[:old_cap] = self.ttiles
                self.ttiles = new_tt
            self._put(self._free_ranges, old_cap, bank)
            self.stats["provisions"] += 1
            self._staged = None
            arrays = [torch.from_numpy(self.bd).to(self.device, copy=True),
                      torch.from_numpy(self.tiles).to(self.device)]
            if self.ttiles is not None:
                arrays.append(torch.from_numpy(self.ttiles).to(self.device))
            self._live = GraphArrays(arrays, self._record_ready())
            return self._reserve_report_locked()

    # ------------------------------------------------------- internals
    def _append_locked(self, u: int, v: int, touched_tiles, touched_bd,
                       ts: Optional[float] = None):
        """One append, adjacency and tiles together; returns ``(pad_writes,
        spills, lanes_reused)``. A node with expired lanes reuses the
        lowest first (no degree growth, no reserve taken)."""
        dead = self._dead.get(u)
        if dead:
            p = dead.pop(0)
            if not dead:
                del self._dead[u]
            self._dead_lanes -= 1
            row = int(self.bd[u, 0]) + p // LANE
            self.tiles[row, p % LANE] = v
            self.ttiles[row, p % LANE] = ts  # only expiry makes dead lanes
            self.adj.replace_at(u, p, v, ts=ts)
            self._min_ts[u] = min(float(self._min_ts[u]), float(ts))
            touched_tiles.add(row)
            touched_bd.add(u)
            return 0, 0, 1
        self.adj._append_one(u, v, ts=ts)
        base = int(self.bd[u, 0])
        deg = int(self.bd[u, 1])
        spilled = 0
        if deg >= int(self.alloc_rows[u]) * LANE:
            base = self._relocate_locked(u, touched_tiles)
            spilled = 1
        row = base + deg // LANE
        self.tiles[row, deg % LANE] = v
        if self.ttiles is not None:
            self.ttiles[row, deg % LANE] = ts
            self._min_ts[u] = min(float(self._min_ts[u]), float(ts))
        self.bd[u, 1] = deg + 1
        touched_tiles.add(row)
        touched_bd.add(u)
        return 1 - spilled, spilled, 0

    def _relocate_locked(self, u: int, touched_tiles) -> int:
        """Move ``u`` to ``rows + GROW_TILES`` free rows (its tiles copied,
        ``base`` moved); its old rows park in ``_retired`` until a
        compaction."""
        old_base = int(self.bd[u, 0])
        old_rows = int(self.alloc_rows[u])
        need = old_rows + GROW_TILES
        new_base = self._take(self._free_ranges, need)
        if new_base is None:
            raise self._capacity_error(f"tile reserve exhausted: node {u} needs {need} "
                                       f"contiguous rows, {self.free_rows} free")
        if old_rows:
            self.tiles[new_base:new_base + old_rows] = self.tiles[old_base:old_base + old_rows]
            if self.ttiles is not None:
                self.ttiles[new_base:new_base + old_rows] = (
                    self.ttiles[old_base:old_base + old_rows])
            self._retired.append((old_base, old_rows))
            self._retired_rows += old_rows
        touched_tiles.update(range(new_base, new_base + old_rows + 1))
        self.bd[u, 0] = new_base
        self.alloc_rows[u] = need
        return new_base

    def _rewrite_node_locked(self, u: int, touched_tiles, touched_bd) -> None:
        """Write ``u``'s lanes again from its adjacency (a deletion's shift:
        survivors packed left, trailing lanes zero), then its dead lanes
        and least timestamp."""
        base = int(self.bd[u, 0])
        rows = int(self.alloc_rows[u])
        nbrs = self.adj.neighbors(u)
        d = int(nbrs.size)
        tvals = None
        if rows:
            flat = self.tiles[base:base + rows].reshape(-1)
            flat[:d] = nbrs.astype(self.tiles.dtype)
            flat[d:] = 0
            if self.ttiles is not None:
                tvals = self.adj.neighbors_ts(u)
                tflat = self.ttiles[base:base + rows].reshape(-1)
                tflat[:d] = tvals
                tflat[d:] = 0
            touched_tiles.update(range(base, base + rows))
        self.bd[u, 1] = d
        touched_bd.add(u)
        if self.ttiles is not None:
            self._reindex_node_ts_locked(u, np.empty(0, np.float32) if tvals is None else tvals)

    def _reindex_node_ts_locked(self, u: int, tvals: np.ndarray) -> None:
        """``u``'s dead lanes and least finite timestamp from its
        timestamp row."""
        old = self._dead.pop(u, None)
        if old:
            self._dead_lanes -= len(old)
        deadpos = np.nonzero(np.isinf(tvals))[0]
        if deadpos.size:
            self._dead[u] = deadpos.tolist()
            self._dead_lanes += int(deadpos.size)
        finite = tvals[np.isfinite(tvals)]
        self._min_ts[u] = finite.min() if finite.size else np.inf

    def _update_one_locked(self, u: int, v: int, t: float, touched_tiles, touched_bd) -> None:
        """Rewrite one edge's timestamp lane (a dead lane given a finite
        timestamp lives again)."""
        p = self.adj.update_one(u, v, t)
        row = int(self.bd[u, 0]) + p // LANE
        self.ttiles[row, p % LANE] = t
        touched_tiles.add(row)
        touched_bd.add(u)
        self._reindex_node_ts_locked(u, self.adj.neighbors_ts(u))

    def _install_locked(self, node: int, nbrs: np.ndarray, touched_tiles, touched_bd,
                        ts_row: Optional[np.ndarray] = None) -> None:
        if not 0 <= node < self.n:
            raise ValueError(f"install node {node} outside [0, {self.n})")
        if int(self.bd[node, 1]) != 0:
            raise ValueError(f"install_rows targets degree-0 rows only (node {node} has degree "
                             f"{int(self.bd[node, 1])}); use apply() appends for materialized "
                             "rows")
        if nbrs.size == 0:
            return
        old_rows = int(self.alloc_rows[node])
        if old_rows:  # a row deleted to degree 0 gives its rows back first
            self._release_locked(int(self.bd[node, 0]), old_rows)
            self.alloc_rows[node] = 0
        need = -(-int(nbrs.size) // LANE)
        base = self._take(self._free_ranges, need)
        if base is None:
            raise self._capacity_error(f"tile reserve exhausted installing node {node} "
                                       f"({need} contiguous rows needed, {self.free_rows} free)")
        flat = self.tiles[base:base + need].reshape(-1)
        flat[: nbrs.size] = nbrs.astype(self.tiles.dtype)
        flat[nbrs.size:] = 0
        if self.ttiles is not None:
            tflat = self.ttiles[base:base + need].reshape(-1)
            tflat[: nbrs.size] = ts_row
            tflat[nbrs.size:] = 0
        self.bd[node, 0] = base
        self.bd[node, 1] = nbrs.size
        self.alloc_rows[node] = need
        touched_tiles.update(range(base, base + need))
        touched_bd.add(node)
        # the installed row enters the adjacency as extras over its empty
        # base row, or replaces an override list wholesale
        if node in self.adj._override:
            self.adj._override[node] = nbrs.astype(np.int64)
            if self.ttiles is not None:
                self.adj._override_ts[node] = ts_row.astype(np.float32)
        else:
            self.adj._extra[node] = [int(x) for x in nbrs]
            if self.ttiles is not None:
                self.adj._extra_ts[node] = [float(x) for x in ts_row]
        for v in nbrs:
            self.adj._rev_extra.setdefault(int(v), []).append(node)
        if self._min_ts is not None:
            finite = ts_row[np.isfinite(ts_row)]
            self._min_ts[node] = finite.min() if finite.size else np.inf

    def _record_ready(self):
        """A CUDA event after the work queued so far on the current stream
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _scatter(self, table: torch.Tensor, idx: np.ndarray, mirror: np.ndarray,
                 sentinel: int) -> torch.Tensor:
        """B1: a new device table equal to ``table`` with the host
        mirror's rows ``idx`` written in (`tiers.set_rows`)."""
        pos, rows = _bucketed(idx, mirror[idx], sentinel)
        dev = self.device
        pin = dev.type == "cuda"
        pos_t = torch.from_numpy(pos)
        rows_t = torch.from_numpy(rows)
        if pin:
            pos_t, rows_t = pos_t.pin_memory(), rows_t.pin_memory()
        return set_rows(table, pos_t.to(dev, non_blocking=pin), rows_t.to(dev, non_blocking=pin))

    def _sync_device_locked(self, touched_tiles, touched_bd, defer: bool = False):
        n_tiles, n_bd = len(touched_tiles), len(touched_bd)
        if not n_tiles and not n_bd:
            return n_tiles, n_bd
        if not defer and self._staged is not None:
            self._publish_locked()  # an unpublished staged commit goes live first
        # a deferred commit builds on the staged arrays when there are any,
        # so a commit's apply and its expiry accumulate into one flip
        base = self._staged if defer and self._staged is not None else self._live
        arrays = list(base)
        if n_tiles:
            idx = np.fromiter(touched_tiles, np.int64, n_tiles)
            idx.sort()
            arrays[1] = self._scatter(arrays[1], idx, self.tiles, self.m_cap)
            if self.ttiles is not None:
                # the timestamps of the same rows, in the same commit
                arrays[2] = self._scatter(arrays[2], idx, self.ttiles, self.m_cap)
        if n_bd:
            idx = np.fromiter(touched_bd, np.int64, n_bd)
            idx.sort()
            arrays[0] = self._scatter(arrays[0], idx, self.bd, self.n)
        new = GraphArrays(arrays, self._record_ready())
        if defer:
            self._staged = new
        else:
            self._live = new
        return n_tiles, n_bd

    def _publish_locked(self) -> bool:
        if self._staged is None:
            return False
        self._live, self._staged = self._staged, None
        return True

    def publish(self) -> bool:
        """Make the staged (``defer_publish``) device arrays live: one
        reference swap under the stream's lock. Flushes sealed before it
        keep the old tensors, which no commit writes. Returns True when
        something was staged."""
        with self._lock:
            return self._publish_locked()

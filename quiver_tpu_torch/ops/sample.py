"""One-hop uniform, weighted and temporal neighbor sampling and the
sampling-probability estimate — the port of ``quiver_tpu/ops/sample.py``
(``pad_widths``, ``row_windows``, ``fisher_yates_positions``,
``sample_layer``, ``tiled_sample_layer``, ``gumbel_topk_positions``,
``weighted_sample_layer``, ``tiled_weighted_sample_layer``,
``temporal_edge_weights``, ``temporal_weight_rows``,
``tiled_temporal_sample_layer``, the host tile build and its device
twin ``build_tiled_device`` with ``tiled_rowmap_host``, ``neighbor_prob``
and ``sample_prob``).

Each row draws ``min(deg, k)`` distinct neighbor positions by a partial
Fisher-Yates shuffle over k threefry uniforms of shape ``[k, W]``; rows
with ``deg <= k`` copy all neighbors. The draw is bit-equal to the JAX
package on the same key. ``sample_layer`` reads the flat CSR,
``tiled_sample_layer`` the 128-lane tile layout; both give the same draw.

On a CUDA tensor the wrappers launch the hand-written kernel of
``csrc/sample.cu``; on a CPU tensor they run the plain torch version in
this module, which the tests hold against the JAX package.

A weighted draw (K7) takes the top k of ``log w + Gumbel`` over each
row's window of its first ``min(deg, max_deg)`` edge weights (the flat
CSR's or the tile map's); a temporal draw (K8) is the same draw over the
timestamp tiles with weight ``exp(recency * ts)`` where ``ts <= t[row]``
and 0 elsewhere, and K8w builds those weights for whole tile tables. The
kernels (``csrc/weighted.cu``) and the plain versions take every ``log``
and ``exp`` in float64 and round once to float32, so they agree bit for
bit; the JAX package's float32 ``log`` and ``exp`` are XLA's own
approximations, within an ULP, so a row whose two best candidates score
within an ULP or two may order them differently there.

`neighbor_prob` propagates per-node sampling probabilities one hop
(``next[v] = sum over edges u -> v of prob[u] * min(k / deg(u), 1)``) and
`sample_prob` adds one hop per fanout to the seeds' ones: the heat that
`utils.heat_reorder` and `partition` place rows by. On the card it is the
pull kernel of ``csrc/prob.cu`` (K11) over the transposed CSR
(`build_transposed_host`, cached per graph by
`utils.CSRTopo.to_device_transposed`); on the CPU `neighbor_prob_plain`
adds each node's sources in edge order, bit-equal to the JAX package's
edge-ordered scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .. import random as qrandom

LANE = 128  # tile row width of the tiled layout


def pad_widths(batch: int, sizes, caps=None):
    """Static padded n_id widths per hop: ``W_{l+1} = min(cap_l, W_l*(1+k_l))``."""
    widths = [int(batch)]
    for l, k in enumerate(sizes):
        w = widths[-1] * (1 + int(k))
        if caps is not None and caps[l] is not None:
            w = min(w, int(caps[l]))
        widths.append(w)
    return widths


def fisher_yates_positions(key, deg: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos [B, k] int32, valid [B, k] bool)``: for each row, ``min(deg,
    k)`` distinct positions in ``[0, deg)``; ``0..deg-1`` in order where
    ``deg <= k``. Plain torch, step for step the JAX formulation."""
    deg = deg.to(torch.int32)
    B = deg.shape[0]
    dev = deg.device
    if k == 0:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B, 0), dtype=torch.bool, device=dev))
    ar_k = torch.arange(k, dtype=torch.int32, device=dev)
    us = qrandom.uniform(key, (k, B), device=dev)
    head = ar_k.expand(B, k).clone()
    tail_j = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    tail_v = torch.zeros((B, k), dtype=torch.int32, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    lim = torch.clamp(deg - 1, min=0)
    outs = []
    for i in range(k):
        span = torch.clamp(deg - i, min=1)
        j = i + (us[i] * span.to(torch.float32)).to(torch.int32)
        j = torch.minimum(j, lim)
        in_head = j < k
        onehot = ar_k[None, :] == j[:, None]
        head_val = torch.where(onehot, head, 0).sum(dim=1).to(torch.int32)
        match = tail_j == j[:, None]
        has_match = match.any(dim=1)
        first = match.to(torch.int32).argmax(dim=1).to(torch.int32)
        tail_val = torch.where(
            has_match, torch.where(match, tail_v, 0).sum(dim=1).to(torch.int32), j
        )
        val_j = torch.where(in_head, head_val, tail_val)
        val_i = head[:, i].clone()
        head = torch.where(onehot & in_head[:, None], val_i[:, None], head)
        head[:, i] = val_j
        slot = torch.where(has_match, first, cnt)
        write_tail = ~in_head
        onehot_s = (ar_k[None, :] == slot[:, None]) & write_tail[:, None]
        tail_j = torch.where(onehot_s, j[:, None], tail_j)
        tail_v = torch.where(onehot_s, val_i[:, None], tail_v)
        cnt = cnt + (write_tail & ~has_match).to(torch.int32)
        outs.append(val_j)
    pos = torch.stack(outs, dim=1)
    pos = torch.where(deg[:, None] <= k, ar_k[None, :], pos)
    valid = ar_k[None, :] < torch.clamp(deg, max=k)[:, None]
    return pos, valid


def _check_layer_args(seeds, seed_valid, k, graph):
    if seeds.dim() != 1 or seed_valid.shape != seeds.shape:
        raise ValueError("seeds and seed_valid must be [W] of one shape")
    if seed_valid.dtype != torch.bool:
        raise TypeError("seed_valid must be bool")
    if int(k) < 0:
        raise ValueError("fanout k must be >= 0")
    for t in graph:
        if t.device != seeds.device:
            raise ValueError(
                f"graph tensor on {t.device} but seeds on {seeds.device}"
            )


def row_windows(indptr: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row start, degree int32)`` of clipped node ids ``s``."""
    s = s.to(torch.int64)
    ptr = indptr[s]
    return ptr, (indptr[s + 1] - ptr).to(torch.int32)


def _tiled_bd_lookup(bd, seeds, seed_valid):
    s = torch.clamp(seeds, 0, bd.shape[0] - 1).to(torch.int64)
    both = bd[s]
    return both[:, 0], torch.where(seed_valid, both[:, 1], 0)


def _tiled_resolve(tiles, base, pos):
    rows = torch.clamp(base.to(torch.int64)[:, None] + (pos >> 7), 0, tiles.shape[0] - 1)
    return tiles[rows, (pos & (LANE - 1)).to(torch.int64)]


def sample_layer_plain(indptr, indices, seeds, seed_valid, k, key):
    """Plain torch one-hop draw over the flat CSR."""
    ptr, deg = row_windows(indptr, torch.clamp(seeds, 0, indptr.shape[0] - 2))
    deg = torch.where(seed_valid, deg, 0)
    pos, valid = fisher_yates_positions(key, deg, k)
    flat = torch.clamp(ptr[:, None].to(torch.int64) + pos, 0, indices.shape[0] - 1)
    return indices[flat], valid


def tiled_sample_layer_plain(bd, tiles, seeds, seed_valid, k, key):
    """Plain torch one-hop draw over the tile layout."""
    base, deg = _tiled_bd_lookup(bd, seeds, seed_valid)
    pos, valid = fisher_yates_positions(key, deg, k)
    return _tiled_resolve(tiles, base, pos), valid


def _key_args(key, seeds):
    """The key arguments of a draw launch and its variant: a host key's two
    words by value, or one pointer to ``uint32[2]`` key words on the card
    (the device-key form, `_kernels.DEVICE_KEY`)."""
    if not isinstance(key, torch.Tensor):
        return (int(key[0]), int(key[1])), None
    if key.device != seeds.device:
        raise ValueError(f"key words on {key.device} but seeds on {seeds.device}")
    if key.dtype not in (torch.uint32, torch.int32) or key.numel() != 2 or not key.is_contiguous():
        raise TypeError(f"key words must be 2 contiguous uint32; got {key.dtype} "
                        f"{tuple(key.shape)}")
    return (key.data_ptr(),), "device_key"


def _graph_word_args(graph_words, key_args, seeds, n_tables: int):
    """The device-graph form's first argument, the table addresses'
    ``uint64[n_tables]`` words on the card, and its variants; the key must
    be the device-key form's words."""
    if graph_words.device != seeds.device:
        raise ValueError(f"graph words on {graph_words.device} but seeds on {seeds.device}")
    if (graph_words.dtype not in (torch.int64, torch.uint64)
            or graph_words.numel() != n_tables or not graph_words.is_contiguous()):
        raise TypeError(f"graph words must be {n_tables} contiguous 64-bit words; got "
                        f"{graph_words.dtype} {tuple(graph_words.shape)}")
    if len(key_args) != 1:
        raise TypeError("the device-graph form takes its key words from the card too")
    return graph_words.data_ptr(), ("device_key", "device_graph")


def _launch_sample(kind, a, b, seeds, seed_valid, k, key, graph_words=None):
    """Launch the sampling kernel: ``kind`` is "tiled" (``a=bd``,
    ``b=tiles``) or "flat" (``a=indptr``, ``b=indices``). With
    ``graph_words`` (tiled only) the kernel reads the two tables'
    addresses from them and ``a``, ``b`` give only the shapes."""
    for t, name in ((a, "graph"), (b, "graph"), (seeds, "seeds")):
        if t.dtype != torch.int32:
            raise TypeError(f"the sampling kernel takes int32 {name}; got {t.dtype}")
    if int(k) > _kernels.SAMPLE_KMAX:
        raise ValueError(f"the sampling kernel takes k <= {_kernels.SAMPLE_KMAX}; got {k}")
    a, b = a.contiguous(), b.contiguous()
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    W = seeds.shape[0]
    nbrs = torch.empty((W, k), dtype=torch.int32, device=seeds.device)
    valid = torch.empty((W, k), dtype=torch.bool, device=seeds.device)
    key_args, variant = _key_args(key, seeds)
    if W == 0 or k == 0:
        return nbrs, valid
    if kind == "tiled":
        n_nodes, extent = a.shape[0], b.shape[0]
    else:
        n_nodes, extent = a.shape[0] - 1, b.shape[0]
    if graph_words is not None:
        words, variant = _graph_word_args(graph_words, key_args, seeds, 2)
        _kernels.launch("sample_tiled", words, extent, n_nodes, seeds.data_ptr(),
                        seed_valid.data_ptr(), W, int(k), *key_args, nbrs.data_ptr(),
                        valid.data_ptr(), _kernels.stream_of(seeds), variant=variant)
        return nbrs, valid
    _kernels.launch(
        "sample_" + kind, a.data_ptr(), b.data_ptr(), extent, n_nodes,
        seeds.data_ptr(), seed_valid.data_ptr(), W, int(k),
        *key_args, nbrs.data_ptr(), valid.data_ptr(),
        _kernels.stream_of(seeds), variant=variant,
    )
    return nbrs, valid


def sample_layer(indptr, indices, seeds, seed_valid, k: int, key):
    """One-hop sample over the flat CSR: ``(nbrs [W, k], valid [W, k])``.
    ``key`` is a host key (`quiver_tpu_torch.random.key`) or its two words
    as a ``uint32[2]`` tensor on the seeds' device (on the card the kernel
    then reads them from device memory). Kernel on CUDA tensors, plain
    torch on CPU tensors."""
    _check_layer_args(seeds, seed_valid, k, (indptr, indices))
    if seeds.is_cuda:
        return _launch_sample("flat", indptr, indices, seeds, seed_valid, k, key)
    return sample_layer_plain(indptr, indices, seeds, seed_valid, k, qrandom.host_key(key))


def tiled_sample_layer(bd, tiles, seeds, seed_valid, k: int, key, graph_words=None):
    """One-hop sample over the tile layout, draw-identical to
    `sample_layer` on the same key. ``graph_words`` (the card, with device
    key words): the addresses of ``bd`` and ``tiles``, or of same-shaped
    tables, as two 64-bit words on the card, which the kernel reads in
    place of the tables passed (K1's device-graph form, which a captured
    serve step replays against each flush's graph epoch)."""
    _check_layer_args(seeds, seed_valid, k, (bd, tiles))
    if seeds.is_cuda:
        return _launch_sample("tiled", bd, tiles, seeds, seed_valid, k, key, graph_words)
    return tiled_sample_layer_plain(bd, tiles, seeds, seed_valid, k, qrandom.host_key(key))


# -- weighted and temporal draws (K7, K8, K8w) ---------------------------------

# the largest per-row window of the Gumbel kernels (one warp a row, the
# window's keys in shared memory)
MAX_WINDOW = 4096
GUMBEL_MINVAL = 1e-20  # the Gumbel uniform's floor (log(-log(u)) stays finite)


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log``, evaluated in float64 and rounded once (the rule the
    kernels keep: kernel and plain version agree bit for bit)."""
    return torch.log(x.double()).float()


def gumbel_scores(key, deg: torch.Tensor, weight_rows: torch.Tensor) -> torch.Tensor:
    """``[B, W]`` float32 scores of a Gumbel draw: ``log(max(w, 1e-30)) +
    -log(-log(u))`` where lane ``j < deg[b]`` and ``w > 0``, else
    ``-inf``. The uniform at lane ``j`` of row ``b`` is the threefry value
    at flat counter ``b * W + j`` with ``minval=1e-20``; each ``log`` is
    taken in float64 and rounded once. Plain torch on any device."""
    B, W = weight_rows.shape
    dev = weight_rows.device
    u = qrandom.uniform(key, (B, W), device=dev, minval=GUMBEL_MINVAL)
    g = -_log32(-_log32(u))
    w = torch.clamp(weight_rows.to(torch.float32), min=0.0)  # NaN stays NaN: w > 0 fails
    live = (torch.arange(W, device=dev)[None, :] < deg.to(dev)[:, None]) & (w > 0)
    lw = _log32(torch.clamp(w, min=1e-30))
    return torch.where(live, lw + g, torch.tensor(-float("inf"), device=dev))


def topk_lane_order(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, lanes)`` of the ``k`` largest scores per row, ties (and
    ``-inf`` lanes) to the lower lane, as ``lax.top_k`` orders them: a
    stable descending sort (``torch.topk`` leaves the order of ties
    undefined)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def gumbel_topk_positions(key, deg: torch.Tensor, k: int,
                          weight_rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted k-subset without replacement per row: the top k of
    `gumbel_scores` over a ``[B, W]`` window (``(pos [B, k] int32, valid
    [B, k] bool)``); ``valid`` is ``j < min(deg, k)`` and a finite selected
    score, so zero-weight lanes are never valid draws. Plain torch on any
    device: the plain versions of K7 and K8 use it; the kernels fuse it."""
    B, _ = weight_rows.shape
    dev = weight_rows.device
    if k == 0:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B, 0), dtype=torch.bool, device=dev))
    vals, pos = topk_lane_order(gumbel_scores(key, deg, weight_rows), k)
    n_valid = torch.clamp(deg.to(dev), max=k)
    valid = (torch.arange(k, device=dev)[None, :] < n_valid[:, None]) & (vals > -float("inf"))
    return pos.to(torch.int32), valid


def _tiled_payload_window(base: torch.Tensor, ptiles: torch.Tensor, max_deg: int) -> torch.Tensor:
    """Each row's first ``ceil(max_deg/128)`` payload tiles as one ``[B,
    T*128]`` window (weights and timestamps both ride it)."""
    T = -(-int(max_deg) // LANE)
    rows = base.to(torch.int64)[:, None] + torch.arange(T, device=base.device)[None, :]
    rows = torch.clamp(rows, 0, ptiles.shape[0] - 1)
    return ptiles[rows].reshape(base.shape[0], T * LANE)


def weighted_sample_layer_plain(indptr, indices, weights, seeds, seed_valid, k, key,
                                max_deg: int = 512):
    """Plain torch weighted draw over the flat CSR: a ``[W, max_deg]``
    weight window from each row's start."""
    n = indptr.shape[0] - 1
    s = torch.clamp(seeds, 0, n - 1)
    ptr, deg = row_windows(indptr, s)
    deg = torch.where(seed_valid, torch.clamp(deg, max=int(max_deg)), 0)
    e_last = indices.shape[0] - 1
    lanes = ptr.to(torch.int64)[:, None] + torch.arange(int(max_deg), device=ptr.device)[None, :]
    w_rows = weights[torch.clamp(lanes, 0, e_last)]
    pos, valid = gumbel_topk_positions(key, deg, k, w_rows)
    flat = torch.clamp(ptr.to(torch.int64)[:, None] + pos, 0, e_last)
    return indices[flat], valid


def tiled_weighted_sample_layer_plain(bd, tiles, wtiles, seeds, seed_valid, k, key,
                                      max_deg: int = 512):
    """Plain torch weighted draw over the tile layout: the window is the
    row's first ``ceil(max_deg/128)`` weight tiles."""
    base, deg = _tiled_bd_lookup(bd, seeds, seed_valid)
    deg = torch.clamp(deg, max=int(max_deg))
    w_rows = _tiled_payload_window(base, wtiles, max_deg)
    pos, valid = gumbel_topk_positions(key, deg, k, w_rows)
    return _tiled_resolve(tiles, base, pos), valid


def temporal_edge_weights_plain(ts: torch.Tensor, recency: float) -> torch.Tensor:
    """Plain torch `temporal_edge_weights`: ``exp(f32(recency) * ts)`` with
    the product rounded to float32 and the ``exp`` taken in float64 and
    rounded once; exactly 1.0 at ``recency == 0``."""
    if recency == 0.0:
        return torch.ones(ts.shape, dtype=torch.float32, device=ts.device)
    x = ts.to(torch.float32) * torch.tensor(float(recency), dtype=torch.float32, device=ts.device)
    return torch.exp(x.double()).float()


def temporal_weight_rows(ts_rows: torch.Tensor, t: torch.Tensor, recency: float,
                         cutoff=None) -> torch.Tensor:
    """The masked weight window of a temporal draw: the recency weight
    where ``ts <= t[row]`` (and ``ts > cutoff`` when a cutoff is given),
    else 0 — the zero weight `gumbel_topk_positions` excludes. Plain
    torch; the host-masked oracle and the plain temporal layer share it."""
    ts = ts_rows.to(torch.float32)
    keep = ts <= t.to(ts.device, torch.float32)[:, None]
    if cutoff is not None:
        keep = keep & (ts > torch.tensor(float(cutoff), dtype=torch.float32, device=ts.device))
    w = temporal_edge_weights_plain(ts, recency)
    return torch.where(keep, w, torch.zeros((), dtype=torch.float32, device=ts.device))


def tiled_temporal_sample_layer_plain(bd, tiles, ttiles, seeds, seed_valid, k, key, t,
                                      max_deg: int = 512, recency: float = 0.0, cutoff=None):
    """Plain torch temporal draw over the tile layout: the timestamp
    window, masked and weighted by `temporal_weight_rows`, through the
    Gumbel top-k."""
    base, deg = _tiled_bd_lookup(bd, seeds, seed_valid)
    deg = torch.clamp(deg, max=int(max_deg))
    ts_rows = _tiled_payload_window(base, ttiles, max_deg)
    w_rows = temporal_weight_rows(ts_rows, t, recency, cutoff)
    pos, valid = gumbel_topk_positions(key, deg, k, w_rows)
    return _tiled_resolve(tiles, base, pos), valid


def gumbel_window(max_deg: int, layout: str) -> int:
    """The Gumbel window of a draw: ``max_deg`` lanes over the flat CSR,
    ``ceil(max_deg/128)*128`` over the tile layout (so flat and tiled draws
    are equal only when ``max_deg % 128 == 0``)."""
    return int(max_deg) if layout == "flat" else -(-int(max_deg) // LANE) * LANE


def _check_gumbel_args(k, max_deg, wwin, floats):
    if not 1 <= int(max_deg) <= MAX_WINDOW:
        raise ValueError(f"the Gumbel kernels take 1 <= max_deg <= {MAX_WINDOW}; got {max_deg}")
    if int(k) > wwin:
        raise ValueError(f"fanout k={k} exceeds the {wwin}-lane window (max_deg={max_deg})")
    for t, name in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"the Gumbel kernels take float32 {name}; got {t.dtype}")


def _gumbel_outputs(seeds, k):
    W = seeds.shape[0]
    return (torch.empty((W, k), dtype=torch.int32, device=seeds.device),
            torch.empty((W, k), dtype=torch.bool, device=seeds.device))


def _same_tile_map(tiles, ptiles):
    if ptiles.shape != tiles.shape:
        raise ValueError(f"payload tiles {tuple(ptiles.shape)} must share the tile map of "
                         f"{tuple(tiles.shape)}")


def _int32_args(*named):
    for t, name in named:
        if t.dtype != torch.int32:
            raise TypeError(f"the Gumbel kernels take int32 {name}; got {t.dtype}")


def weighted_sample_layer(indptr, indices, weights, seeds, seed_valid, k: int, key,
                          max_deg: int = 512):
    """One-hop weighted sample over the flat CSR (K7, flat window): each
    row draws ``min(deg, k)`` of its first ``min(deg, max_deg)`` edges
    without replacement, with probability proportional to ``weights``
    (``[E]`` float32, aligned with ``indices``); zero weights are never
    drawn. ``(nbrs [W, k], valid [W, k])``. Kernel ``weighted_sample_flat``
    on CUDA tensors, `weighted_sample_layer_plain` on CPU tensors."""
    _check_layer_args(seeds, seed_valid, k, (indptr, indices, weights))
    if not seeds.is_cuda:
        return weighted_sample_layer_plain(indptr, indices, weights, seeds, seed_valid, k,
                                           qrandom.host_key(key), max_deg)
    _check_gumbel_args(k, max_deg, int(max_deg), ((weights, "weights"),))
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must align with indices "
                         f"{tuple(indices.shape)}")
    _int32_args((indptr, "indptr"), (indices, "indices"), (seeds, "seeds"))
    indptr, indices, weights = indptr.contiguous(), indices.contiguous(), weights.contiguous()
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    nbrs, valid = _gumbel_outputs(seeds, k)
    key_args, variant = _key_args(key, seeds)
    if seeds.shape[0] == 0 or k == 0:
        return nbrs, valid
    _kernels.launch("weighted_sample_flat", indptr.data_ptr(), indices.data_ptr(),
                    weights.data_ptr(), indices.shape[0], indptr.shape[0] - 1,
                    seeds.data_ptr(), seed_valid.data_ptr(), seeds.shape[0], int(k),
                    int(max_deg), *key_args, nbrs.data_ptr(), valid.data_ptr(),
                    _kernels.stream_of(seeds), variant=variant)
    return nbrs, valid


def tiled_weighted_sample_layer(bd, tiles, wtiles, seeds, seed_valid, k: int, key,
                                max_deg: int = 512):
    """One-hop weighted sample over the tile layout (K7, tiled window):
    ``wtiles`` holds the edge weights in the tile map of ``tiles``
    (`utils.CSRTopo.to_device_tiled_weights`). Draw-equal to
    `weighted_sample_layer` on the same key when ``max_deg % 128 == 0``.
    Kernel ``weighted_sample_tiled`` on CUDA tensors, the plain version on
    CPU tensors."""
    _check_layer_args(seeds, seed_valid, k, (bd, tiles, wtiles))
    if not seeds.is_cuda:
        return tiled_weighted_sample_layer_plain(bd, tiles, wtiles, seeds, seed_valid, k,
                                                 qrandom.host_key(key), max_deg)
    wwin = gumbel_window(max_deg, "tiled")
    _check_gumbel_args(k, max_deg, wwin, ((wtiles, "weight tiles"),))
    _same_tile_map(tiles, wtiles)
    _int32_args((bd, "bd"), (tiles, "tiles"), (seeds, "seeds"))
    bd, tiles, wtiles = bd.contiguous(), tiles.contiguous(), wtiles.contiguous()
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    nbrs, valid = _gumbel_outputs(seeds, k)
    key_args, variant = _key_args(key, seeds)
    if seeds.shape[0] == 0 or k == 0:
        return nbrs, valid
    _kernels.launch("weighted_sample_tiled", bd.data_ptr(), tiles.data_ptr(),
                    wtiles.data_ptr(), tiles.shape[0], bd.shape[0], seeds.data_ptr(),
                    seed_valid.data_ptr(), seeds.shape[0], int(k), int(max_deg),
                    *key_args, nbrs.data_ptr(), valid.data_ptr(),
                    _kernels.stream_of(seeds), variant=variant)
    return nbrs, valid


def tiled_temporal_sample_layer(bd, tiles, ttiles, seeds, seed_valid, k: int, key, t,
                                max_deg: int = 512, recency: float = 0.0, cutoff=None,
                                graph_words=None):
    """One-hop temporal sample over the tile layout (K8): each row draws
    among its first ``min(deg, max_deg)`` edges those with ``ts <= t[row]``
    (and ``ts > cutoff`` when given), weighted ``exp(recency * ts)``
    (uniform at ``recency == 0``). ``ttiles`` holds the edge timestamps in
    the tile map of ``tiles``; ``t`` is ``[W]`` float32. At ``t = +inf``
    the draw equals `tiled_weighted_sample_layer` over
    ``temporal_edge_weights(ttiles, recency)`` bit for bit. Kernel
    ``temporal_sample_tiled`` on CUDA tensors, the plain version on CPU
    tensors. ``graph_words`` as in `tiled_sample_layer`, three words: bd,
    tiles, ttiles (K8's device-graph form)."""
    _check_layer_args(seeds, seed_valid, k, (bd, tiles, ttiles, t))
    if t.shape != seeds.shape:
        raise ValueError(f"t must be [W] = {tuple(seeds.shape)}; got {tuple(t.shape)}")
    if not seeds.is_cuda:
        return tiled_temporal_sample_layer_plain(bd, tiles, ttiles, seeds, seed_valid, k,
                                                 qrandom.host_key(key), t, max_deg, recency,
                                                 cutoff)
    wwin = gumbel_window(max_deg, "tiled")
    _check_gumbel_args(k, max_deg, wwin, ((ttiles, "timestamp tiles"), (t, "t")))
    _same_tile_map(tiles, ttiles)
    _int32_args((bd, "bd"), (tiles, "tiles"), (seeds, "seeds"))
    bd, tiles, ttiles, t = bd.contiguous(), tiles.contiguous(), ttiles.contiguous(), t.contiguous()
    seeds, seed_valid = seeds.contiguous(), seed_valid.contiguous()
    nbrs, valid = _gumbel_outputs(seeds, k)
    key_args, variant = _key_args(key, seeds)
    if seeds.shape[0] == 0 or k == 0:
        return nbrs, valid
    if graph_words is not None:
        words, variant = _graph_word_args(graph_words, key_args, seeds, 3)
        _kernels.launch("temporal_sample_tiled", words, tiles.shape[0], bd.shape[0],
                        seeds.data_ptr(), seed_valid.data_ptr(), t.data_ptr(), seeds.shape[0],
                        int(k), int(max_deg), float(recency), int(cutoff is not None),
                        0.0 if cutoff is None else float(cutoff), *key_args, nbrs.data_ptr(),
                        valid.data_ptr(), _kernels.stream_of(seeds), variant=variant)
        return nbrs, valid
    _kernels.launch("temporal_sample_tiled", bd.data_ptr(), tiles.data_ptr(),
                    ttiles.data_ptr(), tiles.shape[0], bd.shape[0], seeds.data_ptr(),
                    seed_valid.data_ptr(), t.data_ptr(), seeds.shape[0], int(k), int(max_deg),
                    float(recency), int(cutoff is not None),
                    0.0 if cutoff is None else float(cutoff), *key_args,
                    nbrs.data_ptr(), valid.data_ptr(), _kernels.stream_of(seeds),
                    variant=variant)
    return nbrs, valid


def temporal_edge_weights(ts: torch.Tensor, recency: float) -> torch.Tensor:
    """Recency weight per edge, ``exp(recency * ts)`` (1.0 at ``recency ==
    0``), float32 of ``ts``'s shape: on CUDA tensors kernel K8w
    (``recency_weights``), which computes each weight through the device
    function K8 uses, so weight tiles built here make the weighted draw
    equal to the temporal one at ``t = +inf``; on CPU tensors
    `temporal_edge_weights_plain`."""
    if not ts.is_cuda:
        return temporal_edge_weights_plain(ts, recency)
    if ts.dtype != torch.float32:
        raise TypeError(f"the recency-weight kernel takes float32 timestamps; got {ts.dtype}")
    ts = ts.contiguous()
    out = torch.empty_like(ts)
    if ts.numel():
        _kernels.launch("recency_weights", ts.data_ptr(), ts.numel(), float(recency),
                        out.data_ptr(), _kernels.stream_of(ts))
    return out


def tiled_base_host(indptr) -> Tuple[np.ndarray, int]:
    """Host half of the tile build: ``(bd [N,2] int32, m_rows)``."""
    deg = np.diff(indptr).astype(np.int64)
    rows_per = -(-deg // LANE)
    base = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(rows_per, out=base[1:])
    if base[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"tile row count {base[-1]} exceeds int32")
    bd = np.stack([base[:-1].astype(np.int32), deg.astype(np.int32)], axis=1)
    return bd, max(int(base[-1]), 1)


def build_tiled_host(indptr: np.ndarray, indices: np.ndarray, id_dtype=None):
    """Host build of the 128-lane tile layout: each node's edge list starts
    at a tile-row boundary of a ``[M, 128]`` table; ``bd [N, 2]`` holds
    (tile_base, degree). Returns ``(bd, tiles)``. The oracle of
    `build_tiled_device`, which the port's callers build with."""
    if id_dtype is None:
        from ..utils import _best_id_dtype

        id_dtype = _best_id_dtype(indptr.shape[0])
    bd, M = tiled_base_host(indptr)
    base = bd[:, 0].astype(np.int64)
    deg = bd[:, 1].astype(np.int64)
    tiles = np.zeros((M, LANE), np.dtype(id_dtype))
    out_pos = (
        np.repeat(base * LANE, deg)
        + np.arange(len(indices), dtype=np.int64)
        - np.repeat(indptr[:-1].astype(np.int64), deg)
    )
    tiles.reshape(-1)[out_pos] = indices.astype(id_dtype, copy=False)
    return bd, tiles


def tiled_rowmap_host(indptr) -> Tuple[np.ndarray, np.ndarray]:
    """Per tile row, ``(row_start [M] int64, row_width [M] int32)`` for
    `build_tiled_device`: row r of the tile table holds the flat words
    ``[row_start[r], row_start[r] + row_width[r])`` of its owner node. An
    empty graph gets one all-padding row."""
    indptr = np.asarray(indptr, np.int64)
    bd, M = tiled_base_host(indptr)
    base = bd[:, 0].astype(np.int64)
    deg = bd[:, 1].astype(np.int64)
    rows_per = -(-deg // LANE)
    owner = np.repeat(np.arange(len(deg), dtype=np.int64), rows_per)
    if owner.shape[0] == 0:
        return np.zeros(1, np.int64), np.zeros(1, np.int32)
    t = np.arange(M, dtype=np.int64) - base[owner]
    start = indptr[:-1][owner] + t * LANE
    width = np.minimum(indptr[1:][owner] - start, LANE).astype(np.int32)
    return start, width


# tile rows a chunk of the plain tile build (bounds its [rows, 128] int64 index)
TILE_CHUNK = 1 << 18


def build_tiled_device_plain(src: torch.Tensor, row_start: torch.Tensor,
                             row_width: torch.Tensor) -> torch.Tensor:
    """Plain torch K12 on ``src``'s device: ``out[r, l] = src[clip(row_start[r]
    + l, 0, E - 1)]`` where ``l < row_width[r]``, else 0, in chunks of
    `TILE_CHUNK` rows."""
    M, E = row_start.shape[0], src.shape[0]
    out = torch.zeros((M, LANE), dtype=src.dtype, device=src.device)
    if E == 0:
        return out
    lanes = torch.arange(LANE, dtype=torch.int64, device=src.device)
    for r0 in range(0, M, TILE_CHUNK):
        r1 = min(r0 + TILE_CHUNK, M)
        g = torch.clamp(row_start[r0:r1].to(torch.int64)[:, None] + lanes[None, :], 0, E - 1)
        keep = lanes[None, :] < row_width[r0:r1].to(torch.int64)[:, None]
        out[r0:r1] = torch.where(keep, src[g], out[r0:r1])
    return out


def build_tiled_device(src: torch.Tensor, row_start: torch.Tensor,
                       row_width: torch.Tensor) -> torch.Tensor:
    """The ``[M, 128]`` tile table of flat ``src [E]`` (node ids, edge
    weights or timestamps) through the row map of `tiled_rowmap_host`
    (``row_start [M]`` int64, ``row_width [M]`` int32), on ``src``'s
    device. On CUDA tensors kernel K12 (``csrc/tiles.cu``, a bit copy of
    4-byte words); on CPU tensors `build_tiled_device_plain`. Bit-equal to
    `build_tiled_host`'s table."""
    if src.dim() != 1 or row_start.dim() != 1 or row_width.shape != row_start.shape:
        raise ValueError(f"src [E], row_start [M] and row_width [M] expected; got "
                         f"{tuple(src.shape)}, {tuple(row_start.shape)}, "
                         f"{tuple(row_width.shape)}")
    if row_start.dtype != torch.int64 or row_width.dtype != torch.int32:
        raise TypeError(f"row_start must be int64 and row_width int32; got {row_start.dtype}, "
                        f"{row_width.dtype}")
    if row_start.device != src.device or row_width.device != src.device:
        raise ValueError("src and the row map must share a device")
    if not src.is_cuda:
        return build_tiled_device_plain(src, row_start, row_width)
    if src.element_size() != 4:
        raise ValueError(f"the tile kernel copies 4-byte words; got {src.dtype}: a graph "
                         "whose ids need int64 samples on the host with mode='HOST', whose "
                         "engine is int64 end to end (int64 ids on the card: ROADMAP B4)")
    src, row_start, row_width = src.contiguous(), row_start.contiguous(), row_width.contiguous()
    out = torch.empty((row_start.shape[0], LANE), dtype=src.dtype, device=src.device)
    _kernels.launch("build_tiles", src.data_ptr(), src.shape[0], row_start.data_ptr(),
                    row_width.data_ptr(), row_start.shape[0], out.data_ptr(),
                    _kernels.stream_of(src),
                    variant="float32" if src.dtype.is_floating_point else "int32")
    return out


# K11's merge-path ranges (csrc/prob.cu, which refuses other values): the
# merge items (an edge, or a node's end) a lane walks, a warp's range of
# 32 lanes, and the ranges up to which a node's parts are added one by one
PROB_LANE_ITEMS = 16
PROB_WARP_ITEMS = 32 * PROB_LANE_ITEMS
PROB_SEQ_SPAN = 8


class TransposedCSR(NamedTuple):
    """The graph's edges grouped by destination, which the probability
    kernel (K11) pulls over: the sources of node v are
    ``tsrc[tindptr[v]:tindptr[v+1]]`` in stable edge order. The merge of
    the node ends with the edges (node v's edges, then its end, then v + 1's
    edges) is cut into ranges of ``PROB_WARP_ITEMS`` items, range r
    starting at node ``range_node[r]`` and edge ``range_edge[r]``."""

    tindptr: torch.Tensor     # [N+1] int64
    tsrc: torch.Tensor        # [E'] int32 (E' edges with a destination in [0, N))
    deg: torch.Tensor         # [N] int32 out-degree
    range_node: torch.Tensor  # [R+1] int32
    range_edge: torch.Tensor  # [R+1] int64

    def to(self, device) -> "TransposedCSR":
        return TransposedCSR(*(t.to(device) for t in self))


def build_transposed_host(indptr, indices) -> TransposedCSR:
    """Host build of the `TransposedCSR` (CPU tensors). Edges are stored
    by source, so among the edges into one node the stable edge order is
    ascending source order (duplicate edges, equal in source, carry equal
    values): one sort of packed (destination, source) keys gives it.
    Edges whose destination lies outside ``[0, N)`` are left out, as the
    reference's scatter drops them."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = indptr.shape[0] - 1
    if n >= 2**31:
        raise ValueError(f"{n} nodes: the transposed CSR keeps int32 sources")
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    keep = (indices >= 0) & (indices < n)
    if not keep.all():
        src, indices = src[keep], indices[keep]
    key = (indices << 32) | src
    key.sort()
    tsrc = (key & 0xFFFFFFFF).astype(np.int32)
    tindptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=tindptr[1:])
    node, edge = merge_path_ranges(tindptr, PROB_WARP_ITEMS)
    return TransposedCSR(torch.from_numpy(tindptr), torch.from_numpy(tsrc),
                         torch.from_numpy(deg.astype(np.int32)), torch.from_numpy(node),
                         torch.from_numpy(edge))


def merge_path_ranges(tindptr, items: int):
    """Where each range of ``items`` merge items starts in the merge of the
    node ends with the edges of ``tindptr [N+1]``: ``(node [R+1] int32,
    edge [R+1] int64)``, the last entry ``(N, E)``. At merge position d,
    the nodes whose end lies before d (node v's end sits at v + tindptr[v +
    1]) number ``node``, and ``edge = d - node``."""
    tindptr = np.asarray(tindptr, np.int64)
    n = tindptr.shape[0] - 1
    total = n + int(tindptr[-1])
    d = np.minimum(np.arange(-(-total // items) + 1, dtype=np.int64) * items, total)
    node = np.searchsorted(np.arange(n, dtype=np.int64) + tindptr[1:], d, side="left")
    return node.astype(np.int32), d - node


def _prob_weights(deg: torch.Tensor, prob: torch.Tensor, k: int) -> torch.Tensor:
    """``prob * min(k / max(deg, 1), 1)`` in float32, in the reference's
    steps (an IEEE division: ``k / tensor`` would multiply by a
    reciprocal)."""
    d = torch.clamp(deg.to(torch.float32), min=1.0)
    return prob * torch.clamp(torch.div(torch.full_like(d, float(k)), d), max=1.0)


def neighbor_prob_plain(indptr, indices, prob: torch.Tensor, k: int,
                        acc_dtype=torch.float32) -> torch.Tensor:
    """Plain torch version of `neighbor_prob` on ``prob``'s device: the
    weights, then ``index_add_`` over the edge list in edge order (on the
    CPU a sequential sum per node, the reference's order). With
    ``acc_dtype=torch.float64`` the float32 weights are summed in float64:
    their exact sum to within float64 rounding, which the card's tree order
    is held against (`neighbor_prob_depth`)."""
    n = indptr.shape[0] - 1
    dev = prob.device
    deg = (indptr[1:] - indptr[:-1]).to(dev)
    w = _prob_weights(deg, prob, k).to(acc_dtype)
    src = torch.repeat_interleave(torch.arange(n, device=dev), deg.to(torch.int64))
    dst = indices.to(dev, torch.int64)
    keep = (dst >= 0) & (dst < n)
    return torch.zeros(n, dtype=acc_dtype, device=dev).index_add_(0, dst[keep], w[src[keep]])


def neighbor_prob_depth(t: TransposedCSR) -> torch.Tensor:
    """``[N]`` int64: for each node, a bound on the float32 additions any
    of its terms passes through in K11's order. In its range of the merge
    of node ends and edges, a term passes a lane's sequential sum (at most
    ``PROB_LANE_ITEMS`` items), the 5-level segmented scan over the lanes
    and one addition of the lane's part to the earlier lanes'. A node whose
    items span S > 1 ranges then adds its S parts: one by one (S - 1
    additions) up to ``PROB_SEQ_SPAN`` parts, else strided over 32 lanes
    (``ceil(S / 32)``) and a 5-level butterfly. The terms are nonnegative,
    so the kernel's ``next[v]`` lies within ``d u / (1 - d u)`` (``d`` the
    depth, ``u = 2^-24``) of their exact sum, relative."""
    v = torch.arange(t.tindptr.shape[0] - 1, dtype=torch.int64, device=t.tindptr.device)
    first = (v + t.tindptr[:-1]) // PROB_WARP_ITEMS  # the range of v's first item
    span = (v + t.tindptr[1:]) // PROB_WARP_ITEMS - first + 1  # ranges up to its end's
    parts = torch.where(span <= PROB_SEQ_SPAN, span - 1, (span + 31) // 32 + 5)
    return PROB_LANE_ITEMS + 6 + parts


def neighbor_prob(indptr, indices, prob: torch.Tensor, k: int,
                  transposed: Optional[TransposedCSR] = None) -> torch.Tensor:
    """One hop of sampling-probability propagation: ``next [N]`` float32
    with ``next[v] = sum over edges u -> v of prob[u] * min(k / max(deg(u),
    1), 1)``. On CUDA tensors one call of ``csrc/prob.cu``'s
    ``qt_neighbor_prob`` (K11) over ``transposed`` (built from the graph
    when not given; `utils.CSRTopo.to_device_transposed` caches it), which
    adds in a fixed merge-path order: deterministic, and within float
    rounding of the reference's sequential sum (`neighbor_prob_depth`). On
    CPU tensors `neighbor_prob_plain`."""
    n = indptr.shape[0] - 1
    if prob.dim() != 1 or prob.shape[0] != n:
        raise ValueError(f"prob must be [N] = [{n}]; got {tuple(prob.shape)}")
    if not prob.is_cuda:
        return neighbor_prob_plain(indptr, indices, prob, k)
    if prob.dtype != torch.float32:
        raise TypeError(f"the probability kernel takes float32 prob; got {prob.dtype}")
    if transposed is None:
        transposed = build_transposed_host(indptr.cpu().numpy(), indices.cpu().numpy())
        transposed = transposed.to(prob.device)
    t = transposed
    if t.tsrc.device != prob.device or t.deg.shape[0] != n:
        raise ValueError("the transposed graph must be this graph's, on prob's device")
    prob = prob.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=prob.device)
    if n == 0:
        return out
    e = t.tsrc.shape[0]
    n_bytes = _kernels.neighbor_prob_scratch_bytes(n, e)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=prob.device)
    _kernels.launch("neighbor_prob", prob.data_ptr(), t.deg.data_ptr(), n, float(k),
                    t.tindptr.data_ptr(), t.tsrc.data_ptr(), e, t.range_node.data_ptr(),
                    t.range_edge.data_ptr(),
                    t.range_node.shape[0] - 1, PROB_LANE_ITEMS, PROB_SEQ_SPAN,
                    scratch.data_ptr(), n_bytes, out.data_ptr(), _kernels.stream_of(prob))
    return out


def sample_prob(indptr, indices, sizes, train_idx, num_nodes: Optional[int] = None,
                transposed: Optional[TransposedCSR] = None) -> torch.Tensor:
    """Multi-hop hot-probability estimate on ``indptr``'s device: the train
    nodes get 1, then each fanout of ``sizes`` adds one `neighbor_prob`
    hop of the previous hop's result."""
    n = num_nodes if num_nodes is not None else indptr.shape[0] - 1
    dev = indptr.device
    idx = torch.as_tensor(train_idx).to(dev, torch.int64)
    prob = torch.zeros(n, dtype=torch.float32, device=dev)
    prob[idx] = 1.0
    last = prob
    for k in sizes:
        nxt = neighbor_prob(indptr, indices, last, int(k), transposed)
        prob = prob + nxt
        last = nxt
    return prob

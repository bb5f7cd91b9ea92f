"""Inference, evaluation and the fused serve step — the port of
``quiver_tpu/inference.py``.

The JAX package passes a flax module and its params separately; here a
model is an ``nn.Module`` holding its weights (`bind_params` makes one
from a ``state_dict``), so every function below takes the bound module:
a `models.GraphSAGE`, `models.GCN` or `models.GAT` (full-neighbor
inference is GraphSAGE's alone, as in the JAX package).
All of them run the model in eval mode with TF32 off
(`strict_float32`): float32 products stay float32, as in the reference.

- `full_mean_aggregate` (K10: the kernel of ``csrc/full_mean.cu`` on CUDA
  tensors, `full_mean_aggregate_plain` on CPU tensors) and
  `sage_full_inference`: exact layer-wise full-neighbor GraphSAGE over all
  nodes; `full_inference_accuracy` and `sampled_eval` score a model;
- `sample_batch` + `forward_logits` == `batch_logits`: the split path;
- `make_serve_step`: sample + gather + forward as one step function, the
  engine's fused path, and `make_temporal_serve_step`, its temporal twin
  that takes the padded per-seed query times as one more argument;
  `BucketPrograms` keeps one entry per bucket with the hard miss after
  `seal()`. Each bucket stays a plain call in this
  slice (CUDA-graph capture per bucket is later work).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from . import _kernels
from . import random as qrandom
from .feature import Feature, gather_rows


def strict_float32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions (the
    reference computes in full float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


EDGE_CHUNK = 1 << 22  # edges per index_add_ of the plain full mean (bounds its [E, D] temporary)


def full_mean_aggregate_plain(indptr: torch.Tensor, indices: torch.Tensor,
                              h: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `full_mean_aggregate`: an edge-chunked
    ``index_add_`` of the neighbor rows, then the divide."""
    n = indptr.shape[0] - 1
    e = indices.shape[0]
    out = torch.zeros((n, h.shape[1]), dtype=h.dtype, device=h.device)
    deg = (indptr[1:] - indptr[:-1]).to(torch.int64)
    for lo in range(0, e, EDGE_CHUNK):
        hi = min(lo + EDGE_CHUNK, e)
        eidx = torch.arange(lo, hi, dtype=indptr.dtype, device=h.device)
        src = torch.searchsorted(indptr, eidx, right=True) - 1
        dst = torch.clamp(indices[lo:hi].to(torch.int64), 0, h.shape[0] - 1)
        out.index_add_(0, src.to(torch.int64), h[dst])
    return out / torch.clamp(deg, min=1).to(h.dtype)[:, None]


def full_mean_aggregate(indptr: torch.Tensor, indices: torch.Tensor,
                        h: torch.Tensor) -> torch.Tensor:
    """Exact mean over all neighbors of every node: ``out[u] = mean_{v in
    N(u)} h[clip(v)]`` (zero where the degree is 0), ``[N, D]``. On CUDA
    tensors one counted launch of K10, whose C entry point runs its kernels
    in turn (the heavy rows' segment table, the sums, the heavy rows'
    combine); deterministic: a fixed order, no atomics."""
    if indptr.dim() != 1 or indices.dim() != 1 or h.dim() != 2:
        raise ValueError("indptr [N+1], indices [E] and h [N_h, D] expected")
    if len({indptr.device, indices.device, h.device}) != 1:
        raise ValueError("indptr, indices and h must share a device")
    if not h.is_cuda:
        return full_mean_aggregate_plain(indptr, indices, h)
    if h.dtype != torch.float32:
        raise TypeError(f"the full-mean kernel takes float32 h; got {h.dtype}")
    if indptr.dtype != indices.dtype or indptr.dtype not in (torch.int32, torch.int64):
        raise TypeError("indptr and indices must both be int32 or both int64")
    indptr, indices, h = indptr.contiguous(), indices.contiguous(), h.contiguous()
    n = indptr.shape[0] - 1
    D = h.shape[1]
    out = torch.empty((n, D), dtype=h.dtype, device=h.device)
    if n == 0 or D == 0:
        return out
    n_bytes = _kernels.full_mean_scratch_bytes(n, indices.shape[0], D)
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=h.device)
    _kernels.launch(
        "full_mean", indptr.data_ptr(), indices.data_ptr(), int(indptr.dtype == torch.int64),
        n, indices.shape[0], h.data_ptr(), h.shape[0], D, out.data_ptr(), scratch.data_ptr(),
        n_bytes, _kernels.stream_of(h),
    )
    return out


def sage_full_inference(model: nn.Module, indptr: torch.Tensor, indices: torch.Tensor,
                        x_all) -> torch.Tensor:
    """Layer-wise full-neighbor GraphSAGE over all nodes: per layer one
    `full_mean_aggregate` and the layer's two projections, relu between
    layers, no dropout. ``model`` is a port `GraphSAGE` holding its
    weights; the result lies on its device."""
    strict_float32()
    dev = next(model.parameters()).device
    h = x_all if isinstance(x_all, torch.Tensor) else torch.from_numpy(np.asarray(x_all))
    h = h.to(device=dev, dtype=torch.float32)
    last = len(model.convs) - 1
    with torch.inference_mode():
        for i, conv in enumerate(model.convs):
            agg = full_mean_aggregate(indptr, indices, h)
            h = conv.lin_l(agg) + conv.lin_r(h)
            if i != last:
                h = torch.relu(h)
    return h


def full_inference_accuracy(model: nn.Module, topo, x_all, labels, nodes) -> float:
    """Accuracy of `sage_full_inference` on a node subset."""
    dev = next(model.parameters()).device
    indptr, indices = topo.to_device(dev)
    h = sage_full_inference(model, indptr, indices, x_all)
    pred = h.argmax(dim=-1).cpu().numpy()
    nodes = np.asarray(nodes)
    return float((pred[nodes] == np.asarray(labels)[nodes]).mean())


def sampled_eval(model: nn.Module, sampler, feature, labels, nodes,
                 batch_size: int = 1024) -> float:
    """Sampled accuracy over ``nodes``: batches of ``batch_size`` seeds
    (the last one padded with its final seed, the padding not scored)
    through ``sampler`` and `lookup_features`. Returns the fraction
    correct."""
    nodes = np.asarray(nodes)
    labels = np.asarray(labels)
    correct = 0
    for lo in range(0, nodes.shape[0], batch_size):
        batch = pad_seed_batch(nodes[lo: lo + batch_size], batch_size)
        logits = batch_logits(model, sampler, feature, batch)
        n_real = min(batch_size, nodes.shape[0] - lo)
        pred = logits.argmax(dim=-1).cpu().numpy()[:n_real]
        correct += int((pred == labels[nodes[lo: lo + batch_size]]).sum())
    return correct / nodes.shape[0]


def bind_params(model: nn.Module, params=None, device=None) -> nn.Module:
    """An eval-mode module with ``params`` (a ``state_dict``, e.g. from
    `convert.sage_params_from_flax`, `gcn_params_from_flax` or
    `gat_params_from_flax`) loaded into a copy of ``model``, on
    ``device``. ``params=None`` keeps the model's own weights."""
    m = copy.deepcopy(model) if params is not None else model
    if device is not None:
        m = m.to(device)
    if params is not None:
        m.load_state_dict(params)
    return m.eval()


def pad_seed_batch(batch: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a 1-D seed batch up to ``batch_size`` by repeating its last
    seed (the rows are sliced off after the forward)."""
    batch = np.asarray(batch)
    if batch.shape[0] == 0:
        raise ValueError("cannot pad an empty seed batch")
    if batch.shape[0] > batch_size:
        raise ValueError(f"batch of {batch.shape[0]} exceeds batch_size={batch_size}")
    out = np.empty(batch_size, batch.dtype)
    out[: batch.shape[0]] = batch
    out[batch.shape[0]:] = batch[-1]
    return out


def lookup_features(feature, n_id: torch.Tensor) -> torch.Tensor:
    """Feature rows for a sampled ``n_id``: a ``[N, D]`` tensor on the
    sample's device goes through `gather_rows`; a `Feature` through
    `Feature.lookup_padded` when every row is on the device, else its
    tiered ``__getitem__``; a numpy table is clipped and taken on the
    host, then moved; a feature with a ``gather_spec`` (the fleet's
    `serve.dist.ClosureFeature`) goes through `gather_rows` with its index
    map, as the fused step gathers; any other feature object (the fleet's
    exchange-residency shard feature) through its own ``__getitem__``."""
    if isinstance(feature, Feature):
        return feature.lookup_padded(n_id) if feature.resident else feature[n_id]
    if isinstance(feature, torch.Tensor):
        return gather_rows(feature, n_id)
    if isinstance(feature, np.ndarray):
        ids = np.clip(n_id.cpu().numpy(), 0, feature.shape[0] - 1)
        return torch.from_numpy(feature[ids]).to(n_id.device)
    if hasattr(feature, "gather_spec"):
        table, index_map = feature.gather_spec(n_id.device)
        return gather_rows(table, n_id, index_map)
    if hasattr(feature, "__getitem__"):
        return torch.as_tensor(feature[n_id]).to(n_id.device)
    raise TypeError(f"unsupported feature type {type(feature).__name__}")


def sample_batch(sampler, padded_batch):
    """Stage 1 of the split step: the sampler's next key and its k-hop
    sample of ``padded_batch``."""
    return sampler.sample_dense(padded_batch)


def forward_logits(model: nn.Module, feature, ds) -> torch.Tensor:
    """Stage 2 of the split step: gather ``ds.n_id``'s rows and run the
    bound model."""
    strict_float32()
    with torch.inference_mode():
        x = lookup_features(feature, ds.n_id)
        return model.eval()(x, ds.adjs)


def batch_logits(model: nn.Module, sampler, feature, padded_batch) -> torch.Tensor:
    """One fixed-shape eval step: `sample_batch` then `forward_logits`."""
    return forward_logits(model, feature, sample_batch(sampler, padded_batch))


def draw_sample_key(sampler) -> qrandom.Key:
    """Consume the sampler's next key without sampling (the fused path
    draws keys in dispatch order and samples inside the step)."""
    return sampler.next_key()


def feature_gather_spec(feature, device):
    """``(table, index_map)`` tensors on ``device`` for the in-step gather:
    a dense ``[R, D]`` table and no map, or a feature's own
    ``gather_spec(device)`` (the fleet's `serve.dist.ClosureFeature`: its
    closure rows and int32 global -> row map). Raises TypeError for
    features whose lookup is host-side."""
    if hasattr(feature, "gather_spec"):
        return feature.gather_spec(device)
    if isinstance(feature, np.ndarray):
        feature = torch.from_numpy(feature)
    if isinstance(feature, torch.Tensor):
        if feature.dim() != 2:
            raise TypeError(f"feature table must be [N, D]; got {tuple(feature.shape)}")
        return feature.to(device), None
    raise TypeError(
        f"{type(feature).__name__} has no in-step gather — the serve engine "
        "uses the split path for it"
    )


def make_serve_step(sampler):
    """The fused serve step: ``serve_step(model, key, seeds, table,
    index_map, graph)`` samples with ``key``, gathers
    ``table[clip(index_map[clip(n_id)])]`` and runs ``model``, the same
    arithmetic as `sample_batch` + `forward_logits`. Returns
    ``(serve_step, graph, id_dtype)``."""
    from .pyg.sage_sampler import sample_dense_fused, sample_dense_pure

    graph, bind, id_dtype = sampler.fused_sample_spec()
    sizes, caps, dedup = sampler.sizes, sampler.caps, sampler.dedup

    def serve_step(model, key, seeds, table, index_map, graph):
        sample_fn = bind(graph)
        if dedup:
            ds = sample_dense_pure(None, None, key, seeds, sizes, caps, sample_fn=sample_fn)
        else:
            ds = sample_dense_fused(None, None, key, seeds, sizes, sample_fn=sample_fn)
        x = gather_rows(table, ds.n_id, index_map)
        return model(x, ds.adjs)

    return serve_step, graph, id_dtype


def make_temporal_serve_step(sampler):
    """The temporal twin of `make_serve_step`: ``serve_step(model, key,
    seeds, table, index_map, graph, t)`` runs
    `workloads.temporal.temporal_sample_dense` with the padded per-seed
    query times ``t``, then the gather and the forward. The sampler must
    be temporal-bound (`GraphSageSampler.bind_temporal`)."""
    from .workloads.temporal import temporal_sample_dense

    if getattr(sampler, "temporal", None) is None:
        raise TypeError("make_temporal_serve_step needs a temporal-bound sampler")
    _, recency = sampler.temporal
    graph = sampler.fused_graph_arrays()
    sizes, max_deg = sampler.sizes, sampler.max_deg

    def serve_step(model, key, seeds, table, index_map, graph, t):
        ds = temporal_sample_dense(graph, key, seeds, t, sizes, recency=recency,
                                   max_deg=max_deg)
        x = gather_rows(table, ds.n_id, index_map)
        return model(x, ds.adjs)

    return serve_step, graph, graph[1].dtype


class BucketPrograms:
    """The fused serve step per bucket. `compile_bucket` runs a bucket
    once on a fixed key (the sampler's key stream is untouched) so that
    the kernels are built and the allocator warm; `seal()` turns a later
    call at an unwarmed bucket into a hard RuntimeError. A temporal-bound
    sampler's step takes the padded query-time vector as one more
    argument of each call (the warm run passes ``t = +inf``)."""

    _WARM_KEY = qrandom.fold_in(qrandom.key(0), 0)

    def __init__(self, sampler, feature):
        self._temporal = getattr(sampler, "temporal", None) is not None
        make = make_temporal_serve_step if self._temporal else make_serve_step
        self._fn, self._graph, self._id_dtype = make(sampler)
        self._sampler = sampler
        self._caps = sampler.caps  # the caps the step was built for
        self._table, self._map = feature_gather_spec(feature, sampler.device)
        self._buckets = set()
        self._sealed = False

    @property
    def buckets(self):
        return tuple(sorted(self._buckets))

    def seal(self) -> None:
        self._sealed = True

    def compile_bucket(self, bucket: int, model: nn.Module) -> None:
        bucket = int(bucket)
        if bucket in self._buckets:
            return
        extra = (np.full(bucket, np.inf, np.float32),) if self._temporal else ()
        self._run(model, self._WARM_KEY, np.zeros(bucket, np.int64), *extra)
        if self._table.is_cuda:
            torch.cuda.synchronize(self._table.device)
        self._buckets.add(bucket)

    def _run(self, model, key, seeds, *extra):
        strict_float32()
        if len(extra) != int(self._temporal):
            raise TypeError(f"the serve step takes {int(self._temporal)} per-seed array(s) "
                            f"besides the seeds; got {len(extra)}")
        t = tuple(self._on_device(np.asarray(e, np.float32)) for e in extra)
        with torch.inference_mode():
            return self._fn(model.eval(), key, self._sampler.as_seeds(seeds), self._table,
                            self._map, self._graph, *t)

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if self._sampler.device.type == "cuda":
            return host.pin_memory().to(self._sampler.device, non_blocking=True)
        return host

    def __call__(self, bucket: int, model: nn.Module, key, seeds, *extra) -> torch.Tensor:
        """Sample + gather + forward of one padded seed batch at
        ``bucket`` (``extra``: the padded query times of a temporal step);
        misses register lazily before `seal()` and raise after."""
        if self._sampler.caps != self._caps:
            raise RuntimeError(
                f"sampler caps changed from {self._caps} to {self._sampler.caps} "
                "after the serve step was built — set caps before the engine"
            )
        if int(bucket) not in self._buckets:
            if self._sealed:
                raise RuntimeError(
                    f"serve bucket {bucket} was not warmed (warmed: {self.buckets}) — "
                    "warmup() seals the bucket table"
                )
            self._buckets.add(int(bucket))
        return self._run(model, key, seeds, *extra)


def to_host(out: torch.Tensor) -> np.ndarray:
    """Read a result back to the host. On the card the copy goes to
    pinned memory on the current stream and the host reads it only after
    the copy's CUDA event, so another thread's work queued behind it is
    not waited for."""
    if not out.is_cuda:
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    ev.synchronize()
    return host.numpy().copy()

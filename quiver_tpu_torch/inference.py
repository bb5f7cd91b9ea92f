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
  `BucketPrograms` keeps one program per bucket with the hard miss after
  `seal()`: on the card one captured CUDA graph a bucket, whose inputs
  (seeds, the hops' key words, query times) reach it through device
  buffers, with the reference's `rebind`, `reprovision`, `binding` and
  `sealed`; over a streaming graph the graph tensors' addresses are one
  more input, so a commit's `rebind` captures nothing;
- `time_eval_split`: the split step's two stages timed apart.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import _kernels
from . import random as qrandom
from .feature import Feature, gather_rows
from .graphs import GraphBook, byte_fields, byte_views, capture, stage


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


class Binding(tuple):
    """A `BucketPrograms.binding()` snapshot: the ``(table, index_map,
    graph)`` triple bound when it was taken and, on the card, the graphs
    captured against those arrays (``captures``: bucket -> `_Capture`). A
    flush that holds it keeps its graphs and arrays alive after a
    `BucketPrograms.rebind`. ``ready``: the CUDA event after the commit
    that wrote a streaming graph's arrays (a replay waits on it), or
    None."""

    def __new__(cls, table, index_map, graph, token, captures=None):
        b = super().__new__(cls, (table, index_map, tuple(graph)))
        b.token = token  # the BucketPrograms it belongs to
        b.captures = {} if captures is None else captures
        b.ready = getattr(graph, "ready", None)
        return b


class DeviceGraph(tuple):
    """The graph tensors a step samples from, with ``words``: their
    addresses as 64-bit words on the device, which the draws' device-graph
    forms read in place of the tensors (on the card; the CPU's plain
    versions read the tensors)."""

    def __new__(cls, graph, words):
        g = super().__new__(cls, graph)
        g.words = words
        return g


def _spec(x):
    """Shape, dtype and device of a tensor, of each tensor of a tuple, or
    None: all a captured step bakes in besides the addresses."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    return tuple(_spec(t) for t in x)


def _input_fields(bucket: int, hops: int, id_dtype: torch.dtype, temporal: bool,
                  graph_words: int = 0):
    """The byte layout of a call's inputs: ``[(offset, bytes, dtype,
    shape)]`` of the padded seeds, the hops' key words, for a temporal
    step the query times and, for a step over a streaming graph, the graph
    tensors' ``graph_words`` addresses, each 8-byte aligned, and the total
    bytes."""
    fields = [(id_dtype, (bucket,)), (torch.uint32, (hops, 2))]
    if temporal:
        fields.append((torch.float32, (bucket,)))
    if graph_words:
        fields.append((torch.int64, (graph_words,)))
    return byte_fields(fields)


class _Capture:
    """One bucket's captured serve step: the graph, its static input
    bytes (`_input_fields`) and output, the lock a call holds from its
    input copy to its read-back's enqueue, and its `graphs.Tally`."""

    __slots__ = ("graph", "static", "fields", "out", "lock", "tally")


class BucketPrograms(GraphBook):
    """The fused serve step, one program per bucket, with the hard miss
    after `seal()` (the JAX package's ``BucketPrograms``; its
    ahead-of-time executable a bucket is, on the card, one captured
    ``torch.cuda.CUDAGraph`` a bucket).

    `compile_bucket` on a CUDA sampler runs the step once eagerly on a
    side stream (kernels built, cuBLAS up), then captures it reading
    static device inputs: the padded seeds, the hops' key words (the draw
    kernels read them from the card) and, for a temporal step, the padded
    query times. A call fills one pinned staging buffer with those, copies
    it into the static inputs with one asynchronous copy, replays the
    graph and reads the output back (`to_host`), all on the programs' own
    stream, and returns the logits as a numpy array. A capture that fails,
    or a replay that CUDA refuses, raises: nothing runs the eager step in
    its place. On a CPU sampler the same object runs the step eagerly
    (`compile_bucket` warms it on a fixed key; the sampler's key stream
    is untouched).

    The graphs bake in addresses. They are captured with one module
    (`compile_bucket`'s ``model``), whose weights a caller updates in
    place (`ServeEngine.update_params`); the table, map and graph arrays
    are a `Binding`, and a same-shaped `rebind` captures every warmed
    bucket anew against the new arrays (nothing is written into the
    captured buffers), while a flush holding the old `binding()` keeps
    running the old graphs. Over a streaming graph (a sampler with a
    ``stream``) the draws take their device-graph form instead: the graph
    tensors' addresses are staged with each call's inputs, so one capture
    a bucket serves every epoch, and a same-shaped `rebind` of the graph
    captures nothing (a replay waits on the epoch's ``ready`` event and
    marks its tensors in use on the programs' stream; `reprovision`, a
    shape change, still captures anew). Concurrent calls at one bucket share its
    static buffers, so each holds the bucket's lock from its staging copy
    to its read-back's enqueue and waits for the read-back outside it:
    one graph a bucket (captures and graph memory do not grow with the
    engine's ``max_in_flight``), and the card runs the flushes in turn on
    one stream, as the eager flushes did, while the next flush's host
    work overlaps the device work before it."""

    _WARM_KEY = qrandom.fold_in(qrandom.key(0), 0)

    def __init__(self, sampler, feature):
        super().__init__()  # the tallies: one a graph captured, kept after the graph is gone
        self._temporal = getattr(sampler, "temporal", None) is not None
        make = make_temporal_serve_step if self._temporal else make_serve_step
        self._fn, graph, self._id_dtype = make(sampler)
        self._sampler = sampler
        self._hops = len(sampler.sizes)
        self._caps = sampler.caps  # the caps the step was built for
        # over a streaming graph: the graph tensors' addresses are inputs
        self._graph_words = len(graph) if getattr(sampler, "stream", None) is not None else 0
        self._token = object()
        table, index_map = feature_gather_spec(feature, sampler.device)
        self._binding = Binding(table, index_map, graph, self._token)
        self._device = torch.device(sampler.device)
        self._cuda = self._device.type == "cuda"
        self._buckets = set()
        self._sealed = False
        self._model = None  # the module the graphs were captured with
        self._lock = threading.Lock()  # captures and binding changes
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None

    @property
    def buckets(self):
        return tuple(sorted(self._buckets))

    @property
    def sealed(self) -> bool:
        return self._sealed

    def seal(self) -> None:
        self._sealed = True

    def binding(self) -> Binding:
        """The ``(table, index_map, graph)`` bound now, as a snapshot that
        a later call takes through ``binding=`` (the engine records it at
        a flush's seal, so the flush runs against the arrays of its own
        dispatch even if a `rebind` comes before it runs)."""
        return self._binding

    def rebind(self, graph=None, table=None, index_map=None) -> None:
        """Bind same-shaped new arrays: a ``graph`` tuple, a feature
        ``table`` or an ``index_map`` (where one is bound). A shape, dtype
        or device change raises ValueError. On the card every warmed bucket
        is captured anew against the new arrays, but for a streaming
        graph's ``graph`` alone (its addresses are staged inputs: the new
        binding shares the graphs); the sealed state stays."""
        with self._lock:
            t, m, g = self._binding
            ready = self._binding.ready
            if graph is not None:
                if _spec(tuple(graph)) != _spec(g):
                    raise ValueError(f"rebind graph {_spec(tuple(graph))} differs from the bound "
                                     f"{_spec(g)}: a rebind swaps contents, never shapes")
                g, ready = tuple(graph), getattr(graph, "ready", None)
            if table is not None:
                if _spec(table) != _spec(t):
                    raise ValueError(f"rebind table {_spec(table)} differs from the bound "
                                     f"{_spec(t)}")
                t = table
            if index_map is not None:
                if m is None or _spec(index_map) != _spec(m):
                    raise ValueError(f"rebind index_map {_spec(index_map)} differs from the "
                                     f"bound {_spec(m)}")
                m = index_map
            if self._graph_words and table is None and index_map is None:
                # the graphs read the graph's addresses from their inputs
                new = Binding(t, m, g, self._token, captures=self._binding.captures)
            else:
                new = Binding(t, m, g, self._token)
                if self._cuda:
                    for b in sorted(self._buckets):
                        new.captures[b] = self._capture(b, new, self._model)
            new.ready = ready
            self._binding = new

    def reprovision(self, graph, model=None) -> int:
        """Bind a graph of another shape (the reference's reserve
        re-provisioning): every warmed bucket is dropped and, when
        ``model`` is given, built anew against it; the sealed state stays
        (a sealed table without its buckets misses hard). Returns the
        buckets rebuilt: 0 when the shapes are unchanged, which is a
        `rebind` (captured anew on the card)."""
        if _spec(tuple(graph)) == _spec(self._binding[2]):
            self.rebind(graph=graph)
            return 0
        with self._lock:
            t, m, _ = self._binding
            self._binding = Binding(t, m, graph, self._token)
            warmed = sorted(self._buckets)
            self._buckets = set()
        if model is not None:
            for b in warmed:
                self.compile_bucket(b, model)
        return len(warmed)

    def compile_bucket(self, bucket: int, model: nn.Module) -> None:
        """Build ``bucket``'s program: on the card capture its graph (after
        one eager run on a side stream), on the CPU run it once on a fixed
        key (the sampler's key stream is untouched)."""
        bucket = int(bucket)
        with self._lock:
            if bucket in self._buckets:
                return
            if self._cuda:
                self._claim(model)
                b = self._binding
                b.captures[bucket] = self._capture(bucket, b, model)
            else:
                extra = (np.full(bucket, np.inf, np.float32),) if self._temporal else ()
                self._eager(bucket, model, self._binding, self._WARM_KEY,
                            np.zeros(bucket, np.int64), extra)
            self._buckets.add(bucket)

    def __call__(self, bucket: int, model: nn.Module, key, seeds, *extra,
                 binding: Optional[Binding] = None) -> np.ndarray:
        """Sample + gather + forward of one padded seed batch at
        ``bucket`` with host key ``key`` (``extra``: the padded query
        times of a temporal step), against ``binding`` (a `binding()`
        snapshot) or the arrays bound now. Returns the logits ``[bucket,
        C]`` on the host. Misses build lazily before `seal()` and raise
        after."""
        if len(extra) != int(self._temporal):
            raise TypeError(f"the serve step takes {int(self._temporal)} per-seed array(s) "
                            f"besides the seeds; got {len(extra)}")
        if self._sampler.caps != self._caps:
            raise RuntimeError(
                f"sampler caps changed from {self._caps} to {self._sampler.caps} "
                "after the serve step was built — set caps before the engine"
            )
        bucket = int(bucket)
        if np.shape(seeds) != (bucket,):
            raise ValueError(f"bucket {bucket} takes {bucket} padded seeds; got "
                             f"{np.shape(seeds)}")
        if bucket not in self._buckets:
            if self._sealed:
                raise RuntimeError(
                    f"serve bucket {bucket} was not warmed (warmed: {self.buckets}) — "
                    "warmup() seals the bucket table"
                )
            self.compile_bucket(bucket, model)
        if binding is None:
            binding = self._binding
        elif not isinstance(binding, Binding) or binding.token is not self._token:
            raise TypeError("binding= takes a binding() snapshot of these programs")
        if not self._cuda:
            return self._eager(bucket, model, binding, key, seeds, extra)
        self._claim(model)  # compile_bucket claimed the capturing module: a check here
        cap = binding.captures.get(bucket)
        if cap is None:  # a bucket warmed after this snapshot was taken
            with self._lock:
                cap = binding.captures.get(bucket)
                if cap is None:
                    cap = binding.captures[bucket] = self._capture(bucket, binding, model)
        staging = self._stage(cap.fields, cap.static.shape[0], key, seeds, extra, binding,
                              pin=True)
        with cap.lock:
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
            if binding.ready is not None:  # the commit's scatters that wrote the graph
                self._stream.wait_event(binding.ready)
            with torch.cuda.stream(self._stream):
                cap.static.copy_(staging, non_blocking=True)
                cap.graph.replay()
                host, done = _read_back(cap.out)
            if self._graph_words:
                for t in binding[2]:  # read here by address, unknown to the allocator
                    t.record_stream(self._stream)
            cap.tally.replays += 1
        done.synchronize()
        return host.numpy().copy()

    # -- internals --------------------------------------------------------------

    def _claim(self, model: nn.Module) -> None:
        if self._model is None:
            self._model = model
        elif model is not self._model:
            raise ValueError("the serve graphs were captured with another module: load new "
                             "weights into that one in place (ServeEngine.update_params)")

    def _fields(self, bucket: int):
        return _input_fields(bucket, self._hops, self._id_dtype, self._temporal,
                             self._graph_words)

    def _stage(self, fields, nbytes: int, key, seeds, extra, binding, pin: bool) -> torch.Tensor:
        """A host byte buffer holding a call's inputs: the seeds in the id
        dtype, the words of each hop's sub-key, the query times and the
        addresses of ``binding``'s graph tensors."""
        values = [np.asarray(seeds).astype(np.int32 if self._id_dtype == torch.int32
                                           else np.int64),
                  qrandom.hop_key_words(key, self._hops)]
        values += [np.asarray(e, np.float32) for e in extra]
        if self._graph_words:
            values.append(np.asarray([g.data_ptr() for g in binding[2]], np.int64))
        return stage(values, fields, nbytes, pin)

    def _step(self, model, binding, inputs) -> torch.Tensor:
        """The step on ``inputs``, the `byte_views` of `_input_fields`."""
        strict_float32()
        table, index_map, graph = binding
        seeds, keys, *rest = inputs
        if self._graph_words:
            graph = DeviceGraph(graph, rest.pop())
        with torch.inference_mode():
            return self._fn(model.eval(), keys, seeds, table, index_map, graph, *rest)

    def _eager(self, bucket, model, binding, key, seeds, extra) -> np.ndarray:
        fields, nbytes = self._fields(bucket)
        staging = self._stage(fields, nbytes, key, seeds, extra, binding, pin=False)
        return to_host(self._step(model, binding, byte_views(staging, fields)))

    def _capture(self, bucket: int, binding: Binding, model: nn.Module) -> _Capture:
        """Capture ``bucket``'s step against ``binding`` (caller holds
        ``_lock``): one eager run on a side stream, then the capture, both
        on a stream of their own (a flush replaying meanwhile runs on
        ``_stream``)."""
        dev = self._device
        cap = _Capture()
        cap.fields, nbytes = self._fields(bucket)
        warm_t = (np.full(bucket, np.inf, np.float32),) if self._temporal else ()
        cap.static = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        cap.static.copy_(self._stage(cap.fields, nbytes, self._WARM_KEY,
                                     np.zeros(bucket, np.int64), warm_t, binding, pin=False))
        inputs = byte_views(cap.static, cap.fields)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        if binding.ready is not None:
            side.wait_event(binding.ready)
        with torch.cuda.stream(side):
            self._step(model, binding, inputs)
            side.synchronize()
            cap.graph = torch.cuda.CUDAGraph()
            cap.out, tally = capture(cap.graph, side,
                                     lambda: self._step(model, binding, inputs))
        cap.tally = self._record(tally)
        cap.lock = threading.Lock()
        torch.cuda.current_stream(dev).wait_stream(side)
        return cap

    # -- what the graphs did (`replayed_launches`, `reset_replays`: GraphBook) ---

    def graph_stats(self) -> Dict[str, object]:
        """The bound graphs: how many, the kernels of each (by bucket), the
        seconds their captures took, their memory pools' bytes on the card
        (reserved segments), and every graph's replays since the last
        `reset_replays`; ``captured`` counts every capture made."""
        caps = self._binding.captures
        return {"graphs": len(caps), "captured": len(self._tallies),
                "kernels": {b: c.tally.kernels for b, c in sorted(caps.items())},
                "capture_s": sum(c.tally.seconds for c in caps.values()),
                "pool_bytes": self.pool_bytes(c.graph for c in caps.values()),
                "replays": sum(t.replays for t in self._tallies)}


def time_eval_split(model: nn.Module, sampler, feature, padded_batch,
                    iters: int = 10) -> Tuple[float, float]:
    """Seconds a call of the split step's two stages, ``(t_sample_s,
    t_forward_s)``, at this batch shape: one untimed `sample_batch` and
    `forward_logits` first, then ``iters`` samples and ``iters`` forwards
    of the last sample, each leg synchronized once at its end (the
    reference's method; it takes ``1 + iters`` keys of the sampler)."""
    def sync(t: torch.Tensor) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    ds = sample_batch(sampler, padded_batch)
    sync(ds.n_id)
    sync(forward_logits(model, feature, ds))
    t0 = time.perf_counter()
    for _ in range(iters):
        ds = sample_batch(sampler, padded_batch)
    sync(ds.n_id)
    t_sample = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = forward_logits(model, feature, ds)
    sync(out)
    return t_sample, (time.perf_counter() - t0) / iters


def _read_back(out: torch.Tensor):
    """Queue ``out``'s copy to pinned host memory on the current stream;
    returns the host tensor and the CUDA event after the copy."""
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return host, done


def to_host(out: torch.Tensor) -> np.ndarray:
    """Read a result back to the host. On the card the copy goes to
    pinned memory on the current stream and the host reads it only after
    the copy's CUDA event, so another thread's work queued behind it is
    not waited for."""
    if not out.is_cuda:
        return out.numpy()
    host, done = _read_back(out)
    done.synchronize()
    return host.numpy().copy()

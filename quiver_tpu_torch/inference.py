"""Sampled inference and the fused serve step — the port of the serving
half of ``quiver_tpu/inference.py``.

The JAX package passes a flax module and its params separately; here a
model is an ``nn.Module`` holding its weights (`bind_params` makes one
from a ``state_dict``), so every function below takes the bound module.
All of them run the model in eval mode with TF32 off
(`strict_float32`): float32 products stay float32, as in the reference.

- `sample_batch` + `forward_logits` == `batch_logits`: the split path;
- `make_serve_step`: sample + gather + forward as one step function, the
  engine's fused path; `BucketPrograms` keeps one entry per bucket with
  the hard miss after `seal()`. Each bucket stays a plain call in this
  slice (CUDA-graph capture per bucket is later work).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from . import random as qrandom
from .feature import gather_rows


def strict_float32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions (the
    reference computes in full float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bind_params(model: nn.Module, params=None, device=None) -> nn.Module:
    """An eval-mode module with ``params`` (a ``state_dict``, e.g. from
    `convert.sage_params_from_flax`) loaded into a copy of ``model``, on
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
    sample's device goes through `gather_rows`; a numpy table is
    clipped and taken on the host, then moved."""
    if isinstance(feature, torch.Tensor):
        return gather_rows(feature, n_id)
    if isinstance(feature, np.ndarray):
        ids = np.clip(n_id.cpu().numpy(), 0, feature.shape[0] - 1)
        return torch.from_numpy(feature[ids]).to(n_id.device)
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
    a dense ``[R, D]`` table and no map. Raises TypeError for features
    whose lookup is host-side."""
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


class BucketPrograms:
    """The fused serve step per bucket. `compile_bucket` runs a bucket
    once on a fixed key (the sampler's key stream is untouched) so that
    the kernels are built and the allocator warm; `seal()` turns a later
    call at an unwarmed bucket into a hard RuntimeError."""

    _WARM_KEY = qrandom.fold_in(qrandom.key(0), 0)

    def __init__(self, sampler, feature):
        self._fn, self._graph, self._id_dtype = make_serve_step(sampler)
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
        self._run(model, self._WARM_KEY, np.zeros(bucket, np.int64))
        if self._table.is_cuda:
            torch.cuda.synchronize(self._table.device)
        self._buckets.add(bucket)

    def _run(self, model, key, seeds):
        strict_float32()
        with torch.inference_mode():
            return self._fn(model.eval(), key, self._sampler.as_seeds(seeds), self._table,
                            self._map, self._graph)

    def __call__(self, bucket: int, model: nn.Module, key, seeds) -> torch.Tensor:
        """Sample + gather + forward of one padded seed batch at
        ``bucket``; misses register lazily before `seal()` and raise
        after."""
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
        return self._run(model, key, seeds)


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

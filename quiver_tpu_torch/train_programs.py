"""Captured training steps — the counterpart of the JAX package's jitted
train steps (the example's ``train_step``, ``pipeline.make_tiered_train_step``
and ``quant.lookup.make_quantized_train_step``): `TrainPrograms` keeps one
captured ``torch.cuda.CUDAGraph`` a step signature, as ``jax.jit`` keeps one
program a shape.

- `TrainPrograms`: a step body (forward, loss, backward, optimizer step)
  and its graphs. A signature is the shapes and dtypes of the step's
  device inputs and host inputs (and what a factory adds, such as the
  sampler's caps). The first call of a signature runs the body once eagerly
  on a side stream (kernels built, cuBLAS up, the optimizer's state made),
  puts the weights, the optimizer's state and the dropout generator back
  as they were, then captures the body on that stream; every call, the
  first included, then copies its inputs into the graph's static buffers
  (device tensors one copy each, the host arrays packed into one pinned
  buffer and one host-to-device copy) and replays the graph. A capture that
  fails, or a replay that CUDA refuses, raises: nothing runs the eager step
  in its place. With ``device="cpu"`` the same object runs the body eagerly
  on the same staged inputs: that is the CPU form.
- `make_train_step`: ``step(x, adjs, y, generator) -> loss``, the example's
  ``train_step``.
- `make_sample_train_step`: the whole sampled leg, sample (the draws read
  their hop key words from the card), gather, forward, backward and Adam,
  in one graph a batch size; with ``auto_grow_caps``, a host-mode sampler
  or a feature that reads rows on the host, the sample and gather stay
  outside and the rest is `make_train_step`'s graph (the JAX example's
  split).

The card needs an optimizer that keeps its state there (``torch.optim.
Adam(..., capturable=True)``); others are refused. The graphs bake in the
addresses of the weights, the optimizer's state, the dropout generator and
the tables: after anything that replaces one of them (``optimizer.
load_state_dict``, a new table) call ``invalidate()``; a call finds a
replaced weight or state tensor and raises rather than replay against freed
memory. ``reset()`` frees the graphs and their memory pools. A step's
Python scalars (the learning rate, the dropout rate) are baked in as well.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import random as qrandom
from .feature import Feature
from .graphs import GraphBook, byte_fields, byte_views, capture, stage
from .inference import lookup_features
from .pyg.sage_sampler import (sample_and_gather_dedup, sample_and_gather_fused,
                               sample_dense_fused, sample_dense_pure)
from .utils import resolve_device

MODES = ("dense", "fused", "dedup")


def require_capturable(optimizer) -> None:
    """Refuse an optimizer whose step cannot be captured: its state must
    live on the card (``capturable=True``, which Adam and AdamW take)."""
    if not optimizer.param_groups or not all(g.get("capturable", False)
                                             for g in optimizer.param_groups):
        raise ValueError(
            f"a training step captured on the card needs an optimizer that keeps its state "
            f"there: build it as torch.optim.Adam(params, lr=..., capturable=True) "
            f"(got {type(optimizer).__name__} without capturable=True)")


def descend(model: nn.Module, optimizer, x: torch.Tensor, adjs, y: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """One optimizer step on the batch: the forward with ``train=True``
    (dropout drawn from ``generator``), cross-entropy against ``y``,
    backward and ``optimizer.step()``. Returns the loss, detached."""
    loss = F.cross_entropy(model(x, adjs, train=True, generator=generator),
                           y.to(torch.int64))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _leaves(tree):
    """The tensors of nested tuples (NamedTuples included), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)


def _spec_tree(tree):
    """A hashable signature of nested tuples: each tensor's shape, dtype
    and device, every other leaf (ints, None) as it is."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, tuple(_spec_tree(t) for t in tree)
    return tree


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by the iterator
    ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, tensors) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, tensors) for t in tree)
    return tree


def _host_fields(host):
    """The `graphs.byte_fields` of the host inputs (numpy arrays)."""
    return byte_fields([(torch.from_numpy(np.zeros(0, a.dtype)).dtype, a.shape) for a in host])


class _Capture:
    """One signature's graph: its static device inputs, the static buffer
    of its host inputs and their layout, its outputs and its
    `graphs.Tally`."""

    __slots__ = ("graph", "static", "host_static", "fields", "nbytes", "out", "tally")


class TrainPrograms(GraphBook):
    """A training step, one captured CUDA graph a step signature on the
    card, run eagerly on the CPU (see the module's docstring).

    ``body(inputs, host, generator)`` is the step: ``inputs`` the nested
    tuple of device tensors a call passes (their static copies under
    capture), ``host`` the typed views of the call's host arrays on the
    step's device; it returns a tensor or a tuple of tensors (the loss
    first). ``bound()`` gives the tables the body reads besides its inputs
    and the model's weights (their addresses are baked in too), and
    ``signature()`` what else a graph depends on (hashable)."""

    def __init__(self, body: Callable, model: nn.Module, optimizer, device,
                 bound: Callable[[], Sequence[torch.Tensor]] = tuple,
                 signature: Callable[[], object] = lambda: None):
        super().__init__()  # the tallies: one a capture, kept after its graph is gone
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            require_capturable(optimizer)
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"the model's weights live on {p.device}, the step on "
                                 f"{self.device}")
        self._body, self.model, self.optimizer = body, model, optimizer
        self._bound, self._signature = bound, signature
        self._graphs: Dict[object, _Capture] = {}
        self._generator = None  # the dropout generator the graphs were captured with
        self._baked = None  # the addresses the graphs read
        self._lock = threading.Lock()

    def __call__(self, inputs=(), host=(), generator: Optional[torch.Generator] = None):
        """Run the step on device tensors ``inputs`` (nested tuples) and
        host arrays ``host`` (numpy): the graph of their signature replayed
        (captured first when new), or the body on the CPU. Returns the
        body's outputs, copied out of the graph's buffers."""
        host = tuple(np.ascontiguousarray(a) for a in host)
        if not self._cuda:
            fields, nbytes = _host_fields(host)
            return self._body(inputs, byte_views(stage(host, fields, nbytes, False), fields),
                              generator)
        sig = (_spec_tree(inputs), tuple((a.dtype.str, a.shape) for a in host),
               self._signature())
        with self._lock:
            if self._graphs and self._addresses() != self._baked:
                raise RuntimeError(
                    "a tensor the training graphs read was replaced (optimizer."
                    "load_state_dict, new weights or a new table): call invalidate() on the "
                    "step first, or load through the step's load_state_dict")
            if self._generator is not None and generator is not self._generator:
                raise ValueError("the training graphs draw dropout from the generator they "
                                 "were captured with: pass that one, or invalidate() first")
            cap = self._graphs.get(sig)
            if cap is None:
                cap = self._graphs[sig] = self._capture(inputs, host, generator)
                self._generator = generator
                self._baked = self._addresses()
            with torch.no_grad():
                for s, t in zip(cap.static, _leaves(inputs)):
                    s.copy_(t)
                if host:
                    cap.host_static.copy_(stage(host, cap.fields, cap.nbytes, True),
                                          non_blocking=True)
            cap.graph.replay()
            cap.tally.replays += 1
            out = tuple(o.clone() for o in cap.out)
        return out if len(out) > 1 else out[0]

    # -- the graphs' lifetime ------------------------------------------------------

    def invalidate(self) -> None:
        """Drop every graph (and the generator they drew from): the next
        call of each signature captures anew against the tensors bound
        then. Run it after anything that replaces a tensor the graphs read
        (``optimizer.load_state_dict``, a new table). The launch tallies
        stay."""
        with self._lock:
            for cap in self._graphs.values():
                cap.graph.reset()
            self._graphs.clear()
            self._generator = self._baked = None
            # the last capture's gradients live in its pool
            self.optimizer.zero_grad(set_to_none=True)

    def reset(self) -> None:
        """Free the graphs and their memory pools (`invalidate`) and set the
        tallies to nothing."""
        self.invalidate()
        self._tallies = []

    # -- internals ----------------------------------------------------------------

    def _addresses(self):
        """The addresses of every tensor the graphs bake in besides their
        inputs: the weights, the optimizer's state, the bound tables."""
        out = []
        for p in self.model.parameters():
            out.append(p.data_ptr())
            out += [v.data_ptr() for v in self.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
        out += [t.data_ptr() for t in self._bound() if t is not None]
        return tuple(out)

    def _snapshot(self, generator):
        params = [p.detach().clone() for p in self.model.parameters()]
        state = {p: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                 for p, st in self.optimizer.state.items()}
        return params, state, None if generator is None else generator.get_state()

    def _restore(self, saved, generator) -> None:
        """Put back what the warm-up step changed: the weights, the
        optimizer's state (state the warm-up made starts at zero, as
        Adam's does) and the generator's offset."""
        params, state, gen_state = saved
        with torch.no_grad():
            for p, v in zip(self.model.parameters(), params):
                p.copy_(v)
            for p, st in self.optimizer.state.items():
                before = state.get(p)
                for k, v in st.items():
                    if not isinstance(v, torch.Tensor):
                        if before is not None:
                            st[k] = before[k]
                    elif before is None:
                        v.zero_()
                    else:
                        v.copy_(before[k])
        if generator is not None:
            generator.set_state(gen_state)

    def _capture(self, inputs, host, generator) -> _Capture:
        """One eager run of the body on a side stream, everything it
        changed put back, then the capture on that stream (caller holds
        ``_lock``)."""
        dev = self.device
        cap = _Capture()
        cap.static = [t.detach().clone() for t in _leaves(inputs)]
        static_inputs = _rebuild(inputs, iter(cap.static))
        cap.fields, cap.nbytes = _host_fields(host)
        cap.host_static = torch.empty(cap.nbytes, dtype=torch.uint8, device=dev)
        cap.host_static.copy_(stage(host, cap.fields, cap.nbytes, False))
        views = byte_views(cap.host_static, cap.fields)
        saved = self._snapshot(generator)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(static_inputs, views, generator)
            self._restore(saved, generator)
            self.optimizer.zero_grad(set_to_none=True)  # the graph's backward makes its own
            cap.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                cap.graph.register_generator_state(generator)
            side.synchronize()
            # the graph's private pool cannot take the general pool's cached
            # blocks (the warm-up's activations among them): hand them back
            torch.cuda.empty_cache()
            out, tally = capture(cap.graph, side,
                                 lambda: self._body(static_inputs, views, generator))
        torch.cuda.current_stream(dev).wait_stream(side)
        cap.out = out if isinstance(out, tuple) else (out,)
        cap.tally = self._record(tally)
        return cap

    # -- what the graphs did (`replayed_launches`, `reset_replays`: GraphBook) -----

    def graph_stats(self) -> Dict[str, object]:
        """The graphs held now and their memory pools' bytes on the card
        (reserved segments); ``captured`` counts every capture since the
        last `reset`, with their seconds, and ``replays`` every replay
        since the last `reset_replays`."""
        return {"graphs": len(self._graphs), "captured": len(self._tallies),
                "capture_s": sum(t.seconds for t in self._tallies),
                "pool_bytes": self.pool_bytes(c.graph for c in self._graphs.values()),
                "replays": sum(t.replays for t in self._tallies),
                "launches_per_replay": [dict(t.counts) for t in self._tallies]}


class TrainStep:
    """A step built on `TrainPrograms`: called as its factory says; carries
    ``model``, ``optimizer`` (what `pipeline.TrainPipeline` checkpoints)
    and ``programs``."""

    def __init__(self, programs: TrainPrograms, call: Callable):
        self.programs = programs
        self.model, self.optimizer = programs.model, programs.optimizer
        self._call = call

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def invalidate(self) -> None:
        self.programs.invalidate()

    def reset(self) -> None:
        self.programs.reset()

    def load_state_dict(self, state) -> None:
        """Resume from a checkpoint's ``{"model", "optimizer"}`` state: the
        weights are copied in place, the optimizer's state is replaced,
        so the graphs are captured anew (`invalidate`)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.invalidate()


def make_train_step(model: nn.Module, optimizer, device=None) -> TrainStep:
    """``step(x, adjs, y, generator=None) -> loss``: forward with
    ``train=True``, cross-entropy, backward and ``optimizer.step()`` on a
    gathered batch, one captured graph a shape of ``(x, adjs, y)`` on the
    card (the JAX example's jitted ``train_step``). ``device`` defaults to
    the card; ``device="cpu"`` runs the step eagerly."""
    dev = resolve_device(device)

    def body(inputs, host, generator):
        x, adjs, y = inputs
        return descend(model, optimizer, x, adjs, y, generator)

    programs = TrainPrograms(body, model, optimizer, dev)

    def call(x, adjs, y, generator: Optional[torch.Generator] = None):
        return programs((x, tuple(adjs), y), generator=generator)

    return TrainStep(programs, call)


def _in_step_rows(source) -> bool:
    """Whether ``source``'s rows can be gathered inside a graph: a table
    on the device, or a `Feature` whose tiers are the device and pinned
    host memory (a disk tier or an adaptive store reads on the host)."""
    if isinstance(source, torch.Tensor):
        return True
    return (isinstance(source, Feature) and source.tier_store is None
            and source.shard_tensor is not None and source.shard_tensor.disk_shard is None)


def _source_tensors(source):
    if isinstance(source, torch.Tensor):
        return (source,)
    st = source.shard_tensor
    return (st.device_rows, st.cpu_tensor, source._order_dev)


def make_sample_train_step(sampler, source, labels, model: nn.Module, optimizer,
                           mode: str = "dense") -> TrainStep:
    """``step(seeds, generator=None) -> (loss, sampled_edges)``: one
    training step on a seed batch (numpy), sampled with the sampler's next
    key, the rows gathered from ``source``, the labels of the clamped seeds.
    ``mode`` "dense": ``sampler.sample_dense``'s pipeline, then the rows of
    a `Feature` (`inference.lookup_features`) or of a ``[N, D]`` table;
    "fused" and "dedup": `sample_and_gather_fused` / `sample_and_gather_dedup`
    over a ``[N, D]`` table (the sampler's caps apply to "dedup").

    On the card the whole leg is one captured graph a batch size: the
    draws read their hop key words (`random.hop_key_words` of the
    sampler's next key) from the card, staged with the seeds in one copy,
    so the key stream advances as the eager path's and the draws are its
    draws. A "dense" step over a sampler with ``auto_grow_caps`` (the ladder
    reads ``cap_overflow`` on the host and resamples), a host-mode sampler
    (the engine draws on the host) or a feature that reads rows on the host
    samples and gathers eagerly and captures the rest (`make_train_step`).
    The step runs where the sampler runs."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if sampler.temporal is not None or sampler.stream is not None:
        raise TypeError("make_sample_train_step takes a frozen, non-temporal sampler")
    if sampler.on_host and mode != "dense":
        raise TypeError(f"mode {mode!r} samples inside the step; a host-mode sampler "
                        f"(mode={sampler.mode!r}) takes mode='dense'")
    dev = sampler.device
    labels = torch.as_tensor(labels).to(dev, torch.int64)
    n = labels.shape[0]
    if mode != "dense" and not isinstance(source, torch.Tensor):
        raise TypeError(f"mode {mode!r} gathers from an [N, D] table tensor")

    def targets(seeds: torch.Tensor) -> torch.Tensor:
        return labels[torch.clamp(seeds.to(torch.int64), 0, n - 1)]

    def edges(ds) -> torch.Tensor:
        return sum(a.mask.sum() for a in ds.adjs)

    if mode == "dense" and (sampler.auto_grow_caps or sampler.on_host
                            or not _in_step_rows(source)):
        inner = make_train_step(model, optimizer, dev)

        def split_step(seeds, generator: Optional[torch.Generator] = None):
            ds = sampler.sample_dense(seeds)
            loss = inner(lookup_features(source, ds.n_id), ds.adjs,
                         targets(ds.n_id[:ds.batch_size]), generator)
            return loss, edges(ds)

        step = TrainStep(inner.programs, split_step)
        step.captures_sample = False
        return step

    graph, bind, id_dtype = sampler.fused_sample_spec()
    sample_fn = bind(graph)
    sizes, hops = sampler.sizes, len(sampler.sizes)
    np_ids = np.int32 if id_dtype == torch.int32 else np.int64

    def body(inputs, host, generator):
        seeds, keys = host
        caps = sampler.caps  # the signature holds them
        if mode == "fused":
            ds, x = sample_and_gather_fused(None, None, source, keys, seeds, sizes,
                                            sample_fn=sample_fn)
        elif mode == "dedup":
            ds, x = sample_and_gather_dedup(None, None, source, keys, seeds, sizes, caps=caps,
                                            sample_fn=sample_fn)
        else:
            if sampler.dedup:
                ds = sample_dense_pure(None, None, keys, seeds, sizes, caps, sample_fn=sample_fn)
            else:
                ds = sample_dense_fused(None, None, keys, seeds, sizes, sample_fn=sample_fn)
            x = lookup_features(source, ds.n_id)
        return descend(model, optimizer, x, ds.adjs, targets(seeds), generator), edges(ds)

    programs = TrainPrograms(
        body, model, optimizer, dev,
        bound=lambda: (labels,) + tuple(graph) + _source_tensors(source),
        signature=lambda: sampler.caps)

    def call(seeds, generator: Optional[torch.Generator] = None):
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy()
        seeds = np.asarray(seeds).astype(np_ids).reshape(-1)
        words = qrandom.hop_key_words(sampler.next_key(), hops)
        return programs((), (seeds, words), generator)

    step = TrainStep(programs, call)
    step.captures_sample = True
    return step

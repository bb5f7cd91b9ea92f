"""``ForkingPickler`` reducers for `Feature` and `GraphSageSampler` — the
port of ``quiver_tpu/multiprocessing/reductions.py``.

A `Feature` or `GraphSageSampler` passed to a child process (the arguments
of a ``spawn`` child, a ``multiprocessing`` queue) travels as its
``share_ipc`` handle and is rebuilt there by ``new_from_ipc_handle`` /
``lazy_from_ipc_handle``. Nothing is copied: device tensors cross as CUDA
IPC handles (torch's own reducers in ``torch.multiprocessing``), host arrays
and a tiered feature's host tail as shared memory (registered with the card
in the child), a disk tier by its path. The child must run on the card the
tensors live on.

Start children with ``multiprocessing.get_context("spawn")``: a child
started by ``fork`` after the parent touched CUDA cannot use the card, and
torch raises at its first CUDA call there. The producer must keep the
shared tensors alive until its children are done with them: torch counts
the references a child holds to each CUDA block it received and frees the
block only when they are gone, so a producer that exits first leaves its
children's mappings invalid (torch warns "Producer process has been
terminated before all shared CUDA tensors released").
"""

from __future__ import annotations

from multiprocessing.reduction import ForkingPickler

import torch.multiprocessing  # noqa: F401 (installs torch's tensor and storage reducers)

from ..feature import Feature
from ..pyg.sage_sampler import GraphSageSampler


def rebuild_feature(ipc_handle: dict) -> Feature:
    """The child's side of `reduce_feature`."""
    return Feature.lazy_from_ipc_handle(ipc_handle.get("rank", 0), ipc_handle)


def reduce_feature(feature: Feature):
    return (rebuild_feature, (feature.share_ipc(),))


def rebuild_pyg_sampler(cls, ipc_handle: tuple) -> GraphSageSampler:
    """The child's side of `reduce_pyg_sampler`: ``cls`` rebuilt from the
    handle, its key stream at call 0."""
    return cls.lazy_from_ipc_handle(ipc_handle)


def reduce_pyg_sampler(sampler: GraphSageSampler):
    return (rebuild_pyg_sampler, (type(sampler), sampler.share_ipc()))


def init_reductions() -> None:
    """Register the reducers on ``ForkingPickler`` (idempotent)."""
    ForkingPickler.register(Feature, reduce_feature)
    ForkingPickler.register(GraphSageSampler, reduce_pyg_sampler)

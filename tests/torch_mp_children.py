"""Child-process bodies of tests/test_torch_multiprocessing.py. This module
imports torch, numpy and the port only (no jax), so a spawned child starts
quickly; each body puts its result, or the traceback of what it raised, on
the queue it is given."""

import traceback

import numpy as np
import torch

import quiver_tpu_torch.multiprocessing  # noqa: F401 (the reducers)


def _report(q, fn):
    try:
        q.put(("ok", fn()))
    except BaseException:  # the parent re-raises it with the traceback
        q.put(("error", traceback.format_exc()))


def feature_rows(holder, ids, q):
    """``holder["feature"][ids]`` as numpy, and whether its host tail (if
    any) lies in shared memory."""
    def run():
        feat = holder["feature"]
        tail = feat.shard_tensor.cpu_tensor
        return feat[ids].numpy(), tail is None or tail.is_shared()
    _report(q, run)


def feature_rows_from_queue(in_q, ids, q):
    """The same, for a feature that arrives through a queue."""
    def run():
        return in_q.get(timeout=60)[ids].numpy()
    _report(q, run)


def sampler_draw(holder, q):
    """``sample(np.arange(8))`` of ``holder["sampler"]`` as numpy, and
    whether a device graph it holds came from shared memory (handed over,
    not rebuilt)."""
    def run():
        s = holder["sampler"]
        n_id, bs, adjs = s.sample(np.arange(8))
        graph = None if s.on_host else all(t.is_shared() for t in s.lazy_init_quiver())
        return (n_id.numpy(), bs, [(a.edge_index.numpy(), a.size) for a in adjs], graph,
                all(t.is_shared() for t in s.csr_topo._shared.values()))
    _report(q, run)


def cuda_tiered_gather(handle, ids, q):
    """On the card: the `ShardTensor` of a `share_ipc` handle (device rows
    mapped, the shared tail registered here), its K3t gather of ``ids``,
    the plain version over the same tiers, and whether the tail is
    page-locked here."""
    from quiver_tpu_torch.shard_tensor import ShardTensor, tiered_gather_plain

    def run():
        st = ShardTensor.new_from_share_ipc(handle, 0)
        dev_ids = torch.as_tensor(ids, dtype=torch.int32, device=st.device)
        got = st.gather(dev_ids)
        want = tiered_gather_plain(st.device_rows, st.cpu_tensor, dev_ids, st.shape[0])
        return got.cpu().numpy(), want.cpu().numpy(), st.cpu_tensor.is_pinned()
    _report(q, run)


def cuda_tiled_draw(holder, seeds, q):
    """On the card: the first dense draw (K1, K2) of a handed tiled sampler,
    and this process's launch counts (no K12 build: the tile table is the
    parent's, mapped)."""
    from quiver_tpu_torch import _kernels

    def run():
        ds = holder["sampler"].sample_dense(seeds)
        return (ds.n_id.cpu().numpy(), int(ds.count),
                [a.mask.cpu().numpy() for a in ds.adjs],
                [a.cols.cpu().numpy() for a in ds.adjs], _kernels.counts())
    _report(q, run)

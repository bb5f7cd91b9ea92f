"""Parity of the port's sampling-probability estimate and the placement it
feeds with quiver_tpu's, on the CPU: `ops.sample.neighbor_prob` and
`sample_prob` (K11's plain version), `GraphSageSampler.sample_prob`, the
transposed graph the card's kernel pulls over, `utils.heat_reorder` and
`partition`.

Shapes: a few thousand nodes with a hub whose in-edges span more of the
kernel's ranges than it adds one by one, a node that spans a few, nodes
without in-edges and duplicate edges. Inputs come from
seeded numpy and go through both packages. Bars:
- `neighbor_prob_plain` and `sample_prob` bit-equal to the JAX functions:
  both add each node's sources one by one in edge order (the JAX function
  scatter-adds the edge list in order, the plain version ``index_add_``s
  it, which on the CPU is the same sequential sum), from the same float32
  weights;
- the kernel's order of additions (merge-path ranges of node ends and
  edges, a lane's sequential sum, a segmented scan over the lanes, the
  parts of a node that crosses ranges in range order), replayed in numpy
  (`torch_fixtures.prob_kernel_order`), within rtol 1e-5 of the
  sequential sum: both round float32 sums of positive terms, in different
  orders; and within its own depth bound (`neighbor_prob_depth`) of the
  float64 sum of the same terms;
- reorders, partitions and artifacts bit-equal."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from quiver_tpu import CSRTopo as JCSRTopo
from quiver_tpu import partition as jpartition
from quiver_tpu.ops.sample import neighbor_prob as j_neighbor_prob
from quiver_tpu.ops.sample import sample_prob as j_sample_prob
from quiver_tpu.pyg.sage_sampler import GraphSageSampler as JSampler
from quiver_tpu.utils import heat_reorder as j_heat_reorder
from quiver_tpu_torch import CSRTopo, GraphSageSampler, partition
from quiver_tpu_torch.ops.sample import (
    PROB_LANE_ITEMS,
    PROB_SEQ_SPAN,
    PROB_WARP_ITEMS,
    build_transposed_host,
    neighbor_prob,
    neighbor_prob_depth,
    neighbor_prob_plain,
    sample_prob,
)
from quiver_tpu_torch.utils import heat_reorder
from torch_fixtures import prob_kernel_order

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

N, E, HUB, MID = 3000, 40000, 7, 13
SIZES = (15, 10, 5)


def _graph(seed=0):
    """A random graph plus a hub with 5,000 in-edges (about 10 of the
    kernel's ranges), a node with 700 (about 2), a source with 4,000
    out-edges, duplicate edges and isolated nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N - 50, E)  # the last 50 nodes have no edges
    dst = rng.integers(0, N - 50, E)
    dst[:5000] = HUB
    dst[5000:5700] = MID
    src[-4000:] = 11
    src = np.concatenate([src, [3, 3, 3]])
    dst = np.concatenate([dst, [9, 9, 9]])  # duplicate edges
    return np.stack([src, dst])


def _csr(edge_index):
    t = CSRTopo(edge_index=edge_index, num_nodes=N)
    return t.indptr, t.indices


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", SIZES)
def test_neighbor_prob_plain_bit_equal_to_reference(id_dtype, k):
    indptr, indices = _csr(_graph())
    prob = np.random.default_rng(k).random(N).astype(np.float32)
    want = np.asarray(j_neighbor_prob(jnp.asarray(indptr.astype(np.int32)),
                                      jnp.asarray(indices.astype(np.int32)),
                                      jnp.asarray(prob), k))
    got = neighbor_prob(torch.from_numpy(indptr.astype(id_dtype)),
                        torch.from_numpy(indices.astype(id_dtype)), torch.from_numpy(prob), k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[HUB]) > 0 and float(got[N - 1]) == 0.0  # no in-edges


def test_sample_prob_and_the_sampler_bit_equal_to_reference():
    edge_index = _graph(1)
    indptr, indices = _csr(edge_index)
    train = np.random.default_rng(2).choice(N, 400, replace=False)
    want = np.asarray(j_sample_prob(jnp.asarray(indptr.astype(np.int32)),
                                    jnp.asarray(indices.astype(np.int32)), SIZES,
                                    jnp.asarray(train)))
    got = sample_prob(torch.from_numpy(indptr), torch.from_numpy(indices), SIZES,
                      torch.from_numpy(train))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[train].min()) >= 1.0
    js = JSampler(JCSRTopo(edge_index=edge_index, num_nodes=N), sizes=list(SIZES), mode="TPU")
    ts = GraphSageSampler(CSRTopo(edge_index=edge_index, num_nodes=N), SIZES, device="cpu")
    n = ts.csr_topo.node_count
    np.testing.assert_array_equal(ts.sample_prob(train, n).numpy(),
                                  np.asarray(js.sample_prob(train, n)))


def test_transposed_graph_lists_sources_in_stable_edge_order_and_tiles_cover_it():
    """The transposed graph, and the kernel's merge-path ranges over it:
    consecutive, PROB_WARP_ITEMS items each but the last, each starting
    inside a node's edges, together covering every edge and node end."""
    indptr, indices = _csr(_graph())
    t = build_transposed_host(indptr, indices)
    src = np.repeat(np.arange(N), np.diff(indptr))
    order = np.argsort(indices, kind="stable")  # the reference's visiting order
    np.testing.assert_array_equal(t.tsrc.numpy(), src[order])
    np.testing.assert_array_equal(np.diff(t.tindptr.numpy()), np.bincount(indices, minlength=N))
    np.testing.assert_array_equal(t.deg.numpy(), np.diff(indptr))
    tindptr = t.tindptr.numpy()
    _, start = prob_kernel_order(tindptr, t.tsrc.numpy(), np.ones(N, np.float32),
                                 PROB_LANE_ITEMS, PROB_SEQ_SPAN)
    e = tindptr[-1]
    np.testing.assert_array_equal(np.stack([t.range_node.numpy(), t.range_edge.numpy()], 1),
                                  start)
    assert tuple(start[0]) == (0, 0) and tuple(start[-1]) == (N, e)
    items = np.diff(start.sum(axis=1))
    assert (items[:-1] == PROB_WARP_ITEMS).all() and 0 < items[-1] <= PROB_WARP_ITEMS
    assert (np.diff(start, axis=0) >= 0).all()
    v, at = start[:-1, 0], start[:-1, 1]
    assert ((tindptr[v] <= at) & (at <= tindptr[v + 1])).all()
    hub_ranges = (HUB + tindptr[HUB + 1]) // PROB_WARP_ITEMS - (HUB + tindptr[HUB]) // PROB_WARP_ITEMS
    assert hub_ranges + 1 > PROB_SEQ_SPAN
    # out-of-range destinations are left out, as the reference drops them
    bad = build_transposed_host(np.array([0, 2, 3]), np.array([1, 5, -1]))
    assert bad.tsrc.tolist() == [0] and bad.tindptr.tolist() == [0, 0, 1]


def _kernel_order(t, w):
    """`csrc/prob.cu`'s additions in numpy float32 (K11's order)."""
    return prob_kernel_order(t.tindptr.numpy(), t.tsrc.numpy(), w, PROB_LANE_ITEMS,
                             PROB_SEQ_SPAN)[0]


def test_the_kernels_order_of_additions_agrees_with_the_sequential_sum():
    indptr, indices = _csr(_graph(3))
    prob = np.random.default_rng(4).random(N).astype(np.float32)
    t = build_transposed_host(indptr, indices)
    deg = np.diff(indptr).astype(np.float32)
    w = prob * np.minimum(np.float32(10) / np.maximum(deg, np.float32(1)), np.float32(1))
    got = _kernel_order(t, w)
    want = neighbor_prob_plain(torch.from_numpy(indptr), torch.from_numpy(indices),
                               torch.from_numpy(prob), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[HUB] != 0 and got[MID] != 0 and (got[want == 0] == 0).all()
    assert (got[N - 50:] == 0).all()  # no in-edges


def test_the_kernels_order_lies_within_its_depth_bound_of_the_exact_sum():
    """The card's check: K11 against the float64 sum of the same float32
    terms, within ``d u / (1 - d u)`` relative (`neighbor_prob_depth`). The
    bound is tight enough at the hub that one of its ranges dropped there
    fails it."""
    indptr, indices = _csr(_graph(5))
    prob = np.random.default_rng(6).random(N).astype(np.float32)
    t = build_transposed_host(indptr, indices)
    deg = np.diff(indptr).astype(np.float32)
    w = prob * np.minimum(np.float32(15) / np.maximum(deg, np.float32(1)), np.float32(1))
    got = _kernel_order(t, w).astype(np.float64)
    exact = neighbor_prob_plain(torch.from_numpy(indptr), torch.from_numpy(indices),
                                torch.from_numpy(prob), 15, acc_dtype=torch.float64).numpy()
    np.testing.assert_array_equal(exact, np.bincount(indices, w[np.repeat(np.arange(N),
                                                                          np.diff(indptr))]
                                                     .astype(np.float64), minlength=N))
    d = neighbor_prob_depth(t).numpy().astype(np.float64)
    tindptr = t.tindptr.numpy()
    v = np.arange(N)
    span = (v + tindptr[1:]) // PROB_WARP_ITEMS - (v + tindptr[:-1]) // PROB_WARP_ITEMS + 1
    assert span[HUB] > PROB_SEQ_SPAN >= span[MID] > 1 and span[N - 1] == 1
    assert d[HUB] == PROB_LANE_ITEMS + 6 + -(-span[HUB] // 32) + 5
    assert d[MID] == PROB_LANE_ITEMS + 6 + span[MID] - 1 and d[N - 1] == PROB_LANE_ITEMS + 6
    tol = d * 2.0**-24 / (1 - d * 2.0**-24) * exact
    assert (np.abs(got - exact) <= tol).all()
    # the hub's edges of its second range dropped: far outside the bound
    tsrc = t.tsrc.numpy()
    r = (HUB + tindptr[HUB]) // PROB_WARP_ITEMS + 1
    lo, hi = r * PROB_WARP_ITEMS - HUB, (r + 1) * PROB_WARP_ITEMS - HUB
    assert tindptr[HUB] < lo < hi < tindptr[HUB + 1]
    assert w[tsrc[lo:hi]].astype(np.float64).sum() > 100 * tol[HUB]


def test_neighbor_prob_refuses_a_prob_of_another_shape():
    indptr, indices = _csr(_graph())
    with pytest.raises(ValueError, match="prob must be"):
        neighbor_prob(torch.from_numpy(indptr), torch.from_numpy(indices), torch.zeros(N + 1), 5)


@pytest.mark.parametrize("measured", [False, True])
def test_heat_reorder_bit_equal_to_reference(measured):
    edge_index = _graph(5)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((N, 8)).astype(np.float32)
    labels = rng.integers(0, 5, N)
    sets = (rng.choice(N, 100, replace=False), rng.choice(N, 30, replace=False))
    heat = None
    if measured:
        indptr, indices = _csr(edge_index)
        heat = sample_prob(torch.from_numpy(indptr), torch.from_numpy(indices), SIZES,
                           torch.from_numpy(sets[0])).numpy()
    got = heat_reorder(edge_index, N, feats, labels, sets, heat=heat)
    want = j_heat_reorder(edge_index, N, feats, labels, sets, heat=heat)
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
    assert heat_reorder(edge_index, N)[1] is None
    with pytest.raises(ValueError, match="heat has"):
        heat_reorder(edge_index, N, heat=np.zeros(N - 1))


def _probs(parts=3):
    edge_index = _graph(7)
    indptr, indices = _csr(edge_index)
    rng = np.random.default_rng(8)
    return [sample_prob(torch.from_numpy(indptr), torch.from_numpy(indices), (10, 5),
                        torch.from_numpy(rng.choice(N - 200, 150, replace=False))).numpy()
            for _ in range(parts)]


@pytest.mark.parametrize("chunk", [64, 256])
def test_partition_without_replication_bit_equal_to_reference(chunk):
    probs = _probs()
    got_parts, got_book = partition.partition_feature_without_replication(probs, chunk)
    want_parts, want_book = jpartition.partition_feature_without_replication(probs, chunk)
    np.testing.assert_array_equal(got_book, want_book)
    assert len(got_parts) == len(want_parts) == 3
    for g, w in zip(got_parts, want_parts):
        np.testing.assert_array_equal(g, w)
    assert (got_book >= 0).all() and sum(p.size for p in got_parts) == N


def test_quiver_partition_feature_results_and_artifacts_bit_equal(tmp_path):
    probs = _probs(2)
    got = partition.quiver_partition_feature(probs, str(tmp_path / "t"), "4K", 16 * 4)
    want = jpartition.quiver_partition_feature(probs, str(tmp_path / "j"), "4K", 16 * 4)
    for g, w in zip(got[0] + got[1] + [got[2]], want[0] + want[1] + [want[2]]):
        np.testing.assert_array_equal(g, w)
    assert all(c.size == 64 for c in got[1])
    for p in range(2):
        loaded = partition.load_quiver_feature_partition(p, str(tmp_path / "t"))
        jloaded = jpartition.load_quiver_feature_partition(p, str(tmp_path / "j"))
        for a, b in zip(loaded, jloaded):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(loaded[0], got[0][p])
        # the reference can read the port's artifacts and the other way round
        for a, b in zip(jpartition.load_quiver_feature_partition(p, str(tmp_path / "t")), loaded):
            np.testing.assert_array_equal(a, b)

"""The port's CUDA kernels against their plain torch versions, on the card
(marker ``cuda``; they skip where there is no card). This file imports
torch and numpy only, so it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bars: the sampling kernel (tiled and flat), the reindex kernel (n_id,
count, local_seeds; local_nbrs on valid lanes), the gather kernel and the
tiered gather are bit-equal to the plain versions, and to the plain
versions run on the CPU; the neighbor mean and the full-graph mean are
within atol = rtol = 1e-5 (a different sum order). The mean's backward
is within the same of its plain version run on the CPU, which adds the
lanes in ascending order as the kernel does (the plain version on the
card is ``index_add_`` with float atomics, whose order changes from run
to run), and the backward run twice is bit-equal (no float atomics). Shapes are
the serving slice's (B = 64, sizes [15, 10, 5], D = 100 and 256) and the
training slice's (B = 1024 for the backward). The staged pipeline's
kernels — the tiered lookup (K5), the tiered gather over int8 and bfloat16
rows, the dequant gather (K9a) and the quantized tiered lookup (K9b) for
the fp32, bf16 and int8 codecs — are bit-equal to their plain versions on
the card and on the CPU, at a batch-1024 n_id's width (67,584 slots at
B = 64 for the gathers) and D = 100, and at D = 99, whose rows take the
narrower accesses. The out-of-core slice's kernels: the row scatter of a
placement batch (K6) over fp32, bf16 and int8 tables, bit-equal to its
plain version on the card and on the CPU, with drop-padding, and leaving
its input table untouched (copy-on-write); the probability propagation
(K11) on a graph whose hub spans ~78 of the kernel's merge-path ranges,
within rtol 1e-4 (atol 1e-6) of its plain version run on the CPU (a
sequential float32 sum, whose rounding error over a 40,000-edge segment
is ~2e-6 of the sum; the kernel adds in a fixed merge-path order), within
its order's bound of the float64 sum and bit-equal when run twice, and
bit-equal to the numpy replay of its order on a smaller graph;
the tiered gather with a disk tail (K3t's gather, then the staged disk
rows' scatter), bit-equal to the CPU store. The weighted and temporal
slice's kernels at the three hops of a B = 64 sample: the weighted draw
(K7) over the tile layout and the flat CSR at max_deg 512 and 4096, the
temporal draw (K8) at recency 0.02 with and without a cutoff and at
recency 0, each bit-equal to its plain version on the card and on the
CPU (every log and exp is float64 rounded once on both sides), K8 also
equal to the host-masked oracle on its valid lanes; the recency weights
(K8w) bit-equal to their plain version on the card and within an ULP of
the CPU's, and K8 at t = +inf bit-equal to K7 over K8w's tiles. The tile
slice's: the tile build (K12) on ids, weights and timestamps of a graph
with a degree-0 row and a hub, bit-equal to its plain version on the card
and on the CPU and to the host build, with row starts past the end; the
sampling kernels at k = 48, 64 and 300 (tables in shared memory, opted in
above 48 KB at 300), bit-equal to their plain versions. The model zoo's:
the hop-source gather (K14) over float32 and bfloat16 rows of F = 1, 47,
100, 256 and 1,024 bit-equal to its plain version; its gradient (K14b) on
a hop with a hub source row and padded lanes all naming one real row,
bit-equal when run twice and to its plain version run on the CPU (the same
additions in lane order; bfloat16 rounded once from float32 on both
sides), and through autograd; the block out-degree (K14c) with negative
and out-of-range cols, bit-equal to its plain version; the bfloat16 mean
(K4) and its gradient (K4b) equal to the float32 kernels' outputs on the
same values rounded to bfloat16. The host axis's: the grouped unpack (K13c)
of 2 and 3 slabs in float32, bfloat16, int8 and int32 with -0.0 owners and
the grouped draw's pair unpack (K13e), the hot/cold compaction (K13d) with
the cold count below, at and above the budget over 5,077 and 1,081,421
lanes, and the merge (K13d) in float32 and bfloat16, each bit-equal to its
plain version on the card and on the CPU; four rank threads on a
host 2 x dp 1 x ici 2 mesh running the grouped and hot/cold gathers and
the grouped draws against the unsharded rows and draw. The fleet's: the
serve exchange's owner gather (K13f) on [H, L] id slabs with -1 pads, ids
past the block (clamped to its last row), all lanes -1, a one-row block and
an empty L, at D = 100, 99, 4 and 1, bit-equal to its plain version on the
card and on the CPU. Fanouts above 32: K4 (within 1e-5) and K4b
(bit-equal to its plain version on the CPU and when run twice) at k = 33,
64 and 512 in both layouts, float32 and bfloat16, the cols layout with a
source row named by at least 20,000 lanes; K7 (tiled, flat) and K8 at
k = 33, 64 and k = the window (512 and 4,096), bit-equal on the card and
on the CPU; a GraphSAGE step at sizes [64, 10] (uniform and weighted
sampler) against the CPU's plain path. The full-graph mean (K10) on a graph
with a star of 100 segments' edges and rows at the segment length and one
past it, at D = 99, 100 and 256 with int32 and int64 ids, bit-equal when
run twice. The redesigned K2: bit-equal to its plain version (card and
CPU) and when run twice at S*k of 1, 2,048, 2,049 and 65,537, across its
1,024-seed tiles and its sort's 1,024-element tiles, with every neighbor a
seed, no valid neighbor, no valid seed, ids 0 and INT32_MAX - 1 and
negative ids; one kernel on the card a call up to 2,048 slots and eight
from there to S*k = 901,120.
The redesigned K4 at k in {1, 5, 15, 33, 64, 512}, W in {1, 64, 1,024,
16,384} and D in {1, 47, 100, 256, 257}, both layouts, float32 and
bfloat16: within 1e-5 of its plain version (bfloat16: the float32 kernel
rounded once), zeros for an all-false row, bit-equal when run twice.
The redesigned Gumbel draw (K7 tiled and flat, K8) across its switch
points (rows a block, the key budget's passes, rows of at most 32 lanes,
the arg-max/radix crossover at k = 16/17, the rank cap at 128/129, the
shared pick list, deg < k, zero-weight rows, invalid seeds, K8's cutoff
masking whole rows), bit-equal to its plain version and when run twice.
The redesigned uniform draw (K1, K1b, K13b) at k = 1, 2, 15, 16, 17, 31,
32, 33, 48, 64, 300 and 512, on rows of degree 0, k, k + 1 and past 10^6,
invalid seeds, W never a multiple of the rows a warp draws and seeds at
the owner windows' edges, bit-equal to its plain version, with K13b's
stacked slab of 2 and 3 groups; kernel launches counted on the host
(`_kernels.kernel_launches`): one a K1 or K13b call, two a grouped hop
(K13e: K13b into the stacked slab, one K13c unpack) on each of four rank
threads, and K2's one or eight.
The redesigned K14b (one cooperative kernel a call, on the host's launch
count, at the zoo's shapes) bit-equal to its plain version on a CPU copy
and when run twice, on its small path and its grid path, with no valid
lane, W_src = 1, segments of 2, 32, 33, 256, 257, 1,024 and 1,025 lanes,
rows of 64 and 65 lanes, more column chunks than warps, cols outside the
source, 65,536 lanes on one source, a hub across two bitmap windows, a
products-sized source at F = 1, F = 1,024 and 256-wide rows whose pointer
is not 16-byte aligned, and in bfloat16 equal to the float32 sum rounded
once. The redesigned K14c (one cooperative kernel a call, a table in
shared memory for a block of many lanes) and K13d's compaction (one
cooperative kernel a call) at each of their switch points, bit-equal to
their plain versions, and both launched from four threads at once. The
draws' device-key forms (K1, K1b, K7, K7 flat and K8 reading the hop's key
words from a row of a [3, 2] uint32 buffer on the card, as a captured
serve step does) bit-equal to their by-value forms at a B = 64 sample's
three hops. The streaming graph's row scatter (B1: K6's body on int32
tile rows, float32 timestamp tiles and int32 (base, deg) rows, at a
commit's bucketed positions) bit-equal to its plain version with its
input untouched; K1's and K8's device-graph forms (the tables' addresses
read from words on the card) bit-equal to their by-value forms; and a
serve step over a streaming graph captured once, replaying a binding
sealed before a commit bit for bit and the commit's epoch after it, with
nothing captured anew. The redesigned B1/K6 (a flat copy of the table,
then a cooperative patch of the rows) over int32 rows of 512 and 8 bytes
and float32, bfloat16 and int8 rows of 400, 200 and 100 bytes, with
duplicate slots, all padding, no rows, the edge slots and unaligned base
pointers, bit-equal to its plain version in two kernels a call; and the
tiled K13a at D = 1, 47 and 100 in each dtype, all, none and some ids
owned, bit-equal in one kernel a call. In a spawned child (the hand-off of
`quiver_tpu_torch.multiprocessing`): K3t over a device shard mapped by
CUDA IPC and a shared host tail registered with the card there, bit-equal
to its plain version, and K1/K2's first draw over a mapped tile table,
bit-equal to the parent's, with no tile table built in the child; a
child started by ``fork`` instead fails at its first gather."""

import numpy as np
import pytest
import torch

from quiver_tpu_torch import GraphSAGE, GraphSageSampler, _kernels
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.feature import Feature, gather_rows, gather_rows_plain
from quiver_tpu_torch.inference import (
    bind_params,
    forward_logits,
    full_mean_aggregate,
    full_mean_aggregate_plain,
)
from quiver_tpu_torch.models.sage import (
    masked_mean_aggregate,
    masked_mean_aggregate_plain,
    masked_mean_backward,
    masked_mean_backward_plain,
)
from quiver_tpu_torch.shard_tensor import tiered_gather, tiered_gather_plain
from quiver_tpu_torch.ops import reindex, sample
from quiver_tpu_torch.pipeline import tiered_lookup, tiered_lookup_plain
from quiver_tpu_torch.quant import gather_dequant, get_codec, quantized_tiered_lookup
from quiver_tpu_torch.quant.lookup import gather_dequant_plain, quantized_tiered_lookup_plain
from quiver_tpu_torch.utils import round_up_pow2
from quiver_tpu_torch.pyg.sage_sampler import DenseAdj
from quiver_tpu_torch.utils import CSRTopo
from quiver_tpu_torch.ops.sample import (
    PROB_LANE_ITEMS,
    PROB_SEQ_SPAN,
    PROB_WARP_ITEMS,
    build_transposed_host,
    neighbor_prob,
    neighbor_prob_depth,
    neighbor_prob_plain,
)
from quiver_tpu_torch.tiers import set_rows, set_rows_plain
from quiver_tpu_torch.ops.gather_src import (
    block_out_degree,
    block_out_degree_plain,
    gather_src,
    gather_src_backward,
    gather_src_backward_plain,
    gather_src_plain,
    gather_src_rows,
)

from torch_fixtures import cuda_device  # noqa: F401 (fixture)
from torch_fixtures import prob_kernel_order, run_in_child

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)

HOPS = ((64, 15), (1024, 10), (11264, 5))


def _graph(n=3000, e=60000, seed=0):
    """Random graph with a degree-0 row (9), a degree-15 row (7) and a
    500-neighbor hub (5) that crosses tile boundaries."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    src[np.isin(src, (5, 7, 9))] = 11
    src = np.concatenate([src, np.full(500, 5), np.full(15, 7)])
    dst = rng.integers(0, n, src.shape[0])
    return CSRTopo(edge_index=np.stack([src, dst]), num_nodes=n), n


def _same(a, b):
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
def test_sample_kernel_matches_plain(cuda_device, layout):
    topo, n = _graph()
    rng = np.random.default_rng(1)
    for W, k in HOPS:
        seeds = torch.from_numpy(rng.integers(-3, n + 3, W).astype(np.int32))
        seeds[:3] = torch.tensor([5, 7, 9], dtype=torch.int32)
        valid = torch.from_numpy(rng.random(W) < 0.9)
        key = qrandom.split(qrandom.key(W))[1]
        if layout == "tiled":
            g = topo.to_device_tiled(cuda_device)
            fn, plain = sample.tiled_sample_layer, sample.tiled_sample_layer_plain
        else:
            g = topo.to_device(cuda_device)
            fn, plain = sample.sample_layer, sample.sample_layer_plain
        args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
        torch.cuda.synchronize()
        _kernels.reset_kernel_launches()
        got = fn(*g, *args)
        assert _kernels.kernel_launches() == 1, (W, k)
        want = plain(*g, *args)
        cpu = plain(*(t.cpu() for t in g), seeds, valid, k, key)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, cpu):
            assert _same(a, b) and _same(a, c)


@pytest.mark.cuda
def test_reindex_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    for S, k in HOPS + ((3000, 7),):
        seeds = rng.integers(0, 2_000_000, S).astype(np.int32)
        seeds[3] = seeds[1]
        seed_valid = np.ones(S, bool)
        seed_valid[S // 2:] = rng.random(S - S // 2) < 0.7
        nbrs = rng.integers(0, 2_000_000, (S, k)).astype(np.int32)
        nbrs[0, 0] = seeds[1]
        nbrs[1] = rng.integers(0, 50, k)  # repeats
        nbr_valid = rng.random((S, k)) < 0.8
        case = [torch.from_numpy(a).to(cuda_device) for a in (seeds, seed_valid, nbrs, nbr_valid)]
        got = reindex.local_reindex(*case)
        want = reindex.local_reindex_plain(*case)
        again = reindex.local_reindex(*case)
        torch.cuda.synchronize()
        valid = case[3]
        assert _same(got.n_id, want.n_id) and _same(got.count, want.count)
        assert _same(got.local_seeds, want.local_seeds)
        assert _same(got.local_nbrs[valid], want.local_nbrs[valid])
        assert _same(again.n_id, got.n_id) and _same(again.local_nbrs, got.local_nbrs)


INT32_MAX = 2**31 - 1


def _reindex_case(S, k, rng, lo=0, hi=2_000_000, seed_frac=0.9, nbr_frac=0.8):
    seeds = rng.integers(lo, hi, S).astype(np.int32)
    seed_valid = rng.random(S) < seed_frac
    nbrs = rng.integers(lo, hi, (S, k)).astype(np.int32)
    nbr_valid = rng.random((S, k)) < nbr_frac
    return seeds, seed_valid, nbrs, nbr_valid


def _new_uniques(n_new, S, k, rng):
    """Seeds and neighbors whose valid neighbors hold exactly ``n_new``
    values that no seed holds (S * k >= n_new)."""
    seeds = np.arange(S, dtype=np.int32) * 2  # even ids
    vals = rng.permutation(n_new).astype(np.int32) * 2 + 1  # odd ids: never a seed
    nbrs = np.resize(vals, S * k).reshape(S, k)
    return seeds, np.ones(S, bool), nbrs, np.ones((S, k), bool)


def _reindex_boundary_cases():
    rng = np.random.default_rng(31)
    cases = {f"S*k={S * k} (S={S}, k={k})": _reindex_case(S, k, rng)
             for S, k in ((1, 1), (64, 32), (683, 3), (2049, 1), (65537, 1), (1, 2049))}
    # the one-block path's limit: S*(1+k) = 2,048 slots, then 2,049
    cases["one block, 2048 slots"] = _reindex_case(64, 31, rng)
    cases["past one block, 2049 slots"] = _reindex_case(683, 2, rng)
    cases["one block, 1025 new uniques"] = _new_uniques(1025, 500, 3, rng)
    cases["seed tiles 1024"] = _reindex_case(1024, 4, rng)
    cases["seed tiles 1025"] = _reindex_case(1025, 4, rng)
    for n_new in (1024, 1025, 2048, 2049):  # the sort's 1,024-element tiles
        cases[f"new uniques {n_new}"] = _new_uniques(n_new, 700, 3, rng)
    seeds, sv, _, nv = _reindex_case(500, 7, rng, hi=100)
    cases["all neighbors duplicates of the seeds"] = (
        seeds, np.ones(500, bool), seeds[rng.integers(0, 500, (500, 7))], nv)
    for S, path in ((300, "one block"), (700, "eight kernels")):
        seeds, sv, nbrs, nv = _reindex_case(S, 5, rng)
        cases[f"no valid neighbor, {path}"] = (seeds, sv, nbrs, np.zeros_like(nv))
        cases[f"no valid seed, {path}"] = (seeds, np.zeros_like(sv), nbrs, nv)
    for S, path in ((200, "one block"), (400, "eight kernels")):
        seeds, sv, nbrs, nv = _reindex_case(S, 6, rng, lo=INT32_MAX - 40, hi=INT32_MAX)
        seeds[:3] = (0, INT32_MAX - 1, 0)
        nbrs[:2] = 0
        nbrs[2:4] = INT32_MAX - 1
        cases[f"ids 0 and INT32_MAX - 1, {path}"] = (seeds, sv, nbrs, nv)
    seeds, sv, nbrs, nv = _reindex_case(400, 6, rng, lo=-2**31, hi=INT32_MAX)
    nbrs[:3, 0] = (-2**31, -1, 0)
    cases["negative ids in signed order"] = (seeds, sv, nbrs, nv)
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_reindex_boundary_cases()))
def test_reindex_kernel_at_its_design_boundaries(cuda_device, name):
    """K2 at S*k of 1, 2,048, 2,049 and 65,537, on both sides of its
    one-block limit (2,048 slots), across its 1,024-seed tiles and its
    sort's 1,024-element tiles of new uniques, with all neighbors
    duplicates of the seeds, no valid neighbor, no valid seed, ids 0 and
    INT32_MAX - 1 and negative ids: bit-equal to its plain version on the
    card and on the CPU, and when run twice."""
    case = _reindex_boundary_cases()[name]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in case]
    got = reindex.local_reindex(*args)
    again = reindex.local_reindex(*args)
    want = reindex.local_reindex_plain(*args)
    cpu = reindex.local_reindex_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in case))
    torch.cuda.synchronize()
    valid = args[3]
    for other in (want, cpu, again):
        assert _same(got.n_id, other.n_id) and _same(got.count, other.count)
        assert _same(got.local_seeds, other.local_seeds)
        assert _same(got.local_nbrs[valid], other.local_nbrs.to(cuda_device)[valid])


@pytest.mark.cuda
def test_reindex_kernel_launches_do_not_grow_with_the_batch(cuda_device):
    """One counted launch of K2 runs one kernel on the card up to 2,048
    slots (a flush's first hop) and eight from there to S*k = 901,120 (a
    batch of 1,024's third hop), as the host's count of kernel launches
    (`_kernels.kernel_launches`) sees them, and its scratch is the size its
    C helper names (none for one block)."""
    rng = np.random.default_rng(32)
    for S, k in ((64, 15), (64, 31), (683, 2), (1024, 10), (11264, 5), (180224, 5)):
        args = [torch.from_numpy(a).to(cuda_device) for a in _reindex_case(S, k, rng)]
        reindex.local_reindex(*args)
        torch.cuda.synchronize()
        _kernels.reset_kernel_launches()
        reindex.local_reindex(*args)
        n = _kernels.kernel_launches()
        torch.cuda.synchronize()
        W = S * (1 + k)
        assert n == (1 if W <= 2048 else 8), (S, k, n)
        H = 1 << (2 * W - 1).bit_length()
        tiles, seed_tiles = -(-S * k // 1024), -(-S // 1024)
        assert _kernels.local_reindex_scratch_words(S, k) == (0 if W <= 2048 else (
            2 * H + 2 * S * k + seed_tiles + 8 + 4 * 256 + 4 * 256 * tiles))


@pytest.mark.cuda
def test_gather_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((5000, 100)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(-5, 5100, 67584).astype(np.int32)).to(cuda_device)
    imap = torch.from_numpy(rng.integers(-2, 5002, 6000).astype(np.int32)).to(cuda_device)
    assert _same(gather_rows(table, ids), gather_rows_plain(table, ids))
    assert _same(gather_rows(table, ids, imap), gather_rows_plain(table, ids, imap))
    odd = table[:, :99].contiguous()  # width not a multiple of 4: scalar copy
    assert _same(gather_rows(odd, ids), gather_rows_plain(odd, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("structural", [False, True])
def test_mean_kernel_matches_plain(cuda_device, structural):
    rng = np.random.default_rng(4)
    for (W, k), D in zip(reversed(HOPS), (100, 256, 256)):
        w_src = W * (1 + k)
        mask = torch.from_numpy(rng.random((W, k)) < 0.7)
        mask[0] = False
        cols = None if structural else torch.from_numpy(
            rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)).to(cuda_device)
        x = torch.from_numpy(rng.standard_normal((w_src, D)).astype(np.float32)).to(cuda_device)
        adj = DenseAdj(cols, mask.to(cuda_device), None, None)
        got, want = masked_mean_aggregate(x, adj), masked_mean_aggregate_plain(x, adj)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert not got[0].any()


@pytest.mark.cuda
def test_sampled_forward_on_card_matches_cpu(cuda_device):
    """The whole split path, kernels on the card against plain torch on
    the CPU: same n_id and masks, logits within 1e-4 (float32 products in
    another order)."""
    topo, n = _graph(seed=5)
    feat = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 100)).astype(np.float32))
    torch.manual_seed(0)
    model = GraphSAGE(100, 256, 47, num_layers=3)
    samplers = [GraphSageSampler(topo, [15, 10, 5], device=d, seed=3) for d in ("cpu", cuda_device)]
    seeds = np.arange(64) * 37 % n
    ds_cpu, ds_dev = (s.sample_dense(seeds) for s in samplers)
    assert _same(ds_cpu.n_id, ds_dev.n_id) and _same(ds_cpu.count, ds_dev.count)
    for a, b in zip(ds_cpu.adjs, ds_dev.adjs):
        assert _same(a.mask, b.mask) and _same(a.cols[a.mask], b.cols[b.mask])
    out_cpu = forward_logits(bind_params(model, None, "cpu"), feat, ds_cpu)
    dev_model = bind_params(model, model.state_dict(), cuda_device)
    out_dev = forward_logits(dev_model, feat.to(cuda_device), ds_dev)
    torch.testing.assert_close(out_dev.cpu(), out_cpu, atol=1e-4, rtol=1e-4)
    assert sum(_kernels.counts().values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("structural", [False, True])
def test_mean_backward_kernel_matches_plain_and_reruns_bit_equal(cuda_device, structural):
    """Layers 1 and 2 of a batch-1024 step at sizes [15, 10, 5]: targets
    share source rows (a hub named by many lanes), some lanes invalid, a
    target with no valid lane, columns past the source width."""
    rng = np.random.default_rng(7)
    for (W, k), D in (((1024, 15), 256), ((16384, 10), 256)):
        w_src = W * (1 + k)
        mask = torch.from_numpy(rng.random((W, k)) < 0.8)
        mask[0] = False
        cols = None
        if not structural:
            c = rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)
            c[rng.random((W, k)) < 0.05] = 3  # a hub row
            cols = torch.from_numpy(c).to(cuda_device)
        g = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32)).to(cuda_device)
        m = mask.to(cuda_device)
        before = _kernels.counts()["masked_mean_backward"]
        got = masked_mean_backward(g, m, cols, w_src)
        again = masked_mean_backward(g, m, cols, w_src)
        cpu = masked_mean_backward_plain(g.cpu(), mask, None if cols is None else cols.cpu(), w_src)
        torch.cuda.synchronize()
        assert _kernels.counts()["masked_mean_backward"] == before + 2
        torch.testing.assert_close(got.cpu(), cpu, atol=1e-5, rtol=1e-5)
        assert _same(got, again)


@pytest.mark.cuda
def test_mean_autograd_on_card_matches_cpu(cuda_device):
    """The autograd Function end to end: gradients of x_src through K4
    and K4b against torch's plain path on the CPU."""
    rng = np.random.default_rng(8)
    W, k, w_src, D = 512, 10, 3000, 64
    mask = torch.from_numpy(rng.random((W, k)) < 0.7)
    cols = torch.from_numpy(rng.integers(0, w_src, (W, k)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((w_src, D)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        xs = x.to(dev, copy=True).requires_grad_(True)
        adj = DenseAdj(cols.to(dev), mask.to(dev), None, None)
        (masked_mean_aggregate(xs, adj) * R.to(dev)).sum().backward()
        grads.append(xs.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_wide_fanout_training_step_on_card_matches_cpu(cuda_device, weighted):
    """A GraphSAGE step at sizes [64, 10] on the card (the sampler, K1 or
    K7, K2, K4 and K4b at k = 64) against the CPU's plain path: the same
    sample bit for bit, the loss and every parameter gradient within 1e-4
    (float32 products in another order)."""
    import torch.nn.functional as F

    if weighted:
        topo, _, n = _weighted_topo(seed=22)
    else:
        topo, n = _graph(seed=22)
    rng = np.random.default_rng(23)
    feat = torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, n))
    torch.manual_seed(0)
    model = GraphSAGE(32, 64, 7, num_layers=2, dropout=0.0)
    seeds = (np.arange(128) * 37 % n).astype(np.int64)
    seeds[0] = 5  # the hub
    outs = []
    for dev in ("cpu", cuda_device):
        sampler = GraphSageSampler(topo, [64, 10], device=dev, seed=3, weighted=weighted,
                                   max_deg=512)
        ds = sampler.sample_dense(seeds)
        m = bind_params(model, model.state_dict(), dev)
        x = feat.to(dev)[torch.clamp(ds.n_id.long(), 0, n - 1)]
        loss = F.cross_entropy(m(x, ds.adjs, train=True), labels.to(dev)[seeds])
        loss.backward()
        outs.append((ds, float(loss), {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (ds_cpu, loss_cpu, g_cpu), (ds_dev, loss_dev, g_dev) = outs
    assert ds_dev.adjs[-1].mask.shape == (128, 64)
    assert _same(ds_cpu.n_id, ds_dev.n_id)
    for a, b in zip(ds_cpu.adjs, ds_dev.adjs):
        assert _same(a.mask, b.mask) and _same(a.cols[a.mask], b.cols[b.mask])
    assert abs(loss_dev - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for name in g_cpu:
        torch.testing.assert_close(g_dev[name], g_cpu[name], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_full_mean_kernel_matches_plain(cuda_device, id_dtype):
    topo, n = _graph(seed=9)
    for D in (100, 256, 99):
        h = torch.from_numpy(np.random.default_rng(D).standard_normal((n, D)).astype(np.float32))
        indptr, indices = topo.to_device(cuda_device, id_dtype=id_dtype)
        got = full_mean_aggregate(indptr, indices, h.to(cuda_device))
        want = full_mean_aggregate_plain(indptr, indices, h.to(cuda_device))
        cpu = full_mean_aggregate_plain(*topo.to_device("cpu", id_dtype=id_dtype), h)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got.cpu(), cpu, atol=1e-5, rtol=1e-5)
        assert not got[9].any()  # the degree-0 row


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 512])
@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mean_kernels_at_wide_fanouts_match_plain(cuda_device, k, structural, dtype):
    """K4 and K4b above 32 lanes a row (chunks of 32): K4 within 1e-5 of
    its plain version (bfloat16: the float32 kernel rounded once); K4b
    bit-equal to its plain version on a CPU copy and when run twice. The
    cols layout names one source row from at least 20,000 lanes."""
    rng = np.random.default_rng(k)
    W = 4096 if k < 512 else 512
    D = 256 if k < 512 else 64
    w_src = W * (1 + k)
    mask = torch.from_numpy(rng.random((W, k)) < 0.8)
    mask[0] = False
    mask[1, :] = True
    cols = None
    if not structural:
        c = rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)
        c[rng.random((W, k)) < 25_000 / (W * k * 0.8)] = 3  # the hub row
        cols = torch.from_numpy(c)
        assert int((torch.from_numpy(c == 3) & mask).sum()) >= 20_000
    x = torch.from_numpy(rng.standard_normal((w_src, D)).astype(np.float32)).to(cuda_device, dtype)
    m = mask.to(cuda_device)
    adj = DenseAdj(None if cols is None else cols.to(cuda_device), m, None, None)
    got = masked_mean_aggregate(x, adj)
    if dtype == torch.float32:
        torch.testing.assert_close(got, masked_mean_aggregate_plain(x, adj), atol=1e-5, rtol=1e-5)
    else:
        assert _same(got, masked_mean_aggregate(x.float(), adj).to(dtype))
    assert not got[0].any()
    g = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32)).to(cuda_device, dtype)
    before = _kernels.counts()["masked_mean_backward"]
    gx = masked_mean_backward(g, m, adj.cols, w_src)
    again = masked_mean_backward(g, m, adj.cols, w_src)
    torch.cuda.synchronize()
    assert _kernels.counts()["masked_mean_backward"] == before + 2
    assert gx.dtype == dtype and _same(gx, again)
    assert _same(gx, masked_mean_backward_plain(g.cpu(), mask, cols, w_src))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 15, 33, 64, 512])
@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mean_kernel_over_its_launch_plans(cuda_device, k, structural, dtype):
    """K4 at W in {1, 64, 1,024, 16,384} targets and D in {1, 47, 100,
    256, 257} columns: every access width (16 bytes down to one element),
    one to eight warps a target and the lane split. Within 1e-5 of its
    plain version (bfloat16: the float32 kernel rounded once, bit for
    bit), an all-false mask row giving zeros, and bit-equal when run
    twice."""
    rng = np.random.default_rng(1000 + k)
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    for W in (1, 64, 1024, 16384):
        for D in (1, 47, 100, 256, 257):
            w_src = W * (1 + k) if structural else min(W * (1 + k), 50_000)
            mask = torch.from_numpy(rng.random((W, k)) < 0.8)
            mask[0] = False
            cols = None if structural else torch.from_numpy(
                rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)).to(cuda_device)
            adj = DenseAdj(cols, mask.to(cuda_device), None, None)
            x = torch.randn((w_src, D), generator=gen, device=cuda_device)
            got32 = masked_mean_aggregate(x, adj)
            torch.testing.assert_close(got32, masked_mean_aggregate_plain(x, adj), atol=1e-5,
                                       rtol=1e-5)
            xd = x.to(dtype)
            got = masked_mean_aggregate(xd, adj)
            again = masked_mean_aggregate(xd, adj)
            torch.cuda.synchronize()
            assert got.dtype == dtype and _same(got, again), (W, D)
            if dtype == torch.bfloat16:
                assert _same(got, masked_mean_aggregate(xd.float(), adj).to(dtype)), (W, D)
            assert not got[0].any()
            del x, xd, got, got32, again


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 99, 256])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_full_mean_kernel_splits_hub_rows(cuda_device, D, id_dtype):
    """K10 on a graph with a star of 100 segments' edges and rows of one
    segment's edges and one more (split at the segment length), beside
    degree-0 rows: within 1e-5 of its plain version on the card and on the
    CPU, and bit-equal when run twice."""
    S = _kernels.full_mean_segment_edges()
    rng = np.random.default_rng(D)
    n = 4000
    src = rng.integers(0, n, 40_000)
    src[np.isin(src, (1, 2, 3, 9))] = 11
    src = np.concatenate([src, np.full(100 * S, 1), np.full(S, 2), np.full(S + 1, 3)])
    dst = rng.integers(0, n, src.shape[0])
    topo = CSRTopo(edge_index=np.stack([src, dst]), num_nodes=n)
    h = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    indptr, indices = topo.to_device(cuda_device, id_dtype=id_dtype)
    before = _kernels.counts()["full_mean"]
    got = full_mean_aggregate(indptr, indices, h.to(cuda_device))
    again = full_mean_aggregate(indptr, indices, h.to(cuda_device))
    want = full_mean_aggregate_plain(indptr, indices, h.to(cuda_device))
    cpu = full_mean_aggregate_plain(*topo.to_device("cpu", id_dtype=id_dtype), h)
    torch.cuda.synchronize()
    assert _kernels.counts()["full_mean"] == before + 2
    assert _same(got, again)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.cpu(), cpu, atol=1e-5, rtol=1e-5)
    assert not got[9].any()  # a degree-0 row
    assert got[1].any() and got[2].any() and got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cache_frac", [0.0, 0.2, 1.0])
def test_tiered_gather_kernel_matches_plain(cuda_device, cache_frac):
    topo, n = _graph(seed=10)
    table = np.random.default_rng(11).standard_normal((n, 100)).astype(np.float32)
    feat = Feature(device_cache_size=int(n * cache_frac) * 400, csr_topo=topo, device=cuda_device)
    feat.from_cpu_tensor(table)
    st = feat.shard_tensor
    if cache_frac < 1.0:
        assert st.cpu_tensor.is_pinned()
    cpu_feat = Feature(device_cache_size=int(n * cache_frac) * 400, csr_topo=_graph(seed=10)[0],
                       device="cpu")
    cpu_feat.from_cpu_tensor(table)
    ids = torch.from_numpy(np.random.default_rng(12).integers(-5, n + 5, 67584).astype(np.int32))
    ids[:2] = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32)
    dev_ids = ids.to(cuda_device)
    got = feat[dev_ids]
    want = tiered_gather_plain(st.device_rows, st.cpu_tensor, dev_ids, n, feat._order_dev)
    torch.cuda.synchronize()
    assert _same(got, want) and _same(got, cpu_feat[ids])
    assert not got[:2].any()
    stored = tiered_gather(st.device_rows, st.cpu_tensor, dev_ids, n)  # no order
    assert _same(stored, tiered_gather_plain(st.device_rows, st.cpu_tensor, dev_ids, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_tiered_gather_kernel_on_narrow_rows(cuda_device, dtype):
    topo, n = _graph(seed=13)
    rng = np.random.default_rng(14)
    ids = torch.from_numpy(rng.integers(-5, n + 5, 67584).astype(np.int32))
    for D in (100, 99):
        table = rng.standard_normal((n, D)).astype(np.float32)
        rows = get_codec("int8").encode(table).payload if dtype == "int8" else table
        feats = []
        for dev in (cuda_device, "cpu"):
            f = Feature(device_cache_size=int(n * 0.2) * D * (1 if dtype == "int8" else 2),
                        dtype=dtype, device=dev)
            f.from_cpu_tensor(rows)
            feats.append(f)
        st = feats[0].shard_tensor
        assert st.cpu_tensor.is_pinned() and st.cpu_tensor.dtype == st.device_rows.dtype
        dev_ids = ids.to(cuda_device)
        before = _kernels.counts()[f"tiered_gather/{dtype}"]
        got = feats[0].gather_stored(dev_ids)
        want = tiered_gather_plain(st.device_rows, st.cpu_tensor, dev_ids, n)
        torch.cuda.synchronize()
        assert _kernels.counts()[f"tiered_gather/{dtype}"] == before + 1
        assert got.dtype == st.device_rows.dtype
        assert _same(got, want) and _same(got, feats[1].gather_stored(ids))


def _staged(rng, W, H, n, D, make_rows):
    """A lookup's inputs as the pipeline stages them: mapped ids with
    invalid (-1) and cold (>= H) lanes, the cold rows padded to a power of
    two with slot W."""
    mapped = rng.integers(-1, n, W).astype(np.int32)
    cold_sel = np.nonzero(mapped >= H)[0]
    b = round_up_pow2(cold_sel.size, floor=256)
    pos = np.full(b, W, np.int32)
    pos[: cold_sel.size] = cold_sel
    return torch.from_numpy(mapped), make_rows(b), torch.from_numpy(pos)


@pytest.mark.cuda
def test_tiered_lookup_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(15)
    for D in (100, 99):
        hot = torch.from_numpy(rng.standard_normal((3000, D)).astype(np.float32))
        mapped, cold, pos = _staged(rng, 67584, 3000, 15000, D, lambda b: torch.from_numpy(
            rng.standard_normal((b, D)).astype(np.float32)))
        args = [t.to(cuda_device) for t in (hot, mapped, cold, pos)]
        before = _kernels.counts()["tiered_lookup"]
        got = tiered_lookup(*args)
        want = tiered_lookup_plain(*args)
        torch.cuda.synchronize()
        assert _kernels.counts()["tiered_lookup"] == before + 1
        assert _same(got, want) and _same(got, tiered_lookup_plain(hot, mapped, cold, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp32", "bf16", "int8"])
def test_dequant_kernels_match_plain(cuda_device, name):
    """K9a with and without the feature order, K9b with its invalid lanes,
    cold lanes and padding; every decode bit-equal to the plain torch
    version on the card and on the CPU."""
    rng = np.random.default_rng(16)
    codec = get_codec(name)
    for D in (100, 99):
        enc = codec.encode((rng.standard_normal((20000, D)) * 3).astype(np.float32))
        payload = torch.as_tensor(enc.payload)
        side = [None if a is None else torch.from_numpy(a) for a in (enc.scale, enc.zero)]
        dev_side = [None if a is None else a.to(cuda_device) for a in side]
        ids = torch.from_numpy(rng.integers(-5, 20005, 67584).astype(np.int32))
        order = torch.from_numpy(rng.permutation(20000).astype(np.int32))
        for imap in (None, order):
            args = (payload.to(cuda_device), ids.to(cuda_device), *dev_side)
            kw = dict(index_map=None if imap is None else imap.to(cuda_device))
            got = gather_dequant(name, *args, **kw)
            want = gather_dequant_plain(name, *args, **kw)
            cpu = gather_dequant_plain(name, payload, ids, *side, index_map=imap)
            torch.cuda.synchronize()
            assert _same(got, want) and _same(got, cpu)
        H = 4000
        mapped, cold, pos = _staged(rng, 67584, H, 20000, D, lambda b: payload[
            torch.from_numpy(rng.integers(H, 20000, b))])
        before = _kernels.counts()[f"quantized_tiered_lookup/{name}"]
        args = [t.to(cuda_device) for t in (payload[:H], mapped, cold, pos)]
        got = quantized_tiered_lookup(name, *args, *dev_side)
        want = quantized_tiered_lookup_plain(name, *args, *dev_side)
        cpu = quantized_tiered_lookup_plain(name, payload[:H], mapped, cold, pos, *side)
        torch.cuda.synchronize()
        assert _kernels.counts()[f"quantized_tiered_lookup/{name}"] == before + 1
        assert _same(got, want) and _same(got, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_set_rows_kernel_matches_plain_and_leaves_its_input(cuda_device, dtype):
    rng = np.random.default_rng(17)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    for D in (100, 99):
        H, b = 50000, 4096
        table = torch.from_numpy((rng.standard_normal((H, D)) * 30).astype(np.float32)).to(tdt)
        rows = torch.from_numpy((rng.standard_normal((b, D)) * 30).astype(np.float32)).to(tdt)
        slots = rng.permutation(H)[:b].astype(np.int64)
        slots[-100:] = H  # the bucket's padding
        slots[-3] = H + 7
        slots = torch.from_numpy(slots)
        dev = [t.to(cuda_device) for t in (table, slots, rows)]
        keep = dev[0].clone()
        before = _kernels.counts()[f"set_rows/{dtype}"]
        got = set_rows(*dev)
        want = set_rows_plain(*dev)
        torch.cuda.synchronize()
        assert _kernels.counts()[f"set_rows/{dtype}"] == before + 1
        assert torch.equal(dev[0], keep)  # copy-on-write
        assert got.data_ptr() != dev[0].data_ptr()
        assert _same(got, want) and _same(got, set_rows_plain(table, slots, rows))
    # a slot given twice takes the later row, as a sequential scatter does
    twice = torch.tensor([3, 9, 3, H], dtype=torch.int64, device=cuda_device)
    got = set_rows(dev[0], twice, dev[2][:4])
    assert _same(got[3], dev[2][2]) and _same(got[9], dev[2][1]) and _same(got[4], dev[0][4])


@pytest.mark.cuda
def test_neighbor_prob_kernel_on_a_hub_graph_reruns_bit_equal(cuda_device):
    rng = np.random.default_rng(18)
    n, e = 200000, 3000000
    src = rng.integers(0, n, e)
    dst = (rng.pareto(1.2, e) * 50).astype(np.int64) % n  # power-law in-degrees
    dst[:40000] = 5  # a hub across ~78 of the kernel's ranges
    topo = CSRTopo(edge_index=np.stack([src, dst]), num_nodes=n)
    indptr, indices = topo.to_device(cuda_device)
    t = build_transposed_host(topo.indptr, topo.indices)
    tp = t.tindptr
    assert int((5 + tp[6]) // PROB_WARP_ITEMS - (5 + tp[5]) // PROB_WARP_ITEMS) >= 40000 // (
        PROB_WARP_ITEMS + 1)
    assert int((tp[1:] == tp[:-1]).sum()) > 0  # nodes without in-edges
    t = t.to(cuda_device)
    prob = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda_device)
    for k in (15, 10, 5):
        before = _kernels.counts()["neighbor_prob"]
        got = neighbor_prob(indptr, indices, prob, k, t)
        again = neighbor_prob(indptr, indices, prob, k, t)
        built = neighbor_prob(indptr, indices, prob, k)  # builds its own transposed graph
        cpu = neighbor_prob_plain(indptr.cpu(), indices.cpu(), prob.cpu(), k)
        card_plain = neighbor_prob_plain(indptr, indices, prob, k)
        torch.cuda.synchronize()
        assert _kernels.counts()["neighbor_prob"] == before + 3
        assert torch.equal(got, again) and torch.equal(got, built)
        torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(got, card_plain, rtol=1e-4, atol=1e-6)
        # within the kernel's own order bound of the exact sum, hub included
        exact = neighbor_prob_plain(indptr, indices, prob, k, acc_dtype=torch.float64)
        d = neighbor_prob_depth(t).double()
        # plus 1e-9 relative for the float64 sum's own rounding
        tol = (d * 2.0**-24 / (1 - d * 2.0**-24) + 1e-9) * exact
        assert bool(((got.double() - exact).abs() <= tol).all())


@pytest.mark.cuda
def test_neighbor_prob_kernel_adds_in_its_emulated_order(cuda_device):
    """K11 bit-equal to the numpy replay of its order of additions
    (`torch_fixtures.prob_kernel_order`) on a graph with a hub across more
    ranges than it adds one by one, a node across a few and nodes without
    in-edges; three kernels a call on the host's launch count."""
    rng = np.random.default_rng(19)
    n, e = 3000, 40000
    src = rng.integers(0, n - 50, e)
    dst = rng.integers(0, n - 50, e)
    dst[:5000] = 7
    dst[5000:5700] = 13
    topo = CSRTopo(edge_index=np.stack([src, dst]), num_nodes=n)
    t = build_transposed_host(topo.indptr, topo.indices)
    prob = rng.random(n).astype(np.float32)
    indptr, indices = topo.to_device(cuda_device)
    td = t.to(cuda_device)
    for k in (15, 10, 5):
        deg = np.diff(topo.indptr).astype(np.float32)
        w = prob * np.minimum(np.float32(k) / np.maximum(deg, np.float32(1)), np.float32(1))
        want, _ = prob_kernel_order(t.tindptr.numpy(), t.tsrc.numpy(), w, PROB_LANE_ITEMS,
                                    PROB_SEQ_SPAN)
        _kernels.reset_kernel_launches()
        got = neighbor_prob(indptr, indices, torch.from_numpy(prob).to(cuda_device), k, td)
        torch.cuda.synchronize()
        assert _kernels.kernel_launches() == 3
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert float(got[7]) > 0 and not got[n - 50:].any()


@pytest.mark.cuda
def test_tiered_gather_with_a_disk_tail_matches_the_cpu_store(cuda_device, tmp_path):
    topo, n = _graph(seed=19)
    table = np.random.default_rng(20).standard_normal((n, 100)).astype(np.float32)
    feats = []
    for dev in (cuda_device, "cpu"):
        f = Feature(device_cache_size=int(n * 0.2) * 400, host_memory_budget=int(n * 0.3) * 400,
                    disk_path=str(tmp_path / f"{dev}.npy"), csr_topo=_graph(seed=19)[0],
                    device=dev)
        f.from_cpu_tensor(table)
        feats.append(f)
    ids = torch.from_numpy(np.random.default_rng(21).integers(-5, n + 5, 67584).astype(np.int32))
    before = _kernels.counts()["tiered_gather/disk"]
    got = feats[0][ids.to(cuda_device)]
    torch.cuda.synchronize()
    assert _kernels.counts()["tiered_gather/disk"] == before + 1
    assert _same(got, feats[1][ids])


# -- the weighted and temporal slice: K7, K8, K8w --------------------------------------

def _weighted_topo(seed=0):
    topo, n = _graph(seed=seed)
    rng = np.random.default_rng(seed + 1)
    w = rng.uniform(0.0, 1.0, topo.edge_count).astype(np.float32)
    w[rng.random(topo.edge_count) < 0.05] = 0.0
    ts = rng.uniform(0.0, 50.0, topo.edge_count).astype(np.float32)
    return CSRTopo(indptr=topo.indptr, indices=topo.indices, edge_weights=w), ts, n


def _hop_seeds(rng, W, n):
    seeds = torch.from_numpy(rng.integers(-3, n + 3, W).astype(np.int32))
    seeds[:3] = torch.tensor([5, 7, 9], dtype=torch.int32)
    valid = torch.from_numpy(rng.random(W) < 0.9)
    valid[:3] = True
    return seeds, valid


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("max_deg", [512, 4096])
def test_weighted_kernels_match_plain(cuda_device, layout, max_deg):
    """K7 against its plain version on the card and on the CPU, at the
    three hops of a B = 64 sample (the hub of 500 edges spans four tile
    rows; max_deg 4096 takes the two-rows-a-block window)."""
    topo, _, n = _weighted_topo()
    rng = np.random.default_rng(2)
    if layout == "tiled":
        g = (*topo.to_device_tiled(cuda_device), topo.to_device_tiled_weights(cuda_device))
        fn, plain = sample.tiled_weighted_sample_layer, sample.tiled_weighted_sample_layer_plain
    else:
        g = (*topo.to_device(cuda_device), topo.to_device_weights(cuda_device))
        fn, plain = sample.weighted_sample_layer, sample.weighted_sample_layer_plain
    before = _kernels.counts()[f"weighted_sample_{layout}"]
    for W, k in HOPS:
        seeds, valid = _hop_seeds(rng, W, n)
        key = qrandom.split(qrandom.key(W))[1]
        args = (seeds.to(cuda_device), valid.to(cuda_device), k, key, max_deg)
        got, want = fn(*g, *args), plain(*g, *args)
        cpu = plain(*(t.cpu() for t in g), seeds, valid, k, key, max_deg)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, cpu):
            assert _same(a, b) and _same(a, c)
        assert got[1][0].all()  # the hub draws k valid neighbours
    assert _kernels.counts()[f"weighted_sample_{layout}"] == before + len(HOPS)


@pytest.mark.cuda
@pytest.mark.parametrize("recency,cutoff", [(0.02, None), (0.02, 20.0), (0.0, None)])
def test_temporal_kernel_matches_plain(cuda_device, recency, cutoff):
    from quiver_tpu_torch.workloads import TemporalTiledGraph, host_masked_oracle

    topo, ts, n = _weighted_topo()
    tg = TemporalTiledGraph(topo, ts, device=cuda_device)
    g = tg.temporal_graph()
    rng = np.random.default_rng(3)
    for W, k in HOPS:
        seeds, valid = _hop_seeds(rng, W, n)
        t = torch.from_numpy(rng.uniform(0.0, 60.0, W).astype(np.float32))
        t[1] = float("inf")
        key = qrandom.split(qrandom.key(W + 1))[1]
        args = (seeds.to(cuda_device), valid.to(cuda_device), k, key, t.to(cuda_device), 512,
                recency, cutoff)
        got = sample.tiled_temporal_sample_layer(*g, *args)
        want = sample.tiled_temporal_sample_layer_plain(*g, *args)
        cpu = sample.tiled_temporal_sample_layer_plain(*(x.cpu() for x in g), seeds, valid, k,
                                                       key, t, 512, recency, cutoff)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, cpu):
            assert _same(a, b) and _same(a, c)
        if W <= 1024:  # the host-masked oracle, on the valid lanes
            onb, ovl = host_masked_oracle(topo.indptr, topo.indices, ts, seeds.numpy(),
                                          valid.numpy(), k, key, t.numpy(), max_deg=512,
                                          recency=recency, cutoff=cutoff)
            vl = got[1].cpu().numpy()
            assert np.array_equal(vl, ovl)
            assert np.array_equal(got[0].cpu().numpy()[vl], onb[ovl])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiled", "flat", "temporal"])
@pytest.mark.parametrize("max_deg,k", [(512, 33), (512, 64), (512, 512), (4096, 4096)])
def test_gumbel_kernels_at_wide_fanouts_match_plain(cuda_device, kind, max_deg, k):
    """K7 (tiled and flat) and K8 above 32 draws a row, up to k = the
    window (each round's pick in shared memory, the ids fetched 32 at a
    time), bit-equal to the plain version on the card and on the CPU."""
    from quiver_tpu_torch.workloads import TemporalTiledGraph

    topo, ts, n = _weighted_topo()
    rng = np.random.default_rng(k + max_deg)
    W = 1024 if k <= 64 else 128
    seeds, valid = _hop_seeds(rng, W, n)
    key = qrandom.split(qrandom.key(k))[1]
    args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
    cpu_args = (seeds, valid, k, key)
    if kind == "temporal":
        g = TemporalTiledGraph(topo, ts, device=cuda_device).temporal_graph()
        t = torch.from_numpy(rng.uniform(0.0, 60.0, W).astype(np.float32))
        t[0] = float("inf")
        fn, plain = sample.tiled_temporal_sample_layer, sample.tiled_temporal_sample_layer_plain
        args, cpu_args = args + (t.to(cuda_device),), cpu_args + (t,)
        tail = (max_deg, 0.02)
    elif kind == "tiled":
        g = (*topo.to_device_tiled(cuda_device), topo.to_device_tiled_weights(cuda_device))
        fn, plain = sample.tiled_weighted_sample_layer, sample.tiled_weighted_sample_layer_plain
        tail = (max_deg,)
    else:
        g = (*topo.to_device(cuda_device), topo.to_device_weights(cuda_device))
        fn, plain = sample.weighted_sample_layer, sample.weighted_sample_layer_plain
        tail = (max_deg,)
    got, want = fn(*g, *args, *tail), plain(*g, *args, *tail)
    cpu = plain(*(x.cpu() for x in g), *cpu_args, *tail)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, cpu):
        assert a.shape == (W, k)
        assert _same(a, b) and _same(a, c)
    if kind != "temporal":  # the hub draws its nonzero-weight edges of the window, up to k
        w = topo.edge_weights[topo.indptr[5]:topo.indptr[6]][:max_deg]
        assert int(got[1][0].sum()) == min(k, int((w > 0).sum()))


def _gumbel_boundary_graph(seed=5):
    """Degrees by node range: 0-999 up to 4, 1,000-1,999 5-40, 2,000-2,799
    41-200, 2,800-3,599 200-700, 3,600-3,999 700-5,000 (past a 4,096-lane
    window); 5% zero weights, and every weight zero on nodes 1,500-1,519
    and 3,000-3,009; timestamps uniform in [0, 50)."""
    rng = np.random.default_rng(seed)
    n = 4000
    deg = np.concatenate([rng.integers(0, 5, 1000), rng.integers(5, 41, 1000),
                          rng.integers(41, 201, 800), rng.integers(200, 701, 800),
                          rng.integers(700, 5001, 400)])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    w = rng.uniform(0.0, 1.0, indices.shape[0]).astype(np.float32)
    w[rng.random(w.shape[0]) < 0.05] = 0.0
    for lo, hi in ((1500, 1520), (3000, 3010)):
        w[indptr[lo]:indptr[hi]] = 0.0
    ts = rng.uniform(0.0, 50.0, indices.shape[0]).astype(np.float32)
    return CSRTopo(indptr=indptr, indices=indices, edge_weights=w), ts, n


def _gumbel_boundary_seeds(rng, W, n):
    """W seeds: 64 rows of degree 700-5,000 first (several passes of the
    block's key budget), then 64 rows of degree <= 4, 32 rows of all-zero
    weights, the rest random; ~10% invalid and a few out of range."""
    seeds = rng.integers(0, n, W)
    seeds[:64] = rng.integers(3600, 4000, 64)
    seeds[64:128] = rng.integers(0, 1000, 64)
    seeds[128:160] = np.resize(np.r_[1500:1520, 3000:3010], 32)
    seeds[160:163] = (-3, n + 3, n - 1)
    valid = rng.random(W) >= 0.1
    valid[:4] = True
    return torch.from_numpy(seeds.astype(np.int32)), torch.from_numpy(valid)


def _gumbel_call(kind, topo, ts, dev, W, rng):
    """``(fn, plain, graph)`` of one Gumbel kernel; the temporal draw's
    query times (some +inf) ride in ``fn``/``plain`` with recency 0.02
    and the cutoff 30, which masks every lane of a row with t <= 30."""
    from quiver_tpu_torch.workloads import TemporalTiledGraph

    if kind == "tiled":
        return (sample.tiled_weighted_sample_layer, sample.tiled_weighted_sample_layer_plain,
                (*topo.to_device_tiled(dev), topo.to_device_tiled_weights(dev)))
    if kind == "flat":
        return (sample.weighted_sample_layer, sample.weighted_sample_layer_plain,
                (*topo.to_device(dev), topo.to_device_weights(dev)))
    t = torch.from_numpy(rng.uniform(0.0, 60.0, W).astype(np.float32))
    t[::17] = float("inf")
    g = TemporalTiledGraph(topo, ts, device=dev).temporal_graph()

    def fn(*a, max_deg):
        seeds, valid, k, key = a[-4:]
        return sample.tiled_temporal_sample_layer(*a[:-4], seeds, valid, k, key,
                                                  t.to(seeds.device), max_deg, 0.02, 30.0)

    def plain(*a, max_deg):
        seeds, valid, k, key = a[-4:]
        return sample.tiled_temporal_sample_layer_plain(*a[:-4], seeds, valid, k, key,
                                                        t.to(seeds.device), max_deg, 0.02, 30.0)
    return fn, plain, g


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiled", "flat", "temporal"])
@pytest.mark.parametrize("max_deg,k,W", [
    (512, 1, 4999), (512, 5, 34001), (512, 16, 20011), (512, 17, 20011), (512, 64, 4999),
    (512, 33, 34001), (512, 128, 1031), (512, 129, 1031), (4096, 5, 300), (4096, 64, 300)])
def test_gumbel_kernels_at_their_design_boundaries(cuda_device, kind, max_deg, k, W):
    """The redesigned Gumbel draw (K7 tiled and flat, K8) across its
    switch points: 1 to 32 rows a block (W = 300 to 34,001; 4,999, 20,011
    and 34,001 rows are no multiple of their 4, 16 and 32 rows a block),
    hub rows whose windows take several
    passes of the block's 4,096-key budget (512 and 4,096-lane windows),
    rows of at most 32 lanes (one key a lane) and wider ones, the arg-max
    rounds up to k = 16 and the radix select from 17, the compacted ranks
    up to k = 128 and the whole-span ranks from 129, the picks written
    through the block's shared list (up to 512 a pass) and straight out,
    rows of deg < k (their -inf lanes in lane order), rows of zero
    weights alone and mixed with live ones, invalid and out-of-range
    seeds, and K8's cutoff masking whole rows: bit-equal to the plain
    version on the card (and on the CPU up to 1,031 rows) and when run
    twice."""
    topo, ts, n = _gumbel_boundary_graph()
    rng = np.random.default_rng(W + k)
    seeds, valid = _gumbel_boundary_seeds(rng, W, n)
    fn, plain, g = _gumbel_call(kind, topo, ts, cuda_device, W, rng)
    key = qrandom.split(qrandom.key(k + max_deg))[1]
    args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
    name = "temporal_sample_tiled" if kind == "temporal" else f"weighted_sample_{kind}"
    before = _kernels.counts()[name]
    got = fn(*g, *args, max_deg=max_deg)
    again = fn(*g, *args, max_deg=max_deg)
    want = plain(*g, *args, max_deg=max_deg)
    torch.cuda.synchronize()
    assert _kernels.counts()[name] == before + 2
    for a, b, c in zip(got, want, again):
        assert a.shape == (W, k)
        assert _same(a, b) and _same(a, c)
    if W <= 1031:
        cpu = plain(*(x.cpu() for x in g), seeds, valid, k, key, max_deg=max_deg)
        assert _same(got[0], cpu[0]) and _same(got[1], cpu[1])
    if kind != "temporal":  # an all-zero-weight row draws nothing; a hub row draws k
        assert not got[1][128:160].any()
        assert got[1][:4].sum(1).tolist() == [k] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("recency", [0.0, 0.05])
def test_recency_weights_kernel_matches_plain_and_pins_t_inf(cuda_device, recency):
    """K8w bit-equal to its plain version on the card (within an ULP of the
    CPU's exp), and K8 at t = +inf bit-equal to K7 over K8w's tiles."""
    from quiver_tpu_torch.workloads import TemporalTiledGraph

    topo, ts, n = _weighted_topo()
    tg = TemporalTiledGraph(topo, ts, device=cuda_device)
    bd, tiles, tt = tg.temporal_graph()
    wt = tg.recency_wtiles(recency)
    want = sample.temporal_edge_weights_plain(tt, recency)
    torch.cuda.synchronize()
    assert _same(wt, want)
    np.testing.assert_allclose(wt.cpu().numpy(),
                               sample.temporal_edge_weights_plain(tt.cpu(), recency).numpy(),
                               rtol=1.2e-7, atol=0)
    rng = np.random.default_rng(4)
    seeds, valid = _hop_seeds(rng, 1024, n)
    seeds, valid = seeds.to(cuda_device), valid.to(cuda_device)
    key = qrandom.key(9)
    inf = torch.full((1024,), float("inf"), device=cuda_device)
    a = sample.tiled_temporal_sample_layer(bd, tiles, tt, seeds, valid, 10, key, inf, 512, recency)
    b = sample.tiled_weighted_sample_layer(bd, tiles, wt, seeds, valid, 10, key, 512)
    torch.cuda.synchronize()
    assert _same(a[0], b[0]) and _same(a[1], b[1])


@pytest.mark.cuda
def test_build_tiles_kernel_matches_plain_and_the_host_build(cuda_device):
    """K12 on ids, weights and timestamps of a graph with a degree-0 row and
    a 500-edge hub, bit-equal to its plain version on the card and on the
    CPU and to build_tiled_host; a row map past the end clips as the plain
    version does; CSRTopo's tables are K12's."""
    topo, _ = _graph()
    rng = np.random.default_rng(12)
    start, width = sample.tiled_rowmap_host(topo.indptr)
    rs, rw = torch.from_numpy(start), torch.from_numpy(width)
    e = topo.edge_count
    for src in (topo.indices.astype(np.int32), rng.random(e, dtype=np.float32),
                rng.uniform(0, 50, e).astype(np.float32)):
        t = torch.from_numpy(src)
        _kernels.reset_counts()
        got = sample.build_tiled_device(t.to(cuda_device), rs.to(cuda_device), rw.to(cuda_device))
        assert _kernels.counts()["build_tiles"] == 1
        want = sample.build_tiled_device_plain(t.to(cuda_device), rs.to(cuda_device),
                                               rw.to(cuda_device))
        cpu = sample.build_tiled_device_plain(t, rs, rw)
        _, host = sample.build_tiled_host(topo.indptr, src, src.dtype)
        torch.cuda.synchronize()
        bits = (lambda a: a.view(torch.int32)) if t.dtype == torch.float32 else (lambda a: a)
        assert _same(bits(got), bits(want)) and _same(bits(got), bits(cpu))
        assert _same(bits(got), bits(torch.from_numpy(host)))
    past = torch.tensor([e - 3, 0, e + 100], dtype=torch.int64)
    wid = torch.tensor([128, 0, 5], dtype=torch.int32)
    src = torch.from_numpy(topo.indices.astype(np.int32))
    got = sample.build_tiled_device(src.to(cuda_device), past.to(cuda_device), wid.to(cuda_device))
    assert _same(got, sample.build_tiled_device_plain(src, past, wid))
    with pytest.raises(ValueError, match="ROADMAP"):
        sample.build_tiled_device(src.long().to(cuda_device), past.to(cuda_device),
                                  wid.to(cuda_device))
    _kernels.reset_counts()
    fresh = CSRTopo(indptr=topo.indptr, indices=topo.indices)
    _, tiles = fresh.to_device_tiled(cuda_device)
    # "cuda" and "cuda:<current>" are one device: one cache entry, one build
    assert fresh.to_device_tiled(f"cuda:{torch.cuda.current_device()}")[1] is tiles
    assert fresh.to_device_tiled("cuda")[1] is tiles
    assert _kernels.counts()["build_tiles"] == 1
    assert _same(tiles, torch.from_numpy(sample.build_tiled_host(topo.indptr, topo.indices,
                                                                 np.int32)[1]))


SAMPLE_BOUNDARY_KS = [1, 2, 15, 16, 17, 31, 32, 33, 48, 64, 300, 512]


def _sample_boundary_graph(k, seed=0):
    """A CSR graph whose rows 0-3 have degree 0, k, k + 1 and 1,100,000 (a
    hub past 10^6 neighbors, the JAX tail table's worst case), then 2,000
    rows of degree 0 to 2k + 3."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0, k, k + 1, 1_100_000], rng.integers(0, 2 * k + 4, 2000)])
    n = deg.shape[0]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return CSRTopo(indptr=indptr, indices=indices), n


def _boundary_seeds(rng, W, n):
    """Seeds over every row, the four boundary rows first, ids past both ends,
    about 10% invalid (never the first four)."""
    seeds = torch.from_numpy(rng.integers(-3, n + 3, W).astype(np.int32))
    seeds[:8] = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], dtype=torch.int32)
    valid = torch.from_numpy(rng.random(W) < 0.9)
    valid[:8] = True
    return seeds, valid


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("k", SAMPLE_BOUNDARY_KS)
def test_sample_kernel_at_its_design_boundaries(cuda_device, layout, k):
    """K1 and K1b at the redesign's switch points: k = 1, 2, 15, 16, 17, 31,
    32 (a team of k lanes, 32 // k rows a warp), 33, 48, 64, 300 and 512 (a
    warp a row, ceil(k / 32) steps a lane); rows of degree 0, k, k + 1 and
    past 10^6, invalid seeds, ids past both ends, and W a prime, so never a
    multiple of the rows a warp draws: bit-equal to the plain draw on the
    card and on the CPU, one kernel launch a call."""
    topo, n = _sample_boundary_graph(k)
    rng = np.random.default_rng(k + 100)
    W = 1031 if k <= 64 else 257
    seeds, valid = _boundary_seeds(rng, W, n)
    key = qrandom.split(qrandom.key(k + 7))[1]
    if layout == "tiled":
        g = topo.to_device_tiled(cuda_device)
        fn, plain = sample.tiled_sample_layer, sample.tiled_sample_layer_plain
    else:
        g = topo.to_device(cuda_device)
        fn, plain = sample.sample_layer, sample.sample_layer_plain
    args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
    torch.cuda.synchronize()
    _kernels.reset_kernel_launches()
    got = fn(*g, *args)
    assert _kernels.kernel_launches() == 1
    want = plain(*g, *args)
    cpu = plain(*(t.cpu() for t in g), seeds, valid, k, key)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, cpu):
        assert _same(a, b) and _same(a, c)
    counts = got[1].sum(1).cpu()
    assert counts[:4].tolist() == [0, k, k, k]  # deg 0, k, k + 1, the hub
    row1 = int(topo.indptr[1])
    assert torch.equal(got[0][1, :k].cpu(), torch.from_numpy(topo.indices[row1:row1 + k]))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("k", [48, 64, 300])
def test_sample_kernel_wide_fanouts_match_plain(cuda_device, layout, k):
    """K1 and K1b above 32 (a warp a row, ceil(k / 32) steps a lane),
    bit-equal to the plain draw on the card and on the CPU."""
    topo, n = _graph()
    rng = np.random.default_rng(k)
    W = 1024 if k < 300 else 256
    seeds = torch.from_numpy(rng.integers(-3, n + 3, W).astype(np.int32))
    seeds[:3] = torch.tensor([5, 7, 9], dtype=torch.int32)
    valid = torch.from_numpy(rng.random(W) < 0.9)
    valid[0] = True  # the hub
    key = qrandom.split(qrandom.key(k))[1]
    if layout == "tiled":
        g = topo.to_device_tiled(cuda_device)
        fn, plain = sample.tiled_sample_layer, sample.tiled_sample_layer_plain
    else:
        g = topo.to_device(cuda_device)
        fn, plain = sample.sample_layer, sample.sample_layer_plain
    args = (seeds.to(cuda_device), valid.to(cuda_device), k, key)
    got, want = fn(*g, *args), plain(*g, *args)
    cpu = plain(*(t.cpu() for t in g), seeds, valid, k, key)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, cpu):
        assert _same(a, b) and _same(a, c)
    assert int(got[1][0].sum()) == min(500, k)  # the hub draws a full subset
    with pytest.raises(ValueError, match="k <= 512"):
        fn(*g, args[0], args[1], 513, key)


def _padded_hop(rng, W, k, w_src, valid=0.8):
    """A hop as the dedup sampler pads it: valid lanes name rows below
    the source count, with a hub row named by ~5% of them; every masked lane
    names one real row (the count)."""
    count = int(w_src * 0.9)
    mask = rng.random((W, k)) < valid
    mask[0] = False
    c = rng.integers(0, count, (W, k)).astype(np.int32)
    c[rng.random((W, k)) < 0.05] = 3
    c[~mask] = count
    return torch.from_numpy(mask), torch.from_numpy(c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_src_kernel_matches_plain(cuda_device, dtype):
    """K14 on the hops of a batch-1024 step at GCN's and GAT's widths, and
    F = 1 (a thread a row), bit-equal: a copy; cols clipped at both ends."""
    rng = np.random.default_rng(11)
    for (W, k, w_src), rows in (((1024, 15, 16384), (47,)), ((1024, 15, 16384), (1,)),
                                ((16384, 10, 180224), (4, 256)), ((16384, 10, 180224), (256,)),
                                ((4096, 5, 24576), (100,)), ((4096, 5, 24576), (99,))):
        mask, cols = _padded_hop(rng, W, k, w_src)
        cols[1, :2] = torch.tensor([-3, w_src + 5], dtype=torch.int32)
        x = torch.from_numpy(rng.standard_normal((w_src,) + rows).astype(np.float32)).to(
            cuda_device, dtype)
        c = cols.to(cuda_device)
        before = _kernels.counts()["gather_src"]
        got = gather_src_rows(x, c)
        torch.cuda.synchronize()
        assert _kernels.counts()["gather_src"] == before + 1
        assert got.shape == (W, k) + rows and got.dtype == dtype
        assert _same(got, gather_src_plain(x, c))
        assert _same(got, gather_src_plain(x.cpu(), cols))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_src_backward_kernel_reruns_bit_equal_and_matches_cpu(cuda_device, dtype):
    """K14b on layers 1 and 2 of a batch-1024 step and GAT's widest hop
    (cut to 4,096 targets): a hub row, padded lanes all naming one real
    row, a target with no valid lane, columns clipped; F = 256, 1,024 (as
    [4, 256]) and 47. Bit-equal run twice and to the plain version on a
    CPU copy, which adds the valid lanes in the kernel's order."""
    rng = np.random.default_rng(12)
    for (W, k, w_src), rows in (((1024, 15, 16384), (47,)), ((1024, 15, 16384), (256,)),
                                ((16384, 10, 180224), (4, 256)), ((4096, 5, 24576), (99,))):
        mask, cols = _padded_hop(rng, W, k, w_src)
        cols[2, 0], mask[2, 0] = w_src + 7, True  # a valid lane past the source: clipped
        g = torch.from_numpy(rng.standard_normal((W, k) + rows).astype(np.float32)).to(
            cuda_device, dtype)
        m, c = mask.to(cuda_device), cols.to(cuda_device)
        before = _kernels.counts()["gather_src_backward"]
        got = gather_src_backward(g, m, c, w_src)
        again = gather_src_backward(g, m, c, w_src)
        torch.cuda.synchronize()
        assert _kernels.counts()["gather_src_backward"] == before + 2
        assert got.shape == (w_src,) + rows and got.dtype == dtype
        assert _same(got, again)
        assert _same(got, gather_src_backward_plain(g.cpu(), mask, cols, w_src))
        pad = int(w_src * 0.9)  # the row every masked lane names: no valid lane does
        assert got[3].any() and got[-1].any() and not got[pad].any()


@pytest.mark.cuda
def test_gather_src_autograd_on_card_matches_cpu(cuda_device):
    """The autograd Function end to end on a [W_src, H, D] source: the
    gradient of x_src through K14 and K14b equals the CPU's plain path."""
    rng = np.random.default_rng(13)
    W, k, w_src = 512, 10, 3000
    mask, cols = _padded_hop(rng, W, k, w_src)
    x = torch.from_numpy(rng.standard_normal((w_src, 2, 32)).astype(np.float32))
    R = torch.from_numpy(rng.standard_normal((W, k, 2, 32)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        xs = x.to(dev, copy=True).requires_grad_(True)
        m = mask.to(dev)
        (gather_src(xs, m, cols.to(dev)) * R.to(dev) * m[..., None, None]).sum().backward()
        grads.append(xs.grad.cpu())
    assert torch.equal(grads[1], grads[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_src_backward_launches_one_kernel_a_call(cuda_device, dtype):
    """K14b at the zoo's shapes (the three hops of a batch-1024 step at
    sizes [15, 10, 5], GAT's and GCN's widths): one counted wrapper call
    and one kernel on the host's launch count a call, bit-equal run twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    hops = (((180224, 5, 1081344), (1024,)), ((16384, 10, 180224), (1024,)),
            ((16384, 10, 180224), (256,)), ((1024, 15, 16384), (256,)),
            ((1024, 15, 16384), (47,)))
    for (W, k, w_src), rows in hops:
        if dtype == torch.bfloat16 and rows == (47,):
            continue
        mask = torch.rand((W, k), generator=gen, device=cuda_device) < 0.8
        cols = torch.randint(0, w_src, (W, k), generator=gen, device=cuda_device,
                             dtype=torch.int32)
        g = torch.randn((W, k) + rows, generator=gen, device=cuda_device).to(dtype)
        got = gather_src_backward(g, mask, cols, w_src)
        torch.cuda.synchronize()
        before = _kernels.counts()["gather_src_backward"]
        _kernels.reset_kernel_launches()
        again = gather_src_backward(g, mask, cols, w_src)
        launches = _kernels.kernel_launches()
        torch.cuda.synchronize()
        assert launches == 1, (W, k, w_src, rows, launches)
        assert _kernels.counts()["gather_src_backward"] == before + 1
        assert _same(got, again)
        del g, got, again


def _src_backward_case(name, W, rng):
    """(g [W, k, F] float32, mask, cols, w_src) of a K14b boundary case over
    W targets (1,024: the small path's at most 32,768 lanes; 4,096: the
    grid's path)."""
    k, w_src, F = 15, 16384, 47
    mask = rng.random((W, k)) < 0.8
    cols = rng.integers(0, w_src, (W, k)).astype(np.int32)
    if name == "no valid lane":
        mask[:] = False
    elif name == "one source row":
        w_src = 1
    elif name == "65,536 lanes on one source":
        W, k = 4096, 16
        mask, cols = np.ones((W, k), bool), np.full((W, k), 5, np.int32)
    elif name == "a hub across bitmap windows":
        W, k, w_src = 400000, 5, 500000
        mask = rng.random((W, k)) < 0.9
        cols = rng.integers(0, w_src, (W, k)).astype(np.int32)
        cols[rng.random((W, k)) < 0.01] = 3  # ~18,000 lanes over 2,000,000 lane indices
    elif name == "segments of 2, 32, 33, 256 and 257 lanes":
        cols = rng.integers(100, w_src, (W, k)).astype(np.int32)
        mask[:] = True
        sizes = (2, 32, 33, 256, 257)
        flat = cols.reshape(-1)
        flat[rng.choice(W * k, sum(sizes), replace=False)] = np.repeat(np.arange(5), sizes)
    elif name == "segments of 1,024 and 1,025 lanes":
        W, k = 4096, 16
        mask = np.ones((W, k), bool)
        cols = rng.integers(100, w_src, (W, k)).astype(np.int32)
        flat = cols.reshape(-1)
        flat[rng.choice(W * k, 1024 + 1025, replace=False)] = [0] * 1024 + [1] * 1025
    elif name == "rows of 64 and 65 lanes":
        cols = rng.integers(100, w_src, (W, k)).astype(np.int32)
        mask[:] = True
        flat = cols.reshape(-1)
        flat[rng.choice(W * k, 64 + 65, replace=False)] = [1] * 64 + [2] * 65
    elif name == "more column chunks than warps":
        W, k, w_src, F = W // 4, 4 if W == 1024 else 33, 3000, 33 * 128
        mask = rng.random((W, k)) < 0.9
        cols = rng.integers(0, w_src, (W, k)).astype(np.int32)
        cols[:100, 0], mask[:100, 0] = 3, True  # a row the whole block sums
    elif name == "cols outside the source":
        cols = rng.integers(-w_src, 2 * w_src, (W, k)).astype(np.int32)
    elif name == "F = 1 over a products-sized source":
        W, k, w_src, F = 180224, 5, 1081344, 1
        mask = rng.random((W, k)) < 0.7
        cols = rng.integers(0, w_src, (W, k)).astype(np.int32)
    elif name == "F = 1,024":
        W, k, w_src, F = W if W == 1024 else 2 * W, 5, 24576, 1024
        mask = rng.random((W, k)) < 0.8
        cols = rng.integers(0, w_src, (W, k)).astype(np.int32)
        cols[rng.random((W, k)) < 0.05] = 3
    elif name == "F = 256 rows misaligned":
        F = 256
    g = rng.standard_normal((W, k, F)).astype(np.float32)
    return torch.from_numpy(g), torch.from_numpy(mask), torch.from_numpy(cols), w_src


SRC_BACKWARD_CASES = [
    (name, W)
    for name in ("no valid lane", "one source row", "segments of 2, 32, 33, 256 and 257 lanes",
                 "rows of 64 and 65 lanes", "more column chunks than warps",
                 "cols outside the source", "F = 1,024", "F = 256 rows misaligned", "bfloat16")
    for W in (1024, 4096)
] + [(name, 4096) for name in ("65,536 lanes on one source", "a hub across bitmap windows",
                               "segments of 1,024 and 1,025 lanes",
                               "F = 1 over a products-sized source")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,W", SRC_BACKWARD_CASES,
                         ids=[f"{n}, {w} targets" for n, w in SRC_BACKWARD_CASES])
def test_gather_src_backward_kernel_at_its_design_boundaries(cuda_device, name, W):
    """K14b across its switch points, on its small path (1,024 targets of
    15 lanes: every block orders and sums its own rows in shared memory)
    and its grid path (4,096 and more): no valid lane, W_src = 1, segments
    at the warps' batched and register sorts' bounds (32, 33), the small
    path's shared-memory sort's (256, 257) and the grid path's (1,024,
    1,025), rows at the block sum's bound (64, 65), more column chunks
    than a block has warps, clipped cols, one source of 65,536 lanes, a hub
    whose lane indices span two bitmap windows, 1,056 count tiles at F = 1,
    F = 1,024 and F = 256 rows whose pointer is not 16-byte aligned (the
    scalar path): bit-equal run twice and to the plain version on a CPU
    copy, in one kernel a call; bfloat16 equal to the float32 sum rounded
    once."""
    rng = np.random.default_rng(SRC_BACKWARD_CASES.index((name, W)) + 21)
    g, mask, cols, w_src = _src_backward_case(name if name != "bfloat16" else "", W, rng)
    m, c = mask.to(cuda_device), cols.to(cuda_device)
    gd = g.to(cuda_device)
    if name == "F = 256 rows misaligned":  # a view one element into its storage
        flat = torch.empty(g.numel() + 1, device=cuda_device)
        flat[1:] = gd.reshape(-1)
        gd = flat[1:].view(g.shape)
        assert gd.data_ptr() % 16 != 0
    if name == "bfloat16":
        gd = gd.to(torch.bfloat16)
    _kernels.reset_kernel_launches()
    got = gather_src_backward(gd, m, c, w_src)
    assert _kernels.kernel_launches() == 1
    again = gather_src_backward(gd, m, c, w_src)
    torch.cuda.synchronize()
    assert got.shape == (w_src,) + tuple(g.shape[2:]) and got.dtype == gd.dtype
    assert _same(got, again)
    assert _same(got, gather_src_backward_plain(gd.cpu(), mask, cols, w_src))
    if name == "bfloat16":
        assert _same(got, gather_src_backward(gd.float(), m, c, w_src).to(torch.bfloat16))
    if name == "no valid lane":
        assert not got.any()


@pytest.mark.cuda
def test_block_out_degree_kernel_matches_plain(cuda_device):
    """K14c on the three hops of a batch-1024 step, with negative cols
    (counted from the end) and cols outside [-W_src, W_src) (dropped): one
    kernel a call on the host's launch count, a table in shared memory on
    the outer hop only."""
    rng = np.random.default_rng(14)
    for (W, k, w_src), table in zip(((1024, 15, 16384), (16384, 10, 180224),
                                     (180224, 5, 1081344)), (False, False, True)):
        mask, cols = _padded_hop(rng, W, k, w_src)
        cols[1] = torch.tensor([-1, -w_src, -w_src - 1, w_src, 0] * 3, dtype=torch.int32)[:k]
        mask[1] = True
        m, c = mask.to(cuda_device), cols.to(cuda_device)
        assert (_kernels.block_out_degree_plan(W * k, w_src)[1] > 0) == table
        _kernels.reset_kernel_launches()
        got = block_out_degree(m, c, w_src)
        assert _kernels.kernel_launches() == 1
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert _same(got, block_out_degree_plain(m, c, w_src))
        assert _same(got, block_out_degree_plain(mask, cols, w_src))
        assert int(got.sum()) == int(mask.sum()) - 2 * (k // 5)  # -W_src - 1 and W_src drop


# K14c's switch points (csrc/aggregate.cu): one cooperative grid of at most
# `blocks` (the co-resident count, from the plan of a large call); a block
# of at least 4,096 lanes merges them in a table of at most 16,384 slots;
# float atomics count up to 2^24 lanes. A case: blocks -> (W, k, W_src,
# whether a block takes a table); "aligned" cases start 3 lanes into their
# tensors, so the cols are not 16-byte aligned (one lane a load)
K14C_HASH_MIN_LANES = 4096
K14C_CASES = {
    "no lanes": lambda b: (0, 15, 1000, False),
    "every lane masked out": lambda b: (1024, 15, 16384, False),
    "one source": lambda b: (1024, 15, 1, False),
    "lanes not a multiple of 4": lambda b: (1023, 3, 5000, False),
    "cols not 16-byte aligned": lambda b: (1023, 3, 5000, False),
    "a lane short of a table": lambda b: ((K14C_HASH_MIN_LANES - 1) * b, 1, 5000, False),
    "a table's fewest lanes": lambda b: (K14C_HASH_MIN_LANES * b // 8, 8, 5000, True),
    "more sources than lanes": lambda b: (20_000, 5, 180_224, False),
    "every lane on one source": lambda b: (300_000, 5, 1, True),
    "crowded tables": lambda b: (600_000, 5, 4_000_000, True),
    "integer counts past 2^24 lanes": lambda b: ((1 << 20) + 1, 16, 1_081_344, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K14C_CASES))
def test_block_out_degree_kernel_at_its_design_boundaries(cuda_device, name):
    """K14c on both sides of its table switch and at its edges: bit-equal
    to its plain version on the card and on the CPU and when run twice, one
    kernel a call, a table where the plan says; cols in [-W_src - 2,
    W_src + 2) (negative ones count from the end, the others past the
    source drop), a twentieth of the lanes on one hub; no lanes, every lane
    masked out, one source, a tail of lanes past the last 4-lane load,
    unaligned cols (one lane a load), more sources a block than its table
    holds and integer counts past 2^24 lanes."""
    blocks = _kernels.block_out_degree_plan(10**7, 10**7)[0]
    W, k, w_src, table = K14C_CASES[name](blocks)
    skew = 3 if "aligned" in name else 0
    n = W * k + skew
    rng = np.random.default_rng(sum(map(ord, name)))
    mask = torch.from_numpy(rng.random(n) < (0.0 if "masked" in name else 0.8))
    c = rng.integers(-w_src - 2, w_src + 2, n)
    c[rng.random(n) < 0.05] = w_src // 2
    cols = torch.from_numpy(c.astype(np.int32))
    m, cc = mask.to(cuda_device)[skew:].view(W, k), cols.to(cuda_device)[skew:].view(W, k)
    mask, cols = mask[skew:].view(W, k), cols[skew:].view(W, k)
    assert (cc.data_ptr() % 16 != 0) == bool(skew)
    assert (_kernels.block_out_degree_plan(W * k, w_src)[1] > 0) == table
    _kernels.reset_kernel_launches()
    got = block_out_degree(m, cc, w_src)
    assert _kernels.kernel_launches() == 1
    again = block_out_degree(m, cc, w_src)
    torch.cuda.synchronize()
    want = block_out_degree_plain(mask, cols, w_src)
    assert got.dtype == torch.float32 and got.shape == (w_src,)
    assert _same(got, want) and _same(got, again)
    assert _same(got, block_out_degree_plain(m, cc, w_src))
    if W == 0 or "masked" in name:
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("structural", [False, True])
def test_bf16_mean_kernels_round_the_float32_kernels_once(cuda_device, structural):
    """K4 and K4b on bfloat16 rows at SAGE's shapes: equal to the float32
    kernels run on the same (bfloat16-valued) inputs, rounded once; and
    K4 within its float32 bar of the plain version."""
    rng = np.random.default_rng(15)
    for (W, k), D in (((1024, 15), 256), ((16384, 10), 256), ((180224, 5), 100)):
        w_src = W * (1 + k)
        mask = torch.from_numpy(rng.random((W, k)) < 0.8).to(cuda_device)
        cols = None if structural else torch.from_numpy(
            rng.integers(-2, w_src + 2, (W, k)).astype(np.int32)).to(cuda_device)
        adj = DenseAdj(cols, mask, None, None)
        x = torch.from_numpy(rng.standard_normal((w_src, D)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        got = masked_mean_aggregate(x, adj)
        assert got.dtype == torch.bfloat16
        assert _same(got, masked_mean_aggregate(x.float(), adj).to(torch.bfloat16))
        torch.testing.assert_close(got.float(), masked_mean_aggregate_plain(x, adj).float(),
                                   atol=1e-2, rtol=1e-2)
        g = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        gx = masked_mean_backward(g, mask, cols, w_src)
        assert gx.dtype == torch.bfloat16
        assert _same(gx, masked_mean_backward(g.float(), mask, cols, w_src).to(torch.bfloat16))


# -- the multi-device slice: K13a, K13b, K9c ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("D", [100, 99])
def test_sharded_rows_kernel_matches_plain(cuda_device, dtype, D):
    """K13a: each shard's partial of a striped table, bit-equal to its plain
    version on the card and on the CPU, for ids below, inside and past the
    shard and the padding sentinel; the shards' partials sum to the rows."""
    from quiver_tpu_torch.parallel.collectives import partial_rows, partial_rows_plain

    rng = np.random.default_rng(D)
    N, shards = 1001, 4
    R = -(-N // shards)
    if dtype == torch.int8:
        table = torch.from_numpy(rng.integers(-127, 128, (shards * R, D)).astype(np.int8))
    else:
        table = torch.from_numpy(rng.standard_normal((shards * R, D)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(-5, N + 40, 4096).astype(np.int32))
    ids[:2] = torch.tensor([np.iinfo(np.int32).max, -1], dtype=torch.int32)
    total = torch.zeros((ids.shape[0], D), dtype=torch.float64)
    _kernels.reset_counts()
    for p in range(shards):
        block = table[p * R:(p + 1) * R]
        got = partial_rows(block.to(cuda_device), ids.to(cuda_device), p)
        want = partial_rows_plain(block.to(cuda_device), ids.to(cuda_device), p)
        cpu = partial_rows_plain(block, ids, p)
        torch.cuda.synchronize()
        assert _same(got, want) and _same(got, cpu)
        total += got.cpu().double()
    assert _kernels.counts()["sharded_rows"] == shards
    inside = ((ids >= 0) & (ids < shards * R)).numpy()
    want = np.where(inside[:, None], table.double().numpy()[np.clip(ids.numpy(), 0,
                                                                     shards * R - 1)], 0)
    assert np.array_equal(total.numpy(), want)


def _owned_seeds(rng, W, n):
    """`_hop_seeds` with every id a node of the graph: an id no shard owns
    draws nothing from the sharded graph, where the unsharded one clips it."""
    seeds, valid = _hop_seeds(rng, W, n)
    return torch.clamp(seeds, 0, n - 1), valid


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("k", [1, 15, 17, 33, 64, 512])
def test_sharded_sample_kernel_matches_plain_and_unsharded(cuda_device, layout, k):
    """K13b on 3 shards (one owning the hub), with seeds on both sides of
    every owner window's edges: each partial bit-equal to its plain version
    on the card and on the CPU, one kernel launch a call; the partials sum
    to the unsharded K1/K1b draw on its valid lanes, neighbor 0 elsewhere;
    the stacked slab of 2 and 3 groups (the grouped hop's [G, 2, w, k]) holds
    the same neighbors and flags, group by group."""
    from quiver_tpu_torch.parallel.topology import (
        build_tiled_topology_shards,
        build_topology_shards,
        sample_layer_partial,
        sample_layer_partial_plain,
        sample_layer_partial_slab,
        tiled_sample_layer_partial,
        tiled_sample_layer_partial_plain,
        tiled_sample_layer_partial_slab,
    )

    topo, n = _graph()
    rng = np.random.default_rng(k)
    W = 2046 if k <= 64 else 258  # splits into 2 and 3 groups
    seeds, valid = _owned_seeds(rng, W, n)
    key = qrandom.split(qrandom.key(k))[1]
    if layout == "tiled":
        a, b, rs = build_tiled_topology_shards(topo.indptr, topo.indices.astype(np.int32), 3)
        fn, plain, slab_fn = (tiled_sample_layer_partial, tiled_sample_layer_partial_plain,
                              tiled_sample_layer_partial_slab)
    else:
        a, b, rs = build_topology_shards(topo.indptr, topo.indices.astype(np.int32), 3)
        fn, plain, slab_fn = (sample_layer_partial, sample_layer_partial_plain,
                              sample_layer_partial_slab)
    edges = [int(rs[p]) + d for p in range(1, 3) for d in (-1, 0)] + [0, n - 1]
    seeds[8:8 + len(edges)] = torch.tensor(edges, dtype=torch.int32)
    valid[8:8 + len(edges)] = True
    if layout == "tiled":
        ref = sample.tiled_sample_layer(*topo.to_device_tiled(cuda_device), seeds.to(cuda_device),
                                        valid.to(cuda_device), k, key)
    else:
        ref = sample.sample_layer(*topo.to_device(cuda_device), seeds.to(cuda_device),
                                  valid.to(cuda_device), k, key)
    nbrs = torch.zeros((seeds.shape[0], k), dtype=torch.int32)
    vsum = torch.zeros((seeds.shape[0], k), dtype=torch.int32)
    for p in range(3):
        blk = (torch.from_numpy(a[p]), torch.from_numpy(b[p]))
        win = (int(rs[p]), int(rs[p + 1]))
        dev_args = (*(t.to(cuda_device) for t in blk), *win, seeds.to(cuda_device),
                    valid.to(cuda_device), k, key)
        torch.cuda.synchronize()
        _kernels.reset_kernel_launches()
        got = fn(*dev_args)
        assert _kernels.kernel_launches() == 1
        want, cpu = plain(*dev_args), plain(*blk, *win, seeds, valid, k, key)
        torch.cuda.synchronize()
        for x, y, z in zip(got, want, cpu):
            assert x.dtype == torch.int32 and _same(x, y) and _same(x, z)
        for G in (2, 3):
            slab = slab_fn(*dev_args, groups=G)
            w = seeds.shape[0] // G
            assert slab.shape == (G, 2, w, k)
            assert _same(slab[:, 0].reshape(-1, k), got[0])
            assert _same(slab[:, 1].reshape(-1, k), got[1])
        nbrs += got[0].cpu()
        vsum += got[1].cpu()
    rv = ref[1].cpu()
    assert torch.equal(vsum > 0, rv) and int(vsum.max()) == 1
    assert torch.equal(nbrs[rv], ref[0].cpu()[rv]) and not nbrs[~rv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16", "fp32"])
def test_sharded_dequant_kernel_matches_plain_and_k9a(cuda_device, codec):
    """K9c: the decode of the summed payload bit-equal to its plain version
    on the card and on the CPU, and to K9a on the unsharded payload for
    in-range ids; ids outside [0, N) give zero rows."""
    from quiver_tpu_torch.parallel.collectives import partial_rows
    from quiver_tpu_torch.quant.lookup import sharded_dequant, sharded_dequant_plain

    c = get_codec(codec)
    rng = np.random.default_rng(3)
    N, D, shards = 1001, 100, 2
    enc = c.encode(rng.standard_normal((N, D)).astype(np.float32) * 3)
    payload = torch.as_tensor(enc.payload)
    R = -(-N // shards)
    padded = torch.cat([payload, torch.zeros((shards * R - N, D), dtype=payload.dtype)])
    side = () if enc.scale is None else (torch.from_numpy(enc.scale), torch.from_numpy(enc.zero))
    ids = torch.from_numpy(rng.integers(-3, N + 3, 4096).astype(np.int32))
    dev = cuda_device
    q = sum(partial_rows(padded[p * R:(p + 1) * R].to(dev), ids.to(dev), p).cpu()
            for p in range(shards)).to(payload.dtype)
    args = (q.to(dev), ids.to(dev), *(t.to(dev) for t in side))
    got, want = sharded_dequant(c, *args), sharded_dequant_plain(c, *args)
    cpu = sharded_dequant_plain(c, q, ids, *side)
    k9a = gather_dequant(c, payload.to(dev), ids.to(dev), *(t.to(dev) for t in side))
    torch.cuda.synchronize()
    assert _same(got, want) and _same(got, cpu)
    ok = ((ids >= 0) & (ids < N)).numpy()
    assert _same(got[ok], k9a[ok]) and not got.cpu()[~ok].any()


@pytest.mark.cuda
def test_rank_threads_gather_and_sample_on_the_card(cuda_device):
    """Four rank threads (dp 2 x ici 2) on one card over gloo: the sharded
    gather of float32, bfloat16 and int8 rows and the sharded draw equal the
    unsharded ones on every rank."""
    from quiver_tpu_torch.parallel import (
        local_meshes,
        run_ranks,
        shard_feature_rows,
        shard_topology_rows,
        sharded_gather,
        sharded_sample_layer,
        tiled_sharded_sample_layer,
    )

    topo, n = _graph()
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((n, 100)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-2, n + 2, 5000).astype(np.int32))
    seeds, valid = _owned_seeds(rng, 1024, n)
    key = qrandom.key(9)
    ref = sample.sample_layer(*topo.to_device(cuda_device), seeds.to(cuda_device),
                              valid.to(cuda_device), 10, key)
    meshes = local_meshes(4, dp=2, device=cuda_device, timeout_s=120)

    def rank(m):
        out = {}
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            t = table.to(dt) if dt != torch.int8 else (table * 20).to(dt)
            out[dt] = sharded_gather(shard_feature_rows(m, t), ids.to(m.device), m)
        for layout in ("flat", "tiled"):
            st = shard_topology_rows(m, topo, layout=layout)
            a = (st.indptr, st.indices) if layout == "flat" else (st.bd, st.tiles)
            fn = sharded_sample_layer if layout == "flat" else tiled_sharded_sample_layer
            out[layout] = fn(*a, st.row_start, seeds.to(m.device), valid.to(m.device), 10, key, m)
        return out

    rv = ref[1].cpu()
    ok = ((ids >= 0) & (ids < n)).numpy()
    for out in run_ranks(rank, meshes):
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            t = table.to(dt) if dt != torch.int8 else (table * 20).to(dt)
            got = out[dt].cpu()
            assert got.dtype == dt and _same(got[ok], t[ids[ok].long()]) and not got[~ok].any()
        for layout in ("flat", "tiled"):
            nb, v = (x.cpu() for x in out[layout])
            assert torch.equal(v, rv) and torch.equal(nb[rv], ref[0].cpu()[rv])


@pytest.mark.cuda
def test_run_ranks_waits_for_the_callers_queued_work(cuda_device):
    """Work the caller queued on its stream and did not synchronize (about
    40 ms of adds here) is done before any rank thread's stream reads its
    result."""
    from quiver_tpu_torch.parallel import local_meshes, run_ranks

    meshes = local_meshes(4, dp=2, device=cuda_device, timeout_s=120)
    x = torch.zeros(1 << 26, dtype=torch.int32, device=cuda_device)
    for _ in range(200):
        x.add_(1)
    sums = run_ranks(lambda m: int(x.sum()), meshes)
    assert sums == [200 * (1 << 26)] * 4


def _same_bits(a, b):
    """Bit-equal (so -0.0 and +0.0 differ), on the CPU."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int16)
        b = b.view(a.dtype)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int32])
@pytest.mark.parametrize("D", [100, 99])
def test_grouped_unpack_kernel_matches_plain(cuda_device, dtype, D):
    """K13c's unpack of G = 2 and 3 slabs, one nonzero owner an element (a
    -0.0 owner among +0.0 rows gives +0.0), bit-equal to its plain version
    on the card and on the CPU and to the owners' rows; D = 99 takes the
    one-element path. The grouped draw's int32 [G, W, k] slabs likewise."""
    from quiver_tpu_torch.parallel.collectives import grouped_unpack, grouped_unpack_plain

    rng = np.random.default_rng(D)
    for G in (2, 3):
        W = 3001
        owner = rng.integers(0, G, (W, D))
        if dtype in (torch.int8, torch.int32):
            vals = torch.from_numpy(rng.integers(-100, 100, (W, D))).to(dtype)
        else:
            vals = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32)).to(dtype)
            vals[:5] = -0.0
        slabs = torch.zeros((G, W, D), dtype=dtype)
        for g in range(G):
            slabs[g][torch.from_numpy(owner == g)] = vals[torch.from_numpy(owner == g)]
        _kernels.reset_counts()
        got = grouped_unpack(slabs.to(cuda_device))
        want = grouped_unpack_plain(slabs.to(cuda_device))
        torch.cuda.synchronize()
        assert _kernels.counts()["grouped_unpack"] == 1
        assert _same_bits(got, want) and _same_bits(got, grouped_unpack_plain(slabs))
        expect = vals.clone()
        if dtype.is_floating_point:
            expect[:5] = 0.0  # -0.0 plus the others' +0.0
        assert _same_bits(got, expect)
    a = torch.from_numpy(rng.integers(-9, 9, (2, 4097, 5)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, (2, 4097, 5)).astype(np.int32))
    for shape in ((2, 4097, 5), (2, 4096, 5)):
        x, y = a[:, :shape[1]].contiguous(), b[:, :shape[1]].contiguous()
        got = grouped_unpack(x.to(cuda_device)), grouped_unpack(y.to(cuda_device))
        torch.cuda.synchronize()
        assert _same(got[0], x.sum(0)) and _same(got[1], y.sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [5000, 1_081_344 + 77])
def test_cold_compact_kernel_matches_plain(cuda_device, W):
    """K13d's compaction with n_cold below, at and above the budget, W not a
    multiple of the 1,024-lane tile (and past 1,024 tiles), ids out of
    range: sel, cold_local and (n_cold, overflow) bit-equal to its plain
    version (the stable argsort) on the card and on the CPU, one kernel a
    call on the host's launch count."""
    from quiver_tpu_torch.parallel.collectives import cold_compact, cold_compact_plain

    rng = np.random.default_rng(W % 97)
    ids = torch.from_numpy(rng.integers(-50, 2_500_000, W).astype(np.int32))
    ids[:3] = torch.tensor([np.iinfo(np.int32).max, -1, 2_000_000], dtype=torch.int32)
    lo, hi = 400_000, 2_000_000
    n_cold = int(((ids >= lo) & (ids < hi)).sum())
    for budget in (n_cold - 1000, n_cold, n_cold + 777, W, 0):
        _kernels.reset_counts()
        _kernels.reset_kernel_launches()
        got = cold_compact(ids.to(cuda_device), lo, hi, budget)
        assert _kernels.kernel_launches() == 1
        want = cold_compact_plain(ids.to(cuda_device), lo, hi, budget)
        cpu = cold_compact_plain(ids, lo, hi, budget)
        torch.cuda.synchronize()
        assert _kernels.counts()["cold_compact"] == (1 if W else 0)
        for x, y, z in zip(got, want, cpu):
            assert x.dtype == torch.int32 and _same(x, y) and _same(x, z)
        assert got[2].tolist() == [n_cold, max(n_cold - budget, 0)]


# the compaction's widths: one lane, a tile (1,024 lanes) and one either side,
# and past the lanes the resident grid keeps in shared memory (at most 2
# blocks of 1,024 threads an SM, 8,192 ids a block)
COMPACT_WIDTHS = (1, 1023, 1024, 1025, 2_500_077)


@pytest.mark.cuda
@pytest.mark.parametrize("W", COMPACT_WIDTHS)
@pytest.mark.parametrize("cold", ["none", "all", "some"])
def test_cold_compact_kernel_at_its_design_boundaries(cuda_device, W, cold):
    """K13d's compaction with no cold lane, every lane cold and a third
    cold, at budgets 0, n_cold and W (and either side of n_cold): bit-equal
    to its plain version on the card and on the CPU, one kernel a call;
    the widest W reads past one pass of the resident grid's shared memory."""
    from quiver_tpu_torch.parallel.collectives import cold_compact, cold_compact_plain

    if W == COMPACT_WIDTHS[-1]:
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        assert W > sms * 2 * 8192
    rng = np.random.default_rng(W + len(cold))
    lo, hi = 1000, 2000
    share = {"none": 0.0, "all": 1.0, "some": 1 / 3}[cold]
    ids = np.where(rng.random(W) < share, rng.integers(lo, hi, W), rng.integers(0, lo, W))
    if cold != "all":
        ids[rng.random(W) < 0.01] = np.iinfo(np.int32).max  # neither hot nor cold
    ids = torch.from_numpy(ids.astype(np.int32))
    n_cold = int(((ids >= lo) & (ids < hi)).sum())
    assert n_cold == {"none": 0, "all": W}.get(cold, n_cold)
    d = ids.to(cuda_device)
    for budget in sorted({0, max(n_cold - 1, 0), n_cold, min(n_cold + 1, W), W}):
        _kernels.reset_kernel_launches()
        got = cold_compact(d, lo, hi, budget)
        assert _kernels.kernel_launches() == 1
        cpu = cold_compact_plain(ids, lo, hi, budget)
        torch.cuda.synchronize()
        for x, z in zip(got, cpu):
            assert x.dtype == torch.int32 and _same(x, z)


@pytest.mark.cuda
def test_cooperative_kernels_from_four_threads_at_once(cuda_device):
    """Four threads, each on its own stream, launch K13d's compaction and
    K14c's grid path (both cooperative launches of the co-resident grid)
    twenty times each at once, as the host legs' rank threads do on one
    card: no launch fails, none hangs, every result is the plain version's."""
    import threading

    from quiver_tpu_torch.parallel.collectives import cold_compact, cold_compact_plain

    rng = np.random.default_rng(44)
    W, lo, hi, budget = 901_120, 1000, 2000, 619_008
    ids = torch.from_numpy(np.where(rng.random(W) < 0.36, rng.integers(lo, hi, W),
                                    rng.integers(0, lo, W)).astype(np.int32))
    mask, cols = _padded_hop(rng, 180_224, 5, 1_081_344)
    want = cold_compact_plain(ids, lo, hi, budget)
    want_deg = block_out_degree_plain(mask, cols, 1_081_344)
    d, m, c = ids.to(cuda_device), mask.to(cuda_device), cols.to(cuda_device)
    torch.cuda.synchronize()  # the inputs are on the card before the threads' streams read them
    start = threading.Barrier(4)
    results, errors = [None] * 4, []

    def worker(i):
        try:
            stream = torch.cuda.Stream(cuda_device)
            start.wait()
            outs = []
            with torch.cuda.stream(stream):
                for _ in range(20):
                    outs.append((cold_compact(d, lo, hi, budget),
                                 block_out_degree(m, c, 1_081_344)))
            stream.synchronize()
            results[i] = outs
        except Exception as exc:  # reported below with the thread's index
            errors.append((i, exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for outs in results:
        for compact, deg in outs:
            assert all(_same(x, y) for x, y in zip(compact, want)) and _same(deg, want_deg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cold_merge_kernel_matches_plain(cuda_device, dtype):
    """K13d's merge: cold rows added at their selected lanes for the first
    n_cold budget lanes, zero rows added past them (a -0.0 hot element
    becomes +0.0), bit-equal to its plain version on the card and on the
    CPU and to index_add_ of the masked rows."""
    from quiver_tpu_torch.parallel.collectives import (
        cold_compact,
        cold_merge,
        cold_merge_plain,
    )

    rng = np.random.default_rng(11)
    W, D = 20_000, 100
    ids = torch.from_numpy(rng.integers(0, 1000, W).astype(np.int32))
    n_cold = int((ids >= 800).sum())
    budget = n_cold + 300
    sel, _, counts = cold_compact(ids.to(cuda_device), 800, 1000, budget)
    hot = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32)).to(dtype)
    hot[sel[n_cold:n_cold + 3].long().cpu(), 7] = -0.0
    cold = torch.from_numpy(rng.standard_normal((budget, D)).astype(np.float32)).to(dtype)
    _kernels.reset_counts()
    got = cold_merge(hot.to(cuda_device), sel, cold.to(cuda_device), counts)
    want = cold_merge_plain(hot.to(cuda_device), sel, cold.to(cuda_device), counts)
    cpu = cold_merge_plain(hot, sel.cpu(), cold, counts.cpu())
    torch.cuda.synchronize()
    assert _kernels.counts()["cold_merge"] == 1
    assert _same_bits(got, want) and _same_bits(got, cpu)
    add = torch.where(torch.arange(budget)[:, None] < n_cold, cold.float(), 0.0)
    ref = hot.float().index_add_(0, sel.long().cpu(), add).to(dtype)
    assert _same_bits(got, ref)
    assert not got[sel[n_cold:n_cold + 3].long(), 7].signbit().any()


@pytest.mark.cuda
def test_rank_threads_host_axis_on_the_card(cuda_device):
    """Four rank threads (host 2 x dp 1 x ici 2) on one card over gloo: each
    host's own ids through the grouped gather (float32, bfloat16, int8; both
    via spellings) and the hot/cold gather, and each host's own frontier
    through the grouped draw (flat and tiled), equal the unsharded rows and
    the unsharded K1b draw on its valid lanes; the new kernels launched."""
    from quiver_tpu_torch.parallel import (
        local_meshes,
        run_ranks,
        shard_feature_hot_cold,
        shard_feature_rows,
        shard_topology_rows,
        sharded_gather_grouped,
        sharded_gather_hot_cold,
        sharded_sample_layer_grouped,
        tiled_sharded_sample_layer_grouped,
    )

    topo, n = _graph()
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((n, 100)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-2, n + 2, (2, 5000)).astype(np.int32))
    seeds, valid = _owned_seeds(rng, 2 * 1024, n)
    key = qrandom.key(13)
    ref = sample.sample_layer(*topo.to_device(cuda_device), seeds.to(cuda_device),
                              valid.to(cuda_device), 10, key)
    meshes = local_meshes(4, hosts=2, device=cuda_device, timeout_s=120)
    feat = ("host", "ici")
    hot_rows = n // 5

    def rank(m):
        h, out = m.host_idx, {}
        mine = ids[h].to(m.device)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            t = table.to(dt) if dt != torch.int8 else (table * 20).to(dt)
            for via in ("scatter", "psum"):
                out[dt, via] = sharded_gather_grouped(shard_feature_rows(m, t), mine, m, feat,
                                                      "host", via=via)
        hot, cold = shard_feature_hot_cold(m, table, hot_rows)
        out["hot_cold"] = sharded_gather_hot_cold(hot, cold, mine, m, feat, "host", hot_rows,
                                                  1.0)
        sl = slice(h * 1024, (h + 1) * 1024)
        for layout in ("flat", "tiled"):
            st = shard_topology_rows(m, topo, layout=layout)
            a = (st.indptr, st.indices) if layout == "flat" else (st.bd, st.tiles)
            fn = (sharded_sample_layer_grouped if layout == "flat"
                  else tiled_sharded_sample_layer_grouped)
            out[layout] = fn(*a, st.row_start, seeds[sl].to(m.device), valid[sl].to(m.device),
                             10, key, m, feat, "host")
        return out

    _kernels.reset_counts()
    results = run_ranks(rank, meshes)
    counts = _kernels.counts()
    for name in ("grouped_unpack/float32", "grouped_unpack/bfloat16", "grouped_unpack/int8",
                 "cold_compact", "cold_merge/float32", "grouped_unpack/int32"):
        assert counts[name] > 0, name
    for m, out in zip(meshes, results):
        h = m.host_idx
        mine = ids[h]
        ok = ((mine >= 0) & (mine < n)).numpy()
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            t = table.to(dt) if dt != torch.int8 else (table * 20).to(dt)
            for via in ("scatter", "psum"):
                got = out[dt, via].cpu()
                assert got.dtype == dt and _same(got[ok], t[mine[ok].long()])
                assert not got[~ok].any()
        rows, over = out["hot_cold"]
        assert int(over) == 0
        assert _same(rows.cpu()[ok], table[mine[ok].long()]) and not rows.cpu()[~ok].any()
        sl = slice(h * 1024, (h + 1) * 1024)
        rv = ref[1].cpu()[sl]
        for layout in ("flat", "tiled"):
            nb, v = (x.cpu() for x in out[layout])
            assert torch.equal(v, rv) and torch.equal(nb[rv], ref[0].cpu()[sl][rv])
            assert not nb[~rv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "tiled"])
@pytest.mark.parametrize("via", ["scatter", "psum"])
def test_grouped_hop_launches_two_kernels_a_rank(cuda_device, layout, via):
    """A grouped hop (K13e) on four rank threads (host 2 x dp 1 x ici 2):
    each rank launches K13b once into the stacked slab and, under
    ``via="scatter"``, K13c's int32 unpack once (two kernels a rank, as the
    host's launch count sees them; one under ``via="psum"``), and gets the
    unsharded draw of its own frontier on the valid lanes."""
    from quiver_tpu_torch.parallel import (
        local_meshes,
        run_ranks,
        shard_topology_rows,
        sharded_sample_layer_grouped,
        tiled_sharded_sample_layer_grouped,
    )

    topo, n = _graph()
    rng = np.random.default_rng(16)
    seeds, valid = _owned_seeds(rng, 2 * 1024, n)
    key = qrandom.key(17)
    ref = sample.sample_layer(*topo.to_device(cuda_device), seeds.to(cuda_device),
                              valid.to(cuda_device), 10, key)
    meshes = local_meshes(4, hosts=2, device=cuda_device, timeout_s=120)
    blocks = run_ranks(lambda m: shard_topology_rows(m, topo, layout=layout), meshes)
    fn = sharded_sample_layer_grouped if layout == "flat" else tiled_sharded_sample_layer_grouped

    def rank(m):
        st = blocks[m.rank]
        a = (st.indptr, st.indices) if layout == "flat" else (st.bd, st.tiles)
        sl = slice(m.host_idx * 1024, (m.host_idx + 1) * 1024)
        return fn(*a, st.row_start, seeds[sl].to(m.device), valid[sl].to(m.device), 10, key,
                  m, ("host", "ici"), "host", via=via)

    torch.cuda.synchronize()
    _kernels.reset_counts()
    _kernels.reset_kernel_launches()
    results = run_ranks(rank, meshes)
    torch.cuda.synchronize()
    launches, counts = _kernels.kernel_launches(), _kernels.counts()
    per_rank = 2 if via == "scatter" else 1
    assert launches == 4 * per_rank, launches
    assert counts["sharded_sample_" + layout] == 4
    assert counts["grouped_unpack/int32"] == 4 * (per_rank - 1)
    for m, (nb, v) in zip(meshes, results):
        sl = slice(m.host_idx * 1024, (m.host_idx + 1) * 1024)
        rv = ref[1].cpu()[sl]
        assert torch.equal(v.cpu(), rv) and torch.equal(nb.cpu()[rv], ref[0].cpu()[sl][rv])
        assert not nb.cpu()[~rv].any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 99, 4, 1])
def test_exchange_rows_kernel_matches_plain(cuda_device, D):
    """K13f's owner gather on an [H, L] id slab: -1 pads read zero rows, ids
    past the block clamp to its last row (a -0.0 row keeps its sign), all
    lanes -1, a one-row block, an empty L; bit-equal to its plain version
    on the card and on the CPU. D = 99 and 1 take the one-word path."""
    from quiver_tpu_torch.comm import exchange_rows, exchange_rows_plain

    rng = np.random.default_rng(D)
    for R in (1000, 1):
        table = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32))
        table[-1] = -0.0
        cases = [rng.integers(-1, R + 50, (2, 4097)).astype(np.int32),
                 np.full((2, 333), -1, np.int32), np.zeros((2, 0), np.int32),
                 np.array([[R - 1, R, 2**31 - 1, -1, -5]], np.int32)]
        for ids_np in cases:
            ids = torch.from_numpy(ids_np)
            _kernels.reset_counts()
            got = exchange_rows(table.to(cuda_device), ids.to(cuda_device))
            want = exchange_rows_plain(table.to(cuda_device), ids.to(cuda_device))
            torch.cuda.synchronize()
            assert _kernels.counts()["exchange_rows"] == int(ids.numel() > 0)
            assert got.shape == tuple(ids.shape) + (D,)
            assert _same_bits(got, want) and _same_bits(got, exchange_rows_plain(table, ids))
            flat, rows = ids.reshape(-1).long(), got.cpu().reshape(-1, D)
            assert not rows[flat < 0].any()
            past = flat >= R
            assert _same_bits(rows[past], table[-1].expand(int(past.sum()), D))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K1", "K1b", "K7", "K7 flat", "K8"])
def test_device_key_forms_equal_the_by_value_forms(cuda_device, kind):
    """Each draw's device-key form, reading the hop's two key words from a
    row of a [3, 2] uint32 buffer on the card (a captured serve step's
    layout), is bit-equal to its by-value form on the same words, at the
    three hops of a B = 64 sample; its launches count under
    ``name/device_key``."""
    topo, ts, n = _weighted_topo()
    name, fn, g = {
        "K1": ("sample_tiled", sample.tiled_sample_layer, topo.to_device_tiled(cuda_device)),
        "K1b": ("sample_flat", sample.sample_layer, topo.to_device(cuda_device)),
        "K7": ("weighted_sample_tiled", sample.tiled_weighted_sample_layer,
               (*topo.to_device_tiled(cuda_device), topo.to_device_tiled_weights(cuda_device))),
        "K7 flat": ("weighted_sample_flat", sample.weighted_sample_layer,
                    (*topo.to_device(cuda_device), topo.to_device_weights(cuda_device))),
        "K8": ("temporal_sample_tiled", sample.tiled_temporal_sample_layer, None),
    }[kind]
    if kind == "K8":
        from quiver_tpu_torch.workloads import TemporalTiledGraph

        g = TemporalTiledGraph(topo, ts, device=cuda_device).temporal_graph()
    rng = np.random.default_rng(4)
    key = qrandom.fold_in(qrandom.key(11), 2)
    words = torch.from_numpy(qrandom.hop_key_words(key, len(HOPS)).view(np.int32))
    words = words.to(cuda_device).view(torch.uint32)
    _kernels.reset_counts()
    for h, ((W, k), sub) in enumerate(zip(HOPS, qrandom.hop_keys(key, len(HOPS)))):
        seeds, valid = _hop_seeds(rng, W, n)
        seeds, valid = seeds.to(cuda_device), valid.to(cuda_device)
        extra = ()
        if kind == "K8":
            t = rng.uniform(0.0, 60.0, W).astype(np.float32)
            extra = (torch.from_numpy(t).to(cuda_device), 512, 0.02)
        elif kind.startswith("K7"):
            extra = (512,)
        by_value = fn(*g, seeds, valid, k, sub, *extra)
        on_card = fn(*g, seeds, valid, k, words[h], *extra)
        torch.cuda.synchronize()
        for a, b in zip(by_value, on_card):
            assert _same(a, b), (kind, W, k)
    counts = _kernels.counts()
    assert counts[name] == 2 * len(HOPS) and counts[f"{name}/device_key"] == len(HOPS)
    with pytest.raises(ValueError):  # key words must lie on the seeds' device
        fn(*g, seeds, valid, 5, words[0].cpu(), *extra)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["tiles", "ttiles", "bd"])
def test_stream_row_scatter_matches_plain_and_leaves_its_input(cuda_device, table):
    """B1, a streaming graph's commit through K6's body: the int32 tile
    rows [m_cap, 128], the float32 timestamp tiles and the int32 (base,
    deg) rows [N, 2] (8-byte rows), at a commit's bucketed positions (the
    padding, position = the row count, dropped), bit-equal to the plain
    version on the card and the CPU, the input untouched."""
    from quiver_tpu_torch.stream import _bucketed

    rng = np.random.default_rng(19)
    H, D, dt = {"tiles": (70001, 128, np.int32), "ttiles": (70001, 128, np.float32),
                "bd": (60000, 2, np.int32)}[table]
    host = (rng.integers(-2**31, 2**31 - 1, (H, D)).astype(dt) if dt == np.int32
            else rng.uniform(0.0, 50.0, (H, D)).astype(dt))
    for n_rows in (1, 37, 3000):
        idx = np.sort(rng.choice(H, n_rows, replace=False))
        new = host.copy()
        new[idx] = rng.integers(0, 1000, (n_rows, D)).astype(dt)
        pos, rows = _bucketed(idx, new[idx], H)
        assert pos.shape[0] >= 64 and (pos[n_rows:] == H).all()
        dev = [torch.from_numpy(a).to(cuda_device) for a in (host, pos, rows)]
        keep = dev[0].clone()
        name = f"set_rows/{'float32' if dt == np.float32 else 'int32'}"
        before = _kernels.counts()[name]
        got = set_rows(*dev)
        want = set_rows_plain(*dev)
        torch.cuda.synchronize()
        assert _kernels.counts()[name] == before + 1
        assert torch.equal(dev[0], keep) and got.data_ptr() != dev[0].data_ptr()
        assert _same(got, want) and np.array_equal(got.cpu().numpy(), new)


# -- the copy-and-patch row scatter (B1, K6) and the tiled K13a ----------------------

# (dtype, D): int32 rows of 512 and 8 bytes (B1's tiles and (base, deg)
# rows), float32, bfloat16 and int8 rows of 400, 200 and 100 bytes (K6)
SET_ROWS_ROWS = [(torch.int32, 128), (torch.int32, 2), (torch.float32, 100),
                 (torch.bfloat16, 100), (torch.int8, 100)]


def _random_rows(rng, shape, dtype):
    if dtype in (torch.int32, torch.int8):
        info = torch.iinfo(dtype)
        return torch.from_numpy(rng.integers(info.min, info.max, shape, endpoint=True)
                                .astype(np.int64)).to(dtype)
    return torch.from_numpy((rng.standard_normal(shape) * 30).astype(np.float32)).to(dtype)


def _offset_view(x, k):
    """``x``'s values in a contiguous view that starts ``k`` elements into
    a larger buffer, so its base pointer is not 16-byte aligned for k > 0."""
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    view = buf[k:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", SET_ROWS_ROWS)
@pytest.mark.parametrize("case", ["unique", "duplicates", "all_padding", "empty", "edge_slots",
                                  "unaligned"])
def test_set_rows_copy_and_patch_matches_plain(cuda_device, dtype, D, case):
    """B1/K6 as a flat copy of the table and a patch of the rows: bit-equal
    to its plain version on the card and on the CPU, with slots given twice
    or more (the later row wins), every slot padding, no rows, slots 0 and
    H - 1 beside slots past the table and negative ones, and a table and
    rows whose base pointers are not 16-byte aligned; the input untouched;
    two kernels a call (the copy alone when there are no rows), none of
    them over an [H] map."""
    rng = np.random.default_rng(D + len(case))
    H, b = 20011, 256  # H a multiple of no copy stride
    table = _random_rows(rng, (H, D), dtype)
    rows = _random_rows(rng, (b, D), dtype)
    slots = rng.permutation(H)[:b].astype(np.int64)
    slots[-40:] = H  # the bucket's padding
    if case == "duplicates":
        slots[:200] = rng.integers(0, 50, 200)
    elif case == "all_padding":
        slots[:] = H
    elif case == "empty":
        slots, rows = slots[:0], rows[:0]
    elif case == "edge_slots":
        slots[:6] = [H - 1, 0, H + 7, -3, H - 1, 0]
    slots = torch.from_numpy(slots)
    dev = [t.to(cuda_device) for t in (table, slots, rows)]
    if case == "unaligned":
        dev[0], dev[2] = _offset_view(dev[0], 1), _offset_view(dev[2], 1)
        assert dev[0].data_ptr() % 16 and dev[2].data_ptr() % 16
    keep = dev[0].clone()
    _kernels.reset_kernel_launches()
    got = set_rows(*dev)
    launches = _kernels.kernel_launches()
    want = set_rows_plain(*dev)
    torch.cuda.synchronize()
    assert launches == (1 if case == "empty" else 2)
    assert torch.equal(dev[0], keep) and got.data_ptr() != dev[0].data_ptr()
    assert _same(got, want) and _same(got, set_rows_plain(table, slots, rows))
    if case == "duplicates":  # the later of two rows given one slot
        s = slots.numpy()
        i = next(i for i in range(b) if s[i] in s[i + 1:])
        j = b - 1 - int(np.nonzero(s[::-1] == s[i])[0][0])
        assert _same(got[s[i]], rows[j]) and not _same(rows[i], rows[j])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("D", [1, 47, 100])
@pytest.mark.parametrize("owned", ["all", "none", "mixed"])
def test_sharded_rows_tiles_match_plain(cuda_device, dtype, D, owned):
    """K13a by tiles of output rows: bit-equal to its plain version on the
    card and on the CPU at D = 1, 47 and 100 in each dtype, with every id
    owned by shard 1 (first > 0), none owned, and ids below, inside and past
    each shard with the padding sentinel, over a count of ids that is no
    multiple of the tile; one kernel a call; the shards' partials sum to the
    rows."""
    from quiver_tpu_torch.parallel.collectives import partial_rows, partial_rows_plain

    rng = np.random.default_rng(D + 3 * len(owned))
    N, shards, W = 3001, 3, 5003
    R = -(-N // shards)
    table = _random_rows(rng, (shards * R, D), dtype)
    if owned == "all":
        ids = rng.integers(R, 2 * R, W)
    elif owned == "none":
        ids = np.r_[rng.integers(-R, 0, W // 2), rng.integers(shards * R, 4 * R, W - W // 2)]
    else:
        ids = rng.integers(-5, N + 40, W)
        ids[:2] = [np.iinfo(np.int32).max, -1]
    ids = torch.from_numpy(ids.astype(np.int32))
    total = torch.zeros((W, D), dtype=torch.float64)
    for p in range(shards):
        block = table[p * R:(p + 1) * R]
        _kernels.reset_kernel_launches()
        got = partial_rows(block.to(cuda_device), ids.to(cuda_device), p)
        assert _kernels.kernel_launches() == 1
        want = partial_rows_plain(block.to(cuda_device), ids.to(cuda_device), p)
        torch.cuda.synchronize()
        assert _same(got, want) and _same(got, partial_rows_plain(block, ids, p))
        if owned == "all":
            assert bool(got.any()) == (p == 1)
        total += got.cpu().double()
    inside = ((ids >= 0) & (ids < shards * R)).numpy()
    want = np.where(inside[:, None],
                    table.double().numpy()[np.clip(ids.numpy(), 0, shards * R - 1)], 0)
    assert np.array_equal(total.numpy(), want)


@pytest.mark.cuda
def test_sharded_rows_refuses_rows_past_its_word_index(cuda_device):
    """K13a indexes a tile's words with ints: a row of more than 493,447
    words (an int8 row of an odd width, copied a byte a word) is refused
    with an error, never copied wrong; the widest row it takes is copied."""
    from quiver_tpu_torch.parallel.collectives import partial_rows, partial_rows_plain

    ids = torch.tensor([0, 1, -1], dtype=torch.int32, device=cuda_device)
    for D, ok in ((493_447, True), (493_449, False)):
        block = torch.randint(-127, 128, (2, D), dtype=torch.int8, device=cuda_device)
        if ok:
            assert _same(partial_rows(block, ids, 0), partial_rows_plain(block, ids, 0))
        else:
            with pytest.raises(RuntimeError):
                partial_rows(block, ids, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K1", "K8"])
def test_device_graph_forms_equal_the_by_value_forms(cuda_device, kind):
    """K1's and K8's device-graph forms read the tables' addresses from
    uint64 words on the card (a captured serve step's staged inputs), with
    placeholder tensors of the same shapes passed: bit-equal to the
    by-value forms at a B = 64 sample's three hops; launches count under
    ``name/device_graph``."""
    topo, ts, n = _weighted_topo()
    if kind == "K1":
        name, fn, g = "sample_tiled", sample.tiled_sample_layer, topo.to_device_tiled(cuda_device)
    else:
        from quiver_tpu_torch.workloads import TemporalTiledGraph

        name, fn = "temporal_sample_tiled", sample.tiled_temporal_sample_layer
        g = TemporalTiledGraph(topo, ts, device=cuda_device).temporal_graph()
    words = torch.tensor([t.data_ptr() for t in g], dtype=torch.int64, device=cuda_device)
    blanks = [torch.zeros_like(t) for t in g]
    rng = np.random.default_rng(5)
    key = qrandom.fold_in(qrandom.key(12), 3)
    keys = torch.from_numpy(qrandom.hop_key_words(key, len(HOPS)).view(np.int32))
    keys = keys.to(cuda_device).view(torch.uint32)
    _kernels.reset_counts()
    for h, ((W, k), sub) in enumerate(zip(HOPS, qrandom.hop_keys(key, len(HOPS)))):
        seeds, valid = (t.to(cuda_device) for t in _hop_seeds(rng, W, n))
        extra = ()
        if kind == "K8":
            extra = (torch.from_numpy(rng.uniform(0.0, 60.0, W).astype(np.float32))
                     .to(cuda_device), 512, 0.02)
        by_value = fn(*g, seeds, valid, k, sub, *extra)
        on_card = fn(*blanks, seeds, valid, k, keys[h], *extra, graph_words=words)
        torch.cuda.synchronize()
        for a, b in zip(by_value, on_card):
            assert _same(a, b), (kind, W, k)
    counts = _kernels.counts()
    assert counts[f"{name}/device_graph"] == counts[f"{name}/device_key"] == len(HOPS)
    with pytest.raises(TypeError):  # the graph form takes its keys from the card
        fn(*blanks, seeds, valid, 5, sub, *extra, graph_words=words)


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True])
def test_captured_bucket_replays_two_epochs_without_capture(cuda_device, temporal):
    """A serve step over a streaming graph, captured once: after a commit
    and a rebind nothing is captured anew, a binding sealed before the
    commit replays that epoch bit for bit, and the new binding serves the
    commit's graph, bit-equal to programs over a table built afresh."""
    from quiver_tpu_torch.inference import BucketPrograms
    from quiver_tpu_torch.stream import GraphDelta, StreamingAdjacency, StreamingTiledGraph
    from quiver_tpu_torch.workloads import TemporalTiledGraph

    topo, ts, n = _weighted_topo()
    topo = CSRTopo(indptr=topo.indptr, indices=topo.indices)
    feat = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 24))
                            .astype(np.float32)).to(cuda_device)
    model = bind_params(GraphSAGE(24, 32, 5, num_layers=2, dropout=0.0), None, cuda_device)

    def sampler(graph):
        if not temporal:
            return GraphSageSampler(topo, [10, 5], seed=3, device=cuda_device).bind_stream(graph)
        s = GraphSageSampler(topo, [10, 5], seed=3, device=cuda_device, dedup=False)
        return s.bind_temporal(graph, recency=0.02)

    st = StreamingTiledGraph(topo, reserve_frac=0.2, edge_ts=ts if temporal else None,
                             device=cuda_device)
    # the reverse CSR sorted on the card equals the CPU's, and so its closures
    cpu_adj = StreamingAdjacency(topo, device="cpu")
    assert torch.equal(st.adj.rev_indices.cpu(), cpu_adj.rev_indices)
    assert np.array_equal(st.affected_seeds([5, 7, 11], 2), cpu_adj.reverse_closure([5, 7, 11], 2))
    progs = BucketPrograms(sampler(st), feat)
    progs.compile_bucket(64, model)
    captured = progs.graph_stats()["captured"]
    rng = np.random.default_rng(8)
    seeds, key = rng.integers(0, n, 64), qrandom.key(4)
    extra = (rng.uniform(40.0, 70.0, 64).astype(np.float32),) if temporal else ()
    before = progs(64, model, key, seeds, *extra)
    sealed = progs.binding()
    src = np.r_[seeds[:8].repeat(200), [5] * 40]
    st.apply(GraphDelta(src, rng.integers(0, n, src.shape[0]),
                        ts=np.full(src.shape[0], 45.0, np.float32) if temporal else None))
    rm = GraphDelta()
    rm.remove_edges([5, 7], [st.neighbors(5)[0], st.neighbors(7)[0]])
    st.apply(rm)
    progs.rebind(graph=progs._sampler.fused_graph_arrays())
    assert progs.graph_stats()["captured"] == captured
    assert np.array_equal(progs(64, model, key, seeds, *extra, binding=sealed), before)
    after = progs(64, model, key, seeds, *extra)
    if temporal:
        t2, ts2 = st.adj.to_temporal()
        fresh = GraphSageSampler(t2, [10, 5], seed=3, device=cuda_device, dedup=False)
        fresh.bind_temporal(TemporalTiledGraph(t2, ts2, device=cuda_device), recency=0.02)
    else:
        fresh = GraphSageSampler(st.to_csr_topo(), [10, 5], seed=3, device=cuda_device)
    assert np.array_equal(BucketPrograms(fresh, feat)(64, model, key, seeds, *extra), after)
    assert not np.array_equal(after, before)


# -- the hand-off to a spawned child (quiver_tpu_torch.multiprocessing) ----------------

@pytest.mark.cuda
def test_spawned_child_k3t_over_a_registered_shared_tail(cuda_device):
    """A ShardTensor handed to a spawned child: the device rows by CUDA IPC,
    the host tail copied into shared memory and registered with the card in
    both processes. The child's K3t gather equals its plain version over the
    same tiers and the plain gather of the table; so does the parent's."""
    import quiver_tpu_torch.multiprocessing  # noqa: F401 (torch's reducers too)
    import torch_mp_children as children
    from quiver_tpu_torch.shard_tensor import CPU_DEVICE, ShardTensor

    table = torch.randn((20_000, 100), generator=torch.Generator().manual_seed(5))
    st = ShardTensor(cuda_device)
    st.append(table[:4_000], 0)
    st.append(table[4_000:], CPU_DEVICE)
    handle = st.share_ipc()
    assert st.cpu_tensor.is_shared() and st.cpu_tensor.is_pinned()
    ids = np.random.default_rng(5).integers(-8, 20_008, 16_384)
    got, want, pinned = run_in_child(children.cuda_tiered_gather, handle, ids)
    expect = tiered_gather_plain(table[:4_000], table[4_000:], torch.from_numpy(ids), 20_000)
    assert pinned
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got.view(np.int32), expect.numpy().view(np.int32))
    mine = st.gather(torch.as_tensor(ids, dtype=torch.int32, device=cuda_device)).cpu()
    assert torch.equal(mine.view(torch.int32), expect.view(torch.int32))
    st.close()


@pytest.mark.cuda
def test_spawned_child_k1_draws_over_an_ipc_mapped_tile_table(cuda_device):
    """A tiled sampler handed to a spawned child after the parent drew: the
    child's first draw (K1, K2) over the mapped tile table equals the
    parent's first draw through a sampler of the same handle, and the child
    built no tile table (no K12 launch)."""
    import quiver_tpu_torch.multiprocessing  # noqa: F401
    import torch_mp_children as children

    ei = np.random.default_rng(3).integers(0, 5_000, (2, 200_000))
    sampler = GraphSageSampler(CSRTopo(edge_index=ei), [15, 10, 5], device=cuda_device, seed=7)
    sampler.sample_dense(np.arange(64))
    seeds = np.random.default_rng(4).integers(0, 5_000, 64)
    n_id, count, masks, cols, counts = run_in_child(children.cuda_tiled_draw,
                                                    {"sampler": sampler}, seeds)
    ds = GraphSageSampler.lazy_from_ipc_handle(sampler.share_ipc()).sample_dense(seeds)
    assert counts["build_tiles"] == 0 and counts["sample_tiled"] == 3
    assert np.array_equal(n_id, ds.n_id.cpu().numpy()) and count == int(ds.count)
    for m, c, a in zip(masks, cols, ds.adjs):
        assert np.array_equal(m, a.mask.cpu().numpy())
        assert np.array_equal(c, a.cols.cpu().numpy())


@pytest.mark.cuda
def test_a_forked_child_fails_loudly_on_a_handed_feature(cuda_device):
    """A child started by ``fork`` after the parent touched CUDA cannot use
    the card: its first gather from an inherited feature raises (torch's
    forked-subprocess error) instead of reading anything. Hand-offs use
    ``spawn``."""
    import multiprocessing as mp

    import torch_mp_children as children

    feat = Feature(device=cuda_device, device_cache_size=100 * 8 * 4)
    feat.from_cpu_tensor(np.ones((100, 8), np.float32))
    feat[np.arange(4)]
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=children.feature_rows, args=({"feature": feat}, np.arange(4), q))
    p.start()
    try:
        status, out = q.get(timeout=60)
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert status == "error" and "forked subprocess" in out, out

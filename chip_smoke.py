#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphSAGE serving, training,
capped training, out-of-core training, weighted training, GCN and GAT
training (float32 and bfloat16), temporal serving, (dp, ici) and
(host, dp, ici) data-parallel training and routed fleet serving paths on
one card, with every tile table built on it.

    python3 chip_smoke.py [--scale 1.0] [--requests 2000] [--seed 0]

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — compile every kernel of the path from ``quiver_tpu_torch/csrc``
             (one nvcc per source, in parallel) and print the seconds;
2. card    — the card's name and power limit from nvidia-smi;
3. graph   — a products-shaped power-law graph from the seed (2,449,029
             nodes and 123,718,280 directed edges at scale 1.0), its tile
             table built on the card by K12 (the counts set to 0 just
             before, its seconds on the "tiled graph on the card" line), a
             [N, 100] float32 feature table and a GraphSAGE(100 -> 256 ->
             256 -> 47) with weights from seeded numpy;
4. kernels — every kernel at the shapes one B=64 flush gives it (sizes
             [15, 10, 5], D = 100 and 256), held against its plain torch
             version on the same inputs on the card: bit-equal for the
             sampler (tiled and flat), the reindex and the gather, within
             1e-5 for the neighbor mean. Times are medians of CUDA-event
             timed runs with the L2 cache flushed between runs. Yardsticks:
             index_select (K3), embedding_bag's weighted sum with weights
             mask / count computed beforehand (K4); no one torch call
             draws a k-subset per CSR row (K1) or dedups with the seeds
             kept in their slots (K2). K4 is also bit-equal when run twice;
5. serve   — ServeEngine(max_batch=64) on the tiled sampler: warmup, then
             Zipf requests from 4 client threads; every kernel of the path
             must have launched (counts zeroed just before, read just
             after). Then 8 dispatches replayed through batch_logits with a
             fresh sampler must equal the served rows bit for bit, and 2
             dispatches replayed with the plain torch versions on the CPU
             must agree within 1e-3;
6. flat    — a shorter serve run on the flat layout (the flat sampling
             kernel's path), counts read the same way;
7. kernels-2 — the training slice's kernels at the shapes a batch-1024
             step gives them, against their plain versions: the
             neighbor-mean backward (K4b) on layers 1 and 2 in the cols
             and structural layouts, within 1e-5 of the plain version run
             on a CPU copy of the inputs (it adds in the kernel's order;
             the card's index_add_ does not) and bit-equal when run twice;
             the full-graph mean (K10) over the whole graph at D = 100 and
             256 within 1e-5; the tiered gather (K3t) of a real batch's
             n_id at a 20% cache, bit-equal. Bounds as above; K3t's host
             rows are charged at the link rate of a 1 GiB pinned copy
             measured in the run (median of 5). Yardsticks: index_add_ (K4b),
             torch.sparse.mm with a CSR adjacency of ones (K10), none for
             K3t (no one call reads two tiers). K4b is bit-equal to its plain
             version on a CPU copy; K10 bit-equal when run twice. Logged:
             each K4b cols call's segment lengths (valid lanes a source row:
             largest and 99th percentile), K10's segment length and the
             heavy rows and segments it splits, and a ``kernels-2
             redesign:`` line with both kernels' times, library call and
             bound beside their times before the redesign;
7b. full inference — sage_full_inference of the GraphSAGE above over the
             whole graph (three K10 calls, 3 launches checked), timed end
             to end twice after a first run, its logits within 1e-4 of the
             same layers over K10's plain version; a ``full inference:``
             line;
8. train   — 20 Adam steps at batch 1024 on each of four legs at full
             width (sample_dense + lookup_padded on the resident table;
             sample_dense + Feature[...] at a 20% cache; sample_and_gather_
             fused; sample_and_gather_dedup), dropout 0.5 from a seeded
             device generator, random labels from the seed: median step
             ms, SEPS, first and last loss (finite), the leg's launches
             (zeroed before its timed steps; every kernel of the leg must
             have launched) and a profiled device-time split of 3 more
             steps;
9. caps    — bench.py's capped path (calibrate_bench_caps) on the
             products graph: GraphSageSampler.calibrate_caps over 24 probe
             batches of 1,024 from another shuffle of the train split
             (margin 1.1, granule 2048; the caps must equal
             caps_from_counts of the same probe, whose maxima are logged),
             then train leg 1 uncapped and capped on the same draws (step
             ms, SEPS, n_id width, cap_overflow summed over the steps,
             which must be 0), then an auto_grow_caps sampler from tight
             caps (the exact maxima of 2 probe batches: margin 1.0,
             granule 1; regrowth at margin 1.1, granule 2048) over 10
             batches, each with no node dropped, which must regrow at
             least once (its regrowths logged),
             then one sample() of 1,024 seeds equal to dense_to_pyg of the
             same draw through sample_dense, timed. Before the legs, K2 on
             each hop of one dedup sample of the first 1,024 train seeds,
             uncapped and at the caps: bit-equal to its plain version and
             when run twice, ms a call (also queued behind a spin), and the
             kernels it launches a call (``torch.profiler``); ``caps k2``
             lines. Lines start ``caps``;
10. learn  — the example (python -m quiver_tpu_torch.examples.reddit_sage)
             on the card at the args ACCURACY.json was recorded at
             (--epochs 8 --nodes 20000 --batch-size 512 --cache 4M): with
             --model sage, test and full-inference accuracy must exceed 0.8
             and lie within 0.05 of ACCURACY.json's 0.903 and 0.911, printed
             beside them, and K10 must have launched; with --model gcn and
             --model gat, test accuracy must exceed 0.5 and lie within 0.05
             of the JAX example's on the CPU at the same args (0.993 and
             0.998), and K14 and K14b must have launched;
11. kernels-3 — the staged pipeline's kernels on a real batch of 1,024
             seeds staged by TieredFeaturePipeline.prepare, each bit-equal
             to its plain version: the tiered lookup (K5) at the 20% fp32
             cache; the dequant gather (K9a) on fully resident int8 and bf16
             tables; the quantized tiered lookup (K9b) on the int8 and bf16
             stores of the same device bytes (195.92 MB: int8 72% hot after
             its side tables, bf16 40%), whose valid lanes must also equal
             QuantizedFeature[n_id]; the tiered gather (K3t) over those
             stores' int8 and bf16 rows. Times as above; the report rows of
             K9a and K9b are the int8 calls (the bf16 ones are logged). No
             one torch call computes K5, K9a or K9b (library_ms null);
12. pipeline — TrainPipeline.run_epoch at full width on three tables of
             the same device bytes (fp32 Feature 20%, QuantizedFeature int8
             and bf16): per table 6 warm-up batches at depth 2 (they
             allocate the pinned staging blocks), 20 timed batches at
             depth 1 and at depth 2 (per-batch wall time, each stage's busy
             seconds a batch, overlap_frac, hidden_frac_measured, cold rows
             and bytes a batch, first and last loss, launches), a
             sequential pass over 20 batches (each stage alone, then the
             step, all timed to a synchronize) and one
             measure_overlap epoch of 20; then 20 steps of sample_dense +
             QuantizedFeature.lookup_padded on the resident int8 table (K9a
             on a train path). Losses must be finite and K1, K2, K4, K4b and
             K5 (fp32) or K9b (int8, bf16) or K9a must have launched;
13. kernels-4 — the out-of-core slice's kernels against their plain
             versions: the row scatter of a placement batch (K6: one pass
             writing a new table from the rows or the old table) on the 20%
             cache's fp32 table (489,805 x 100) with 65,000 promoted rows
             padded to a bucket of 65,536, bit-equal and leaving its input
             untouched (copy-on-write); the probability propagation (K11) on
             the products graph per hop of sizes [15, 10, 5] from a
             196,615-node train split and for a whole sample_prob, bit-equal
             when run twice; per hop each node within 2 (n - 1) 2^-24 of
             its sum of the plain version's (n its in-edges: the worst
             float32 rounding of two orders of addition), on the card
             (index_add_ with float atomics) and on the CPU (the
             reference's sequential order), with the relative errors
             logged; and per hop each node within its own order's bound
             (neighbor_prob_depth) of the float64 sum of the same terms,
             about 7.5e-5 relative at the hub, with the share of that
             bound used logged. Yardsticks:
             index_copy (K6), index_add_ of the edge contributions (K11);
             the transposed graph's build seconds;
14. tiers  — the out-of-core path at full width: the heat from
             GraphSageSampler.sample_prob (K11), heat_reorder of graph,
             features and train split, then TrainPipeline at batch 1024 over
             a 20% device cache, 195.92 MB of host DRAM and the rest on disk
             in a temporary directory (removed at exit): (a) static 4-tier,
             prefetch off, (b) prefetch on, (c) adaptive — an epoch, a plan
             from its exact per-row counts (65,536 moves at most),
             TierStore.apply (K6), a fresh pipeline and a second epoch —
             and (d) QuantizedFeature(int8) of the same device bytes with a
             disk tail (K9b), 4 batches each (2 for d). Legs (a) and (b)
             and the second epoch of (c) must equal an all-DRAM epoch with
             the same seeds bit for bit; the pipeline built before the apply
             must still gather the right bytes; K11, K6, K5 and K9b must
             have launched. Disk reads go through O_DIRECT where the
             filesystem takes it, else through the page cache after
             drop_page_cache; leg (a) also runs through the page cache
             dropped and once more warm, labelled a DRAM read. The temp
             directory's filesystem is logged. Lines start ``tiers: ``;
15. kernels-6 — the tile slice's kernels at full products size: K12 on the
             id, weight and timestamp tables (M = 2,833,089 rows of 128),
             bit-equal to its plain version on the card and to
             build_tiled_host's tables; the id table's host build with its
             copy against to_device_tiled's own (row map, flat upload, K12),
             in seconds; K12 across the int32 edge-offset boundary on a
             2^31 + 256-word source, bit-equal; K1 and K1b at k = 48 and 64
             over a batch of 1,024 seeds, bit-equal. Yardstick:
             torch.take of the clamped [M, 128] lane indices, computed
             beforehand (K12). Every tile table the run builds is logged
             on a ``tiles:`` line with its seconds and K12 launches; the
             report line's K12 launches are their sum;
16. kernels-5 — the weighted and temporal slice's kernels against their
             plain versions, bit-equal on the card, on per-edge weights
             uniform in [0, 1) with 5% set to 0 and timestamps uniform in
             [0, 50) from the seed: the weighted draw (K7) over the tile
             layout and the flat CSR at the three hops of one batch-1024
             weighted sample_dense (max_deg 512), and tiled == flat on
             their valid lanes; the temporal draw (K8) at the three hops
             of one B = 64 temporal_sample_dense (64, 1,024, 11,264 rows;
             its 64 requests spread over the temporal trace, so their
             query times span [0, 50)) at recency 0.02 with and without a
             cutoff of 10 and at recency 0, logging the share of lanes
             the time mask removed; the recency weights (K8w) over the
             whole timestamp table; K8 at t = +inf equal to K7 over K8w's
             tiles and K8 equal to the host-masked oracle (1,024 rows).
             Bounds: each row's window, pair, ids and flags read and
             written once, against a threefry uniform and the float64
             logarithms (and exp) of each live lane, their FP64
             instructions counted from the built kernel's SASS, at the
             FP64 rate. Yardsticks: torch.topk of the given scores (K7,
             K8), torch.exp of the scaled tiles (K8w);
17. weighted-train — path (a): 20 Adam steps at batch 1024 of
             sample_dense + lookup_padded with GraphSageSampler(weighted=
             True, max_deg=512) on the tile layout (with a profiled
             split) and 5 on the flat one, as the train legs above; K7
             must have launched on each;
17b. fanout — fanouts above 32 at sizes [64, 10, 5]: one dedup
             sample of the 1,024 seeds hop by hop, K1 and K2 bit-equal to
             their plain versions; K4 (within 1e-5) and K4b (bit-equal to
             its plain version on a CPU copy and run twice) on each of its
             cols layers and on the structural layers of a B = 64 temporal
             sample; 5 Adam steps of GraphSAGE through GraphSageSampler at
             those sizes (K1, K2, K3, K4, K4b launched; a ``fanout train:``
             line); K7 tiled and flat (max_deg 512) and K8 at k = 64 on the
             seeds, bit-equal to their plain versions, K7's layouts equal on
             their valid lanes; the weighted (tiled, flat) and temporal
             samplers at those sizes launching their kernel every hop. The
             kernels' times at k = 64 are logged;
18. kernels-7 — the model zoo's kernels at the shapes one dedup
             sample_dense of 1,024 train seeds gives them (hops 180,224 x 5,
             16,384 x 10 and 1,024 x 15): the hop-source gather (K14) at
             GCN's row widths (100, 256, 256), GAT's (1,024, 1,024, 47) and
             F = 1, float32 and, at 256 and 1,024, bfloat16, bit-equal to its
             plain version; its gradient (K14b) wherever a gradient reaches
             the source (GCN's 256 on layers 1-2, GAT's three), bit-equal when
             run twice, within one float32 (bfloat16) rounding of the sum of
             its plain version on a CPU copy, which adds the valid lanes in
             the kernel's order, and in bfloat16 equal to the float32
             kernel's sum rounded once; the block out-degree (K14c) of each
             hop, bit-equal; K4 and K4b in bfloat16 at SAGE's widths, equal to
             the float32 kernels on the same values rounded once. Each hop's
             valid lanes, distinct rows and largest source segment (the hub)
             are logged. Bounds: each byte read and written once (K14b also
             its float32 adds). Yardsticks: index_select of the clamped flat
             cols (K14), index_add_ of the valid lanes' cotangent rows
             computed beforehand (K14b), index_add_ of the mask (K14c),
             embedding_bag and index_add_ (K4, K4b bf16). The report rows of
             K14 and K14b are the float32 calls at GAT's widths (one GAT
             step's), K14c's its three hops;
19. zoo    — path (c): 20 Adam steps at batch 1024 of sample_dense +
             lookup_padded on the resident table, as the train legs (dropout
             0.5 from a seeded generator, labels from the seed), on six
             models at products width: (a) GCN(100 -> 256 -> 256 -> 47,
             norm right), (b) the same with norm both, (c) GAT(hidden 256,
             4 heads, 3 layers -> 47), (d) GCN right in bfloat16, (e) GAT in
             bfloat16, (f) GraphSAGE(100 -> 256 -> 256 -> 47) in bfloat16:
             median step ms, SEPS, first and last loss (finite), the peak
             device memory, launches and a profiled split. K14 and K14b must
             have launched on (a)-(e) in the leg's dtype, K14c on (b), the
             bfloat16 K4/K4b on (f), and K14 not on (f). Lines start
             ``zoo: ``; the kernels line's K14, K14b and K14c launches are
             the sums over the legs;
20. temporal-serve — path (b): TemporalServeEngine(max_batch=64,
             t_quantum=0.05) over GraphSageSampler(dedup=False).
             bind_temporal(TemporalTiledGraph, recency=0.02): the recency
             weight tiles (K8w must have launched building them; the
             kernels line's K8w launches are these) and the t = +inf
             layer pin over them, warmup, then, with the counts set to 0,
             the temporal_trace's requests (Zipf 0.99, query times at 40
             a second from 0) from 4 client threads: QPS, p50/p99, cache
             hits, coalescing, launches of the served run (K8, K3, K4
             must have launched); 8 dispatches replayed through
             replay_temporal_log on the card bit-equal, 2 on the CPU plain
             path within 1e-3; a temporal engine at recency 0 queried at
             t = +inf bit-equal to a plain ServeEngine over a weighted
             sampler with unit weights; 256 lp_trace pairs through
             predict_pairs with finite scores. Lines start ``temporal``;
21. mc setup — the multi-device slice's state: 4 rank threads (dp 2 x ici
             2) on the card over gloo (local_meshes), the table's two ici
             stripes (one tensor a stripe, shared by the dp pair that reads
             it), each ici shard's flat and tiled graph block (the tiled ones
             built by K12 on the card, a ``tiles:`` line) and leg (a)'s caps
             from calibrate_caps over 8 probe batches of 1,024;
22. kernels-8 — on one calibrated dedup batch's lanes (its gather ids and
             three hops; timed), and for K13a and K13b also on the same
             batch uncapped (the widths legs (b) and (c) launch them at;
             checked, not timed): the sharded row gather's pack (K13a) per shard in
             float32 (the report row: shard 0) and bfloat16, bit-equal to its
             plain version, the shards' partials summing to the rows;
             K9c's decode of the summed int8 partials, bit-equal to its
             plain version and to K9a on the whole payload, then
             sharded_dequant_gather on the four rank threads (the report
             row's launches); the owner-masked draw (K13b) flat and tiled
             per hop and shard, bit-equal to its plain version, the shards'
             sum equal to unsharded K1b/K1 on the valid lanes (neighbor 0
             elsewhere). Yardsticks: index_select of the clamped local ids
             (K13a), none for K13b and K9c. Then gloo's all-reduce alone
             (``kernels-8 gloo:`` lines: the batch's float32 and int8 rows
             and last hop's int32 neighbors over an ici pair, both pairs at
             once; host-staged by gloo on one card, not NVLink or NCCL);
23. mc train — three legs on the rank threads at full products width,
             batch 1,024 a dp group, GraphSAGE(100 -> 256 -> 256 -> 47),
             Adam 1e-3, dropout 0.5: (a) replicated graph, dedup, the caps;
             (b) row-sharded tiled graph, dedup; (c) row-sharded flat graph,
             fused. Each: the first step's sample and rows on every rank
             bit-equal on the real lanes to the single-device pipeline on
             the whole graph and table with the step's key
             (split(fold_in(key, dp_idx))[0]), a warm-up step, 5 timed steps
             (median ms), 2 steps with each all-reduce timed apart between
             stream syncs (the collectives' share), the card's peak memory
             (the four ranks share one allocator) and each rank's resident
             bytes, gather_comm_bytes and sampling_comm_bytes; all ranks'
             parameters bit-equal after the leg, finite losses, K13a and
             the leg's sampler (K1b, or K13b tiled or flat) launched. Lines
             start ``mc train:``;
24. learn multichip — the products_multichip example on the four rank
             threads at the learn phase's graph size and args (20,000 nodes,
             dim 64, sizes [25, 10], 8 epochs, batch 512 a dp group; its own
             synthetic power-law graph): test accuracy above 0.8, printed
             beside the JAX example's 1.000 on the same graph and args (4
             virtual CPU devices) and the single-device example's 0.938 on
             its own community graph;
25. host setup — the host axis's state: 4 rank threads (host 2 x dp 1 x
             ici 2) on the card over gloo, the table's four (host, ici)
             stripes, each (host, ici) shard's flat and tiled graph block,
             and for the hot/cold leg the graph and table renumbered by the
             tiers phase's heat order, 20% of the rows hot (replicated per
             host, striped over ici; the rest striped over (host, ici)),
             their tiled blocks and the cold budget from
             calibrate_cold_budget over 8 probe batches of 1,024 (margin
             1.3); lines start ``host setup``;
26. kernels-9 — on one calibrated dedup batch a data group (timed), and on
             the same batches uncapped (1,081,344 gather ids, last hop
             180,224 lanes; checked, not timed): the grouped gather's pack
             (K13a at the gathered width, shard (0, 0); logged) and the
             grouped unpack (K13c) of the two slabs each rank receives, in
             float32 (the report row: rank (0, 0)), bfloat16 and int8,
             bit-equal to its plain version, the ici ranks' unpacks summing
             to the rows; the grouped hop (K13e: K13b at the gathered
             width, then K13c's int32 unpack of the neighbor and valid
             slabs) flat and tiled per hop and rank, bit-equal to their
             plain versions, the ici ranks' sums equal to the
             single-device K1b draw of the two hosts' frontiers with each
             row drawn by its owner host's key (logged as ``grouped_hop``
             on rank (0, 0)); the hot/cold compaction and merge (K13d) at
             the hot/cold leg's two gather widths and calibrated budget,
             bit-equal to their plain versions, the merged rows the table's.
             Yardsticks: index_select (pack), the slabs' sum (K13c), a
             stable argsort of the cold flag (compaction), index_add_
             (merge).
             Then gloo's all-gather of the ids and all-to-all of the float32
             slabs over a host pair (``kernels-9 gloo:`` lines);
27. host train — three legs on the rank threads at full products width,
             batch 1,024 a data group, GraphSAGE(100 -> 256 -> 256 -> 47),
             Adam 1e-3, dropout 0.5: (d) replicated graph, dedup, the mc
             phase's caps, grouped gathers (K13c); (e) graph row-sharded
             over (host, ici) in tiled blocks, fused, grouped draws (K13e)
             and per-hop grouped gathers; (f) hot/cold on the renumbered
             graph row-sharded in tiled blocks, dedup, the calibrated budget
             (K13d, K13c, K13e). Each: the first step's sample and rows on
             every rank bit-equal on the real lanes to the single-device
             pipelines of both data groups in lockstep, each hop's draw by
             the owners' keys (the rows where no cold id overflowed), a
             warm-up step, 3 timed steps (median ms), 2 steps with every
             collective timed apart between stream syncs (the collectives'
             share, and by wrapper), the rows gathered, the byte models with
             their host-axis terms, the card's peak memory and, on (f), the
             overflow a step; the replicas bit-equal after the leg, finite
             losses, the leg's kernels launched. Lines start ``host train:``;
28. learn host — the products_multichip example with --hosts 2 --hot-frac
             0.2 on the four rank threads at the multichip learn args: test
             accuracy above 0.8 and within 0.05 of the JAX example's 1.000
             on the same graph and args (4 virtual CPU devices), K13c and
             K13d launched;
29. fleet  — routed serving: DistServeEngine.build over the products
             graph and table, 2 owners of a contiguous partition (each
             owner's closure shard and K12 tile table built on the card; a
             ``tiles:`` line), max_batch 64, the collective exchange over
             one rank thread a host: (a) the closure residency (each owner
             gathers its closure's rows through K3's index map), the 2,000
             Zipf requests from 4 client threads; (b) the exchange
             residency (each owner's rows on the host, K3t, the others'
             over its own feature exchange, K13f), the first 256. Each leg:
             QPS, p50/p99, router cache and coalescing, exchange id and
             logit bytes, mean sub-batch width per owner, each owner's
             topo_stats (owned, closure and feature-closure nodes, edge
             share), its dispatches and latency, each owner's launches
             (counted around its answerer; K1, K2, K4 and its gather must
             launch, K13f in (b)), the ms a router flush spends in
             run_ranks and each rank in gloo's all_to_all; then each
             owner's first 8 dispatches replayed through replay_shard_oracle
             with a fresh full-graph sampler on the card, bit-equal to the
             served rows, and the first 2 on the CPU plain path, within
             1e-3. Lines start ``fleet``;
30. kernels-10 — K13f alone: owner 0's [1,224,515, 100] block and the
             [2, 131072] id slab it receives (requester 1 asks the owner-0
             rows of one B = 64 flush of its own seeds, then 64 ids past
             the block, then -1 pads), bit-equal to its plain version.
             Yardstick: index_select of the clamped ids, then masked_fill_
             of the -1 lanes;
31. report — a ``redesign K4 K2:`` line (K4 and K2 before and after
             their redesign: K4 at a flush's three layers, the bfloat16
             layers of kernels-7 and the k = 64 layer of the fanout phase,
             with embedding_bag's time and the bound; K2 at a flush's three
             hops and the caps phase's hops, with its kernel launches a
             call; each time also queued behind a 1 ms spin, the card's
             time without the host's share), then one JSON line of all
             kernels, the card line, then the ``{"ok": true, ...}`` line
             last.

As each phase of the run ends, a ``phase <name> done at <t> s`` line
(seconds since the run began) goes to both stdout and stderr, so the end
of either stream shows how far a run got and how long each phase took.

Exits non-zero without a card. Needs one card.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # deterministic GEMMs

import numpy as np
import torch
import torch.nn.functional as F

from quiver_tpu_torch import (GAT, GCN, Feature, GraphSAGE, GraphSageSampler, ServeConfig,
                              ServeEngine, _kernels)
from quiver_tpu_torch import random as qrandom
from quiver_tpu_torch.datasets import PRODUCTS, powerlaw_csr
from quiver_tpu_torch.feature import gather_rows, gather_rows_plain
from quiver_tpu_torch.inference import (
    batch_logits,
    bind_params,
    full_mean_aggregate,
    full_mean_aggregate_plain,
    sage_full_inference,
    strict_float32,
)
from quiver_tpu_torch.pipeline import (
    TieredFeaturePipeline,
    TrainPipeline,
    make_tiered_train_step,
    tiered_lookup,
    tiered_lookup_plain,
)
from quiver_tpu_torch.quant import (
    QuantizedFeature,
    gather_dequant,
    get_codec,
    make_quantized_train_step,
    quantized_tiered_lookup,
)
from quiver_tpu_torch.quant.lookup import (
    gather_dequant_plain,
    quantized_tiered_lookup_plain,
    sharded_dequant,
    sharded_dequant_gather,
    sharded_dequant_plain,
)
from quiver_tpu_torch.parallel import (
    allreduce_sum,
    calibrate_cold_budget,
    gather_comm_bytes,
    local_meshes,
    make_sharded_topo_train_step,
    make_sharded_train_step,
    replicate,
    run_ranks,
    sampling_comm_bytes,
    shard_topology_rows,
)
from quiver_tpu_torch.parallel import collectives as par_collectives
from quiver_tpu_torch.parallel.collectives import (
    cold_budget_lanes,
    cold_compact,
    cold_compact_plain,
    cold_merge,
    cold_merge_plain,
    grouped_unpack,
    grouped_unpack_plain,
    partial_rows,
    partial_rows_plain,
)
from quiver_tpu_torch.parallel.topology import (
    sample_layer_partial,
    sample_layer_partial_plain,
    tiled_sample_layer_partial,
    tiled_sample_layer_partial_plain,
)
from quiver_tpu_torch.parallel.train import hot_cold_stripes, stripe_rows
from quiver_tpu_torch.models.sage import (
    masked_mean_aggregate,
    masked_mean_aggregate_plain,
    masked_mean_backward,
    masked_mean_backward_plain,
)
from quiver_tpu_torch.ops import reindex, sample
from quiver_tpu_torch.ops.gather_src import (
    block_out_degree,
    block_out_degree_plain,
    gather_src_backward,
    gather_src_backward_plain,
    gather_src_plain,
    gather_src_rows,
)
from quiver_tpu_torch.pyg.sage_sampler import (
    caps_from_counts,
    dense_to_pyg,
    probe_hop_counts,
    sample_and_gather_dedup,
    sample_and_gather_fused,
)
from quiver_tpu_torch.comm import exchange_rows, exchange_rows_plain
from quiver_tpu_torch.parallel import train as ptrain
from quiver_tpu_torch.serve import (DistServeConfig, DistServeEngine, contiguous_partition,
                                    lp_trace, replay_shard_oracle, temporal_trace, zipfian_trace)
from quiver_tpu_torch.shard_tensor import tiered_gather_plain
from quiver_tpu_torch.ops.sample import (
    neighbor_prob,
    neighbor_prob_depth,
    neighbor_prob_plain,
    sample_prob,
)
from quiver_tpu_torch.tiers import (
    DiskShard,
    drop_page_cache,
    o_direct_supported,
    plan_adaptive,
    set_rows,
    set_rows_plain,
)
from quiver_tpu_torch.trace import median_min_max, seps
from quiver_tpu_torch.utils import CSRTopo, heat_reorder, round_up_pow2
from quiver_tpu_torch.workloads import (
    TemporalServeEngine,
    TemporalTiledGraph,
    host_masked_oracle,
    quantize_t,
    replay_temporal_log,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
# Its 67 TFLOP/s float32 rate counts an FMA as two operations on 128 lanes
# per SM; a lone float add issues at half of it, and a 32-bit integer op
# (add, shift, logic, compare) at 64 per SM per clock, a quarter of it
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0).
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# FP64 outside the tensor cores: 34 TFLOP/s with an FMA as two operations,
# so one DFMA, DADD or DMUL instruction per unit per clock
F64_INSTR_PER_S = 34e12 / 2
# integer ops of one threefry2x32 uniform: 2 key adds, 5 rounds of 4 x
# (add, funnel shift, xor) and 2 key adds, then xor, shift and or
THREEFRY_INT_OPS = 2 + 5 * (4 * 3 + 2) + 3
STEP_INT_OPS = 5  # a Fisher-Yates step besides its draw: span, j, clamp, head test

SIZES = (15, 10, 5)
BATCH = 64
DIM, HIDDEN, CLASSES = 100, 256, 47
N_EDGES_FULL = 2 * PRODUCTS["n_edges"]  # products is undirected: both directions

SOURCES = {
    "sample_tiled": ("quiver_tpu_torch/csrc/sample.cu", "quiver_tpu/ops/sample.py:526"),
    "sample_flat": ("quiver_tpu_torch/csrc/sample.cu", "quiver_tpu/ops/sample.py:288"),
    "local_reindex": ("quiver_tpu_torch/csrc/reindex.cu", "quiver_tpu/ops/reindex.py:124"),
    "gather_rows": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/feature.py:141"),
    "masked_mean": ("quiver_tpu_torch/csrc/aggregate.cu", "quiver_tpu/models/sage.py:25"),
    "masked_mean_backward": ("quiver_tpu_torch/csrc/aggregate.cu",
                             "quiver_tpu/models/sage.py:25"),
    "tiered_gather": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/shard_tensor.py:241"),
    "full_mean": ("quiver_tpu_torch/csrc/full_mean.cu", "quiver_tpu/inference.py:30"),
    "tiered_lookup": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/pipeline.py:178"),
    "gather_dequant": ("quiver_tpu_torch/csrc/dequant.cu", "quiver_tpu/quant/lookup.py:29"),
    "quantized_tiered_lookup": ("quiver_tpu_torch/csrc/dequant.cu",
                                "quiver_tpu/quant/lookup.py:47"),
    "set_rows": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/tiers.py:329"),
    "neighbor_prob": ("quiver_tpu_torch/csrc/prob.cu", "quiver_tpu/ops/sample.py:546"),
    "weighted_sample_tiled": ("quiver_tpu_torch/csrc/weighted.cu",
                              "quiver_tpu/ops/sample.py:242"),
    "weighted_sample_flat": ("quiver_tpu_torch/csrc/weighted.cu", "quiver_tpu/ops/sample.py:172"),
    "temporal_sample_tiled": ("quiver_tpu_torch/csrc/weighted.cu",
                              "quiver_tpu/ops/sample.py:476"),
    "recency_weights": ("quiver_tpu_torch/csrc/weighted.cu",
                        "quiver_tpu/workloads/temporal.py:128"),
    "build_tiles": ("quiver_tpu_torch/csrc/tiles.cu", "quiver_tpu/ops/sample.py:368"),
    "gather_src": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/pyg/sage_sampler.py:85"),
    "gather_src_backward": ("quiver_tpu_torch/csrc/aggregate.cu",
                            "quiver_tpu/pyg/sage_sampler.py:85"),
    "block_out_degree": ("quiver_tpu_torch/csrc/aggregate.cu", "quiver_tpu/models/gcn.py:69"),
    "sharded_rows": ("quiver_tpu_torch/csrc/gather.cu", "quiver_tpu/parallel/collectives.py:26"),
    "sharded_sample_tiled": ("quiver_tpu_torch/csrc/sample.cu",
                             "quiver_tpu/parallel/topology.py:411"),
    "sharded_sample_flat": ("quiver_tpu_torch/csrc/sample.cu",
                            "quiver_tpu/parallel/topology.py:339"),
    "sharded_dequant": ("quiver_tpu_torch/csrc/dequant.cu", "quiver_tpu/quant/lookup.py:88"),
    "grouped_unpack": ("quiver_tpu_torch/csrc/collective.cu",
                       "quiver_tpu/parallel/collectives.py:65"),
    "cold_compact": ("quiver_tpu_torch/csrc/collective.cu",
                     "quiver_tpu/parallel/collectives.py:150"),
    "cold_merge": ("quiver_tpu_torch/csrc/collective.cu", "quiver_tpu/parallel/collectives.py:150"),
    "exchange_rows": ("quiver_tpu_torch/csrc/collective.cu", "quiver_tpu/comm.py:183"),
}
MAIN_PATH = ("sample_tiled", "local_reindex", "gather_rows", "masked_mean")
# the training slice: batch, timed steps a leg, the tiered leg's cache share
TRAIN_BATCH, TRAIN_STEPS, CACHE_FRAC = 1024, 20, 0.2
PRODUCTS_TRAIN = 196_615  # ogbn-products train nodes
# the staged pipeline: timed batches a run, and the two quantized codecs
PIPE_BATCHES, PIPE_WARMUP = 20, 6
QUANT_CODECS = ("int8", "bf16")
# the out-of-core slice: a promotion batch, the planner's move bound, the
# batches of a tiers leg (and of the int8 leg)
PROMOTE_ROWS, MAX_MOVES = 65_000, 65_536
PREFETCH_ROWS = 1 << 18  # staging room for one batch's disk rows
TIER_BATCHES, TIER_WARMUP, TIER_INT8_BATCHES = 4, 2, 2
# the weighted and temporal slice: the Gumbel window, the zero-weight share,
# the flat weighted leg's steps; timestamps in [0, TS_SPAN), the recency and
# t quantum of scripts/serve_probe.py --temporal, its trace rate, LP pairs
MAX_DEG, ZERO_WEIGHT_FRAC, WEIGHTED_FLAT_STEPS = 512, 0.05, 5
TS_SPAN, RECENCY, T_QUANTUM, TEMPORAL_QPS, LP_PAIRS = 50.0, 0.02, 0.05, 40.0, 256
# the tile slice: the int32 source of K12's edge-offset check (past 2^31), the
# wide fanouts of K1/K1b; bench.py's cap policy (calibrate_bench_caps: probe
# batches, margin, granule) and the auto-grow sampler's batches
BOUNDARY_WORDS = 2**31 + 256
WIDE_FANOUTS = (48, 64)
CAP_PROBES, CAP_MARGIN, CAP_GRANULE, CAP_GROW_BATCHES = 24, 1.1, 2048, 10
# the example at the args ACCURACY.json was recorded at (scripts/record_accuracy.py)
LEARN_ARGS = ["--epochs", "8", "--nodes", "20000", "--batch-size", "512", "--cache", "4M"]
LEARN_BAR, LEARN_REF_TOL = 0.8, 0.05
# the model zoo slice: GAT's heads (examples/reddit_sage.py), each layer's
# K14 row width for GCN and GAT (layer 0 reads the [N, 100] features; GAT
# projects to heads x hidden before the gather), and the JAX example's test
# accuracy on the CPU at LEARN_ARGS with --model gcn / gat (no ACCURACY.json
# entry exists): the port's must exceed ZOO_LEARN_BAR and lie within
# LEARN_REF_TOL of it
GAT_HEADS = 4
# K14b against its plain version on a CPU copy: the same float32 additions in
# lane order, so 0 is expected; the bars allow one float32 rounding of the sum
# (one bfloat16 rounding in bf16) in case the host's index_add_ reorders
K14B_CPU_BAR = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-8}
GCN_WIDTHS = (DIM, HIDDEN, HIDDEN)
GAT_WIDTHS = (GAT_HEADS * HIDDEN, GAT_HEADS * HIDDEN, CLASSES)
JAX_CPU_TEST_ACC = {"gcn": 0.993, "gat": 0.998}
ZOO_LEARN_BAR = 0.5
# the multi-device slice: rank threads on the one card (dp x ici), the probe
# batches of leg (a)'s caps, a leg's timed steps and its steps timed with the
# collectives apart; the products_multichip example at the learn phase's
# graph size and args, beside the JAX package's examples/products_multichip.py
# on the same graph and args on 4 virtual CPU devices (test accuracy 1.000),
# and beside the single-device example's 0.938 on its own community graph
# (PR 6's final run; another graph, so not a like-for-like comparison)
MC_RANKS, MC_DP = 4, 2
MC_CAP_PROBES, MC_STEPS, MC_COLLECTIVE_STEPS = 8, 5, 2
MC_LEARN_ARGS = ["--nodes", "20000", "--dim", "64", "--sizes", "25,10", "--epochs", "8",
                 "--batch-per-dp", "512"]
MC_JAX_EXAMPLE_ACC, MC_SINGLE_DEVICE_ACC = 1.000, 0.938
# the host axis: rank threads host 2 x dp 1 x ici 2, the hot/cold leg's hot
# share of the heat-ordered rows and its cold budget's calibration margin, a
# leg's timed steps; the JAX package's examples/products_multichip.py at
# MC_LEARN_ARGS with --hosts 2 --hot-frac 0.2 on 4 virtual CPU devices (test
# accuracy), the bar of the port's example at the same args on the card
HOST_RANKS, HOST_HOSTS, HOST_HOT_FRAC, HOST_COLD_MARGIN, HOST_STEPS = 4, 2, 0.2, 1.3, 3
HOST_JAX_EXAMPLE_ACC = 1.000
# the fleet: owners (DistServeConfig's default), the exchange residency leg's
# requests, the dispatches of each owner replayed on the card and on the CPU,
# the ids past the block among K13f's received lanes
FLEET_HOSTS, FLEET_EXCHANGE_REQUESTS, FLEET_REPLAY, FLEET_REPLAY_CPU = 2, 256, 8, 2
FLEET_PAST_IDS = 64
# the kernels redesigned in the fanout slice, as PERF.md's table had them
# before (K4b: the float32 cols layout's two calls of a step; K10: the two
# passes at D = 100 and 256), logged beside this run's times; the fanout
# phase's sizes (k = 64 on the first hop) and timed steps
K4B_MS_BEFORE, K10_MS_BEFORE = 1.3436, 292.24
FANOUT_SIZES, FANOUT_STEPS = (64, 10, 5), 5
# K4 and K2 before their redesign (NVIDIA H100 80GB HBM3, 700 W), logged
# beside this run's times at the same shapes: K4 as PERF.md's table had it
# (a B = 64 flush's three calls, the bfloat16 hops of a batch of 1,024 at
# D = 100, 256, 256, and [1,024 x 64, D = 256]); K2 a B = 64 flush's three
# calls (PERF.md) and, per hop of one dedup sample of a batch of 1,024 at
# SIZES, uncapped and capped, the parent build's ms and kernel launches a
# call from scripts/torch_redesign_probe.py
K4_MS_BEFORE = {"flush": 0.07904, "bf16 hops": [0.1508, 0.0617, 0.0322], "k64": 0.1255}
K2_MS_BEFORE = {"flush": 0.26525, "uncapped": [0.12043, 0.22066, 0.75910],
                "capped": [0.10152, 0.22277, 0.72509]}
K2_LAUNCHES_BEFORE = {"uncapped": [16, 42, 61], "capped": [16, 42, 61]}
REDESIGN = {}  # this run's times of K4 and K2 at those shapes, filled by the phases


def log(*a):
    print(*a, flush=True)


_T_RUN = [time.perf_counter()]


def phase_done(name):
    """Logs, to both streams, the seconds since the run began as a phase
    ends, so the end of either stream says how far a run got and when."""
    line = f"phase {name} done at {time.perf_counter() - _T_RUN[0]:.1f} s"
    log(line)
    print(line, file=sys.stderr, flush=True)


class Failed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


# -- timing --------------------------------------------------------------------

_L2_FLUSH = None


def time_ms(fn, reps=15, warm=3):
    """Median device milliseconds of ``fn()``, each run timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2 cache."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _L2_FLUSH.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms_queued(fn, reps=15, warm=3, spin_cycles=2_000_000):
    """As `time_ms`, with each timed call queued behind a spin of
    ``spin_cycles`` clocks (about 1 ms) after the L2 flush: the host has
    enqueued the whole call before the first event fires, so the time is
    the card's alone, its kernels back to back, whatever the host's share
    of the call (which `time_ms` takes in when the host is late)."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _L2_FLUSH.zero_()
        torch.cuda._sleep(spin_cycles)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved, int_ops=0, f32_adds=0, f64_instr=0):
    """Least time (ms) for the work, and which side binds: the bytes over
    the HBM rate, or the operations over their peak rate (integer, float
    and FP64 pipes run side by side, so the slowest of them)."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = max(int_ops / INT32_OPS_PER_S, f32_adds / F32_ADDS_PER_S,
              f64_instr / F64_INSTR_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sample_bound(indptr, cur, cur_valid, k):
    """K1's least time for one hop on this hop's data. Bytes: seeds and
    flags, one (base, degree) pair and min(deg, k) neighbor ids per
    distinct valid seed, the [W, k] ids and flags written. Operations:
    only rows with deg > k draw; each takes k uniforms and k steps, and
    step i scans the i tail slots filled before it."""
    W = cur.shape[0]
    s = torch.clamp(cur.long(), 0, indptr.shape[0] - 2)
    deg = torch.where(cur_valid, indptr[s + 1] - indptr[s], 0)
    u = torch.unique(s[cur_valid])
    deg_u = indptr[u + 1] - indptr[u]
    n_bytes = W * 5 + u.numel() * 8 + int(torch.clamp(deg_u, max=k).sum()) * 4 + W * k * 5
    n_draw = int((deg > k).sum())
    return bound(n_bytes, n_draw * (k * (THREEFRY_INT_OPS + STEP_INT_OPS) + k * (k - 1) // 2))


def record(rows, name, err, ms, plain_ms, b, lib_ms=None, shape="", report=True):
    """Log one timed kernel call; with ``report`` also add it to the
    kernel's row of the report line (sums over the calls of one pass)."""
    log(json.dumps({"kernel": name, "shape": shape, "kernel_ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
                    "max_abs_err": float(err)}))
    if not report:
        return
    r = rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                   bound_by="bytes", library_ms=None, calls=0))
    r["max_abs_err"] = max(r["max_abs_err"], float(err))
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += b[0]
    if b[1] == "operations":
        r["bound_by"] = "operations"
    if lib_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
    r["calls"] += 1


# -- phases ----------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


TILE_BUILDS = []  # every tile table the run builds on the card: K12's launches


def tile_build(what, fn):
    """``fn()``, which builds tile tables on the card through K12, timed to
    a synchronize; logs and keeps its seconds and K12 launches (the
    counter's rise: the phases set the counts to 0 around their own runs)."""
    before = _kernels.counts()["build_tiles"]
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    entry = {"table": what, "seconds": time.perf_counter() - t0,
             "launches": _kernels.counts()["build_tiles"] - before}
    check(entry["launches"] > 0, f"K12 never launched building {what}")
    TILE_BUILDS.append(entry)
    log("tiles: " + json.dumps(entry))
    return out


def build_graph(scale: float, seed: int):
    n = max(int(PRODUCTS["n_nodes"] * scale), 1000)
    e = max(int(N_EDGES_FULL * scale), 10 * n)
    t0 = time.perf_counter()
    indptr, indices = powerlaw_csr(n, e, seed=seed)
    topo = CSRTopo(indptr=indptr, indices=indices)
    log(f"graph: {n} nodes, {topo.edge_count} edges, built in {time.perf_counter() - t0:.1f} s")
    return topo


def make_model_params(seed: int):
    """GraphSAGE(100, 256, 47, 3 layers) and a state_dict drawn from
    seeded numpy (uniform in +-1/sqrt(fan_in), as nn.Linear draws)."""
    model = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    params = {}
    for name, p in sd.items():
        lim = 1.0 / np.sqrt(sd[name.rsplit(".", 1)[0] + ".weight"].shape[1])
        params[name] = torch.from_numpy(rng.uniform(-lim, lim, tuple(p.shape)).astype(np.float32))
    return model, params


def hop_inputs(graph_tiled, seeds, key, sizes=SIZES, caps=None):
    """The inputs one dedup sample of ``seeds`` (a B=64 flush, or a
    training batch cut to ``caps`` as `sample_dense_pure` cuts it) hands
    each kernel: per hop the sampling and reindex inputs, then the final
    n_id for the gather."""
    widths = sample.pad_widths(seeds.shape[0], sizes, caps)
    cur = seeds
    cur_valid = torch.ones_like(seeds, dtype=torch.bool)
    hops = []
    for l, k in enumerate(sizes):
        key, sub = qrandom.split(key)
        nbrs, valid = sample.tiled_sample_layer(*graph_tiled, cur, cur_valid, k, sub)
        hops.append(dict(cur=cur, cur_valid=cur_valid, k=k, key=sub, nbrs=nbrs, valid=valid))
        res = reindex.local_reindex(cur, cur_valid, nbrs, valid)
        cur = res.n_id[:widths[l + 1]]
        cur_valid = torch.arange(cur.shape[0], device=cur.device) < res.count
    return hops, cur


def kernel_phase(topo, table, model, seeds):
    """Hold every kernel against its plain version at the path's shapes;
    returns per-kernel sums over one flush's calls."""
    dev = table.device
    g_tiled = topo.to_device_tiled(dev)
    g_flat = topo.to_device(dev)
    key = qrandom.fold_in(qrandom.key(1234), 0)
    hops, n_id = hop_inputs(g_tiled, seeds, key)
    rows = {}

    def add(name, err, ms, plain_ms, b, lib_ms=None, shape=""):
        record(rows, name, err, ms, plain_ms, b, lib_ms, shape)

    def int_err(a, b):
        for x, y in zip(a, b):
            check(torch.equal(x, y), "kernel output differs from its plain version")
        return 0.0

    # K1 / K1b: sampling, tiled and flat, at each hop's width
    for h in hops:
        W, k = h["cur"].shape[0], h["k"]
        args = (h["cur"], h["cur_valid"], k, h["key"])
        b = sample_bound(g_flat[0], h["cur"], h["cur_valid"], k)
        for name, g, fn, plain in (
            ("sample_tiled", g_tiled, sample.tiled_sample_layer, sample.tiled_sample_layer_plain),
            ("sample_flat", g_flat, sample.sample_layer, sample.sample_layer_plain),
        ):
            got, want = fn(*g, *args), plain(*g, *args)
            err = int_err(got, want)
            check(torch.equal(got[1], h["valid"]) and torch.equal(got[0][got[1]], h["nbrs"][h["valid"]]),
                  "flat and tiled draws differ")
            add(name, err, time_ms(lambda: fn(*g, *args)), time_ms(lambda: plain(*g, *args), reps=5),
                b, shape=f"W={W} k={k}")

    # K2: reindex at each hop
    for h in hops:
        S, k = h["cur"].shape[0], h["k"]
        args = (h["cur"], h["cur_valid"], h["nbrs"], h["valid"])
        got, want = reindex.local_reindex(*args), reindex.local_reindex_plain(*args)
        int_err((got.n_id, got.count, got.local_seeds, got.local_nbrs[h["valid"]]),
                (want.n_id, want.count, want.local_seeds, want.local_nbrs[h["valid"]]))
        W = S * (1 + k)
        b = bound(S * 5 + S * k * 5 + W * 4 + 4 + S * 4 + S * k * 4)
        ms = time_ms(lambda: reindex.local_reindex(*args))
        REDESIGN.setdefault("K2 flush", []).append(
            dict(ms=ms, queued_ms=time_ms_queued(lambda: reindex.local_reindex(*args))))
        add("local_reindex", 0.0, ms, time_ms(lambda: reindex.local_reindex_plain(*args), reps=5),
            b, shape=f"S={S} k={k}")

    # K3: the feature gather of the final n_id
    n = n_id.shape[0]
    int_err((gather_rows(table, n_id),), (gather_rows_plain(table, n_id),))
    clipped = torch.clamp(n_id, 0, table.shape[0] - 1)
    # the padding slots all clip to one row: each distinct row is read once
    b = bound(n * 4 + torch.unique(clipped).numel() * DIM * 4 + n * DIM * 4)
    add("gather_rows", 0.0, time_ms(lambda: gather_rows(table, n_id)),
        time_ms(lambda: gather_rows_plain(table, n_id)), b,
        lib_ms=time_ms(lambda: torch.index_select(table, 0, clipped)), shape=f"n={n} D={DIM}")

    # K4: the neighbor mean of each layer, on that layer's real input
    from quiver_tpu_torch.pyg.sage_sampler import sample_dense_pure

    ds = sample_dense_pure(None, None, key, seeds, SIZES,
                           sample_fn=lambda c, v, k, kk: sample.tiled_sample_layer(
                               *g_tiled, c, v, k, kk))
    check(torch.equal(ds.n_id, n_id), "multi-hop sample differs from the hop-by-hop inputs")
    with torch.inference_mode():
        x = gather_rows(table, ds.n_id)
        for conv, adj in zip(model.convs, ds.adjs):
            W, k = adj.mask.shape
            D = x.shape[1]
            got = masked_mean_aggregate(x, adj)
            want = masked_mean_aggregate_plain(x, adj)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"masked_mean differs from its plain version by {err}")
            lanes = int(adj.mask.sum())
            # targets share neighbors under dedup: each distinct source row is read once
            if adj.cols is None:
                src = (W + torch.arange(k, device=dev)[None, :] * W
                       + torch.arange(W, device=dev)[:, None])
            else:
                src = torch.clamp(adj.cols, 0, x.shape[0] - 1)
            idx_bytes = W * k * (5 if adj.cols is not None else 1)
            b = bound(idx_bytes + torch.unique(src[adj.mask]).numel() * D * 4 + W * D * 4,
                      f32_adds=lanes * D + W * D)
            # yardstick: embedding_bag's weighted sum, weights mask / cnt computed beforehand
            cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1).to(x.dtype)
            bag = dict(input=src.reshape(-1).long(), weight=x, mode="sum",
                       offsets=torch.arange(0, W * k, k, device=dev),
                       per_sample_weights=(adj.mask.to(x.dtype) / cnt).reshape(-1))
            check(torch.allclose(F.embedding_bag(**bag), got, atol=1e-5, rtol=1e-5),
                  "the embedding_bag yardstick computes another function")
            again = masked_mean_aggregate(x, adj)
            check(torch.equal(got, again), f"K4 at W={W} k={k} D={D}: two runs differ")
            ms, lib = time_ms(lambda: masked_mean_aggregate(x, adj)), time_ms(
                lambda: F.embedding_bag(**bag))
            REDESIGN.setdefault("K4 flush", []).append(
                k4_times(ms, lib, b, lambda: masked_mean_aggregate(x, adj),
                         lambda: F.embedding_bag(**bag)))
            add("masked_mean", err, ms,
                time_ms(lambda: masked_mean_aggregate_plain(x, adj), reps=5), b,
                lib_ms=lib, shape=f"W={W} k={k} D={D}")
            x = torch.relu(conv(x, adj))
    torch.cuda.synchronize()
    return rows


def serve_phase(engine, trace, clients, t=None):
    """Requests from ``clients`` threads, 8 ids a call (with their query
    times ``t`` on a temporal engine); returns (key -> first served row,
    wall seconds), the key a node or a (node, float32 t bucket) pair."""
    served = {}
    lock = threading.Lock()
    errors = []

    def client(chunk, tchunk):
        try:
            for j in range(0, len(chunk), 8):
                ids = chunk[j:j + 8]
                if tchunk is None:
                    out, keys = engine.predict(ids, timeout=120), ids.tolist()
                else:
                    tq = tchunk[j:j + 8]
                    out = engine.predict(ids, t=tq, timeout=120)
                    keys = [(int(a), float(np.float32(quantize_t(b, engine.t_quantum))))
                            for a, b in zip(ids, tq)]
                with lock:
                    for key, row in zip(keys, out):
                        served.setdefault(key, row)
        except Exception as exc:  # noqa: BLE001 — reported and failed below
            errors.append(exc)

    t0 = time.perf_counter()
    tparts = [None] * clients if t is None else np.array_split(t, clients)
    with engine:
        threads = [threading.Thread(target=client, args=(c, tc))
                   for c, tc in zip(np.array_split(trace, clients), tparts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client did not finish")
    check(not errors, f"client errors: {errors[:3]}")
    return served, wall


def replay_check(topo, model, params, table, engine, served, device, n_dispatch, atol):
    """Replay the first dispatches through batch_logits with a fresh
    sampler on ``device``; returns the largest difference to the served
    rows (0.0 means bit-equal)."""
    feat = table if device != "cpu" else table.cpu()
    m = bind_params(model, params, device)
    if device == "cpu":  # its own tile cache: the card's tables stay cached
        topo = CSRTopo(indptr=topo.indptr, indices=topo.indices)
    twin = GraphSageSampler(topo, SIZES, device=device, seed=engine._sampler._seed)
    worst = 0.0
    for padded, nvalid in engine.dispatch_log[:n_dispatch]:
        out = batch_logits(m, twin, feat, padded).cpu().numpy()
        for i in range(nvalid):
            row = served.get(int(padded[i]))
            if row is not None:
                worst = max(worst, float(np.abs(row - out[i]).max()))
    check(worst <= atol, f"replay on {device} differs from the served rows by {worst}")
    return worst


# -- the training slice ----------------------------------------------------------

def link_rate(dev, reps: int = 5) -> float:
    """Host-to-card bytes per second of a 1 GiB pinned ``copy_``, the
    median of ``reps`` timed copies: the rate the bound charges the tiered
    gather's host-tail rows at. All ``reps`` rates are logged."""
    host = torch.empty(256 << 20, dtype=torch.float32).pin_memory()
    dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
    dst.copy_(host, non_blocking=True)  # warm the path
    rates = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        rates.append(host.numel() * 4 / (a.elapsed_time(b) / 1e3))
    log(json.dumps({"link_GBps_runs": [r / 1e9 for r in rates]}))
    return float(np.median(rates))


def build_features(topo, table_np, dev):
    """The two stores of the training legs: the whole table on the card
    (no reorder) and the 20% cache with the degree reorder, its tail in
    pinned host memory."""
    t0 = time.perf_counter()
    resident = Feature(device_cache_size=table_np.nbytes, device=dev)
    resident.from_cpu_tensor(table_np)
    tiered = Feature(device_cache_size=int(table_np.shape[0] * CACHE_FRAC) * DIM * 4,
                     csr_topo=topo, device=dev)
    tiered.from_cpu_tensor(table_np)
    log(f"features: resident {resident.tier_bytes()}, tiered {tiered.tier_bytes()} "
        f"in {time.perf_counter() - t0:.1f} s")
    return resident, tiered


def kernel_phase_2(topo, table, tiered, seeds, rows, seed):
    """Hold K4b, K10 and K3t against their plain versions at the training
    shapes and time them; adds their rows to ``rows``. Returns the link
    rate (bytes a second) measured for K3t's bound."""
    dev = table.device
    n = topo.node_count
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 11)
    ds = sampler.sample_dense(seeds)                            # cols layout
    graph, bind, _ = sampler.fused_sample_spec()
    ds_f, _ = sample_and_gather_fused(None, None, table, sampler.next_key(),
                                      sampler.as_seeds(seeds), SIZES, sample_fn=bind(graph))

    # K4b: the backward of layers 1 and 2 in both layouts; the report row
    # sums the cols layout's two calls (one step of legs 1, 2 and 4)
    for layout, d in (("cols", ds), ("structural", ds_f)):
        for layer in (1, 2):
            adj = d.adjs[layer]
            W, k = adj.mask.shape
            w_src = d.adjs[layer - 1].w_dst
            g = torch.randn((W, HIDDEN), generator=gen, device=dev)
            got = masked_mean_backward(g, adj.mask, adj.cols, w_src)
            again = masked_mean_backward(g, adj.mask, adj.cols, w_src)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"K4b {layout} layer {layer}: two runs differ")
            # held against the plain version on a CPU copy of the inputs, which
            # adds the lanes in the kernel's order (bit-equal); on the card the
            # plain version is index_add_ with float atomics, in no fixed order
            cpu = masked_mean_backward_plain(g.cpu(), adj.mask.cpu(),
                                             None if adj.cols is None else adj.cols.cpu(), w_src)
            err = float((got.cpu() - cpu).abs().max())
            check(torch.equal(got.cpu(), cpu),
                  f"K4b {layout} layer {layer} differs from its plain version by {err}")
            lanes = int(adj.mask.sum())
            seg = {}
            if adj.cols is not None:  # valid lanes a source row: the segments K4b sums
                per_row = torch.bincount(torch.clamp(adj.cols.long(), 0, w_src - 1)[adj.mask],
                                         minlength=w_src)
                per_row = per_row[per_row > 0].float()
                seg = {"segment_max": int(per_row.max()),
                       "segment_p99": float(torch.quantile(per_row, 0.99))}
                log("kernels-2 k4b segments: " + json.dumps(dict(layer=layer, W=W, k=k,
                                                                 w_src=w_src, **seg)))
            idx_bytes = W * k * (5 if adj.cols is not None else 1)
            b = bound(idx_bytes + W * HIDDEN * 4 + w_src * HIDDEN * 4, f32_adds=2 * lanes * HIDDEN)
            # yardstick: index_add_ of the lane contributions, computed beforehand
            cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1).to(g.dtype)
            contrib = (g / cnt)[:, None, :].expand(W, k, HIDDEN)[adj.mask].contiguous()
            if adj.cols is None:
                src = (W + torch.arange(k, device=dev)[None, :] * W
                       + torch.arange(W, device=dev)[:, None])
            else:
                src = torch.clamp(adj.cols.long(), 0, w_src - 1)
            idx = src[adj.mask].contiguous()
            lib = time_ms(lambda: torch.zeros((w_src, HIDDEN), device=dev).index_add_(0, idx,
                                                                                      contrib))
            record(rows, "masked_mean_backward", err,
                   time_ms(lambda: masked_mean_backward(g, adj.mask, adj.cols, w_src)),
                   time_ms(lambda: masked_mean_backward_plain(g, adj.mask, adj.cols, w_src),
                           reps=5),
                   b, lib, shape=f"{layout} layer {layer} W={W} k={k} D={HIDDEN} W_src={w_src}"
                   + "".join(f" {key}={v}" for key, v in seg.items()),
                   report=layout == "cols")

    # K10: the full-graph mean over the whole graph at D = 100 and 256; the
    # report row sums the two calls
    indptr, indices = topo.to_device(dev)
    e = indices.shape[0]
    adjacency = torch.sparse_csr_tensor(indptr, indices, torch.ones(e, device=dev), size=(n, n))
    deg = (indptr[1:] - indptr[:-1]).long()
    denom = torch.clamp(deg, min=1).to(torch.float32)[:, None]
    S = _kernels.full_mean_segment_edges()  # rows of more edges are split into segments
    heavy = deg > S
    log("kernels-2 k10 segments: " + json.dumps({
        "segment_edges": S, "heavy_rows": int(heavy.sum()),
        "heavy_segments": int(((deg[heavy] + S - 1) // S).sum()),
        "heavy_edge_share": float(deg[heavy].sum() / deg.sum()), "max_degree": int(deg.max())}))
    for D in (DIM, HIDDEN):
        h = table if D == DIM else torch.randn((n, D), generator=gen, device=dev)
        got = full_mean_aggregate(indptr, indices, h)
        again = full_mean_aggregate(indptr, indices, h)
        want = full_mean_aggregate_plain(indptr, indices, h)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K10 at D={D}: two runs differ")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
              f"K10 at D={D} differs from its plain version by {err}")
        del got, again, want
        b = bound((n + 1) * 4 + e * 4 + 2 * n * D * 4, f32_adds=e * D + n * D)
        record(rows, "full_mean", err,
               time_ms(lambda: full_mean_aggregate(indptr, indices, h), reps=5, warm=1),
               time_ms(lambda: full_mean_aggregate_plain(indptr, indices, h), reps=3, warm=1), b,
               time_ms(lambda: torch.sparse.mm(adjacency, h) / denom, reps=3, warm=1),
               shape=f"N={n} E={e} D={D} edge_row_bytes={e * D * 4}")
    del adjacency
    # the two redesigned kernels beside their times before the redesign (the
    # kernel table of PERF.md: K4b's one step's two calls, K10's two passes)
    log("kernels-2 redesign: " + json.dumps({
        name: {"ms": rows[name]["ms"], "library_ms": rows[name]["library_ms"],
               "bound_ms": rows[name]["bound_ms"], "ms_before_redesign": before}
        for name, before in (("masked_mean_backward", K4B_MS_BEFORE),
                             ("full_mean", K10_MS_BEFORE))}))

    # K3t: the tiered gather of a real sample_dense batch's n_id at 20% cache
    st = tiered.shard_tensor
    n_id = ds.n_id
    got = tiered[n_id]
    want = tiered_gather_plain(st.device_rows, st.cpu_tensor, n_id, n, tiered._order_dev)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K3t differs from its plain version")
    rate = link_rate(dev)
    ids = n_id.long()
    stored = torch.unique(tiered._order_dev[ids[(ids >= 0) & (ids < n)]].long())
    H = st.device_rows.shape[0]
    host_rows = int((stored >= H).sum())
    hbm_bytes = n_id.numel() * 4 + stored.numel() * 4 + (stored.numel() - host_rows) * DIM * 4 \
        + n_id.numel() * DIM * 4
    t_hbm, t_link = hbm_bytes / HBM_BYTES_PER_S * 1e3, host_rows * DIM * 4 / rate * 1e3
    log(json.dumps({"link_GBps": rate / 1e9, "k3t_rows": n_id.numel(),
                    "k3t_distinct_rows": stored.numel(), "k3t_host_rows": host_rows,
                    "k3t_hbm_bound_ms": t_hbm, "k3t_link_bound_ms": t_link}))
    record(rows, "tiered_gather", 0.0, time_ms(lambda: tiered[n_id]),
           time_ms(lambda: tiered_gather_plain(st.device_rows, st.cpu_tensor, n_id, n,
                                               tiered._order_dev), reps=5),
           (max(t_hbm, t_link), "bytes"), None, shape=f"n={n_id.numel()} D={DIM} cache=20%")
    return rate


def full_inference_phase(topo, table, model, params):
    """sage_full_inference of GraphSAGE(100 -> 256 -> 256 -> 47) over the
    whole graph on the card: three K10 calls, timed end to end to a
    synchronize (a first run, then two timed), K10's launches counted on
    one run; the logits [N, 47] finite and within 1e-4 of the same layers
    computed with K10's plain version. Logs a ``full inference:`` line."""
    dev = table.device
    m = bind_params(model, params, dev)
    indptr, indices = topo.to_device(dev)
    sage_full_inference(m, indptr, indices, table)
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        _kernels.reset_counts()
        t0 = time.perf_counter()
        out = sage_full_inference(m, indptr, indices, table)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _kernels.counts()["full_mean"]
    check(launches == len(m.convs), f"K10 launched {launches} times in one full inference")
    check(out.shape == (topo.node_count, CLASSES) and bool(torch.isfinite(out).all()),
          "full inference logits malformed")
    h = table
    with torch.inference_mode():
        for i, conv in enumerate(m.convs):
            h = conv.lin_l(full_mean_aggregate_plain(indptr, indices, h)) + conv.lin_r(h)
            if i != len(m.convs) - 1:
                h = torch.relu(h)
    err = float((out - h).abs().max())
    check(torch.allclose(out, h, atol=1e-4, rtol=1e-4),
          f"full inference differs from its plain layers by {err}")
    log("full inference: " + json.dumps({"nodes": topo.node_count, "edges": topo.edge_count,
                                         "layers": len(m.convs), "ms_runs": times,
                                         "ms": min(times), "k10_launches": launches,
                                         "max_abs_err_vs_plain": err}))
    del out, h
    torch.cuda.empty_cache()


def port_kernel_names() -> set:
    """The ``__global__`` function names of ``quiver_tpu_torch/csrc``: how a
    profiled kernel is told to be one of the port's own."""
    return {m for f in Path(_kernels.CSRC).glob("*.cu")
            for m in re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                f.read_text())}


def kernel_base_name(key: str) -> str:
    """A profiler kernel row's function name, without its return type,
    template arguments or parameter list."""
    return key.split("(")[0].split("<")[0].removeprefix("void ").strip()


def profile_steps(step, seeds_iter, port_names, steps=3):
    """Device time per step over ``steps`` profiled steps, from the kernel
    rows of the trace only (an op's row, and a user annotation's span on
    the device such as the optimizer step's, repeat their kernels' time),
    and the host time of the same steps: ``{"port_ms", "other_ms",
    "step_ms", "top"}`` — the port's kernels (matched by exact name),
    every other kernel (GEMMs, elementwise, Adam, copies), the mean
    profiled step, and the eight largest kernels. The profiler adds host
    time of its own, so ``step_ms`` exceeds an unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            step(next(seeds_iter))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    per = {}
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and not ev.is_user_annotation
                and ev.device_time_total > 0):
            per[ev.key] = per.get(ev.key, 0.0) + ev.device_time_total / 1e3 / steps
    check(bool(per), "the profiler saw no kernel on the card")
    port = sum(v for k, v in per.items() if kernel_base_name(k) in port_names)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return {"port_ms": port, "other_ms": sum(per.values()) - port,
            "step_ms": sum(times) / steps, "top": [(k[:60], v) for k, v in top]}


def kernel_launches(fn):
    """The kernels ``fn()`` launches on the card in one call (a wrapper's
    one counted launch may run several), from a profiler trace of one call
    after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation)


def k4_times(ms, lib_ms, b, fn, lib_fn):
    """One K4 shape's entry of the redesign line: its and embedding_bag's
    ms (`time_ms`), the same queued behind a spin (`time_ms_queued`), and
    the bound."""
    return dict(ms=ms, embedding_bag_ms=lib_ms, queued_ms=time_ms_queued(fn),
                embedding_bag_queued_ms=time_ms_queued(lib_fn), bound_ms=b[0])


def k2_train_hops(topo, seeds, caps, seed):
    """K2 at the training shapes: one dedup sample of ``seeds`` (a batch of
    1,024) at SIZES hop by hop, uncapped and cut to ``caps``; each call
    bit-equal to its plain version and when run twice, timed, and its
    kernel launches counted. Lines start ``caps k2``."""
    dev = seeds.device
    g_tiled = topo.to_device_tiled(dev)
    for name, c in (("uncapped", None), ("capped", caps)):
        hops, _ = hop_inputs(g_tiled, seeds, qrandom.key(seed + 44), caps=c)
        per = []
        for h in hops:
            S, k = h["cur"].shape[0], h["k"]
            args = (h["cur"], h["cur_valid"], h["nbrs"], h["valid"])
            got, want = reindex.local_reindex(*args), reindex.local_reindex_plain(*args)
            again = reindex.local_reindex(*args)
            for a, b in ((got, want), (got, again)):
                check(torch.equal(a.n_id, b.n_id) and torch.equal(a.count, b.count)
                      and torch.equal(a.local_seeds, b.local_seeds)
                      and torch.equal(a.local_nbrs[h["valid"]], b.local_nbrs[h["valid"]]),
                      f"K2 {name} at S={S} k={k} differs from its plain version or itself")
            n_seed = int(h["cur_valid"].sum())
            per.append({"S": S, "k": k, "valid_seeds": n_seed,
                        "new_uniques": int(got.count) - n_seed,
                        "ms": time_ms(lambda: reindex.local_reindex(*args)),
                        "queued_ms": time_ms_queued(lambda: reindex.local_reindex(*args)),
                        "launches": kernel_launches(lambda: reindex.local_reindex(*args))})
        log(f"caps k2 {name}: " + json.dumps(per))
        REDESIGN[f"K2 {name}"] = per


def redesign_line() -> dict:
    """K4 and K2 before and after their redesign at each shape of
    K4_MS_BEFORE and K2_MS_BEFORE: this run's ms a call (`time_ms`, as the
    kernels line) and queued ms a call (`time_ms_queued`: the card's time
    alone), beside K4's embedding_bag and bound and K2's kernel launches."""
    def cols(entries):
        return {key: [e[key] for e in entries] for key in entries[0]}

    k64 = REDESIGN["K4 k64"]
    return {"K4": {"flush": dict(cols(REDESIGN["K4 flush"]), ms_before=K4_MS_BEFORE["flush"]),
                   "bf16 hops": dict(cols(REDESIGN["K4 bf16 hops"]),
                                     ms_before=K4_MS_BEFORE["bf16 hops"]),
                   "k64": dict(cols([k64]), ms_before=K4_MS_BEFORE["k64"])},
            "K2": {"flush": dict(cols(REDESIGN["K2 flush"]), ms_before=K2_MS_BEFORE["flush"]),
                   **{name: dict(cols(REDESIGN[f"K2 {name}"]), ms_before=K2_MS_BEFORE[name],
                                 launches_before=K2_LAUNCHES_BEFORE[name])
                      for name in ("uncapped", "capped")}}}


def train_phase(topo, table, resident, tiered, train_idx, seed):
    """Four legs of TRAIN_STEPS Adam steps at batch 1024, full width;
    returns the launches summed over the legs."""
    dev = table.device
    labels = train_labels(topo.node_count, dev)
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 5)
    graph, bind, _ = sampler.fused_sample_spec()

    def dense_resident(s):
        ds = sampler.sample_dense(s)
        return ds, resident.lookup_padded(ds.n_id)

    def dense_tiered(s):
        ds = sampler.sample_dense(s)
        return ds, tiered[ds.n_id]

    def fused(s):
        return sample_and_gather_fused(None, None, table, sampler.next_key(), sampler.as_seeds(s),
                                       SIZES, sample_fn=bind(graph))

    def dedup(s):
        return sample_and_gather_dedup(None, None, table, sampler.next_key(), sampler.as_seeds(s),
                                       SIZES, sample_fn=bind(graph))

    legs = (
        ("sample_dense+lookup_padded", dense_resident, ("local_reindex", "gather_rows",
                                                        "masked_mean_backward/cols")),
        ("sample_dense+Feature20%", dense_tiered, ("local_reindex", "tiered_gather",
                                                   "masked_mean_backward/cols")),
        ("sample_and_gather_fused", fused, ("gather_rows", "masked_mean_backward/structural")),
        ("sample_and_gather_dedup", dedup, ("local_reindex", "gather_rows",
                                            "masked_mean_backward/cols")),
    )
    total = {}
    port_names = port_kernel_names()
    for leg, inputs, needs in legs:
        counts, _ = train_leg(leg, inputs, ("sample_tiled", "masked_mean") + needs, labels,
                              train_idx, seed, TRAIN_STEPS, port_names)
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
    return total


def train_labels(n, dev):
    """Random labels of the training legs, from a seeded device generator."""
    return torch.randint(0, CLASSES, (n,), generator=torch.Generator(device=dev).manual_seed(8),
                         device=dev)


def sage_model():
    return GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)


def train_leg(leg, inputs, needs, labels, train_idx, seed, steps, port_names, profile=True,
              make_model=sage_model, tag="train"):
    """``steps`` timed Adam steps at batch 1024 on ``inputs(seeds) -> (ds,
    x)`` after 2 warm-up steps, then (with ``profile``) a profiled device
    split of 3 more; logs a ``{tag}:`` line (with the peak device memory of
    the timed steps), checks that the losses are finite and that every
    kernel of ``needs`` launched in the timed steps, and returns their
    launch counts and the logged summary. The model is ``make_model()``
    with flax's init drawn from ``seed``."""
    dev = labels.device
    model = make_model()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    drop = torch.Generator(device=dev).manual_seed(seed + 1)
    order = np.random.default_rng(seed + 2).permutation(train_idx)
    batches = iter(order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                   for i in range(len(order) // TRAIN_BATCH))

    def step(seeds):
        ds, x = inputs(seeds)
        y = labels[ds.n_id[:TRAIN_BATCH].long()]
        loss = F.cross_entropy(model(x, ds.adjs, train=True, generator=drop), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), sum(a.mask.sum() for a in ds.adjs)

    for _ in range(2):  # warm-up: allocator, cuBLAS handles
        step(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_counts()
    times, losses, edges = [], [], 0
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, e = step(next(batches))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        edges += int(e)
    wall = time.perf_counter() - t_all
    counts = _kernels.counts()
    first, last = float(losses[0]), float(losses[-1])
    summary = {"leg": leg, "steps": steps, "batch": TRAIN_BATCH,
               "step_ms": median_min_max(times), "seps": seps(edges, wall),
               "sampled_edges": edges, "loss_first": first, "loss_last": last,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "launches": {k: v for k, v in counts.items() if v}}
    if profile:
        prof = profile_steps(step, batches, port_names)
        summary.update(profile_per_step=prof,
                       port_kernel_share=prof["port_ms"] / prof["step_ms"],
                       device_idle_share=1.0 - (prof["port_ms"] + prof["other_ms"])
                       / prof["step_ms"])
    log(f"{tag}: " + json.dumps(summary))
    check(np.isfinite(first) and np.isfinite(last), f"{leg}: loss not finite")
    for name in needs:
        check(counts[name] > 0, f"kernel {name} never launched on the {leg} leg")
    return counts, summary


# -- the staged pipeline -----------------------------------------------------------

def build_quant_tables(topo, table_np, budget, dev):
    """The quantized stores of the pipeline phase: int8 and bf16 at the
    fp32 leg's device bytes with the degree reorder, and the two fully
    resident tables of K9a (no reorder)."""
    t0 = time.perf_counter()
    tiered, resident = {}, {}
    n = table_np.shape[0]
    for name in QUANT_CODECS:
        q = QuantizedFeature(name, device_cache_size=budget, csr_topo=topo, device=dev)
        q.from_cpu_tensor(table_np)
        tiered[name] = q
        c = get_codec(name)
        r = QuantizedFeature(name, device_cache_size=int(n * c.row_bytes(DIM)), device=dev)
        r.from_cpu_tensor(table_np)
        resident[name] = r
    log("quant tables: " + json.dumps({
        name: {"hot_rows": q.hot_rows, "hot_share": q.hot_rows / n, "tiers": q.tier_bytes(),
               "side_table_bytes": q.side_table_bytes()} for name, q in tiered.items()}
    ) + f" in {time.perf_counter() - t0:.1f} s")
    return tiered, resident


def staged_batch(feature, ds):
    """One batch staged as the pipeline stages it: (hot_table, mapped,
    cold_rows, cold_pos, pipeline)."""
    pipe = TieredFeaturePipeline(feature)
    mapped, cold_rows, cold_pos = pipe.prepare(ds.n_id, valid_count=int(ds.count))
    torch.cuda.synchronize()
    return pipe.hot_table, mapped, cold_rows, cold_pos, pipe


def lookup_bytes(hot_table, mapped, cold_rows, row_bytes, side_bytes=0):
    """Least bytes of a tiered lookup: W ids, each distinct hot row (and
    its side entries) read once, the staged cold rows and slots read once,
    the [W, D] output written once."""
    m = mapped.long()
    hot = torch.unique(m[(m >= 0) & (m < hot_table.shape[0])]).numel()
    valid = torch.unique(m[m >= 0]).numel()
    W, C_b = mapped.numel(), cold_rows.shape[0]
    return W * 4 + hot * row_bytes + valid * side_bytes + C_b * (row_bytes + 4) + W * DIM * 4


def kernel_phase_3(topo, tiered, qtiered, qresident, seeds, rows, rate, seed):
    """Hold K5, K9a, K9b and K3t over int8 and bf16 rows against their
    plain versions on one real batch and time them; adds K5's row and the
    int8 rows of K9a and K9b to ``rows`` (the bf16 calls and K3t's narrow
    rows are logged only)."""
    dev = seeds.device
    n = topo.node_count
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 21)
    ds = sampler.sample_dense(seeds)
    count = int(ds.count)

    # K5: the fp32 20% store's assembly
    hot, mapped, cold_rows, cold_pos, pipe = staged_batch(tiered, ds)
    got = tiered_lookup(hot, mapped, cold_rows, cold_pos)
    want = tiered_lookup_plain(hot, mapped, cold_rows, cold_pos)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K5 differs from its plain version")
    check(torch.equal(got[:count], tiered[ds.n_id[:count]]), "K5 rows differ from Feature[n_id]")
    cold = int((cold_pos < mapped.numel()).sum())
    log(json.dumps({"k5_slots": mapped.numel(), "k5_valid": count, "k5_cold_rows": cold,
                    "k5_cold_bucket": cold_rows.shape[0]}))
    record(rows, "tiered_lookup", 0.0, time_ms(lambda: tiered_lookup(hot, mapped, cold_rows,
                                                                       cold_pos)),
           time_ms(lambda: tiered_lookup_plain(hot, mapped, cold_rows, cold_pos), reps=5),
           bound(lookup_bytes(hot, mapped, cold_rows, DIM * 4)), None,
           shape=f"W={mapped.numel()} H={hot.shape[0]} C_b={cold_rows.shape[0]} D={DIM}")

    for name in QUANT_CODECS:
        codec = get_codec(name)
        es = int(codec.bytes_per_elem)
        side = int(codec.side_bytes_per_row)
        # K9a: the resident table, every lane clipped into range
        r = qresident[name]
        table = r.shard_tensor.device_rows
        ids = ds.n_id
        got = r.lookup_padded(ids)
        want = gather_dequant_plain(codec, table, ids, r.scale, r.zero)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K9a {name} differs from its plain version")
        distinct = torch.unique(torch.clamp(ids.long(), 0, n - 1)).numel()
        record(rows, "gather_dequant", 0.0,
               time_ms(lambda: gather_dequant(codec, table, ids, r.scale, r.zero)),
               time_ms(lambda: gather_dequant_plain(codec, table, ids, r.scale, r.zero), reps=5),
               bound(ids.numel() * 4 + distinct * (DIM * es + side) + ids.numel() * DIM * 4),
               None, shape=f"{name} W={ids.numel()} N={n} D={DIM}", report=name == "int8")
        # K9b: the store at the fp32 leg's device bytes
        q = qtiered[name]
        hot, mapped, cold_rows, cold_pos, _ = staged_batch(q, ds)
        args = (codec, hot, mapped, cold_rows, cold_pos, q.scale, q.zero)
        got = quantized_tiered_lookup(*args)
        want = quantized_tiered_lookup_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K9b {name} differs from its plain version")
        check(torch.equal(got[:count], q[ds.n_id[:count]]),
              f"K9b {name} rows differ from QuantizedFeature[n_id]")
        log(json.dumps({"k9b": name, "hot_rows": q.hot_rows, "cold_rows":
                        int((cold_pos < mapped.numel()).sum()), "cold_bucket": cold_rows.shape[0]}))
        record(rows, "quantized_tiered_lookup", 0.0, time_ms(lambda: quantized_tiered_lookup(*args)),
               time_ms(lambda: quantized_tiered_lookup_plain(*args), reps=5),
               bound(lookup_bytes(hot, mapped, cold_rows, DIM * es, side)), None,
               shape=f"{name} W={mapped.numel()} H={hot.shape[0]} C_b={cold_rows.shape[0]}",
               report=name == "int8")
        # K3t over the store's encoded rows (its hot prefix and pinned tail)
        st = q.shard_tensor
        got = q.inner.gather_stored(mapped)
        want = tiered_gather_plain(st.device_rows, st.cpu_tensor, mapped, n)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K3t over {name} rows differs from its plain version")
        m = mapped.long()
        stored = torch.unique(m[m >= 0])
        host_rows = int((stored >= st.device_rows.shape[0]).sum())
        hbm = mapped.numel() * 4 + (stored.numel() - host_rows) * DIM * es \
            + mapped.numel() * DIM * es
        t_b = max(hbm / HBM_BYTES_PER_S * 1e3, host_rows * DIM * es / rate * 1e3)
        record(rows, "tiered_gather", 0.0, time_ms(lambda: q.inner.gather_stored(mapped)),
               time_ms(lambda: tiered_gather_plain(st.device_rows, st.cpu_tensor, mapped, n),
                       reps=5),
               (t_b, "bytes"), None, report=False,
               shape=f"{name} rows n={mapped.numel()} host_rows={host_rows} D={DIM}")


def pipeline_leg(name, topo, feature, labels, order, seed):
    """TrainPipeline on one table: 6 warm-up batches, 20 timed batches at
    depth 1 and at depth 2, a sequential pass (each stage alone, then the
    step), a measure_overlap epoch. Returns the launches of the timed
    epochs."""
    dev = labels.device
    model = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    pipe = TieredFeaturePipeline(feature)
    if name == "fp32":
        step = make_tiered_train_step(model, opt, labels, pipe.hot_table)
        lookup = "tiered_lookup"
    else:
        step = make_quantized_train_step(model, opt, labels, pipe.hot_table, feature.scale,
                                         feature.zero, codec=name)
        lookup = f"quantized_tiered_lookup/{name}"
    drop = torch.Generator(device=dev).manual_seed(seed + 1)
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 5)
    batches = iter(order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                   for i in range(len(order) // TRAIN_BATCH))

    def take(k):
        return [next(batches) for _ in range(k)]

    def pipeline(**kw):
        return TrainPipeline(sampler, feature, step, tiered=pipe, **kw)

    row_bytes = DIM * feature.shard_tensor.dtype.itemsize
    # warm-up at depth 2: its chains in flight allocate the pinned staging
    # blocks the timed epochs then reuse (a 105 MB first allocation can take
    # hundreds of ms)
    pipeline(depth=2).run_epoch(take(PIPE_WARMUP), drop)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    out = {"leg": name, "batches": PIPE_BATCHES, "hot_rows": pipe.hot_rows,
           "hot_share": pipe.hot_rows / topo.node_count, "row_bytes": row_bytes}
    for depth in (1, 2):
        tp = pipeline(depth=depth)
        t0 = time.perf_counter()
        losses = tp.run_epoch(take(PIPE_BATCHES), drop)
        wall = time.perf_counter() - t0
        starts = sorted(t for s, t, _ in tp.stats.spans if s == "step_dispatch")
        ov = tp.stats.overlap_summary()
        check(all(np.isfinite(losses)), f"{name} depth {depth}: loss not finite")
        out[f"depth{depth}"] = {
            "batch_ms": median_min_max(np.diff(starts) * 1e3), "epoch_ms_per_batch":
            wall / PIPE_BATCHES * 1e3,
            "busy_ms_per_batch": {k: v / PIPE_BATCHES * 1e3 for k, v in ov["busy_s"].items()},
            "overlap_frac": ov["overlap_frac"], "hidden_frac_measured": ov["hidden_frac_measured"],
            "cold_rows_per_batch": tp.stats.cold_rows / PIPE_BATCHES,
            "cold_bytes_per_batch": tp.stats.cold_rows / PIPE_BATCHES * row_bytes,
            "loss_first": losses[0], "loss_last": losses[-1]}
    counts = _kernels.counts()
    # the sequential reference: each stage alone, then the step, per batch
    tp = pipeline()
    alone = {"sample": 0.0, "gather": 0.0, "upload": 0.0, "step": 0.0}
    for s in take(PIPE_BATCHES):
        t0 = time.perf_counter()
        r = tp._sample_body(sampler.sample_dense(s), s)
        t1 = time.perf_counter()
        r = tp._gather_body(*r)
        t2 = time.perf_counter()
        b = tp._upload_body(*r)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        float(step(b, drop))
        t4 = time.perf_counter()
        for k, a, z in (("sample", t0, t1), ("gather", t1, t2), ("upload", t2, t3),
                        ("step", t3, t4)):
            alone[k] += (z - a) / PIPE_BATCHES * 1e3
    out["sequential_ms_per_batch"] = dict(alone, total=sum(alone.values()))
    # the step spans of this epoch cover the step's device work
    tp = pipeline(depth=1, measure_overlap=True)
    losses = tp.run_epoch(take(PIPE_BATCHES), drop)
    ov = tp.stats.overlap_summary()
    out["measured"] = {"busy_ms_per_batch": {k: v / PIPE_BATCHES * 1e3
                                             for k, v in ov["busy_s"].items()},
                       "overlap_frac": ov["overlap_frac"],
                       "hidden_frac_measured": ov["hidden_frac_measured"],
                       "covered_ms_per_batch": ov["covered_wall_s"] / PIPE_BATCHES * 1e3,
                       "loss_last": losses[-1]}
    out["launches"] = {k: v for k, v in counts.items() if v}
    log("pipeline: " + json.dumps(out))
    check(all(np.isfinite(losses)), f"{name} measured epoch: loss not finite")
    for k in ("sample_tiled", "local_reindex", "masked_mean", "masked_mean_backward/cols", lookup):
        check(counts[k] > 0, f"kernel {k} never launched on the {name} pipeline")
    del model, opt, step
    return counts


def pipeline_phase(topo, tiered, qtiered, qresident, train_idx, seed):
    """The three pipeline legs, then 20 steps of sample_dense +
    QuantizedFeature.lookup_padded on the resident int8 table. Returns the
    launches summed over them."""
    dev = tiered.device
    n = topo.node_count
    labels = torch.randint(0, CLASSES, (n,), generator=torch.Generator(device=dev).manual_seed(8),
                           device=dev)
    order = np.random.default_rng(seed + 4).permutation(train_idx)
    total = {}
    for name, feature in (("fp32", tiered), ("int8", qtiered["int8"]), ("bf16", qtiered["bf16"])):
        for k, v in pipeline_leg(name, topo, feature, labels, order, seed).items():
            total[k] = total.get(k, 0) + v

    # K9a on a train path: the resident int8 table's fused lookup
    q = qresident["int8"]
    sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 6)
    model = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    drop = torch.Generator(device=dev).manual_seed(seed + 1)

    def step(seeds):
        ds = sampler.sample_dense(seeds)
        loss = F.cross_entropy(model(q.lookup_padded(ds.n_id), ds.adjs, train=True,
                                     generator=drop), labels[ds.n_id[:TRAIN_BATCH].long()])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    batches = [order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for i in range(2 + PIPE_BATCHES)]
    for s in batches[:2]:
        step(s)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    times, losses = [], []
    for s in batches[2:]:
        t0 = time.perf_counter()
        losses.append(float(step(s)))
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _kernels.counts()
    log("pipeline: " + json.dumps({"leg": "sample_dense+QuantizedFeature(int8).lookup_padded",
                                   "steps": PIPE_BATCHES, "step_ms": median_min_max(times),
                                   "loss_first": losses[0], "loss_last": losses[-1],
                                   "launches": {k: v for k, v in counts.items() if v}}))
    check(all(np.isfinite(losses)), "the K9a leg's loss is not finite")
    for k in ("sample_tiled", "local_reindex", "masked_mean", "gather_dequant/int8"):
        check(counts[k] > 0, f"kernel {k} never launched on the K9a leg")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


# -- the out-of-core slice -----------------------------------------------------------

def prob_errors(got, want, in_deg, what):
    """Hold K11's ``got`` against a plain version's ``want``: two float32
    sums of the same n >= 0 terms in two orders each lie within
    (n - 1) * 2^-24 of their exact sum, so they may differ by twice that
    (times the sum) and no more; a node of one in-edge or none must be
    equal. Returns (max |got - want|, max |got - want| / want, the largest
    share of that bound used)."""
    got, want, in_deg = got.double(), want.double(), in_deg.double()
    diff = (got - want).abs()
    tol = 2 * torch.clamp(in_deg - 1, min=0) * 2.0**-24 * torch.maximum(got, want) * 1.001
    check(bool((diff <= tol).all()), f"{what}: K11 differs from its plain version by more than "
          "the float32 rounding of the two orders of addition")
    nz = want != 0
    rel = float((diff[nz] / want[nz]).max()) if bool(nz.any()) else 0.0
    used = float((diff[tol > 0] / tol[tol > 0]).max()) if bool((tol > 0).any()) else 0.0
    return float(diff.max()), rel, used


def prob_order_check(got, exact, depth, hub, what):
    """Hold K11's ``got`` against ``exact``, the float64 sum of the same
    float32 terms: all are >= 0, so the kernel's order lies within
    d u / (1 - d u) of it, relative (d = `neighbor_prob_depth`, u = 2^-24;
    about 7.5e-5 at the products hub, where dropping one 1,024-edge tile
    costs 8e-4), plus 1e-9 for the float64 sum's own rounding. Returns the
    largest share of that bound used, and the share at node ``hub``."""
    u = 2.0**-24
    dd = depth.double()
    tol = (dd * u / (1 - dd * u) + 1e-9) * exact
    diff = (got.double() - exact).abs()
    check(bool((diff <= tol).all()), f"{what}: K11 lies outside its order's rounding bound "
          "of the exact sum")
    share = torch.where(tol > 0, diff / tol, torch.zeros_like(tol))
    return float(share.max()), float(share[hub])


def kernel_phase_4(topo, tiered, train_idx, rows):
    """K6 on the 20% cache's fp32 table (a 65,000-row promotion batch
    padded to its bucket, slots from the seed) and K11 per hop and for a
    whole sample_prob on the products graph, each against its plain
    version; adds their rows to ``rows``. Returns the seconds the
    transposed graph took to build."""
    dev = tiered.device
    n = topo.node_count
    rng = np.random.default_rng(PROMOTE_ROWS)
    table = tiered.shard_tensor.device_rows
    H = table.shape[0]
    b = round_up_pow2(PROMOTE_ROWS, floor=256)
    slots = torch.full((b,), H, dtype=torch.int64)
    slots[:PROMOTE_ROWS] = torch.from_numpy(rng.choice(H, PROMOTE_ROWS, replace=False))
    promo = torch.from_numpy(rng.standard_normal((b, DIM)).astype(np.float32))
    slots, promo = slots.to(dev), promo.to(dev)
    untouched = table.clone()
    got = set_rows(table, slots, promo)
    want = set_rows_plain(table, slots, promo)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K6 differs from its plain version")
    check(torch.equal(table, untouched), "K6 wrote into its input table: copy-on-write broken")
    del got, want, untouched
    valid = slots[:PROMOTE_ROWS]
    clone_ms = time_ms(lambda: table.clone())
    log(json.dumps({"k6_table_rows": H, "k6_bucket": b, "k6_rows": PROMOTE_ROWS,
                    "k6_clone_ms": clone_ms}))
    # least bytes: the rows that keep their bytes and the promoted rows read,
    # the slots read, the new table written
    record(rows, "set_rows", 0.0, time_ms(lambda: set_rows(table, slots, promo)),
           time_ms(lambda: set_rows_plain(table, slots, promo), reps=5),
           bound((H - PROMOTE_ROWS) * DIM * 4 + PROMOTE_ROWS * DIM * 4 + b * 8 + H * DIM * 4),
           time_ms(lambda: torch.index_copy(table, 0, valid, promo[:PROMOTE_ROWS])),
           shape=f"H={H} b={b} rows={PROMOTE_ROWS} D={DIM}")

    t0 = time.perf_counter()
    tr = topo.to_device_transposed(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    indptr, indices = topo.to_device(dev)
    e = int(tr.tsrc.numel())
    log(json.dumps({"k11_transposed_build_s": build_s, "edges": e,
                    "tiles": int(tr.tile_node.numel()), "long_nodes": int(tr.long_nodes.numel()),
                    "tile": tr.tile, "top_in_degree": int((tr.tindptr[1:] - tr.tindptr[:-1]).max())}))
    train_t = torch.from_numpy(np.asarray(train_idx)).to(dev)
    deg = indptr[1:] - indptr[:-1]
    src = torch.repeat_interleave(torch.arange(n, device=dev), deg.long())
    dst = indices.long()
    d = torch.clamp(deg.to(torch.float32), min=1.0)
    last = torch.zeros(n, device=dev)
    last[train_t] = 1.0
    in_deg = tr.tindptr[1:] - tr.tindptr[:-1]
    depth = neighbor_prob_depth(tr)
    hub = int(in_deg.argmax())
    cpu_graph = (indptr.cpu(), indices.cpu())
    for k in SIZES:
        got = neighbor_prob(indptr, indices, last, k, tr)
        again = neighbor_prob(indptr, indices, last, k, tr)
        want = neighbor_prob_plain(indptr, indices, last, k)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K11 at k={k}: two runs differ")
        err, rel, used = prob_errors(got, want, in_deg, f"k={k}")
        # the plain version on the CPU adds in the reference's order
        seq = neighbor_prob_plain(*cpu_graph, last.cpu(), k)
        _, rel_seq, used_seq = prob_errors(got.cpu(), seq, in_deg.cpu(), f"k={k}, CPU")
        exact = neighbor_prob_plain(indptr, indices, last, k, acc_dtype=torch.float64)
        used_exact, used_hub = prob_order_check(got, exact, depth, hub, f"k={k}")
        contrib = (last * torch.clamp(torch.full_like(d, float(k)) / d, max=1.0))[src]
        # least bytes: the transposed sources once; tindptr, deg, prob and the
        # output once a node, and the weights w written and read once (the
        # [N] w stays in the L2, so its per-edge reads are not HBM bytes)
        record(rows, "neighbor_prob", err, time_ms(lambda: neighbor_prob(indptr, indices, last, k, tr)),
               time_ms(lambda: neighbor_prob_plain(indptr, indices, last, k), reps=5),
               bound(e * 4 + n * (8 + 4 + 4 + 4 + 8), f32_adds=e),
               time_ms(lambda: torch.zeros(n, device=dev).index_add_(0, dst, contrib), reps=5),
               shape=f"N={n} E={e} k={k}")
        log(json.dumps({"k11_hop_k": k, "max_rel_err": rel, "max_abs_err": err,
                        "bound_share_used": used, "max_rel_err_vs_cpu_sequential": rel_seq,
                        "bound_share_used_vs_cpu": used_seq,
                        "order_bound_share_used": used_exact,
                        "order_bound_share_used_at_hub": used_hub, "hub_in_edges":
                        int(in_deg[hub]), "hub_depth": int(depth[hub])}))
        del exact
        last = got
        del contrib, seq
    del src, dst

    def plain_sample_prob():
        prob = torch.zeros(n, device=dev)
        prob[train_t] = 1.0
        cur = prob
        for k in SIZES:
            cur = neighbor_prob_plain(indptr, indices, cur, k)
            prob = prob + cur
        return prob

    got = sample_prob(indptr, indices, SIZES, train_t, n, tr)
    again = sample_prob(indptr, indices, SIZES, train_t, n, tr)
    want = plain_sample_prob()
    torch.cuda.synchronize()
    check(torch.equal(got, again), "sample_prob: two runs differ")
    err = float((got - want).abs().max())
    nz = want > 0
    check(bool((got[~nz] == 0).all()), "sample_prob gives heat to a node its plain version does not")
    rel = float(((got - want).abs()[nz] / want[nz]).max())
    log(json.dumps({"sample_prob_ms": time_ms(lambda: sample_prob(indptr, indices, SIZES, train_t,
                                                                  n, tr), reps=5),
                    "sample_prob_plain_ms": time_ms(plain_sample_prob, reps=3),
                    "max_rel_err": rel, "max_abs_err": err, "train_nodes": int(train_t.numel())}))
    return build_s


class TapPipeline(TieredFeaturePipeline):
    """A TieredFeaturePipeline that also counts each batch's valid lanes
    and, with ``keep_ids``, keeps their stored rows: the exact per-row
    counts an adaptive placement is planned from."""

    def __init__(self, feature, keep_ids=False, **kw):
        super().__init__(feature, **kw)
        self.valid_rows = 0
        self.ids = [] if keep_ids else None

    def prepare_host(self, ids, valid_count=None):
        flat = torch.as_tensor(ids).reshape(-1).cpu()
        v = flat[:valid_count] if valid_count is not None else flat
        v = v[(v >= 0) & (v < self.feature.shape[0])].to(torch.int64)
        self.valid_rows += v.numel()
        if self.ids is not None:
            stored = self._order[v] if self._order is not None else v
            self.ids.append(stored.numpy().copy())
        return super().prepare_host(ids, valid_count)


def fs_type(path: str) -> str:
    """The filesystem type of the mount that holds ``path``."""
    best, kind = "", "unknown"
    try:
        for line in Path("/proc/mounts").read_text().splitlines():
            parts = line.split()
            if len(parts) > 2 and path.startswith(parts[1]) and len(parts[1]) > len(best):
                best, kind = parts[1], parts[2]
    except OSError:
        pass
    return kind


def renumbered_csr(topo, order, inv) -> CSRTopo:
    """The graph with node ``order[j]`` renamed ``j`` (``inv`` the
    inverse): the CSR that ``CSRTopo(edge_index=inv[edge_index])`` builds,
    each row's edges in their old order, without its sort of every edge."""
    deg = np.diff(topo.indptr)
    new_deg = deg[order]
    indptr = np.zeros(order.shape[0] + 1, np.int64)
    np.cumsum(new_deg, out=indptr[1:])
    idx = np.repeat(topo.indptr[:-1][order] - indptr[:-1], new_deg)
    idx += np.arange(idx.shape[0], dtype=np.int64)
    return CSRTopo(indptr=indptr, indices=inv[topo.indices[idx]])


def tiers_phase(topo, table_np, train_idx, seed, dev):
    """The out-of-core path: heat from K11's sample_prob, heat_reorder,
    then TrainPipeline through the disk tier on four legs — (a) static
    4-tier, prefetch off; (b) prefetch on; (c) adaptive: an epoch, a plan
    from its exact row counts, TierStore.apply (K6), a fresh pipeline and a
    second epoch; (d) QuantizedFeature(int8) with a disk tail — against an
    all-DRAM epoch with the same seeds. Returns the launches of the main
    path's parts and the heat order (order[new_id] = old_id)."""
    n = topo.node_count
    launches = {}
    # the heat: K11 on the main path
    _kernels.reset_counts()
    t0 = time.perf_counter()
    heat = GraphSageSampler(topo, SIZES, device=dev, seed=seed).sample_prob(train_idx, n)
    heat = heat.cpu().numpy()
    heat_s = time.perf_counter() - t0
    launches["neighbor_prob"] = _kernels.counts()["neighbor_prob"]
    check(launches["neighbor_prob"] > 0, "K11 never launched building the heat")
    check(bool(np.isfinite(heat).all()) and heat[train_idx].min() >= 1.0, "heat malformed")
    t0 = time.perf_counter()
    edge_index = np.stack([np.repeat(np.arange(n, dtype=np.int64), np.diff(topo.indptr)),
                           topo.indices])
    edge_r, feats_r, _, (train_r,), order, inv = heat_reorder(edge_index, n, table_np, None,
                                                             (train_idx,), heat=heat)
    del edge_index
    topo_r = renumbered_csr(topo, order, inv)
    tile_build("renumbered ids (tiers)", lambda: topo_r.to_device_tiled(dev))
    probe = np.sort(np.random.default_rng(seed).choice(n, 48, replace=False))
    probe = np.concatenate([[0, 1], probe])  # the two hottest rows too
    sel = np.isin(edge_r[0], probe)
    src_p, dst_p = edge_r[0][sel], edge_r[1][sel]
    for j in probe:
        check(np.array_equal(dst_p[src_p == j], topo_r.indices[topo_r.indptr[j]:topo_r.indptr[j + 1]]),
              f"renumbered row {j} differs from heat_reorder's edges")
    del edge_r, sel, src_p, dst_p
    reorder_s = time.perf_counter() - t0
    log("tiers: " + json.dumps({"heat_build_s": heat_s, "heat_reorder_s": reorder_s,
                                "k11_launches": launches["neighbor_prob"],
                                "heat_top": float(heat[order[0]]),
                                "heat_at_20pct": float(heat[order[int(n * CACHE_FRAC)]]),
                                "nodes_with_heat": int((heat > 0).sum())}))

    labels = torch.randint(0, CLASSES, (n,), generator=torch.Generator(device=dev).manual_seed(8),
                           device=dev)
    cache_b = int(n * CACHE_FRAC) * DIM * 4
    perm = np.random.default_rng(seed + 7).permutation(train_r)
    batches = [perm[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
               for i in range(2 * TIER_BATCHES + TIER_WARMUP)]
    b_warm, b0, b1 = (batches[:TIER_WARMUP], batches[TIER_WARMUP:TIER_WARMUP + TIER_BATCHES],
                      batches[TIER_WARMUP + TIER_BATCHES:])

    def epoch(feature, bs, keep_ids=False, quant=None, **kw):
        model = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        pipe = TapPipeline(feature, keep_ids=keep_ids, prefetch=kw.pop("prefetch", False),
                           prefetch_max_rows=PREFETCH_ROWS)
        if quant is None:
            step = make_tiered_train_step(model, opt, labels, pipe.hot_table)
        else:
            step = make_quantized_train_step(model, opt, labels, pipe.hot_table, feature.scale,
                                             feature.zero, codec=quant)
        tp = TrainPipeline(GraphSageSampler(topo_r, SIZES, device=dev, seed=seed + 5), feature,
                           step, tiered=pipe, **kw)
        t0 = time.perf_counter()
        losses = tp.run_epoch(bs, torch.Generator(device=dev).manual_seed(seed + 1))
        wall = time.perf_counter() - t0
        check(all(np.isfinite(losses)), "a tiers leg's loss is not finite")
        return losses, wall, tp, pipe

    def report(leg, feature, losses, wall, tp, pipe, mode, row_bytes=DIM * 4, **extra):
        nb = len(losses)
        starts = sorted(t for s, t, _ in tp.stats.spans if s == "step_dispatch")
        ov = tp.stats.overlap_summary()
        cold, disk = pipe.cold_rows_seen / nb, pipe.disk_rows_seen / nb
        per = {"hbm": pipe.valid_rows / nb - cold, "host": cold - disk, "disk": disk}
        out = {"leg": leg, "batches": nb, "read_mode": mode,
               "batch_ms": wall / nb * 1e3,
               "step_interval_ms": median_min_max(np.diff(starts) * 1e3),
               "busy_ms_per_batch": {k: v / nb * 1e3 for k, v in ov["busy_s"].items()},
               "overlap_frac": ov["overlap_frac"],
               "rows_per_batch": per,
               "mb_per_batch": {k: v * row_bytes / 1e6 for k, v in per.items()},
               "prefetch": pipe.prefetch_stats, "loss_first": losses[0], "loss_last": losses[-1]}
        out.update(extra)
        log("tiers: " + json.dumps(out))
        return out

    with tempfile.TemporaryDirectory(prefix="qt-tiers-") as tmp:
        t0 = time.perf_counter()
        dram = Feature(device_cache_size=cache_b, device=dev)
        dram.from_cpu_tensor(feats_r)
        static = Feature(device_cache_size=cache_b, host_memory_budget=cache_b,
                         disk_path=os.path.join(tmp, "static.npy"), device=dev)
        static.from_cpu_tensor(feats_r)
        adaptive = Feature(device_cache_size=cache_b, host_memory_budget=cache_b,
                           disk_path=os.path.join(tmp, "adaptive.npy"), adaptive_tiers=True,
                           device=dev)
        adaptive.from_cpu_tensor(feats_r)
        q8 = QuantizedFeature("int8", device_cache_size=cache_b,
                              disk_path=os.path.join(tmp, "int8.npy"), device=dev)
        q8.from_cpu_tensor(feats_r)
        st = static.shard_tensor
        direct = o_direct_supported(st.disk_shard.path)
        log("tiers: " + json.dumps({
            "tmp_fs": fs_type(tmp), "o_direct_supported": direct,
            "build_s": time.perf_counter() - t0, "static": static.tier_bytes(),
            "adaptive": adaptive.tier_bytes(), "int8": q8.tier_bytes(),
            "int8_side_table_bytes": q8.side_table_bytes(), "int8_hot_rows": q8.hot_rows}))
        # reads: O_DIRECT where the filesystem takes it (cold by construction),
        # else through the page cache after drop_page_cache
        mapped_shard = st.disk_shard
        primary = "O_DIRECT" if direct else "page cache dropped"
        if direct:
            st.disk_shard = DiskShard(st.disk_shard.path, direct=True)
            adaptive.tier_store.backing = DiskShard(adaptive.tier_store.backing.path, direct=True)
            q8.shard_tensor.disk_shard = DiskShard(q8.shard_tensor.disk_shard.path, direct=True)
        direct_shard = st.disk_shard
        for f in (dram, static, adaptive):
            epoch(f, b_warm, depth=2)  # allocates the pinned staging blocks
        torch.cuda.synchronize()

        ref, wall, tp, pipe = epoch(dram, b1)
        report("all-DRAM reference", dram, ref, wall, tp, pipe, "host DRAM")

        def drop():
            """Evict the disk files from the page cache; logs whether it took."""
            done = [drop_page_cache(f) for f in (st.disk_shard.path, adaptive.tier_store.backing.path,
                                                 q8.shard_tensor.disk_shard.path)]
            log("tiers: " + json.dumps({"drop_page_cache": done}))

        # leg (a) in the primary mode, then (where that was O_DIRECT) through
        # the page cache dropped, and once more warm: a DRAM read
        legs = [("a", False, primary)]
        if direct:
            legs.append(("a", False, "page cache dropped"))
        legs += [("a", False, "page cache warm (a DRAM read)"), ("b", True, primary)]
        out = {}
        for leg, prefetch, mode in legs:
            st.disk_shard = direct_shard if mode == "O_DIRECT" else mapped_shard
            if mode == "page cache dropped":
                drop()
            _kernels.reset_counts()
            losses, wall, tp, pipe = epoch(static, b1, prefetch=prefetch)
            counts = _kernels.counts()
            check(counts["tiered_lookup"] > 0, f"K5 never launched on tiers leg {leg}")
            check(losses == ref, f"tiers leg {leg} ({mode}) losses differ from the all-DRAM epoch")
            out[(leg, mode)] = report(f"{leg}: static 4-tier, prefetch {'on' if prefetch else 'off'}",
                                      static, losses, wall, tp, pipe, mode,
                                      bit_equal_to_dram=True)
        launches["tiered_lookup"] = counts["tiered_lookup"]

        # (c) adaptive: an epoch, exact counts, a plan, the apply, a fresh epoch
        store = adaptive.tier_store
        mode_c = primary
        if not direct:
            drop()
        losses0, wall, tp, pipe_c1 = epoch(adaptive, b0, keep_ids=True)
        report("c1: adaptive, first epoch", adaptive, losses0, wall, tp, pipe_c1, mode_c)
        counts_rows = np.bincount(np.concatenate(pipe_c1.ids), minlength=n)
        hot_stored = np.nonzero(counts_rows)[0]
        t0 = time.perf_counter()
        plan = plan_adaptive(store.placement, hot_stored, counts_rows[hot_stored].astype(np.float64),
                             lambda ids: counts_rows[ids].astype(np.float64), max_moves=MAX_MOVES)
        plan_s = time.perf_counter() - t0
        old_table = pipe_c1.hot_table
        _kernels.reset_counts()
        t0 = time.perf_counter()
        summary = store.apply(plan)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        launches["set_rows"] = _kernels.counts()["set_rows"]
        check(launches["set_rows"] > 0 and summary["promoted_hbm"] > 0,
              "the plan promoted no row into HBM: K6 never launched")
        check(store.hbm_table is not old_table, "apply did not swap the HBM table")
        ds = GraphSageSampler(topo_r, SIZES, device=dev, seed=seed + 9).sample_dense(b1[0])
        count = int(ds.count)
        x_old = tiered_lookup(old_table, *pipe_c1.prepare(ds.n_id, valid_count=count))
        check(torch.equal(x_old[:count], dram[ds.n_id[:count]]),
              "the pipeline built before apply gathers other bytes after it")
        log("tiers: " + json.dumps({
            "leg": "c: plan and apply", "rows_counted": int(counts_rows.sum()),
            "distinct_rows": int(hot_stored.size), "plan_moves": len(plan), "plan_s": plan_s,
            "apply_s": apply_s, "k6_launches": launches["set_rows"],
            **{k: v for k, v in summary.items() if k != "moved_stored"}}))
        if not direct:
            drop()
        _kernels.reset_counts()
        losses2, wall, tp, pipe = epoch(adaptive, b1)
        counts = _kernels.counts()
        check(counts["tiered_lookup"] > 0, "K5 never launched on tiers leg c")
        check(losses2 == ref, "the adaptive second epoch's losses differ from the static run's")
        launches["tiered_lookup"] += counts["tiered_lookup"]
        report("c2: adaptive after apply", adaptive, losses2, wall, tp, pipe, mode_c,
               bit_equal_to_static=True)

        # K5 on one staged batch of the static store: its share of a batch
        sp = TieredFeaturePipeline(static)
        args = (sp.hot_table, *sp.prepare(ds.n_id, valid_count=count))
        k5_ms = time_ms(lambda: tiered_lookup(*args))
        log("tiers: " + json.dumps({"k5_ms_one_batch": k5_ms, "k5_share_of_leg_a_batch":
                                    k5_ms / out[(legs[0][0], legs[0][2])]["batch_ms"]}))

        # (d) the int8 store with a disk tail (K9b decodes the staged rows)
        if not direct:
            drop()
        _kernels.reset_counts()
        losses, wall, tp, pipe = epoch(q8, b1[:TIER_INT8_BATCHES], quant="int8")
        counts = _kernels.counts()
        check(counts["quantized_tiered_lookup/int8"] > 0, "K9b never launched on tiers leg d")
        launches["quantized_tiered_lookup"] = counts["quantized_tiered_lookup"]
        report("d: int8 QuantizedFeature, disk tail", q8, losses, wall, tp, pipe, mode_c,
               row_bytes=DIM)
        for f in (static, adaptive, q8.inner):
            f.read_pool.shutdown()
        del dram, static, adaptive, q8, store, old_table, sp, args
    return launches, order


# -- the weighted and temporal slice ----------------------------------------------

def f64_ops_per_lane() -> dict:
    """FP64 instructions (DFMA, DADD, DMUL) a live lane of each Gumbel
    kernel executes, counted from the built library's SASS (``cuobjdump
    -sass``): the unpredicated ones of the kernel, whose lane loop is not
    unrolled and whose three logs (and exp) are inlined and straight-line;
    the predicated ones serve special and subnormal arguments. Keys
    ``tiled``, ``flat``, ``temporal`` and ``exp``, the temporal kernel's
    count less the tiled one's: its one exp, K8w's work an element (K8w's
    own SASS unrolls its loop, so its count is not an element's)."""
    so = _kernels._lib_path("weighted")
    tool = Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per_fn[fn] = 0
        elif fn and re.search(r"\b(DFMA|DADD|DMUL)\b", line) and not re.search(r"@!?U?P", line):
            per_fn[fn] += 1
    out = {}
    for key, tag in (("tiled", "12TiledWeights"), ("flat", "11FlatWeights"),
                     ("temporal", "15TemporalWeights")):
        hits = [v for f, v in per_fn.items() if tag in f]
        check(len(hits) == 1 and hits[0] > 0, f"no FP64 count for the {key} kernel in the SASS")
        out[key] = hits[0]
    out["exp"] = out["temporal"] - out["tiled"]
    check(out["exp"] > 0, "the temporal kernel's SASS shows no exp")
    log("f64 instructions a live lane (SASS): " + json.dumps(out))
    return out


def gumbel_inputs(indptr, cur, cur_valid, max_deg):
    """``(deg, ptr)`` of a hop's rows: the degree clamped to ``max_deg``
    (0 for an invalid row) and the row start in the flat CSR."""
    s = torch.clamp(cur.long(), 0, indptr.shape[0] - 2)
    ptr = indptr[s].long()
    deg = torch.where(cur_valid, torch.clamp(indptr[s + 1].long() - ptr, max=max_deg), 0)
    return deg, ptr


def gumbel_bound(indptr, cur, cur_valid, k, max_deg, live, f64_per_lane, extra_row_bytes=0):
    """K7/K8's least time for one hop on this hop's data. Bytes: seeds,
    flags (and a query time) per row; per distinct valid seed its (base,
    degree) pair, its min(deg, max_deg) window values and min(deg, k) ids;
    the [W, k] ids and flags written. Operations: a threefry uniform and
    the float64 logarithms (and exp) of each live lane (below its degree,
    weight > 0), at the integer and FP64 rates."""
    W = cur.shape[0]
    s = torch.clamp(cur.long(), 0, indptr.shape[0] - 2)
    u = torch.unique(s[cur_valid])
    deg_u = (indptr[u + 1] - indptr[u]).long()
    n_bytes = (W * (5 + extra_row_bytes) + u.numel() * 8
               + int(torch.clamp(deg_u, max=max_deg).sum()) * 4
               + int(torch.clamp(deg_u, max=k).sum()) * 4 + W * k * 5)
    return bound(n_bytes, live * THREEFRY_INT_OPS, f64_instr=live * f64_per_lane)


def weighted_hops(g, bind, seeds, key, sizes=SIZES):
    """The inputs one batch's dedup ``sample_dense`` hands the weighted
    kernel per hop (``bind(g)`` the sampler's one-hop draw)."""
    sample_fn = bind(g)
    cur, cur_valid = seeds, torch.ones_like(seeds, dtype=torch.bool)
    hops = []
    for k in sizes:
        key, sub = qrandom.split(key)
        nbrs, valid = sample_fn(cur, cur_valid, k, sub)
        hops.append(dict(cur=cur, cur_valid=cur_valid, k=k, key=sub))
        res = reindex.local_reindex(cur, cur_valid, nbrs, valid)
        cur = res.n_id
        cur_valid = torch.arange(cur.shape[0], device=cur.device) < res.count
    return hops


def temporal_hops(graph, seeds, t, key, sizes=SIZES):
    """The inputs one B = 64 ``temporal_sample_dense`` hands K8 per hop:
    rows, flags and query times in the structural layout."""
    bd, tiles, ttiles = graph
    cur, cur_valid, cur_t = seeds, torch.ones_like(seeds, dtype=torch.bool), t
    hops = []
    for k in sizes:
        key, sub = qrandom.split(key)
        nbrs, valid = sample.tiled_temporal_sample_layer(bd, tiles, ttiles, cur, cur_valid, k,
                                                         sub, cur_t, MAX_DEG, RECENCY)
        hops.append(dict(cur=cur, cur_valid=cur_valid, t=cur_t, k=k, key=sub))
        cur = torch.cat([cur, nbrs.t().reshape(-1)])
        cur_valid = torch.cat([cur_valid, valid.t().reshape(-1)])
        cur_t = torch.cat([cur_t, cur_t.repeat(k)])
    return hops


def kernel_phase_5(topo, wtopo, tg, ts_np, seeds_1024, tseeds, tvals, rows, seed):
    """Hold K7 (tiled and flat), K8 (recency 0.02 with and without a
    cutoff, recency 0) and K8w against their plain versions on the card at
    the shapes of real calls, check the t = +inf and host-masked-oracle
    pins there, and time each; adds their rows to ``rows``."""
    dev = seeds_1024.device
    f64 = f64_ops_per_lane()
    indptr = topo.to_device(dev)[0]
    g_tiled = (*tile_build("weighted graph's ids", lambda: wtopo.to_device_tiled(dev)),
               tile_build("edge weights", lambda: wtopo.to_device_tiled_weights(dev)))
    g_flat = (*wtopo.to_device(dev), wtopo.to_device_weights(dev))
    wsampler = GraphSageSampler(wtopo, SIZES, device=dev, seed=seed + 21, weighted=True,
                                max_deg=MAX_DEG)
    graph_w, bind, _ = wsampler.fused_sample_spec()
    hops = weighted_hops(graph_w, bind, seeds_1024, qrandom.key(seed + 22))
    w_flat = g_flat[2]

    def same(got, want, what):
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what} differs from its plain version")

    # K7, tiled then flat, at the three hops of a batch-1024 weighted sample
    for layout, g, fn, plain in (
        ("tiled", g_tiled, sample.tiled_weighted_sample_layer,
         sample.tiled_weighted_sample_layer_plain),
        ("flat", g_flat, sample.weighted_sample_layer, sample.weighted_sample_layer_plain),
    ):
        for h in hops:
            W, k = h["cur"].shape[0], h["k"]
            args = (h["cur"], h["cur_valid"], k, h["key"], MAX_DEG)
            got, want = fn(*g, *args), plain(*g, *args)
            same(got, want, f"K7 {layout} at W={W}")
            deg, ptr = gumbel_inputs(indptr, h["cur"], h["cur_valid"], MAX_DEG)
            # the flat lanes: past a row's degree they hold other rows' weights,
            # which the draw masks, so the scores are the tiled window's too
            lanes = torch.clamp(ptr[:, None] + torch.arange(MAX_DEG, device=dev)[None, :], 0,
                                w_flat.shape[0] - 1)
            scores = sample.gumbel_scores(h["key"], deg, w_flat[lanes])
            live = int(torch.isfinite(scores).sum())
            b = gumbel_bound(indptr, h["cur"], h["cur_valid"], k, MAX_DEG, live, f64[layout])
            record(rows, f"weighted_sample_{layout}", 0.0, time_ms(lambda: fn(*g, *args)),
                   time_ms(lambda: plain(*g, *args), reps=5), b,
                   time_ms(lambda: torch.topk(scores, k)), shape=f"W={W} k={k} live={live}")
        if layout == "tiled":  # draw-equal to the flat layout at max_deg % 128 == 0
            for h in hops:
                args = (h["cur"], h["cur_valid"], h["k"], h["key"], MAX_DEG)
                (tn, tv), (fn_, fv) = fn(*g, *args), sample.weighted_sample_layer(*g_flat, *args)
                check(torch.equal(tv, fv) and torch.equal(tn[tv], fn_[fv]),
                      "K7's tiled and flat draws differ")

    # K8 at the three hops of a B = 64 temporal sample, three variants
    graph = tg.temporal_graph()
    ttiles = graph[2]
    thops = temporal_hops(graph, tseeds, tvals, qrandom.key(seed + 23))
    for name, rec, cutoff, report in (("recency 0.02", RECENCY, None, True),
                                      ("recency 0.02, cutoff 10", RECENCY, 10.0, False),
                                      ("recency 0", 0.0, None, False)):
        for h in thops:
            W, k = h["cur"].shape[0], h["k"]
            args = (h["cur"], h["cur_valid"], k, h["key"], h["t"], MAX_DEG, rec, cutoff)
            got = sample.tiled_temporal_sample_layer(*graph, *args)
            want = sample.tiled_temporal_sample_layer_plain(*graph, *args)
            same(got, want, f"K8 ({name}) at W={W}")
            base = graph[0][torch.clamp(h["cur"].long(), 0, graph[0].shape[0] - 1), 0]
            deg, _ = gumbel_inputs(indptr, h["cur"], h["cur_valid"], MAX_DEG)
            ts_rows = sample._tiled_payload_window(base, ttiles, MAX_DEG)
            w_rows = sample.temporal_weight_rows(ts_rows, h["t"], rec, cutoff)
            scores = sample.gumbel_scores(h["key"], deg, w_rows)
            live = int(torch.isfinite(scores).sum())
            in_deg = torch.arange(ts_rows.shape[1], device=dev)[None, :] < deg[:, None]
            masked = int((in_deg & (w_rows <= 0)).sum())
            log(json.dumps({"k8_mask": name, "W": W, "lanes_below_deg": int(in_deg.sum()),
                            "lanes_masked_by_time": masked,
                            "masked_share": masked / max(int(in_deg.sum()), 1)}))
            b = gumbel_bound(indptr, h["cur"], h["cur_valid"], k, MAX_DEG, live, f64["temporal"],
                             extra_row_bytes=4)
            record(rows, "temporal_sample_tiled", 0.0,
                   time_ms(lambda: sample.tiled_temporal_sample_layer(*graph, *args)),
                   time_ms(lambda: sample.tiled_temporal_sample_layer_plain(*graph, *args),
                           reps=5), b, time_ms(lambda: torch.topk(scores, k)),
                   shape=f"{name} W={W} k={k} live={live}", report=report)

    # K8w over the whole timestamp table, then the two pins
    wt = tg.recency_wtiles(RECENCY)
    check(torch.equal(wt, sample.temporal_edge_weights_plain(ttiles, RECENCY)),
          "K8w differs from its plain version")
    scaled = ttiles * torch.tensor(RECENCY, device=dev)
    record(rows, "recency_weights", 0.0, time_ms(lambda: tg.recency_wtiles(RECENCY)),
           time_ms(lambda: sample.temporal_edge_weights_plain(ttiles, RECENCY), reps=5),
           bound(2 * ttiles.numel() * 4, f64_instr=ttiles.numel() * f64["exp"]),
           time_ms(lambda: torch.exp(scaled)), shape=f"M={ttiles.shape[0]} x 128")
    h = thops[1]  # 1,024 rows
    inf = torch.full_like(h["t"], float("inf"))
    a = sample.tiled_temporal_sample_layer(*graph, h["cur"], h["cur_valid"], h["k"], h["key"],
                                           inf, MAX_DEG, RECENCY)
    b = sample.tiled_weighted_sample_layer(graph[0], graph[1], wt, h["cur"], h["cur_valid"],
                                           h["k"], h["key"], MAX_DEG)
    same(a, b, "K8 at t = +inf against K7 over the recency tiles:")
    args = (h["cur"], h["cur_valid"], h["k"], h["key"], h["t"], MAX_DEG, RECENCY)
    nb, vl = sample.tiled_temporal_sample_layer(*graph, *args)
    onb, ovl = host_masked_oracle(topo.indptr, topo.indices, ts_np, h["cur"].cpu().numpy(),
                                  h["cur_valid"].cpu().numpy(), h["k"], h["key"],
                                  h["t"].cpu().numpy(), max_deg=MAX_DEG, recency=RECENCY)
    vl = vl.cpu().numpy()
    check(np.array_equal(vl, ovl) and np.array_equal(nb.cpu().numpy()[vl], onb[ovl]),
          "K8 differs from the host-masked oracle")
    log(f"kernels-5 pins: t=+inf == weighted over K8w tiles and host-masked oracle, "
        f"{h['cur'].shape[0]} rows each, bit-equal")
    torch.cuda.synchronize()


def mean_pair_check(rows, adj, w_src, D, gen, tag, x=None):
    """K4 within 1e-5 of its plain version and bit-equal when run twice,
    and K4b (where ``x`` is None or a gradient reaches it) bit-equal to its
    plain version on a CPU copy and when run twice, on one hop ``adj``
    (cols or structural), each timed; logged, not added to the report
    rows. Returns K4's `k4_times`."""
    dev = adj.mask.device
    W, k = adj.mask.shape
    lanes = int(adj.mask.sum())
    if adj.cols is None:
        src = W + torch.arange(k, device=dev)[None, :] * W + torch.arange(W, device=dev)[:, None]
    else:
        src = torch.clamp(adj.cols.long(), 0, w_src - 1)
    xs = torch.randn((w_src, D), generator=gen, device=dev) if x is None else x
    got, want = masked_mean_aggregate(xs, adj), masked_mean_aggregate_plain(xs, adj)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
          f"K4 differs from its plain version by {err} at {tag}")
    cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1).to(xs.dtype)
    bag = dict(input=src.reshape(-1).long(), weight=xs, mode="sum",
               offsets=torch.arange(0, W * k, k, device=dev),
               per_sample_weights=(adj.mask.to(xs.dtype) / cnt).reshape(-1))
    check(torch.equal(got, masked_mean_aggregate(xs, adj)), f"K4: two runs differ at {tag}")
    b = bound(W * k * (5 if adj.cols is not None else 1)
              + torch.unique(src[adj.mask]).numel() * D * 4 + W * D * 4,
              f32_adds=lanes * D + W * D)
    k4 = k4_times(time_ms(lambda: masked_mean_aggregate(xs, adj)),
                  time_ms(lambda: F.embedding_bag(**bag)), b,
                  lambda: masked_mean_aggregate(xs, adj), lambda: F.embedding_bag(**bag))
    record(rows, "masked_mean", err, k4["ms"],
           time_ms(lambda: masked_mean_aggregate_plain(xs, adj), reps=5), b,
           k4["embedding_bag_ms"],
           shape=f"{tag} W={W} k={k} D={D}", report=False)
    if x is not None:  # the features take no gradient
        return k4
    g = torch.randn((W, D), generator=gen, device=dev)
    gx = masked_mean_backward(g, adj.mask, adj.cols, w_src)
    again = masked_mean_backward(g, adj.mask, adj.cols, w_src)
    cpu = masked_mean_backward_plain(g.cpu(), adj.mask.cpu(),
                                     None if adj.cols is None else adj.cols.cpu(), w_src)
    torch.cuda.synchronize()
    check(torch.equal(gx, again), f"K4b: two runs differ at {tag}")
    check(torch.equal(gx.cpu(), cpu), f"K4b differs from its plain version at {tag}")
    contrib = (g / cnt)[:, None, :].expand(W, k, D)[adj.mask].contiguous()
    idx = src[adj.mask].contiguous()
    record(rows, "masked_mean_backward", 0.0,
           time_ms(lambda: masked_mean_backward(g, adj.mask, adj.cols, w_src)),
           time_ms(lambda: masked_mean_backward_plain(g, adj.mask, adj.cols, w_src), reps=5),
           bound(W * k * (5 if adj.cols is not None else 1) + W * D * 4 + w_src * D * 4,
                 f32_adds=2 * lanes * D),
           time_ms(lambda: torch.zeros((w_src, D), device=dev).index_add_(0, idx, contrib)),
           shape=f"{tag} W={W} k={k} D={D} W_src={w_src}", report=False)
    return k4


def fanout_phase(topo, wtopo, tg, resident, labels, train_idx, seeds, seed):
    """Fanouts above 32 on the card, at FANOUT_SIZES (k = 64 on the first
    hop): one dedup sample of the 1,024 seeds hop by hop, K1 and K2 each
    bit-equal to its plain version; K4 and K4b on each of its layers
    (mean_pair_check); a GraphSAGE train leg through GraphSageSampler at
    those sizes (K1, K2, K3, K4, K4b launched); K7 tiled and flat (max_deg
    512) and K8 on the seeds at k = 64, bit-equal to their plain versions,
    and the weighted and temporal samplers at those sizes (their kernel
    launched on every hop; the temporal sample's structural hops through
    mean_pair_check). Lines start ``fanout``; returns the leg's launches."""
    dev = seeds.device
    fk = FANOUT_SIZES[0]
    g_tiled = topo.to_device_tiled(dev)
    indptr = topo.to_device(dev)[0]
    key = qrandom.key(seed + 90)
    hops, n_id = hop_inputs(g_tiled, seeds, key, FANOUT_SIZES)
    logged = {}
    for h in hops:
        W, k = h["cur"].shape[0], h["k"]
        args = (h["cur"], h["cur_valid"], k, h["key"])
        got = sample.tiled_sample_layer(*g_tiled, *args)
        want = sample.tiled_sample_layer_plain(*g_tiled, *args)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K1 at W={W} k={k} differs from its plain version")
        record(logged, "sample_tiled", 0.0, time_ms(lambda: sample.tiled_sample_layer(*g_tiled,
                                                                                      *args)),
               time_ms(lambda: sample.tiled_sample_layer_plain(*g_tiled, *args), reps=3),
               sample_bound(indptr, h["cur"], h["cur_valid"], k), shape=f"fanout W={W} k={k}",
               report=False)
        rargs = (h["cur"], h["cur_valid"], h["nbrs"], h["valid"])
        r, rp = reindex.local_reindex(*rargs), reindex.local_reindex_plain(*rargs)
        check(torch.equal(r.n_id, rp.n_id) and torch.equal(r.count, rp.count)
              and torch.equal(r.local_seeds, rp.local_seeds)
              and torch.equal(r.local_nbrs[h["valid"]], rp.local_nbrs[h["valid"]]),
              f"K2 at S={W} k={k} differs from its plain version")
    from quiver_tpu_torch.pyg.sage_sampler import sample_dense_pure

    ds = sample_dense_pure(None, None, key, seeds, FANOUT_SIZES,
                           sample_fn=lambda c, v, k, kk: sample.tiled_sample_layer(*g_tiled, c, v,
                                                                                   k, kk))
    check(torch.equal(ds.n_id, n_id) and ds.adjs[-1].mask.shape == (seeds.shape[0], fk),
          "the k = 64 sample differs from its hop-by-hop inputs")
    gen = torch.Generator(device=dev).manual_seed(seed + 91)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        x = resident.lookup_padded(ds.n_id) if layer == 0 else None
        k4 = mean_pair_check(logged, adj, w_src, DIM if layer == 0 else HIDDEN, gen,
                             f"fanout cols layer {layer}", x=x)
        if adj.mask.shape[1] == fk:
            REDESIGN["K4 k64"] = k4

    # the train leg at k = 64 through the sampler
    sampler = GraphSageSampler(topo, FANOUT_SIZES, device=dev, seed=seed + 92)

    def inputs(s):
        d = sampler.sample_dense(s)
        return d, resident.lookup_padded(d.n_id)

    counts, _ = train_leg(f"sample_dense{list(FANOUT_SIZES)}+lookup_padded", inputs,
                          ("sample_tiled", "local_reindex", "gather_rows", "masked_mean",
                           "masked_mean_backward/cols"), labels, train_idx, seed, FANOUT_STEPS,
                          port_kernel_names(), profile=False, tag="fanout train")

    # K7 tiled and flat, K8, at k = 64 on the seeds; then their samplers
    f64 = f64_ops_per_lane()
    valid = torch.ones_like(seeds, dtype=torch.bool)
    g_w = (*wtopo.to_device_tiled(dev), wtopo.to_device_tiled_weights(dev))
    g_f = (*wtopo.to_device(dev), wtopo.to_device_weights(dev))
    wkey = qrandom.key(seed + 93)
    deg, ptr = gumbel_inputs(indptr, seeds, valid, MAX_DEG)
    wargs = (seeds, valid, fk, wkey, MAX_DEG)
    draws = {}
    for layout, g, fn, plain in (
        ("tiled", g_w, sample.tiled_weighted_sample_layer, sample.tiled_weighted_sample_layer_plain),
        ("flat", g_f, sample.weighted_sample_layer, sample.weighted_sample_layer_plain),
    ):
        got, want = fn(*g, *wargs), plain(*g, *wargs)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K7 {layout} at k={fk} differs from its plain version")
        draws[layout] = got
        lanes = torch.clamp(ptr[:, None] + torch.arange(MAX_DEG, device=dev)[None, :], 0,
                            g_f[2].shape[0] - 1)
        scores = sample.gumbel_scores(wkey, deg, g_f[2][lanes])
        live = int(torch.isfinite(scores).sum())
        record(logged, f"weighted_sample_{layout}", 0.0, time_ms(lambda: fn(*g, *wargs)),
               time_ms(lambda: plain(*g, *wargs), reps=5),
               gumbel_bound(indptr, seeds, valid, fk, MAX_DEG, live, f64[layout]),
               time_ms(lambda: torch.topk(scores, fk)),
               shape=f"fanout W={seeds.shape[0]} k={fk} live={live}", report=False)
    (tn, tv), (fn_, fv) = draws["tiled"], draws["flat"]
    check(torch.equal(tv, fv) and torch.equal(tn[tv], fn_[fv]),
          f"K7's tiled and flat draws differ at k={fk}")
    graph = tg.temporal_graph()
    t = torch.rand(seeds.shape[0], generator=gen, device=dev) * TS_SPAN
    targs = (seeds, valid, fk, wkey, t, MAX_DEG, RECENCY)
    got = sample.tiled_temporal_sample_layer(*graph, *targs)
    want = sample.tiled_temporal_sample_layer_plain(*graph, *targs)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"K8 at k={fk} differs from its plain version")
    base = graph[0][torch.clamp(seeds.long(), 0, graph[0].shape[0] - 1), 0]
    w_rows = sample.temporal_weight_rows(sample._tiled_payload_window(base, graph[2], MAX_DEG), t,
                                         RECENCY)
    scores = sample.gumbel_scores(wkey, deg, w_rows)
    live = int(torch.isfinite(scores).sum())
    record(logged, "temporal_sample_tiled", 0.0,
           time_ms(lambda: sample.tiled_temporal_sample_layer(*graph, *targs)),
           time_ms(lambda: sample.tiled_temporal_sample_layer_plain(*graph, *targs), reps=5),
           gumbel_bound(indptr, seeds, valid, fk, MAX_DEG, live, f64["temporal"],
                        extra_row_bytes=4),
           time_ms(lambda: torch.topk(scores, fk)),
           shape=f"fanout W={seeds.shape[0]} k={fk} live={live}", report=False)
    seeds_np = seeds.cpu().numpy()
    for layout in ("tiled", "flat"):
        ws = GraphSageSampler(wtopo, FANOUT_SIZES, device=dev, seed=seed + 94, weighted=True,
                              max_deg=MAX_DEG, layout=layout)
        _kernels.reset_counts()
        wds = ws.sample_dense(seeds_np)
        torch.cuda.synchronize()
        n = _kernels.counts()[f"weighted_sample_{layout}"]
        check(n == len(FANOUT_SIZES) and wds.adjs[-1].mask.shape == (seeds.shape[0], fk),
              f"the weighted {layout} sampler launched K7 {n} times at {FANOUT_SIZES}")
    tsampler = GraphSageSampler(topo, FANOUT_SIZES, device=dev, seed=seed + 95, dedup=False,
                                max_deg=MAX_DEG).bind_temporal(tg, recency=RECENCY)
    _kernels.reset_counts()
    tds = tsampler.sample_dense(seeds_np[:BATCH], t=t[:BATCH].cpu().numpy())
    torch.cuda.synchronize()
    n = _kernels.counts()["temporal_sample_tiled"]
    check(n == len(FANOUT_SIZES) and tds.adjs[-1].mask.shape == (BATCH, fk),
          f"the temporal sampler launched K8 {n} times at {FANOUT_SIZES}")
    for layer, adj in enumerate(tds.adjs):
        w_src = adj.w_dst * (1 + adj.mask.shape[1])
        mean_pair_check(logged, adj, w_src, HIDDEN, gen, f"fanout structural layer {layer}")
    log("fanout: " + json.dumps({"sizes": list(FANOUT_SIZES), "seeds": int(seeds.shape[0]),
                                 "n_id": int(ds.n_id.shape[0]),
                                 "hops": [list(a.mask.shape) for a in ds.adjs],
                                 "temporal_hops": [list(a.mask.shape) for a in tds.adjs],
                                 "checked": "bit-equal (K1, K2, K4b, K7, K8), K4 within 1e-5"}))
    torch.cuda.synchronize()
    return counts


def weighted_train_phase(wtopo, resident, labels, train_idx, seed):
    """Path (a): TRAIN_STEPS steps of the weighted sampler on the tile
    layout and WEIGHTED_FLAT_STEPS on the flat one (sample_dense +
    lookup_padded, K7 in place of K1); returns the launches of each leg."""
    dev = labels.device
    port_names = port_kernel_names()
    out = {}
    for layout, steps, profile in (("tiled", TRAIN_STEPS, True),
                                   ("flat", WEIGHTED_FLAT_STEPS, False)):
        sampler = GraphSageSampler(wtopo, SIZES, device=dev, seed=seed + 5, weighted=True,
                                   max_deg=MAX_DEG, layout=layout)

        def inputs(s, sampler=sampler):
            ds = sampler.sample_dense(s)
            return ds, resident.lookup_padded(ds.n_id)

        out[layout], _ = train_leg(
            f"weighted {layout} sample_dense+lookup_padded", inputs,
            (f"weighted_sample_{layout}", "local_reindex", "gather_rows", "masked_mean",
             "masked_mean_backward/cols"), labels, train_idx, seed, steps, port_names, profile)
    return out


# -- the model zoo slice: K14, K14b, K14c, bf16 K4/K4b; GCN and GAT training --------

def _rows_of(F):
    """A K14 row of F elements as GAT holds it: [H, D] for the heads, else [F]."""
    return (GAT_HEADS, HIDDEN) if F == GAT_HEADS * HIDDEN else (F,)


def kernel_phase_7(topo, seeds, rows, seed):
    """Hold K14, K14b and K14c against their plain versions at the shapes
    one dedup sample_dense of 1,024 seeds gives GCN and GAT, and K4/K4b's
    bfloat16 variants against their float32 kernels at SAGE's; adds the
    report rows: K14 and K14b the float32 calls at GAT's widths (one GAT
    step's), K14c its three hops."""
    dev = seeds.device
    gen = torch.Generator(device=dev).manual_seed(seed + 70)
    ds = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 70).sample_dense(seeds)
    w_srcs = [int(ds.n_id.shape[0])] + [a.w_dst for a in ds.adjs[:-1]]
    bf16 = torch.bfloat16
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        W, k = adj.mask.shape
        mask, cols = adj.mask, adj.cols
        n_lanes, n_valid = W * k, int(mask.sum())
        src = torch.clamp(cols.long(), 0, w_src - 1)
        distinct = torch.unique(src).numel()
        flat_idx = src.reshape(-1)
        valid_idx = src[mask].contiguous()
        log("kernels-7 hop: " + json.dumps({"layer": layer, "W_dst": W, "k": k, "W_src": w_src,
                                            "valid_lanes": n_valid, "distinct_rows": distinct,
                                            "hub_lanes": int(torch.bincount(valid_idx).max())}))
        # K14c: the out-degree of this hop, as GCN norm="both" counts it
        got = block_out_degree(mask, cols, w_src)
        check(torch.equal(got, block_out_degree_plain(mask, cols, w_src)),
              f"K14c at layer {layer} differs from its plain version")
        # yardstick: index_add_ of the mask; the sampler's cols all lie in [0, W_src),
        # so clipping drops nothing
        check(bool(((cols >= 0) & (cols < w_src)).all()), "a sampled col lies outside the source")
        ones = mask.reshape(-1).to(torch.float32)
        record(rows, "block_out_degree", 0.0,
               time_ms(lambda: block_out_degree(mask, cols, w_src)),
               time_ms(lambda: block_out_degree_plain(mask, cols, w_src), reps=5),
               bound(n_lanes * 5 + w_src * 4, int_ops=n_valid),
               time_ms(lambda: torch.zeros(w_src, device=dev).index_add_(0, flat_idx, ones)),
               shape=f"layer {layer} W={W} k={k} W_src={w_src}")
        widths = sorted({GCN_WIDTHS[layer], GAT_WIDTHS[layer], 1})
        for F_ in widths:
            for dtype in (torch.float32, bf16):
                if dtype == bf16 and F_ not in (HIDDEN, GAT_HEADS * HIDDEN):
                    continue
                es = 4 if dtype == torch.float32 else 2
                tag = f"layer {layer} W={W} k={k} W_src={w_src} F={F_} {str(dtype)[6:]}"
                report = dtype == torch.float32 and F_ == GAT_WIDTHS[layer]
                x32 = torch.randn((w_src,) + _rows_of(F_), generator=gen, device=dev)
                x = x32.to(dtype)
                del x32
                # K14: a copy, bit-equal to its plain version
                got = gather_src_rows(x, cols)
                check(torch.equal(got, gather_src_plain(x, cols)),
                      f"K14 differs from its plain version at {tag}")
                del got
                flat = x.reshape(w_src, -1)
                record(rows, "gather_src", 0.0, time_ms(lambda: gather_src_rows(x, cols)),
                       time_ms(lambda: gather_src_plain(x, cols), reps=5),
                       bound(n_lanes * 4 + distinct * F_ * es + n_lanes * F_ * es),
                       time_ms(lambda: torch.index_select(flat, 0, flat_idx)), shape=tag,
                       report=report)
                del flat
                backward = (F_ == GCN_WIDTHS[layer] and layer > 0) or F_ == GAT_WIDTHS[layer]
                if not backward:  # no gradient reaches this source (the input features, F = 1)
                    del x
                    continue
                # K14b: run twice bit-equal, and against the plain version on a
                # CPU copy (the valid lanes added in lane order, as the kernel does)
                g = torch.randn((W, k) + _rows_of(F_), generator=gen, device=dev).to(dtype)
                got = gather_src_backward(g, mask, cols, w_src)
                again = gather_src_backward(g, mask, cols, w_src)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"K14b: two runs differ at {tag}")
                cpu = gather_src_backward_plain(g.cpu(), mask.cpu(), cols.cpu(), w_src)
                err = float((got.cpu().float() - cpu.float()).abs().max())
                scale = float(cpu.float().abs().max())
                check(err <= K14B_CPU_BAR[dtype] * scale,
                      f"K14b differs from its plain version by {err} (scale {scale}) at {tag}")
                del again, cpu
                if dtype == bf16:  # the float32 kernel on the same values, rounded once
                    ref = gather_src_backward(g.float(), mask, cols, w_src).to(bf16)
                    check(torch.equal(got, ref),
                          f"K14b bf16 is not the float32 sum rounded at {tag}")
                    del ref
                del got
                contrib = g.reshape(n_lanes, -1)[mask.reshape(-1)].contiguous()
                record(rows, "gather_src_backward", err,
                       time_ms(lambda: gather_src_backward(g, mask, cols, w_src)),
                       time_ms(lambda: gather_src_backward_plain(g, mask, cols, w_src), reps=5),
                       bound(n_lanes * 5 + n_valid * F_ * es + w_src * F_ * es,
                             f32_adds=n_valid * F_),
                       time_ms(lambda: torch.zeros((w_src, contrib.shape[1]), dtype=dtype,
                                                   device=dev).index_add_(0, valid_idx, contrib)),
                       shape=tag, report=report)
                del g, contrib, x
        torch.cuda.empty_cache()

    # K4 and K4b in bfloat16 at SAGE's shapes (D = 100 on the features, 256 after),
    # against the float32 kernels on the same values rounded once; logged only
    for layer, (adj, w_src) in enumerate(zip(ds.adjs, w_srcs)):
        W, k = adj.mask.shape
        D = DIM if layer == 0 else HIDDEN
        src = torch.clamp(adj.cols.long(), 0, w_src - 1)
        lanes = int(adj.mask.sum())
        x = torch.randn((w_src, D), generator=gen, device=dev).to(bf16)
        got = masked_mean_aggregate(x, adj)
        check(torch.equal(got, masked_mean_aggregate(x.float(), adj).to(bf16)),
              f"K4 bf16 is not the float32 mean rounded at layer {layer}")
        check(torch.equal(got, masked_mean_aggregate(x, adj)),
              f"K4 bf16 at layer {layer}: two runs differ")
        cnt = torch.clamp(adj.mask.sum(dim=1, keepdim=True), min=1)
        bag = dict(input=src.reshape(-1), weight=x, mode="sum",
                   offsets=torch.arange(0, W * k, k, device=dev),
                   per_sample_weights=(adj.mask.float() / cnt).reshape(-1).to(bf16))
        b = bound(W * k * 5 + torch.unique(src[adj.mask]).numel() * D * 2 + W * D * 2,
                  f32_adds=lanes * D + W * D)
        k4 = k4_times(time_ms(lambda: masked_mean_aggregate(x, adj)),
                      time_ms(lambda: F.embedding_bag(**bag)), b,
                      lambda: masked_mean_aggregate(x, adj), lambda: F.embedding_bag(**bag))
        REDESIGN.setdefault("K4 bf16 hops", []).append(k4)
        record(rows, "masked_mean", 0.0, k4["ms"],
               time_ms(lambda: masked_mean_aggregate_plain(x, adj), reps=5), b,
               k4["embedding_bag_ms"],
               shape=f"bf16 layer {layer} W={W} k={k} D={D}", report=False)
        if layer == 0:  # the features take no gradient
            continue
        g = torch.randn((W, HIDDEN), generator=gen, device=dev).to(bf16)
        got = masked_mean_backward(g, adj.mask, adj.cols, w_src)
        check(torch.equal(got, masked_mean_backward(g.float(), adj.mask, adj.cols,
                                                    w_src).to(bf16)),
              f"K4b bf16 is not the float32 gradient rounded at layer {layer}")
        contrib = ((g.float() / cnt)[:, None, :].expand(W, k, HIDDEN)[adj.mask]).to(bf16)
        idx = src[adj.mask].contiguous()
        record(rows, "masked_mean_backward", 0.0,
               time_ms(lambda: masked_mean_backward(g, adj.mask, adj.cols, w_src)),
               time_ms(lambda: masked_mean_backward_plain(g, adj.mask, adj.cols, w_src), reps=5),
               bound(W * k * 5 + W * HIDDEN * 2 + w_src * HIDDEN * 2, f32_adds=2 * lanes * HIDDEN),
               time_ms(lambda: torch.zeros((w_src, HIDDEN), dtype=bf16, device=dev).index_add_(
                   0, idx, contrib)),
               shape=f"bf16 cols layer {layer} W={W} k={k} D={HIDDEN} W_src={w_src}",
               report=False)
    torch.cuda.synchronize()


def zoo_phase(topo, resident, labels, train_idx, seed):
    """Path (c): TRAIN_STEPS Adam steps at batch 1024 of sample_dense +
    lookup_padded on each model of the zoo at products width, as the train
    legs above; returns the launches summed over the legs."""
    dev = labels.device
    port_names = port_kernel_names()
    bf16 = torch.bfloat16
    f32_zoo = ("gather_src/float32", "gather_src_backward/float32")
    bf16_zoo = ("gather_src/bfloat16", "gather_src_backward/bfloat16")
    legs = (
        ("gcn right", lambda: GCN(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5), f32_zoo),
        ("gcn both", lambda: GCN(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5, norm="both"),
         f32_zoo + ("block_out_degree",)),
        ("gat", lambda: GAT(DIM, HIDDEN, CLASSES, heads=GAT_HEADS, num_layers=3, dropout=0.5),
         f32_zoo),
        ("gcn right bf16", lambda: GCN(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5,
                                       dtype=bf16), bf16_zoo),
        ("gat bf16", lambda: GAT(DIM, HIDDEN, CLASSES, heads=GAT_HEADS, num_layers=3,
                                 dropout=0.5, dtype=bf16), bf16_zoo),
        ("sage bf16", lambda: GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=3, dropout=0.5,
                                        dtype=bf16),
         ("masked_mean/bfloat16", "masked_mean_backward/bfloat16")),
    )
    total = {}
    for leg, make, needs in legs:
        sampler = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 5)

        def inputs(s, sampler=sampler):
            ds = sampler.sample_dense(s)
            return ds, resident.lookup_padded(ds.n_id)

        counts, _ = train_leg(f"{leg} sample_dense+lookup_padded", inputs,
                              ("sample_tiled", "local_reindex", "gather_rows") + needs, labels,
                              train_idx, seed, TRAIN_STEPS, port_names, make_model=make,
                              tag="zoo")
        if leg == "sage bf16":
            check(counts["gather_src"] == 0, "the SAGE leg launched K14")
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        torch.cuda.empty_cache()
    return total


def weighted_inputs(topo, seed):
    """Per-edge weights uniform in [0, 1) with ZERO_WEIGHT_FRAC of them 0
    and timestamps uniform in [0, TS_SPAN), float32, from the seed:
    ``(weighted CSRTopo over the same arrays, timestamps)``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 20)
    e = topo.edge_count
    w = rng.random(e, dtype=np.float32)
    w[rng.random(e) < ZERO_WEIGHT_FRAC] = 0.0
    ts = rng.uniform(0.0, TS_SPAN, e).astype(np.float32)
    wtopo = CSRTopo(indptr=topo.indptr, indices=topo.indices, edge_weights=w)
    log(f"weights and timestamps: {e} edges, {int((w == 0).sum())} zero weights, "
        f"made in {time.perf_counter() - t0:.1f} s")
    return wtopo, ts


def temporal_serve_phase(topo, tg, model, params, table, trace, seed):
    """Path (b): the recency weight tiles (K8w) and the t = +inf pin over
    them, warmup, then the temporal trace's requests with their query
    times from 4 client threads; replay and engine pins after. Returns the
    launches of the served run and K8w's launches building the tiles (the
    engine itself never builds them: K8 weighs each lane in place)."""
    dev = table.device
    requests = trace.requests.shape[0]

    def sampler(recency=RECENCY):
        s = GraphSageSampler(topo, SIZES, device=dev, seed=seed, dedup=False, max_deg=MAX_DEG)
        return s.bind_temporal(tg, recency=recency)

    engine = TemporalServeEngine(model, params, sampler(), table,
                                 ServeConfig(max_batch=BATCH, record_dispatches=True),
                                 t_quantum=T_QUANTUM)
    _kernels.reset_counts()
    wt = tg.recency_wtiles(RECENCY)  # the frozen graph's weights: K8w
    k8w_launches = _kernels.counts()["recency_weights"]
    check(k8w_launches > 0, "K8w never launched building the recency weight tiles")
    bd, tiles, ttiles = tg.temporal_graph()
    s64 = torch.from_numpy(trace.requests[:BATCH].astype(np.int32)).to(dev)
    ones = torch.ones(BATCH, dtype=torch.bool, device=dev)
    key = qrandom.key(seed + 32)
    a = sample.tiled_temporal_sample_layer(bd, tiles, ttiles, s64, ones, SIZES[0], key,
                                           torch.full((BATCH,), float("inf"), device=dev),
                                           MAX_DEG, RECENCY)
    b = sample.tiled_weighted_sample_layer(bd, tiles, wt, s64, ones, SIZES[0], key, MAX_DEG)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), "temporal at t=+inf != weighted")
    warm = engine.warmup()
    log(f"temporal warmup: {json.dumps({str(k): round(v, 4) for k, v in warm.items()})}")
    engine.reset_stats()
    _kernels.reset_counts()
    served, wall = serve_phase(engine, trace.requests, clients=4, t=trace.t_query)
    counts = _kernels.counts()
    st = engine.stats
    check(st.requests == requests, "not every temporal request was answered")
    out = np.stack(list(served.values()))
    check(out.shape[1] == CLASSES and np.isfinite(out).all(), "temporal logits malformed")
    log("temporal serve: " + json.dumps({
        "requests": st.requests, "wall_s": wall, "qps": st.requests / wall,
        "latency": st.latency.snapshot(), "cache_hit_rate": st.cache.hit_rate,
        "coalesced": st.coalesced, "dispatches": st.dispatches,
        "dispatched_seeds": st.dispatched_seeds, "distinct_keys": len(served),
        "t_query_span": [float(trace.t_query[0]), float(trace.t_query[-1])],
        "launches": {k: v for k, v in counts.items() if v}}))
    for name in ("temporal_sample_tiled", "gather_rows", "masked_mean"):
        check(counts[name] > 0, f"kernel {name} never launched on the temporal path")

    # replay: 8 dispatches on the card bit-equal, 2 on the CPU plain path within 1e-3
    def replay_worst(log_entries, s, feat, device):
        oracle = replay_temporal_log(log_entries, model, params, s, feat)
        worst, seen = 0.0, 0
        for key_, cands in oracle.items():
            row = served.get(key_)
            if row is not None:
                seen += 1
                worst = max(worst, min(float(np.abs(row - c).max()) for c in cands))
        check(seen > 0, f"no served row among the replayed keys on {device}")
        return worst

    dev_worst = replay_worst(engine.dispatch_log[:8], sampler(), table, dev)
    check(dev_worst == 0.0, f"temporal replay on the card differs by {dev_worst}")
    cpu_topo = CSRTopo(indptr=topo.indptr, indices=topo.indices)  # its own tile cache
    cpu_tg = TemporalTiledGraph(cpu_topo, tg.edge_ts, device="cpu")
    cpu_s = GraphSageSampler(cpu_topo, SIZES, device="cpu", seed=seed, dedup=False,
                             max_deg=MAX_DEG)
    cpu_s.bind_temporal(cpu_tg, recency=RECENCY)
    cpu_worst = replay_worst(engine.dispatch_log[:2], cpu_s, table.cpu(), "cpu")
    check(cpu_worst <= 1e-3, f"temporal replay on the CPU differs by {cpu_worst}")
    log(f"temporal replay: 8 dispatches on the card max |diff| {dev_worst} (bit-equal); "
        f"2 on the CPU plain path max |diff| {cpu_worst:.3g}")
    del cpu_tg, cpu_s, cpu_topo

    # the serving-grain pin: recency 0, t = +inf against a plain engine over unit weights
    unit = CSRTopo(indptr=topo.indptr, indices=topo.indices,
                   edge_weights=np.ones(topo.edge_count, np.float32))
    tile_build("unit-weight graph's ids and weights",
               lambda: (unit.to_device_tiled(dev), unit.to_device_tiled_weights(dev)))
    plain_eng = ServeEngine(model, params, GraphSageSampler(unit, SIZES, device=dev, seed=seed,
                                                            dedup=False, weighted=True,
                                                            max_deg=MAX_DEG),
                            table, ServeConfig(max_batch=BATCH, record_dispatches=True))
    temp_eng = TemporalServeEngine(model, params, sampler(0.0), table,
                                   ServeConfig(max_batch=BATCH, record_dispatches=True),
                                   t_quantum=0.0)
    nodes = trace.requests[:BATCH]
    rows_w, rows_t = plain_eng.predict(nodes, timeout=120), temp_eng.predict(nodes, timeout=120)
    check(np.array_equal(rows_w, rows_t), "temporal engine at t=+inf != plain weighted engine")
    check(all(np.array_equal(pw, pt) and nw == nt for (pw, nw), (pt, nt, _) in
              zip(plain_eng.dispatch_log, temp_eng.dispatch_log)), "pin dispatch logs differ")
    log(f"temporal pin: {len(nodes)} nodes at t=+inf, recency 0, bit-equal to the plain "
        "engine over unit weights")
    del plain_eng, temp_eng, unit

    # link prediction: lp_trace pairs through predict_pairs
    lp = lp_trace(topo, LP_PAIRS, seed=seed + 33, qps=TEMPORAL_QPS)
    before = engine.stats.coalesced
    scores = engine.predict_pairs(np.stack([lp.u, lp.v], axis=1), t=lp.t_query, timeout=120)
    check(scores.shape == (LP_PAIRS,) and np.isfinite(scores).all(), "pair scores malformed")
    log("temporal pairs: " + json.dumps({
        "pairs": LP_PAIRS, "positives": int(lp.label.sum()),
        "endpoints_coalesced": engine.stats.coalesced - before,
        "mean_score_pos": float(scores[lp.label == 1].mean()),
        "mean_score_neg": float(scores[lp.label == 0].mean())}))
    return counts, k8w_launches


# -- the tile slice: K12, wide fanouts, caps --------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def kernel_phase_6(topo, wtopo, ts_np, seeds, rows):
    """Hold K12 against its plain version and the host build on the id,
    weight and timestamp tables at full size, and across the int32 edge
    offset boundary; K1/K1b at the wide fanouts against their plain
    versions. Times each; adds K12's id-table row to ``rows``."""
    dev = seeds.device
    E = topo.edge_count
    # to_device_tiled's path against the host build it replaced, for the id table
    fresh = CSRTopo(indptr=topo.indptr, indices=topo.indices)
    t0 = time.perf_counter()
    fresh.tile_map()
    map_s = time.perf_counter() - t0
    before = _kernels.counts()["build_tiles"]
    t0 = time.perf_counter()
    card_ids = fresh.to_device_tiled(dev)[1]
    torch.cuda.synchronize()
    card_s = map_s + time.perf_counter() - t0
    check(_kernels.counts()["build_tiles"] == before + 1, "the id table was not built by K12")
    t0 = time.perf_counter()
    _, host_ids = sample.build_tiled_host(topo.indptr, topo.indices, np.int32)
    host_dev = torch.from_numpy(host_ids).to(dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(torch.equal(card_ids, host_dev), "K12's id table differs from build_tiled_host's")
    log("kernels-6 build: " + json.dumps({"table": "ids", "M": int(card_ids.shape[0]), "E": E,
                                          "host_build_and_copy_s": host_s,
                                          "rowmap_s": map_s, "rowmap_and_k12_s": card_s}))
    del fresh, card_ids, host_dev, host_ids

    _, start, width = topo.tile_map()
    rs, rw = torch.from_numpy(start).to(dev), torch.from_numpy(width).to(dev)
    M = rs.shape[0]
    lanes = torch.arange(sample.LANE, device=dev)
    for what, host_src in (("ids", topo.indices.astype(np.int32)),
                           ("weights", wtopo.edge_weights), ("timestamps", ts_np)):
        src = torch.from_numpy(host_src).to(dev)
        got = sample.build_tiled_device(src, rs, rw)
        check(torch.equal(_bits(got), _bits(sample.build_tiled_device_plain(src, rs, rw))),
              f"K12 on the {what} differs from its plain version")
        t0 = time.perf_counter()
        host = sample.build_tiled_host(topo.indptr, host_src, host_src.dtype)[1]
        host_s = time.perf_counter() - t0
        check(torch.equal(_bits(got), _bits(torch.from_numpy(host).to(dev))),
              f"K12 on the {what} differs from build_tiled_host's table")
        del host, got
        idx = torch.clamp(rs[:, None] + lanes[None, :], 0, E - 1)  # the yardstick's lanes
        record(rows, "build_tiles", 0.0, time_ms(lambda: sample.build_tiled_device(src, rs, rw)),
               time_ms(lambda: sample.build_tiled_device_plain(src, rs, rw), reps=3),
               bound(E * 4 + M * 12 + M * sample.LANE * 4),
               time_ms(lambda: torch.take(src, idx)), shape=f"{what} M={M} E={E}",
               report=what == "ids")
        log(f"kernels-6 {what}: host build_tiled_host {host_s:.3f} s (no copy)")
        del idx, src

    # edge offsets past 2^31: an int32 source of BOUNDARY_WORDS words
    big = torch.zeros(BOUNDARY_WORDS, dtype=torch.int32, device=dev)
    tail = torch.arange(1, 4097, dtype=torch.int32, device=dev)
    big[-4096:] = tail
    s0 = BOUNDARY_WORDS - 4096
    starts = [s0 + 128 * i for i in range(32)] + [2**31 - 64, BOUNDARY_WORDS - 50, 0, s0]
    widths = [128] * 32 + [128, 128, 128, 0]
    bs = torch.tensor(starts, dtype=torch.int64, device=dev)
    bw = torch.tensor(widths, dtype=torch.int32, device=dev)
    got = sample.build_tiled_device(big, bs, bw)
    check(torch.equal(got, sample.build_tiled_device_plain(big, bs, bw)),
          "K12 differs from its plain version past 2^31")
    check(torch.equal(got[:32].reshape(-1), tail) and not got[-1].any(),
          "K12 past 2^31 misplaces the tail")
    log(f"kernels-6 boundary: {BOUNDARY_WORDS} int32 words, {len(starts)} rows "
        f"(starts {min(starts)} to {max(starts)}), bit-equal to the plain version")
    del big, tail, got

    # K1 / K1b at the wide fanouts (shared-memory tables) over one train batch
    g_tiled, g_flat = topo.to_device_tiled(dev), topo.to_device(dev)
    valid = torch.ones_like(seeds, dtype=torch.bool)
    for k in WIDE_FANOUTS:
        key = qrandom.fold_in(qrandom.key(4321), k)
        b = sample_bound(g_flat[0], seeds, valid, k)
        draws = []
        for name, g, fn, plain in (
            ("sample_tiled", g_tiled, sample.tiled_sample_layer, sample.tiled_sample_layer_plain),
            ("sample_flat", g_flat, sample.sample_layer, sample.sample_layer_plain),
        ):
            got, want = fn(*g, seeds, valid, k, key), plain(*g, seeds, valid, k, key)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"{name} at k={k} differs from its plain version")
            draws.append(got)
            record(rows, name, 0.0, time_ms(lambda: fn(*g, seeds, valid, k, key)),
                   time_ms(lambda: plain(*g, seeds, valid, k, key), reps=3), b,
                   shape=f"W={seeds.shape[0]} k={k}", report=False)
        (tn, tv), (fn_, fv) = draws
        check(torch.equal(tv, fv) and torch.equal(tn[tv], fn_[fv]),
              f"tiled and flat draws differ at k={k}")
    torch.cuda.synchronize()


def caps_phase(topo, resident, labels, train_idx, seed):
    """bench.py's capped path on the products graph: calibrate_caps over
    CAP_PROBES probe batches (margin 1.1, granule 2048), then train leg 1
    uncapped and capped on the same draws, then an auto_grow_caps sampler
    from tight caps, then one sample() against dense_to_pyg of the same
    draw."""
    dev = labels.device
    B = TRAIN_BATCH
    order = np.random.default_rng(seed + 40).permutation(train_idx)  # another shuffle
    probes = order[:CAP_PROBES * B].reshape(CAP_PROBES, B)
    cal = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 41)
    twin = copy.copy(cal)  # the same key stream: its probe counts are calibrate_caps's own
    t0 = time.perf_counter()
    caps = cal.calibrate_caps(probes, margin=CAP_MARGIN, granule=CAP_GRANULE)
    cal_s = time.perf_counter() - t0
    graph, bind, _ = twin.fused_sample_spec()
    counts = probe_hop_counts(None, None, twin.next_key(), twin.as_seeds(probes), SIZES,
                              sample_fn=bind(graph))
    check(caps == caps_from_counts(counts, B, SIZES, CAP_MARGIN, CAP_GRANULE),
          "calibrate_caps differs from caps_from_counts of its own probe")
    log("caps: " + json.dumps({"caps": caps, "probe_max": counts.max(axis=0).tolist(),
                               "probe_mean": counts.mean(axis=0).tolist(),
                               "uncapped_widths": sample.pad_widths(B, SIZES)[1:],
                               "probes": CAP_PROBES, "batch": B, "margin": CAP_MARGIN,
                               "granule": CAP_GRANULE, "calibrate_s": cal_s}))
    k2_train_hops(topo, torch.from_numpy(train_idx[:B].astype(np.int32)).to(dev), caps, seed)

    # train leg 1 uncapped, then capped: one seed, so both draw alike while nothing overflows
    port_names = port_kernel_names()
    overflow, widths = [], []
    legs = {}
    for name, caps_ in (("uncapped", None), ("capped", caps)):
        s = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 5, caps=caps_)
        overflow.clear()

        def inputs(seeds, s=s):
            ds = s.sample_dense(seeds)
            overflow.append(ds.cap_overflow)
            widths.append(ds.n_id.shape[0])
            return ds, resident.lookup_padded(ds.n_id)

        _, summary = train_leg(
            f"caps {name} sample_dense+lookup_padded", inputs,
            ("sample_tiled", "local_reindex", "gather_rows", "masked_mean",
             "masked_mean_backward/cols"), labels, train_idx, seed, TRAIN_STEPS, port_names)
        legs[name] = dict(summary, n_id_width=widths[-1],
                          cap_overflow=int(torch.stack(overflow).sum()))
    check(legs["capped"]["cap_overflow"] == 0, "the capped leg dropped nodes")
    log("caps legs: " + json.dumps({
        name: {k: leg[k] for k in ("step_ms", "seps", "loss_first", "loss_last", "n_id_width",
                                   "cap_overflow", "device_idle_share")}
        for name, leg in legs.items()}))

    # the overflow ladder from tight caps: the exact maxima of 2 probe batches
    tight = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 42, auto_grow_caps=True)
    tight_caps = tight.calibrate_caps(probes[:2], margin=1.0, granule=1)
    tight.cap_margin, tight.cap_granule = CAP_MARGIN, CAP_GRANULE  # regrowth: bench.py's policy
    grow = order[CAP_PROBES * B:(CAP_PROBES + CAP_GROW_BATCHES) * B].reshape(-1, B)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a spent ladder fails the phase
        dropped = [int(tight.sample_dense(b).cap_overflow) for b in grow]
    grow_s = time.perf_counter() - t0
    check(not any(dropped), f"auto_grow_caps left nodes dropped: {dropped}")
    check(tight.cap_regrows > 0, "the tight caps never overflowed: the ladder went unused")
    log("caps auto-grow: " + json.dumps({"tight_caps": tight_caps, "grown_caps": tight.caps,
                                         "regrows": tight.cap_regrows,
                                         "batches": len(grow), "cap_overflow": dropped,
                                         "seconds": grow_s}))

    # the ragged surface: sample() == dense_to_pyg of the same draw
    a = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 43, caps=caps)
    b = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 43, caps=caps)
    n_a, bs_a, adjs_a = a.sample(grow[0])
    n_b, bs_b, adjs_b = dense_to_pyg(b.sample_dense(grow[0]))
    check(bs_a == bs_b == B and torch.equal(n_a, n_b) and len(adjs_a) == len(adjs_b)
          and all(x.size == y.size and torch.equal(x.edge_index, y.edge_index)
                  for x, y in zip(adjs_a, adjs_b)), "sample() differs from dense_to_pyg")
    times = []
    for batch in grow[1:6]:
        t0 = time.perf_counter()
        a.sample(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    log("caps sample(): " + json.dumps({"n_id": int(n_a.shape[0]),
                                        "edges": [int(x.edge_index.shape[1]) for x in adjs_a],
                                        "sizes": [x.size for x in adjs_a],
                                        "ms": median_min_max(times)}))


# -- the multi-device slice: K13a, K13b, K9c and the (dp, ici) train legs -------------

def mc_setup(topo, table, train_idx, seed):
    """The slice's shared state: 4 rank threads (dp 2 x ici 2) on the card,
    the table's ici stripes (one tensor a stripe: the two ranks of a dp pair
    only read it), each ici shard's flat and tiled graph block (built once a
    shard, K12 building the tiled ones on the card) and leg (a)'s caps from
    calibrate_caps over MC_CAP_PROBES batches."""
    dev = table.device
    meshes = local_meshes(MC_RANKS, dp=MC_DP, device=dev, timeout_s=600)
    ici = meshes[0].ici
    by_ici = [next(m for m in meshes if m.ici_idx == p) for p in range(ici)]
    stripes = [stripe_rows(table, ici, p) for p in range(ici)]
    t0 = time.perf_counter()
    blocks = {"flat": [shard_topology_rows(m, topo, layout="flat") for m in by_ici]}
    blocks["tiled"] = tile_build("sharded ids (ici shards)", lambda: [
        shard_topology_rows(m, topo, layout="tiled") for m in by_ici])
    build_s = time.perf_counter() - t0
    order = np.random.default_rng(seed + 80).permutation(train_idx)
    probes = order[-MC_CAP_PROBES * TRAIN_BATCH:].reshape(MC_CAP_PROBES, TRAIN_BATCH)
    caps = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 81).calibrate_caps(
        probes, margin=CAP_MARGIN, granule=CAP_GRANULE)
    row_start = blocks["flat"][0].row_start
    log("mc setup: " + json.dumps({
        "mesh": meshes[0].shape, "ranks": len(meshes), "row_start": row_start.tolist(),
        "stripe_rows": int(stripes[0].shape[0]),
        "flat_block_edges": [int(b.indices.shape[0]) for b in blocks["flat"]],
        "tiled_block_rows": [int(b.tiles.shape[0]) for b in blocks["tiled"]],
        "graph_edges": int(topo.edge_count), "blocks_s": build_s, "caps": caps}))
    return dict(meshes=meshes, stripes=stripes, blocks=blocks, caps=caps, order=order)


def dedup_lanes(topo, table, caps, seeds, key):
    """One calibrated dedup batch through the single-device pipeline: each
    hop's (cur, cur_valid, k, key) and the ids its feature gather takes."""
    g = topo.to_device(table.device)
    hops = []

    def recording(cur, cur_valid, k, sub):
        hops.append((cur, cur_valid, k, sub))
        return sample.sample_layer(*g, cur, cur_valid, k, sub)

    ds, _ = sample_and_gather_dedup(None, None, table, key, seeds, SIZES, caps,
                                    sample_fn=recording)
    return hops, ds.n_id.contiguous()


def sharded_sample_bound(indptr, cur, cur_valid, k, start, end):
    """K13b's least time for one shard and hop: K1's (`sample_bound`) over
    the rows the shard owns, with int32 flags written (3 bytes a lane more)."""
    own = cur_valid & (cur >= start) & (cur < end)
    t, by = sample_bound(indptr, cur, own, k)
    extra = cur.shape[0] * k * 3 / HBM_BYTES_PER_S * 1e3
    return (t + extra, by) if by == "bytes" else (t, by)


def kernel_phase_8(topo, table, mc, seeds, rows, seed):
    """Hold K13a, K13b and K9c against their plain versions on one
    calibrated dedup batch's lanes (timed), and K13a and K13b also on the
    same batch uncapped, the widths legs (b) and (c) run: K13a over the
    table's ici stripes in float32 (the report row: one shard's call) and
    bfloat16, the stripes' partials summing to the rows; K9c's decode of the
    summed int8 rows, equal to K9a on the whole payload, then
    sharded_dequant_gather on the four rank threads (its launches); K13b
    flat and tiled per hop and shard, the shards' sum equal to unsharded
    K1b/K1. Then gloo's all-reduce alone.
    Returns K9c's launches."""
    dev = table.device
    ici = mc["meshes"][0].ici
    N = topo.node_count
    key = qrandom.fold_in(qrandom.key(seed + 82), 0)
    # the calibrated lanes are timed; the uncapped ones are the widths legs (b)
    # and (c) launch K13a and K13b at, and are only held against the plain versions
    lanes = {"calibrated": dedup_lanes(topo, table, mc["caps"], seeds, key),
             "uncapped": dedup_lanes(topo, table, None, seeds, key)}
    hops, ids = lanes["calibrated"]
    W = ids.shape[0]
    inr = (ids >= 0) & (ids < N)
    R = mc["stripes"][0].shape[0]
    log("kernels-8 lanes: " + json.dumps({
        tag: {"gather_ids": int(i.shape[0]), "in_range": int(((i >= 0) & (i < N)).sum()),
              "hops": [[int(h[0].shape[0]), h[2]] for h in hs]}
        for tag, (hs, i) in lanes.items()}))

    # K13a over float32 and bfloat16 stripes
    for dtype in (torch.float32, torch.bfloat16):
        full = table if dtype == torch.float32 else table.to(dtype)
        stripes = mc["stripes"] if dtype == torch.float32 else [stripe_rows(full, ici, p)
                                                                 for p in range(ici)]
        es = full.element_size()
        for tag, (_, lids) in lanes.items():
            lw, linr = lids.shape[0], (lids >= 0) & (lids < N)
            total = None
            for p in range(ici):
                got = partial_rows(stripes[p], lids, p)
                check(torch.equal(got, partial_rows_plain(stripes[p], lids, p)),
                      f"K13a {dtype} shard {p} ({tag} lanes) differs from its plain version")
                total = got if total is None else total + got
                if tag != "calibrated":
                    continue
                own = (lids >= p * R) & (lids < (p + 1) * R)
                local = torch.clamp(lids.long() - p * R, 0, R - 1)
                record(rows, "sharded_rows", 0.0, time_ms(lambda: partial_rows(stripes[p], lids, p)),
                       time_ms(lambda: partial_rows_plain(stripes[p], lids, p), reps=5),
                       bound(lw * 4 + torch.unique(lids[own]).numel() * DIM * es + lw * DIM * es),
                       time_ms(lambda: torch.index_select(stripes[p], 0, local)),
                       shape=f"shard {p} of {ici} W={lw} D={DIM} {str(dtype)[6:]}",
                       report=dtype == torch.float32 and p == 0)
            check(torch.equal(total[linr], full[lids[linr].long()]) and not total[~linr].any(),
                  f"K13a {dtype} ({tag} lanes): the shards' partials do not sum to the rows")
            del total, got
        del full, stripes
    torch.cuda.empty_cache()

    # K9c: the int8 payload striped; the decode of the summed rows
    codec = get_codec("int8")
    enc = codec.encode(table.cpu().numpy())
    payload = torch.from_numpy(enc.payload).to(dev)
    scale, zero = (torch.from_numpy(a).to(dev) for a in (enc.scale, enc.zero))
    del enc
    pstripes = [stripe_rows(payload, ici, p) for p in range(ici)]
    q = partial_rows(pstripes[0], ids, 0)
    for p in range(1, ici):
        q += partial_rows(pstripes[p], ids, p)
    got = sharded_dequant(codec, q, ids, scale, zero)
    check(torch.equal(got, sharded_dequant_plain(codec, q, ids, scale, zero)),
          "K9c differs from its plain version")
    k9a = gather_dequant(codec, payload, ids, scale, zero)
    check(torch.equal(got[inr], k9a[inr]) and not got[~inr].any(),
          "K9c differs from K9a on the whole payload")
    record(rows, "sharded_dequant", 0.0, time_ms(lambda: sharded_dequant(codec, q, ids, scale, zero)),
           time_ms(lambda: sharded_dequant_plain(codec, q, ids, scale, zero), reps=5),
           bound(W * DIM + W * 4 + W * 8 + W * DIM * 4), None, shape=f"int8 W={W} D={DIM}")
    record(rows, "sharded_rows", 0.0, time_ms(lambda: partial_rows(pstripes[0], ids, 0)),
           time_ms(lambda: partial_rows_plain(pstripes[0], ids, 0), reps=5),
           bound(W * 4 + W * DIM * 2), None, shape=f"int8 pack shard 0 W={W}", report=False)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    outs = run_ranks(lambda m: sharded_dequant_gather(codec, pstripes[m.ici_idx], ids, m, "ici",
                                                      scale, zero), mc["meshes"])
    k9c_counts = _kernels.counts()
    check(all(torch.equal(o, got) for o in outs),
          "sharded_dequant_gather on the rank threads differs from the decode")
    check(k9c_counts["sharded_dequant/int8"] > 0 and k9c_counts["sharded_rows/int8"] > 0,
          "K9c or its int8 pack never launched on the rank threads")
    log("kernels-8 K9c ranks: " + json.dumps({k: v for k, v in k9c_counts.items() if v}))
    del q, got, k9a, outs, payload, pstripes, scale, zero

    # K13b: flat and tiled, per hop and shard; the shards' sum is the unsharded draw
    indptr_dev = torch.from_numpy(topo.indptr).to(dev)
    row_start = mc["blocks"]["flat"][0].row_start
    for layout in ("flat", "tiled"):
        if layout == "flat":
            fn, plain = sample_layer_partial, sample_layer_partial_plain
            ref_fn, g = sample.sample_layer, topo.to_device(dev)
            blk = [(b.indptr, b.indices) for b in mc["blocks"]["flat"]]
        else:
            fn, plain = tiled_sample_layer_partial, tiled_sample_layer_partial_plain
            ref_fn, g = sample.tiled_sample_layer, topo.to_device_tiled(dev)
            blk = [(b.bd, b.tiles) for b in mc["blocks"]["tiled"]]
        for tag, (lhops, _) in lanes.items():
            for l, (cur, cv, k, sub) in enumerate(lhops):
                ref_n, ref_v = ref_fn(*g, cur, cv, k, sub)
                n_sum = v_sum = None
                for p in range(ici):
                    start, end = int(row_start[p]), int(row_start[p + 1])
                    args = (*blk[p], start, end, cur, cv, k, sub)
                    got_n, got_v = fn(*args)
                    want_n, want_v = plain(*args)
                    check(torch.equal(got_n, want_n) and torch.equal(got_v, want_v),
                          f"K13b {layout} hop {l} shard {p} ({tag} lanes) differs from its "
                          "plain version")
                    n_sum = got_n if n_sum is None else n_sum + got_n
                    v_sum = got_v if v_sum is None else v_sum + got_v
                    if tag == "calibrated":
                        record(rows, "sharded_sample_" + layout, 0.0, time_ms(lambda: fn(*args)),
                               time_ms(lambda: plain(*args), reps=3),
                               sharded_sample_bound(indptr_dev, cur, cv, k, start, end), None,
                               shape=f"hop {l} W={cur.shape[0]} k={k} shard {p} of {ici}",
                               report=p == 0)
                check(torch.equal(v_sum > 0, ref_v) and int(v_sum.max()) <= 1
                      and torch.equal(n_sum[ref_v], ref_n[ref_v]) and not n_sum[~ref_v].any(),
                      f"K13b {layout} hop {l} ({tag} lanes): the shards' sum is not the "
                      "unsharded draw")
    torch.cuda.synchronize()

    # gloo's all-reduce alone: the sums one dedup step makes, both ici pairs at once
    W2, k_last = hops[-1][0].shape[0], hops[-1][2]
    for what, shape, dtype in (("x rows float32", (W, DIM), torch.float32),
                               ("x rows int8 (K9c)", (W, DIM), torch.int8),
                               ("last hop nbrs int32", (W2, k_last), torch.int32)):
        def rank(m, shape=shape, dtype=dtype):
            x = torch.zeros(shape, dtype=dtype, device=m.device)
            times = []
            for _ in range(4):
                m.stream.synchronize()
                t0 = time.perf_counter()
                allreduce_sum(x, m.ici_group)
                m.stream.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times[1:]))
        ms = run_ranks(rank, mc["meshes"])
        n_bytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        log("kernels-8 gloo: " + json.dumps({
            "sum": what, "bytes": n_bytes, "ms": ms[0], "ms_by_rank": ms,
            "GB_per_s": n_bytes / ms[0] / 1e6, "transport": "gloo, host-staged, one card",
            "group": f"ici pair ({ici} ranks), both pairs at once; not NVLink, not NCCL"}))
    return k9c_counts


class CollectiveClock:
    """Times every collective of the rank threads that opt in (``on()``),
    each between two syncs of the rank's stream: patched over the wrappers
    of ``parallel.collectives`` (``COLLECTIVES``: the all-reduce sum, the
    all-gather, the all-to-all and the all-reduce max), through which every
    exchange of the port goes, for the instrumented steps only. ``on()``
    returns the rank's list of (wrapper, ms)."""

    def __init__(self):
        self.local = threading.local()
        self.orig = {name: getattr(par_collectives, name) for name in par_collectives.COLLECTIVES}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(par_collectives, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(par_collectives, name, fn)

    def on(self):
        self.local.acc = []
        return self.local.acc

    def _timed(self, name, fn):
        def timed(t, group):
            acc = getattr(self.local, "acc", None)
            if acc is None:
                return fn(t, group)
            stream = torch.cuda.current_stream()
            stream.synchronize()
            t0 = time.perf_counter()
            out = fn(t, group)
            stream.synchronize()
            acc.append((name, (time.perf_counter() - t0) * 1e3))
            return out
        return timed


def valid_positions(ds, pipeline):
    """The n_id positions of a sample that are real: the unique frontier's
    prefix and the valid leaves (dedup), or every hop's valid lanes
    (fused); elsewhere a sharded step holds neighbor 0 and a zero row."""
    if pipeline == "dedup":
        leaf = ds.adjs[0]
        w = leaf.mask.shape[0]
        return torch.cat([torch.arange(w, device=leaf.mask.device) < leaf.n_dst,
                          leaf.mask.t().reshape(-1)])
    parts = [torch.ones(ds.batch_size, dtype=torch.bool, device=ds.n_id.device)]
    parts += [a.mask.t().reshape(-1) for a in ds.adjs[::-1]]
    return torch.cat(parts)


def same_sample(ds, x, ref_ds, ref_x, pipeline):
    """Bit-equal on every real lane: n_id, masks, counts, cols and rows."""
    ok = valid_positions(ref_ds, pipeline)
    same = (ds.n_id.shape == ref_ds.n_id.shape and torch.equal(ok, valid_positions(ds, pipeline))
            and torch.equal(ds.n_id[ok], ref_ds.n_id[ok]) and torch.equal(x[ok], ref_x[ok]))
    for a, b in zip(ds.adjs, ref_ds.adjs):
        same = same and torch.equal(a.mask, b.mask) and int(a.n_src) == int(b.n_src)
        if a.cols is not None:
            same = same and torch.equal(a.cols[a.mask], b.cols[b.mask])
    return same


def multichip_phase(topo, table, labels, mc, seed):
    """Three legs of the (dp, ici) train step on the four rank threads at
    full products width, batch 1,024 a dp group: (a) replicated graph,
    dedup, caps from calibrate_caps; (b) row-sharded tiled graph, dedup; (c)
    row-sharded flat graph, fused. A leg: the first step's sample and rows
    against the single-device pipeline, a warm-up step, MC_STEPS timed steps
    (median), MC_COLLECTIVE_STEPS steps with every all-reduce timed apart
    (the collectives' share), the device peak and each rank's resident
    bytes, the byte models; the replicas bit-equal after the leg. Returns
    the launches summed over the legs' runs."""
    dev = table.device
    meshes, ici, dp = mc["meshes"], mc["meshes"][0].ici, mc["meshes"][0].dp
    B = TRAIN_BATCH
    legs = (("a replicated dedup capped", "replicated", "dedup", mc["caps"],
             ("sharded_rows/float32", "sample_flat", "local_reindex", "masked_mean_backward/cols")),
            ("b sharded tiled dedup", "tiled", "dedup", None,
             ("sharded_rows/float32", "sharded_sample_tiled", "local_reindex",
              "masked_mean_backward/cols")),
            ("c sharded flat fused", "flat", "fused", None,
             ("sharded_rows/float32", "sharded_sample_flat", "masked_mean_backward/structural")))
    g_flat = topo.to_device(dev)
    total = {}
    for n_leg, (leg, topology, pipeline, caps, needs) in enumerate(legs):
        n_batches = 1 + MC_STEPS + MC_COLLECTIVE_STEPS
        first = n_leg * n_batches * B * dp
        batches = [torch.from_numpy(mc["order"][first + i * B * dp:first + (i + 1) * B * dp]
                                    .astype(np.int32)) for i in range(n_batches)]
        model = sage_model()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        key0 = qrandom.key(seed + 90 + n_leg)
        clock = CollectiveClock()

        def rank(m):
            replica = replicate(m, model)
            opt = torch.optim.Adam(replica.parameters(), lr=1e-3)
            if topology == "replicated":
                step = make_sharded_train_step(m, replica, opt, SIZES, caps=caps,
                                               pipeline=pipeline)
                graph = g_flat
            else:
                step = make_sharded_topo_train_step(m, replica, opt, SIZES, pipeline=pipeline,
                                                    layout=topology)
                graph = (mc["blocks"][topology][m.ici_idx],)
            block = mc["stripes"][m.ici_idx]
            first = step.sample_and_gather(key0, *graph, block, batches[0])
            step(key0, *graph, block, labels, batches[0])  # warm-up
            times, losses = [], []
            for i in range(MC_STEPS):
                m.stream.synchronize()
                t0 = time.perf_counter()
                loss = step(qrandom.key(seed + 100 * n_leg + i), *graph, block, labels,
                            batches[1 + i])
                m.stream.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
            coll, step_ms = [], []
            for i in range(MC_COLLECTIVE_STEPS):
                acc = clock.on()
                m.stream.synchronize()
                t0 = time.perf_counter()
                step(qrandom.key(seed + 100 * n_leg + 50 + i), *graph, block, labels,
                     batches[1 + MC_STEPS + i])
                m.stream.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                coll.append(sum(ms for _, ms in acc))
                clock.local.acc = None
            on_card = g_flat if topology == "replicated" else graph[0]
            held = sum(t.numel() * t.element_size() for t in on_card if t.is_cuda)
            held += block.numel() * block.element_size()
            held += 3 * sum(p.numel() * p.element_size() for p in replica.parameters())
            return dict(first=first, times=times, losses=losses, coll_ms=coll, instr_ms=step_ms,
                        held_bytes=held,
                        params={k: v.detach().clone() for k, v in replica.state_dict().items()})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_counts()
        t_leg = time.perf_counter()
        with clock:
            res = run_ranks(rank, meshes)
        leg_s = time.perf_counter() - t_leg
        counts = _kernels.counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        # the first step's sample and rows against the single-device pipeline
        for r, out in enumerate(res):
            m = meshes[r]
            k_s = qrandom.split(qrandom.fold_in(key0, m.dp_idx))[0]
            local = batches[0][m.dp_idx * B:(m.dp_idx + 1) * B].to(dev)
            if pipeline == "dedup":
                ref = sample_and_gather_dedup(*g_flat, table, k_s, local, SIZES, caps)
            else:
                ref = sample_and_gather_fused(*g_flat, table, k_s, local, SIZES)
            check(same_sample(*out["first"], *ref, pipeline),
                  f"{leg}: rank {r}'s first sample or rows differ from the single-device pipeline")
        for r, out in enumerate(res[1:], 1):
            check(all(torch.equal(v, res[0]["params"][k]) for k, v in out["params"].items()),
                  f"{leg}: rank {r}'s parameters differ from rank 0's after the leg")
        losses = res[0]["losses"]
        check(all(np.isfinite(losses)), f"{leg}: loss not finite: {losses}")
        for name in needs:
            check(counts[name] > 0, f"kernel {name} never launched on the multichip leg {leg}")
        n_rows = int(res[0]["first"][1].shape[0])
        comm = {"gather": gather_comm_bytes(meshes[0], n_rows, DIM)}
        if topology != "replicated":
            comm["sampling"] = sampling_comm_bytes(meshes[0], SIZES, B, caps=caps, layout=topology,
                                                   feature_dim=DIM if pipeline == "fused" else 0)
        coll = [float(np.mean(o["coll_ms"])) for o in res]
        instr = [float(np.mean(o["instr_ms"])) for o in res]
        log("mc train: " + json.dumps({
            "leg": leg, "mesh": meshes[0].shape, "batch_per_dp": B, "steps": MC_STEPS,
            "step_ms": median_min_max(res[0]["times"]),
            "step_ms_by_rank": [float(np.median(o["times"])) for o in res],
            "collective_ms_by_rank": coll, "instrumented_step_ms_by_rank": instr,
            "collective_share": float(np.mean([c / s for c, s in zip(coll, instr)])),
            "loss_first": losses[0], "loss_last": losses[-1], "gathered_rows": n_rows,
            "device_peak_bytes_all_ranks": peak,
            "resident_bytes_by_rank": [o["held_bytes"] for o in res],
            "comm_model_bytes": comm, "leg_s": leg_s,
            "launches": {k: v for k, v in counts.items() if v}}))
        del res
        torch.cuda.empty_cache()
    return total


def multichip_learn_phase():
    """The products_multichip example on the four rank threads at the learn
    phase's graph size and args: its test accuracy beside the JAX example's
    on the same graph and args, and the single-device example's on its own
    graph. Returns the launches."""
    from quiver_tpu_torch.examples import products_multichip

    argv = ["--device", "cuda", "--devices", str(MC_RANKS), "--dp", str(MC_DP)] + MC_LEARN_ARGS
    _kernels.reset_counts()
    t0 = time.perf_counter()
    res = products_multichip.main(argv)
    counts = _kernels.counts()
    log("learn multichip: " + json.dumps({"result": res, "args": argv,
                                          "jax_example_test_acc_same_graph": MC_JAX_EXAMPLE_ACC,
                                          "single_device_test_acc_other_graph":
                                              MC_SINGLE_DEVICE_ACC,
                                          "seconds": time.perf_counter() - t0,
                                          "launches": {k: v for k, v in counts.items() if v}}))
    check(res.get("test_acc", 0.0) > LEARN_BAR, f"the multichip example did not learn: {res}")
    check(counts["sharded_rows"] > 0, "K13a never launched in the multichip example")
    return counts


# -- the host axis: K13c, K13d, K13e and the (host, dp, ici) train legs ---------------

def host_setup(topo, table, train_idx, heat_order, caps, seed):
    """The host slice's state: 4 rank threads (host 2 x dp 1 x ici 2) on the
    card over gloo, the table's four (host, ici) stripes, each (host, ici)
    shard's flat and tiled graph block (K12 building the tiled ones), and
    for the hot/cold leg the graph and table renumbered by the tiers phase's
    heat order, their hot/cold stripes (HOST_HOT_FRAC of the rows hot) and
    tiled blocks, and the cold budget calibrated over MC_CAP_PROBES batches
    (margin HOST_COLD_MARGIN). Leg (d)'s caps are the mc phase's."""
    dev = table.device
    meshes = local_meshes(HOST_RANKS, hosts=HOST_HOSTS, device=dev, timeout_s=600)
    feat = ("host", "ici")
    n_shards = meshes[0].axis_size(feat)
    by_shard = [next(m for m in meshes if m.index(feat) == p) for p in range(n_shards)]
    stripes = [stripe_rows(table, n_shards, p) for p in range(n_shards)]
    t0 = time.perf_counter()
    blocks = {"flat": [shard_topology_rows(m, topo, layout="flat") for m in by_shard]}
    blocks["tiled"] = tile_build("sharded ids (host, ici shards)", lambda: [
        shard_topology_rows(m, topo, layout="tiled") for m in by_shard])
    n = topo.node_count
    inv = np.empty(n, np.int64)
    inv[heat_order] = np.arange(n)
    topo_r = renumbered_csr(topo, heat_order, inv)
    table_r = table[torch.from_numpy(heat_order).to(dev)]
    hot_rows = int(n * HOST_HOT_FRAC)
    hot_cold = [hot_cold_stripes(table_r, hot_rows, m.hosts, m.ici, m.host_idx, m.ici_idx)
                for m in by_shard]
    blocks["renumbered"] = tile_build("renumbered sharded ids (host, ici shards)", lambda: [
        shard_topology_rows(m, topo_r, layout="tiled") for m in by_shard])
    build_s = time.perf_counter() - t0
    order = np.random.default_rng(seed + 120).permutation(train_idx)
    probes = inv[order[-MC_CAP_PROBES * TRAIN_BATCH:]].reshape(MC_CAP_PROBES, TRAIN_BATCH)
    t0 = time.perf_counter()
    budget = tile_build("renumbered ids (cold budget calibration)", lambda: calibrate_cold_budget(
        GraphSageSampler(topo_r, SIZES, device=dev, seed=seed + 121), probes, hot_rows,
        margin=HOST_COLD_MARGIN))
    log("host setup: " + json.dumps({
        "mesh": meshes[0].shape, "ranks": len(meshes),
        "row_start": blocks["flat"][0].row_start.tolist(), "stripe_rows": int(stripes[0].shape[0]),
        "tiled_block_rows": [int(b.tiles.shape[0]) for b in blocks["tiled"]],
        "hot_rows": hot_rows, "hot_stripe_rows": int(hot_cold[0][0].shape[0]),
        "cold_stripe_rows": int(hot_cold[0][1].shape[0]), "cold_budget": budget,
        "cold_budget_margin": HOST_COLD_MARGIN, "calibration_s": time.perf_counter() - t0,
        "blocks_s": build_s, "caps": caps}))
    return dict(meshes=meshes, by_shard=by_shard, stripes=stripes, blocks=blocks, caps=caps,
                order=order, inv=inv, topo_r=topo_r, table_r=table_r, hot_rows=hot_rows,
                hot_cold=hot_cold, budget=budget)


def owner_hosts(row_start, ici: int, ids: torch.Tensor) -> torch.Tensor:
    """The host whose (host, ici) shard owns each id (shard p = host * ici +
    ici_idx; ids outside every shard map to the nearest)."""
    rs = row_start.to(ids.device)
    p = torch.searchsorted(rs, ids.to(torch.int64), right=True) - 1
    return torch.clamp(p, 0, rs.shape[0] - 2) // ici


def grouped_draw_reference(g_flat, row_start, ici, frontiers, g, k):
    """What host ``g`` gets from a grouped draw, by the single-device K1b on
    the whole graph: the hosts' frontiers ``[(cur, cur_valid, key), ...]``
    concatenated, each row drawn with the key of the host that owns it (its
    shards draw with their own data group's key), host g's lanes kept."""
    all_cur = torch.cat([f[0] for f in frontiers])
    all_valid = torch.cat([f[1] for f in frontiers])
    owner = owner_hosts(row_start, ici, all_cur)
    w = frontiers[g][0].shape[0]
    sl = slice(g * w, (g + 1) * w)
    nbrs = torch.zeros((w, k), dtype=torch.int32, device=all_cur.device)
    valid = torch.zeros((w, k), dtype=torch.bool, device=all_cur.device)
    for o, (_, _, key) in enumerate(frontiers):
        n_o, v_o = sample.sample_layer(*g_flat, all_cur, all_valid, k, key)
        m = (owner[sl] == o)[:, None] & v_o[sl]
        nbrs = torch.where(m, n_o[sl], nbrs)
        valid |= m
    return nbrs, valid


def grouped_pipeline_reference(g_flat, row_start, ici, table, keys, seeds, pipeline, caps):
    """The single-device pipelines of all data groups in lockstep threads,
    each hop's draw through `grouped_draw_reference` on the whole graph:
    what a grouped sharded step's first sample and rows must be. Returns
    [(ds, x)] by group."""
    G = len(keys)
    barrier = threading.Barrier(G, timeout=600)
    shared, out, errors = [None] * G, [None] * G, []

    def run(g):
        def sample_fn(cur, cur_valid, k, sub):
            shared[g] = (cur, cur_valid, sub)
            barrier.wait()
            res = grouped_draw_reference(g_flat, row_start, ici, list(shared), g, k)
            barrier.wait()  # every host has read the frontiers before the next hop
            return res

        try:
            if pipeline == "dedup":
                out[g] = sample_and_gather_dedup(None, None, table, keys[g], seeds[g], SIZES,
                                                 caps, sample_fn=sample_fn)
            else:
                out[g] = sample_and_gather_fused(None, None, table, keys[g], seeds[g], SIZES,
                                                 sample_fn=sample_fn)
        except BaseException as exc:  # re-raised below
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(g,), daemon=True) for g in range(G)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors:
        raise errors[0]
    return out


def kernel_phase_9(topo, table, host, rows, seed):
    """Hold the host axis's kernels against their plain versions, timed on
    the lanes of one calibrated dedup batch a data group (host 0's and host
    1's, 1,024 seeds each) and checked, not timed, on the same batches
    uncapped (the widths legs (e) and (f) launch): the grouped gather's
    pack (K13a at the gathered width) and K13c's unpack of the two slabs a
    rank receives, in float32 (the report row: rank (0, 0)), bfloat16 and
    int8, the ici ranks' unpacks summing to the rows; K13e's grouped hop
    (K13b at the gathered width, then K13c's int32 unpack of both slab
    sets) flat and tiled per hop and rank, the ici ranks' sums equal to
    the single-device draw with each row drawn by its owner host's key;
    K13d's compaction and merge at the hot/cold leg's two gather widths and
    calibrated budget on the renumbered graph's batch. Then gloo's
    all-gather and all-to-all alone."""
    dev = table.device
    meshes, by_shard = host["meshes"], host["by_shard"]
    ici, G = meshes[0].ici, meshes[0].hosts
    N = topo.node_count
    B = TRAIN_BATCH
    key = qrandom.key(seed + 130)
    keys = [qrandom.split(qrandom.fold_in(key, g))[0] for g in range(G)]
    seeds = [torch.from_numpy(host["order"][g * B:(g + 1) * B].astype(np.int32)).to(dev)
             for g in range(G)]
    lanes = {tag: [dedup_lanes(topo, table, caps, seeds[g], keys[g]) for g in range(G)]
             for tag, caps in (("calibrated", host["caps"]), ("uncapped", None))}
    log("kernels-9 lanes: " + json.dumps({
        tag: {"gather_ids": [int(l[1].shape[0]) for l in ls],
              "hops": [[int(h[0].shape[0]), h[2]] for h in ls[0][0]]}
        for tag, ls in lanes.items()}))
    R = host["stripes"][0].shape[0]

    # K13c: the slabs rank (h, i) receives: slab g = shard (g, i)'s partial of host h's ids
    def received(stripes, ids, h, i):
        return torch.stack([partial_rows(stripes[g * ici + i], ids[h], g * ici + i)
                            for g in range(G)])

    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        if dtype == torch.float32:
            full, stripes = table, host["stripes"]
        else:
            full = table.to(dtype) if dtype == torch.bfloat16 else \
                torch.clamp(torch.round(table * 20), -127, 127).to(torch.int8)
            stripes = [stripe_rows(full, G * ici, p) for p in range(G * ici)]
        es = full.element_size()
        for tag in (("calibrated", "uncapped") if dtype == torch.float32 else ("calibrated",)):
            ids = [lanes[tag][g][1] for g in range(G)]
            W = ids[0].shape[0]
            if tag == "calibrated":  # the grouped gather's pack: K13a at the gathered width
                all_ids = torch.cat(ids)
                own = (all_ids >= 0) & (all_ids < R)
                local = torch.clamp(all_ids.long(), 0, R - 1)
                record(rows, "sharded_rows", 0.0,
                       time_ms(lambda: partial_rows(stripes[0], all_ids, 0)),
                       time_ms(lambda: partial_rows_plain(stripes[0], all_ids, 0), reps=5),
                       bound(G * W * 4 + torch.unique(all_ids[own]).numel() * DIM * es
                             + G * W * DIM * es),
                       time_ms(lambda: torch.index_select(stripes[0], 0, local)),
                       shape=f"K13c pack: shard (0, 0) at G*W={G * W} D={DIM} "
                             f"{str(dtype)[6:]}", report=False)
                del all_ids, own, local
            for h in range(G):
                total = None
                for i in range(ici):
                    slabs = received(stripes, ids, h, i)
                    got = grouped_unpack(slabs)
                    check(torch.equal(got, grouped_unpack_plain(slabs)),
                          f"K13c {dtype} rank ({h}, {i}) ({tag} lanes) differs from its plain "
                          "version")
                    total = got if total is None else total + got
                    if tag == "calibrated" and h == 0:
                        record(rows, "grouped_unpack", 0.0, time_ms(lambda: grouped_unpack(slabs)),
                               time_ms(lambda: grouped_unpack_plain(slabs), reps=5),
                               bound(G * W * DIM * es + W * DIM * es),
                               time_ms(lambda: slabs.sum(0)),
                               shape=f"G={G} W={W} D={DIM} {str(dtype)[6:]} rank ({h}, {i})",
                               report=dtype == torch.float32 and i == 0)
                    del slabs
                inr = (ids[h] >= 0) & (ids[h] < N)
                check(torch.equal(total[inr], full[ids[h][inr].long()]) and not total[~inr].any(),
                      f"K13c {dtype} ({tag} lanes): host {h}'s unpacked slabs do not sum to the "
                      "rows")
                del total, got
        del full, stripes
    torch.cuda.empty_cache()

    # K13e: a grouped hop per rank, flat and tiled
    row_start = host["blocks"]["flat"][0].row_start
    g_flat = topo.to_device(dev)
    indptr_dev = torch.from_numpy(topo.indptr).to(dev)
    for layout in ("flat", "tiled"):
        if layout == "flat":
            fn, plain = sample_layer_partial, sample_layer_partial_plain
            blk = [(b.indptr, b.indices) for b in host["blocks"]["flat"]]
        else:
            fn, plain = tiled_sample_layer_partial, tiled_sample_layer_partial_plain
            blk = [(b.bd, b.tiles) for b in host["blocks"]["tiled"]]
        for tag, ls in lanes.items():
            for l in range(len(SIZES)):
                fr = [(ls[g][0][l][0], ls[g][0][l][1], ls[g][0][l][3]) for g in range(G)]
                k = ls[0][0][l][2]
                w = fr[0][0].shape[0]
                all_cur = torch.cat([f[0] for f in fr])
                all_valid = torch.cat([f[1] for f in fr])
                # every shard's draw at the gathered width, with its host's key
                parts = {}
                for g in range(G):
                    for i in range(ici):
                        p = g * ici + i
                        args = (*blk[p], int(row_start[p]), int(row_start[p + 1]), all_cur,
                                all_valid, k, fr[g][2])
                        parts[g, i] = fn(*args)
                        if p != 0:
                            continue
                        want = plain(*args)
                        check(torch.equal(parts[g, i][0], want[0])
                              and torch.equal(parts[g, i][1], want[1]),
                              f"K13b {layout} hop {l} at the gathered width ({tag} lanes) "
                              "differs from its plain version")
                for h in range(G):
                    n_sum = v_sum = None
                    for i in range(ici):
                        a = torch.stack([parts[g, i][0][h * w:(h + 1) * w] for g in range(G)])
                        b = torch.stack([parts[g, i][1][h * w:(h + 1) * w] for g in range(G)])
                        got = grouped_unpack(a), grouped_unpack(b)
                        check(torch.equal(got[0], grouped_unpack_plain(a))
                              and torch.equal(got[1], grouped_unpack_plain(b)),
                              f"K13c int32 (K13e) {layout} hop {l} rank ({h}, {i}) ({tag} lanes) "
                              "differs from its plain version")
                        n_sum = got[0] if n_sum is None else n_sum + got[0]
                        v_sum = got[1] if v_sum is None else v_sum + got[1]
                        if tag == "calibrated" and h == 0 and i == 0:
                            p0 = (*blk[0], int(row_start[0]), int(row_start[1]), all_cur,
                                  all_valid, k, fr[0][2])
                            b_draw = sharded_sample_bound(indptr_dev, all_cur, all_valid, k,
                                                          int(row_start[0]), int(row_start[1]))
                            b_unp = bound(2 * G * w * k * 4 + 2 * w * k * 4)
                            unp_ms = time_ms(lambda: (grouped_unpack(a), grouped_unpack(b)))
                            unp_plain = time_ms(lambda: (grouped_unpack_plain(a),
                                                         grouped_unpack_plain(b)), reps=3)
                            record(rows, "grouped_unpack", 0.0, unp_ms, unp_plain, b_unp,
                                   time_ms(lambda: (a.sum(0), b.sum(0))),
                                   shape=f"{layout} hop {l} W={w} G={G} k={k} int32 rank (0, 0): "
                                         "neighbor and valid slabs", report=False)
                            record(rows, "grouped_hop", 0.0, time_ms(lambda: fn(*p0)) + unp_ms,
                                   time_ms(lambda: plain(*p0), reps=3) + unp_plain,
                                   (b_draw[0] + b_unp[0],
                                    b_draw[1] if b_draw[0] >= b_unp[0] else b_unp[1]), None,
                                   shape=f"K13e {layout} hop {l} W={w} G={G} k={k} rank (0, 0): "
                                         f"K13b at {G * w} lanes + K13c int32 unpack of both "
                                         "slab sets", report=False)
                    ref_n, ref_v = grouped_draw_reference(g_flat, row_start, ici, fr, h, k)
                    check(torch.equal(v_sum > 0, ref_v) and int(v_sum.max()) <= 1
                          and torch.equal(n_sum[ref_v], ref_n[ref_v]) and not n_sum[~ref_v].any(),
                          f"K13e {layout} hop {l} host {h} ({tag} lanes): the ici ranks' sum is "
                          "not the owner-keyed single-device draw")
                del parts
    torch.cuda.synchronize()

    # K13d on the renumbered graph: one dedup batch's two gather widths, the budget
    topo_r, table_r, hot_rows = host["topo_r"], host["table_r"], host["hot_rows"]
    seeds_r = torch.from_numpy(host["inv"][host["order"][:B]].astype(np.int32)).to(dev)
    hops_r, ids_r = dedup_lanes(topo_r, table_r, None, seeds_r, keys[0])
    w_cur = hops_r[-1][0].shape[0]
    n_cold_global = host["hot_cold"][0][1].shape[0] * G * ici
    for what, ids in (("frontier", ids_r[:w_cur]), ("leaves", ids_r[w_cur:])):
        w = ids.shape[0]
        budget = cold_budget_lanes(w, host["budget"])
        lo, hi = hot_rows, hot_rows + n_cold_global
        got = cold_compact(ids, lo, hi, budget)
        want = cold_compact_plain(ids, lo, hi, budget)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"K13d's compaction ({what}) differs from its plain version")
        n_cold = int(got[2][0])
        flag = ((ids >= lo) & (ids < hi)).to(torch.int32)
        record(rows, "cold_compact", 0.0, time_ms(lambda: cold_compact(ids, lo, hi, budget)),
               time_ms(lambda: cold_compact_plain(ids, lo, hi, budget), reps=5),
               bound(w * 4 + budget * 8 + 8),
               time_ms(lambda: torch.argsort(1 - flag, stable=True)[:budget]),
               shape=f"{what} W={w} budget={budget} n_cold={n_cold}")
        sel, cold_local, counts = got
        inr = (ids >= 0) & (ids < hot_rows)
        hot = torch.where(inr[:, None], table_r[torch.clamp(ids.long(), 0, hot_rows - 1)], 0.0)
        ok = cold_local >= 0
        cold_rows = torch.where(ok[:, None], table_r[torch.clamp(cold_local.long() + hot_rows, 0,
                                                                   N - 1)], 0.0)
        merged = cold_merge(hot.clone(), sel, cold_rows, counts)
        check(torch.equal(merged, cold_merge_plain(hot, sel, cold_rows, counts)),
              f"K13d's merge ({what}) differs from its plain version")
        served = torch.zeros(w, dtype=torch.bool, device=dev)
        served[sel[:min(n_cold, budget)].long()] = True
        valid = (ids >= 0) & (ids < N) & (inr | served)
        check(torch.equal(merged[valid], table_r[ids[valid].long()]) and not merged[~valid].any(),
              f"K13d ({what}): the merged rows are not the table's")
        hot_t = hot.clone()
        add = torch.where(ok[:, None], cold_rows, 0.0)
        record(rows, "cold_merge", 0.0, time_ms(lambda: cold_merge(hot_t, sel, cold_rows, counts)),
               time_ms(lambda: cold_merge_plain(hot, sel, cold_rows, counts), reps=5),
               bound(budget * 4 + budget * DIM * 4 * 3 + 4),
               time_ms(lambda: hot_t.index_add_(0, sel.long(), add)),
               shape=f"{what} W={w} budget={budget} D={DIM} float32")
        log("kernels-9 hot/cold: " + json.dumps({"gather": what, "width": w, "budget": budget,
                                                 "n_cold": n_cold, "overflow": int(counts[1]),
                                                 "hot_share": float(inr.float().mean())}))
    torch.cuda.synchronize()

    # gloo alone: the grouped gather's id all-gather and slab all-to-all, all ranks at once
    W = lanes["calibrated"][0][1].shape[0]
    for what, shape, dtype, op in (("ids int32 all-gather", (W,), torch.int32, "allgather"),
                                   ("slabs float32 all-to-all", (G, W, DIM), torch.float32,
                                    "all_to_all")):
        def rank(m, shape=shape, dtype=dtype, op=op):
            x = torch.zeros(shape, dtype=dtype, device=m.device)
            fn = getattr(par_collectives, op)
            times = []
            for _ in range(4):
                m.stream.synchronize()
                t0 = time.perf_counter()
                fn(x, m.group("host"))
                m.stream.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times[1:]))
        ms = run_ranks(rank, meshes)
        n_bytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        log("kernels-9 gloo: " + json.dumps({
            "op": what, "bytes_in": n_bytes, "ms": ms[0], "ms_by_rank": ms,
            "GB_per_s_in": n_bytes / ms[0] / 1e6, "transport": "gloo, host-staged, one card",
            "group": f"host pair ({G} ranks), both pairs at once; not NVLink, not NCCL"}))


def same_sample_rows(ds, x, ref_ds, ref_x, pipeline, overflow):
    """`same_sample` on a hot/cold leg: the sample on every real lane, and
    the rows too when no cold id overflowed the budget (an overflowed
    lane's row comes back zero). Returns (ok, real lanes whose rows
    differ)."""
    ok = valid_positions(ref_ds, pipeline)
    differ = int((x[ok] != ref_x[ok]).any(1).sum()) if x.shape == ref_x.shape else -1
    if overflow == 0:
        return same_sample(ds, x, ref_ds, ref_x, pipeline), differ
    return same_sample(ds, ref_x, ref_ds, ref_x, pipeline) and 0 <= differ <= overflow, differ


def host_phase(topo, table, labels, host, seed):
    """Three legs of the (host, dp, ici) train step on the four rank
    threads at full products width, batch 1,024 a data group: (d)
    replicated graph, dedup, the caps, grouped gathers (K13c); (e) graph
    row-sharded over (host, ici) in tiled blocks, fused, grouped draws
    (K13e) and per-hop grouped gathers; (f) hot/cold: the renumbered graph
    row-sharded in tiled blocks, dedup, the hot/cold gathers (K13d, K13c)
    with the calibrated budget. A leg: the first step's sample and rows
    against the single-device pipelines in lockstep (`grouped_pipeline_
    reference`), a warm-up step, HOST_STEPS timed steps (median),
    MC_COLLECTIVE_STEPS steps with every collective timed apart, the
    device peak, the byte models with their host terms and, for (f), the
    overflow a step; the replicas bit-equal after the leg. Returns the
    launches summed over the legs' runs."""
    dev = table.device
    meshes = host["meshes"]
    m0 = meshes[0]
    ici, G = m0.ici, m0.hosts
    B = TRAIN_BATCH
    legs = (("d host replicated dedup capped", "replicated", "dedup", host["caps"], False,
             ("sharded_rows/float32", "grouped_unpack/float32", "sample_flat", "local_reindex",
              "masked_mean_backward/cols")),
            ("e host sharded tiled fused", "tiled", "fused", None, False,
             ("sharded_rows/float32", "grouped_unpack/float32", "sharded_sample_tiled",
              "grouped_unpack/int32", "masked_mean_backward/structural")),
            ("f host hot/cold sharded tiled dedup", "renumbered", "dedup", None, True,
             ("sharded_rows/float32", "grouped_unpack/float32", "cold_compact",
              "cold_merge/float32", "sharded_sample_tiled", "grouped_unpack/int32",
              "local_reindex", "masked_mean_backward/cols")))
    row_start = host["blocks"]["flat"][0].row_start
    total = {}
    for n_leg, (leg, topology, pipeline, caps, hot_cold, needs) in enumerate(legs):
        n_batches = 1 + HOST_STEPS + MC_COLLECTIVE_STEPS
        start = (n_leg * n_batches + 1) * B * G  # past kernels-9's batch
        order = host["inv"][host["order"]] if hot_cold else host["order"]
        batches = [torch.from_numpy(order[start + i * B * G:start + (i + 1) * B * G]
                                    .astype(np.int32)) for i in range(n_batches)]
        model = sage_model()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        key0 = qrandom.key(seed + 140 + n_leg)
        clock = CollectiveClock()
        kw = dict(hot_rows=host["hot_rows"], cold_budget=host["budget"]) if hot_cold else {}

        def rank(m):
            replica = replicate(m, model)
            opt = torch.optim.Adam(replica.parameters(), lr=1e-3)
            p = m.index(("host", "ici"))
            if topology == "replicated":
                step = make_sharded_train_step(m, replica, opt, SIZES, caps=caps,
                                               pipeline=pipeline)
                graph = g_flat
            else:
                step = make_sharded_topo_train_step(m, replica, opt, SIZES, pipeline=pipeline,
                                                    layout="tiled", **kw)
                graph = (host["blocks"][topology][p],)
            block = host["hot_cold"][p] if hot_cold else host["stripes"][p]
            first = step.sample_and_gather(key0, *graph, block, batches[0])
            out = step(key0, *graph, block, labels, batches[0])  # warm-up, the same sample
            first_overflow = int(out[1]) if hot_cold else 0
            times, losses, overflows = [], [], []
            for i in range(HOST_STEPS):
                m.stream.synchronize()
                t0 = time.perf_counter()
                out = step(qrandom.key(seed + 100 * n_leg + i), *graph, block, labels,
                           batches[1 + i])
                m.stream.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                loss = out[0] if hot_cold else out
                losses.append(float(loss))
                if hot_cold:
                    overflows.append(int(out[1]))
            coll, step_ms = [], []
            for i in range(MC_COLLECTIVE_STEPS):
                acc = clock.on()
                m.stream.synchronize()
                t0 = time.perf_counter()
                step(qrandom.key(seed + 100 * n_leg + 50 + i), *graph, block, labels,
                     batches[1 + HOST_STEPS + i])
                m.stream.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                by = {}
                for name, ms in acc:
                    by[name] = by.get(name, 0.0) + ms
                coll.append(by)
                clock.local.acc = None
            return dict(first=first, first_overflow=first_overflow, times=times, losses=losses,
                        overflows=overflows, coll=coll, instr_ms=step_ms,
                        params={k: v.detach().clone() for k, v in replica.state_dict().items()})

        g_flat = (host["topo_r"] if hot_cold else topo).to_device(dev)
        table_ref = host["table_r"] if hot_cold else table
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_counts()
        t_leg = time.perf_counter()
        with clock:
            res = run_ranks(rank, meshes)
        leg_s = time.perf_counter() - t_leg
        counts = _kernels.counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        # the first step's sample and rows against the single-device pipelines
        keys = [qrandom.split(qrandom.fold_in(key0, g))[0] for g in range(G)]
        local = [batches[0][g * B:(g + 1) * B].to(dev) for g in range(G)]
        if topology == "replicated":
            refs = [sample_and_gather_dedup(*g_flat, table_ref, keys[g], local[g], SIZES, caps)
                    for g in range(G)]
        else:
            refs = grouped_pipeline_reference(g_flat, row_start if not hot_cold else
                                              host["blocks"]["renumbered"][0].row_start, ici,
                                              table_ref, keys, local, pipeline, caps)
        differ = []
        for r, out in enumerate(res):
            g = meshes[r].index(("host", "dp"))
            same, d = same_sample_rows(*out["first"], *refs[g], pipeline, out["first_overflow"])
            differ.append(d)
            check(same, f"{leg}: rank {r}'s first sample or rows differ from the single-device "
                        "pipelines")
        for r, out in enumerate(res[1:], 1):
            check(all(torch.equal(v, res[0]["params"][k]) for k, v in out["params"].items()),
                  f"{leg}: rank {r}'s parameters differ from rank 0's after the leg")
        losses = res[0]["losses"]
        check(all(np.isfinite(losses)), f"{leg}: loss not finite: {losses}")
        for name in needs:
            check(counts[name] > 0, f"kernel {name} never launched on the host leg {leg}")
        n_rows = int(res[0]["first"][1].shape[0])
        budget_lanes = None
        if hot_cold:
            w_cur = int(res[0]["first"][0].adjs[0].mask.shape[0]) if pipeline == "dedup" else 0
            budget_lanes = sum(cold_budget_lanes(w, host["budget"]) for w in (w_cur,
                                                                                n_rows - w_cur))
        comm = {"gather": gather_comm_bytes(m0, n_rows, DIM, cold_budget=budget_lanes)}
        if topology != "replicated":
            comm["sampling"] = sampling_comm_bytes(m0, SIZES, B, caps=caps, layout="tiled",
                                                   feature_dim=DIM if pipeline == "fused" else 0)
        coll = [float(np.mean([sum(c.values()) for c in o["coll"]])) for o in res]
        instr = [float(np.mean(o["instr_ms"])) for o in res]
        by_op = {name: float(np.mean([c.get(name, 0.0) for c in res[0]["coll"]]))
                 for name in par_collectives.COLLECTIVES}
        log("host train: " + json.dumps({
            "leg": leg, "mesh": m0.shape, "batch_per_group": B, "steps": HOST_STEPS,
            "step_ms": median_min_max(res[0]["times"]),
            "step_ms_by_rank": [float(np.median(o["times"])) for o in res],
            "collective_ms_by_rank": coll, "instrumented_step_ms_by_rank": instr,
            "collective_share": float(np.mean([c / s for c, s in zip(coll, instr)])),
            "collective_ms_by_op_rank0": by_op,
            "loss_first": losses[0], "loss_last": losses[-1], "gathered_rows": n_rows,
            "overflow_first_step": res[0]["first_overflow"],
            "overflow_per_step": res[0]["overflows"] if hot_cold else None,
            "cold_budget": host["budget"] if hot_cold else None,
            "cold_budget_lanes": budget_lanes, "first_step_rows_differing": differ,
            "host_axis_model_bytes": {k: v["dcn_bytes"] for k, v in comm.items()},
            "comm_model_bytes": comm, "device_peak_bytes_all_ranks": peak, "leg_s": leg_s,
            "launches": {k: v for k, v in counts.items() if v}}))
        del res, refs
        torch.cuda.empty_cache()
    return total


def host_learn_phase():
    """products_multichip --hosts 2 --hot-frac 0.2 on the four rank threads
    at the multichip learn args: test accuracy above LEARN_BAR and within
    LEARN_REF_TOL of the JAX example's on the same graph and args (4
    virtual CPU devices). Returns the launches."""
    from quiver_tpu_torch.examples import products_multichip

    argv = (["--device", "cuda", "--devices", str(HOST_RANKS), "--hosts", str(HOST_HOSTS),
             "--hot-frac", str(HOST_HOT_FRAC)] + MC_LEARN_ARGS)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    res = products_multichip.main(argv)
    counts = _kernels.counts()
    log("learn host: " + json.dumps({"result": res, "args": argv,
                                     "jax_example_test_acc_same_graph": HOST_JAX_EXAMPLE_ACC,
                                     "seconds": time.perf_counter() - t0,
                                     "launches": {k: v for k, v in counts.items() if v}}))
    acc = res.get("test_acc", 0.0)
    check(acc > LEARN_BAR, f"the host example did not learn: {res}")
    check(abs(acc - HOST_JAX_EXAMPLE_ACC) <= LEARN_REF_TOL,
          f"the host example's test accuracy {acc} is not within {LEARN_REF_TOL} of the JAX "
          f"example's {HOST_JAX_EXAMPLE_ACC}")
    for name in ("cold_compact", "cold_merge", "grouped_unpack"):
        check(counts[name] > 0, f"{name} never launched in the host example")
    return counts


# -- the fleet: routed serving over the serve exchange (K13f) ---------------------------

class ExchangeClock:
    """Host wall of every `run_ranks` call the comm makes (on the calling
    thread) and of every all_to_all inside them (on each rank thread,
    between syncs of its stream): patched over ``parallel.train.run_ranks``
    and ``parallel.collectives.all_to_all``, through which `comm` reaches
    them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.run_ranks_ms, self.a2a_ms = [], []
        self.orig = (ptrain.run_ranks, par_collectives.all_to_all)

    def __enter__(self):
        run_ranks_fn, a2a_fn = self.orig

        def run_ranks_timed(*a, **k):
            t0 = time.perf_counter()
            out = run_ranks_fn(*a, **k)
            with self.lock:
                self.run_ranks_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def a2a_timed(t, group):
            stream = torch.cuda.current_stream()
            stream.synchronize()
            t0 = time.perf_counter()
            out = a2a_fn(t, group)
            stream.synchronize()
            with self.lock:
                self.a2a_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        ptrain.run_ranks, par_collectives.all_to_all = run_ranks_timed, a2a_timed
        return self

    def __exit__(self, *exc):
        ptrain.run_ranks, par_collectives.all_to_all = self.orig


def count_owner_launches(dist, names):
    """Wrap each owner engine's predict so that the kernels it launches are
    counted per owner ({host: {name: launches}}). Exact in collective mode:
    the answerers run one at a time under the collective lock, and nothing
    else launches while they do."""
    per_owner = {h: dict.fromkeys(names, 0) for h in dist.engines}

    def counted(h, fn):
        def predict(ids, *a, **k):
            before = _kernels.counts()
            try:
                return fn(ids, *a, **k)
            finally:
                after = _kernels.counts()
                for name in names:
                    per_owner[h][name] += after[name] - before[name]
        return predict

    for h, eng in dist.engines.items():
        eng.predict = counted(h, eng.predict)
    return per_owner


def fleet_leg(leg, topo, table, model, params, trace, residency, seed):
    """One fleet leg: DistServeEngine.build over the products graph and
    table (its owners' tile tables built by K12 on the card), warmup, then
    ``trace`` from 4 client threads with the counts set to 0 just before and
    read just after. Checks that every request was answered with finite
    logits; returns (dist, served, summary, counts, per-owner launches)."""
    names = ("sample_tiled", "local_reindex", "gather_rows", "masked_mean", "tiered_gather",
             "exchange_rows")
    cfg = DistServeConfig(hosts=FLEET_HOSTS, max_batch=BATCH, record_dispatches=True,
                          feature_residency=residency)
    t0 = time.perf_counter()
    dist = tile_build(f"fleet owner ids ({residency} residency, {FLEET_HOSTS} owners)",
                      lambda: DistServeEngine.build(model, params, topo, table, SIZES,
                                                    hosts=FLEET_HOSTS, config=cfg,
                                                    sampler_seed=seed, device=table.device))
    build_s = time.perf_counter() - t0
    check(dist.exchange_mode == "collective", "the fleet did not take the collective exchange")
    t0 = time.perf_counter()
    warm = dist.warmup()
    warm_s = time.perf_counter() - t0
    dist.reset_stats()
    per_owner = count_owner_launches(dist, names)
    with ExchangeClock() as xclock:
        _kernels.reset_counts()
        served, wall = serve_phase(dist, trace, clients=4)
        counts = _kernels.counts()
    st = dist.stats
    agg = dist.aggregate_stats()
    check(st.requests == len(trace) and len(served) == len(set(trace.tolist())),
          f"fleet leg {leg}: not every request was answered")
    out = np.stack(list(served.values()))
    check(out.shape[1] == CLASSES and np.isfinite(out).all(),
          f"fleet leg {leg}: served logits malformed")
    flushes = max(st.router_dispatches, 1)
    summary = {
        "leg": leg, "residency": residency, "exchange": dist.exchange_mode, "hosts": dist.hosts,
        "requests": st.requests, "wall_s": wall, "qps": st.requests / wall,
        "latency": st.latency.snapshot(), "router_cache": st.router_cache.snapshot(),
        "coalesced": st.coalesced, "router_dispatches": st.router_dispatches,
        "routed_seeds": st.routed_seeds, "inflight_peak": st.inflight_peak,
        "exchange_id_bytes": st.exchange_id_bytes,
        "exchange_logit_bytes": st.exchange_logit_bytes, "serve_budget": dist._budget,
        "mean_sub_batch_width": st.mean_sub_batch_width(), "sub_batches": st.sub_batches,
        "topo_stats": dist.shard_topo_stats,
        "owner_dispatches": {h: s["dispatches"] for h, s in agg["per_shard"].items()},
        "owner_latency": {h: s["latency"] for h, s in agg["per_shard"].items()},
        "owner_launches": per_owner, "launches": {k: v for k, v in counts.items() if v},
        "run_ranks_calls": len(xclock.run_ranks_ms),
        "run_ranks_ms_per_flush": sum(xclock.run_ranks_ms) / flushes,
        "all_to_all_calls": len(xclock.a2a_ms),
        "all_to_all_ms_per_flush_per_rank": sum(xclock.a2a_ms) / FLEET_HOSTS / flushes,
        "build_s": build_s, "warmup_s": warm_s,
        "warmup": {str(h): {str(b): round(t, 4) for b, t in w.items()} for h, w in warm.items()},
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"fleet {leg}: " + json.dumps(summary))
    return dist, served, summary, counts, per_owner


def fleet_replay(leg, dist, model, params, full, served, seed):
    """replay_shard_oracle over the first FLEET_REPLAY dispatches of each
    owner through a fresh full-graph sampler on the card (bit-equal to the
    served rows), then over the first FLEET_REPLAY_CPU on the CPU plain path
    (within 1e-3): the owners' logs are cut to those dispatches first.
    ``full`` maps each device to its (CSRTopo, table)."""
    worst = {}
    for device, n_dispatch, atol in ((dist.engines[0].device, FLEET_REPLAY, 0.0),
                                     (torch.device("cpu"), FLEET_REPLAY_CPU, 1e-3)):
        for eng in dist.engines.values():
            eng.dispatch_log = eng.dispatch_log[:n_dispatch]
        topo, table = full[device.type]
        oracle = replay_shard_oracle(dist, model, params,
                                     lambda: GraphSageSampler(topo, SIZES, device=device,
                                                              seed=seed), table)
        check(len(oracle) > 0, f"fleet leg {leg}: nothing to replay")
        diff = max(float(np.abs(served[node] - row).max()) for node, row in oracle.items())
        check(diff <= atol, f"fleet leg {leg}: the replay on {device} differs from the served "
                            f"rows by {diff}")
        worst[str(device)] = {"dispatches_per_owner": n_dispatch, "rows": len(oracle),
                              "max_abs_diff": diff}
    log(f"fleet {leg} replay: " + json.dumps(worst))


def fleet_phase(topo, table, model, params, trace, seed):
    """The fleet's main path, two legs over 2 owners (contiguous partition,
    max_batch 64): (a) the closure residency over the collective exchange,
    the whole trace; (b) the exchange residency (each owner's rows on the
    host, the others' over its own feature exchange: K3t and K13f), the
    first FLEET_EXCHANGE_REQUESTS requests. Each owner must launch K1, K2,
    K4 and its gather (K3 in (a), K3t in (b)); K13f must launch in (b).
    Returns leg (b)'s counts."""
    # the CPU replays get their own CSRTopo: the card's tile table stays cached
    full = {table.device.type: (topo, table),
            "cpu": (CSRTopo(indptr=topo.indptr, indices=topo.indices), table.cpu())}
    dist, served, _, _, per_owner = fleet_leg("a", topo, table, model, params, trace,
                                              "closure", seed)
    for h, c in per_owner.items():
        for name in MAIN_PATH:
            check(c[name] > 0, f"owner {h} never launched {name} in fleet leg (a)")
    fleet_replay("a", dist, model, params, full, served, seed)
    del dist
    gc.collect()  # the comm's answerers hold the engine in a cycle
    torch.cuda.empty_cache()
    dist, served, _, counts, per_owner = fleet_leg(
        "b", topo, table, model, params, trace[:FLEET_EXCHANGE_REQUESTS], "exchange", seed)
    check(counts["exchange_rows"] > 0, "exchange_rows never launched in fleet leg (b)")
    for h, c in per_owner.items():
        for name in ("sample_tiled", "local_reindex", "masked_mean", "tiered_gather",
                     "exchange_rows"):
            check(c[name] > 0, f"owner {h} never launched {name} in fleet leg (b)")
    fleet_replay("b", dist, model, params, full, served, seed)
    del dist
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def kernel_phase_10(topo, table, trace, rows, seed):
    """K13f alone at the fleet's shapes: owner 0's table block (its owned
    rows of the products table, the larger block) and the [2, 131072] id
    slab it receives: requester 0 (itself) asks nothing, requester 1 asks
    the owner-0 rows of one B = 64 flush of its own seeds (a full-graph
    sample's valid n_id below the block's end), then FLEET_PAST_IDS ids past
    the block, then -1 pads. Bit-equal to its plain version."""
    dev = table.device
    g2h = contiguous_partition(topo.node_count, FLEET_HOSTS)
    R = int((g2h == 0).sum())
    block = table[:R]  # contiguous ownership: owner 0 holds rows [0, R)
    budget = round_up_pow2(sample.pad_widths(BATCH, SIZES)[-1])
    seeds1 = np.unique(trace[trace >= R])[:BATCH]
    ds = GraphSageSampler(topo, SIZES, device=dev, seed=seed + 140).sample_dense(seeds1)
    n_id = ds.n_id[: int(ds.count)]
    asked = n_id[n_id < R]
    ids = torch.full((FLEET_HOSTS, budget), -1, dtype=torch.int32, device=dev)
    w = asked.shape[0]
    ids[1, :w] = asked.to(torch.int32)
    ids[1, w: w + FLEET_PAST_IDS] = R + torch.arange(FLEET_PAST_IDS, dtype=torch.int32,
                                                     device=dev)
    got = exchange_rows(block, ids)
    want = exchange_rows_plain(block, ids)
    torch.cuda.synchronize()
    err = 0.0 if torch.equal(got.view(torch.int32), want.view(torch.int32)) else float("inf")
    check(err == 0.0, "exchange_rows differs from its plain version")
    flat = ids.reshape(-1)
    valid = int((flat >= 0).sum())
    neg = (flat < 0)[:, None]
    ms = time_ms(lambda: exchange_rows(block, ids))
    plain_ms = time_ms(lambda: exchange_rows_plain(block, ids))
    lib_ms = time_ms(lambda: block.index_select(0, flat.clamp(0, R - 1)).masked_fill_(neg, 0.0))
    n_bytes = flat.numel() * 4 + valid * DIM * 4 + flat.numel() * DIM * 4
    record(rows, "exchange_rows", err, ms, plain_ms, bound(n_bytes), lib_ms,
           shape=f"block [{R}, {DIM}], ids [{FLEET_HOSTS}, {budget}]: {w} asked, "
                 f"{FLEET_PAST_IDS} past the block")


def learn_phase():
    """The example at ACCURACY.json's args on the card, for GraphSAGE (its
    accuracies beside the reference's recorded ones) and for GCN and GAT
    (beside the JAX example's on the CPU at the same args). Returns the
    launches."""
    from quiver_tpu_torch.examples import reddit_sage

    ref = json.loads((Path(__file__).resolve().parent / "ACCURACY.json").read_text())
    ref = ref["reddit_sage_synthetic"]
    total = {}
    for model in ("sage", "gcn", "gat"):
        _kernels.reset_counts()
        t0 = time.perf_counter()
        res = reddit_sage.main(["--device", "cuda", "--model", model] + LEARN_ARGS)
        counts = _kernels.counts()
        want = ref if model == "sage" else {"test_acc": JAX_CPU_TEST_ACC[model]}
        log("learn: " + json.dumps({"model": model, "result": res, "args": LEARN_ARGS,
                                    "reference": want, "seconds": time.perf_counter() - t0,
                                    "launches": {k: v for k, v in counts.items() if v}}))
        if model == "sage":
            pairs, bar = (("test_acc", "test_acc"), ("test_acc_full", "test_acc_full_inference")), \
                LEARN_BAR
            check(counts["full_mean"] > 0, "K10 never launched in full inference")
        else:
            pairs, bar = (("test_acc", "test_acc"),), ZOO_LEARN_BAR
            for name in ("gather_src", "gather_src_backward"):
                check(counts[name] > 0, f"{name} never launched in the {model} example")
        for got, key in pairs:
            acc = res.get(got, 0.0)
            check(acc > bar, f"the {model} example did not learn: {res}")
            check(abs(acc - want[key]) <= LEARN_REF_TOL,
                  f"{model} {got} {acc} is not within {LEARN_REF_TOL} of {want[key]}")
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="graph scale (1.0 = products)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    t_run = _T_RUN[0] = time.perf_counter()

    log(f"build: {_kernels.build():.1f} s")
    for stem, text in sorted(_kernels.build_log.items()):
        log(f"-- ptxas {stem}.cu\n{text.strip()}")
    card = card_line()
    log(f"card: {card}")

    topo = build_graph(args.scale, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    table = torch.randn((topo.node_count, DIM), generator=gen, device=dev)
    model, params = make_model_params(args.seed)
    trace = zipfian_trace(topo.node_count, args.requests, alpha=0.99, seed=args.seed + 1)
    seeds = torch.from_numpy(trace[:BATCH].astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    _kernels.reset_counts()
    sampler = tile_build("ids", lambda: GraphSageSampler(topo, SIZES, device=dev,
                                                         seed=args.seed))  # tiled, dedup
    log(f"tiled graph on the card in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase(topo, table, bind_params(model, params, dev), seeds)
    phase_done("kernels-1")

    # -- the main path: tiled serving ------------------------------------------
    engine = ServeEngine(model, params, sampler, table,
                         ServeConfig(max_batch=BATCH, record_dispatches=True))
    warm = engine.warmup()
    log(f"warmup: {json.dumps({str(b): round(t, 4) for b, t in warm.items()})}")
    engine.reset_stats()
    _kernels.reset_counts()
    served, wall = serve_phase(engine, trace, clients=4)
    counts = _kernels.counts()
    st = engine.stats
    check(st.requests == args.requests and len(served) == len(set(trace.tolist())),
          "not every request was answered")
    out = np.stack(list(served.values()))
    check(out.shape[1] == CLASSES and np.isfinite(out).all(), "served logits malformed")
    summary = {
        "requests": st.requests, "wall_s": wall, "qps": st.requests / wall,
        "latency": st.latency.snapshot(), "cache_hit_rate": st.cache.hit_rate, "coalesced": st.coalesced,
        "dispatches": st.dispatches, "dispatched_seeds": st.dispatched_seeds,
        "inflight_peak": st.inflight_peak, "launches": counts,
        "launches_per_flush": {k: v / max(st.dispatches, 1) for k, v in counts.items()},
        "overlap": st.spans.overlap_summary(),
    }
    log("serve: " + json.dumps(summary))
    for name in MAIN_PATH:
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    launches = dict(counts)
    replay_dev = replay_check(topo, model, params, table, engine, served, dev, 8, 0.0)
    replay_cpu = replay_check(topo, model, params, table, engine, served, "cpu", 2, 1e-3)
    log(f"replay: 8 dispatches on the card max |diff| {replay_dev} (bit-equal); "
        f"2 on the CPU plain path max |diff| {replay_cpu:.3g}")
    phase_done("serve")

    # -- the flat layout's path ------------------------------------------------
    flat = GraphSageSampler(topo, SIZES, device=dev, seed=args.seed, layout="flat")
    fengine = ServeEngine(model, params, flat, table, ServeConfig(max_batch=BATCH))
    fengine.warmup()
    _kernels.reset_counts()
    fserved, fwall = serve_phase(fengine, trace[: max(args.requests // 8, 64)], clients=2)
    fcounts = _kernels.counts()
    log("flat serve: " + json.dumps({"requests": fengine.stats.requests, "wall_s": fwall,
                                     "launches": fcounts}))
    for name in ("sample_flat", "local_reindex", "gather_rows", "masked_mean"):
        check(fcounts[name] > 0, f"kernel {name} never launched on the flat path")
    launches["sample_flat"] = fcounts["sample_flat"]
    phase_done("flat serve")
    del engine, fengine

    # -- the training slice ----------------------------------------------------
    strict_float32()
    table_np = table.cpu().numpy()
    resident, tiered = build_features(topo, table_np, dev)
    train_idx = np.random.default_rng(args.seed + 3).choice(topo.node_count, PRODUCTS_TRAIN,
                                                            replace=False)
    seeds_1024 = torch.from_numpy(train_idx[:TRAIN_BATCH].astype(np.int32)).to(dev)
    rate = kernel_phase_2(topo, table, tiered, seeds_1024, rows, args.seed)
    phase_done("kernels-2")
    full_inference_phase(topo, table, model, params)
    phase_done("full inference")
    train_counts = train_phase(topo, table, resident, tiered, train_idx, args.seed)
    phase_done("train")
    caps_phase(topo, resident, train_labels(topo.node_count, dev), train_idx, args.seed)
    phase_done("caps")
    learn_counts = learn_phase()
    phase_done("learn")
    for name in ("masked_mean_backward", "tiered_gather"):
        launches[name] = train_counts[name]
    launches["full_mean"] = learn_counts["full_mean"]

    # -- the staged pipeline over fp32, int8 and bf16 tables ------------------------
    budget = tiered.shard_tensor.tier_bytes()["device"]
    qtiered, qresident = build_quant_tables(topo, table_np, budget, dev)
    kernel_phase_3(topo, tiered, qtiered, qresident, seeds_1024, rows, rate, args.seed)
    phase_done("kernels-3")
    pipe_counts = pipeline_phase(topo, tiered, qtiered, qresident, train_idx, args.seed)
    phase_done("pipeline")
    for name in ("tiered_lookup", "gather_dequant", "quantized_tiered_lookup"):
        launches[name] = pipe_counts[name]
    del qtiered, qresident

    # -- the out-of-core slice: K6 and K11, then training through the disk tier ----
    kernel_phase_4(topo, tiered, train_idx, rows)
    phase_done("kernels-4")
    tier_counts, heat_order = tiers_phase(topo, table_np, train_idx, args.seed, dev)
    phase_done("tiers")
    for name in ("set_rows", "neighbor_prob"):
        launches[name] = tier_counts[name]

    # -- the weighted and temporal slice: K7, K8, K8w ------------------------------
    wtopo, ts_np = weighted_inputs(topo, args.seed)
    kernel_phase_6(topo, wtopo, ts_np, seeds_1024, rows)
    phase_done("kernels-6")
    t0 = time.perf_counter()
    tg = tile_build("timestamps", lambda: TemporalTiledGraph(topo, ts_np, device=dev))
    log(f"timestamp tiles on the card in {time.perf_counter() - t0:.1f} s")
    ttrace = temporal_trace(topo.node_count, args.requests, alpha=0.99, seed=args.seed + 31,
                            qps=TEMPORAL_QPS, t0=0.0)
    # a flush of 64 requests spread over the trace, so its query times span [0, TS_SPAN)
    spread = np.linspace(0, args.requests - 1, BATCH).astype(np.int64)
    tseeds = torch.from_numpy(ttrace.requests[spread].astype(np.int32)).to(dev)
    tvals = torch.from_numpy(np.float32([quantize_t(t, T_QUANTUM)
                                         for t in ttrace.t_query[spread]])).to(dev)
    kernel_phase_5(topo, wtopo, tg, ts_np, seeds_1024, tseeds, tvals, rows, args.seed)
    phase_done("kernels-5")
    w_counts = weighted_train_phase(wtopo, resident, train_labels(topo.node_count, dev),
                                    train_idx, args.seed)
    phase_done("weighted train")

    # -- fanouts above 32 on the card: K1, K2, K4, K4b, K7, K8 at k = 64 ----------------
    fanout_phase(topo, wtopo, tg, resident, train_labels(topo.node_count, dev), train_idx,
                 seeds_1024, args.seed)
    phase_done("fanout")

    # -- the model zoo slice: K14, K14b, K14c; GCN, GAT and bf16 training -----------
    kernel_phase_7(topo, seeds_1024, rows, args.seed)
    phase_done("kernels-7")
    zoo_counts = zoo_phase(topo, resident, train_labels(topo.node_count, dev), train_idx,
                           args.seed)
    phase_done("zoo")
    for name in ("gather_src", "gather_src_backward", "block_out_degree"):
        launches[name] = zoo_counts[name]
    del resident
    t_counts, k8w_launches = temporal_serve_phase(topo, tg, model, params, table, ttrace,
                                                  args.seed)
    phase_done("temporal serve")
    launches["weighted_sample_tiled"] = w_counts["tiled"]["weighted_sample_tiled"]
    launches["weighted_sample_flat"] = w_counts["flat"]["weighted_sample_flat"]
    launches["temporal_sample_tiled"] = t_counts["temporal_sample_tiled"]
    launches["recency_weights"] = k8w_launches  # building the recency weight tiles

    # -- the multi-device slice: K13a, K13b, K9c; (dp, ici) training on rank threads --
    mc = mc_setup(topo, table, train_idx, args.seed)
    k9c_counts = kernel_phase_8(topo, table, mc, seeds_1024, rows, args.seed)
    phase_done("kernels-8")
    mc_counts = multichip_phase(topo, table, train_labels(topo.node_count, dev), mc, args.seed)
    phase_done("multichip")
    for name in ("sharded_rows", "sharded_sample_tiled", "sharded_sample_flat"):
        launches[name] = mc_counts[name]
    launches["sharded_dequant"] = k9c_counts["sharded_dequant"]  # the ici group's encoded gather
    caps = mc["caps"]
    del mc
    multichip_learn_phase()
    phase_done("learn multichip")

    # -- the host axis: K13c, K13d, K13e; (host, dp, ici) training on rank threads ------
    host = host_setup(topo, table, train_idx, heat_order, caps, args.seed)
    kernel_phase_9(topo, table, host, rows, args.seed)
    phase_done("kernels-9")
    host_counts = host_phase(topo, table, train_labels(topo.node_count, dev), host, args.seed)
    phase_done("host")
    for name in ("grouped_unpack", "cold_compact", "cold_merge"):
        launches[name] = host_counts[name]
    del host
    torch.cuda.empty_cache()
    host_learn_phase()
    phase_done("learn host")

    # -- the fleet: routed serving over the serve exchange, K13f --------------------
    fleet_counts = fleet_phase(topo, table, model, params, trace, args.seed)
    phase_done("fleet")
    launches["exchange_rows"] = fleet_counts["exchange_rows"]
    kernel_phase_10(topo, table, trace, rows, args.seed)
    phase_done("kernels-10")
    launches["build_tiles"] = sum(b["launches"] for b in TILE_BUILDS)
    log("tiles: " + json.dumps({"tables_built": TILE_BUILDS,
                                "launches": launches["build_tiles"]}))

    log("redesign K4 K2: " + json.dumps(redesign_line()))
    log(f"every phase passed in {time.perf_counter() - t_run:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)

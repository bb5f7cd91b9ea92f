#!/usr/bin/env python3
"""K2 (the dedup reindex, ``csrc/reindex.cu``) at the shapes ``chip_smoke.py``
gives it on the products-shaped graph: the three hops of a B = 64 flush
and of one dedup sample of a batch of 1,024 at [15, 10, 5], uncapped and
cut to the caps ``calibrate_caps`` gives. Each call is checked bit-equal
to its plain version and to itself run twice.

    python3 scripts/torch_k2_shapes.py [--reps N] [--guard]

Needs one CUDA card. ``--reps N`` runs each hop N times (twice a rep).
``--guard`` also calls K2's C entry point directly on each hop with its
scratch filled with 0, with -1 and with random words (a word the kernel
reads before it writes it would change the outputs) and every output and
the scratch set between guard bands of 4,096 words (a write out of range
within them changes a guard word); both are held against the plain
version and checked after a synchronize.

Prints one line a hop and ``k2 shapes: N calls, bit-equal`` at the end;
exits 1 on a difference.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def same(a, b, valid) -> bool:
    return (torch.equal(a.n_id, b.n_id) and torch.equal(a.count, b.count)
            and torch.equal(a.local_seeds, b.local_seeds)
            and torch.equal(a.local_nbrs[valid], b.local_nbrs[valid]))


def make_cases(seed: int):
    """``[(tag, (cur, cur_valid, nbrs, valid))]`` for the flush's and the
    batch's hops, as chip_smoke's kernel and caps phases build them."""
    import chip_smoke as cs
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch import random as qrandom
    from quiver_tpu_torch.serve import zipfian_trace

    dev = torch.device("cuda")
    topo = cs.build_graph(1.0, seed)
    n = topo.node_count
    g_tiled = topo.to_device_tiled(dev)
    train_idx = np.random.default_rng(seed + 3).choice(n, cs.PRODUCTS_TRAIN, replace=False)
    seeds_1024 = torch.from_numpy(train_idx[:cs.TRAIN_BATCH].astype(np.int32)).to(dev)
    trace = zipfian_trace(n, 2000, alpha=0.99, seed=seed + 1)
    seeds_64 = torch.from_numpy(trace[:cs.BATCH].astype(np.int32)).to(dev)
    order = np.random.default_rng(seed + 40).permutation(train_idx)
    probes = order[:cs.CAP_PROBES * cs.TRAIN_BATCH].reshape(cs.CAP_PROBES, cs.TRAIN_BATCH)
    caps = GraphSageSampler(topo, cs.SIZES, device=dev, seed=seed + 41).calibrate_caps(
        probes, margin=cs.CAP_MARGIN, granule=cs.CAP_GRANULE)
    cases = []
    key = qrandom.fold_in(qrandom.key(1234), 0)
    for tag, s, k, c in (("flush", seeds_64, key, None),
                         ("batch uncapped", seeds_1024, qrandom.key(seed + 44), None),
                         ("batch capped", seeds_1024, qrandom.key(seed + 44), caps)):
        for i, h in enumerate(cs.hop_inputs(g_tiled, s, k, caps=c)[0]):
            cases.append((f"{tag} hop {i + 1}",
                          tuple(h[x].contiguous() for x in ("cur", "cur_valid", "nbrs", "valid"))))
    return cases


GUARD = 4096
GUARD_WORD = 0x5A5A5A5A


def guarded_call(args, fill: str):
    """K2 on ``args`` through its C entry point, the scratch prefilled with
    ``fill`` and every buffer between guard bands. Returns the outputs
    (n_id, count, local_seeds, local_nbrs) and whether every guard word
    held."""
    from quiver_tpu_torch import _kernels

    seeds, seed_valid, nbrs, nbr_valid = args
    S, k = nbrs.shape
    dev = seeds.device
    words = _kernels.local_reindex_scratch_words(S, k)
    gen = torch.Generator(device=dev).manual_seed(words)
    bufs = []

    def guarded(n):
        full = torch.full((n + 2 * GUARD,), GUARD_WORD, dtype=torch.int32, device=dev)
        bufs.append(full)
        return full[GUARD:GUARD + n]

    scratch = guarded(max(words, 1))
    if fill == "zero":
        scratch.zero_()
    elif fill == "ones":
        scratch.fill_(-1)
    else:
        scratch.copy_(torch.randint(-2**31, 2**31 - 1, scratch.shape, generator=gen,
                                    device=dev, dtype=torch.int64).to(torch.int32))
    n_id, count, local_seeds, local_nbrs = (guarded(S * (1 + k)), guarded(1), guarded(S),
                                            guarded(S * k))
    _kernels.launch("local_reindex", seeds.data_ptr(), seed_valid.data_ptr(), nbrs.data_ptr(),
                    nbr_valid.data_ptr(), S, k, scratch.data_ptr(), words, n_id.data_ptr(),
                    count.data_ptr(), local_seeds.data_ptr(), local_nbrs.data_ptr(),
                    _kernels.stream_of(seeds))
    torch.cuda.synchronize()
    held = all(bool((b[:GUARD] == GUARD_WORD).all()) and bool((b[-GUARD:] == GUARD_WORD).all())
               for b in bufs)
    return (n_id, count[0], local_seeds, local_nbrs.view(S, k)), held


def run_guarded(cases) -> int:
    from quiver_tpu_torch.ops import reindex

    n = 0
    for tag, args in cases:
        want = reindex.local_reindex_plain(*args)
        for fill in ("zero", "ones", "random"):
            (n_id, count, ls, ln), held = guarded_call(args, fill)
            n += 1
            ok = (torch.equal(n_id, want.n_id) and int(count) == int(want.count)
                  and torch.equal(ls, want.local_seeds)
                  and torch.equal(ln[args[3]], want.local_nbrs[args[3]]))
            if not (ok and held):
                print(f"k2 guard: {tag}, scratch {fill}: outputs equal {ok}, guards held {held}",
                      flush=True)
                return 1
    print(f"k2 guard: {n} calls (scratch 0, -1, random), bit-equal, every guard word held",
          flush=True)
    return 0


def run(cases, reps: int) -> int:
    from quiver_tpu_torch.ops import reindex

    n = 0
    for tag, args in cases:
        want = reindex.local_reindex_plain(*args)
        for _ in range(reps):
            got = reindex.local_reindex(*args)
            again = reindex.local_reindex(*args)
            torch.cuda.synchronize()
            n += 2
            if not (same(got, want, args[3]) and same(again, got, args[3])):
                print(f"k2 shapes: {tag} differs from its plain version or itself", flush=True)
                return 1
        S, k = args[2].shape
        print(f"k2 {tag}: S={S} k={k} valid_seeds={int(args[1].sum())} "
              f"count={int(got.count)} bit-equal x{reps}", flush=True)
    print(f"k2 shapes: {n} calls, bit-equal", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_shapes: no CUDA device", file=sys.stderr)
        return 2
    cases = make_cases(args.seed)
    rc = run(cases, args.reps)
    if args.guard and rc == 0:
        rc = run_guarded(cases)
    return rc


if __name__ == "__main__":
    sys.exit(main())

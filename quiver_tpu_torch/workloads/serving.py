"""Temporal and link-prediction serving — the port of
``quiver_tpu/workloads/serving.py`` (single host, fused only).

`TemporalServeEngine` is a `ServeEngine` whose requests carry a query
time ``t``: coalescing and the cache key by ``(node, t_bucket)`` under the
params version (two requests for one node at times in one ``t_quantum``
window share a computation; in two windows they do not), and each flush
dispatches the padded per-seed query times as one more argument of the
fused step (`inference.make_temporal_serve_step`), padded like the seeds
and logged beside them: every dispatch-log entry is ``(padded_seeds,
n_valid, padded_t)``, which `replay_temporal_log` replays through a fresh
sampler. ``submit_pair``/``predict_pairs`` score candidate edges through
`linkpred.LinkPredictor`.

Over a streaming temporal graph (`GraphSageSampler.bind_temporal` of a
`stream.StreamingTiledGraph` built with ``edge_ts=``) the engine takes the
base engine's graph commits: a committed edge is drawn by the next query
with ``t >= ts``, and ``stream_retention_window`` expires the edges a
commit's clock leaves behind.

Not ported yet: the routed temporal engine (``TemporalDistServeEngine`` in
``serve/dist.py``, which ROADMAP A16 leaves after the single-host training
half of ``parallel/``: it needs the host axis, ``comm.py``'s exchanges and
``DistFeature`` first) and the vectorised whole-batch admission (this
engine admits request by request, through the base engine's
`_admit_locked`, late admission included).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..inference import bind_params, forward_logits
from ..serve.engine import ServeConfig, ServeEngine, ServeResult
from .linkpred import LinkPredictor, PairHead, PairResult

__all__ = ["TemporalServeEngine", "quantize_t", "quantize_t_many", "replay_temporal_log"]


def quantize_t(t: float, quantum: float) -> float:
    """The t-bucketing rule of every cache and coalescing key:
    ``floor(t / quantum) * quantum`` snapped to the float32 grid (a query
    is served as of its bucket's floor, never seeing an edge from its
    future). ``quantum = 0`` keys exact times. A ``t`` float32-equal to a
    bucket value is that bucket (the nearest bucket is checked first, so a
    re-quantization returns its input bit for bit); any other ``t`` takes
    the plain floor. Non-finite ``t`` passes through."""
    t = float(t)
    if quantum <= 0 or not math.isfinite(t):
        return t
    x = t / quantum
    j = round(x)
    snapped = float(np.float32(j * quantum))
    if snapped == float(np.float32(t)):
        return snapped
    return float(np.float32(math.floor(x) * quantum))


def quantize_t_many(t, quantum: float) -> np.ndarray:
    """`quantize_t` over an array (float64 ``[n]``), element-wise equal
    to the scalar rule: ``np.rint`` is Python's half-to-even ``round``,
    the same float32 snap and nearest-bucket-first check, the same
    passthrough of non-finite values and ``quantum <= 0``."""
    tv = np.asarray(t, np.float64).reshape(-1).copy()
    if quantum <= 0:
        return tv
    finite = np.isfinite(tv)
    if not finite.any():
        return tv
    tf = tv[finite]
    x = tf / quantum
    j = np.rint(x)
    snapped = (j * quantum).astype(np.float32).astype(np.float64)
    t32 = tf.astype(np.float32).astype(np.float64)
    floored = (np.floor(x) * quantum).astype(np.float32).astype(np.float64)
    tv[finite] = np.where(snapped == t32, snapped, floored)
    return tv


def _aligned_t(t, n: int) -> np.ndarray:
    """Per-request float64 query times from a scalar, an array or None
    (``+inf``)."""
    if t is None:
        return np.full((n,), np.inf)
    tv = np.asarray(t, np.float64).reshape(-1)
    if tv.shape[0] == 1 and n != 1:
        tv = np.broadcast_to(tv, (n,)).copy()
    if tv.shape[0] != n:
        raise ValueError(f"t has {tv.shape[0]} entries for {n} requests")
    return tv


class TemporalServeEngine(ServeEngine):
    """`ServeEngine` over a temporal-bound sampler
    (`GraphSageSampler.bind_temporal`)::

        sampler = GraphSageSampler(topo, sizes, dedup=False, seed=SEED)
        sampler.bind_temporal(TemporalTiledGraph(topo, edge_ts), recency=0.02)
        eng = TemporalServeEngine(model, params, sampler, table,
                                  ServeConfig(max_batch=64), t_quantum=0.05)
        eng.warmup()
        row = eng.predict([node], t=now)[0]
        score = eng.submit_pair(u, v, t=now).result()

    ``t=None`` means no time bound (``t = +inf``). Fused only: the padded
    query times are an argument of the one step a flush runs."""

    _temporal_capable = True

    def __init__(self, model, params, sampler, feature, config: Optional[ServeConfig] = None,
                 t_quantum: float = 0.0, pair_head: Optional[PairHead] = None):
        if getattr(sampler, "temporal", None) is None:
            raise TypeError("TemporalServeEngine needs a temporal-bound sampler "
                            "(GraphSageSampler.bind_temporal)")
        self.t_quantum = float(t_quantum)
        self.pair_head = pair_head or PairHead("dot")
        self._lp: Optional[LinkPredictor] = None
        super().__init__(model, params, sampler, feature, config)
        if self._programs is None:
            raise ValueError("temporal serving is fused-only (dispatch_mode='split' or a "
                             "feature without an in-step gather cannot carry the query times)")

    # -- request path: (node, t_bucket) keys -----------------------------------

    def submit(self, node_id: int, t: Optional[float] = None) -> ServeResult:
        """`ServeEngine.submit` with the request keyed by ``(node,
        quantize_t(t))``."""
        return self.submit_many((node_id,), t=None if t is None else (t,))[0]

    def submit_many(self, node_ids, t=None):
        """Admit requests in order under ``(node, t_bucket)`` keys; ``t``
        is None (``+inf``), a scalar, or aligned with ``node_ids``."""
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        tq = quantize_t_many(_aligned_t(t, ids.shape[0]), self.t_quantum)
        return self._submit_keyed_many(list(zip(ids.tolist(), tq.tolist())))

    # -- flush hooks --------------------------------------------------------

    def _flush_arrays(self, fl):
        nodes = np.asarray([k[0] for k in fl.keys], np.int64)
        ts = np.asarray([k[1] for k in fl.keys], np.float32)
        return nodes, (ts,)

    def _dispatch_log_entry(self, fl, padded):
        return (padded.copy(), len(fl.keys), fl.extra[0].copy())

    # -- link prediction ----------------------------------------------------

    def _linkpred(self) -> LinkPredictor:
        if self._lp is None or self._lp.head is not self.pair_head:
            self._lp = LinkPredictor(self, self.pair_head)
        return self._lp

    def submit_pair(self, u: int, v: int, t: Optional[float] = None) -> PairResult:
        """Score candidate edge ``(u, v)`` as of ``t``: two lookups through
        the coalescer and cache (an endpoint coalesces with any request for
        the same ``(node, t_bucket)``), combined by `pair_head`."""
        return self._linkpred().submit_pair(u, v, t=t)

    def predict_pairs(self, pairs, t=None, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking: ``[P]`` float32 scores of ``[P, 2]`` pairs in request
        order."""
        return self._linkpred().predict_pairs(pairs, t=t, timeout=timeout)


def replay_temporal_log(log, model, params, sampler, feature,
                        served: Optional[Dict] = None) -> Dict:
    """Replay a temporal dispatch log (entries ``(padded_seeds, n_valid,
    padded_t)``) through a fresh temporal-bound ``sampler`` with the
    serving sampler's seed, then the offline gather and forward. Returns
    ``{(node, t): [candidate rows]}`` with ``t`` the float32 query time
    the dispatch carried; a served row is right iff it equals one of its
    key's candidates."""
    m = bind_params(model, params, sampler.device)
    served = {} if served is None else served
    for padded, nvalid, tvec in log:
        ds = sampler.sample_dense(padded, t=tvec)
        logits = forward_logits(m, feature, ds).cpu().numpy()
        for i in range(nvalid):
            served.setdefault((int(padded[i]), float(np.float32(tvec[i]))), []).append(logits[i])
    return served

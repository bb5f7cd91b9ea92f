"""Link-prediction serving — the port of
``quiver_tpu/workloads/linkpred.py`` (the retrieval workload).

Scoring a candidate edge ``(u, v)`` is two node lookups through the serve
engine's own path (coalescer, cache, micro-batcher) and a small head over
the two logits rows: a pair whose endpoints are cached costs no device
work, and an endpoint shared with another request coalesces onto it.
`PairHead` is a pure function of the two rows and its parameters, so a
pair's score replays from the dispatch logs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["LinkPredictor", "PairHead", "PairResult"]


class PairHead:
    """The pair scoring head: ``score(h_u, h_v) -> [P]`` probabilities.

    ``mode="dot"``: ``sigmoid(<h_u, h_v>)``, no parameters. ``mode="mlp"``:
    a 2-layer scorer over ``[h_u, h_v, h_u*h_v]`` with ``hidden`` units,
    its weights drawn once from ``seed`` (numpy, so the same seed gives the
    same head on every machine) or given as ``params`` (``{"w1" [3*dim,
    hidden], "b1", "w2" [hidden, 1], "b2"}``, e.g.
    `convert.pair_head_params_from_jax` of the JAX package's head).
    Scoring runs on the host in float32 torch; same rows and parameters
    give bit-equal scores."""

    def __init__(self, mode: str = "dot", dim: Optional[int] = None, hidden: int = 32,
                 seed: int = 0, params: Optional[Dict[str, torch.Tensor]] = None):
        if mode not in ("dot", "mlp"):
            raise ValueError(f"unknown PairHead mode {mode!r}")
        self.mode = mode
        self.dim = None if dim is None else int(dim)
        self.hidden = int(hidden)
        self.seed = int(seed)
        self.params = None
        if mode == "mlp":
            if dim is None:
                raise ValueError("PairHead('mlp') needs dim= (engine out_dim)")
            d_in = 3 * self.dim
            if params is None:
                rng = np.random.default_rng(self.seed)
                params = {
                    "w1": rng.standard_normal((d_in, self.hidden)) / np.sqrt(d_in),
                    "b1": np.zeros(self.hidden),
                    "w2": rng.standard_normal((self.hidden, 1)) / np.sqrt(self.hidden),
                    "b2": np.zeros(1),
                }
            self.params = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in params.items()}
            if tuple(self.params["w1"].shape) != (d_in, self.hidden):
                raise ValueError(f"w1 must be [{d_in}, {self.hidden}]; "
                                 f"got {tuple(self.params['w1'].shape)}")

    def score(self, h_u, h_v) -> np.ndarray:
        """``[P]`` float32 scores for stacked endpoint rows ``[P, C]``."""
        h_u = torch.from_numpy(np.array(h_u, np.float32))  # a copy: served rows are read-only
        h_v = torch.from_numpy(np.array(h_v, np.float32))
        if h_u.shape != h_v.shape or h_u.dim() != 2:
            raise ValueError(f"PairHead.score wants matched [P, C] rows; got "
                             f"{tuple(h_u.shape)} / {tuple(h_v.shape)}")
        if h_u.shape[0] == 0:
            return np.zeros((0,), np.float32)
        with torch.inference_mode():
            if self.mode == "dot":
                return torch.sigmoid((h_u * h_v).sum(dim=-1)).numpy()
            p = self.params
            x = torch.cat([h_u, h_v, h_u * h_v], dim=-1)
            h = torch.relu(x @ p["w1"] + p["b1"])
            return torch.sigmoid(h @ p["w2"] + p["b2"])[:, 0].numpy()


class PairResult:
    """Handle of one submitted ``(u, v)`` pair: the two endpoint handles,
    scored through the head on demand."""

    __slots__ = ("_u", "_v", "_head")

    def __init__(self, u_result, v_result, head: PairHead):
        self._u = u_result
        self._v = v_result
        self._head = head

    def done(self) -> bool:
        return self._u.done() and self._v.done()

    def error(self) -> Optional[BaseException]:
        """The first endpoint error, if any."""
        return self._u.error() or self._v.error()

    def rows(self, timeout: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """The two endpoint logits rows (blocks; raises an endpoint's
        error). Read-only: shared with the cache and co-waiters."""
        return self._u.result(timeout), self._v.result(timeout)

    def result(self, timeout: Optional[float] = None) -> float:
        """The pair score."""
        hu, hv = self.rows(timeout)
        return float(self._head.score(hu[None], hv[None])[0])


class LinkPredictor:
    """Pair serving over a serve engine: ``submit_pair`` submits both
    endpoints through the engine's submit path, ``predict_pairs`` scores a
    whole batch in one head call. A temporal engine takes a per-pair ``t``
    (both endpoints looked up as of it); a plain engine refuses one."""

    def __init__(self, engine, head: Optional[PairHead] = None):
        self.engine = engine
        self.head = head or PairHead("dot")
        self._temporal = hasattr(engine, "t_quantum")

    def submit_pair(self, u: int, v: int, t: Optional[float] = None) -> PairResult:
        if self._temporal:
            hu = self.engine.submit(int(u), t=t)
            hv = self.engine.submit(int(v), t=t)
        else:
            if t is not None:
                raise TypeError("t= needs a temporal engine (workloads.TemporalServeEngine)")
            hu = self.engine.submit(int(u))
            hv = self.engine.submit(int(v))
        return PairResult(hu, hv, self.head)

    def predict_pairs(self, pairs, t=None, timeout: Optional[float] = None) -> np.ndarray:
        """Scores of ``[P, 2]`` pairs in request order; ``t`` scalar or
        ``[P]`` (temporal engines). Blocking; flushes inline when no
        background flusher runs."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        p = pairs.shape[0]
        tv = None
        if t is not None:
            tv = np.asarray(t, np.float64).reshape(-1)
            if tv.shape[0] == 1 and p != 1:
                tv = np.broadcast_to(tv, (p,))
            if tv.shape[0] != p:
                raise ValueError(f"t has {tv.shape[0]} entries for {p} pairs")
        handles = [self.submit_pair(u, v, t=None if tv is None else float(tv[i]))
                   for i, (u, v) in enumerate(pairs)]
        if not handles:
            return np.zeros((0,), np.float32)
        self.engine.flush_inline(lambda: all(h.done() for h in handles))
        hu = np.stack([h._u.result(timeout) for h in handles])
        hv = np.stack([h._v.result(timeout) for h in handles])
        return self.head.score(hu, hv)

"""Datasets — the port's own copy of ``quiver_tpu/datasets.py``
(``load_npz``, ``_powerlaw_csr_arrays``, ``powerlaw_csr``,
``synthetic_powerlaw``, ``products_like``): same seeds, same arrays."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# ogbn-products scale (OGB reference numbers)
PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140, feat_dim=100, classes=47,
                train_nodes=196_615)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Load a dataset the user exported: {edge_index [2,E], features
    [N,D], labels [N], train_idx [T], (optional valid_idx/test_idx)}.
    Nothing is downloaded."""
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    for k in ("edge_index", "features", "labels", "train_idx"):
        if k not in out:
            raise ValueError(f"dataset {path} missing required array {k!r}")
    return out


def _powerlaw_csr_arrays(n_nodes, n_edges, alpha, seed, max_deg_frac):
    """(indptr, indices, rng) of a power-law graph, built in CSR order."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, n_nodes) + 1.0
    raw = np.minimum(raw, raw.sum() * max_deg_frac)  # clip mega-hubs
    deg = np.maximum((raw / raw.sum() * n_edges).astype(np.int64), 1)
    diff = int(deg.sum() - n_edges)
    if diff > 0:
        idx = rng.choice(n_nodes, diff, replace=True, p=deg / deg.sum())
        np.subtract.at(deg, idx, 1)
        deg = np.maximum(deg, 0)
    elif diff < 0:
        idx = rng.integers(0, n_nodes, -diff)
        np.add.at(deg, idx, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    # degree-proportional destinations via inverse-CDF on the degree mass
    cdf = np.cumsum(deg.astype(np.float64))
    cdf /= cdf[-1]
    e = int(indptr[-1])
    indices = np.searchsorted(cdf, rng.random(e), side="right").astype(np.int64)
    np.minimum(indices, n_nodes - 1, out=indices)
    return indptr, indices, rng


def powerlaw_csr(n_nodes: int, n_edges: int, alpha: float = 1.35, seed: int = 0,
                 max_deg_frac: float = 0.01):
    """CSR arrays of a products-like power-law graph, no edge list built."""
    indptr, indices, _ = _powerlaw_csr_arrays(n_nodes, n_edges, alpha, seed, max_deg_frac)
    return indptr, indices


def synthetic_powerlaw(n_nodes: int, n_edges: int, alpha: float = 1.35, dim: int = 0,
                       classes: int = 0, train_frac: float = 0.08, seed: int = 0,
                       max_deg_frac: float = 0.01, label_signal: float = 1.5):
    """Power-law graph with products-like degree skew (out-degree
    Pareto(alpha), destinations degree-proportional). Returns
    ``(edge_index [2,E], features [N,dim] or None, labels [N] or None,
    train_idx)``."""
    indptr, dst, rng = _powerlaw_csr_arrays(n_nodes, n_edges, alpha, seed, max_deg_frac)
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    edge_index = np.stack([src, dst])
    features = labels = None
    if dim:
        features = rng.standard_normal((n_nodes, dim)).astype(np.float32)
    if classes:
        labels = rng.integers(0, classes, n_nodes).astype(np.int32)
        if dim:
            basis = rng.standard_normal((classes, dim)).astype(np.float32)
            features += basis[labels] * label_signal
    train_idx = rng.choice(n_nodes, max(int(n_nodes * train_frac), 1), replace=False)
    return edge_index, features, labels, train_idx


def products_like(scale: float = 1.0, dim: Optional[int] = None,
                  classes: Optional[int] = None, seed: int = 0):
    """products-shaped graph at ``scale`` (1.0 = 2.45M nodes / 61.9M
    edges)."""
    n = max(int(PRODUCTS["n_nodes"] * scale), 10)
    e = max(int(PRODUCTS["n_edges"] * scale), 20)
    return synthetic_powerlaw(
        n, e,
        dim=PRODUCTS["feat_dim"] if dim is None else dim,
        classes=PRODUCTS["classes"] if classes is None else classes,
        train_frac=PRODUCTS["train_nodes"] / PRODUCTS["n_nodes"],
        seed=seed,
    )

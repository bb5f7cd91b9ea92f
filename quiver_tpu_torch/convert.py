"""Carry weights from the JAX package to the port: the flax parameter trees
of GraphSAGE (`sage_params_from_flax`), GCN (`gcn_params_from_flax`) and
GAT (`gat_params_from_flax`), and the link-prediction head's parameters
(`pair_head_params_from_jax`). Takes numpy arrays (or anything
``np.asarray`` accepts), so it imports no flax or jax."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tree(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _kernel(dense: Mapping) -> torch.Tensor:
    """A flax ``kernel [in, out]`` as a torch Linear weight ``[out, in]``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))


def _array(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layers(p: Mapping, prefix: str):
    """The layer subtrees ``prefix{0}``, ``prefix{1}``, ... in order."""
    out = []
    while f"{prefix}{len(out)}" in p:
        out.append(p[f"{prefix}{len(out)}"])
    if not out:
        raise ValueError(f"no {prefix}{{i}} layers in the parameter tree")
    return out


def sage_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` of `models.GraphSAGE` from a flax tree
    ``{"params": {"conv{i}": {"lin_l": {"kernel", "bias"}, "lin_r":
    {"kernel"}}}}``. A flax ``kernel`` is ``[in, out]``; a torch Linear
    weight is ``[out, in]``."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(_layers(_tree(params), "conv")):
        pre = f"convs.{i}."
        out[pre + "lin_l.weight"] = _kernel(layer["lin_l"])
        if "bias" in layer["lin_l"]:
            out[pre + "lin_l.bias"] = _array(layer["lin_l"]["bias"])
        out[pre + "lin_r.weight"] = _kernel(layer["lin_r"])
    return out


def gcn_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` of `models.GCN` from a flax tree ``{"params":
    {"conv{i}": {"lin": {"kernel", "bias"}}}}``."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(_layers(_tree(params), "conv")):
        out[f"convs.{i}.lin.weight"] = _kernel(layer["lin"])
        if "bias" in layer["lin"]:
            out[f"convs.{i}.lin.bias"] = _array(layer["lin"]["bias"])
    return out


def gat_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` of `models.GAT` from a flax tree ``{"params":
    {"gat{i}": {"lin": {"kernel"}, "att_src" [1, H, D], "att_dst" [1, H,
    D]}}}``."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(_layers(_tree(params), "gat")):
        out[f"convs.{i}.lin.weight"] = _kernel(layer["lin"])
        out[f"convs.{i}.att_src"] = _array(layer["att_src"])
        out[f"convs.{i}.att_dst"] = _array(layer["att_dst"])
    return out


def pair_head_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``params`` of `workloads.PairHead` ("mlp") from the JAX
    package's ``PairHead.params`` (``{"w1" [3*dim, hidden], "b1"
    [hidden], "w2" [hidden, 1], "b2" [1]}``; both heads compute ``x @ w1
    + b1``, so no transpose)."""
    missing = {"w1", "b1", "w2", "b2"} - set(params)
    if missing:
        raise ValueError(f"pair-head params lack {sorted(missing)}")
    return {k: _array(params[k]) for k in ("w1", "b1", "w2", "b2")}

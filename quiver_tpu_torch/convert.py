"""Carry weights from the JAX package to the port: GraphSAGE's flax
parameter tree (`sage_params_from_flax`) and the link-prediction head's
parameters (`pair_head_params_from_jax`). Takes numpy arrays (or anything
``np.asarray`` accepts), so it imports no flax or jax."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def sage_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` of `models.GraphSAGE` from a flax tree
    ``{"params": {"conv{i}": {"lin_l": {"kernel", "bias"}, "lin_r":
    {"kernel"}}}}``. A flax ``kernel`` is ``[in, out]``; a torch Linear
    weight is ``[out, in]``."""
    p = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}" in p:
        layer = p[f"conv{i}"]
        pre = f"convs.{i}."
        out[pre + "lin_l.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["lin_l"]["kernel"], np.float32).T))
        if "bias" in layer["lin_l"]:
            out[pre + "lin_l.bias"] = torch.from_numpy(
                np.asarray(layer["lin_l"]["bias"], np.float32).copy())
        out[pre + "lin_r.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["lin_r"]["kernel"], np.float32).T))
        i += 1
    if i == 0:
        raise ValueError("no conv{i} layers in the parameter tree")
    return out


def pair_head_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``params`` of `workloads.PairHead` ("mlp") from the JAX
    package's ``PairHead.params`` (``{"w1" [3*dim, hidden], "b1"
    [hidden], "w2" [hidden, 1], "b2" [1]}``; both heads compute ``x @ w1
    + b1``, so no transpose)."""
    missing = {"w1", "b1", "w2", "b2"} - set(params)
    if missing:
        raise ValueError(f"pair-head params lack {sorted(missing)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32))
            for k in ("w1", "b1", "w2", "b2")}

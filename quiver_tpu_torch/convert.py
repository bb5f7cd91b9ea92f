"""Carry GraphSAGE weights from the JAX package's flax parameter tree to
the port's modules. Takes numpy arrays (or anything ``np.asarray``
accepts), so it imports no flax."""

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

"""Pickle reducers that hand features and samplers to other processes —
the port of ``quiver_tpu/multiprocessing``. Importing the package installs
them on ``multiprocessing.reduction.ForkingPickler`` (`init_reductions`)."""

from .reductions import (
    init_reductions,
    rebuild_feature,
    rebuild_pyg_sampler,
    reduce_feature,
    reduce_pyg_sampler,
)

init_reductions()

__all__ = ["init_reductions", "rebuild_feature", "rebuild_pyg_sampler", "reduce_feature",
           "reduce_pyg_sampler"]

"""Checkpoint and resume of training state — the port of
``quiver_tpu/checkpoint.py`` (``CheckpointManager``,
``save_partition_artifacts``, ``load_partition_artifacts``) on
``torch.save`` instead of orbax.

A checkpoint is one file per step, ``step_<step>.pt`` in the manager's
directory, holding the state dict given to `CheckpointManager.save` (e.g.
``{"model": model.state_dict(), "optimizer": optimizer.state_dict()}``).
Torch state is updated in place by later steps, so `save` copies every
tensor to the host on the caller's thread before it returns; the write
itself runs on a background thread, to a temporary name renamed into
place, so a reader never sees half a file.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_NAME = re.compile(r"step_(\d+)\.pt")


def _to_host(state):
    """A copy of ``state`` with every tensor detached and copied to the CPU."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


class CheckpointManager:
    """Step-keyed checkpoints in ``directory``, keeping the newest
    ``max_to_keep``::

        mgr = CheckpointManager("/tmp/run1", max_to_keep=3)
        mgr.save(step, {"model": model.state_dict(), "optimizer": opt.state_dict()})
        state = mgr.restore()           # the latest, or restore(step)
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._writer = concurrent.futures.ThreadPoolExecutor(1, "qt-checkpoint")
        self._pending: List[concurrent.futures.Future] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint file, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory))
                      if m)

    def _write(self, step: int, state) -> None:
        tmp = self._path(step) + f".tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def save(self, step: int, state: Dict[str, Any], wait: bool = True) -> None:
        """Save ``state`` (nested dicts, lists and tuples of tensors and
        plain values) as step ``step``. The tensors are copied to the host
        before this returns; with ``wait=False`` the file is written in the
        background (`flush` waits for it and raises its error)."""
        fut = self._writer.submit(self._write, int(step), _to_host(state))
        self._pending.append(fut)
        if wait:
            self.flush()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at ``step`` (default: the latest), its tensors on
        ``map_location`` (default: the CPU)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location=map_location or "cpu",
                          weights_only=True)

    def flush(self) -> None:
        """Block until every background save is on disk; re-raises the first
        save's error."""
        pending, self._pending = self._pending, []
        errors = []
        for fut in pending:  # wait for every save before raising
            try:
                fut.result()
            except Exception as exc:  # noqa: BLE001 — the first is re-raised below
                errors.append(exc)
        if errors:
            raise errors[0]

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._writer.shutdown(wait=True)


def save_partition_artifacts(path: str, **arrays) -> None:
    """Persist offline artifacts (partition books, orders, a preprocessed
    CSR) as one ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_partition_artifacts(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return {k: data[k] for k in data.files}

"""Checkpoint / resume of solver state (port of
``naviflow_tpu/io/checkpoint.py``).

Long runs checkpoint ``(u, v, p, iteration, residual histories)`` and
resume from them.  The JAX package writes orbax PyTree directories; orbax
needs JAX, so here each checkpoint directory holds one ``torch.save``
file of CPU tensors (the histories and metadata as tensors too), which
``torch.load(..., weights_only=True)`` reads back bit for bit.  The
directory layout (``step_{iteration:08d}``), the pruning to ``keep`` and
the reseeding from existing ``step_*`` directories are the JAX module's.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..core.state import FlowState, resolve_device

_FILE = "state.pt"


def _cpu_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    return torch.from_numpy(np.array(x))


def save_checkpoint(path: str, state: FlowState, iteration: int = 0,
                    histories: Optional[dict] = None, metadata: Optional[dict] = None):
    """Write a checkpoint directory (replacing one already at ``path``);
    returns its absolute path."""
    payload = {
        "u": _cpu_tensor(state.u),
        "v": _cpu_tensor(state.v),
        "p": _cpu_tensor(state.p),
        "iteration": torch.tensor(iteration, dtype=torch.int64),
        "histories": {k: _cpu_tensor(val) for k, val in (histories or {}).items()},
        "metadata": {k: _cpu_tensor(val) for k, val in (metadata or {}).items()},
    }
    path = os.path.abspath(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(payload, os.path.join(path, _FILE))
    return path


def load_checkpoint(path: str, device="cuda"):
    """Read a checkpoint; returns (FlowState on ``device``, iteration,
    histories, metadata), the last two dicts of CPU tensors.  ``device``
    is the card by default (raises where there is none), ``'cpu'`` for
    the CPU."""
    device = resolve_device(device, "load_checkpoint")
    payload = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu",
                         weights_only=True)
    state = FlowState(
        u=payload["u"].to(device),
        v=payload["v"].to(device),
        p=payload["p"].to(device),
    )
    return (
        state,
        int(payload["iteration"]),
        payload.get("histories", {}),
        payload.get("metadata", {}),
    )


class CheckpointManager:
    """Periodic checkpointing helper for host-driven solve loops."""

    def __init__(self, directory: str, every: int = 100, keep: int = 2):
        self.directory = directory
        self.every = every
        self.keep = keep
        # seed from existing step_* dirs so pruning keeps working (and the
        # keep-window stays bounded) across resumed runs
        self._saved = []
        if os.path.isdir(directory):
            self._saved = [
                os.path.join(directory, d)
                for d in sorted(os.listdir(directory))
                if d.startswith("step_")
            ]

    def maybe_save(self, state: FlowState, iteration: int, histories=None):
        if self.every <= 0 or iteration % self.every:
            return None
        path = os.path.join(self.directory, f"step_{iteration:08d}")
        save_checkpoint(path, state, iteration, histories)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            shutil.rmtree(self._saved.pop(0), ignore_errors=True)
        return path

    def latest(self) -> Optional[str]:
        if self._saved:
            return self._saved[-1]
        if os.path.isdir(self.directory):
            steps = sorted(
                d for d in os.listdir(self.directory) if d.startswith("step_")
            )
            if steps:
                return os.path.join(self.directory, steps[-1])
        return None

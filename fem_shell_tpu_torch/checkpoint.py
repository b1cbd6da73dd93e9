"""Checkpoint / resume for coupled runs.

The reference keeps only preCICE *iteration* checkpoints, which are
deliberate no-ops because the structure solver is quasi-static
(fem-shell_precice.cpp:259-265, 325-330); the only evolving state is the
previous-timestep solution ``preSols`` and the step counter. This module
persists exactly that state (plus interface forces) so long coupled runs
can stop and resume — a capability the reference lacks entirely.

Format: a single .npz per checkpoint, written atomically.

A copy of ``fem_shell_tpu/checkpoint.py``: host numpy, the same files.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CoupledState:
    timestep: int
    time: float
    pre_sols: np.ndarray  # [N, 6]
    iface_forces: np.ndarray  # [n_iface, dims]

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # suffix must end in .npz or np.savez silently appends it
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        np.savez(
            tmp,
            timestep=np.int64(self.timestep),
            time=np.float64(self.time),
            pre_sols=self.pre_sols,
            iface_forces=self.iface_forces,
        )
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "CoupledState":
        with np.load(path) as z:
            return CoupledState(
                timestep=int(z["timestep"]),
                time=float(z["time"]),
                pre_sols=z["pre_sols"],
                iface_forces=z["iface_forces"],
            )


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix) : -4]))
    return os.path.join(directory, cands[-1])

"""Flagship model wrapper: a 'forward step' view of the shell solver, for
harnesses that expect (fn, example_args) entry points. Port of
``fem_shell_tpu/models/shell.py``.

The 'model' of this framework is the linear shell boundary-value problem;
its 'forward step' is assemble+solve: forces -> displacements given node
coordinates. ``fn`` is a plain callable (PyTorch runs eagerly; there is
no jit to hand it to); ``ShellSystem._solve_pcg_impl(...,
differentiable=True)`` gives the load and shape sensitivities.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.system import ShellSystem


def make_plate_system(
    n: int = 16,
    elem_type: str = "q",
    dtype=torch.float32,
    material: Material | None = None,
    device=None,
) -> Tuple[ShellSystem, np.ndarray]:
    """Reference Test-D/G style simply-supported plate under uniform load.
    ``device`` defaults to CUDA; pass ``"cpu"`` to run on the host."""
    material = material or Material(nu=0.3, em=1e7, thickness=0.5)
    p = MeshGenParams(
        elem_type, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, elem_type == "q", "z"
    )
    mesh, rows, fac = generate(p)
    return ShellSystem(mesh, material, dtype=dtype, device=device), (rows * fac)


def forward_step_fn(system: ShellSystem, rtol: float = 1e-6, maxiter: int = 500):
    """fn(coords, forces) -> displacements for the given system."""

    def fn(coords, forces):
        x, _ = system._solve_pcg_impl(coords, forces, rtol, maxiter)
        return x

    return fn

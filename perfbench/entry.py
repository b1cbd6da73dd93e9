"""The program under test, driven as a traffic mix names it.

A mix's ``entry`` block (and its ``control`` block, which overrides keys
of it) names:

- ``class``: the dotted path of a solver class of ``fem_shell_tpu_torch``;
- ``args``: its constructor's keyword arguments beside the mesh, the
  material and ``device`` (``dtype`` as a name: ``"float64"``);
- ``solve``: the method that takes one [N, 6] force field and returns the
  [N, 6] displacements; ``solve_args`` its keyword arguments (the
  tolerance);
- ``iters``: the attribute path of the CG iterations of the last solve;
- ``warmup``: solves run in set-up, before the window.

The benchmark gives the program the mesh as a ``ShellMesh`` built from
its own arrays, the constrained dofs as the mesh's node mask, and the
material; everything else the program derives itself.
"""
from __future__ import annotations

import importlib
import operator

import numpy as np
import torch

PROGRAM = "fem_shell_tpu_torch"


def spec_of(mix: dict, control: bool = False) -> dict:
    spec = dict(mix["entry"])
    if control:
        spec.update(mix["control"])
    return spec


def program_mesh(plate):
    from fem_shell_tpu_torch.mesh import XDA_QUAD4, XDA_TRI3, ShellMesh

    e, m = plate.conn.shape
    conn4 = np.full((e, 4), -1, dtype=np.int32)
    conn4[:, :m] = plate.conn
    types = np.full(e, XDA_TRI3 if m == 3 else XDA_QUAD4, dtype=np.int32)
    return ShellMesh(plate.coords, types, conn4, np.zeros((0, 3), np.int32),
                     node_dirichlet_mask=plate.fixed)


def _kwargs(args: dict) -> dict:
    return {k: getattr(torch, v) if k == "dtype" else v for k, v in args.items()}


def build(spec: dict, plate, material: dict, device):
    from fem_shell_tpu_torch import Material

    path, _, name = spec["class"].rpartition(".")
    if path.split(".")[0] != PROGRAM:
        raise ValueError(f"entry class {spec['class']!r} is not of {PROGRAM}")
    cls = getattr(importlib.import_module(path), name)
    mat = Material(nu=material["nu"], em=material["em"], thickness=material["thickness"])
    return cls(program_mesh(plate), mat, device=device, **_kwargs(spec.get("args", {})))


def solve(system, spec: dict, forces: torch.Tensor):
    """(u [N, 6], CG iterations) of one load case."""
    u = getattr(system, spec["solve"])(forces, **spec.get("solve_args", {}))
    return u, int(operator.attrgetter(spec["iters"])(system))

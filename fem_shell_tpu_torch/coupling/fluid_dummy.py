"""Dummy fluid solver — the ``FluidSolver`` analog (fluid_solver.cpp:24-247).

The coupling counter-participant for testing: a hard-coded bending-tower
interface grid (left edge 21 nodes at x=3.0, right edge 21 at x=3.25, tip
at (3.125, 2.0); fluid_solver.cpp:95-121) and the synthetic force
``fx = 1 + sin(t / 25.01)`` on the left edge (:190-195). Lets the full
handshake + implicit-coupling machinery run without a real CFD code.

A copy of ``fem_shell_tpu/coupling/fluid_dummy.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from fem_shell_tpu_torch.coupling.api import (
    Participant,
    action_read_iteration_checkpoint,
    action_write_initial_data,
    action_write_iteration_checkpoint,
)
from fem_shell_tpu_torch.coupling.m2n import Transport


def tower_grid(dims: int = 2) -> np.ndarray:
    """The 43-node tower outline (fluid_solver.cpp:95-121)."""
    pts = []
    for k in range(21):  # left edge
        pts.append((3.0, k * 0.1))
    for k in range(21):  # right edge
        pts.append((3.25, k * 0.1))
    pts.append((3.125, 2.0))  # tip
    g = np.array(pts, dtype=np.float64)
    if dims == 3:
        g = np.hstack([g, np.zeros((len(g), 1))])
    return g


def run_fluid(
    config,
    grid: Optional[np.ndarray] = None,
    transport: Optional[Transport] = None,
    solver_name: str = "FLUID",
    on_timestep: Optional[Callable[[int, np.ndarray], None]] = None,
    max_timesteps: Optional[int] = None,
):
    """Execute the dummy fluid until the coupling ends. Returns the list of
    per-timestep interface displacement arrays."""
    interface = Participant(solver_name, config, 0, 1, transport=transport)
    dims = interface.get_dimensions()
    if grid is None:
        grid = tower_grid(dims)
    n = len(grid)

    mesh_id = interface.get_mesh_id("Fluid_Nodes")
    displ_id = interface.get_data_id("Displacements", mesh_id)
    force_id = interface.get_data_id("Stresses", mesh_id)
    vertex_ids = interface.set_mesh_vertices(mesh_id, grid)

    interface.initialize()
    f = np.zeros((n, dims))
    d = np.ones((n, dims))
    if interface.is_action_required(action_write_initial_data()):
        interface.write_block_vector_data(force_id, vertex_ids, f)
        interface.fulfilled_action(action_write_initial_data())
    interface.initialize_data()
    if interface.is_read_data_available():
        d = interface.read_block_vector_data(displ_id, vertex_ids)

    t = 0
    history = []
    while interface.is_coupling_ongoing():
        if interface.is_action_required(action_write_iteration_checkpoint()):
            interface.fulfilled_action(action_write_iteration_checkpoint())

        # "magic" forces on the left tower edge (fluid_solver.cpp:190-195)
        f[:21, 0] = 1.0 + np.sin(t / 25.01)

        interface.write_block_vector_data(force_id, vertex_ids, f)
        interface.advance(0.01)
        d = interface.read_block_vector_data(displ_id, vertex_ids)

        if interface.is_action_required(action_read_iteration_checkpoint()):
            interface.fulfilled_action(action_read_iteration_checkpoint())  # iterate
        else:
            history.append(d.copy())
            if on_timestep is not None:
                on_timestep(t, d)
            t += 1
            if max_timesteps is not None and t >= max_timesteps:
                break
    interface.finalize()
    return history

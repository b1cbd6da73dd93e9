"""Coupled structure solver — the ``FEM-shell-precice`` analog
(fem-shell_precice.cpp:18-419).

Runs the shell solver inside an implicit coupling loop: discovers the
coupling interface from boundary ids {2, 20, 21}
(fem-shell_precice.cpp:62-70), registers interface vertices with dead-axis
handling (:89-145), exchanges delta displacements / forces per coupling
iteration (:282-323 — including the forces-read-at-end-of-iteration lag),
and writes per-timestep output with displaced geometry (:377-408).

Port of ``fem_shell_tpu/coupling/adapter.py``, the one module of the
coupling package that touches the device: the structure solve is the
port's ``ShellSystem`` (f64, block-Jacobi PCG) on ``device``, assembled
and factored once per run; with ``devices > 1`` it is the sharded
``parallel.sharded.ShardedShellSystem`` (Jacobi PCG) over one mesh of
ranks that lives for the run and is closed at its end, the analog of the
reference's MPI-parallel participant. The coupling itself (transport, mapping,
IQN-ILS) is host numpy; each coupling iteration brings the solution to
the host once, as f64 numpy. Every device call stays on the caller's
thread.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from fem_shell_tpu_torch.coupling.api import (
    Participant,
    action_read_iteration_checkpoint,
    action_write_initial_data,
    action_write_iteration_checkpoint,
)
from fem_shell_tpu_torch.coupling.m2n import Transport
from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.utils.profiling import PerfLog

_AXIS_COLS = {
    # dead axis -> the two global coordinate columns of the 2D coupling plane
    "z": (0, 1),  # xy-plane (fem-shell_precice.cpp:122-126)
    "y": (0, 2),  # xz-plane (:127-131)
    "x": (1, 2),  # yz-plane (:132-136)
}


@dataclasses.dataclass
class CoupledRunResult:
    timesteps: int
    solutions: np.ndarray  # [T, N, 6] per-timestep converged solutions
    iterations: list  # CG iterations of every coupling iteration's solve
    step_iterations: list = None  # coupling iterations of each converged step
    # [T, n_iface, dims] the interface forces each converged solve was given
    # (``interface_load`` turns one into the [N, 6] load vector)
    iface_forces: np.ndarray = None
    # host seconds by scope: "setup" (ShellSystem, assembly, factor),
    # "solve" (one repeat solve and the copy to the host), "coupling"
    # (write, advance, read: transport, mapping, IQN-ILS)
    perf: PerfLog = None


def interface_load(n_nodes: int, iface_nodes, iface_forces, dims: int, dead_axis: str) -> np.ndarray:
    """The [N, 6] load vector of interface forces [n_iface, dims]: in 3D
    the forces act on (u, v, w); in 2D on the two columns of the coupling
    plane ``_AXIS_COLS[dead_axis]``."""
    forces = np.zeros((n_nodes, 6))
    if dims == 3:
        forces[iface_nodes, 0:3] = iface_forces
    else:
        c0, c1 = _AXIS_COLS[dead_axis]
        forces[iface_nodes, c0] = iface_forces[:, 0]
        forces[iface_nodes, c1] = iface_forces[:, 1]
    return forces


def run_structure(
    mesh: ShellMesh,
    material: Material,
    config,
    dt: float = 0.01,
    dead_axis: str = "y",
    solver_name: str = "STRUCTURE",
    transport: Optional[Transport] = None,
    on_timestep: Optional[Callable[[int, np.ndarray], None]] = None,
    rtol: float = 1e-10,
    maxiter: int = 20000,
    max_timesteps: Optional[int] = None,
    dtype=torch.float64,
    devices: int = 1,
    device=None,
    backend: Optional[str] = None,
) -> CoupledRunResult:
    """Execute the coupled structure solve until the coupling ends.

    ``on_timestep(t, sols)`` is invoked after each converged timestep with the
    full [N,6] solution (the per-timestep output hook,
    fem-shell_precice.cpp:377-408). ``dtype`` is the ``ShellSystem``'s
    (float64 or float32); the solution comes to the host as f64 either way.
    ``device`` defaults to CUDA; pass ``"cpu"`` to solve on the host.
    ``devices > 1`` solves over that many ranks (``backend`` "nccl" or
    "gloo", as ``parallel.sharded.make_device_mesh`` takes it); the
    coupling surface stays whole on the host.
    """
    device = resolve_device(device)  # before any transport opens
    dmesh = None
    try:
        if devices > 1:
            from fem_shell_tpu_torch.parallel.sharded import make_device_mesh

            dmesh = make_device_mesh(devices, device=device, backend=backend)
        return _run_structure(mesh, material, config, dt, dead_axis, solver_name, transport, on_timestep, rtol,
                              maxiter, max_timesteps, dtype, device, dmesh)
    finally:
        if dmesh is not None:
            dmesh.close()


def _run_structure(mesh, material, config, dt, dead_axis, solver_name, transport, on_timestep, rtol, maxiter,
                   max_timesteps, dtype, device, dmesh) -> CoupledRunResult:
    from fem_shell_tpu_torch.system import ShellSystem

    perf = PerfLog()
    interface = Participant(solver_name, config, 0, 1, transport=transport)
    dims = interface.get_dimensions()

    # ---- interface discovery (bc ids 2/20/21), sorted by node id
    iface_nodes = mesh.coupling_node_ids()
    n_iface = len(iface_nodes)
    if dims == 2:
        if dead_axis not in _AXIS_COLS:
            raise ValueError(
                "coupling is 2D but no valid dead axis given (allowed: x/y/z)"
            )
        cols = _AXIS_COLS[dead_axis]
        grid = mesh.coords[iface_nodes][:, cols]
    else:
        grid = mesh.coords[iface_nodes]

    mesh_id = interface.get_mesh_id("Structure_Nodes")
    displ_id = interface.get_data_id("Displacements", mesh_id)
    force_id = interface.get_data_id("Stresses", mesh_id)
    vertex_ids = interface.set_mesh_vertices(mesh_id, grid)

    interface.initialize()
    displ = np.zeros((n_iface, dims))
    if interface.is_action_required(action_write_initial_data()):
        interface.write_block_vector_data(displ_id, vertex_ids, displ)
        interface.fulfilled_action(action_write_initial_data())
    interface.initialize_data()
    iface_forces = np.zeros((n_iface, dims))
    if interface.is_read_data_available():
        iface_forces = interface.read_block_vector_data(force_id, vertex_ids)

    with perf.scope("setup"):
        if dmesh is not None:
            from fem_shell_tpu_torch.parallel.sharded import ShardedShellSystem

            # the sharded system assembles once, when it is built; each
            # coupling iteration is one solve over the ranks
            sharded = ShardedShellSystem(mesh, material, dmesh, dtype=dtype)

            def repeat_solve(f):
                u = sharded.solve(f, rtol=rtol, maxiter=maxiter)
                return torch.as_tensor(u), sharded.last_iters, sharded.last_residual
        else:
            system = ShellSystem(mesh, material, dtype=dtype, device=device)
            # geometry is fixed across the whole coupled run: assemble + factor
            # the preconditioner ONCE instead of per coupling iteration (the
            # reference re-assembles in every equation_systems.solve(),
            # fem-shell_precice.cpp:271)
            repeat_solve = system.make_repeat_solver(rtol=rtol, maxiter=maxiter)

    n = mesh.n_nodes
    pre_sols = np.zeros((n, 6))
    solutions = []
    step_forces = []
    step_iters = []
    iters = []
    t = 0

    while interface.is_coupling_ongoing():
        if interface.is_action_required(action_write_iteration_checkpoint()):
            # solver is quasi-static/stateless — nothing to checkpoint
            # (fem-shell_precice.cpp:259-265)
            interface.fulfilled_action(action_write_iteration_checkpoint())

        forces = interface_load(n, iface_nodes, iface_forces, dims, dead_axis)
        with perf.scope("solve"):
            u, n_it, _res = repeat_solve(forces)
            sols = u.cpu().numpy().astype(np.float64)
        iters.append(int(n_it))
        solved_with = iface_forces

        with perf.scope("coupling"):
            # delta displacements on the interface (fem-shell_precice.cpp:282-317)
            if dims == 3:
                displ = sols[iface_nodes, 0:3] - pre_sols[iface_nodes, 0:3]
            else:
                c0, c1 = _AXIS_COLS[dead_axis]
                displ = np.stack(
                    [
                        sols[iface_nodes, c0] - pre_sols[iface_nodes, c0],
                        sols[iface_nodes, c1] - pre_sols[iface_nodes, c1],
                    ],
                    axis=1,
                )
            interface.write_block_vector_data(displ_id, vertex_ids, displ)
            interface.advance(dt)
            iface_forces = interface.read_block_vector_data(force_id, vertex_ids)

        if interface.is_action_required(action_read_iteration_checkpoint()):
            interface.fulfilled_action(action_read_iteration_checkpoint())  # iterate
        else:
            # timestep complete: update preSols on interface dofs only
            # (fem-shell_precice.cpp:336-374)
            if dims == 3:
                pre_sols[iface_nodes, 0:3] = sols[iface_nodes, 0:3]
            else:
                c0, c1 = _AXIS_COLS[dead_axis]
                pre_sols[iface_nodes, c0] = sols[iface_nodes, c0]
                pre_sols[iface_nodes, c1] = sols[iface_nodes, c1]
            solutions.append(sols)
            step_forces.append(np.array(solved_with))
            step_iters.append(len(iters) - sum(step_iters))
            if on_timestep is not None:
                on_timestep(t, sols)
            t += 1
            if max_timesteps is not None and t >= max_timesteps:
                break

    interface.finalize()
    return CoupledRunResult(timesteps=t, solutions=np.array(solutions), iterations=iters,
                            step_iterations=step_iters, iface_forces=np.array(step_forces), perf=perf)

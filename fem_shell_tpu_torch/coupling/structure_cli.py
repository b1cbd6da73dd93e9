"""Coupled structure solver CLI — the ``FEM-shell-precice`` executable
analog (fem-shell_precice.cpp:428-526 flag surface):
  -nu -e -t -mesh [-out] [-d] -config -dt [-axis x|y|z]

Connects to the FLUID participant over the configured m2n (TCP sockets)
and runs the implicit coupling loop, writing per-timestep output when
-out is given (fem-shell_precice.cpp:1526-1561): ``-out name`` writes
one displaced-geometry VTU per timestep (name_%04d.vtu, the reference's
serial-build mode); ``-out name.e`` writes ONE ExodusII file with the
full displacement time series. The latter is a deliberate extension:
the reference's parallel build emits one ExodusII file PER timestep
(out_%04d.e, selected by MPI process count); a single-file series is
the more ParaView-friendly equivalent and is what our netCDF-3 writer
supports natively.

Port of ``fem_shell_tpu/coupling/structure_cli.py``, the same flags and
printed lines, plus ``--device cuda|cpu`` (default cuda) for the
structure solve:

    python -m fem_shell_tpu_torch.coupling.structure_cli -nu 0.3 -e 1e6 -t 0.1 \
        -mesh tower.xda -config fsi_tower.xml -dt 0.01 -axis y -out tower.e
"""
from __future__ import annotations

import sys
from typing import List, Optional


def make_timestep_writer(mesh, out: Optional[str], dt: float):
    """Per-timestep output plumbing for the coupled driver.

    Returns ``(on_timestep, finalize)``: ``on_timestep(t, sols)`` is
    handed to run_structure; ``finalize()`` must be called after the
    coupling loop. ``out`` ending in ``.e`` selects the single-file
    ExodusII time-series mode: displacements accumulate on the host and
    the file is REWRITTEN every ``flush_every`` steps (netCDF-3 cannot
    append, but a periodic rewrite is cheap next to a solve step and
    bounds data loss if the coupling run dies mid-flight); any other
    name selects per-step VTU files; None disables output."""
    from fem_shell_tpu_torch.io.vtk import write_vtu

    if out is None:
        return (lambda t, sols: None), (lambda: None)
    if out.endswith(".e"):
        import numpy as np

        from fem_shell_tpu_torch.io.exodus import write_exodus

        history: list = []
        flush_every = 25

        def flush():
            if history:
                times = dt * (1.0 + np.arange(len(history)))
                write_exodus(mesh, out, displacements=np.stack(history),
                             times=times)

        def on_timestep(t, sols):
            history.append(np.asarray(sols, np.float64))
            if len(history) % flush_every == 0:
                flush()

        return on_timestep, flush

    def on_timestep(t, sols):
        write_vtu(mesh, f"{out}_{t:04d}.vtu", displacement=sols,
                  displace=True)

    return on_timestep, (lambda: None)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fem-shell-precice")
    ap.add_argument("-nu", type=float, required=True)
    ap.add_argument("-e", type=float, required=True)
    ap.add_argument("-t", type=float, required=True)
    ap.add_argument("-mesh", required=True)
    ap.add_argument("-out", default=None)
    ap.add_argument("-d", type=int, default=0)
    ap.add_argument("-config", required=True, help="coupling XML configuration")
    ap.add_argument("-dt", type=float, required=True)
    ap.add_argument("-axis", default="0", help="dead axis for 2D coupling (x|y|z)")
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--devices", type=int, default=1,
                    help="device-parallel structure solve over this many ranks (MPI-participant analog)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the structure solve (default cuda)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' transport with --devices > 1 (default nccl on cuda, gloo on cpu)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from fem_shell_tpu_torch.coupling.adapter import run_structure
    from fem_shell_tpu_torch.materials import Material
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces

    print("Starting Structure Solver...")
    mesh, _ = load_mesh_and_forces(args.mesh)
    print(
        f"Mesh: {mesh.n_nodes} nodes, {mesh.n_elems} elements, "
        f"{len(mesh.coupling_node_ids())} coupling interface nodes"
    )

    write_step, finalize_out = make_timestep_writer(mesh, args.out, args.dt)

    def on_timestep(t, sols):
        print(f"Advancing in time, finished timestep: {t}")
        write_step(t, sols)

    result = run_structure(
        mesh,
        Material(nu=args.nu, em=args.e, thickness=args.t),
        args.config,
        dt=args.dt,
        dead_axis=args.axis,
        on_timestep=on_timestep,
        rtol=args.rtol,
        max_timesteps=args.steps,
        devices=args.devices,
        device=args.device,
        backend=args.backend,
    )
    finalize_out()
    print(f"Exiting Structure Solver ({result.timesteps} timesteps)")
    print("All done :)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

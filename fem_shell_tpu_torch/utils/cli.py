"""Stand-alone solver CLI — the ``FEM-shell`` executable analog, port of
``fem_shell_tpu/utils/cli.py``.

    python -m fem_shell_tpu_torch.utils.cli -nu 0.3 -e 1e7 -t 0.5 -mesh plate.xda -out plate

The reference flag surface (fem-shell.cpp:194-267):
  -nu    Poisson's ratio (required)
  -e     Young's modulus E (required)
  -t     thickness (required)
  -mesh  input mesh file (*.xda, *.xdr or *.msh, required; *_f force file
         by convention)
  -out   output file base name (optional; writes <out>.vtu, <out>.vtk and
         <out>.e)
  -d     debug output 1|0

plus the JAX package's extras, with the same printed lines, warnings,
exit codes and output files:
  --rtol      linear solver relative tolerance (default 1e-10)
  --maxiter   CG iteration cap
  --method    pcg | dense (ShellSystem)
  --precond   block_jacobi | jacobi (ShellSystem) | mg (geometric
              multigrid, structured grids: MultigridShellSystem.solve,
              f64 levels, f32 with --f32) | amg (smoothed-aggregation AMG, arbitrary
              meshes: AMGShellSystem, RCM-reordered unless --reorder says
              otherwise; f32 cycle with --f32, --df or --refined)
  --reorder   rcm: reverse Cuthill-McKee renumbering (LargeShellSystem,
              or AMG's reorder)
  --df        with --precond mg: solve_df on the f64 levels (f64 CG, f32
              V-cycle), with --f32 on the f32 levels; with amg: solve_df (f64 CG, the cycle in f32);
              else LargeShellSystem.solve_df (f64 CG on the scaled
              operator). Native f64 takes the place of the JAX package's
              two-float32 arithmetic
  --refined   with --precond mg: the df_operator system's
              solve_df_refined (refinement against the class tables); with
              amg or without mg: solve_df_refined on the true residual
  --f32       ShellSystem in f32 (block_jacobi, jacobi, dense); with
              --precond mg the f32 levels (solve, or solve_df with --df);
              with amg the f32 cycle and CG (AMGShellSystem dtype=float32);
              ignored by --refined and by the LargeShellSystem routes, as
              in the JAX CLI
  --stress    with -out: recover element-center and nodal stresses
              (ops/recovery.py, on --device) into the .vtu cell and point
              data and the .vtk point data
  --devices   N > 1: the sharded solve over N rank processes
              (parallel/): ShardedMGShellSystem with --precond mg, else
              ShardedShellSystem (Jacobi PCG), f32 with --f32
  --device    cuda (default) | cpu
  --backend   nccl | gloo: the ranks' transport with --devices > 1
              (default nccl on cuda, one GPU per rank; gloo lets ranks
              share a card, and is the CPU's). XLA's collectives have no
              such switch: it is the port's, like --device
"""
from __future__ import annotations

import sys
from typing import List, Optional


def _parse(argv: List[str]):
    import argparse

    ap = argparse.ArgumentParser(
        prog="fem-shell",
        description="flat-shell FEM solver on PyTorch/CUDA (fem-shell analog)",
    )
    ap.add_argument("-nu", type=float, required=True, help="Poisson's ratio")
    ap.add_argument("-e", type=float, required=True, help="Young's modulus E")
    ap.add_argument("-t", type=float, required=True, help="thickness")
    ap.add_argument("-mesh", required=True, help="input mesh (*.xda, *.xdr, *.msh)")
    ap.add_argument("-out", default=None, help="output base name (optional)")
    ap.add_argument("-d", type=int, default=0, help="debug messages 1|0")
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--method", choices=("pcg", "dense"), default="pcg")
    ap.add_argument(
        "--precond",
        choices=("block_jacobi", "jacobi", "mg", "amg"),
        default="block_jacobi",
        help="mg = geometric multigrid V-cycle (structured grid meshes; "
        "mesh-independent iteration counts); amg = smoothed-aggregation "
        "algebraic multigrid (arbitrary meshes)",
    )
    ap.add_argument("--reorder", choices=("rcm",), default=None,
                    help="bandwidth-reduce the node numbering (reverse Cuthill-McKee) before solving")
    ap.add_argument("--stress", action="store_true",
                    help="with -out: write von Mises, moments and membrane stresses (cell + point data)")
    ap.add_argument("--f32", action="store_true",
                    help="f32 operator and solve (ShellSystem, --precond mg or amg)")
    ap.add_argument(
        "--df",
        action="store_true",
        help="f64 CG on the scaled operator (with --precond mg or amg: "
        "preconditioned by the f32 cycle); native f64 replaces the JAX "
        "package's two-float32 arithmetic",
    )
    ap.add_argument(
        "--refined",
        action="store_true",
        help="df solve plus iterative refinement on the true residual (with "
        "--precond mg: against the exact class-table operator)",
    )
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the sharded solve (values > 1; parallel/)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to solve on (default cuda)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' transport with --devices > 1 (default nccl on cuda, gloo on cpu)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)

    import math

    import numpy as np
    import torch

    from fem_shell_tpu_torch.io.vtk import write_legacy_vtk, write_vtu
    from fem_shell_tpu_torch.materials import Material
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces
    from fem_shell_tpu_torch.system import ShellSystem

    print(
        f"Run program with parameters: debug messages = "
        f"{'true' if args.d else 'false'}, nu = {args.nu}, E = {args.e}, "
        f"t = {args.t}, mesh file = {args.mesh}"
        + (f", out-file = {args.out}" if args.out else "")
    )
    mesh, forces = load_mesh_and_forces(args.mesh)
    print(
        f"Mesh: {mesh.n_nodes} nodes, {mesh.n_elems} elements "
        f"({len(mesh.tri)} tri, {len(mesh.quad)} quad), {mesh.n_dofs} dofs"
    )
    if not np.any(forces):
        print(
            "WARNING: all nodal loads are zero (missing or empty "
            f"'{args.mesh.rsplit('.',1)[0]}_f' force file?) — solution will be zero."
        )
    material = Material(nu=args.nu, em=args.e, thickness=args.t)
    device = args.device
    dtype = torch.float32 if args.f32 else torch.float64

    if args.devices > 1:
        from fem_shell_tpu_torch.parallel.sharded import ShardedShellSystem, make_device_mesh

        with make_device_mesh(args.devices, device=device, backend=args.backend) as dmesh:
            if args.precond == "mg":
                from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem

                system = ShardedMGShellSystem(mesh, material, dmesh, dtype=dtype)
            else:
                system = ShardedShellSystem(mesh, material, dmesh, dtype=dtype)
            u = torch.as_tensor(system.solve(forces, rtol=args.rtol, maxiter=args.maxiter))
        iters, res = system.last_iters, system.last_residual
    elif args.precond == "mg":
        from fem_shell_tpu_torch.mg import MultigridShellSystem, detect_structured_grid

        if detect_structured_grid(mesh) is None:
            print("ERROR: --precond mg needs a row-major structured grid mesh.")
            return 2
        if args.refined:
            system = MultigridShellSystem(mesh, material, dtype=torch.float32, df_operator=True,
                                          device=device)
            u = system.solve_df_refined(forces, rtol=args.rtol, maxiter=args.maxiter)
            iters, res = system.last_iters, system.last_residual
        elif args.df:
            system = MultigridShellSystem(mesh, material, dtype=dtype, device=device)
            u = system.solve_df(forces, rtol=args.rtol, maxiter=args.maxiter)
            iters, res = system.last_iters, system.last_residual
        else:
            system = MultigridShellSystem(mesh, material, dtype=dtype, device=device)
            u = system.solve(forces, rtol=args.rtol, maxiter=args.maxiter)
            iters, res = int(system.last_cg.iters), float(system.last_cg.residual)
    elif args.precond == "amg":
        from fem_shell_tpu_torch.amg import AMGShellSystem

        use_df = args.df or args.refined
        amg_dtype = torch.float32 if (args.f32 or use_df) else torch.float64
        system = AMGShellSystem(mesh, material, dtype=amg_dtype, df=use_df,
                                reorder=args.reorder or "rcm", device=device)
        if args.refined:
            u = system.solve_df_refined(forces, rtol=args.rtol, inner_maxiter=args.maxiter)
        elif args.df:
            u = system.solve_df(forces, rtol=args.rtol, maxiter=args.maxiter)
        else:
            u = system.solve(forces, rtol=args.rtol, maxiter=args.maxiter)
        iters, res = system.last_iters, system.last_residual
    elif args.df or args.refined or args.reorder:
        from fem_shell_tpu_torch.large import LargeShellSystem

        system = LargeShellSystem(mesh, material, reorder=args.reorder, device=device)
        if args.refined:
            u = system.solve_df_refined(forces, rtol=args.rtol, inner_maxiter=args.maxiter)
            iters, res = system.last_iters, system.last_residual
        elif args.df:
            u = system.solve_df(forces, rtol=args.rtol, maxiter=args.maxiter)
            iters, res = system.last_iters, system.last_residual
        else:
            u = system.solve(forces, rtol=args.rtol, maxiter=args.maxiter, precond=args.precond)
            iters, res = int(system.last_cg.iters), float(system.last_cg.residual)
    else:
        system = ShellSystem(mesh, material, dtype=dtype, device=device)
        u = system.solve(forces, method=args.method, rtol=args.rtol, maxiter=args.maxiter,
                         precond=args.precond)
        if args.method == "pcg":
            iters, res = int(system.last_cg.iters), float(system.last_cg.residual)
        else:
            iters, res = 0, 0.0
    u = u.cpu().numpy()
    if args.method == "pcg":
        print(f"Linear solve: {iters} CG iterations, relative residual {res:.3e}")
        if not math.isfinite(res):
            print("ERROR: linear solve diverged (non-finite residual) — "
                  "check material parameters and boundary conditions.")
            return 2
        if res > args.rtol * 10:
            print(f"WARNING: solver stopped above the requested tolerance "
                  f"({res:.2e} > {args.rtol:.0e}); increase --maxiter.")

    if args.d:
        print("Solution: u_vec = [")
        for i in range(mesh.n_nodes):
            print(
                f"u= {u[i,0]:.6g}, v= {u[i,1]:.6g}, w= {u[i,2]:.6g}, "
                f"tx= {u[i,3]:.6g}, ty= {u[i,4]:.6g}, tz= {u[i,5]:.6g}"
            )
        print("]")

    if args.out:
        point_data = {}
        cell_data = {}
        if args.stress:
            from fem_shell_tpu_torch.ops.recovery import (
                recover_stresses,
                recover_stresses_nodal,
                to_mesh_order,
            )

            field = recover_stresses(mesh, material, u, device=device)
            nodal = recover_stresses_nodal(mesh, material, u, device=device)
            point_data["von_mises"] = nodal.vm
            point_data["moments"] = nodal.moments
            point_data["sigma_membrane"] = nodal.sigma_m
            cell_data["von_mises"] = to_mesh_order(mesh, field.vm)
            cell_data["moments"] = to_mesh_order(mesh, field.moments)
            cell_data["sigma_membrane"] = to_mesh_order(mesh, field.sigma_m)
            print(f"Stress recovery: peak von Mises {nodal.vm.max():.6g} "
                  f"(nodal), {field.vm.max():.6g} (element centers)")
        write_vtu(mesh, args.out + ".vtu", displacement=u, displace=True, point_data=point_data,
                  cell_data=cell_data)
        write_legacy_vtk(mesh, args.out + ".vtk", displacement=u, displace=True, point_data=point_data)
        wrote = [args.out + ".vtu", args.out + ".vtk"]
        try:
            from fem_shell_tpu_torch.io.exodus import write_exodus

            write_exodus(mesh, args.out + ".e", displacements=u)
            wrote.append(args.out + ".e")
        except RuntimeError:
            pass  # scipy unavailable; VTK outputs cover visualization
        print("Wrote " + " and ".join(wrote))

    print("All done :)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

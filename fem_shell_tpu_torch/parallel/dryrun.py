"""The multi-rank dry run: the JAX package's ``_dryrun_body`` paths 1-7
(``__graft_entry__.py``) on the port, on the same meshes and with the
same asserts.

1. ``ShardedShellSystem`` (all-gather SPMD) on the 8x8 Test-D/G plate:
   converged, centre deflection 0.106405 +- 5e-4.
2. ``ShardedStencilSystem`` (halo strips) on a 1 x 2n strip plate
   (8 x 16n quads): converged, symmetric across the strip to 1e-8, and
   within 1e-4 of the single-device f64 ``ShellSystem`` block-Jacobi
   solve; then ("2t") solved again to rtol 1e-10, for comparisons of two
   runs at the CG's precision.
3. ``ShardedMGShellSystem`` (f64) on the 64x64 Test-G plate: converged to
   1e-9 in fewer than 40 iterations, centre 0.106465 +- 5e-5.
4. ``ShardedMGDFShellSystem`` (f64 CG, f32 V-cycle) on the same plate:
   the same gates.
5. ``Sharded2DGridSystem`` (f64) on a py x px process grid (py = 2 where n
   is even and at least 4, else 1) on the 21x21 quad plate, to rtol
   1e-10: within 1e-8 of the single-device f64 ``ShellSystem`` solve;
   "5b" ``Sharded2DGridDFSystem`` to rtol 1e-9: within 1e-4.
6. ``GridShardedDFShellSystem(prec="mg")`` (the operator from the sharded
   grid assembly) on the 16x128 quad strip, to rtol 1e-9: within 1e-4 of
   ``ShellSystem`` at rtol 1e-12.
7. ``HaloShardedShellSystem`` on the I-beam refined three times (5120
   Tri-3): within 1e-6 of the single-device ``LargeShellSystem`` Jacobi
   solve, iterations within max(5, 5 %) of its count, and the exchanged
   values per iteration below N*6/3.

    python -m fem_shell_tpu_torch.parallel.dryrun 2 --device cpu [--save out.npz] [--repeat 1,2]

``--save`` writes each path's displacements (``u1``, ``u2``, ...) and a
JSON ``meta`` of the rest, the ranks' kernel launches included, to an
.npz; ``--repeat`` names the paths solved twice.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Iterable, Optional

import numpy as np
import torch

def dryrun(n: int, device=None, backend: Optional[str] = None, repeat: Iterable[str] = (),
           verbose: bool = True) -> dict:
    """Run paths 1-7 on ``n`` ranks of ``device`` over ``backend``;
    raises AssertionError on a failed gate. Returns {path: {"u", "iters",
    "residual", "seconds"[, "repeat_equal"]}, "launches": per-rank kernel
    launches}; the paths named in ``repeat`` solve twice, and
    "repeat_equal" says whether the two agree bit for bit."""
    from fem_shell_tpu_torch.data import test_e as E
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.materials import Material
    from fem_shell_tpu_torch.mesh import ShellMesh, refine_uniform
    from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
    from fem_shell_tpu_torch.parallel.df_shard import ShardedMGDFShellSystem
    from fem_shell_tpu_torch.parallel.grid2d_shard import (
        Sharded2DGridDFSystem,
        Sharded2DGridSystem,
        make_device_mesh2d,
    )
    from fem_shell_tpu_torch.parallel.grid_asm_shard import GridShardedDFShellSystem
    from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem
    from fem_shell_tpu_torch.parallel.sharded import ShardedShellSystem, make_device_mesh
    from fem_shell_tpu_torch.parallel.stencil_shard import ShardedStencilSystem
    from fem_shell_tpu_torch.parallel.unstructured_shard import HaloShardedShellSystem
    from fem_shell_tpu_torch.system import ShellSystem

    t_start = time.perf_counter()
    out = {}

    def mark(msg):
        if verbose:
            print(f"[dryrun +{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    def run(path, system, solve, *args, **kw):
        t0 = time.perf_counter()
        u = solve(*args, **kw)
        rec = {"u": u, "iters": system.last_iters, "residual": system.last_residual,
               "seconds": time.perf_counter() - t0}
        if path in repeat:
            rec["repeat_equal"] = bool(np.array_equal(u, solve(*args, **kw)))
        out[path] = rec
        return u

    rtol = 1e-6
    mat = Material(0.3, 1e7, 0.5)
    with make_device_mesh(n, device=device, backend=backend) as dmesh:
        # path 1: all-gather SPMD on the Test-D/G plate (Kirchhoff w* =
        # 0.1064045; the 8x8 quad mesh gives 0.106405)
        mesh, rows, fac = generate(MeshGenParams("q", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        system = ShardedShellSystem(mesh, mat, dmesh)
        u = run("1", system, system.solve, rows * fac, rtol=rtol, maxiter=2000)
        assert np.isfinite(u).all(), "all-gather path produced non-finite output"
        assert system.last_residual < rtol, (
            f"all-gather path did not converge: res {system.last_residual:.2e} after {system.last_iters} iters")
        w = float(u[mesh.n_nodes // 2, 2])
        assert abs(w - 0.106405) < 5e-4, f"centre deflection {w:.6f} outside 0.106405+-5e-4"
        mark(f"path 1/7 allgather OK ({system.last_iters} iters)")

        # path 2: halo-exchange strips on a 1 x 2n strip plate
        mesh2, rows2, fac2 = generate(MeshGenParams("q", 8, 16 * n, 0, 0, 1, 2 * n, (0, 0, 0, 0), 1.0, 2, True, "z"))
        halo = ShardedStencilSystem(mesh2, mat, dmesh, dtype=torch.float64, chunk=256)
        u2 = run("2", halo, halo.solve, rows2 * fac2, rtol=rtol, maxiter=20000)
        assert np.isfinite(u2).all(), "halo path produced non-finite output"
        assert halo.last_residual < rtol, (
            f"halo path did not converge: res {halo.last_residual:.2e} after {halo.last_iters} iters")
        w_grid = u2[:, 2].reshape(-1, 9)  # 9 nodes across the strip
        sym_err = float(np.max(np.abs(w_grid - w_grid[:, ::-1])))
        scale = float(np.max(np.abs(u2[:, 2])))
        assert scale > 0 and sym_err < 1e-8 * scale, f"halo solution asymmetric: {sym_err:.3e} vs {scale:.3e}"
        ref2 = ShellSystem(mesh2, mat, device=dmesh.device).solve(rows2 * fac2, rtol=1e-10, maxiter=20000,
                                                                   precond="block_jacobi").cpu().numpy()
        halo_err = float(np.max(np.abs(u2 - ref2))) / float(np.max(np.abs(ref2)))
        assert halo_err < 1e-4, f"halo path disagrees with the single-device solve: rel {halo_err:.3e}"
        out["2"].update(sym_err=sym_err, ref_err=halo_err, l=halo.l, w_pad=halo.w_pad)
        mark(f"path 2/7 halo-strip OK ({halo.last_iters} iters)")
        # "2t": the same strip to rtol 1e-10, where two runs that sum in other
        # orders agree to the CG's precision (at rtol 1e-6 a last-bit
        # difference grows to ~1e-9 of max|u|)
        run("2t", halo, halo.solve, rows2 * fac2, rtol=1e-10, maxiter=20000)
        assert halo.last_residual < 1e-10, f"halo path at rtol 1e-10: res {halo.last_residual:.2e}"
        mark(f"path 2/7 halo-strip at rtol 1e-10 OK ({halo.last_iters} iters)")

        # path 3: sharded geometric multigrid on Test-G 64^2 (w 0.106465)
        mesh3, rows3, fac3 = generate(MeshGenParams("q", 64, 64, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        mgs = ShardedMGShellSystem(mesh3, mat, dmesh, dtype=torch.float64)
        u3 = run("3", mgs, mgs.solve, rows3 * fac3, rtol=1e-9, maxiter=100)
        assert mgs.last_residual < 1e-9, f"sharded-MG path did not converge: res {mgs.last_residual:.2e}"
        assert mgs.last_iters < 40, f"sharded-MG iterations {mgs.last_iters} not mesh-independent"
        w3 = float(u3[mesh3.n_nodes // 2, 2])
        assert abs(w3 - 0.106465) < 5e-5, f"sharded-MG centre deflection {w3:.6f} off 0.106465"
        out["3"].update(n_sharded=mgs.n_sharded, n_levels=mgs.n_levels)
        mark(f"path 3/7 sharded-MG OK ({mgs.last_iters} iters, {mgs.n_sharded}/{mgs.n_levels} levels sharded)")

        # path 4: the production solver: f64 CG, f32 sharded V-cycle
        mgdf = ShardedMGDFShellSystem(mesh3, mat, dmesh)
        u4 = run("4", mgdf, mgdf.solve_df, rows3 * fac3, rtol=1e-9, maxiter=100)
        assert mgdf.last_residual < 1e-9, f"sharded MG-df path did not converge: res {mgdf.last_residual:.2e}"
        assert mgdf.last_iters < 40, f"sharded MG-df iterations {mgdf.last_iters} not mesh-independent"
        w4 = float(u4[mesh3.n_nodes // 2, 2])
        assert abs(w4 - 0.106465) < 5e-5, f"sharded MG-df centre deflection {w4:.6f} off 0.106465"
        mark(f"path 4/7 sharded MG-df OK ({mgdf.last_iters} iters)")
        del mgs, mgdf

        # path 5: the 2-D process grid on a quad plate whose node grid need
        # not divide it (padded tiles), laid over these ranks
        py = 2 if n % 2 == 0 and n >= 4 else 1
        px = n // py
        grid_mesh = make_device_mesh2d(py, px, ranks=dmesh)
        mesh5, rows5, fac5 = generate(MeshGenParams("q", 21, 21, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        g2d = Sharded2DGridSystem(mesh5, mat, grid_mesh, dtype=torch.float64, chunk=256)
        u5 = run("5", g2d, g2d.solve, rows5 * fac5, rtol=1e-10, maxiter=20000)
        u5_ref = ShellSystem(mesh5, mat, device=dmesh.device).solve(rows5 * fac5, rtol=1e-10).cpu().numpy()
        g2d_err = float(np.max(np.abs(u5 - u5_ref))) / float(np.max(np.abs(u5_ref)))
        assert g2d.last_residual < 1e-9 and g2d_err < 1e-8, (
            f"2D-grid path off reference: rel {g2d_err:.3e}, res {g2d.last_residual:.2e}")
        out["5"].update(ref_err=g2d_err, grid=[py, px], tile=[g2d.ly, g2d.lx])
        mark(f"path 5/7 2D-grid OK ({g2d.last_iters} iters, {py}x{px} grid)")
        # 5b: the production (f64) system on the same tiles
        g2df = Sharded2DGridDFSystem(mesh5, mat, grid_mesh, chunk=256)
        u5d = run("5b", g2df, g2df.solve, rows5 * fac5, rtol=1e-9, maxiter=20000)
        g2df_err = float(np.max(np.abs(u5d - u5_ref))) / float(np.max(np.abs(u5_ref)))
        assert g2df.last_residual < 1e-9 and g2df_err < 1e-4, (
            f"2D-grid df path off reference: rel {g2df_err:.3e}, res {g2df.last_residual:.2e}")
        out["5b"].update(ref_err=g2df_err)
        mark(f"path 5b/7 2D-grid df OK ({g2df.last_iters} iters)")
        del g2d, g2df

        # path 6: the operator from the sharded grid assembly, the f64 CG
        # preconditioned by the sharded f32 V-cycle, on a strip tall enough
        # (129 node rows) for every rank
        mesh6, rows6, fac6 = generate(MeshGenParams("q", 16, 128, 0, 0, 2.5, 20, (0, 0, 0, 0), 300.0, 2, True, "z"))
        gdf = GridShardedDFShellSystem(mesh6, mat, dmesh, prec="mg")
        u6 = run("6", gdf, gdf.solve, rows6 * fac6, rtol=1e-9, maxiter=20000)
        u6_ref = ShellSystem(mesh6, mat, device=dmesh.device).solve(rows6 * fac6, rtol=1e-12).cpu().numpy()
        g6_err = float(np.max(np.abs(u6 - u6_ref))) / float(np.max(np.abs(u6_ref)))
        assert gdf.last_residual < 1e-9 and g6_err < 1e-4, (
            f"grid-sharded-df path off reference: rel {g6_err:.3e}, res {gdf.last_residual:.2e}")
        out["6"].update(ref_err=g6_err, n_sharded=gdf.mgp.n_sharded, n_levels=gdf.mgp.n_levels)
        mark(f"path 6/7 grid-sharded-df OK ({gdf.last_iters} iters)")
        del gdf

        # path 7: unstructured halo decomposition on the refined I-beam
        ne = E.TRIS.shape[0]
        conn7 = np.hstack([E.TRIS, np.full((ne, 1), -1, np.int32)])
        mesh7 = refine_uniform(ShellMesh(E.COORDS, np.full(ne, 3, np.int32), conn7, E.BOUNDARY_SIDES), 3)
        mat7 = Material(0.25, 10000, 0.25)
        f7 = np.zeros((mesh7.n_nodes, 6))
        f7[35, 1] = 1.6
        f7[44, 1] = -1.6
        hs = HaloShardedShellSystem(mesh7, mat7, dmesh)
        u7 = run("7", hs, hs.solve, f7, rtol=1e-10, maxiter=50000)
        ref7 = LargeShellSystem(mesh7, mat7, device=dmesh.device)
        u7_ref = ref7.solve(f7, rtol=1e-10, maxiter=50000).cpu().numpy()
        err7 = float(np.max(np.abs(u7 - u7_ref))) / float(np.max(np.abs(u7_ref)))
        it7_ref = int(ref7.last_cg.iters)
        assert hs.last_residual < 1e-10 and err7 < 1e-6, (
            f"unstructured halo path off the reference: rel {err7:.3e}, res {hs.last_residual:.2e}")
        assert abs(hs.last_iters - it7_ref) <= max(5, 0.05 * it7_ref), (
            f"unstructured halo iterations {hs.last_iters} vs single-device {it7_ref}")
        comm7, full7 = hs.comm_floats_per_iter, mesh7.n_nodes * 6
        assert comm7 < full7 / 3, f"halo comm {comm7} not boundary-sized against the all-gather's {full7}"
        out["7"].update(ref_err=err7, ref_iters=it7_ref, comm_floats_per_iter=comm7, n_dofs=full7)
        mark(f"path 7/7 unstructured-halo OK ({hs.last_iters} iters, comm {comm7} of {full7})")
        out["launches"] = [dict(c) for c in dmesh.launches]
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fem-shell-dryrun", description="multi-rank dry run of the sharded solvers")
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--save", default=None, help="write the results to this .npz")
    ap.add_argument("--repeat", default="", help="comma-separated paths to solve twice, bit for bit")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    res = dryrun(args.n, device=args.device, backend=args.backend, repeat=[p for p in args.repeat.split(",") if p])
    if args.save:
        paths = {k: v for k, v in res.items() if k != "launches"}
        meta = {k: {f: x for f, x in v.items() if f != "u"} for k, v in paths.items()}
        np.savez(args.save, meta=json.dumps(dict(meta, launches=res["launches"])),
                 **{f"u{k}": v["u"] for k, v in paths.items()})
    print("dryrun OK: " + "; ".join(f"path {k} {v['iters']} iters res {v['residual']:.2e}"
                                    for k, v in res.items() if k != "launches"))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

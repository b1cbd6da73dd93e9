"""The multi-rank dry run: the JAX package's ``_dryrun_body`` paths 1, 2,
3, 4 and 7 (``__graft_entry__.py``) on the port, on the same meshes and
with the same asserts.

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
7. ``HaloShardedShellSystem`` on the I-beam refined three times (5120
   Tri-3): within 1e-6 of the single-device ``LargeShellSystem`` Jacobi
   solve, iterations within max(5, 5 %) of its count, and the exchanged
   values per iteration below N*6/3.

Paths 5, 5b (the 2-D process grid, ``grid2d_shard``) and 6 (the sharded
grid-df assembly, ``grid_asm_shard``) are not ported yet (ROADMAP.md
Queue 1 item 9); the run says so.

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

WAITING = {"5": "2-D process grid (grid2d_shard)", "5b": "2-D process grid, df (grid2d_shard)",
           "6": "sharded grid-df assembly (grid_asm_shard)"}


def dryrun(n: int, device=None, backend: Optional[str] = None, repeat: Iterable[str] = (),
           verbose: bool = True) -> dict:
    """Run paths 1-4 and 7 on ``n`` ranks of ``device`` over ``backend``;
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

        for path, what in WAITING.items():
            mark(f"path {path}/7 {what}: not ported yet (ROADMAP.md Queue 1 item 9)")

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

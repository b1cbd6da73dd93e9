#!/usr/bin/env python3
"""Where block-Jacobi PCG on the Test-G plates reaches its rounding floor,
on the CPU, in three arithmetic orders: the port's ShellSystem (its own
operator and block-Jacobi factor), the same loop over the JAX package's
assembled operator, and the same loop eagerly in JAX (jitted matvec and
preconditioner, the JAX package's unrolled 6x6 Cholesky). Prints, per
plate and run, the first iteration whose relative residual is at most
1e-6 ... 1e-12, and the JAX package's own jitted ShellSystem.solve counts
at rtol 1e-10 and 1e-12.

    JAX_PLATFORMS=cpu python3 tools/torch_pcg_floor_probe.py [--plates qt]

With ``--solve-df`` it also prints how far the JAX package's
MultigridShellSystem.solve_df on f64 levels (its two-float32 CG) lands
from its own f64 solve at 16x16 (coarse_max=4), at several rtol, beside
the port's solve_df.

Needs JAX with x64 on the CPU and the port; a few minutes.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from fem_shell_tpu import mg as jmg  # noqa: E402
from fem_shell_tpu.materials import Material as JMaterial  # noqa: E402
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate  # noqa: E402
from fem_shell_tpu.ops.blockprec import cholesky6 as jchol, cholesky6_solve as jchol_solve  # noqa: E402
from fem_shell_tpu.system import ShellSystem as JShellSystem  # noqa: E402
from fem_shell_tpu_torch import mg as tmg  # noqa: E402
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax  # noqa: E402
from fem_shell_tpu_torch.ops.assemble import BlockEllMatrix  # noqa: E402
from fem_shell_tpu_torch.system import ShellSystem  # noqa: E402

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
THRESHOLDS = (1e-6, 1e-8, 1e-9, 1e-10, 1e-11, 1e-12)


def pcg_history(matvec, prec, b, dot, maxiter=6000, rtol=1e-12):
    """The relative residual of every iteration of plain PCG (the port's
    and the JAX package's recurrence), to rtol."""
    bn = float(dot(b, b)) ** 0.5
    x, r = b * 0, b
    z = prec(r)
    p, rz = z, dot(r, z)
    hist = []
    for _ in range(maxiter):
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        hist.append(float(dot(r, r)) ** 0.5 / bn)
        if hist[-1] <= rtol:
            break
    return np.array(hist)


def crossings(hist):
    return {t: (int(np.argmax(hist <= t)) + 1 if (hist <= t).any() else None) for t in THRESHOLDS}


def floor_probe(et):
    jmesh, rows, fac = jgenerate(JParams(et, 64, 64, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
    forces = rows * fac
    jsys = JShellSystem(jmesh, JMAT)
    for rtol in (1e-10, 1e-12):
        jsys.solve(forces, rtol=rtol, maxiter=20000)
        print(f"{et}64 JAX ShellSystem.solve(rtol={rtol:g}): {int(jsys.last_cg.iters)} iterations", flush=True)
    ja = jsys.assemble()
    tsys = ShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), device="cpu")
    b = torch.as_tensor(forces) * tsys.free_mask
    tdot = lambda u, v: torch.sum(u * v)  # noqa: E731
    runs = []
    ta = tsys.assemble()
    runs.append(("port", ta.matvec, tsys._preconditioner(ta, "block_jacobi")))
    ta_j = BlockEllMatrix(torch.from_numpy(np.array(ja.blocks)), tsys.adj)
    runs.append(("port loop, JAX operator", ta_j.matvec, tsys._preconditioner(ta_j, "block_jacobi")))
    for name, mv, prec in runs:
        h = pcg_history(mv, prec, b, tdot)
        print(f"{et}64 {name}: {len(h)} iterations, first at or under {crossings(h)}", flush=True)
    jl = jchol(ja.diagonal_blocks())
    h = pcg_history(jax.jit(ja.matvec), jax.jit(lambda r: jchol_solve(jl, r)),
                    jnp.asarray(forces) * jsys.free_mask, lambda u, v: jnp.sum(u * v))
    print(f"{et}64 JAX eager loop: {len(h)} iterations, first at or under {crossings(h)}", flush=True)


def solve_df_probe(et):
    jmesh, rows, fac = jgenerate(JParams(et, 16, 16, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
    forces = rows * fac
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, coarse_max=4)
    tsys = tmg.MultigridShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), coarse_max=4, device="cpu")
    ref = np.asarray(jsys.solve(forces, rtol=1e-14, maxiter=500))
    sc = np.abs(ref).max()
    for rtol in (1e-9, 1e-11, 1e-12):
        uj = np.asarray(jsys.solve_df(forces, rtol=rtol))
        ut = tsys.solve_df(forces, rtol=rtol).numpy()
        print(f"{et}16 solve_df(rtol={rtol:g}): JAX {jsys.last_iters} iterations, "
              f"{np.abs(uj - ref).max() / sc:.2e} of max|u| from its f64 solve; port {tsys.last_iters}, "
              f"{np.abs(ut - ref).max() / sc:.2e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plates", default="qt")
    ap.add_argument("--solve-df", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for et in args.plates:
        floor_probe(et)
        if args.solve_df:
            solve_df_probe(et)
    return 0


if __name__ == "__main__":
    sys.exit(main())

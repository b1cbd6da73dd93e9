#!/usr/bin/env python3
"""How far an f64 solution of the Scordelis-Lo roof can drive its true
residual: the port's df-cycle solve (MultigridShellSystem(dtype=float32,
df_operator=True, df_cycle=True, smoother="chebyshev"), solve_df(rtol=1e-9))
at each size, then ``--refine`` passes of iterative refinement on the
compensated residual (stencil_resid_dd, double-double). Prints per size the
CG iterations, the recursive residual, the true residual ||b - A x|| / ||b||
evaluated in f64 (stencil_spmv) and compensated (stencil_resid_dd), the
scale || |A| |x| || / ||b|| (an f64 x carries a true residual of about eps
times this by its rounding alone), the normwise backward error, and the
midside deflection after each pass.

    python3 tools/torch_roof_residual_floor.py [--sizes 128 256 512] [--refine 2] [--device cuda]

One GPU, about half a minute; ``--device cpu`` for small sizes.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fem_shell_tpu_torch import MultigridShellSystem  # noqa: E402
from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd  # noqa: E402
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv  # noqa: E402
from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL, scordelis_lo  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 256, 512])
    ap.add_argument("--refine", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print("card:", torch.cuda.get_device_name(0), flush=True)
    for n in args.sizes:
        mesh, forces, mid = scordelis_lo(n)
        mg = MultigridShellSystem(mesh, SCORDELIS_LO_MATERIAL, dtype=torch.float32, df_operator=True,
                                  df_cycle=True, smoother="chebyshev", device=args.device)
        f = mg.stage_forces(forces)
        b = f * mg.levels[0].free_t
        a, offs = mg._fine64, mg.levels[0].offsets
        nb = float(torch.linalg.vector_norm(b))
        x = mg.solve_df(f, rtol=1e-9, maxiter=2000, return_device=True)
        r64 = b - stencil_spmv(a, x, offs)
        rdd = stencil_resid_dd(a, x, b, offs)
        scale = float(torch.linalg.vector_norm(stencil_spmv(a.abs(), x.abs(), offs)))
        print(f"roof {n}^2: {mg.last_iters} iterations, recursive {mg.last_residual:.4e}, true f64 "
              f"{float(torch.linalg.vector_norm(r64)) / nb:.4e}, true dd "
              f"{float(torch.linalg.vector_norm(rdd)) / nb:.4e}, |||A||x|||/||b|| {scale / nb:.4e}, "
              f"backward {float(torch.linalg.vector_norm(r64)) / scale:.4e}, w {float(x[2, mid]):.12f}",
              flush=True)
        for k in range(args.refine):
            d = mg.solve_df(rdd, rtol=1e-3, maxiter=2000, return_device=True)
            x = x + d
            rdd = stencil_resid_dd(a, x, b, offs)
            print(f"  refinement pass {k + 1}: {mg.last_iters} iterations, true dd "
                  f"{float(torch.linalg.vector_norm(rdd)) / nb:.4e}, w {float(x[2, mid]):.12f}", flush=True)
        del mg, a, x, b, f, r64, rdd
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

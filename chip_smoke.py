#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fem_shell_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each gated; any failed gate ends the run with a non-zero exit
before the last line:

1. Device: CUDA is required (no fallback). Prints the card's name and
   power limit, asserts TF32 is off, builds every CUDA kernel from
   fem_shell_tpu_torch/csrc, and prints the ptxas line and the SASS
   counts of both element-stiffness instances; elem_stiffness<4> must
   spill nothing.
2. Kernels against their plain PyTorch versions on the card, on operators
   assembled by the port: Test-G 64x64 quad (K=9) and tri (K=7), and the
   1024x1024 tri scale size, in f32 and f64. Error gate relative to
   max|y|: 1e-13 in f64, 1e-5 in f32 (another summation order over 36*K
   terms). Times with CUDA events: kernel, plain version, bound (the bytes
   the product must move over the card's datasheet bandwidth) and one
   torch.sparse BSR product as a yardstick the port never calls. Then
   stencil_spmv_f32v (f32 values, f64 x and y; the f64 CG matvec over an
   f32 operator, no TPU kernel's counterpart) against its plain version on
   the same operators cast to f32 with a random f64 x, gate F32V_GATE
   (1e-13) of max|y|; times as above, the bound 4 bytes per value and 8
   per x and y entry, the yardstick the f64 BSR product of the cast-up
   operator.
2b. The class-stencil kernel against its plain version on the card, on
   class tables built by the port (64x64 quad K=9 and tri K=7, 1024x1024
   tri): the f64 operator, the f32 operator, the fused w * (b - A x) form
   and the E term. Error gate relative to max|y|: 1e-13 in f64, 1e-5 in
   f32 (the band deltas cancel against the interior row to the same
   ~eps*|c_int|*|x| in both versions; measured 1.6e-7). Times with CUDA
   events: kernel, plain version, bound (bytes the launch must move over
   the datasheet bandwidth, or its operations over the vector peak,
   whichever is larger) and one torch.nn.functional.conv2d (6->6, 3x3,
   zero padding: the interior term only) as a yardstick the port never
   calls. Each form's device time per launch also comes from
   torch.profiler (at 64x64 the events time the host's per-call cost). The
   same launch through the all-36-term instance of the kernel (the instance
   a table outside the flat-shell pattern takes) is gated and timed beside
   it, and the ptxas line and the SASS instruction counts of every
   instance are recorded.
2c. The pair path's kernels against their plain versions on the card, on
   class-consistent operators built by the port (64x64 quad and tri,
   1024x1024 tri): stencil_spmv_sym<double> (the symmetric-storage CG
   matvec, gate 1e-13 of max|y|) and stencil_resid_dd<double> (the
   compensated residual, gate 1e-15 of the term scale, max over rows of
   sum |a x|). At 64x64 the full pair residual (kernel minus the E term)
   of a smooth field against a numpy-longdouble oracle from the port's
   ExactStencil must err at most 1e-2 of the plain-f64 residual's error:
   compensation happens on the card. Times with CUDA events: kernel,
   plain version, bound (bytes over the datasheet bandwidth, or operations
   over the f64 vector peak) and one torch.sparse BSR product of the full
   operator (for the residual: the product and b - y, uncompensated) as a
   yardstick the port never calls.
2d. The element-stiffness kernel (elem_stiffness<3>, Tri-3, and <4>,
   Quad-4) against its plain version on the card, on the element
   coordinates the grid assembly gives it: every strip of the 1024x1024
   tri and quad fine levels (strips of 65536 // nxp element rows, as
   LargeShellSystem.assemble_df cuts them; the tri level's first strip also
   timed alone) and of the 64x64 plates, plus the first 1024x1024 strip
   warped out of plane (z = 0.3 sin x cos 0.7y, so the local frames turn).
   Error gate ELEM_GATE of each element's max|ke|. 200 warped elements per
   family are also held against the numpy-longdouble element of
   ops/elements_ld.py, at the same gate. Two launches on a level's first
   strip must be equal bit for bit, and the Quad-4 ke equal to its
   transpose (the kernel writes each node-pair block's transpose from the
   same registers). Times with CUDA events: the kernel over a whole level
   (the sum of its launches), the plain version, and the bound (the bytes
   of xyz and ke over the datasheet bandwidth, or the operations counted
   from the reference math over the f64 vector peak, whichever is
   larger); beside them the kernel's device time per launch from
   torch.profiler (at 64x64 the events hold the host's per-call cost). No
   single library call computes a shell element stiffness, so there is no
   library time. Then elements off any grid, as ShellSystem gives them:
   Tests A, B and E (the I-beam's web and flanges lie in three planes), the
   mixed I-beam's tri and quad elements, and 1, 31, 33 and 65 randomly
   shaped, rotated and placed Quad-4 elements (partial blocks of the
   32-element Quad-4 block), each against the plain version at
   ELEM_CASE_GATE of each element's max|ke|, and ke equal to its transpose
   bit for bit in both families.
3. Test-G, quad and tri at 64x64 (bench.py parameters, rtol 1e-9,
   maxiter 400) through MultigridShellSystem(...).solve_fused: centre
   deflection against the thesis goldens (relative error < 1e-4),
   iteration counts within 1 of the JAX package's f64 counts, the
   kernels' launch counts (stencil_spmv, and elem_stiffness once per
   strip and family of every level: the levels come from the grid
   assembly), and repeated solves equal bit for bit. The assembly of every
   level is timed apart, through the grid pipeline (the path's) and
   through LargeShellSystem.assemble() (the element kernel per chunk and
   the pass-by-pass scatter).
4. Scale: the same program at 1024x1024 tri (2,097,152 elements,
   6,303,750 DOF, 7 levels) and quad (1,048,576 elements, the same DOF;
   every level's elem_stiffness<4> launches on the main path), centre
   deflection against the analytic Kirchhoff value at relative error <
   1e-3, two solves bitwise equal, elem_stiffness launches as phase 3
   counts them; iterations and peak memory recorded.
5. The scale path of bench.py bench_scale at 1024x1024 tri:
   MultigridShellSystem(mesh, mat, dtype=float32, df_operator=True,
   smoother="chebyshev"), stage_forces, a warm-up
   solve_df_refined(rtol=1e-9, return_device=True), then reassemble() +
   solve twice (the second pair is the steady state, counted and
   reported; the first is *_first), fetch_solution. Gates: centre
   deflection within 1e-3 of the Kirchhoff value, final true residual
   <= 9.7e-4 (the JAX package's df floor at this size), a finite
   history, the 58 inner iterations of every run since the class path
   came to the card, class-kernel launches >= the count from the code, no
   stencil_spmv<double> launch (no fine operator exists), and
   elem_stiffness<3> launched in the steady reassemble() exactly as often as
   the grid assembly of the coarse levels needs (strips x families). Then
   the class path on the Test-G plates, 64x64 quad and tri, against the
   goldens (relative 1e-4).
6. The pair path: phase 5's sequence with class_operator=False at
   1024x1024 tri (the materialized fine operator; solve_df_refined swaps
   in the class-consistent one). Gates: centre within 1e-3 of the
   Kirchhoff value, final true residual <= 9.7e-4, a finite history, 58
   inner iterations,
   stencil_spmv_sym<double> launches >= the CG iterations,
   stencil_resid_dd<double> and class_stencil<float> (the E term)
   launches equal to the refinement passes, no stencil_spmv<double>
   launch in the steady pair, and elem_stiffness<3> launched in the steady
   reassemble() as often as the grid assembly of all seven levels needs.
   Then the pair path on the 64x64 Test-G plates against the goldens
   (relative 1e-4).
7. The grid assembly alone: LargeShellSystem.assemble_df(method="grid")
   of the 1024x1024 tri and quad fine levels against assemble() (the
   element kernel per chunk and the pass-by-pass scatter), gate 1e-13 of
   max|A| (the JAX package's
   grid-against-f64 contract, tests/test_assemble_grid.py), two grid
   assemblies bitwise equal, its diagonal equal to soa_diagonal, and
   elem_stiffness launched once per strip and family; seconds and peak
   memory of each assembly.
8. The stand-alone solver. ShellSystem (block-ELL, block-Jacobi PCG, rtol
   1e-12) on the goldens A-F of tests/test_golden.py at its tolerances (A
   and the mixed I-beam also through method="dense"), elem_stiffness
   launched once per element family present per assembly; Test-G quad and
   tri (64x64) through ShellSystem and through MultigridShellSystem(mesh,
   mat).solve (f64 levels, rtol 1e-10): centres within 1e-8 of the JAX
   package's f64 CPU solves and within 5e-5 of bench.py's goldens,
   block-Jacobi iterations to rtol 1e-10 within 2 % (the count to 1e-12
   is recorded: it falls where a residual stalled at its rounding floor
   first dips under 1e-12, see JAX_SYSTEM_G; the iteration where the
   rtol-1e-12 history first reaches 1e-11, the floor, within 2 % of
   FLOOR_ITERS) and multigrid iterations within one of the JAX counts, two
   solves bitwise equal, every multigrid matvec of the solve through
   stencil_spmv<double> (exactly one per CG iteration plus seven per
   V-cycle and non-coarsest level) and none through <float>; each
   smoothing level's stencil_spmv<double> against stencil_spmv_plain
   (1e-13 of max|y|), and one V-cycle against the same V-cycle with the
   plain matvec at every level (VCYCLE_GATE); seconds, seconds per CG
   iteration and peak memory. The
   block-ELL matvec (PyTorch: a gather and a batched 6x6 product) timed
   against its bytes bound at 64x64 and on a 1024x1024 quad pattern. Then
   MultigridShellSystem.solve at 1024x1024 tri: converged to rtol 1e-10,
   centre within 1e-3 of the Kirchhoff value, two solves bitwise equal,
   its seven levels' matvecs and one V-cycle against the plain version.
   Last, python -m fem_shell_tpu_torch.meshgen and python -m
   fem_shell_tpu_torch.utils.cli in subprocesses on the card (the default
   route and --precond mg): exit 0 and the .vtu displacements equal to the
   library solve of the same files.
9. Curved shells, the Scordelis-Lo roof (fem_shell_tpu_torch/shells.py).
   ShellSystem at n = 8, 16, 32: midside w within 1e-4 of the goldens of
   tests/test_shells.py, one elem_stiffness<4> launch per assembly. The
   512x512 roof (1,579,014 DOF, 6 levels) through
   MultigridShellSystem(dtype=float32, df_operator=True, df_cycle=True,
   smoother="chebyshev"): constructor, solve_df(rtol=1e-9) three times
   (the third after reassemble()), every level f64 and every level below
   the fine one a Galerkin RAP (9 offsets); gates: rtol reached, the true
   residual through stencil_spmv<double> as a backward error ||b - A x|| /
   || |A| |x| || at most ROOF_BACKWARD_ERR (and ||b - A x|| / ||b||
   recorded), midside w within 1e-6 of ROOF_W512, at most
   ROOF_MAX_ITERS iterations, three solves bitwise equal, one
   stencil_spmv_sym<double> per CG iteration and seven stencil_spmv<double>
   per smoothing level and V-cycle, elem_stiffness<4> for level 0 only (in
   the constructor and in reassemble), no stencil_spmv<float>; then
   reassemble(profile=True) for the stage split, a profiled solve of
   ROOF_PROFILE_ITERS iterations, and each level's stencil_spmv<double> and
   one V-cycle against the plain version. At 256x256 on f64 levels
   (Chebyshev): cycle V, K and K with k_depth=1 reach rtol 1e-9, K in fewer
   iterations than V, their midside w within 1e-6 relative; W recorded
   (gated finite). solve_fused with coarse_op="galerkin" on the 64x64
   Test-G plates: goldens within 1e-4, iterations within one of
   JAX_GALERKIN_ITERS, elem_stiffness for level 0 only. The pair path
   (df_operator=True, no df_cycle) with Galerkin levels on the 64x64 and
   128x128 roofs, solve_df(rtol=1e-6): iterations within 5 % and midside w
   within 1e-4 of the port's own CPU run (ROOF_PAIR_CPU).

10. Unstructured meshes. (a) LargeShellSystem(reorder="rcm").assemble()
   of the 416x416 quad plate renumbered by
   np.random.default_rng(1).permutation (173,889 nodes, 1,043,334 DOF;
   gather mode, K=9): against the same assembly with the plain element
   math on the card at 1e-13 of max|A|, two assemblies bitwise equal,
   elem_stiffness<4> once per 16,384-element chunk and the plain element
   math never called; the gather-mode matvec timed against its bytes
   bound. (b) AMGShellSystem(mesh, mat) (f64, W cycle, RCM), its
   constructor timed with the set-up stages, solve(rtol=1e-10,
   maxiter=200) twice: residual <= 1e-10, fewer than 100 iterations and
   within 2 of the JAX package's CPU count (JAX_AMG_416), the centre within
   1e-3 of the Kirchhoff value, two solves bitwise equal, the fine
   assembly through elem_stiffness<4>; seconds per iteration, peak memory,
   a profiled short solve and the cycle's products against their bytes
   bounds. (c) AMGShellSystem(mesh, mat, dtype=float32,
   df=True).solve_df_refined(rtol=1e-9) (the CLI's --precond amg
   --refined): final true residual < 1e-9, a finite history, the centre
   within 1e-3, u within 1e-6 of max|u| of (b). (d) LargeShellSystem's
   routes: the Test-E I-beam with RCM and block-Jacobi within 1e-12 of
   ShellSystem; solve_df_refined(rtol=1e-11, inner_rtol=1e-6) of a
   renumbered (gather mode) and a plain (stencil mode) 64x64 plate within
   1e-8 of ShellSystem, with stencil_spmv<double> = CG iterations +
   passes and stencil_resid_dd<double> = passes in stencil mode (none in
   gather mode); the I-beam refined twice through AMG within 1e-7 of the
   f64 Jacobi-PCG LargeShellSystem. (e) The solver CLI in subprocesses
   (--precond amg, --precond amg --refined, --reorder rcm, --refined) on a
   written 64x64 plate: exit 0 and the .vtu displacements equal to the
   library calls'.

11. The coupled solver and stress recovery. (a) The tower demo
   (coupling/demo.py run_demo, 63 nodes, in-process transport) for 30
   steps once on the CPU and twice on the card: per-step solutions within
   1e-10 of max|u| of the CPU run, the same coupling iterations in every
   step, one elem_stiffness<3> launch per run (the operator is assembled
   and factored once), two runs bitwise equal, the tip |u_x| correlated
   with 1 + sin(t/25.01) above 0.999; ms per coupling iteration (solve and
   host coupling work, from the run's PerfLog scopes), CG iterations per
   solve, ms per CG iteration. (b) python -m
   fem_shell_tpu_torch.coupling.fluid_cli and .structure_cli as two
   subprocesses over TCP (the tower XML on a free port, the mesh written
   by the port's meshgen), 10 steps: both exit 0, the Exodus series within
   1e-12 of max|u| of (a)'s first 10 steps; each peer killed after
   PEER_TIMEOUT_S. (c) The tower with each cell split 16 x 16 (10,593
   nodes, 63,558 DOF, 673 interface nodes) against the unchanged 43-node
   dummy fluid, TOWER_SCALE_STEPS (3) steps, twice: every window under
   the XML's 40-iteration cap, one elem_stiffness<3> launch per run, two
   runs bitwise equal, the last step within 1e-8 of max|u| of ShellSystem.solve(rtol=1e-12) of
   its load; s per step, CG iterations, ms per CG iteration, the idle
   share of one profiled step, peak memory. (d) recover_stresses and
   recover_stresses_nodal on the card on phase 4's converged 1024^2 tri
   and quad fields: the centre node's nodal Mx, My within 5 % (tri) / 2 %
   (quad) of 0.0479 q a^2, the nodal vm maximum within 6 % of the corner
   twisting value, the element-centre peak moment within 5 %, two calls
   bitwise equal, seconds and peak memory; on phase 3's 64x64 fields the
   card's fields within 1e-12 of max|field| of the CPU's. (e) python -m
   fem_shell_tpu_torch.utils.cli --stress in three concurrent subprocesses
   (a 64x64 plate as .xda and as .xdr, the thesis example as .msh): every
   .vtu point and cell array equal bit for bit to the library calls.

12. The differentiable solve and the f32 systems. (a) The compliance c =
   f^T u of the tower split 16 x 16 (63,558 DOF) under a lateral load of 1
   in x on each interface node, through ShellSystem._solve_pcg_impl(...,
   differentiable=True) in f64 to rtol 1e-12, and its gradients in the
   loads and the coordinates: central differences on the card at the three
   largest entries of each (rtol 1e-5 loads, 1e-4 coordinates), two
   forward + backward passes equal bit for bit, elem_stiffness<3>
   launched once per forward and never in the backward, the forward and
   adjoint CGs at their rtol; forward and backward seconds, the backward's
   parts timed alone (adjoint CG, element vjp, nodal sum), iterations and
   peak memory. The 16x16 Test-G quad plate's gradients on the card against
   the port's CPU ones at 1e-10 of their max. (b) On the 64x64 Test-G quad
   and tri plates, each f32 route twice: ShellSystem(dtype=float32).solve
   and LargeShellSystem(dtype=float32).solve to rtol 1e-6, its solve_df to
   1e-9, MultigridShellSystem(dtype=float32).solve to 1e-6 and solve_df to
   1e-9: the rtol reached, two calls equal bit for bit, the centre and
   the iteration count against the same route's f32 solve on the CPU
   (F32_CPU: the centres within F32_CENTRE_SPREAD of the CPU's departure
   from the f64 centre, the counts within F32_ITER_SPREAD),
   stencil_spmv<float> and stencil_spmv_f32v launches as the code
   predicts them; seconds per solve, ms per iteration, departures. The
   scaling s of the f32 solve_df on the card equal bit for bit to s taken
   on the CPU from the same diagonal, and the card's f32 operator against
   the CPU's cast, entries that differ counted. The solver CLI's --f32, --f32 --precond mg and
   --f32 --precond mg --df in subprocesses on a 64x64 plate: exit 0, the
   rtol reached and the .vtu displacements equal to the library solve of
   the same files. (c) run_structure(dtype=float32) on the 30-step tower
   demo (rtol 1e-5) on the CPU and on the card: the same coupling
   iterations, solutions within F32_TOWER_GATE (1e-3) of max|u| of the
   CPU's, one elem_stiffness<3> launch.

13. The sharded solvers (parallel/), after a first line with the GPU
   count (torch.cuda.device_count() and nvidia-smi -L). (a)
   parallel/dryrun.py's paths 1-7, path 2's strip again to rtol 1e-10
   ("2t"), the 2-D process grid (5, and 5b in f64) and the sharded grid
   assembly (6), over two gloo ranks on the card, over NCCL on min(count,
   4) ranks (and on two where there are more GPUs) in background
   processes beside it, over gloo at that count too, and over two gloo
   ranks on the host's CPU in a background process started with the
   script: every dry-run assert; each card answer within DRYRUN_U_GATE of
   max|u| of the CPU ranks' (1e-9; path 2, a CG stopped at rtol 1e-6,
   1e-8; paths 4 and 6, the f32 V-cycle, 1e-6) with the iterations within
   DRYRUN_ITER_GATE; a second solve bit for bit; gloo and NCCL bit for bit
   where they ran the same rank count. (b) Test-G quad SHARD_N^2
   (6,303,750 DOF) written by the port's meshgen (beside (a)) and solved
   by the CLI's --devices 2 --precond mg --backend gloo (and nccl with two
   GPUs) in a subprocess: exit 0, fewer than 40 iterations, the rtol; then
   on two gloo ranks in this process ShardedMGShellSystem (f64) and
   ShardedMGDFShellSystem.solve_df(rtol=1e-9): the centre within 1e-3 of
   0.1064045 and 1e-6 of the single-device f64
   MultigridShellSystem.solve, the compensated true residual on the
   single-device operator within twice that solve's (an f64 iterate's
   floor, far above 1e-9 at this size), fewer than 40 iterations; build
   and solve seconds, s per iteration, halo and psum bytes per iteration
   per rank, peak bytes and kernel launches per rank; each rank's padded
   window stencil_spmv (f64, and f32 in the MG-df cycle) against the
   plain slice-and-einsum version (ERR_GATE), with their times. (e), on
   the same ranks, Test-G quad SHARD_N^2 from meshgen.generate (the class
   tables need a uniform grid; the .xda coordinates are print-rounded)
   and its own single-device f64 MultigridShellSystem.solve:
   GridShardedDFShellSystem(prec="mg").solve_refined(rtol=1e-9), its
   operator from the sharded grid assembly: the centre as in (b), fewer
   than 40 iterations per inner
   solve, the class-table true residual below max(1e-9, twice that of the
   single-device solve), each rank's rows against the single-device
   assemble_grid (bit for bit off the fold row, 1e-14 of max|A| on it),
   elem_stiffness<4> launches per rank = its grid strips + the coarser
   levels' chunks (no fine-level scatter), peak bytes per rank at most
   GRID_ASM_PEAK, the ranks' stencil_spmv and the controller's class
   kernels against their plain versions. (d) The 2-D process grid 2x2 on
   four gloo ranks sharing the card (started beside (a)): Test-G quad
   64^2 to rtol 1e-10 (centre within 5e-5 of 0.106465, within 1e-8 of
   max|u| of the single-device f64 MultigridShellSystem.solve), then (e)'s
   1024^2 plate over GRID2D_ITERS CG iterations: build s, ms per
   iteration, halo bytes per iteration per rank beside the strip's, peak
   bytes per rank, each rank's tile stencil_spmv (f64 and f32) against
   the plain 9-slot loop (ERR_GATE). (c) The
   tower demo's first SHARD_TOWER_STEPS steps with run_structure(devices=2)
   (gloo) against devices=1: the same coupling iterations in every step,
   every step within SHARD_TOWER_GATE (1e-10) of max|u|. The ranks' kernel
   launches join the kernels line. Each phase's title carries the
   seconds since the start.

Prints one JSON line with every ported kernel, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
"""
import json
import platform
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

GOLDEN = {"q": 0.106465, "t": 0.106413}  # bench.py:48 (doc/validation.tex:518)
KIRCHHOFF = 0.1064045  # bench.py:157, analytic (doc/validation.tex:264-281)
# CG iterations of the JAX package's MultigridShellSystem(mesh, mat,
# dtype=float64, assemble=False).solve_fused(forces, rtol=1e-9, maxiter=400,
# arith="f64") on the CPU for the 64x64 Test-G plates, produced with
#   JAX_PLATFORMS=cpu python -c "import jax; jax.config.update('jax_enable_x64', True);
#     import jax.numpy as jnp; from fem_shell_tpu.materials import Material;
#     from fem_shell_tpu.meshgen import MeshGenParams, generate;
#     from fem_shell_tpu.mg import MultigridShellSystem as M
#     for et in 'qt':
#       m, r, f = generate(MeshGenParams(et, 64, 64, 0, 0, 10, 10, (0,0,0,0), 300.0, 2, et == 'q', 'z'))
#       s = M(m, Material(0.3, 1e7, 0.5), dtype=jnp.float64, assemble=False)
#       s.solve_fused(r * f, rtol=1e-9, maxiter=400, arith='f64'); print(et, s.last_iters)"
JAX_F64_ITERS = {"q": 18, "t": 41}
ERR_GATE = {torch.float32: 1e-5, torch.float64: 1e-13}
# datasheet device-memory bandwidth (bytes/s) and vector (non-tensor-core)
# peak rates (flop/s) by card; the first matching key wins
CARDS = (
    ("H100 PCIe", 2.0e12, {torch.float32: 51.2e12, torch.float64: 25.6e12}),
    ("H100 NVL", 3.9e12, {torch.float32: 60e12, torch.float64: 30e12}),
    ("H100", 3.35e12, {torch.float32: 67e12, torch.float64: 34e12}),
    ("H200", 4.8e12, {torch.float32: 67e12, torch.float64: 34e12}),
)
KERNELS = {
    torch.float32: {
        "name": "stencil_spmv<float>",
        "replaces": "fem_shell_tpu/ops/pallas_spmv.py:49",
    },
    torch.float64: {
        "name": "stencil_spmv<double>",
        "replaces": "fem_shell_tpu/ops/pallas_spmv_df.py:102",
    },
}
SOURCE = "fem_shell_tpu_torch/csrc/stencil_spmv.cu"
CLASS_KERNELS = {
    torch.float32: {
        "name": "class_stencil<float>",
        "replaces": "fem_shell_tpu/ops/pallas_class.py:130",
    },
    torch.float64: {
        "name": "class_stencil<double>",
        "replaces": "fem_shell_tpu/ops/pallas_class.py:163",
    },
}
CLASS_SOURCE = "fem_shell_tpu_torch/csrc/class_stencil.cu"
PAIR_KERNELS = {
    "resid": {"name": "stencil_resid_dd<double>", "replaces": "fem_shell_tpu/ops/pallas_spmv_df.py:102",
              "source": "fem_shell_tpu_torch/csrc/stencil_resid.cu", "count": "resid"},
    "sym": {"name": "stencil_spmv_sym<double>", "replaces": "fem_shell_tpu/ops/pallas_spmv_df.py:402",
            "source": "fem_shell_tpu_torch/csrc/stencil_spmv_sym.cu", "count": "sym"},
}
SYM_GATE = 1e-13  # of max|y|: f64, another summation order than the plain version
RESID_GATE = 1e-15  # of the term scale: both sum in double-double
ELEM_KERNELS = {
    3: {"name": "elem_stiffness<3>", "replaces": "fem_shell_tpu/ops/pallas_elem.py:627",
        "kernel": "tri_stiffness_kernel"},
    4: {"name": "elem_stiffness<4>", "replaces": "fem_shell_tpu/ops/pallas_elem.py:627",
        "kernel": "quad_stiffness_kernel"},
}
ELEM_SOURCE = "fem_shell_tpu_torch/csrc/elem_stiffness.cu"
# of each element's max|ke|, kernel against the plain version and against
# the longdouble element. The Quad-4 frame projects absolute coordinates
# (the reference's algorithm), so an element of size h at distance |x|
# from the origin loses ~|x|/h ulps in its local edge lengths: ~1000 on the
# 1024^2 plate, where the warped strip measured 2.9e-13 against the plain
# version and 4.4e-13 against longdouble (both versions alike; flat
# elements 1.7e-16). 1e-12 covers that with a margin of 2.3.
ELEM_GATE = 1e-12
# f64 operations per element of the reference math, counted from the
# one-thread-per-element form of csrc/elem_stiffness.cu (an add, multiply,
# divide, square root or comparison one each, an fma two), before the
# compiler folds the constant quadrature terms; the Quad-4 kernel's eight
# threads per element repeat the frame and the B columns, which is not
# counted, so the bound reads the same work whatever implements it. Tri-3:
# frame 67 + membrane 257 + plate 3 x (609 Specht B + 135 Y B + 450
# B^T D B) + 79 + 9 node-pair blocks x 365 (drilling term, four 3x3
# rotations R^T L R) = 7270. Quad-4: frame 126 + membrane 4 x 480 + plate
# 88 + 4 x 1183 + 16 x 365 = 12706.
ELEM_OPS = {3: 7270, 4: 12706}
GRID_GATE = 1e-13  # of max|A|
# of each element's max|ke|: elements off the grid, near the origin
ELEM_CASE_GATE = 1e-13
# the JAX package's f64 solves of the 64x64 Test-G plates on the CPU with
# x64: ShellSystem(mesh, mat).solve(forces, rtol=1e-12, maxiter=20000)
# (block-Jacobi PCG): CG iterations, centre deflection, and the iterations
# of the same solve at rtol 1e-10; MultigridShellSystem(mesh,
# mat).solve(forces, rtol=1e-10): CG iterations and centre deflection.
# Block-Jacobi PCG on these plates stalls at its rounding floor (~1e-12 to
# 1e-11 of ||b||) from iteration 784 (quad) / 2494 (tri): where a history
# first dips under 1e-12 then depends on the last bits of every sum (the
# JAX package's own operator in an eager loop took 2617 / 2507, the port's
# 2282 / 3758 on the CPU; tools/torch_pcg_floor_probe.py), so the iteration
# gate is taken at rtol 1e-10, before the floor, where every run so far
# counts the same (779 / 2483).
JAX_SYSTEM_G = {"q": (1583, 0.10646538200876869, 779), "t": (5004, 0.10641333659903551, 2483)}
# the first iteration whose relative residual is at most 1e-11 in the
# port's rtol-1e-12 history on the CPU (tools/torch_pcg_floor_probe.py):
# where the descent stops and the floor starts (1e-10 came 5 / 11
# iterations earlier, 1e-12 another 1498 / 1264 later); gated within 2 %
FLOOR_ITERS = {"q": 784, "t": 2494}
# of max|y|: one f64 V-cycle against the same V-cycle with every level's
# matvec the plain version (another summation order; on the CPU, two orders
# of the plain loop differ by 4e-15 at 64^2 and 1.7e-14 at 256^2)
VCYCLE_GATE = 1e-12
JAX_MG_G = {"q": (20, 0.10646538200868508), "t": (44, 0.10641333659918732)}
# the JAX package's refined 1024^2 tri solve reached this true residual,
# its df representation floor at that size (BENCH_r05.json)
JAX_SCALE_FLOOR = 9.7e-4
# inner CG iterations of the port's refined 1024^2 tri solve on the class
# and pair paths, the same in every card run since the class path came to
# the card (PERF.md)
SCALE_INNER_ITERS = 58
# the Scordelis-Lo roof (fem_shell_tpu_torch/shells.py): ShellSystem's
# midside deflections pinned by tests/test_shells.py:20 (gate 1e-4)
ROOF_PINNED = {8: -0.28523, 16: -0.29379, 32: -0.29844}
# the 512^2 roof's midside deflection: the JAX package's df cycle to rtol
# 1e-9 in 871 iterations, which iterative refinement against a host f64
# operator moved by < 1e-7 (ROOF_DFCYCLE.json); gated at 1e-6 absolute,
# the iterations at 960
ROOF_W512 = -0.2966950
ROOF_MAX_ITERS = 960
# the true residual is gated as a normwise backward error ||b - A x|| /
# || |A| |x| || (f64 evaluation): at 512^2 || |A| |x| || is 1.56e9 ||b||,
# so an f64 x carries a true residual of ~eps * 1.56e9 ~ 1e-7 ||b|| by its
# rounding alone (two compensated refinement passes stop at 3.35e-8 ||b||,
# tools/torch_roof_residual_floor.py); a backward-stable f64 solve sits at
# a few eps (the port: 4.6e-16), where np.linalg.inv's amplified null
# vector on the coarsest level (ROADMAP.md "Differences") gave 4.5e-15
ROOF_BACKWARD_ERR = 2e-15
ROOF_PROFILE_ITERS = 50  # iterations of the profiled 512^2 roof solve
# CG iterations of the JAX package's MultigridShellSystem(mesh, mat,
# dtype=float64, assemble=False, coarse_op="galerkin").solve_fused(forces,
# rtol=1e-9, maxiter=400, arith="f64") on the CPU for the 64x64 Test-G
# plates (the JAX_F64_ITERS command with coarse_op="galerkin")
JAX_GALERKIN_ITERS = {"q": 43, "t": 69}
# (CG iterations, midside w) of the port's pair path with Galerkin levels
# on the CPU (the f32 V-cycle sums in another order on the card):
#   python -c "import torch; from fem_shell_tpu_torch import MultigridShellSystem as M
#     from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL as mat, scordelis_lo
#     for n in (64, 128):
#       mesh, f, mid = scordelis_lo(n); s = M(mesh, mat, dtype=torch.float32, df_operator=True,
#         smoother='chebyshev', device='cpu'); u = s.solve_df(f, rtol=1e-6, maxiter=2000)
#       print(n, s.last_iters, repr(float(u[mid, 2])))"
ROOF_PAIR_CPU = {64: (54, -0.29977165876861), 128: (76, -0.30011196323392236)}
# (CG iterations, centre w) of the JAX package's AMGShellSystem(mesh, mat)
# (f64, W cycle, RCM) .solve(forces, rtol=1e-10, maxiter=200) on the 416^2
# quad plate renumbered by np.random.default_rng(1).permutation (1,043,334
# DOF; tests/test_amg.py::test_amg_million_dof), on the CPU with x64:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#     jax.config.update('jax_enable_x64', True); import numpy as np
#     from fem_shell_tpu.amg import AMGShellSystem; from fem_shell_tpu.materials import Material
#     from fem_shell_tpu.mesh import permute_nodes; from fem_shell_tpu.meshgen import MeshGenParams, generate
#     m, r, f = generate(MeshGenParams('q', 416, 416, 0, 0, 10, 10, (0,0,0,0), 300.0, 2, True, 'z'))
#     p = np.random.default_rng(1).permutation(m.n_nodes); a = AMGShellSystem(permute_nodes(m, p),
#     Material(0.3, 1e7, 0.5)); u = a.solve((r * f)[p], rtol=1e-10, maxiter=200)
#     print(a.last_iters, repr(float(u[int(np.nonzero(p == m.n_nodes // 2)[0][0]), 2])))"
# (set-up 64.7 s, solve 66.3 s, residual 8.56e-11, levels 173889 / 31718 /
# 3671 / 484 / 73)
JAX_AMG_416 = (48, 0.1064661181265919)

# phase 12: the differentiable solve and the f32 systems
# 12(a): the compliance c = f^T u of the tower split TOWER_SPLIT x
# TOWER_SPLIT under a lateral load of GRAD_LOAD in x on every interface
# node (a fixed load, simpler than a coupled step's forces), f64, to rtol
# GRAD_RTOL; central differences at the GRAD_PROBES largest entries of each
# gradient with steps FD_EPS (the load: c is quadratic in f, so only the
# solves' rounding enters; the coordinates: ~0.2 % of the 6-8e-3 element
# size) at FD_RTOL, tests/test_autodiff.py's tolerances
GRAD_RTOL = 1e-12
GRAD_MAXITER = 20000
GRAD_LOAD = 1.0
GRAD_PROBES = 3
FD_EPS = {"forces": 1e-3, "coords": 1e-5}
FD_RTOL = {"forces": 1e-5, "coords": 1e-4}
GRAD_PLATE = 16  # the card's gradients against the CPU's at this Test-G quad plate
GRAD_CPU_GATE = 1e-10  # of each gradient's max
# 12(b): the f32 routes at Test-G size
F32_N = 64
F32_RTOL = 1e-6  # the f32 CGs
F32_DF_RTOL = 1e-9  # the f64 CGs over f32 operators (solve_df)
F32V_GATE = 1e-13  # stencil_spmv_f32v against its plain version, of max|y|
# each 12(b) route's f32 solve on the CPU at F32_N^2: (centre w, CG
# iterations), from
#   python3 tools/torch_f32_autodiff_phase.py --device cpu --cpu-reference
# (the f64 centre, MultigridShellSystem.solve to rtol 1e-10: 0.1064653819783077
# quad, 0.10641333662908302 tri). Every f32 route departs 0.08-0.48 from it
# (one f32 rounding of a uniform grid's identical rows is a coherent
# perturbation that kappa amplifies; solve_df's f32 scaling rounds twice
# more), so the card is held to the CPU's f32 solve, not to the f64 one:
# |w_card - w_cpu| at most F32_CENTRE_SPREAD times |w_cpu - w64|, the count
# within F32_ITER_SPREAD of the CPU's plus 2. Spread
# measured before the scaling fix (NVIDIA H100 80GB HBM3, 700 W): centres
# within 1 % of the departure, counts within 2.4 %, but solve_df, whose
# f32 rsqrt differed between card and CPU (1,417 iterations against 774)
F32_CPU = {
    "ShellSystem.solve q": (0.09565519541501999, 2981),
    "LargeShellSystem.solve q": (0.09568542242050171, 2977),
    "LargeShellSystem.solve_df q": (0.08989975954306786, 1417),
    "MultigridShellSystem.solve q": (0.09538683295249939, 13),
    "MultigridShellSystem.solve_df q": (0.09567210507972058, 19),
    "ShellSystem.solve t": (0.11497317999601364, 5569),
    "LargeShellSystem.solve t": (0.11499874293804169, 5864),
    "LargeShellSystem.solve_df t": (0.15722793935666823, 4249),
    "MultigridShellSystem.solve t": (0.11535587906837463, 30),
    "MultigridShellSystem.solve_df t": (0.11498291014909291, 41),
}
F32_CENTRE_SPREAD = 0.05  # |w_card - w_cpu| / |w_cpu - w64|
F32_ITER_SPREAD = 0.05  # |it_card - it_cpu| / it_cpu, plus 2
# 12(c): run_structure(dtype=float32) on the tower demo, its CGs to this
# rtol (an f32 CG does not reach the f64 default 1e-10); the card's
# solutions within F32_TOWER_GATE of max|u| of the CPU's f32 run (both f32
# runs lie ~1.9e-3 from the f64 one, tests/test_torch_coupling.py; the
# gate allows the two CGs' rounding, not the operator's error)
F32_TOWER_RTOL = 1e-5
F32_TOWER_GATE = 1e-3


class Gates:
    """Collects gate failures so every phase reports before the exit."""

    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str):
        print(f"  gate {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failed.append(what)


def card_rates(name: str):
    for key, bw, peaks in CARDS:
        if key in name:
            return bw, peaks
    raise RuntimeError(f"no datasheet rates for {name!r}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time per launch of the kernels whose name contains
    ``kernel`` over ``reps`` calls of ``fn`` (torch.profiler): the kernel
    alone, where cuda_ms also holds the host's per-call cost when that is
    the longer. NaN where the profiler shows none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and kernel in e.key:
            us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            count += e.count
    return us / count / 1e3 if count else float("nan")


def plate(et: str, n: int):
    from fem_shell_tpu_torch import MeshGenParams, generate

    return generate(MeshGenParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))


def bsr_operator(values, offsets):
    """The same operator as one torch.sparse BSR matrix with 6x6 blocks,
    acting on the node-major vector x.T.reshape(-1)."""
    k, npad = values.shape[1], values.shape[2]
    dev = values.device
    nodes = torch.arange(npad, device=dev)
    cols = nodes[:, None] + torch.tensor(offsets, device=dev)[None, :]  # [Npad, K]
    valid = (cols >= 0) & (cols < npad)
    blocks = values.reshape(6, 6, k, npad).permute(3, 2, 0, 1)[valid]  # [nnzb, 6, 6]
    crow = torch.zeros(npad + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(dim=1), 0)
    return torch.sparse_bsr_tensor(crow, cols[valid], blocks.contiguous(),
                                   size=(6 * npad, 6 * npad))


def kernel_phase(gates, shapes, reps, bandwidth, peaks, device="cuda"):
    """Each kernel against its plain version on operators assembled by the
    port; returns one record per (shape, dtype)."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_plain

    mat = Material(0.3, 1e7, 0.5)
    rows = []
    for et, n in shapes:
        mesh, _, _ = plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device=device, chunk=65536)
        v64 = sys_.assemble()
        offs = tuple(int(o) for o in sys_.offsets)
        k, npad = v64.shape[1], v64.shape[2]
        x64 = torch.from_numpy(np.random.default_rng(n).normal(size=(6, npad))).to(device)
        for dtype in (torch.float32, torch.float64):
            v = v64.to(dtype)
            x = x64.to(dtype)
            y = stencil_spmv(v, x, offs)
            y_plain = stencil_spmv_plain(v, x, offs)
            torch.cuda.synchronize()
            scale = float(y_plain.abs().max())
            err = float((y - y_plain).abs().max()) / scale
            tag = f"{et}{n} K={k} Npad={npad} {str(dtype)[6:]}"
            gates.check(err <= ERR_GATE[dtype] and bool(torch.isfinite(y).all()),
                        f"kernel {tag}: max|y-y_plain|/max|y| = {err:.3e} <= {ERR_GATE[dtype]:.0e}")
            r = reps[n]
            ms = cuda_ms(lambda: stencil_spmv(v, x, offs), r)
            plain_ms = cuda_ms(lambda: stencil_spmv_plain(v, x, offs), max(2, r // 10))
            # what this product needs: the kernel skips slots whose target
            # lies outside [0, Npad), and reads every other value once
            slots = sum(npad - abs(o) for o in offs)
            nbytes = (36 * slots + 12 * npad) * v.element_size()
            flops = 72 * slots
            bound_ms = max(nbytes / bandwidth, flops / peaks[dtype]) * 1e3
            bound_by = "bytes" if nbytes / bandwidth >= flops / peaks[dtype] else "operations"
            library_ms, lib_err = None, None
            try:
                with warnings.catch_warnings():  # BSR "beta" and invariant-check notices
                    warnings.simplefilter("ignore", UserWarning)
                    a = bsr_operator(v, offs)
                xa = x.T.reshape(-1, 1).contiguous()
                ya = a @ xa
                lib_err = float((ya.reshape(npad, 6).T - y_plain).abs().max()) / scale
                library_ms = cuda_ms(lambda: a @ xa, max(2, r // 2))
                del a, xa, ya
            except (RuntimeError, NotImplementedError) as e:  # yardstick only
                print(f"  library BSR product unavailable for {tag}: {type(e).__name__}: {e}")
            rec = {
                "shape": f"{et}{n}", "k": k, "npad": npad, "dtype": str(dtype)[6:],
                "max_abs_err": float((y - y_plain).abs().max()), "rel_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_rel_err": lib_err,
                "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6,
            }
            print(f"  {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"library_ms={library_ms} rel_err={err:.2e} "
                  f"({rec['achieved_GBps']:.0f} GB/s)", flush=True)
            rows.append(rec)
            del v, x, y, y_plain
        del v64, x64, sys_
        torch.cuda.empty_cache()
    return rows


def class_work(cp, dtype, fused):
    """(bytes, operations) one class_stencil launch must move and do on
    this grid: the x components any accumulated (a, b, s) term reads, once
    over the real nodes; y written over Npad; on each band node, the band
    entry of every accumulated term whose neighbour lies in the grid; w
    and b read over Npad when fused. Two operations per accumulated term
    whose neighbour lies in the grid (interior, and band again on band
    nodes), one add per output to join the two sums, and two more when
    fused."""
    nyp, nxp, npad = cp.nyp, cp.nxp, cp.npad
    n = nyp * nxp
    iy, ix = np.meshgrid(np.arange(nyp), np.arange(nxp), indexing="ij")
    band = (iy < 2) | (iy >= nyp - 2) | (ix < 2) | (ix >= nxp - 2)
    terms = band_values = cols = 0
    for (dy, dx), m in zip(cp.offs2d, cp.masks):
        inside = (iy + dy >= 0) & (iy + dy < nyp) & (ix + dx >= 0) & (ix + dx < nxp)
        set_bits = bin(int(m)).count("1")
        band_values += set_bits * int((inside & band).sum())
        terms += set_bits * int(inside.sum())
        cols |= int(m)
    terms += band_values  # each band entry read is one more term
    x_comps = sum(any((cols >> (a * 6 + b)) & 1 for a in range(6)) for b in range(6))
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (x_comps * n + 6 * npad + band_values + (12 * npad if fused else 0))
    ops = 2 * terms + 6 * n + (12 * npad if fused else 0)
    return nbytes, ops


def class_kernel_phase(gates, shapes, reps, bandwidth, peaks, device="cuda"):
    """The class-stencil kernel against its plain version on class tables
    built by the port: the f64 operator, the f32 operator, the fused
    w * (b - A x) form and the E term; each also through the kernel's
    all-36-term instance (a copy of the table whose launch arguments name
    it). One record per (shape, form)."""
    import dataclasses

    import torch.nn.functional as F

    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.class_matvec import build_class_parts
    from fem_shell_tpu_torch.ops.class_stencil import class_stencil, class_stencil_plain, pack_launch
    from fem_shell_tpu_torch.ops.exact_stencil import build_exact_stencil

    mat = Material(0.3, 1e7, 0.5)
    rows = []
    for et, n in shapes:
        mesh, _, _ = plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device="cpu")  # pattern and offsets only
        t0 = time.perf_counter()
        st = build_exact_stencil(mesh, mat, sys_.offsets)
        t1 = time.perf_counter()
        cp, _ = build_class_parts(st, sys_.pattern.n_pad, device=device)
        torch.cuda.synchronize()
        tables = {"exact_stencil_s": t1 - t0, "class_parts_s": time.perf_counter() - t1}
        print(f"  {et}{n} host class tables: {tables}", flush=True)
        nn, npad, k = cp.nyp * cp.nxp, cp.npad, len(cp.offs2d)
        rng = np.random.default_rng(n)
        x64 = torch.zeros((6, npad), dtype=torch.float64)
        x64[:, :nn] = torch.from_numpy(rng.normal(size=(6, nn)))
        x64 = x64.to(device)
        w32 = torch.from_numpy(rng.random((6, npad)).astype(np.float32)).to(device)
        b32 = torch.from_numpy(rng.normal(size=(6, npad)).astype(np.float32)).to(device)
        forms = (("f64", cp.a64, x64, None, None), ("f32", cp.hi, x64.float(), None, None),
                 ("fused", cp.hi, x64.float(), w32, b32), ("e", cp.e, x64.float(), None, None))
        for form, tab, x, w, b in forms:
            dtype = x.dtype
            every = dataclasses.replace(tab, launch=pack_launch(
                tab.interior.cpu().numpy(), tab.offs2d, tab.masks, all_terms=True))

            def kern(t=tab):
                return class_stencil(t, x, w=w, b=b)

            def plain():
                return class_stencil_plain(tab, x, w=w, b=b)

            y, y_all, y_plain = kern(), kern(every), plain()
            torch.cuda.synchronize()
            scale = float(y_plain.abs().max())
            err = float((y - y_plain).abs().max()) / scale
            err_all = float((y_all - y_plain).abs().max()) / scale
            tag = f"{et}{n} K={k} Npad={npad} {form}"
            gates.check(err <= ERR_GATE[dtype] and bool(torch.isfinite(y).all()),
                        f"class kernel {tag} (instance {tab.launch.instance}): max|y-y_plain|/max|y| "
                        f"= {err:.3e} <= {ERR_GATE[dtype]:.0e}")
            gates.check(err_all <= ERR_GATE[dtype] and bool(torch.isfinite(y_all).all()),
                        f"class kernel {tag} (all-36 instance {every.launch.instance}): "
                        f"{err_all:.3e} <= {ERR_GATE[dtype]:.0e}")
            r = reps[n]
            ms = cuda_ms(kern, r)
            device_ms = kernel_device_ms(kern, r, "class_stencil_kernel")
            all_ms = cuda_ms(lambda: kern(every), r)
            plain_ms = cuda_ms(plain, max(2, r // 10))
            nbytes, ops = class_work(cp, dtype, w is not None)
            t_bytes, t_ops = nbytes / bandwidth, ops / peaks[dtype]
            bound_ms = max(t_bytes, t_ops) * 1e3
            # yardstick: the interior term alone as one cuDNN convolution
            weight = torch.zeros((6, 6, 3, 3), dtype=dtype, device=device)
            for s_, (dy, dx) in enumerate(cp.offs2d):
                weight[:, :, 1 + dy, 1 + dx] = tab.interior[s_]
            xg = x[:, :nn].reshape(1, 6, cp.nyp, cp.nxp)
            library_ms = cuda_ms(lambda: F.conv2d(xg, weight, padding=1), r)
            rec = {
                "shape": f"{et}{n}", "k": k, "npad": npad, "form": form, "dtype": str(dtype)[6:],
                "instance": tab.launch.instance, "max_abs_err": float((y - y_plain).abs().max()),
                "rel_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "all_terms_ms": all_ms, "all_terms_rel_err": err_all,
                "bytes": nbytes, "ops": ops, "achieved_GBps": nbytes / ms / 1e6, **tables,
            }
            print(f"  {tag}: kernel_ms={ms:.4f} device_ms={device_ms:.4f} all36_ms={all_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({rec['bound_by']}) "
                  f"conv2d_ms={library_ms:.4f} rel_err={err:.2e} ({rec['achieved_GBps']:.0f} GB/s, "
                  f"{100 * bound_ms / ms:.1f} % of the bound; device {100 * bound_ms / device_ms:.1f} %)",
                  flush=True)
            rows.append(rec)
            del y, y_all, y_plain
        del cp, x64, w32, b32
        torch.cuda.empty_cache()
    return rows


def ptxas_by_kernel(log: str):
    """{kernel: 'registers | spills | shared memory'} from an nvcc -Xptxas -v
    log: the 'Used' line and the stack/spill line of each entry function."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name is not None and ("spill" in ln or "Used" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def sass_counts(so_path: str):
    """{kernel: {"instructions", "fma", "lds", "ldg", "stg"}} from cuobjdump
    -sass of a built library (static counts; the kernels' loops are fully
    unrolled), or None where the toolkit has no cuobjdump."""
    from fem_shell_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            cur = out.setdefault(ln.split("Function :")[1].strip(),
                                 {"instructions": 0, "fma": 0, "lds": 0, "ldg": 0, "stg": 0})
        elif cur is not None and "/*" in ln and ";" in ln:
            op = ln.split("*/", 1)[1].strip().split()
            if not op:
                continue
            opc = op[1] if op[0].startswith("@") and len(op) > 1 else op[0]
            cur["instructions"] += 1
            cur["fma"] += opc.startswith(("FFMA", "DFMA"))
            cur["lds"] += opc.startswith("LDS")
            cur["ldg"] += opc.startswith("LDG")
            cur["stg"] += opc.startswith("STG")
    return out


def smooth_field(mesh, nyp, nxp, npad):
    """A plate-deflection-like field [6, npad] (zero on the constrained
    DOFs and the padding), whose A x cancels as a solution's does."""
    iy, ix = np.meshgrid(np.arange(nyp), np.arange(nxp), indexing="ij")
    free = ~mesh.dirichlet_mask()
    x = np.zeros((6, npad))
    for c in range(6):
        x[c, : nyp * nxp] = ((c + 1) * np.sin(np.pi * ix / (nxp - 1) + 0.3 * c)
                             * np.sin(np.pi * iy / (nyp - 1))).reshape(-1) * free[:, c]
    return x


def pair_work(offs, npad):
    """(bytes, operations) of one launch per pair kernel: the slots whose
    target lies inside the vector, read once (for the symmetric form the
    off >= 0 half, whose direct and transposed reads cover the same
    entries), and the vectors (sym: x, y; resid: x, b, r). sym: 2
    operations per direct and per transposed term; resid: 11 per term
    (multiply, fma, six adds of TwoSum, two into the error sum) and one
    add per output."""
    slots = sum(npad - abs(o) for o in offs)
    up = sum(npad - o for o in offs if o >= 0)
    trans = sum(npad - o for o in offs if o > 0)
    return {"sym": ((36 * up + 12 * npad) * 8, 72 * (up + trans)),
            "resid": ((36 * slots + 18 * npad) * 8, 11 * 36 * slots + 6 * npad)}


def pair_kernel_phase(gates, shapes, reps, bandwidth, peaks, device="cuda"):
    """The symmetric-storage SpMV and the compensated residual against their
    plain versions on class-consistent operators built by the port; at 64x64
    the full pair residual against a longdouble oracle. One record per
    (shape, kernel)."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.class_matvec import build_pair_ecorr, pair_ecorr
    from fem_shell_tpu_torch.ops.exact_stencil import (
        build_exact_stencil, class_flat_tables, class_pair_flat, exact_matvec_ld)
    from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd, stencil_resid_dd_plain
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_plain
    from fem_shell_tpu_torch.ops.stencil_spmv_sym import (
        prepare_sym_values, stencil_spmv_sym, stencil_spmv_sym_plain)

    mat = Material(0.3, 1e7, 0.5)
    rows = []
    for et, n in shapes:
        mesh, _, _ = plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device="cpu")  # pattern and offsets only
        offs = tuple(int(o) for o in sys_.offsets)
        npad = sys_.pattern.n_pad
        st = build_exact_stencil(mesh, mat, offs)
        tfl0, tfl1, _, cls = class_flat_tables(st)
        a64, hi = class_pair_flat(tfl0, tfl1, cls, npad, device=device)
        del hi
        up = prepare_sym_values(a64, offs)
        nn, k = st.nyp * st.nxp, len(offs)
        rng = np.random.default_rng(n)
        x = torch.zeros((6, npad), dtype=torch.float64)
        x[:, :nn] = torch.from_numpy(rng.normal(size=(6, nn)))
        x = x.to(device)
        b = torch.from_numpy(rng.normal(size=(6, npad))).to(device)
        tag = f"{et}{n} K={k} Npad={npad}"
        extra = {}
        if n <= 64:
            # compensation on the card: the full pair residual of a smooth
            # field against the longdouble oracle, dd against plain f64
            ec = build_pair_ecorr(st, device=device)
            xs = smooth_field(mesh, st.nyp, st.nxp, npad)
            y_ld = exact_matvec_ld(st, xs[:, :nn])
            bs = np.zeros((6, npad))
            bs[:, :nn] = y_ld.astype(np.float64)
            r_ld = bs[:, :nn].astype(np.longdouble) - y_ld
            xt, bt = torch.from_numpy(xs).to(device), torch.from_numpy(bs).to(device)
            ex = pair_ecorr(ec, xt.float()).double()
            r_dd = (stencil_resid_dd(a64, xt, bt, offs) - ex).cpu().numpy()[:, :nn]
            r_64 = (bt - stencil_spmv(a64, xt, offs) - ex).cpu().numpy()[:, :nn]
            term_s = float(stencil_spmv_plain(a64.abs(), xt.abs(), offs).max())
            err_dd = float(np.abs(r_dd.astype(np.longdouble) - r_ld).max())
            err_64 = float(np.abs(r_64.astype(np.longdouble) - r_ld).max())
            gates.check(0 < err_64 and err_dd <= 1e-2 * err_64,
                        f"pair residual {tag}: dd err {err_dd / term_s:.2e} <= 1e-2 x f64 err "
                        f"{err_64 / term_s:.2e} (of the term scale, longdouble oracle)")
            extra = {"smooth_err_dd": err_dd / term_s, "smooth_err_f64": err_64 / term_s,
                     "smooth_ratio": err_dd / err_64 if err_64 else None}
            del ec, xt, bt, ex
        term = float(stencil_spmv_plain(a64.abs(), x.abs(), offs).max())
        with warnings.catch_warnings():  # BSR "beta" and invariant-check notices
            warnings.simplefilter("ignore", UserWarning)
            bsr = bsr_operator(a64, offs)
        xa = x.T.reshape(-1, 1).contiguous()
        ba = b.T.reshape(-1, 1).contiguous()
        work = pair_work(offs, npad)
        forms = (
            ("sym", lambda: stencil_spmv_sym(up, x, offs), lambda: stencil_spmv_sym_plain(up, x, offs),
             lambda: bsr @ xa, SYM_GATE, None),
            ("resid", lambda: stencil_resid_dd(a64, x, b, offs),
             lambda: stencil_resid_dd_plain(a64, x, b, offs), lambda: ba - bsr @ xa, RESID_GATE, term),
        )
        for form, kern, plain, lib, gate, scale in forms:
            y, y_plain = kern(), plain()
            torch.cuda.synchronize()
            sc = float(y_plain.abs().max()) if scale is None else scale
            err = float((y - y_plain).abs().max()) / sc
            what = "max|y|" if scale is None else "term scale"
            gates.check(err <= gate and bool(torch.isfinite(y).all()),
                        f"{form} kernel {tag}: max|y-y_plain|/{what} = {err:.3e} <= {gate:.0e}")
            r = reps[n]
            ms = cuda_ms(kern, r)
            plain_ms = cuda_ms(plain, max(2, r // 10))
            library_ms = cuda_ms(lib, max(2, r // 2))
            nbytes, ops = work[form]
            t_bytes, t_ops = nbytes / bandwidth, ops / peaks[torch.float64]
            rec = {
                "shape": f"{et}{n}", "k": k, "npad": npad, "form": form,
                "max_abs_err": float((y - y_plain).abs().max()), "rel_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "bytes": nbytes, "ops": ops,
                "achieved_GBps": nbytes / ms / 1e6, **(extra if form == "resid" else {}),
            }
            print(f"  {tag} {form}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) bsr_ms={library_ms:.4f} "
                  f"rel_err={err:.2e} ({rec['achieved_GBps']:.0f} GB/s)", flush=True)
            rows.append(rec)
            del y, y_plain
        del a64, up, bsr, xa, ba, x, b
        torch.cuda.empty_cache()
    return rows


def elem_work(m, ne):
    """(bytes, operations) of elem_stiffness over ne elements: xyz read
    once and ke written once, 8 (3m + 36m^2) bytes per element, and
    ELEM_OPS[m] operations per element."""
    return 8 * (3 * m + 36 * m * m) * ne, ELEM_OPS[m] * ne


def elem_err(ke, ref):
    """(max over elements of max|ke - ref| / max|ref|, max|ke - ref|) for
    [6m, 6m, E] batches."""
    d = (ke - ref).abs().amax(dim=(0, 1))
    return float((d / ref.abs().amax(dim=(0, 1))).max()), float(d.max())


def elem_kernel_phase(gates, cases, bandwidth, peaks, device="cuda"):
    """elem_stiffness against its plain version on the strips the grid
    assembly cuts, and against the longdouble element; one record per
    (shape, family size m). ``cases`` lists (element type, n, reps); the
    largest n also runs the warped strip and the longdouble check."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.mg import detect_structured_grid
    from fem_shell_tpu_torch.ops import elements_ld as eld
    from fem_shell_tpu_torch.ops.assemble_grid import (
        family_coords, family_corners, grid_coords, strip_bounds)
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness, elem_stiffness_plain

    mat = Material(0.3, 1e7, 0.5)
    t = mat.thickness
    dm64, dp64 = mat.matrices()
    dm, dp = (torch.from_numpy(a).to(device) for a in (dm64, dp64))
    dml, dpl = (np.asarray(a, np.longdouble) for a in (dm64, dp64))
    rows = []
    big = max(n for _, n, _ in cases)
    for et, n, reps in cases:
        mesh, _, _ = plate(et, n)
        grid = detect_structured_grid(mesh)
        m = 3 if et == "t" else 4
        strip_rows = max(1, 65536 // grid.nxp)  # assemble_df's default strip_nodes
        corners = family_corners(et, grid.ul_lr)
        cg = grid_coords(grid, mesh.coords, device)
        xyzs = [family_coords(cg, c, r0, rows_e)
                for r0, rows_e in strip_bounds(grid.nyp - 1, strip_rows) for c in corners]
        ne = sum(x.shape[2] for x in xyzs)
        tag = f"{et}{n} m={m} {len(xyzs)} launches of {xyzs[0].shape[2]} elements"
        err = max_abs = 0.0
        finite = True
        for x in xyzs:
            ke, ref = elem_stiffness(x, dm, dp, t), elem_stiffness_plain(x, dm, dp, t)
            e_rel, e_abs = elem_err(ke, ref)
            err, max_abs = max(err, e_rel), max(max_abs, e_abs)
            finite = finite and bool(torch.isfinite(ke).all())
            del ke, ref
        torch.cuda.synchronize()
        gates.check(finite and err <= ELEM_GATE,
                    f"elem kernel {tag}: max|ke-plain|/max|ke| per element = {err:.3e} <= {ELEM_GATE:.0e}")
        extra = {}
        if n == big:
            # the first strip warped out of plane: frames that turn
            c = np.asarray(mesh.coords, np.float64).copy()
            c[:, 2] = 0.3 * np.sin(c[:, 0]) * np.cos(0.7 * c[:, 1])
            cw = grid_coords(grid, c, device)
            w_err = ld_err = plain_ld_err = 0.0
            for corner in corners:
                xw = family_coords(cw, corner, 0, min(strip_rows, grid.nyp - 1))
                ke, ref = elem_stiffness(xw, dm, dp, t), elem_stiffness_plain(xw, dm, dp, t)
                w_err = max(w_err, elem_err(ke, ref)[0])
                sel = np.linspace(0, xw.shape[2] - 1, 200).astype(int)
                xs, ks, rs = xw[:, :, sel].cpu().numpy(), ke[:, :, sel].cpu().numpy(), ref[:, :, sel].cpu().numpy()
                fn = eld.tri_shell_stiffness if m == 3 else eld.quad_shell_stiffness
                for j in range(len(sel)):
                    k_ld = fn(xs[:, :, j], dml, dpl, np.longdouble(t))
                    sc = float(np.abs(k_ld).max())
                    ld_err = max(ld_err, float(np.abs(ks[:, :, j] - k_ld).max()) / sc)
                    plain_ld_err = max(plain_ld_err, float(np.abs(rs[:, :, j] - k_ld).max()) / sc)
                del ke, ref, xw
            gates.check(w_err <= ELEM_GATE,
                        f"elem kernel {et}{n} warped strip: {w_err:.3e} <= {ELEM_GATE:.0e}")
            gates.check(ld_err <= ELEM_GATE,
                        f"elem kernel {et}{n} warped, {len(corners) * 200} elements against longdouble: "
                        f"{ld_err:.3e} (plain {plain_ld_err:.3e}) <= {ELEM_GATE:.0e}")
            extra = {"warped_rel_err": w_err, "ld_rel_err": ld_err, "plain_ld_rel_err": plain_ld_err,
                     "strip_ms": cuda_ms(lambda: elem_stiffness(xyzs[0], dm, dp, t), 20)}
            del cw

        def kern():
            for x in xyzs:
                elem_stiffness(x, dm, dp, t)

        def plain():
            for x in xyzs:
                elem_stiffness_plain(x, dm, dp, t)

        # two launches on the first strip bit for bit; Quad-4 writes each
        # block's transpose from the same registers, so its ke is symmetric
        ke, again = elem_stiffness(xyzs[0], dm, dp, t), elem_stiffness(xyzs[0], dm, dp, t)
        repeat, symmetric = torch.equal(ke, again), torch.equal(ke, ke.transpose(0, 1))
        del ke, again
        gates.check(repeat, f"elem kernel {tag}: two launches bitwise equal")
        if m == 4:
            gates.check(symmetric, f"elem kernel {tag}: ke equal to its transpose")
        ms = cuda_ms(kern, reps, warmup=1)
        device_ms = kernel_device_ms(kern, max(1, reps // 5), ELEM_KERNELS[m]["kernel"])
        plain_ms = cuda_ms(plain, max(2, reps // 5), warmup=1)
        nbytes, ops = elem_work(m, ne)
        t_bytes, t_ops = nbytes / bandwidth, ops / peaks[torch.float64]
        rec = {
            "shape": f"{et}{n}", "m": m, "elements": ne, "launches_per_level": len(xyzs),
            "strip_elements": int(xyzs[0].shape[2]), "max_abs_err": max_abs, "rel_err": err,
            "bitwise_repeat": repeat, "symmetric": symmetric, "ms": ms,
            "device_ms_per_launch": device_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "bytes": nbytes, "ops": ops, "achieved_GBps": nbytes / ms / 1e6, **extra,
        }
        print(f"  {tag}: level kernel_ms={ms:.4f} device_ms/launch={device_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) rel_err={err:.2e} ({rec['achieved_GBps']:.0f} GB/s) "
              f"{' '.join(f'{k}={v:.3e}' for k, v in extra.items())}", flush=True)
        rows.append(rec)
        del xyzs, cg
        torch.cuda.empty_cache()
    return rows


class plain_soa_elements:
    """While active, ``LargeShellSystem.assemble()`` (ops/soa.py) computes
    its element stiffnesses with the plain element math instead of the
    element kernel: a reference independent of the kernel on any device."""

    def __enter__(self):
        from fem_shell_tpu_torch.ops import soa
        from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness_plain

        self.saved = soa.elem_stiffness
        soa.elem_stiffness = elem_stiffness_plain
        return self

    def __exit__(self, *exc):
        from fem_shell_tpu_torch.ops import soa

        soa.elem_stiffness = self.saved


def grid_phase(gates, n, device="cuda"):
    """LargeShellSystem.assemble_df(method="grid") of the n^2 tri and quad
    fine levels against the scatter assembly (assemble()) with the plain
    element math; the kernel and scatter assembly is timed (scatter_s). The
    first grid assembly of each is a run of this slice's path, counted from
    zero."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.assemble_grid import family_corners, strip_bounds
    from fem_shell_tpu_torch.ops.soa import soa_diagonal

    mat = Material(0.3, 1e7, 0.5)
    rows = []
    for et in ("t", "q"):
        mesh, _, _ = plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device=device)
        grid = sys_.grid
        m = 3 if et == "t" else 4
        want = len(strip_bounds(grid.nyp - 1, max(1, 65536 // grid.nxp))) * len(family_corners(et, grid.ul_lr))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        v, d = sys_.assemble_df(method="grid", with_diag=True)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        launches = read_launches()
        grid_peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        v2 = sys_.assemble_df(method="grid")
        torch.cuda.synchronize()
        grid2_s = time.perf_counter() - t0
        same = torch.equal(v, v2)
        del v2
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = sys_.assemble()
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        index_peak = torch.cuda.max_memory_allocated() - base
        del ref
        with plain_soa_elements():  # the reference: the plain element math, apart from the kernel
            ref = sys_.assemble()
        scale = float(ref.abs().max())
        err = float((v - ref).abs().max()) / scale
        tag = f"grid {et}{n} K={v.shape[1]} Npad={v.shape[2]}"
        gates.check(bool(torch.isfinite(v).all()) and err <= GRID_GATE,
                    f"{tag}: max|A_grid - A_plain|/max|A| = {err:.3e} <= {GRID_GATE:.0e} (A_plain: "
                    f"assemble() with the plain element math)")
        gates.check(same and torch.equal(d, soa_diagonal(v, sys_.offsets)),
                    f"{tag}: two grid assemblies bitwise equal, diagonal equal to soa_diagonal")
        gates.check(launches[f"elem{m}"] == want and launches[f"elem{7 - m}"] == 0,
                    f"{tag}: elem_stiffness<{m}> launches {launches[f'elem{m}']} == {want} strips x families")
        rec = {"case": tag, "rel_err": err, "bitwise_equal": same, "grid_s": grid_s,
               "grid_again_s": grid2_s, "scatter_s": index_s, "grid_peak_bytes": grid_peak,
               "scatter_peak_bytes": index_peak, "launches": launches, "expected_elem": want}
        print(f"  {tag}: rel_err={err:.2e} bitwise={same} grid_s={grid_s:.4f} again={grid2_s:.4f} "
              f"scatter_s={index_s:.4f} peak grid={grid_peak} scatter={index_peak} "
              f"elem launches {launches[f'elem{m}']}/{want}", flush=True)
        rows.append(rec)
        del v, d, ref, sys_
        torch.cuda.empty_cache()
    return rows


def device_profile(fn):
    """Kernel time by name over one call of ``fn`` (torch.profiler): the
    device's busy milliseconds (kernels of one stream do not overlap), the
    window's wall milliseconds, and the top kernels. The profiler's own
    host overhead lengthens the window, so the idle share it gives is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms)


def profile_summary(prof, wall_ms):
    """device_profile's record of a finished torch.profiler window of
    ``wall_ms`` milliseconds, from the raw kineto events (key_averages()
    first parses every event into Python objects: ~25 s for a window of
    10^5 launches)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():  # device-side events only: the kernels themselves
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = [(k, ms, count) for k, (ms, count) in by_name.items()]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    def by(name):
        return sum(r[1] for r in rows if name in r[0])

    return {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
        "stencil_spmv_ms": by("stencil_spmv_kernel"), "class_stencil_ms": by("class_stencil_kernel"),
        "stencil_spmv_sym_ms": by("stencil_spmv_sym_kernel"),
        "stencil_resid_ms": by("stencil_resid_dd_kernel"),
        "top": [{"kernel": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:8]],
    }


def assembly_times(mg):
    """Seconds and peak bytes of one assembly of every level of ``mg``:
    through the grid pipeline (what solve_fused runs) and through the
    scatter assembly, assemble() (what it ran before)."""
    out = {}
    for method, run in (("grid", lambda s: s.assemble_df(method="grid", with_diag=True)),
                        ("scatter", lambda s: s.assemble())):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for s in mg._systems:
            run(s)
        torch.cuda.synchronize()
        out[f"{method}_s"] = time.perf_counter() - t0
        out[f"{method}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def solve_phase(gates, et, n, device="cuda", reps=1, golden=None, gate_rel=1e-4,
                jax_iters=None, keep=None):
    """One main-path run of MultigridShellSystem.solve_fused: launch counts
    are reset just before the measured solve and read just after. With
    reps > 1 a warm-up solve comes first and reps-1 more are timed and held
    to the measured one bit for bit; on CUDA one more solve runs under
    torch.profiler. ``keep[f"{et}{n}"]`` receives (mesh, u as host numpy)
    for phase 11's stress recovery."""
    from fem_shell_tpu_torch import Material, MultigridShellSystem

    mesh, rows, fac = plate(et, n)
    forces = rows * fac
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), assemble=False, device=device)
    setup_s = time.perf_counter() - t0
    if reps > 1:
        mg.solve_fused(forces, rtol=1e-9, maxiter=400)  # warm-up: library handles, allocator
    assembly = assembly_times(mg) if cuda else None  # the per-level work solve_fused starts with
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    u = mg.solve_fused(forces, rtol=1e-9, maxiter=400)
    if cuda:
        torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    if keep is not None:
        keep[f"{et}{n}"] = (mesh, u.cpu().numpy())
    times = [solve_s]
    same = True
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        again = mg.solve_fused(forces, rtol=1e-9, maxiter=400)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        same = same and torch.equal(again, u)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    prof = device_profile(lambda: mg.solve_fused(forces, rtol=1e-9, maxiter=400)) if cuda else None
    it, nl = mg.last_iters, mg.n_levels
    w = float(u[mesh.n_nodes // 2, 2])
    err = abs(w - golden) / golden
    tag = f"{et}{n}"
    # one f64 matvec per CG iteration; per non-coarsest level 21 power-
    # iteration matvecs, and 7 per V-cycle (3+3 smoothing sweeps and one
    # residual), the V-cycle applied once before the loop and once per iteration
    want32 = (nl - 1) * (21 + 7 * (it + 1))
    f32, f64 = launches["spmv_f32"], launches["spmv_f64"]
    want_elem = elem_launch_count(mg)
    key_elem = "elem3" if et == "t" else "elem4"
    gates.check(tuple(u.shape) == (mesh.n_nodes, 6) and bool(torch.isfinite(u).all()),
                f"solve {tag}: finite displacements [{mesh.n_nodes}, 6]")
    gates.check(err < gate_rel, f"solve {tag}: centre w {w:.7f} vs {golden}: rel err {err:.2e} < {gate_rel:.0e}")
    gates.check(mg.last_residual < 1e-9, f"solve {tag}: residual {mg.last_residual:.2e} < 1e-9")
    if jax_iters is not None:
        gates.check(abs(it - jax_iters) <= 1, f"solve {tag}: {it} iterations vs JAX f64 {jax_iters} (+-1)")
    if reps > 1:
        gates.check(same, f"solve {tag}: {reps} solves return bitwise-equal displacements")
    if cuda:
        gates.check(f64 >= it and f32 >= want32,
                    f"solve {tag}: launches f64 {f64} >= {it}, f32 {f32} >= {want32}")
        gates.check(launches[key_elem] == want_elem > 0 and launches["class_f32"] + launches["class_f64"] == 0,
                    f"solve {tag}: elem_stiffness launches {launches[key_elem]} == {want_elem} "
                    f"(grid assembly of every level), no class_stencil launch")
    rec = {
        "case": tag, "levels": nl, "iters": it, "residual": mg.last_residual, "center_w": w,
        "rel_err": err, "setup_s": setup_s, "assembly": assembly, "solve_fused_s": times,
        "bitwise_repeat": same if reps > 1 else None, "launches_f32": f32, "launches_f64": f64,
        "launches": launches, "expected_f32": want32, "expected_elem": want_elem,
        "peak_mem_bytes": peak, "profile": prof,
    }
    print(f"  {tag}: levels={nl} iters={it} residual={mg.last_residual:.2e} w={w:.17g} "
          f"rel_err={err:.2e} setup_s={setup_s:.3f} assembly={assembly} "
          f"solve_fused_s={['%.4f' % t for t in times]} bitwise_repeat={rec['bitwise_repeat']} "
          f"launches={launches} peak_mem={peak}", flush=True)
    if prof is not None:
        print(f"  {tag} profile: wall_ms={prof['wall_ms']:.1f} device_busy_ms={prof['device_busy_ms']:.1f} "
              f"idle_share={prof['idle_share']} stencil_spmv_ms={prof['stencil_spmv_ms']:.1f}", flush=True)
        for row in prof["top"]:
            print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    return rec


def rebuild_split(mg, tag):
    """One more reassemble(profile=True): its stage split (each stage ended
    by a device synchronize), printed and returned as {stage: seconds}."""
    print(f"  {tag} reassemble(profile=True):", flush=True)
    mg.reassemble(profile=True)
    return {name.strip(): secs for name, secs in mg.rebuild_profile}


def reset_launches():
    from fem_shell_tpu_torch.ops.class_stencil import class_stencil
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness
    from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_f32v
    from fem_shell_tpu_torch.ops.stencil_spmv_sym import stencil_spmv_sym

    for counts in (stencil_spmv.launches, class_stencil.launches, elem_stiffness.launches):
        for dt in counts:
            counts[dt] = 0
    stencil_resid_dd.launches = stencil_spmv_sym.launches = stencil_spmv_f32v.launches = 0


def read_launches():
    from fem_shell_tpu_torch.ops.class_stencil import class_stencil
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness
    from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_f32v
    from fem_shell_tpu_torch.ops.stencil_spmv_sym import stencil_spmv_sym

    return {"spmv_f32": stencil_spmv.launches[torch.float32],
            "spmv_f64": stencil_spmv.launches[torch.float64],
            "spmv_f32v": stencil_spmv_f32v.launches,
            "class_f32": class_stencil.launches[torch.float32],
            "class_f64": class_stencil.launches[torch.float64],
            "sym": stencil_spmv_sym.launches, "resid": stencil_resid_dd.launches,
            "elem3": elem_stiffness.launches[3], "elem4": elem_stiffness.launches[4]}


def elem_launch_count(mg):
    """elem_stiffness launches of one assembly of mg's levels: every
    materialized level is assembled by the grid pipeline, one launch per
    strip and element family; a Galerkin level (stencil_rap of the level
    above) launches none."""
    from fem_shell_tpu_torch.ops.assemble_grid import family_corners, strip_bounds

    fams = len(family_corners(mg.grid.elem_type, mg.grid.ul_lr))
    first = 1 if mg._cdf is not None else 0  # the class level is not assembled
    last = 1 if mg.coarse_op == "galerkin" else mg.n_levels  # Galerkin levels are RAPs
    return sum(len(strip_bounds(lvl.nyp - 1, max(1, mg._df_strip_nodes // lvl.nxp))) * fams
               for lvl in mg.levels[first:last])


def class_launch_counts(mg):
    """Class-kernel launches of one reassemble() + solve_df_refined from
    the code: f64 = one CG matvec per inner iteration + one residual per
    refinement pass; f32 = 21 power steps (level 0) + 7 per V-cycle
    application (3 + 3 smoothing sweeps, one residual; one application
    before each CG loop and one per iteration) + one E term per pass."""
    inner, hist = mg.refine_inner_iters, mg.refine_history
    f64 = sum(inner) + len(hist)
    f32 = 21 + 7 * (sum(inner) + len(inner)) + len(hist)
    return f64, f32


def pair_launch_counts(mg):
    """Launches of one pair-path reassemble() + solve_df_refined from the
    code: the CG matvec = one per inner iteration (stencil_spmv_sym<double>
    with symmetric storage, else stencil_spmv<double>); one compensated
    residual and one E term (class_stencil<float>) per refinement pass;
    stencil_spmv<float> on every non-coarsest level, 21 power steps and 7
    per V-cycle application (one before each CG loop, one per
    iteration)."""
    inner, hist = mg.refine_inner_iters, mg.refine_history
    cg, passes = sum(inner), len(hist)
    return cg, passes, (mg.n_levels - 1) * (21 + 7 * (cg + len(inner)))


def class_solve_phase(gates, et, n, device="cuda", golden=KIRCHHOFF, gate_rel=1e-3,
                      steady=True, pair=False):
    """The scale path of bench.py bench_scale: the df_operator system with
    the class-table fine level (or, with ``pair``, class_operator=False:
    the materialized fine operator), staged forces, solve_df_refined. With
    ``steady`` the warm-up solve, two reassemble()+solve pairs (the second
    counted and reported) and a profiled solve follow bench_scale; without
    it one solve runs, counted. The class path may launch no
    stencil_spmv<double>; the pair path none in its steady pair, where its
    CG runs from symmetric storage."""
    from fem_shell_tpu_torch import Material, MultigridShellSystem

    mesh, rows, fac = plate(et, n)
    forces = rows * fac
    tag = f"{'pair' if pair else 'class'} {et}{n}"
    ctr = mesh.n_nodes // 2
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), dtype=torch.float32, df_operator=True,
                              smoother="chebyshev", device=device,
                              **({"class_operator": False} if pair else {}))
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    f_dev = mg.stage_forces(forces)
    times = {"ctor_s": ctor_s}
    if steady:
        mg.solve_df_refined(f_dev, rtol=1e-9, return_device=True)  # warm-up
        for label in ("_first", ""):
            if not label:
                spmv64_before = read_launches()["spmv_f64"]
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mg.reassemble()
            torch.cuda.synchronize()
            times["reassemble" + label + "_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            x_dev = mg.solve_df_refined(f_dev, rtol=1e-9, return_device=True)
            w = float(x_dev[2, ctr])  # a value only the finished solve has
            times["solve" + label + "_s"] = time.perf_counter() - t0
    else:  # counted from the constructor on
        spmv64_before = 0
        t0 = time.perf_counter()
        x_dev = mg.solve_df_refined(f_dev, rtol=1e-9, return_device=True)
        w = float(x_dev[2, ctr])
        times["solve_s"] = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    u = mg.fetch_solution(x_dev)
    hist = list(mg.refine_history)
    err = abs(w - golden) / golden
    gates.check(isinstance(u, np.ndarray) and u.shape == (mesh.n_nodes, 6)
                and abs(float(u[ctr, 2]) - w) < 1e-12,
                f"{tag}: fetch_solution [{mesh.n_nodes}, 6] equals the synced centre value")
    gates.check(bool(np.isfinite(u).all()) and all(np.isfinite(hist)),
                f"{tag}: finite displacements and refine history {['%.3e' % h for h in hist]}")
    gates.check(err < gate_rel, f"{tag}: centre w {w:.7f} vs {golden}: rel err {err:.2e} < {gate_rel:.0e}")
    gates.check(hist[-1] <= JAX_SCALE_FLOOR,
                f"{tag}: final true residual {hist[-1]:.3e} <= {JAX_SCALE_FLOOR:.1e}")
    if steady:
        gates.check(mg.last_iters == SCALE_INNER_ITERS,
                    f"{tag}: {mg.last_iters} inner iterations == {SCALE_INNER_ITERS}")
    if pair:
        cg, passes, want32 = pair_launch_counts(mg)
        cg_key = "sym" if mg._fine_sym is not None else "spmv_f64"
        expected = {"cg": cg, "passes": passes, "spmv_f32": want32, "cg_kernel": cg_key}
        gates.check(launches[cg_key] >= cg and launches["spmv_f32"] >= want32,
                    f"{tag}: CG launches ({cg_key}) {launches[cg_key]} >= {cg}, "
                    f"stencil_spmv<float> {launches['spmv_f32']} >= {want32}")
        gates.check(launches["resid"] == passes and launches["class_f32"] == passes
                    and launches["class_f64"] == 0,
                    f"{tag}: stencil_resid_dd {launches['resid']} and E-term class_stencil<float> "
                    f"{launches['class_f32']} == {passes} passes, class_stencil<double> "
                    f"{launches['class_f64']} == 0")
        if steady:
            gates.check(cg_key == "sym" and launches["spmv_f64"] == 0,
                        f"{tag}: steady pair CG from symmetric storage, stencil_spmv<double> "
                        f"launches {launches['spmv_f64']} == 0")
    else:
        want64, want32 = class_launch_counts(mg)
        expected = {"class_f64": want64, "class_f32": want32}
        gates.check(launches["class_f64"] >= want64 and launches["class_f32"] >= want32,
                    f"{tag}: class launches f64 {launches['class_f64']} >= {want64}, "
                    f"f32 {launches['class_f32']} >= {want32}")
        gates.check(launches["spmv_f64"] + spmv64_before == 0,
                    f"{tag}: stencil_spmv<double> launches {launches['spmv_f64'] + spmv64_before} == 0")
    want_elem = elem_launch_count(mg)
    key_elem = "elem3" if et == "t" else "elem4"
    expected["elem_stiffness"] = want_elem
    gates.check(launches[key_elem] == want_elem > 0,
                f"{tag}: elem_stiffness launches {launches[key_elem]} == {want_elem} "
                f"({'the steady reassemble' if steady else 'the constructor'}'s grid assembly)")
    rebuild = rebuild_split(mg, tag) if steady else None
    prof = device_profile(lambda: mg.solve_df_refined(f_dev, rtol=1e-9, return_device=True)) \
        if steady else None
    rec = {
        "case": tag, "levels": mg.n_levels, "inner_iters": mg.last_iters,
        "inner_per_solve": list(mg.refine_inner_iters), "refine_history": hist,
        "true_residual": hist[-1], "center_w": w, "rel_err": err, **times,
        "launches": launches, "launches_before_steady_spmv_f64": spmv64_before,
        "expected": expected, "peak_mem_bytes": peak, "profile": prof, "rebuild_profile": rebuild,
    }
    print(f"  {tag}: levels={mg.n_levels} inner_iters={mg.last_iters} {mg.refine_inner_iters} "
          f"history={['%.3e' % h for h in hist]} w={w:.7f} rel_err={err:.2e} "
          f"{' '.join(f'{k}={v:.4f}' for k, v in times.items())} launches={launches} "
          f"expected {expected} peak_mem={peak}", flush=True)
    if prof is not None:
        print(f"  {tag} profile: wall_ms={prof['wall_ms']:.1f} device_busy_ms={prof['device_busy_ms']:.1f} "
              f"idle_share={prof['idle_share']} class_stencil_ms={prof['class_stencil_ms']:.1f} "
              f"stencil_spmv_ms={prof['stencil_spmv_ms']:.1f} "
              f"stencil_spmv_sym_ms={prof['stencil_spmv_sym_ms']:.1f} "
              f"stencil_resid_ms={prof['stencil_resid_ms']:.1f}", flush=True)
        for row in prof["top"]:
            print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    return rec


def random_quads(ne: int, seed: int):
    """xyz [4, 3, ne] of convex Quad-4 elements of random shape and size,
    turned by random rotations and placed at random points."""
    rng = np.random.default_rng(seed)
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    out = np.zeros((4, 3, ne))
    for e in range(ne):
        flat = (sq + rng.uniform(-0.2, 0.2, size=(4, 2))) * rng.uniform(0.5, 2.0)
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        pts = np.column_stack([flat, np.zeros(4)]) @ q.T + rng.uniform(-5.0, 5.0, size=3)
        out[:, :, e] = pts
    return out


def elem_case_phase(gates, device="cuda"):
    """elem_stiffness on elements off any grid (the golden meshes, random
    rotated quads in partial blocks) against its plain version."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.data import mixed_ibeam_mesh, test_a, test_b, test_e
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness, elem_stiffness_plain

    mixed = mixed_ibeam_mesh()
    membrane, ibeam, plate_mat = Material(0.25, 30000, 1.0), Material(0.25, 10000, 0.25), Material(0.3, 1e7, 0.5)
    cases = [("A tri", test_a.COORDS[test_a.TRIS].transpose(1, 2, 0), membrane),
             ("B quad", test_b.COORDS[test_b.QUADS].transpose(1, 2, 0), membrane),
             ("E tri", test_e.COORDS[test_e.TRIS].transpose(1, 2, 0), ibeam),
             ("E quad", test_e.COORDS[test_e.QUADS].transpose(1, 2, 0), ibeam),
             ("E mixed tri", mixed.coords[mixed.tri].transpose(1, 2, 0), ibeam),
             ("E mixed quad", mixed.coords[mixed.quad].transpose(1, 2, 0), ibeam)]
    cases += [(f"random quads E={ne}", random_quads(ne, ne), plate_mat) for ne in (1, 31, 33, 65)]
    rows = []
    for tag, xyz, mat in cases:
        dm64, dp64 = mat.matrices()
        dm, dp = (torch.from_numpy(a).to(device) for a in (dm64, dp64))
        x = torch.from_numpy(np.ascontiguousarray(xyz, dtype=np.float64)).to(device)
        m = x.shape[0]
        ke, ref = elem_stiffness(x, dm, dp, mat.thickness), elem_stiffness_plain(x, dm, dp, mat.thickness)
        torch.cuda.synchronize()
        err, max_abs = elem_err(ke, ref)
        kt = ke.transpose(0, 1)
        asym = float(((ke - kt).abs().amax(dim=(0, 1)) / ke.abs().amax(dim=(0, 1))).max())
        symmetric = torch.equal(ke, kt)
        gates.check(bool(torch.isfinite(ke).all()) and err <= ELEM_CASE_GATE,
                    f"elem kernel {tag} (m={m}, {x.shape[2]} elements): max|ke-plain|/max|ke| per "
                    f"element = {err:.3e} <= {ELEM_CASE_GATE:.0e}")
        gates.check(symmetric, f"elem kernel {tag}: ke equal to its transpose")
        rows.append({"case": tag, "m": m, "elements": int(x.shape[2]), "rel_err": err,
                     "max_abs_err": max_abs, "symmetric": symmetric, "asymmetry": asym})
        print(f"  {tag}: m={m} E={x.shape[2]} rel_err={err:.2e} symmetric={symmetric} "
              f"asymmetry={asym:.2e}", flush=True)
    return rows


def golden_cases():
    """The non-slow goldens A-F of tests/test_golden.py: (name, mesh,
    forces, (nu, E, t), checks, dense), each check (node, columns,
    expected, rtol, on the absolute values)."""
    from fem_shell_tpu_torch import MeshGenParams, generate
    from fem_shell_tpu_torch.data import (mesh_from_quads, mesh_from_tris, mixed_ibeam_mesh, test_a,
                                          test_b, test_e)

    def plate_c(et, n, bcid, loading, factor, domain=(0, 0, 10, 10)):
        mesh, rows, fac = generate(MeshGenParams(et, n, n, *domain, (bcid,) * 4, factor, loading, False, "z"))
        return mesh, rows * fac

    ctr = slice(2, 3)
    cases = [
        ("A", mesh_from_tris(test_a.COORDS, test_a.TRIS, test_a.BOUNDARY_SIDES), test_a.FORCES,
         (0.25, 30000, 1.0), [(22, slice(0, 2), [-0.0255988, 0.0629549], 1e-5, False),
                              (26, slice(0, 2), [-0.0342621, 0.1944070], 1e-5, False)], True),
        ("B", mesh_from_quads(test_b.COORDS, test_b.QUADS, test_b.BOUNDARY_SIDES), test_b.FORCES,
         (0.25, 30000, 1.0), [(22, slice(0, 2), [-0.0427728, 0.1012620], 1e-5, False),
                              (26, slice(0, 2), [-0.0570728, 0.3160560], 1e-5, False)], False),
        ("E tri", mesh_from_tris(test_e.COORDS, test_e.TRIS, test_e.BOUNDARY_SIDES), test_e.FORCES,
         (0.25, 10000, 0.25), [(35, slice(0, 3), [0.01605314, 0.08948797, -0.15605938], 1e-6, False),
                               (44, slice(0, 3), [0.01544426, -0.08905332, 0.14949037], 1e-6, False),
                               (44, slice(0, 3), [0.0152698, 0.0879212, 0.1543450], 0.05, True)], False),
        ("E quad", mesh_from_quads(test_e.COORDS, test_e.QUADS, test_e.QUAD_BOUNDARY_SIDES), test_e.FORCES,
         (0.25, 10000, 0.25), [(35, slice(0, 3), [0.02527736, 0.13915961, -0.23064233], 1e-6, False),
                               (44, slice(0, 3), [0.02527736, -0.13915961, 0.23064233], 1e-6, False),
                               (35, slice(0, 3), [0.0246001, 0.1373650, 0.2320180], 0.05, True)], False),
        ("E mixed", mixed_ibeam_mesh(), test_e.FORCES,
         (0.25, 10000, 0.25), [(35, slice(0, 3), [0.01584023, 0.08818383, -0.19393935], 1e-6, False),
                               (44, slice(0, 3), [0.02568137, -0.14142868, 0.19104298], 1e-6, False)], True),
    ]
    for n, g in ((4, 1.06723), (16, 1.15169)):
        mesh, f = plate_c("t", n, 0, 1, 1.0)
        cases.append((f"C t{n}", mesh, f, (0.3, 10.92, 1.0), [(mesh.n_nodes // 2, ctr, [g], 1e-5, False)], False))
    for loading, factor, gold in ((2, 300.0, {4: 0.106032, 8: 0.106405, 16: 0.106454}),
                                  (1, 30000.0, {4: 0.332677, 8: 0.312851, 16: 0.306664})):
        for n, g in gold.items():
            mesh, f = plate_c("q", n, 0, loading, factor)
            cases.append((f"D q{n} load{loading}", mesh, f, (0.3, 1e7, 0.5),
                          [(mesh.n_nodes // 2, ctr, [g], 1e-5, False)], False))
    f_golden = {(0, 2): {2: 14.4005, 4: 12.6269, 8: 12.8565, 16: 12.9431},
                (1, 2): {2: 3.82366, 4: 2.45355, 8: 2.60137, 16: 2.60384},
                (0, 1): {2: 11.5204, 4: 17.3048, 8: 18.1158, 16: 17.4961},
                (1, 1): {2: 3.05893, 4: 6.06564, 8: 7.78902, 16: 7.66573}}
    for (bcid, loading), gold in f_golden.items():
        for n, g in gold.items():
            mesh, f = plate_c("q", n, bcid, loading, 1e-4 if loading == 2 else 4e-4, (0, 0, 10, 2))
            cases.append((f"F q{n} bc{bcid} load{loading}", mesh, f, (0.3, 1.7472e7, 0.01),
                          [(mesh.n_nodes // 2, ctr, [g * 1e-6], 1e-4, False)], False))
    return cases


def golden_phase(gates, device="cuda"):
    """Goldens A-F through ShellSystem on the card; elem_stiffness counted
    per assembly."""
    from fem_shell_tpu_torch import Material, ShellSystem

    rows = []
    launches = {"elem3": 0, "elem4": 0, "spmv_f32": 0, "spmv_f64": 0}
    for name, mesh, forces, (nu, em, t), checks, dense in golden_cases():
        system = ShellSystem(mesh, Material(nu=nu, em=em, thickness=t), device=device)
        want = {"elem3": int(len(mesh.tri) > 0), "elem4": int(len(mesh.quad) > 0)}
        for method in ("pcg", "dense") if dense else ("pcg",):
            reset_launches()
            t0 = time.perf_counter()
            u = system.solve(forces, method=method, rtol=1e-12, maxiter=50000)
            un = u.cpu().numpy()
            secs = time.perf_counter() - t0
            got = read_launches()
            for k in launches:
                launches[k] += got[k]
            errs = []
            for node, cols, want_v, rtol, absval in checks:
                v = np.abs(un[node, cols]) if absval else un[node, cols]
                errs.append(float(np.max(np.abs(v - want_v) / np.abs(want_v))))
                ok = errs[-1] <= rtol
                gates.check(ok, f"golden {name} {method}: node {node} {'|u|' if absval else 'u'} "
                                f"{np.array2string(v, precision=8)} vs {want_v}: {errs[-1]:.2e} <= {rtol:.0e}")
            gates.check(got["elem3"] == want["elem3"] and got["elem4"] == want["elem4"],
                        f"golden {name} {method}: elem_stiffness launches <3> {got['elem3']}, <4> "
                        f"{got['elem4']} == one per family present")
            rec = {"case": name, "method": method, "nodes": mesh.n_nodes, "rel_errs": errs, "seconds": secs,
                   "launches": got}
            if method == "pcg":
                gates.check(system.last_cg.residual < 1e-12, f"golden {name}: residual "
                                                             f"{system.last_cg.residual:.2e} < 1e-12")
                rec.update(iters=system.last_cg.iters, residual=system.last_cg.residual)
            rows.append(rec)
    print(f"  {len(rows)} golden solves, worst error/tolerance "
          f"{max(max(r['rel_errs']) for r in rows):.2e}, launches {launches}", flush=True)
    return rows, launches


def ell_matvec_work(a):
    """Bytes of one block-ELL matvec: the 36 N K f64 values, the gathered
    x (6 N K) and the vectors x and y (6 N each)."""
    n, k = a.adj.shape
    return 8 * (36 * n * k + 6 * n * k + 12 * n)


def ell_matvec_time(a, bandwidth, reps):
    """CUDA-event time of BlockEllMatrix.matvec against its bytes bound."""
    n = a.adj.shape[0]
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 6))).to(a.blocks.device)
    ms = cuda_ms(lambda: a.matvec(x), reps)
    nbytes = ell_matvec_work(a)
    bound = nbytes / bandwidth * 1e3
    return {"nodes": n, "k": int(a.adj.shape[1]), "ms": ms, "bound_ms": bound, "bytes": nbytes,
            "achieved_GBps": nbytes / ms / 1e6}


def system_phase(gates, et, bandwidth, device="cuda"):
    """Test-G through ShellSystem: block-Jacobi PCG to rtol 1e-12, twice,
    launches counted per solve; the block-ELL matvec timed."""
    from fem_shell_tpu_torch import Material, ShellSystem
    from fem_shell_tpu_torch.ops.assemble import constrained_rhs
    from fem_shell_tpu_torch.solver import pcg

    mesh, rows, fac = plate(et, 64)
    forces = rows * fac
    jax_it, jax_w, jax_it10 = JAX_SYSTEM_G[et]
    t0 = time.perf_counter()
    system = ShellSystem(mesh, Material(0.3, 1e7, 0.5), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    system.solve(forces, rtol=1e-10, maxiter=20000)  # warm-up, and the count before the floor
    it10 = system.last_cg.iters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    u = system.solve(forces, rtol=1e-12, maxiter=20000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    it, res = system.last_cg.iters, system.last_cg.residual
    t0 = time.perf_counter()
    again = system.solve(forces, rtol=1e-12, maxiter=20000)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    same = torch.equal(again, u)
    w = float(u[mesh.n_nodes // 2, 2])
    tag = f"ShellSystem {et}64"
    e_jax, e_gold = abs(w - jax_w) / jax_w, abs(w - GOLDEN[et]) / GOLDEN[et]
    gates.check(tuple(u.shape) == (mesh.n_nodes, 6) and bool(torch.isfinite(u).all()) and res < 1e-12,
                f"{tag}: finite [{mesh.n_nodes}, 6], residual {res:.2e} < 1e-12")
    gates.check(e_jax < 1e-8 and e_gold < 5e-5, f"{tag}: centre {w:.17g}: {e_jax:.2e} < 1e-8 of JAX "
                                                f"{jax_w}, {e_gold:.2e} < 5e-5 of {GOLDEN[et]}")
    gates.check(abs(it10 - jax_it10) <= 0.02 * jax_it10,
                f"{tag}: {it10} iterations to rtol 1e-10 within 2 % of JAX {jax_it10} (to rtol 1e-12: "
                f"{it}, JAX {jax_it}; not gated, the rounding floor's lottery)")
    gates.check(same, f"{tag}: two solves bitwise equal")
    want = {"elem3": int(et == "t"), "elem4": int(et == "q")}
    gates.check(launches["elem3"] == want["elem3"] and launches["elem4"] == want["elem4"],
                f"{tag}: elem_stiffness launches <3> {launches['elem3']}, <4> {launches['elem4']} == "
                f"one per family present")
    a = system.assemble()
    # the same rtol-1e-12 solve with its residual history: where it reaches
    # the rounding floor (first at or under 1e-11) and how long it stalls
    hist = []
    b = constrained_rhs(torch.as_tensor(forces, dtype=torch.float64).to(device), system.free_mask)
    x = pcg(a.matvec, b, rtol=1e-12, maxiter=20000, apply_prec=system._preconditioner(a, "block_jacobi"),
            history=hist).x
    h = np.array(hist)
    cross = {t: int(np.argmax(h <= t)) + 1 if (h <= t).any() else None for t in (1e-10, 1e-11, 1e-12)}
    floor_it = cross[1e-11]
    floor_med = float(np.median(h[floor_it - 1:])) if floor_it else None
    gates.check(torch.equal(x, u) and floor_it is not None
                and abs(floor_it - FLOOR_ITERS[et]) <= 0.02 * FLOOR_ITERS[et],
                f"{tag}: the rtol-1e-12 history (the same solve, bitwise) first at or under 1e-11 at "
                f"iteration {floor_it}, within 2 % of {FLOOR_ITERS[et]}; 1e-10 at {cross[1e-10]}, 1e-12 at "
                f"{cross[1e-12]}, median residual from there {floor_med}")
    del x, b
    mv = ell_matvec_time(a, bandwidth, 200)
    del a
    prof = device_profile(lambda: system.solve(forces, rtol=1e-12, maxiter=20000)) if et == "q" else None
    rec = {"case": tag, "iters": it, "jax_iters": jax_it, "iters_rtol1e-10": it10, "jax_iters_rtol1e-10": jax_it10,
           "floor_iter": floor_it, "floor_median_residual": floor_med,
           "history_crossings": {f"{t:g}": v for t, v in cross.items()}, "residual": res, "center_w": w, "rel_err_jax": e_jax,
           "rel_err_golden": e_gold, "setup_s": setup_s, "solve_s": [solve_s, again_s],
           "s_per_iter": solve_s / max(it, 1), "bitwise_repeat": same, "launches": launches,
           "peak_mem_bytes": peak, "ell_matvec": mv, "profile": prof}
    print(f"  {tag}: iters={it} (JAX {jax_it}; to 1e-10 {it10}, JAX {jax_it10}; at or under 1e-11 from "
          f"{floor_it}, median after {floor_med}) residual={res:.2e} "
          f"w={w:.17g} setup_s={setup_s:.3f} "
          f"solve_s={solve_s:.4f},{again_s:.4f} s/iter={rec['s_per_iter'] * 1e3:.4f} ms "
          f"bitwise={same} peak={peak} matvec {mv['ms']:.4f} ms (bound {mv['bound_ms']:.4f}) "
          f"launches={launches}", flush=True)
    if prof is not None:
        print(f"  {tag} profile: wall_ms={prof['wall_ms']:.1f} device_busy_ms={prof['device_busy_ms']:.1f} "
              f"idle_share={prof['idle_share']}", flush=True)
        for row in prof["top"]:
            print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    return rec


def ell_matvec_scale(bandwidth, n=1024, device="cuda"):
    """The block-ELL matvec on the n^2 quad plate's pattern (random blocks):
    its time at a size where bytes, not launches, should set it."""
    from fem_shell_tpu_torch.ops.assemble import BlockEllMatrix, build_ell_pattern

    mesh, _, _ = plate("q", n)
    t0 = time.perf_counter()
    pat = build_ell_pattern(mesh)
    pattern_s = time.perf_counter() - t0
    adj = torch.from_numpy(pat.adj.astype(np.int64)).to(device)
    gen = torch.Generator(device=device).manual_seed(n)
    blocks = torch.randn((adj.shape[0], adj.shape[1], 6, 6), dtype=torch.float64, device=device, generator=gen)
    rec = ell_matvec_time(BlockEllMatrix(blocks, adj), bandwidth, 20)
    rec["pattern_s"] = pattern_s
    print(f"  block-ELL matvec q{n}: N={rec['nodes']} K={rec['k']} {rec['ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['achieved_GBps']:.0f} GB/s); host pattern {pattern_s:.2f} s",
          flush=True)
    del blocks, adj
    torch.cuda.empty_cache()
    return rec


def vcycle_plain_checks(gates, mg, tag, device="cuda"):
    """The f64 V-cycle's kernel against its plain version at the shapes the
    solve gives it: every smoothing level's stencil_spmv<double> against
    stencil_spmv_plain on a random x, then one V-cycle on a random staged
    residual against the same V-cycle with every level's matvec the plain
    version. Launches counted here are comparison launches: the main
    path's were read before."""
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_plain

    gen = torch.Generator(device=device).manual_seed(mg.levels[0].npad)
    levels = []
    for li, lvl in enumerate(mg.levels):
        if lvl.dense_inv is not None:
            continue
        x = torch.randn((6, lvl.npad), dtype=torch.float64, device=device, generator=gen)
        y = stencil_spmv(lvl.values, x, lvl.offsets)
        y_plain = stencil_spmv_plain(lvl.values, x, lvl.offsets)
        abs_err = float((y - y_plain).abs().max())
        err = abs_err / float(y_plain.abs().max())
        levels.append({"level": li, "nodes": f"{lvl.nyp}x{lvl.nxp}", "npad": lvl.npad,
                       "k": int(lvl.values.shape[1]), "max_abs_err": abs_err, "rel_err": err})
        gates.check(err <= ERR_GATE[torch.float64] and bool(torch.isfinite(y).all()),
                    f"{tag} level {li} ({lvl.nyp}x{lvl.nxp}): stencil_spmv<double> max|y-y_plain|/max|y| = "
                    f"{err:.3e} <= {ERR_GATE[torch.float64]:.0e}")
        del x, y, y_plain
    fine = mg.levels[0]
    r = torch.randn((6, fine.npad), dtype=torch.float64, device=device, generator=gen) * fine.free_t
    reset_launches()
    z = mg._vcycle(mg.levels, 0, r)
    kernel_launches = read_launches()["spmv_f64"]
    mg._mv = lambda lvl, x: stencil_spmv_plain(lvl.values, x, lvl.offsets)
    try:
        reset_launches()
        z_plain = mg._vcycle(mg.levels, 0, r)
        plain_launches = read_launches()["spmv_f64"]
    finally:
        del mg._mv
    torch.cuda.synchronize()
    abs_err = float((z - z_plain).abs().max())
    err = abs_err / float(z_plain.abs().max())
    want = 7 * len(levels)
    gates.check(err <= VCYCLE_GATE and bool(torch.isfinite(z).all()) and kernel_launches == want
                and plain_launches == 0,
                f"{tag}: one V-cycle against its plain version: max|z-z_plain|/max|z| = {err:.3e} <= "
                f"{VCYCLE_GATE:.0e}; stencil_spmv<double> launches {kernel_launches} == {want}, plain "
                f"{plain_launches} == 0")
    print(f"  {tag} V-cycle vs plain: rel_err={err:.3e} levels "
          f"{[(l['nodes'], '%.2e' % l['rel_err']) for l in levels]}", flush=True)
    return {"levels": levels, "vcycle_max_abs_err": abs_err, "vcycle_rel_err": err}


def mg_solve_phase(gates, et, n, device="cuda", reps=2, jax=None, golden=None, gate_rel=5e-5):
    """MultigridShellSystem(mesh, mat).solve: the f64 levels, every level's
    matvec through stencil_spmv<double>. Launches counted over the
    constructor (the grid assembly of every level) and over one solve."""
    from fem_shell_tpu_torch import Material, MultigridShellSystem

    mesh, rows, fac = plate(et, n)
    forces = rows * fac
    tag = f"MG.solve {et}{n}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), device=device)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    ctor_launches = read_launches()
    ctor_peak = torch.cuda.max_memory_allocated()
    mg.solve(forces, rtol=1e-10, maxiter=2000)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    u = mg.solve(forces, rtol=1e-10, maxiter=2000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    it, res, nl = mg.last_cg.iters, mg.last_cg.residual, mg.n_levels
    times, same = [solve_s], True
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        again = mg.solve(forces, rtol=1e-10, maxiter=2000)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        same = same and torch.equal(again, u)
    w = float(u[mesh.n_nodes // 2, 2])
    want64 = it + 7 * (nl - 1) * (it + 1)
    want_elem = elem_launch_count(mg)
    key_elem = "elem3" if et == "t" else "elem4"
    gates.check(tuple(u.shape) == (mesh.n_nodes, 6) and bool(torch.isfinite(u).all()) and res < 1e-10,
                f"{tag}: finite [{mesh.n_nodes}, 6], residual {res:.2e} < 1e-10")
    rec = {"case": tag, "levels": nl, "iters": it, "residual": res, "center_w": w, "ctor_s": ctor_s,
           "solve_s": times, "s_per_iter": solve_s / max(it, 1), "bitwise_repeat": same,
           "ctor_launches": ctor_launches, "launches": launches, "expected_spmv_f64": want64,
           "expected_elem": want_elem, "ctor_peak_bytes": ctor_peak, "peak_mem_bytes": peak}
    if jax is not None:
        jax_it, jax_w = jax
        e_jax, e_gold = abs(w - jax_w) / jax_w, abs(w - golden) / golden
        gates.check(e_jax < 1e-8 and e_gold < gate_rel,
                    f"{tag}: centre {w:.17g}: {e_jax:.2e} < 1e-8 of JAX {jax_w}, {e_gold:.2e} < "
                    f"{gate_rel:.0e} of {golden}")
        gates.check(abs(it - jax_it) <= 1, f"{tag}: {it} iterations vs JAX {jax_it} (+-1)")
        rec.update(jax_iters=jax_it, rel_err_jax=e_jax, rel_err_golden=e_gold)
    else:
        e_gold = abs(w - golden) / golden
        gates.check(e_gold < gate_rel, f"{tag}: centre {w:.7f} vs {golden}: rel err {e_gold:.2e} < {gate_rel:.0e}")
        rec.update(rel_err_golden=e_gold)
    gates.check(same, f"{tag}: {reps} solves bitwise equal")
    gates.check(launches["spmv_f64"] == want64 and launches["spmv_f32"] == 0,
                f"{tag}: stencil_spmv<double> launches {launches['spmv_f64']} == {want64} ({it} CG + 7 x "
                f"{nl - 1} levels x {it + 1} V-cycles), <float> {launches['spmv_f32']} == 0")
    gates.check(ctor_launches[key_elem] == want_elem > 0 and launches[key_elem] == 0,
                f"{tag}: elem_stiffness launches {ctor_launches[key_elem]} == {want_elem} in the "
                f"constructor (grid assembly of every level), {launches[key_elem]} in the solve")
    prof = device_profile(lambda: mg.solve(forces, rtol=1e-10, maxiter=2000))
    rec["profile"] = prof
    rec["plain_checks"] = vcycle_plain_checks(gates, mg, tag, device)
    print(f"  {tag}: levels={nl} iters={it} residual={res:.2e} w={w:.17g} ctor_s={ctor_s:.3f} "
          f"solve_s={['%.4f' % t for t in times]} s/iter={rec['s_per_iter'] * 1e3:.4f} ms bitwise={same} "
          f"peak={peak} ctor_peak={ctor_peak} launches={launches} ctor={ctor_launches}", flush=True)
    print(f"  {tag} profile: wall_ms={prof['wall_ms']:.1f} device_busy_ms={prof['device_busy_ms']:.1f} "
          f"idle_share={prof['idle_share']} stencil_spmv_ms={prof['stencil_spmv_ms']:.1f}", flush=True)
    for row in prof["top"]:
        print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    del mg
    torch.cuda.empty_cache()
    return rec


def roof_golden_phase(gates, device="cuda"):
    """The Scordelis-Lo roof through ShellSystem (block-ELL, block-Jacobi
    PCG to rtol 1e-12) at n = 8, 16, 32: curved 3-D Quad-4 elements through
    elem_stiffness<4>, the midside deflection within 1e-4 of the pinned
    goldens, one elem_stiffness<4> launch per assembly."""
    from fem_shell_tpu_torch import ShellSystem
    from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL, scordelis_lo

    rows = []
    for n, want in ROOF_PINNED.items():
        mesh, forces, mid = scordelis_lo(n)
        system = ShellSystem(mesh, SCORDELIS_LO_MATERIAL, device=device)
        reset_launches()
        t0 = time.perf_counter()
        u = system.solve(forces, rtol=1e-12, maxiter=100000)
        w = float(u[mid, 2])
        secs = time.perf_counter() - t0
        got = read_launches()
        err = abs(w - want) / abs(want)
        it, res = system.last_cg.iters, system.last_cg.residual
        gates.check(err <= 1e-4 and res < 1e-12 and bool(torch.isfinite(u).all()),
                    f"roof golden n={n}: ShellSystem midside w {w:.7f} vs {want}: {err:.2e} <= 1e-4, "
                    f"residual {res:.2e} < 1e-12 in {it} iterations")
        gates.check(got["elem4"] == 1 and got["elem3"] == 0,
                    f"roof golden n={n}: elem_stiffness<4> launches {got['elem4']} == 1, <3> {got['elem3']} == 0")
        rows.append({"case": f"roof{n}", "w": w, "rel_err": err, "iters": it, "residual": res,
                     "seconds": secs, "launches": got})
        print(f"  roof{n} ShellSystem: w={w:.10f} rel_err={err:.2e} iters={it} {secs:.3f} s", flush=True)
    return rows


def true_residual(mg, x, b):
    """(||b - A x|| / ||b||, ||b - A x|| / || |A| |x| ||) on the f64 fine
    operator through stencil_spmv<double>: the relative true residual and
    the normwise backward error."""
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv

    offs = mg.levels[0].offsets
    rn = float(torch.linalg.vector_norm(b - stencil_spmv(mg._fine64, x, offs)))
    scale = float(torch.linalg.vector_norm(stencil_spmv(mg._fine64.abs(), x.abs(), offs)))
    return rn / float(torch.linalg.vector_norm(b)), rn / scale


def roof_scale_phase(gates, n=512, device="cuda"):
    """The roof at full width through the df cycle (tools/roof_dfcycle_probe.py's
    configuration): MultigridShellSystem(dtype=float32, df_operator=True,
    df_cycle=True, smoother="chebyshev") and solve_df(rtol=1e-9,
    maxiter=2000): constructor, solve (the main path: launches counted), solve
    again, reassemble(), solve a third time; then reassemble(profile=True)
    for the stage split, a profiled solve and the V-cycle against its plain
    version on this hierarchy."""
    from fem_shell_tpu_torch import MultigridShellSystem
    from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL, scordelis_lo

    mesh, forces, mid = scordelis_lo(n)
    tag = f"roof{n} df_cycle"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = t_main = time.perf_counter()
    mg = MultigridShellSystem(mesh, SCORDELIS_LO_MATERIAL, dtype=torch.float32, df_operator=True,
                              df_cycle=True, smoother="chebyshev", device=device)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    ctor_launches = read_launches()
    ctor_peak = torch.cuda.max_memory_allocated()
    f_dev = mg.stage_forces(forces)
    b = f_dev * mg.levels[0].free_t
    torch.cuda.reset_peak_memory_stats()
    xs, times, iters, resids = [], [], [], []
    launches = reassemble_launches = None
    for k in range(3):
        if k == 2:
            reset_launches()
            t0 = time.perf_counter()
            mg.reassemble()
            torch.cuda.synchronize()
            reassemble_s = time.perf_counter() - t0
            reassemble_launches = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        x = mg.solve_df(f_dev, rtol=1e-9, maxiter=2000, return_device=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if k == 0:
            launches = read_launches()
        xs.append(x)
        iters.append(mg.last_iters)
        resids.append(mg.last_residual)
    peak = torch.cuda.max_memory_allocated()
    x = xs[0]
    it = iters[0]
    w = float(x[2, mid])
    true_res, backward = true_residual(mg, x, b)
    same = all(torch.equal(xi, x) for xi in xs[1:])
    nl = mg.n_levels
    smoothing = nl - 1
    want64 = 7 * smoothing * (it + 1)
    want_elem = elem_launch_count(mg)
    cg_key = "sym" if mg._fine_sym is not None else "spmv_f64"
    gates.check(mg.coarse_op == "galerkin" and mg.cycle == "V" and nl == 6
                and all(len(l.offsets) == 9 and l.values.dtype == torch.float64 for l in mg.levels),
                f"{tag}: {nl} f64 levels, coarse_op {mg.coarse_op}, cycle {mg.cycle}, 9 offsets "
                f"(level 0 assembled, 1-{nl - 1} stencil_rap)")
    gates.check(all(r <= 1e-9 for r in resids) and backward <= ROOF_BACKWARD_ERR and bool(torch.isfinite(x).all()),
                f"{tag}: residuals {['%.2e' % r for r in resids]} <= 1e-9; true residual {true_res:.3e}, "
                f"backward error ||b-Ax||/|||A||x||| {backward:.3e} <= {ROOF_BACKWARD_ERR:.0e}")
    gates.check(abs(w - ROOF_W512) <= 1e-6, f"{tag}: midside w {w:.8f} vs {ROOF_W512} (+-1e-6)")
    gates.check(it <= ROOF_MAX_ITERS, f"{tag}: {it} iterations <= {ROOF_MAX_ITERS}")
    gates.check(same and iters.count(it) == 3, f"{tag}: three solves (the third after reassemble) bitwise equal")
    gates.check(cg_key == "sym" and launches["sym"] == it and launches["spmv_f64"] == want64
                and launches["spmv_f32"] == 0 and launches["elem4"] == 0,
                f"{tag}: stencil_spmv_sym<double> {launches['sym']} == {it} CG iterations, "
                f"stencil_spmv<double> {launches['spmv_f64']} == {want64} (7 x {smoothing} levels x "
                f"{it + 1} V-cycles), <float> {launches['spmv_f32']} == 0, elem_stiffness {launches['elem4']} == 0")
    gates.check(ctor_launches["elem4"] == want_elem == reassemble_launches["elem4"] and want_elem > 0
                and ctor_launches["elem3"] == 0 and ctor_launches["spmv_f32"] == 0,
                f"{tag}: elem_stiffness<4> launches {ctor_launches['elem4']} (constructor) and "
                f"{reassemble_launches['elem4']} (reassemble) == {want_elem}: level 0 only, no "
                f"stencil_spmv<float>")
    mean_uy = float(x[1, :mesh.n_nodes].mean())
    steps = {"main_s": time.perf_counter() - t_main}
    t0 = time.perf_counter()
    split = rebuild_split(mg, tag)
    steps["split_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the first ROOF_PROFILE_ITERS iterations: a trace of all of them
    # takes minutes to summarize, and every iteration does the same work
    prof = device_profile(lambda: mg.solve_df(f_dev, rtol=1e-9, maxiter=ROOF_PROFILE_ITERS,
                                              return_device=True))
    steps["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = vcycle_plain_checks(gates, mg, tag, device)
    steps["plain_checks_s"] = time.perf_counter() - t0
    rec = {"case": tag, "nodes": mesh.n_nodes, "dof": 6 * mesh.n_nodes, "elements": len(mesh.quad),
           "levels": nl, "level_offsets": [len(l.offsets) for l in mg.levels], "iters": iters,
           "residuals": resids, "true_residual": true_res, "backward_error": backward, "center_w": w, "ctor_s": ctor_s,
           "solve_s": times, "s_per_iter": times[0] / max(it, 1), "reassemble_s": reassemble_s,
           "bitwise_repeat": same, "ctor_launches": ctor_launches, "launches": launches,
           "reassemble_launches": reassemble_launches, "expected_spmv_f64": want64,
           "expected_elem": want_elem, "ctor_peak_bytes": ctor_peak, "peak_mem_bytes": peak,
           "fine64_bytes": mg._fine64.numel() * 8, "fine_sym_bytes": mg._fine_sym.numel() * 8,
           "rebuild_profile": split, "profile": prof, "profile_iters": ROOF_PROFILE_ITERS,
           "plain_checks": checks, "mean_uy": mean_uy, "steps": steps}
    rec["launches_total"] = {k: ctor_launches[k] + launches[k] + reassemble_launches[k] for k in launches}
    print(f"  {tag}: levels={nl} iters={iters} residuals={resids} true_res={true_res:.3e} "
          f"backward={backward:.3e} w={w:.10f} "
          f"ctor_s={ctor_s:.3f} solve_s={['%.4f' % t for t in times]} s/iter={rec['s_per_iter'] * 1e3:.4f} ms "
          f"reassemble_s={reassemble_s:.3f} bitwise={same} peak={peak} ctor_peak={ctor_peak} "
          f"mean_uy={mean_uy:.3e} launches={launches} ctor={ctor_launches} steps={steps}", flush=True)
    print(f"  {tag} profile ({ROOF_PROFILE_ITERS} iterations): wall_ms={prof['wall_ms']:.1f} "
          f"device_busy_ms={prof['device_busy_ms']:.1f} idle_share={prof['idle_share']} "
          f"stencil_spmv_ms={prof['stencil_spmv_ms']:.1f} stencil_spmv_sym_ms={prof['stencil_spmv_sym_ms']:.1f}",
          flush=True)
    for row in prof["top"]:
        print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    del mg, xs, x, b, f_dev
    torch.cuda.empty_cache()
    return rec


def roof_cycle_phase(gates, n=256, device="cuda"):
    """V, K, K with k_depth=1 and W cycles on the f64 roof hierarchy
    (tools/roof_kcycle_probe.py's configuration: dtype float64, Chebyshev):
    solve(rtol=1e-9, maxiter=1500). V and both K reach rtol, K takes fewer
    iterations than V, and their midside deflections agree within 1e-6
    relative; W's count and residual are recorded (gated finite)."""
    from fem_shell_tpu_torch import MultigridShellSystem
    from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL, scordelis_lo

    mesh, forces, mid = scordelis_lo(n)
    rows = []
    for cyc, kd in (("V", None), ("K", None), ("K", 1), ("W", None)):
        tag = f"roof{n} cycle={cyc}" + ("" if kd is None else f" k_depth={kd}")
        reset_launches()
        mg = MultigridShellSystem(mesh, SCORDELIS_LO_MATERIAL, dtype=torch.float64, smoother="chebyshev",
                                  cycle=cyc, k_depth=kd, device=device)
        ctor = read_launches()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        u = mg.solve(forces, rtol=1e-9, maxiter=1500)
        w = float(u[mid, 2])
        secs = time.perf_counter() - t0
        got = read_launches()
        it, res = mg.last_cg.iters, mg.last_cg.residual
        rows.append({"case": tag, "cycle": cyc, "k_depth": kd, "levels": mg.n_levels, "iters": it,
                     "residual": res, "center_w": w, "solve_s": secs, "s_per_iter": secs / max(it, 1),
                     "launches": got, "launches_total": {k: ctor[k] + got[k] for k in got}})
        finite = bool(torch.isfinite(u).all()) and np.isfinite(res)
        if cyc == "W":
            gates.check(finite, f"{tag}: finite displacements and residual {res:.3e} ({it} iterations; recorded)")
        else:
            gates.check(finite and res <= 1e-9, f"{tag}: residual {res:.2e} <= 1e-9 in {it} iterations")
        gates.check(got["spmv_f64"] > 0 and got["spmv_f32"] == 0 and got["elem4"] == 0,
                    f"{tag}: stencil_spmv<double> {got['spmv_f64']} > 0, <float> {got['spmv_f32']} == 0")
        print(f"  {tag}: levels={mg.n_levels} iters={it} residual={res:.3e} w={w:.10f} {secs:.3f} s "
              f"({secs / max(it, 1) * 1e3:.3f} ms/iter) launches={got}", flush=True)
        del mg, u
    by = {r["case"]: r for r in rows}
    v, k, k1 = by[f"roof{n} cycle=V"], by[f"roof{n} cycle=K"], by[f"roof{n} cycle=K k_depth=1"]
    gates.check(k["iters"] < v["iters"], f"roof{n}: K {k['iters']} iterations < V {v['iters']}")
    spread = max(abs(r["center_w"] - v["center_w"]) for r in (k, k1)) / abs(v["center_w"])
    gates.check(spread <= 1e-6, f"roof{n}: V, K and K(k_depth=1) midside w agree: {spread:.2e} <= 1e-6")
    torch.cuda.empty_cache()
    return rows


def galerkin_fused_phase(gates, device="cuda"):
    """solve_fused with coarse_op="galerkin" on the 64x64 Test-G plates (the
    tri plate's 7-offset fine level gives 9-offset RAP levels): goldens
    within 1e-4, iterations within one of the JAX package's CPU counts,
    elem_stiffness launched for level 0 only."""
    from fem_shell_tpu_torch import Material, MultigridShellSystem

    rows = []
    for et in ("q", "t"):
        mesh, frows, fac = plate(et, 64)
        forces = frows * fac
        tag = f"fused galerkin {et}64"
        mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), assemble=False, coarse_op="galerkin",
                                  device=device)
        mg.solve_fused(forces, rtol=1e-9, maxiter=400)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        u = mg.solve_fused(forces, rtol=1e-9, maxiter=400)
        w = float(u[mesh.n_nodes // 2, 2])
        secs = time.perf_counter() - t0
        got = read_launches()
        it, nl = mg.last_iters, mg.n_levels
        err = abs(w - GOLDEN[et]) / GOLDEN[et]
        want_elem = elem_launch_count(mg)
        want32 = (nl - 1) * (21 + 7 * (it + 1))
        key_elem = "elem3" if et == "t" else "elem4"
        gates.check(err < 1e-4 and mg.last_residual < 1e-9,
                    f"{tag}: centre w {w:.7f} vs {GOLDEN[et]}: {err:.2e} < 1e-4, residual {mg.last_residual:.2e}")
        gates.check(abs(it - JAX_GALERKIN_ITERS[et]) <= 1,
                    f"{tag}: {it} iterations vs JAX {JAX_GALERKIN_ITERS[et]} (+-1)")
        gates.check(all(len(l.offsets) == 9 for l in mg.levels[1:]),
                    f"{tag}: RAP levels have 9 offsets (fine level {len(mg.levels[0].offsets)})")
        gates.check(got[key_elem] == want_elem > 0 and got["spmv_f32"] >= want32 and got["spmv_f64"] >= it,
                    f"{tag}: elem_stiffness {got[key_elem]} == {want_elem} (level 0 only), stencil_spmv "
                    f"<float> {got['spmv_f32']} >= {want32}, <double> {got['spmv_f64']} >= {it}")
        rows.append({"case": tag, "levels": nl, "iters": it, "residual": mg.last_residual, "center_w": w,
                     "rel_err": err, "solve_s": secs, "launches": got, "launches_total": got})
        print(f"  {tag}: levels={nl} iters={it} w={w:.10f} rel_err={err:.2e} {secs:.4f} s launches={got}",
              flush=True)
    return rows


def roof_pair_phase(gates, n, want, device="cuda"):
    """The pair path with Galerkin levels (df_operator=True, no df_cycle:
    the f64 CG over the assembled fine operator, the f32 V-cycle on f32
    casts of the f64 RAP chain), solve_df(rtol=1e-6) on the roof. ``want``
    = (iterations, midside w) of the port's own CPU run at this size:
    the count within 5 % (another f32 summation order), w within 1e-4
    relative."""
    from fem_shell_tpu_torch import MultigridShellSystem
    from fem_shell_tpu_torch.shells import SCORDELIS_LO_MATERIAL, scordelis_lo

    mesh, forces, mid = scordelis_lo(n)
    tag = f"roof{n} pair path"
    reset_launches()
    mg = MultigridShellSystem(mesh, SCORDELIS_LO_MATERIAL, dtype=torch.float32, df_operator=True,
                              smoother="chebyshev", device=device)
    ctor = read_launches()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    u = mg.solve_df(forces, rtol=1e-6, maxiter=2000)
    w = float(u[mid, 2])
    secs = time.perf_counter() - t0
    got = read_launches()
    it, res = mg.last_iters, mg.last_residual
    gates.check(mg._cdf is None and all(l.values.dtype == torch.float32 for l in mg.levels)
                and all(len(l.offsets) == 9 for l in mg.levels[1:]),
                f"{tag}: no class operator, f32 levels, 9-offset RAP levels")
    gates.check(res <= 1e-6 and bool(torch.isfinite(u).all()), f"{tag}: residual {res:.2e} <= 1e-6 in {it} iterations")
    want_it, want_w = want
    gates.check(abs(it - want_it) <= max(1, 0.05 * want_it) and abs(w - want_w) <= 1e-4 * abs(want_w),
                f"{tag}: {it} iterations vs the port's CPU {want_it} (5 %), w {w:.8f} vs {want_w:.8f} (1e-4)")
    gates.check(got["spmv_f32"] > 0 and got["spmv_f64"] + got["sym"] >= it,
                f"{tag}: stencil_spmv<float> {got['spmv_f32']} > 0, CG matvecs {got['spmv_f64'] + got['sym']} >= {it}")
    nl = mg.n_levels
    print(f"  {tag}: levels={nl} iters={it} residual={res:.2e} w={w:.10f} {secs:.3f} s launches={got}",
          flush=True)
    del mg
    return {"case": tag, "levels": nl, "iters": it, "residual": res, "center_w": w, "solve_s": secs,
            "launches": got, "launches_total": {k: ctor[k] + got[k] for k in got}}


# the subprocesses started to run beside this process; none outlives it
BACKGROUND = []


def stop_background():
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_concurrently(cmds, cwd, env, timeout=600):
    """Start ``python -m`` with each of ``cmds`` ({name: [module, args...]})
    at once, in ``cwd``; returns a handle whose ``wait()`` gives {name:
    (CompletedProcess, seconds from the start to its exit)}. A process
    past ``timeout`` is killed."""
    import threading
    import types

    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m"] + c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    BACKGROUND.extend(procs.values())
    done = {}

    def reap(k, p):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        done[k] = (subprocess.CompletedProcess(p.args, p.returncode, out, err), time.perf_counter() - t0)

    threads = [threading.Thread(target=reap, args=kv, daemon=True) for kv in procs.items()]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join()
        return {k: done[k] for k in cmds}

    return types.SimpleNamespace(wait=wait)


def vtu_displacement(path):
    """The [n, 3] displacement array of a .vtu the port's writer wrote."""
    import re

    body = re.search(r'Name="displacement"[^>]*>\n(.*?)</DataArray>', open(path).read(), re.S).group(1)
    return np.array([float(v) for v in body.split()]).reshape(-1, 3)


def cli_phase(gates, device="cuda"):
    """The port's meshgen and solver CLIs in subprocesses on the card (the
    two routes at once): exit 0, and the .vtu displacements equal to the
    library solve of the same files (the default route: ShellSystem;
    --precond mg: MultigridShellSystem.solve)."""
    import os
    import shutil

    from fem_shell_tpu_torch import Material, MultigridShellSystem, ShellSystem
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces

    work = OUT_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = str(work / "plateG")

    def run(args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m"] + args, cwd=work, env=env, capture_output=True,
                             text=True, timeout=600)
        return out, time.perf_counter() - t0

    gen, gen_s = run(["fem_shell_tpu_torch.meshgen"] + "q 64 64 0 0 10 10 0,0,0,0 300 2 1 z".split() + [base])
    gates.check(gen.returncode == 0 and os.path.exists(base + ".xda") and os.path.exists(base + "_f"),
                f"cli: python -m fem_shell_tpu_torch.meshgen exit {gen.returncode}, plateG.xda and plateG_f")
    mesh, forces = load_mesh_and_forces(base + ".xda")
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    rows = []
    routes = ([], ["--precond", "mg"])
    clis = run_concurrently({" ".join(route) or "default": [
        "fem_shell_tpu_torch.utils.cli", "-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh", base + ".xda", "-out",
        base + ("_mg" if route else "")] + route + ([] if device == "cuda" else ["--device", device])
        for route in routes}, work, env)
    done = None
    for route in routes:
        out_base = base + ("_mg" if route else "")
        name = " ".join(route) or "default"
        if route:
            u = MultigridShellSystem(mesh, mat, device=device).solve(forces, rtol=1e-10, maxiter=20000)
        else:
            u = ShellSystem(mesh, mat, device=device).solve(forces, rtol=1e-10, maxiter=20000)
        u = u.cpu().numpy()
        done = done or clis.wait()
        res, secs = done[name]
        ok = res.returncode == 0 and os.path.exists(out_base + ".vtu")
        gates.check(ok, f"cli {name}: exit {res.returncode}, {os.path.basename(out_base)}.vtu written")
        diff = float(np.abs(vtu_displacement(out_base + ".vtu") - u[:, :3]).max()) if ok else float("inf")
        gates.check(diff <= 1e-12 * float(np.abs(u[:, :3]).max()),
                    f"cli {name}: .vtu displacements - library solve of the same files: max {diff:.3e}")
        lines = res.stdout.strip().splitlines()
        print(f"  cli {name}: rc={res.returncode} {secs:.2f} s, {lines[-3:] if lines else res.stderr[-500:]}",
              flush=True)
        rows.append({"route": name, "returncode": res.returncode, "seconds": secs, "max_abs_diff": diff,
                     "bitwise_equal": diff == 0.0, "stdout": lines[-4:], "stderr": res.stderr[-2000:]})
    return {"meshgen_s": gen_s, "runs": rows}


# ----------------------------------------------------------------------
# phase 10: unstructured meshes
# ----------------------------------------------------------------------


def unstructured_plate(n, seed):
    """The n^2 Test-G quad plate with its nodes randomly renumbered
    (test_amg_million_dof's mesh at n = 416, seed 1): the mesh, its forces
    and the new id of the centre node."""
    from fem_shell_tpu_torch.mesh import permute_nodes

    mesh, rows, fac = plate("q", n)
    perm = np.random.default_rng(seed).permutation(mesh.n_nodes)
    centre = int(np.nonzero(perm == mesh.n_nodes // 2)[0][0])
    return permute_nodes(mesh, perm), (rows * fac)[perm], centre


class PlainElementCounter:
    """Counts calls of the plain element math (ops/elements.py and the
    element kernel's plain version) while active: on a CUDA path it must
    stay zero."""

    NAMES = ("tri_shell_stiffness", "quad_shell_stiffness", "batched_tri_stiffness",
             "batched_quad_stiffness", "elem_stiffness_plain")

    def __enter__(self):
        from fem_shell_tpu_torch.ops import elem_stiffness as es_mod, elements as el_mod

        self.calls = 0
        self.saved = []
        for mod in (el_mod, es_mod):
            for name in self.NAMES:
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self.saved.append((mod, name, fn))

                    def counted(*a, _fn=fn, **kw):
                        self.calls += 1
                        return _fn(*a, **kw)

                    setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def n_chunks(n_elem, chunk=16384):
    return -(-n_elem // chunk)


def product_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def gather_assembly_phase(gates, mesh, bandwidth, device="cuda"):
    """10(a): LargeShellSystem(reorder="rcm").assemble() of the permuted
    plate (gather mode, AMG's fine operator) on the card: the element kernel
    once per chunk, no plain element math, two assemblies bitwise equal,
    against the same assembly with the plain element math on the card; the
    gather-mode matvec timed against its bytes bound."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.soa import soa_matvec

    sys_ = LargeShellSystem(mesh, Material(0.3, 1e7, 0.5), reorder="rcm", device=device)
    tag = f"gather assembly q{int(round(np.sqrt(mesh.n_elems)))} (permuted, RCM)"
    sys_._passes  # the host pass tables, built once per system
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    with PlainElementCounter() as plain:
        t0 = time.perf_counter()
        v = sys_.assemble()
        torch.cuda.synchronize()
        asm_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    v2 = sys_.assemble()
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    same = torch.equal(v, v2)
    del v2
    t0 = time.perf_counter()
    with plain_soa_elements():
        ref = sys_.assemble()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    scale = float(ref.abs().max())
    err = float((v - ref).abs().max()) / scale
    del ref
    want = n_chunks(len(mesh.quad))
    k, npad = v.shape[1], v.shape[2]
    gates.check(sys_.offsets is None and k == 9 and bool(torch.isfinite(v).all()) and err <= GRID_GATE,
                f"{tag}: gather mode K={k} Npad={npad}, max|A - A_plain|/max|A| = {err:.3e} <= {GRID_GATE:.0e}")
    gates.check(same, f"{tag}: two assemblies bitwise equal")
    gates.check(launches["elem4"] == want and launches["elem3"] == 0 and plain.calls == 0,
                f"{tag}: elem_stiffness<4> launches {launches['elem4']} == {want} chunks, plain element "
                f"math calls {plain.calls} == 0")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(6, npad))).to(device)
    mv_ms = cuda_ms(lambda: soa_matvec(v, x, sys_.adj_t), 20)
    mv_bytes = product_bytes(v, sys_.adj_t, x, x)
    rec = {"case": tag, "k": k, "npad": npad, "rel_err": err, "bitwise_equal": same, "assemble_s": asm_s,
           "again_s": again_s, "plain_s": plain_s, "peak_bytes": peak, "launches": launches,
           "expected_elem4": want, "plain_calls": plain.calls,
           "gather_matvec": {"ms": mv_ms, "bytes": mv_bytes, "bound_ms": mv_bytes / bandwidth * 1e3}}
    print(f"  {tag}: K={k} Npad={npad} rel_err={err:.2e} bitwise={same} assemble_s={asm_s:.3f} "
          f"again={again_s:.3f} plain={plain_s:.3f} peak={peak} elem4 {launches['elem4']}/{want} "
          f"plain calls {plain.calls}; gather matvec {mv_ms:.4f} ms (bound "
          f"{rec['gather_matvec']['bound_ms']:.4f} ms)", flush=True)
    del v, x, sys_
    torch.cuda.empty_cache()
    return rec


def amg_products(amg, bandwidth):
    """CUDA-event times of the cycle's products on the fine level against
    their bytes bounds (each input read once, each output written once):
    the block-ELL matvec, the smoother's block apply, restriction P^T r and
    prolongation P e_c; and one whole cycle."""
    from fem_shell_tpu_torch.amg import _block_apply, amg_cycle
    from fem_shell_tpu_torch.ops.assemble import ell_matvec

    dl, dc = amg.levels[0], amg.levels[1]
    n, dt = dl.blocks.shape[0], dl.blocks.dtype
    g = torch.Generator(device=dl.blocks.device).manual_seed(5)
    r = torch.randn((n, 6), generator=g, device=dl.blocks.device, dtype=dt)
    ec = torch.randn((dl.n_coarse, 6), generator=g, device=dl.blocks.device, dtype=dt)

    def restrict():
        contrib = (dl.pblk * r[:, None, :, None]).sum(dim=2).reshape(-1, 6)
        return torch.cat([contrib, contrib.new_zeros((1, 6))])[dl.rsrc].sum(dim=1)

    rc = restrict()
    cases = {
        "ell_matvec": (lambda: ell_matvec(dl.blocks, dl.adj, r), (dl.blocks, dl.adj, r, r)),
        "block_apply": (lambda: _block_apply(dl.inv_diag, r), (dl.inv_diag, r, r)),
        "restrict": (restrict, (dl.pblk, r, dl.rsrc, rc)),
        "prolong": (lambda: ell_matvec(dl.pblk, dl.pcol, ec), (dl.pblk, dl.pcol, ec, r)),
    }
    out = {}
    for name, (fn, ts) in cases.items():
        ms = cuda_ms(fn, 20)
        nbytes = product_bytes(*ts)
        out[name] = {"ms": ms, "bytes": nbytes, "bound_ms": nbytes / bandwidth * 1e3}
    out["cycle_ms"] = cuda_ms(lambda: amg_cycle(amg.levels, r, amg.nu_smooth, amg.cycle), 5)
    out["dtype"] = str(dt)[6:]
    out["shapes"] = {"n": n, "k": int(dl.adj.shape[1]), "pk": int(dl.pcol.shape[1]),
                     "n_coarse": dl.n_coarse, "rk": int(dl.rsrc.shape[1])}
    return out


def amg_scale_phase(gates, mesh, forces, centre, bandwidth, device="cuda"):
    """10(b): AMGShellSystem(mesh, mat) (W cycle, RCM, f64) and
    solve(rtol=1e-10, maxiter=200) twice on the 1,043,334-DOF permuted
    plate; the constructor timed apart with its set-up stages."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.amg import AMGShellSystem

    tag = f"AMG f64 q{int(round(np.sqrt(mesh.n_elems)))} ({mesh.n_dofs} DOF)"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with PlainElementCounter() as plain:
        t0 = time.perf_counter()
        amg = AMGShellSystem(mesh, Material(0.3, 1e7, 0.5), device=device)
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
    ctor_launches = read_launches()
    ctor_peak = torch.cuda.max_memory_allocated()
    print(f"  {tag}: constructor {ctor_s:.2f} s, set-up stages "
          + " ".join(f"{k}={v:.3f}" for k, v in amg.setup_timings.items())
          + f"; levels {[l.n for l in amg.h_levels]}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    u = amg.solve(forces, rtol=1e-10, maxiter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    it, res = amg.last_iters, amg.last_residual
    t0 = time.perf_counter()
    again = amg.solve(forces, rtol=1e-10, maxiter=200)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    same = torch.equal(again, u)
    w = float(u[centre, 2])
    e_k = abs(w - KIRCHHOFF) / KIRCHHOFF
    jax_it, jax_w = JAX_AMG_416
    want = n_chunks(len(mesh.quad))
    gates.check(tuple(u.shape) == (mesh.n_nodes, 6) and bool(torch.isfinite(u).all()) and res <= 1e-10,
                f"{tag}: finite [{mesh.n_nodes}, 6], relative residual {res:.2e} <= 1e-10")
    gates.check(it < 100 and abs(it - jax_it) <= 2,
                f"{tag}: {it} iterations < 100 and within 2 of the JAX package's {jax_it}")
    gates.check(e_k < 1e-3, f"{tag}: centre w {w:.17g} within 1e-3 of {KIRCHHOFF} ({e_k:.2e}; JAX {jax_w})")
    gates.check(same, f"{tag}: two solves bitwise equal")
    gates.check(ctor_launches["elem4"] == want and plain.calls == 0,
                f"{tag}: fine assembly on the card, elem_stiffness<4> launches {ctor_launches['elem4']} == "
                f"{want} chunks, plain element math calls {plain.calls} == 0")
    prof = device_profile(lambda: amg.solve(forces, rtol=1e-10, maxiter=5))
    products = amg_products(amg, bandwidth)
    rec = {"case": tag, "levels": [l.n for l in amg.h_levels], "k": [int(l.adj.shape[1]) for l in amg.h_levels],
           "iters": it, "jax_iters": jax_it, "residual": res, "center_w": w, "jax_center_w": jax_w,
           "rel_err_kirchhoff": e_k, "ctor_s": ctor_s, "setup_timings": dict(amg.setup_timings),
           "solve_s": [solve_s, again_s], "s_per_iter": solve_s / max(it, 1), "bitwise_repeat": same,
           "ctor_launches": ctor_launches, "launches": launches, "ctor_peak_bytes": ctor_peak,
           "peak_mem_bytes": peak, "profile_5_iters": prof, "products": products}
    print(f"  {tag}: iters={it} (JAX {jax_it}) residual={res:.2e} w={w:.17g} solve_s={solve_s:.3f},"
          f"{again_s:.3f} s/iter={rec['s_per_iter'] * 1e3:.2f} ms bitwise={same} peak={peak} "
          f"ctor_peak={ctor_peak}", flush=True)
    print(f"  {tag} profile (5 iterations): wall_ms={prof['wall_ms']:.1f} "
          f"device_busy_ms={prof['device_busy_ms']:.1f} idle_share={prof['idle_share']}", flush=True)
    for row in prof["top"]:
        print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    for name in ("ell_matvec", "block_apply", "restrict", "prolong"):
        p = products[name]
        print(f"  {tag} {name}: {p['ms']:.4f} ms, bound {p['bound_ms']:.4f} ms ({p['bytes']} B)", flush=True)
    print(f"  {tag} one cycle: {products['cycle_ms']:.3f} ms; shapes {products['shapes']}", flush=True)
    del amg
    torch.cuda.empty_cache()
    return rec, u


def amg_refined_phase(gates, mesh, forces, centre, u64, bandwidth, device="cuda"):
    """10(c): the production setting (--precond amg --refined):
    AMGShellSystem(mesh, mat, dtype=float32, df=True).solve_df_refined(
    rtol=1e-9) on the same plate."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.amg import AMGShellSystem

    tag = f"AMG f32 df refined q{int(round(np.sqrt(mesh.n_elems)))}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    amg = AMGShellSystem(mesh, Material(0.3, 1e7, 0.5), dtype=torch.float32, df=True, device=device)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    ctor_launches = read_launches()
    print(f"  {tag}: constructor {ctor_s:.2f} s, set-up stages "
          + " ".join(f"{k}={v:.3f}" for k, v in amg.setup_timings.items()), flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u = amg.solve_df_refined(forces, rtol=1e-9)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, inner = amg.refine_history, amg.refine_inner_iters
    w = float(u[centre, 2])
    e_k = abs(w - KIRCHHOFF) / KIRCHHOFF
    du = float((u - u64).abs().max()) / float(u64.abs().max())
    gates.check(bool(np.all(np.isfinite(hist))) and amg.last_residual < 1e-9 and bool(torch.isfinite(u).all()),
                f"{tag}: final true residual {amg.last_residual:.2e} < 1e-9, history {hist} finite")
    gates.check(e_k < 1e-3, f"{tag}: centre w {w:.17g} within 1e-3 of {KIRCHHOFF} ({e_k:.2e})")
    gates.check(du <= 1e-6, f"{tag}: max|u - u_f64| / max|u_f64| = {du:.2e} <= 1e-6")
    gates.check(ctor_launches["elem4"] == n_chunks(len(mesh.quad)),
                f"{tag}: elem_stiffness<4> launches {ctor_launches['elem4']} in the constructor")
    products = amg_products(amg, bandwidth)
    rec = {"case": tag, "levels": [l.n for l in amg.h_levels], "ctor_s": ctor_s,
           "setup_timings": dict(amg.setup_timings), "solve_s": solve_s, "iters": amg.last_iters,
           "inner_iters": inner, "refine_history": hist, "center_w": w, "rel_err_kirchhoff": e_k,
           "rel_diff_f64": du, "ctor_launches": ctor_launches, "peak_mem_bytes": peak, "products": products}
    print(f"  {tag}: inner iters {inner} history {hist} w={w:.17g} du={du:.2e} solve_s={solve_s:.3f} "
          f"peak={peak}", flush=True)
    print(f"  {tag} f32 cycle: {products['cycle_ms']:.3f} ms; matvec {products['ell_matvec']['ms']:.4f} ms "
          f"(bound {products['ell_matvec']['bound_ms']:.4f})", flush=True)
    del amg
    torch.cuda.empty_cache()
    return rec


def large_routes_phase(gates, device="cuda"):
    """10(d): LargeShellSystem's routes. The Test-E I-beam with RCM and
    block-Jacobi against ShellSystem; solve_df_refined on a permuted
    (gather mode) and an unpermuted (stencil mode, stencil_spmv<double> and
    stencil_resid_dd<double>) 64^2 plate against ShellSystem f64; the
    I-beam refined twice through AMG against the f64 Jacobi-PCG
    LargeShellSystem."""
    from fem_shell_tpu_torch import Material, ShellSystem
    from fem_shell_tpu_torch.amg import AMGShellSystem
    from fem_shell_tpu_torch.data import mesh_from_tris, test_e as E
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.mesh import refine_uniform

    rows = []
    mat_e = Material(nu=0.25, em=10000, thickness=0.25)
    ibeam = mesh_from_tris(E.COORDS, E.TRIS, E.BOUNDARY_SIDES)
    ref = ShellSystem(ibeam, mat_e, device=device).solve(E.FORCES)
    reset_launches()
    big = LargeShellSystem(ibeam, mat_e, reorder="rcm", device=device)
    u = big.solve(E.FORCES, rtol=1e-12, precond="block_jacobi")
    launches = read_launches()
    err = float((u - ref).abs().max()) / float(ref.abs().max())
    tag = f"I-beam RCM block-Jacobi ({'stencil' if big.offsets is not None else 'gather'} mode)"
    gates.check(err <= 1e-12 and launches["elem3"] == 1,
                f"{tag}: {big.last_cg.iters} iterations, max|u - u_ShellSystem|/max = {err:.2e} <= 1e-12, "
                f"elem_stiffness<3> launches {launches['elem3']} == 1")
    rows.append({"case": tag, "iters": big.last_cg.iters, "rel_err": err, "launches": launches})
    print(f"  {tag}: iters={big.last_cg.iters} rel_err={err:.2e} launches={launches}", flush=True)

    for permute in (True, False):
        if permute:
            mesh, forces, _ = unstructured_plate(64, 3)
        else:
            mesh, rows_, fac = plate("q", 64)
            forces = rows_ * fac
        ref = ShellSystem(mesh, Material(0.3, 1e7, 0.5), device=device).solve(forces, rtol=1e-13)
        big = LargeShellSystem(mesh, Material(0.3, 1e7, 0.5), device=device)
        reset_launches()
        t0 = time.perf_counter()
        u = big.solve_df_refined(forces, rtol=1e-11, inner_rtol=1e-6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        err = float((u - ref).abs().max()) / float(ref.abs().max())
        inner, hist = big.refine_inner_iters, big.refine_history
        stencil = big.offsets is not None
        tag = f"LargeShellSystem.solve_df_refined q64 {'stencil' if stencil else 'gather'} mode"
        want64 = sum(inner) + len(hist) if stencil else 0
        want_resid = len(hist) if stencil else 0
        gates.check(err <= 1e-8 and bool(np.all(np.isfinite(hist))),
                    f"{tag}: max|u - u_ShellSystem|/max = {err:.2e} <= 1e-8, history {hist}")
        gates.check(launches["spmv_f64"] == want64 and launches["resid"] == want_resid
                    and launches["elem4"] == 1,
                    f"{tag}: stencil_spmv<double> {launches['spmv_f64']} == {want64} ({sum(inner)} CG + "
                    f"{len(hist)} residuals), stencil_resid_dd<double> {launches['resid']} == {want_resid}, "
                    f"elem_stiffness<4> {launches['elem4']} == 1")
        rows.append({"case": tag, "inner_iters": inner, "refine_history": hist, "rel_err": err,
                     "seconds": secs, "launches": launches})
        print(f"  {tag}: inner={inner} history={hist} rel_err={err:.2e} {secs:.3f} s launches={launches}",
              flush=True)

    fine = refine_uniform(ibeam, 2)
    f = np.zeros((fine.n_nodes, 6))
    f[: ibeam.n_nodes] = E.FORCES
    reset_launches()
    amg = AMGShellSystem(fine, mat_e, device=device)
    u = amg.solve(f, rtol=1e-10, maxiter=300)
    launches = read_launches()
    jac = LargeShellSystem(fine, mat_e, device=device)
    u_ref = jac.solve(f, rtol=1e-12, maxiter=200000)
    err = float((u - u_ref).abs().max()) / float(u_ref.abs().max())
    tag = f"I-beam refined twice ({fine.n_elems} elements) through AMG"
    gates.check(amg.last_residual < 1e-10 and amg.last_iters < 120 and err <= 1e-7,
                f"{tag}: {amg.last_iters} iterations, residual {amg.last_residual:.2e}, max|u - u_JacobiPCG|/max "
                f"= {err:.2e} <= 1e-7 (Jacobi-PCG {jac.last_cg.iters} iterations)")
    rows.append({"case": tag, "iters": amg.last_iters, "jacobi_iters": jac.last_cg.iters, "rel_err": err,
                 "launches": launches})
    print(f"  {tag}: iters={amg.last_iters} jacobi={jac.last_cg.iters} rel_err={err:.2e}", flush=True)
    return rows


def unstructured_cli_phase(gates, device="cuda"):
    """10(e): the solver CLI's unstructured routes in subprocesses on the
    card, all four at once, on a written 64^2 plate: --precond amg, --precond amg --refined,
    --reorder rcm and --refined; the .vtu displacements equal to the
    library calls' outputs on the same files."""
    import os
    import shutil

    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.amg import AMGShellSystem
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces

    work = OUT_DIR / "cli_unstructured"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = str(work / "plate")
    gen = subprocess.run([sys.executable, "-m", "fem_shell_tpu_torch.meshgen"]
                         + "q 64 64 0 0 10 10 0,0,0,0 300 2 1 z".split() + [base], cwd=work, env=env,
                         capture_output=True, text=True, timeout=600)
    gates.check(gen.returncode == 0, f"cli unstructured: meshgen exit {gen.returncode}")
    mesh, forces = load_mesh_and_forces(base + ".xda")
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    library = {
        "--precond amg": lambda: AMGShellSystem(mesh, mat, device=device).solve(
            forces, rtol=1e-10, maxiter=20000),
        "--precond amg --refined": lambda: AMGShellSystem(
            mesh, mat, dtype=torch.float32, df=True, device=device).solve_df_refined(
            forces, rtol=1e-10, inner_maxiter=20000),
        "--reorder rcm": lambda: LargeShellSystem(mesh, mat, reorder="rcm", device=device).solve(
            forces, rtol=1e-10, maxiter=20000, precond="block_jacobi"),
        "--refined": lambda: LargeShellSystem(mesh, mat, device=device).solve_df_refined(
            forces, rtol=1e-10, inner_maxiter=20000),
    }
    rows = []
    clis = run_concurrently({route: ["fem_shell_tpu_torch.utils.cli", "-nu", "0.3", "-e", "1e7", "-t", "0.5",
                                     "-mesh", base + ".xda", "-out", f"{base}_{i}"] + route.split()
                             + ([] if device == "cuda" else ["--device", device])
                             for i, route in enumerate(library)}, work, env)
    libs = {route: lib().cpu().numpy() for route, lib in library.items()}
    done = clis.wait()
    for i, route in enumerate(library):
        out_base = f"{base}_{i}"
        res, secs = done[route]
        ok = res.returncode == 0 and os.path.exists(out_base + ".vtu")
        gates.check(ok, f"cli {route}: exit {res.returncode}, .vtu written")
        u = libs[route]
        diff = float(np.abs(vtu_displacement(out_base + ".vtu") - u[:, :3]).max()) if ok else float("inf")
        gates.check(diff <= 1e-12 * float(np.abs(u[:, :3]).max()),
                    f"cli {route}: .vtu displacements - library call on the same files: max {diff:.3e}")
        lines = res.stdout.strip().splitlines()
        print(f"  cli {route}: rc={res.returncode} {secs:.2f} s, {lines[-3:] if lines else res.stderr[-500:]}",
              flush=True)
        rows.append({"route": route, "returncode": res.returncode, "seconds": secs, "max_abs_diff": diff,
                     "stdout": lines[-4:], "stderr": res.stderr[-2000:]})
    return rows

# ----------------------------------------------------------------------
# phase 11: the coupled solver and stress recovery
# ----------------------------------------------------------------------
# the tower demo's material (coupling/demo.py run_demo: nu, E, t) and the
# refinement of phase 11(c): each cell of the 2 x 20 tower split
# TOWER_SPLIT x TOWER_SPLIT
TOWER = ("t", 2, 20, 3.0, 0.0, 3.25, 2.0, (2, 0, 2, 2), 0.0, 0, False, "y")  # demo.tower_mesh's MeshGenParams
TOWER_MATERIAL = (0.3, 1e6, 0.1)
TOWER_SPLIT = 16
TOWER_STEPS = 30  # 11(a); 11(b) runs the first TOWER_CLI_STEPS of them
TOWER_CLI_STEPS = 10
TOWER_SCALE_STEPS = 3
PEER_TIMEOUT_S = 300  # each coupled peer, thread or subprocess
# the simply supported Test-G plate (q = 300, a = 10, t = 0.5):
# Timoshenko Table 8 centre moment 0.0479 q a^2 and corner twisting
# moment 0.0325 q a^2 (tests/test_recovery.py:66-137)
PLATE_M = 0.0479 * 300.0 * 10.0**2
PLATE_VM_CORNER = np.sqrt(3.0) * 6.0 * 0.0325 * 300.0 * 10.0**2 / 0.5**2
RECOVERY_CENTRE_TOL = {"q": 0.02, "t": 0.05}
RECOVERY_GATE = 1e-12  # card against the CPU, of max|field|
STRESS_FIELDS = ("sigma_m", "moments", "vm_top", "vm_bot")


def coupled_stats(res, wall_s):
    """Times of one run_structure from its PerfLog scopes: per coupling
    iteration the solve (the CG and the copy of u to the host) and the
    host's coupling work (write, advance, read: transport, mapping,
    IQN-ILS); CG iterations per solve and milliseconds per CG iteration."""
    solve, coup = res.perf.stats("solve"), res.perf.stats("coupling")
    cg = sum(res.iterations)
    return {"timesteps": res.timesteps, "wall_s": wall_s, "setup_s": res.perf.stats("setup")["total"],
            "coupling_iterations": len(res.iterations), "step_iterations": res.step_iterations,
            "ms_per_coupling_iteration": 1e3 * (solve["total"] + coup["total"]) / solve["n"],
            "solve_ms_per_coupling_iteration": 1e3 * solve["avg"],
            "host_ms_per_coupling_iteration": 1e3 * coup["avg"],
            "cg_iterations": cg, "cg_iterations_per_solve": cg / len(res.iterations),
            "ms_per_cg_iteration": 1e3 * solve["total"] / cg if cg else None}


def tower_demo_phase(gates, device="cuda"):
    """11(a): the tower demo (coupling/demo.py run_demo, in-process
    transport) for TOWER_STEPS steps once on the CPU and twice on
    ``device``: per-step solutions within 1e-10 of max|u| of the CPU run,
    the same coupling iterations in every step, one elem_stiffness<3>
    launch per run (the operator is assembled once), two runs equal bit
    for bit, the tip following 1 + sin(t / 25.01). Returns (record, the
    first card run's result)."""
    from fem_shell_tpu_torch.coupling.demo import run_demo

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    ref, _ = run_demo(max_timesteps=TOWER_STEPS, verbose=False, device="cpu")
    cpu = coupled_stats(ref, time.perf_counter() - t0)
    runs, recs = [], []
    for k in range(2):
        reset_launches()
        t0 = time.perf_counter()
        res, hist = run_demo(max_timesteps=TOWER_STEPS, verbose=False, device=device)
        rec = coupled_stats(res, time.perf_counter() - t0)
        rec["launches"] = read_launches()
        runs.append(res)
        recs.append(rec)
        gates.check(res.timesteps == TOWER_STEPS and hist is not None and len(hist) == TOWER_STEPS,
                    f"tower demo run {k}: {res.timesteps} structure and "
                    f"{None if hist is None else len(hist)} fluid steps of {TOWER_STEPS}")
        if cuda:
            got = rec["launches"]
            gates.check(got["elem3"] == 1 and got["elem4"] == 0,
                        f"tower demo run {k}: elem_stiffness<3> launched {got['elem3']} time(s) (1), <4> "
                        f"{got['elem4']} (0)")
    a, b = runs
    scale = float(np.abs(ref.solutions).max())
    same_shape = a.solutions.shape == ref.solutions.shape
    diff = float(np.abs(a.solutions - ref.solutions).max()) if same_shape else float("inf")
    gates.check(diff <= 1e-10 * scale, f"tower demo: card - CPU solutions max {diff:.3e} <= 1e-10 * {scale:.4e}")
    gates.check(a.step_iterations == ref.step_iterations,
                f"tower demo: coupling iterations per step {a.step_iterations} == CPU's")
    gates.check(np.array_equal(a.solutions, b.solutions) and a.iterations == b.iterations,
                "tower demo: two card runs equal bit for bit")
    tip = np.abs(a.solutions[:, :, 0]).max(axis=1)
    corr = float(np.corrcoef(tip, 1.0 + np.sin(np.arange(len(tip)) / 25.01))[0, 1])
    gates.check(corr > 0.999, f"tower demo: tip |u_x| correlation with 1 + sin(t/25.01) {corr:.6f} > 0.999")
    cg_diff = max(abs(x - y) for x, y in zip(a.iterations, ref.iterations)) if same_shape else None
    for tag, rec in [("cpu", cpu)] + [(f"{device} {k}", r) for k, r in enumerate(recs)]:
        print(f"  tower demo {tag}: {rec['wall_s']:.3f} s, {rec['coupling_iterations']} coupling iterations, "
              f"{rec['ms_per_coupling_iteration']:.3f} ms each (solve {rec['solve_ms_per_coupling_iteration']:.3f}, "
              f"host {rec['host_ms_per_coupling_iteration']:.3f}), {rec['cg_iterations_per_solve']:.1f} CG "
              f"iterations per solve at {rec['ms_per_cg_iteration']:.4f} ms", flush=True)
    return {"cpu": cpu, "runs": recs, "max_abs_diff_cpu": diff, "scale": scale, "cg_iters_max_diff_cpu": cg_diff,
            "tip_corr": corr}, a


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def coupled_cli_phase(gates, ref, device="cuda"):
    """11(b): python -m ...coupling.fluid_cli and python -m
    ...coupling.structure_cli as two subprocesses over TCP (the tower XML
    on a free port, the mesh written by the port's meshgen), the structure on
    ``device``, for TOWER_CLI_STEPS steps: both exit 0, and the Exodus
    series holds the steps with displacements within 1e-12 of max|u| of
    11(a)'s first steps. A peer that does not finish within
    PEER_TIMEOUT_S is killed, with its partner, and fails the phase."""
    import os
    import shutil

    from fem_shell_tpu_torch.coupling.demo import CONFIG
    from fem_shell_tpu_torch.io.exodus import read_exodus_summary
    from fem_shell_tpu_torch.meshgen import MeshGenParams, write_files

    work = OUT_DIR / "coupled_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    xml = work / "tower.xml"
    xml.write_text(Path(CONFIG).read_text().replace('port="50077"', f'port="{free_port()}"'))
    write_files(MeshGenParams(*TOWER), str(work / "tower"))
    nu, em, t = TOWER_MATERIAL
    steps = str(TOWER_CLI_STEPS)
    cmds = {
        "fluid": ["fem_shell_tpu_torch.coupling.fluid_cli", str(xml), "43", steps],
        "structure": ["fem_shell_tpu_torch.coupling.structure_cli", "-nu", str(nu), "-e", str(em), "-t", str(t),
                      "-mesh", str(work / "tower.xda"), "-config", str(xml), "-dt", "0.01", "-axis", "y",
                      "--steps", steps, "-out", str(work / "tower.e")]
                     + ([] if device == "cuda" else ["--device", device]),
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m"] + c, cwd=work, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    done = {}
    try:
        for k, proc in procs.items():
            left = max(1.0, PEER_TIMEOUT_S - (time.perf_counter() - t0))
            try:
                out, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                for other in procs.values():
                    other.kill()
                out, err = proc.communicate()
            done[k] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    secs = time.perf_counter() - t0
    for k, (rc, out, err) in done.items():
        lines = out.strip().splitlines()
        print(f"  coupled cli {k}: rc={rc} {lines[-2:] if lines else err[-500:]}", flush=True)
        gates.check(rc == 0, f"coupled cli: {k} exit {rc}")
    n = TOWER_CLI_STEPS
    diff, times = float("inf"), None
    if (work / "tower.e").exists():
        summ = read_exodus_summary(str(work / "tower.e"))
        times = [float(v) for v in summ["times"]]
        names = ("disp_x", "disp_y", "disp_z", "rot_x", "rot_y", "rot_z")
        got = np.stack([summ["nodal_vars"][name] for name in names], axis=-1)
        if got.shape == ref.solutions[:n].shape:
            diff = float(np.abs(got - ref.solutions[:n]).max())
    scale = float(np.abs(ref.solutions[:n]).max())
    gates.check(times is not None and len(times) == n and diff <= 1e-12 * scale,
                f"coupled cli: tower.e holds {None if times is None else len(times)} steps of {n}, "
                f"displacements - 11(a)'s: max {diff:.3e} <= 1e-12 * {scale:.4e}")
    return {"seconds": secs, "max_abs_diff": diff, "times": times,
            "returncodes": {k: v[0] for k, v in done.items()},
            "stdout": {k: v[1].strip().splitlines()[-3:] for k, v in done.items()},
            "stderr": {k: v[2][-2000:] for k, v in done.items()}}


def tower_scale_phase(gates, device="cuda", split=TOWER_SPLIT, steps=TOWER_SCALE_STEPS):
    """11(c): the tower with each cell split ``split`` x ``split`` against
    the unchanged 43-node dummy fluid, in-process, ``steps`` steps, twice
    on ``device`` (the second with one step under torch.profiler): every
    window converged under the XML's iteration cap, one elem_stiffness<3>
    launch per run, two runs equal bit for bit, and the last step's u
    within 1e-8 of max|u| of ShellSystem(...).solve of its load at rtol
    1e-12."""
    import threading

    from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem, generate
    from fem_shell_tpu_torch.coupling.adapter import interface_load, run_structure
    from fem_shell_tpu_torch.coupling.config import parse_config
    from fem_shell_tpu_torch.coupling.demo import CONFIG
    from fem_shell_tpu_torch.coupling.fluid_dummy import run_fluid
    from fem_shell_tpu_torch.coupling.m2n import InProcessTransport

    cuda = torch.device(device).type == "cuda"
    mesh, _, _ = generate(MeshGenParams(TOWER[0], TOWER[1] * split, TOWER[2] * split, *TOWER[3:]))
    iface = mesh.coupling_node_ids()
    nu, em, t = TOWER_MATERIAL
    mat = Material(nu=nu, em=em, thickness=t)
    cap = parse_config(CONFIG).scheme.max_iterations
    tag = f"tower {split}x{split} split ({mesh.n_nodes} nodes, {mesh.n_elems} elements, {mesh.n_dofs} DOF, " \
          f"{len(iface)} interface nodes)"
    from torch.profiler import ProfilerActivity, profile

    runs, recs, prof = [], [], {}
    for k in range(2):
        def on_timestep(step, sols, k=k):
            if not (cuda and k == 1):
                return
            if step == 1:  # profile the next step's coupling iterations
                torch.cuda.synchronize()
                prof["p"] = profile(activities=[ProfilerActivity.CUDA])  # kernels only: ~10^5 launches
                prof["p"].start()
                prof["t0"] = time.perf_counter()
            elif step == 2:
                torch.cuda.synchronize()
                prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
                prof["p"].stop()

        ts, tf = InProcessTransport.pair()
        fluid = threading.Thread(target=run_fluid, args=(CONFIG,), kwargs={"transport": tf, "max_timesteps": steps},
                                 daemon=True)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        reset_launches()
        fluid.start()
        t0 = time.perf_counter()
        res = run_structure(mesh, mat, CONFIG, dt=0.01, dead_axis="y", transport=ts, on_timestep=on_timestep,
                            max_timesteps=steps, device=device)
        rec = coupled_stats(res, time.perf_counter() - t0)
        rec["launches"] = read_launches()
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base if cuda else None
        rec["s_per_timestep"] = (rec["wall_s"] - rec["setup_s"]) / max(res.timesteps, 1)
        fluid.join(timeout=PEER_TIMEOUT_S)
        gates.check(not fluid.is_alive() and res.timesteps == steps,
                    f"{tag} run {k}: {res.timesteps} of {steps} steps, the fluid finished")
        gates.check(max(res.step_iterations, default=cap) < cap,
                    f"{tag} run {k}: coupling iterations per step {res.step_iterations} < {cap}")
        if cuda:
            got = rec["launches"]
            gates.check(got["elem3"] == 1 and got["elem4"] == 0,
                        f"{tag} run {k}: elem_stiffness<3> launched {got['elem3']} time(s) (1)")
        runs.append(res)
        recs.append(rec)
        print(f"  {tag} run {k}: {rec['wall_s']:.2f} s (set-up {rec['setup_s']:.3f} s, "
              f"{rec['s_per_timestep']:.3f} s per step), steps {res.step_iterations}, "
              f"{rec['cg_iterations_per_solve']:.1f} CG iterations per solve at {rec['ms_per_cg_iteration']} ms, "
              f"peak {rec['peak_mem_bytes']}", flush=True)
    a, b = runs
    gates.check(np.array_equal(a.solutions, b.solutions) and a.iterations == b.iterations,
                f"{tag}: two runs equal bit for bit")
    reset_launches()
    load = interface_load(mesh.n_nodes, iface, a.iface_forces[-1], 2, "y")
    t0 = time.perf_counter()
    direct = ShellSystem(mesh, mat, device=device)
    u = direct.solve(load, rtol=1e-12).cpu().numpy()
    direct_s = time.perf_counter() - t0
    direct_launches = read_launches()
    diff = float(np.abs(a.solutions[-1] - u).max())
    scale = float(np.abs(u).max())
    gates.check(diff <= 1e-8 * scale,
                f"{tag}: last step - ShellSystem.solve(rtol=1e-12) of its load: max {diff:.3e} <= 1e-8 * {scale:.4e}")
    profiled = None
    if "p" in prof:
        profiled = profile_summary(prof["p"], prof["wall_ms"])
        print(f"  {tag} profiled step: wall {profiled['wall_ms']:.1f} ms, device busy "
              f"{profiled['device_busy_ms']:.1f} ms, idle share {profiled['idle_share']}", flush=True)
        for row in profiled["top"]:
            print(f"    {row['ms']:9.3f} ms {row['count']:6d}x {row['kernel']}", flush=True)
    return {"case": tag, "nodes": mesh.n_nodes, "elements": mesh.n_elems, "dof": mesh.n_dofs,
            "interface_nodes": len(iface), "runs": recs, "direct_iters": int(direct.last_cg.iters),
            "direct_s": direct_s, "direct_launches": direct_launches, "max_abs_diff_direct": diff,
            "profiled_step": profiled}


def recovery_phase(gates, fields, n=1024, device="cuda"):
    """11(d): recover_stresses and recover_stresses_nodal on ``device`` on
    phase 4's converged n x n tri and quad fields: the centre node's nodal
    Mx, My and the element-centre peak moment against 0.0479 q a^2, the
    nodal vm maximum against the corner twisting value, two calls equal
    bit for bit; seconds and peak memory. Then on phase 3's 64x64 fields
    the card's fields within RECOVERY_GATE of max|field| of the same calls
    on the CPU."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.ops.recovery import recover_stresses, recover_stresses_nodal

    cuda = torch.device(device).type == "cuda"
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    out = []
    for et in ("t", "q"):
        tag = f"{et}{n}"
        mesh, u = fields[tag]
        rec = {"case": tag, "elements": mesh.n_elems}
        results = {}
        for fn in (recover_stresses, recover_stresses_nodal):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if cuda else 0
            t0 = time.perf_counter()
            got = fn(mesh, mat, u, device=device)
            rec[f"{fn.__name__}_s"] = time.perf_counter() - t0
            rec[f"{fn.__name__}_peak_bytes"] = torch.cuda.max_memory_allocated() - base if cuda else None
            again = fn(mesh, mat, u, device=device)
            same = all(np.array_equal(getattr(got, f), getattr(again, f)) for f in STRESS_FIELDS)
            gates.check(same, f"recovery {tag}: two {fn.__name__} calls equal bit for bit")
            results[fn.__name__] = got
        elem, nodal = results["recover_stresses"], results["recover_stresses_nodal"]
        centre = mesh.n_nodes // 2
        tol = RECOVERY_CENTRE_TOL[et]
        mx, my = (abs(float(nodal.moments[centre, i])) for i in (0, 1))
        peak = float(np.abs(elem.moments[:, :2]).max())
        vm_max = float(nodal.vm.max())
        gates.check(max(abs(mx - PLATE_M), abs(my - PLATE_M)) < tol * PLATE_M,
                    f"recovery {tag}: centre nodal Mx {mx:.3f}, My {my:.3f} within {tol:.0%} of {PLATE_M:.1f}")
        gates.check(abs(vm_max - PLATE_VM_CORNER) < 0.06 * PLATE_VM_CORNER,
                    f"recovery {tag}: nodal vm max {vm_max:.1f} within 6 % of {PLATE_VM_CORNER:.1f}")
        gates.check(abs(peak - PLATE_M) < 0.05 * PLATE_M,
                    f"recovery {tag}: element-centre peak moment {peak:.3f} within 5 % of {PLATE_M:.1f}")
        rec.update({"centre_mx": mx, "centre_my": my, "elem_peak_moment": peak, "nodal_vm_max": vm_max})
        print(f"  recovery {tag}: {rec}", flush=True)
        out.append(rec)
    for et in ("t", "q"):
        tag = f"{et}64"
        mesh, u = fields[tag]
        worst = 0.0
        for fn in (recover_stresses, recover_stresses_nodal):
            got, want = fn(mesh, mat, u, device=device), fn(mesh, mat, u, device="cpu")
            for f in STRESS_FIELDS:
                d, scale = (float(np.abs(x).max()) for x in (getattr(got, f) - getattr(want, f), getattr(want, f)))
                # a flat plate's membrane stress is exactly zero on both devices
                worst = max(worst, d / scale if scale > 0 else (0.0 if d == 0 else float("inf")))
        gates.check(worst <= RECOVERY_GATE,
                    f"recovery {tag}: {device} - cpu fields max {worst:.3e} of max|field| <= {RECOVERY_GATE:.0e}")
        out.append({"case": tag, "max_rel_diff_cpu": worst})
    return out


def stress_cli_phase(gates, device="cuda"):
    """11(e): python -m fem_shell_tpu_torch.utils.cli --stress in three
    concurrent subprocesses on ``device``: a 64x64 plate from .xda, the
    same plate written as .xdr, and the thesis example from .msh (with
    nodal moments on its free rotations): exit 0, and every .vtu point and cell array
    equal bit for bit to the library calls on the same files
    (ShellSystem.solve, recover_stresses, recover_stresses_nodal,
    to_mesh_order)."""
    import os
    import re
    import shutil

    from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces, read_xda, write_xdr
    from fem_shell_tpu_torch.meshgen import write_files
    from fem_shell_tpu_torch.ops.recovery import recover_stresses, recover_stresses_nodal, to_mesh_order

    work = OUT_DIR / "cli_stress"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    write_files(MeshGenParams("q", 64, 64, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"), str(work / "plate"))
    write_xdr(read_xda(str(work / "plate.xda")), str(work / "platex.xdr"))
    shutil.copy(work / "plate_f", work / "platex_f")
    (work / "thesis.msh").write_text(
        "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n4\n1 -1.0 -1.0 0.0\n2 1.0 -1.0 0.0\n"
        "3 -1.0 1.0 0.0\n4 1.0 1.0 0.0\n$EndNodes\n$Elements\n6\n1 2 2 0 0 1 2 3\n2 2 2 0 0 2 4 3\n"
        "3 15 2 0 0 1\n4 15 2 0 0 2\n5 15 2 1 0 3\n6 15 2 1 0 4\n$EndElements\n")
    (work / "thesis_f").write_text("4\n1\n0 0 0 1 0.5 0\n0 0 0 -0.5 1 0.2\n0 0 0 0 0 0\n0 0 0 0 0 0\n")
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    names = ("plate.xda", "platex.xdr", "thesis.msh")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "fem_shell_tpu_torch.utils.cli", "-nu", "0.3", "-e",
                                     "1e7", "-t", "0.5", "-mesh", str(work / name), "-out",
                                     str(work / (name.replace(".", "_") + "_out")), "--stress"]
                                    + ([] if device == "cuda" else ["--device", device]),
                                    cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in names}  # the three routes at once
    done = {}
    try:
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=max(1.0, PEER_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            done[name] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    secs = time.perf_counter() - t0
    rows = []
    for name in names:
        path = str(work / name)
        out_base = str(work / (name.replace(".", "_") + "_out"))
        rc, stdout, stderr = done[name]
        ok = rc == 0 and os.path.exists(out_base + ".vtu")
        gates.check(ok, f"cli --stress {name}: exit {rc}, .vtu written")
        mesh, forces = load_mesh_and_forces(path)
        u = ShellSystem(mesh, mat, device=device).solve(forces, rtol=1e-10, maxiter=20000).cpu().numpy()
        field = recover_stresses(mesh, mat, u, device=device)
        nodal = recover_stresses_nodal(mesh, mat, u, device=device)
        want = {"PointData": {"von_mises": nodal.vm, "moments": nodal.moments, "sigma_membrane": nodal.sigma_m,
                              "displacement": u[:, :3], "rotation": u[:, 3:]},
                "CellData": {"von_mises": to_mesh_order(mesh, field.vm),
                             "moments": to_mesh_order(mesh, field.moments),
                             "sigma_membrane": to_mesh_order(mesh, field.sigma_m)}}
        diffs = {}
        if ok:
            txt = open(out_base + ".vtu").read()
            for sec, arrays in want.items():
                body = re.search(f"<{sec}>(.*?)</{sec}>", txt, re.S).group(1)
                got = dict(re.findall(r'Name="(\w+)"[^>]*format="ascii">\n(.*?)</DataArray>', body, re.S))
                for key, arr in arrays.items():
                    vals = np.array([float(v) for v in got.get(key, "").split()])
                    diffs[f"{sec}/{key}"] = (float(np.abs(vals - np.asarray(arr).reshape(-1)).max())
                                             if vals.size == np.asarray(arr).size else float("inf"))
        worst = max(diffs.values(), default=float("inf"))
        gates.check(worst == 0.0, f"cli --stress {name}: every .vtu array - library call: max {worst:.3e} (0)")
        lines = stdout.strip().splitlines()
        print(f"  cli --stress {name}: rc={rc}, {[ln for ln in lines if 'von Mises' in ln] or stderr[-500:]}",
              flush=True)
        rows.append({"mesh": name, "returncode": rc, "max_abs_diff": worst, "stdout": lines[-4:],
                     "stderr": stderr[-2000:]})
    print(f"  cli --stress: three subprocesses in {secs:.2f} s", flush=True)
    return {"seconds": secs, "runs": rows}


def f32v_kernel_phase(gates, shapes, reps, bandwidth, peaks, device="cuda"):
    """stencil_spmv_f32v (f32 values, f64 x and y) against its plain version
    on operators assembled by the port and cast to f32, with a random f64
    x: gate F32V_GATE of max|y| (both widen the same f32 values exactly and
    sum in f64, in another order). Times with CUDA events: kernel, plain
    version, bound (4 bytes per value read, 8 per x and y entry, over the
    datasheet bandwidth, or 72 f64 operations per stored block slot over
    the f64 vector peak) and the f64 BSR product of the cast-up operator
    (the same function) as a yardstick the port never calls."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv_f32v, stencil_spmv_plain

    mat = Material(0.3, 1e7, 0.5)
    rows = []
    for et, n in shapes:
        mesh, _, _ = plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device=device, chunk=65536)
        v = sys_.assemble().to(torch.float32)
        offs = tuple(int(o) for o in sys_.offsets)
        k, npad = v.shape[1], v.shape[2]
        x = torch.from_numpy(np.random.default_rng(n + 1).normal(size=(6, npad))).to(device)
        y = stencil_spmv_f32v(v, x, offs)
        y_plain = stencil_spmv_plain(v, x, offs)
        torch.cuda.synchronize()
        scale = float(y_plain.abs().max())
        err = float((y - y_plain).abs().max()) / scale
        tag = f"{et}{n} K={k} Npad={npad} f32 values, f64 x"
        gates.check(err <= F32V_GATE and y.dtype == torch.float64 and bool(torch.isfinite(y).all()),
                    f"stencil_spmv_f32v {tag}: max|y-y_plain|/max|y| = {err:.3e} <= {F32V_GATE:.0e}")
        r = reps[n]
        ms = cuda_ms(lambda: stencil_spmv_f32v(v, x, offs), r)
        plain_ms = cuda_ms(lambda: stencil_spmv_plain(v, x, offs), max(2, r // 10))
        slots = sum(npad - abs(o) for o in offs)
        nbytes = 4 * 36 * slots + 8 * 12 * npad
        flops = 72 * slots
        bound_ms = max(nbytes / bandwidth, flops / peaks[torch.float64]) * 1e3
        bound_by = "bytes" if nbytes / bandwidth >= flops / peaks[torch.float64] else "operations"
        library_ms = None
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                a = bsr_operator(v.to(torch.float64), offs)
            xa = x.T.reshape(-1, 1).contiguous()
            library_ms = cuda_ms(lambda: a @ xa, max(2, r // 2))
            del a, xa
        except (RuntimeError, NotImplementedError) as e:  # yardstick only
            print(f"  library BSR product unavailable for {tag}: {type(e).__name__}: {e}")
        rec = {"shape": f"{et}{n}", "k": k, "npad": npad, "max_abs_err": float((y - y_plain).abs().max()),
               "rel_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6,
               "share_of_bound": bound_ms / ms}
        print(f"  f32v {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({rec['share_of_bound']:.0%} of the bound) library_ms={library_ms} rel_err={err:.2e}", flush=True)
        rows.append(rec)
        del v, x, y, y_plain, sys_
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# phase 12: the differentiable solve and the f32 systems


def grad_probe(g, free, k):
    """The k entries of largest |g| among ``free`` ones, as index tuples."""
    flat = torch.where(free.reshape(-1) > 0, g.reshape(-1).abs(), torch.zeros_like(g.reshape(-1)))
    idx = torch.topk(flat, k).indices.cpu().numpy()
    return [tuple(int(v) for v in np.unravel_index(i, tuple(g.shape))) for i in idx]


def compliance_grads(system, coords, forces, rtol=GRAD_RTOL):
    """(c, dc/d coords, dc/d forces, x) of the compliance c = f^T u(coords,
    f) through _solve_pcg_impl(..., differentiable=True)."""
    c_ = coords.detach().clone().requires_grad_(True)
    f_ = forces.detach().clone().requires_grad_(True)
    x, _ = system._solve_pcg_impl(c_, f_, rtol, GRAD_MAXITER, differentiable=True)
    c = torch.sum(x * f_)
    c.backward()
    return float(c.detach()), c_.grad, f_.grad, x.detach()


def grad_phase(gates, device="cuda", split=TOWER_SPLIT):
    """12(a): load and coordinate gradients of the compliance on the tower
    split ``split`` x ``split`` under GRAD_LOAD (a lateral load of 1 in x on
    every interface node), ShellSystem in f64, rtol GRAD_RTOL: one
    elem_stiffness<3> launch per forward, none in the backward; central
    differences of the compliance at the GRAD_PROBES largest entries of
    each gradient (FD_EPS steps, FD_RTOL); two forward + backward passes
    equal bit for bit. Records the forward s, the backward s and its parts
    (adjoint CG, element vjp, nodal sum, each timed again alone), the CG
    iterations of the forward and adjoint solves, and the peak memory."""
    from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem, generate
    from fem_shell_tpu_torch.coupling.adapter import interface_load
    from fem_shell_tpu_torch.ops.assemble import element_cotangents, sum_by_table
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness_vjp
    from fem_shell_tpu_torch.solver import pcg

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mesh, _, _ = generate(MeshGenParams(TOWER[0], TOWER[1] * split, TOWER[2] * split, *TOWER[3:]))
    iface = mesh.coupling_node_ids()
    nu, em, t = TOWER_MATERIAL
    system = ShellSystem(mesh, Material(nu=nu, em=em, thickness=t), device=device)
    load = np.zeros((len(iface), 2))
    load[:, 0] = GRAD_LOAD
    forces = torch.as_tensor(interface_load(mesh.n_nodes, iface, load, 2, "y"), device=device)
    tag = f"tower {split}x{split} ({mesh.n_nodes} nodes, {mesh.n_dofs} DOF)"
    runs = []
    for k in range(2):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        coords = system.coords.detach().clone().requires_grad_(True)
        f = forces.clone().requires_grad_(True)
        reset_launches()
        sync()
        t0 = time.perf_counter()
        x, res = system._solve_pcg_impl(coords, f, GRAD_RTOL, GRAD_MAXITER, differentiable=True)
        c = torch.sum(x * f)
        sync()
        fwd_s = time.perf_counter() - t0
        fwd_launches = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        c.backward()
        sync()
        bwd_s = time.perf_counter() - t0
        bwd_launches = read_launches()
        runs.append({"forward_s": fwd_s, "backward_s": bwd_s, "residual": res.residual,
                     "adjoint_iters": int(system.last_adjoint_cg.iters),
                     "adjoint_residual": float(system.last_adjoint_cg.residual),
                     "forward_launches": fwd_launches, "backward_launches": bwd_launches,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated() - base if cuda else None,
                     "grads": (coords.grad.detach(), f.grad.detach()), "compliance": float(c.detach())})
        if cuda:
            gates.check(fwd_launches["elem3"] == 1 and fwd_launches["elem4"] == 0 and bwd_launches["elem3"] == 0,
                        f"grad {tag} pass {k}: elem_stiffness<3> launched {fwd_launches['elem3']} time(s) in the "
                        f"forward (1), {bwd_launches['elem3']} in the backward (0)")
        gates.check(system.last_adjoint_cg.residual <= GRAD_RTOL,
                    f"grad {tag} pass {k}: adjoint CG residual {system.last_adjoint_cg.residual:.2e} "
                    f"({system.last_adjoint_cg.iters} iterations) <= {GRAD_RTOL:.0e}; the forward's true "
                    f"residual {res.residual:.2e} (recorded)")
    a, b = runs
    same = all(torch.equal(p, q) for p, q in zip(a["grads"], b["grads"]))
    gates.check(same, f"grad {tag}: two forward + backward passes equal bit for bit")
    gc, gf = a["grads"]
    # the forward CG alone, for its iteration count
    x, fres = system._solve_pcg_impl(system.coords, forces, GRAD_RTOL, GRAD_MAXITER)
    fwd_iters = int(fres.iters)
    gates.check(fres.residual <= GRAD_RTOL, f"grad {tag}: forward CG {fwd_iters} iterations to residual "
                                            f"{fres.residual:.2e} <= {GRAD_RTOL:.0e}")
    # the backward's parts, each timed again alone on the same inputs
    op = system.assemble()
    prec = system._preconditioner(op, "block_jacobi")
    gx = forces.clone()  # d c / d x with f fixed
    sync()
    t0 = time.perf_counter()
    lam = pcg(op.matvec, gx, rtol=GRAD_RTOL, maxiter=GRAD_MAXITER, apply_prec=prec).x * system.free_mask
    sync()
    adj_s = time.perf_counter() - t0
    xm = x * system.free_mask
    t0 = time.perf_counter()
    rows = []
    for conn in (system.tri_conn, system.quad_conn):
        if conn.shape[0]:
            xyz = system.coords[conn].permute(1, 2, 0).contiguous()
            g = elem_stiffness_vjp(xyz, system.dm, system.dp, system.thickness, element_cotangents(lam, xm, conn))
            rows.append(g.permute(2, 0, 1).reshape(-1, 3))
    rows.append(system.coords.new_zeros((1, 3)))
    rows = torch.cat(rows)
    sync()
    vjp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sum_by_table(rows, system._corners)
    sync()
    sum_s = time.perf_counter() - t0
    # central differences of the compliance at the largest entries
    def comp(coords, f):
        u, _ = system._solve_pcg_impl(coords, f, GRAD_RTOL, GRAD_MAXITER)
        return float(torch.sum(u * f))

    fd = []
    free3 = torch.ones_like(gc)
    for kind, g, free in (("forces", gf, system.free_mask), ("coords", gc, free3)):
        for probe in grad_probe(g, free, GRAD_PROBES):
            eps = FD_EPS[kind]
            args = [system.coords, forces]
            i = 0 if kind == "coords" else 1
            plus, minus = args[i].clone(), args[i].clone()
            plus[probe] += eps
            minus[probe] -= eps
            ap, am = list(args), list(args)
            ap[i], am[i] = plus, minus
            val = (comp(*ap) - comp(*am)) / (2 * eps)
            got = float(g[probe])
            rel = abs(got - val) / abs(val)
            gates.check(rel <= FD_RTOL[kind], f"grad {tag}: d c / d {kind}{list(probe)} = {got:.10e}, central "
                                              f"difference {val:.10e}: relative {rel:.2e} <= {FD_RTOL[kind]:.0e}")
            fd.append({"kind": kind, "probe": list(probe), "grad": got, "fd": val, "rel": rel})
    rec = {"case": tag, "dof": mesh.n_dofs, "load": f"{GRAD_LOAD} in x on each of {len(iface)} interface nodes",
           "compliance": a["compliance"], "forward_iters": fwd_iters, "bitwise_repeat": same,
           "adjoint_s_alone": adj_s, "vjp_s_alone": vjp_s, "nodal_sum_s_alone": sum_s, "fd": fd,
           "runs": [{k: v for k, v in r.items() if k != "grads"} for r in runs]}
    for k, r in enumerate(rec["runs"]):
        print(f"  grad {tag} pass {k}: forward {r['forward_s']:.3f} s ({fwd_iters} CG iterations), backward "
              f"{r['backward_s']:.3f} s ({r['adjoint_iters']} adjoint iterations), peak {r['peak_mem_bytes']}",
              flush=True)
    print(f"  grad {tag} backward parts alone: adjoint CG {adj_s:.3f} s, vjp {vjp_s:.3f} s, nodal sum "
          f"{sum_s:.4f} s", flush=True)
    return rec


def grad_plate_phase(gates, device="cuda", n=GRAD_PLATE):
    """12(a), last part: the compliance gradients of the n x n Test-G quad
    plate on ``device`` against the port's own on the CPU, within
    GRAD_CPU_GATE of each gradient's max."""
    from fem_shell_tpu_torch import Material, ShellSystem

    mesh, rows, fac = plate("q", n)
    mat = Material(0.3, 1e7, 0.5)
    out = {}
    for dev in ("cpu", device):
        s = ShellSystem(mesh, mat, device=dev)
        _, gc, gf, _ = compliance_grads(s, s.coords, torch.as_tensor(rows * fac, device=dev))
        out[dev] = (gc.cpu(), gf.cpu())
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(out[device], out["cpu"])]
    gates.check(max(errs) <= GRAD_CPU_GATE, f"grad q{n}: {device} - CPU gradients, coords {errs[0]:.2e}, "
                                            f"forces {errs[1]:.2e} <= {GRAD_CPU_GATE:.0e} of their max")
    return {"n": n, "rel_err_coords": errs[0], "rel_err_forces": errs[1]}


def f32_solves(et, n, device, reps=1):
    """Each f32 route of 12(b) on the n x n Test-G plate: name -> (centre w
    of each call as f64, iterations, relative residual, seconds per call,
    launches of the last call, the last solution). The f64 reference is
    MultigridShellSystem(mesh, mat).solve(rtol=1e-10)."""
    from fem_shell_tpu_torch import Material, MultigridShellSystem, ShellSystem
    from fem_shell_tpu_torch.large import LargeShellSystem

    mesh, rows, fac = plate(et, n)
    forces = rows * fac
    mat = Material(0.3, 1e7, 0.5)
    cuda = torch.device(device).type == "cuda"
    c = mesh.n_nodes // 2
    ref = float(MultigridShellSystem(mesh, mat, device=device).solve(forces, rtol=1e-10)[c, 2])
    shell = ShellSystem(mesh, mat, dtype=torch.float32, device=device)
    large = LargeShellSystem(mesh, mat, dtype=torch.float32, device=device)
    mg = MultigridShellSystem(mesh, mat, dtype=torch.float32, device=device)

    def cg(s):
        return int(s.last_cg.iters), float(s.last_cg.residual)

    def df(s):
        return int(s.last_iters), float(s.last_residual)

    routes = {
        "ShellSystem.solve": (lambda: shell.solve(forces, rtol=F32_RTOL, maxiter=20000), shell, cg, F32_RTOL),
        "LargeShellSystem.solve": (lambda: large.solve(forces, rtol=F32_RTOL, maxiter=20000), large, cg, F32_RTOL),
        "LargeShellSystem.solve_df": (lambda: large.solve_df(forces, rtol=F32_DF_RTOL, maxiter=20000), large, df,
                                      F32_DF_RTOL),
        "MultigridShellSystem.solve": (lambda: mg.solve(forces, rtol=F32_RTOL), mg, cg, F32_RTOL),
        "MultigridShellSystem.solve_df": (lambda: mg.solve_df(forces, rtol=F32_DF_RTOL), mg, df, F32_DF_RTOL),
    }
    out = {"ref": ref, "n_levels": mg.n_levels, "routes": {}}
    for name, (call, s, stats, rtol) in routes.items():
        us, secs = [], []
        for _ in range(1 + reps):
            reset_launches()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            u = call()
            if cuda:
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            us.append(u)
        it, res = stats(s)
        out["routes"][name] = {"centres": [float(u[c, 2]) for u in us], "iters": it, "residual": res,
                               "rtol": rtol, "seconds": secs, "launches": read_launches(),
                               "bitwise_repeat": all(torch.equal(us[0], u) for u in us[1:])}
    return out


def f32_cpu_reference(n=F32_N, device="cpu"):
    """Each 12(b) route's (centre, iterations) on ``device`` (the constants
    F32_CPU come from the CPU)."""
    out = {}
    for et in ("q", "t"):
        run = f32_solves(et, n, device, reps=0)
        for name, r in run["routes"].items():
            out[f"{name} {et}"] = (r["centres"][0], r["iters"])
    return out


def f32_scaling_check(gates, et, n=F32_N, device="cuda", cg=False):
    """12(b), the scaling of the f32 solve_df: the card's f32 operator (the
    cast of its f64 assembly) against the CPU's, entries that differ
    counted; s = rsqrt(diag) of LargeShellSystem._scaled on the card equal
    bit for bit to s taken on the CPU from the card's diagonal (f64 rsqrt
    rounded once); the share of entries where each device's f32
    torch.rsqrt misses that s. With ``cg``, the f64 CG over the operator
    scaled by each device's f32 rsqrt, on the card and on the CPU:
    iterations and centre of each (the question whether the f32 rsqrt alone
    moved the card's iteration count)."""
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.soa import soa_diagonal

    mesh, rows, fac = plate(et, n)
    forces = rows * fac
    mat = Material(0.3, 1e7, 0.5)
    systems = {"card": LargeShellSystem(mesh, mat, dtype=torch.float32, device=device),
               "cpu": LargeShellSystem(mesh, mat, dtype=torch.float32, device="cpu")}
    values = {k: sys_.assemble() for k, sys_ in systems.items()}
    card = systems["card"]
    diag = soa_diagonal(values["card"], offsets=card.offsets)
    _, s_card = card._scaled()
    d = diag.cpu()
    s_ref = torch.where(d > 0, torch.rsqrt(d.double()).float(), torch.ones_like(d))
    rsqrt32 = {"card": torch.where(diag > 0, torch.rsqrt(diag), torch.ones_like(diag)).cpu(),
               "cpu": torch.where(d > 0, torch.rsqrt(d), torch.ones_like(d))}
    tag = f"f32 {et}{n} solve_df scaling"
    same = torch.equal(s_card.cpu(), s_ref)
    gates.check(same, f"{tag}: s on {device} equal bit for bit to s from the same diagonal on the CPU")
    rec = {"case": tag, "entries": int(d.numel()), "s_equal": same,
           "operator_entries_differing": int((values["card"].cpu() != values["cpu"]).sum()),
           "diag_entries_differing": int((d != soa_diagonal(values["cpu"], offsets=card.offsets)).sum()),
           "f32_rsqrt_missing_s": {k: int((v != s_ref).sum()) for k, v in rsqrt32.items()},
           "f32_rsqrt_card_vs_cpu": int((rsqrt32["card"] != rsqrt32["cpu"]).sum())}
    if cg:
        c = mesh.n_nodes // 2
        rec["cg"] = {}
        for dev_name, sys_ in systems.items():
            for s_name, s32 in list(rsqrt32.items()) + [("rounded_once", s_ref)]:
                s32 = s32.to(sys_.device)
                b = sys_._forces_in(forces) * s32.double()
                res = sys_._cg_identity(sys_._scale(values[dev_name], s32), b, F32_DF_RTOL, 20000)
                u = sys_._solution_out(res.x * s32.double())
                rec["cg"][f"{dev_name} CG, {s_name} s"] = {"iters": int(res.iters), "centre": float(u[c, 2])}
    print(f"  {tag}: {rec}", flush=True)
    return rec


def f32_phase(gates, et, n=F32_N, device="cuda"):
    """12(b): the f32 routes on the n x n Test-G plate (f32_solves), each
    called twice: the CG reaches its rtol, two calls equal bit for bit, the
    centre and the iteration count against the same route on the CPU
    (F32_CPU: the centre within F32_CENTRE_SPREAD of the CPU's departure
    from the f64 centre, the count within F32_ITER_SPREAD plus 2), the
    launches as the code predicts them: stencil_spmv<float> once per CG
    iteration of LargeShellSystem.solve, stencil_spmv_f32v once per
    iteration of each solve_df, and in the multigrid routes 7
    stencil_spmv<float> per non-coarsest level and V-cycle application
    (one before the CG loop and one per iteration), plus one per iteration
    of MultigridShellSystem.solve's f32 CG; elem_stiffness once per
    ShellSystem solve. Records seconds per solve,
    ms per iteration and the departures."""
    cuda = torch.device(device).type == "cuda"
    run = f32_solves(et, n, device)
    ref, lv = run["ref"], run["n_levels"] - 1
    recs = []
    for name, r in run["routes"].items():
        it, got = r["iters"], r["launches"]
        w = r["centres"][0]
        dep = abs(w - ref) / abs(ref)
        w_cpu, it_cpu = F32_CPU[f"{name} {et}"]
        cpu_dep = abs(w_cpu - ref) / abs(ref)
        spread = abs(w - w_cpu) / abs(w_cpu - ref)
        tag = f"f32 {et}{n} {name}"
        gates.check(r["residual"] <= r["rtol"], f"{tag}: {it} iterations to residual {r['residual']:.2e} "
                                                f"<= {r['rtol']:.0e}")
        gates.check(r["bitwise_repeat"], f"{tag}: two calls equal bit for bit")
        gates.check(spread <= F32_CENTRE_SPREAD, f"{tag}: centre {w:.10f} against the CPU's {w_cpu:.10f}: "
                                                 f"{spread:.3e} of the CPU's departure {cpu_dep:.3e} from the "
                                                 f"f64 centre <= {F32_CENTRE_SPREAD}")
        gates.check(abs(it - it_cpu) <= F32_ITER_SPREAD * it_cpu + 2,
                    f"{tag}: {it} iterations against the CPU's {it_cpu} (within {F32_ITER_SPREAD:.0%} + 2)")
        if "MultigridShellSystem" in name:
            want = {"spmv_f32": 7 * lv * (it + 1) + (it if name.endswith(".solve") else 0),
                    "spmv_f32v": it if name.endswith("solve_df") else 0}
        elif "LargeShellSystem" in name:
            want = {"spmv_f32": it if name.endswith(".solve") else 0, "spmv_f32v": it if name.endswith("solve_df")
                    else 0}
        else:
            want = {"spmv_f32": 0, "spmv_f32v": 0, f"elem{4 if et == 'q' else 3}": 1}
        if cuda:
            gates.check(all(got[k] == v for k, v in want.items()),
                        f"{tag}: launches { {k: got[k] for k in want} } == {want}")
        secs = min(r["seconds"])
        rec = {"case": tag, "route": name, "iters": it, "cpu_iters": it_cpu, "residual": r["residual"],
               "seconds": r["seconds"], "ms_per_iteration": 1e3 * secs / max(it, 1), "centre": w, "cpu_centre": w_cpu,
               "departure": dep, "cpu_departure": cpu_dep, "centre_spread": spread, "launches": got}
        print(f"  {tag}: {it} iterations (CPU {it_cpu}), {secs:.3f} s ({rec['ms_per_iteration']:.3f} ms per "
              f"iteration), centre departure {dep:.3e} (CPU {cpu_dep:.3e}, card - CPU {spread:.2e} of it), "
              f"launches {got}", flush=True)
        recs.append(rec)
    return recs


def f32_cli_phase(gates, n=F32_N, device="cuda"):
    """12(b), the solver CLI's --f32 routes in subprocesses on the card (the
    three at once), on
    an n x n Test-G quad plate written by the port's meshgen (the default
    route, --precond mg, --precond mg --df): exit 0, the printed residual
    at most the rtol, and the .vtu displacements equal to the library
    solve of the same files."""
    import os
    import shutil

    from fem_shell_tpu_torch import Material, MultigridShellSystem, ShellSystem
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces

    work = OUT_DIR / "cli_f32"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = str(work / "plateG")
    gen = subprocess.run([sys.executable, "-m", "fem_shell_tpu_torch.meshgen"]
                         + f"q {n} {n} 0 0 10 10 0,0,0,0 300 2 1 z".split() + [base],
                         cwd=work, env=env, capture_output=True, text=True, timeout=600)
    gates.check(gen.returncode == 0, f"cli --f32: meshgen exit {gen.returncode}")
    mesh, forces = load_mesh_and_forces(base + ".xda")
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    shell = ShellSystem(mesh, mat, dtype=torch.float32, device=device)
    mg = MultigridShellSystem(mesh, mat, dtype=torch.float32, device=device)
    recs = []
    routes = (("--f32", [], F32_RTOL, lambda: shell.solve(forces, rtol=F32_RTOL, maxiter=20000)),
              ("--f32 --precond mg", ["--precond", "mg"], F32_RTOL, lambda: mg.solve(forces, rtol=F32_RTOL,
                                                                                     maxiter=20000)),
              ("--f32 --precond mg --df", ["--precond", "mg", "--df"], F32_DF_RTOL,
               lambda: mg.solve_df(forces, rtol=F32_DF_RTOL, maxiter=20000)))

    def out_base_of(flags):
        return base + "_".join([""] + [f.strip("-") for f in flags])

    clis = run_concurrently({name: ["fem_shell_tpu_torch.utils.cli", "-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh",
                                    base + ".xda", "-out", out_base_of(flags), "--f32", "--rtol", str(rtol),
                                    "--maxiter", "20000"] + flags + ([] if device == "cuda" else ["--device", device])
                             for name, flags, rtol, _ in routes}, work, env)
    libs = {name: lib().cpu().numpy() for name, _, _, lib in routes}
    done = clis.wait()
    for name, flags, rtol, _ in routes:
        out_base = out_base_of(flags)
        res, secs = done[name]
        ok = res.returncode == 0 and os.path.exists(out_base + ".vtu")
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("Linear solve:")]
        resid = float(line[0].split()[-1]) if line else float("inf")
        gates.check(ok and resid <= rtol, f"cli {name}: exit {res.returncode}, {line}")
        u = libs[name]
        diff = float(np.abs(vtu_displacement(out_base + ".vtu") - u[:, :3]).max()) if ok else float("inf")
        gates.check(diff <= 1e-12 * float(np.abs(u[:, :3]).max()),
                    f"cli {name}: .vtu displacements - the library solve of the same files: max {diff:.3e}")
        print(f"  cli {name}: rc={res.returncode} {secs:.2f} s {line}", flush=True)
        recs.append({"route": name, "returncode": res.returncode, "seconds": secs, "line": line,
                     "max_abs_diff": diff, "stderr": res.stderr[-2000:]})
    return recs


def f32_tower_phase(gates, device="cuda", steps=TOWER_STEPS):
    """12(c): run_structure(dtype=float32) on the tower demo (in-process
    dummy fluid), ``steps`` steps to rtol F32_TOWER_RTOL, once on the CPU
    and once on ``device``: the same coupling iterations in every step and
    every step's solution within F32_TOWER_GATE of max|u| of the CPU run;
    one elem_stiffness<3> launch per run; s per run and CG iterations."""
    import threading

    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.coupling.adapter import run_structure
    from fem_shell_tpu_torch.coupling.demo import CONFIG, tower_mesh
    from fem_shell_tpu_torch.coupling.fluid_dummy import run_fluid
    from fem_shell_tpu_torch.coupling.m2n import InProcessTransport

    nu, em, t = TOWER_MATERIAL
    runs = {}
    for dev in ("cpu", device):
        ts, tf = InProcessTransport.pair()
        fluid = threading.Thread(target=run_fluid, args=(CONFIG,), kwargs={"transport": tf, "max_timesteps": steps},
                                 daemon=True)
        reset_launches()
        fluid.start()
        t0 = time.perf_counter()
        res = run_structure(tower_mesh(), Material(nu=nu, em=em, thickness=t), CONFIG, dt=0.01, dead_axis="y",
                            transport=ts, rtol=F32_TOWER_RTOL, max_timesteps=steps, dtype=torch.float32, device=dev)
        wall = time.perf_counter() - t0
        fluid.join(timeout=PEER_TIMEOUT_S)
        gates.check(not fluid.is_alive() and res.timesteps == steps,
                    f"f32 tower on {dev}: {res.timesteps} of {steps} steps, the fluid finished")
        runs[dev] = (res, coupled_stats(res, wall), read_launches())
    (cpu, cpu_rec, _), (card, card_rec, launches) = runs["cpu"], runs[device]
    scale = float(np.abs(cpu.solutions).max())
    same = card.solutions.shape == cpu.solutions.shape
    diff = float(np.abs(card.solutions - cpu.solutions).max()) if same else float("inf")
    gates.check(card.step_iterations == cpu.step_iterations,
                f"f32 tower: coupling iterations per step on {device} == the CPU's ({sum(cpu.step_iterations)})")
    gates.check(diff <= F32_TOWER_GATE * scale and card.solutions.dtype == np.float64,
                f"f32 tower: {device} - CPU solutions max {diff:.3e} <= {F32_TOWER_GATE:.0e} * {scale:.4e} (f64 "
                f"on the host)")
    if torch.device(device).type == "cuda":
        gates.check(launches["elem3"] == 1, f"f32 tower: elem_stiffness<3> launched {launches['elem3']} time(s) (1)")
    for dev, (_, rec, _) in runs.items():
        print(f"  f32 tower {dev}: {rec['wall_s']:.3f} s, {rec['coupling_iterations']} coupling iterations, "
              f"{rec['cg_iterations_per_solve']:.1f} CG iterations per solve at {rec['ms_per_cg_iteration']:.4f} ms",
              flush=True)
    return {"cpu": cpu_rec, "card": card_rec, "launches": launches, "max_abs_diff_cpu": diff, "scale": scale}


def phase12(gates, device="cuda", split=TOWER_SPLIT, n=F32_N):
    """Phase 12 in order, with each part's seconds."""
    out, laps, t0 = {}, {}, time.perf_counter()

    def lap(key):
        nonlocal t0
        laps[key] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out["grad"] = grad_phase(gates, device=device, split=split)
    out["grad_plate"] = grad_plate_phase(gates, device=device)
    lap("a")
    out["f32"] = [rec for et in ("q", "t") for rec in f32_phase(gates, et, n, device=device)]
    out["f32_scaling"] = [f32_scaling_check(gates, et, n, device=device) for et in ("q", "t")]
    out["f32_cli"] = f32_cli_phase(gates, n, device=device)
    lap("b")
    out["f32_tower"] = f32_tower_phase(gates, device=device)
    lap("c")
    out["phase12_s"] = laps
    print(f"  phase12_s={sum(laps.values()):.1f} {laps}", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 13: the sharded solvers
# ----------------------------------------------------------------------
# 13(a): each card dry-run answer against the CPU ranks' (of max|u|), and
# the iteration spread; path 4's preconditioner is the f32 V-cycle. Path
# 2's Jacobi-PCG stops at rtol 1e-6 on the strip: the card's answer (the
# element kernel's operator, the stencil kernel's sums) lay 5.73e-9 of
# max|u| from the CPU's at equal iterations (H100, two ranks on one card), the
# CG's amplification of last-bit differences at a loose stop, so its
# bound is 1e-8; "2t", the same strip solved to rtol 1e-10 (3.3e-13
# between one and two CPU ranks), is held to 1e-9. Path 2's strip is 16 x
# ranks elements long: a run on another rank count than the CPU's two has
# another mesh there, and is compared on the other paths only.
# Paths 5 and 5b (the 2-D process grid, Jacobi-PCG to rtol 1e-10 and
# 1e-9) are held as "2t" is, at 1e-9: both stop at a tight rtol, where two
# summation orders agree to the CG's precision; path 6 (the f64 CG
# preconditioned by the f32 V-cycle, the design of path 4) as path 4.
DRYRUN_U_GATE = {"1": 1e-9, "2": 1e-8, "2t": 1e-9, "3": 1e-9, "4": 1e-6, "5": 1e-9, "5b": 1e-9, "6": 1e-6,
                 "7": 1e-9}
DRYRUN_ITER_GATE = {"1": 1, "2": 1, "2t": 1, "3": 1, "4": 2, "5": 1, "5b": 1, "6": 2, "7": 1}
# 13(d): the 2-D process grid, GRID2D_SHAPE ranks over gloo sharing the
# card: Test-G GRID2D_SMALL^2 converged, and the 1024^2 plate over
# GRID2D_ITERS CG iterations (Jacobi needs O(n^2) of them to converge)
GRID2D_SHAPE = (2, 2)
GRID2D_SMALL = 64
GRID2D_ITERS = 50
# 13(e): peak device bytes per rank of GridShardedDFShellSystem(prec="mg")
# at 1024^2 on two ranks, at most ShardedMGDFShellSystem's as PERF.md
# first recorded it
GRID_ASM_PEAK = 4.82e9
DRYRUN_STRIP = ("2", "2t")
DRYRUN_CPU_RANKS = 2
# 13(b): Test-G quad at full width through the solver CLI --devices 2
SHARD_N = 1024
# 13(c): run_structure(devices=2) against devices=1 on the tower demo's
# first SHARD_TOWER_STEPS steps, of max|u| (4.2e-13 measured on the CPU
# over 30 steps: Jacobi PCG on the ranks against block-Jacobi on one
# device, both to rtol 1e-10; tests/test_torch_parallel_entry.py holds
# the CPU to the same bound)
SHARD_TOWER_GATE = 1e-10
SHARD_TOWER_STEPS = 5


def gpu_counts():
    """(torch.cuda.device_count(), the GPUs nvidia-smi -L lists)."""
    listed = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60).stdout
    return torch.cuda.device_count(), sum(1 for ln in listed.splitlines() if ln.startswith("GPU "))


def start_dryrun(n, device="cpu", backend="gloo", repeat=()):
    """parallel/dryrun.py on ``n`` ranks in a background process (CPU ranks
    one thread each), its results saved to chiprun_out; ``collect_dryrun``
    waits for it."""
    import os

    OUT_DIR.mkdir(exist_ok=True)  # a run may end before any phase has made it
    path = OUT_DIR / f"dryrun_{device}_{backend}x{n}.npz"
    path.unlink(missing_ok=True)
    proc = subprocess.Popen([sys.executable, "-m", "fem_shell_tpu_torch.parallel.dryrun", str(n), "--device", device,
                             "--backend", backend, "--save", str(path), "--repeat", ",".join(repeat)], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BACKGROUND.append(proc)
    return proc, path, time.perf_counter(), f"{n} {backend} rank(s) on {device}"


def start_cpu_dryrun():
    """The dry run on two gloo ranks on the host's cores, started at the
    script's start so that it runs beside the card-bound phases."""
    return start_dryrun(DRYRUN_CPU_RANKS)


def collect_dryrun(gates, started, timeout=600):
    """Wait for a background dry run: its gate, its last lines, and its
    results {path: {"u", ...}} with the ranks' launches under
    "launches" (None when it failed)."""
    proc, path, t0, what = started
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
    secs = time.perf_counter() - t0
    ok = proc.returncode == 0 and path.exists()
    gates.check(ok, f"13(a) dry run, {what}, in the background: exit {proc.returncode} ({secs:.1f} s since "
                    "its start)")
    tag = what.split(" rank")[0].replace(" ", "x")
    for line in log.strip().splitlines()[-11:]:
        print(f"    {tag} | {line}", flush=True)
    if not ok:
        return None, secs
    data = np.load(path)
    meta = json.loads(str(data["meta"]))
    out = {k: dict(v, u=data[f"u{k}"]) for k, v in meta.items() if k != "launches"}
    out["launches"] = meta["launches"]
    return out, secs


def dryrun_phase(gates, cpu_started, count, device="cuda"):
    """13(a): parallel/dryrun paths 1-7 over gloo with two ranks on
    the card, over NCCL with min(count, 4) ranks (and two, where there are
    more than two GPUs) in background processes beside it, over gloo at
    that count too, and the CPU ranks' run: every dry-run assert, card
    against CPU, a second solve bit for bit (every path on NCCL; on gloo
    paths 1-6, where path 7's 5,817 host-staged iterations would take
    another ~20 s), gloo against NCCL at equal rank counts bit for bit.
    The background runs' rank launches join comm.RANK_LAUNCHES."""
    from fem_shell_tpu_torch.parallel import comm as pcomm
    from fem_shell_tpu_torch.parallel.dryrun import dryrun

    runs = {}
    n_nccl = min(count, 4) if device == "cuda" else 0
    nccl_counts = sorted({n_nccl, 2} if n_nccl > 2 else ({n_nccl} if n_nccl else set()))
    background = {f"ncclx{n}": start_dryrun(n, device=device, backend="nccl", repeat=tuple(DRYRUN_U_GATE))
                  for n in nccl_counts}
    for n in [2] + [n for n in nccl_counts if n > 2]:
        tag = f"gloox{n}"
        t0 = time.perf_counter()
        try:
            runs[tag] = dryrun(n, device=device, backend="gloo", repeat=("1", "2", "3", "4", "5", "5b", "6"))
            ok, why = True, ""
        except (AssertionError, RuntimeError) as exc:
            ok, why = False, f": {exc}"
        secs = time.perf_counter() - t0
        gates.check(ok, f"13(a) dry run, {n} gloo rank(s) on {device} ({secs:.1f} s){why}")
        if ok:
            runs[tag]["seconds"] = secs
    for tag, started in background.items():
        res, secs = collect_dryrun(gates, started)
        if res is not None:
            for rank_counts in res["launches"]:
                for k, v in rank_counts.items():
                    pcomm.RANK_LAUNCHES[k] += v
            runs[tag] = dict(res, seconds=secs)
    cpu, cpu_s = collect_dryrun(gates, cpu_started)
    rows = []
    for tag, res in runs.items():
        n = int(tag.split("x")[1])
        for p in DRYRUN_U_GATE:
            r = res[p]
            if "repeat_equal" in r:
                gates.check(r["repeat_equal"], f"13(a) {tag} path {p}: a second solve bitwise equal")
            row = {"run": tag, "path": p, "iters": r["iters"], "residual": r["residual"], "seconds": r["seconds"]}
            if cpu is not None and (p not in DRYRUN_STRIP or n == DRYRUN_CPU_RANKS):
                c = cpu[p]
                err = float(np.abs(r["u"] - c["u"]).max()) / float(np.abs(c["u"]).max())
                d_it = abs(int(r["iters"]) - int(c["iters"]))
                gates.check(err <= DRYRUN_U_GATE[p] and d_it <= DRYRUN_ITER_GATE[p],
                            f"13(a) {tag} path {p}: {err:.2e} of max|u| from the CPU ranks' (<= "
                            f"{DRYRUN_U_GATE[p]:.0e}), {r['iters']} vs {c['iters']} iterations "
                            f"(+-{DRYRUN_ITER_GATE[p]})")
                row.update(rel_err_cpu=err, cpu_iters=c["iters"])
            rows.append(row)
    compared = []
    for tag, res in runs.items():  # gloo against NCCL where both ran the same rank count
        backend, n = tag.split("x")
        other = f"ncclx{n}"
        if backend == "gloo" and other in runs:
            same = all(np.array_equal(res[p]["u"], runs[other][p]["u"]) for p in DRYRUN_U_GATE)
            gates.check(same, f"13(a) gloo and nccl on {n} ranks: every path bit for bit")
            compared.append(int(n))
    if not compared:
        print(f"  13(a) gloo against nccl not compared: nccl ran {n_nccl} rank(s) on {count} GPU(s); nccl with "
              "two or more ranks did not run", flush=True)
    for row in rows:
        print(f"  13(a) {row}", flush=True)
    launches = {tag: res["launches"] for tag, res in runs.items()}
    return {"runs": rows, "launches": launches, "cpu_s": cpu_s, "gloo_vs_nccl_bitwise_at": compared,
            "cpu": {p: {k: v for k, v in r.items() if k != "u"} for p, r in (cpu or {}).items() if p != "launches"}}


def halo_bytes(system, itemsize):
    """Bytes one rank sends per ring halo exchange of a strip system: [6,
    Wp] each way."""
    return 2 * 6 * system.w_pad * itemsize


def mg_iteration_bytes(mg, cg_itemsize):
    """(halo bytes, psum bytes) one rank sends per CG iteration of a sharded
    multigrid solve: the fine matvec's exchange in the CG's dtype, then per
    sharded level 2 nu + 1 exchanges in the levels' dtype (smoothing and
    residual) and the psum of the coarse level's full vector (and, onto a
    sharded coarse level, of the correction), all-gathered to S - 1 peers."""
    s = mg.n_shards
    item = 8 if mg.dtype == torch.float64 else 4
    halo = halo_bytes(mg.levels[0].sys, cg_itemsize)
    psum = 0
    for li in range(mg.n_sharded):
        lvl, nxt = mg.levels[li], mg.levels[li + 1]
        halo += (2 * mg.nu_smooth + 1) * halo_bytes(lvl.sys, item)
        n_full = getattr(nxt, "n_full", None) or nxt.npad
        psum += (s - 1) * 6 * n_full * item * (2 if hasattr(nxt, "n_full") else 1)
    return halo, psum


def start_shard_meshgen(n=SHARD_N):
    """13(b)'s Test-G quad n x n written by the port's meshgen CLI, in a
    background process (started beside 13(a)); returns (handle, work
    directory, file base)."""
    import os
    import shutil

    work = OUT_DIR / "shard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = str(work / "plateG")
    gen = run_concurrently({"meshgen": ["fem_shell_tpu_torch.meshgen"]
                            + f"q {n} {n} 0 0 10 10 0,0,0,0 300 2 1 z".split() + [base]}, work,
                           dict(os.environ, PYTHONPATH=str(ROOT)))
    return gen, work, base


def shard_scale_phase(gates, count, n=SHARD_N, device="cuda", meshgen=None, big=None):
    """13(b): Test-G quad n x n through the solver CLI --devices 2 --precond
    mg --backend gloo (and nccl with two GPUs), then on two gloo ranks in
    this process the CLI's system (ShardedMGShellSystem, f64) and
    ShardedMGDFShellSystem.solve_df(rtol=1e-9), each against the analytic
    centre, the single-device f64 MultigridShellSystem.solve and the true
    residual on the single-device operator. The true residual of an f64
    iterate has a floor ~eps || |A| |u| || (~n^4: 8.5e-11 of ||b|| at
    64^2, 1.36e-9 at 128^2), so it is computed compensated
    (stencil_resid_dd) and held to max(1e-9, twice the single-device f64
    solve's at rtol 1e-10), beside the normwise backward error. With
    ``big`` (a dict), 13(e) runs on the same ranks and leaves its plate
    and forces in ``big`` for 13(d)."""
    import os
    import re
    import shutil

    from fem_shell_tpu_torch import Material, MultigridShellSystem
    from fem_shell_tpu_torch.mesh import load_mesh_and_forces
    from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv
    from fem_shell_tpu_torch.parallel import comm as pcomm
    from fem_shell_tpu_torch.parallel.df_shard import ShardedMGDFShellSystem
    from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem
    from fem_shell_tpu_torch.parallel.sharded import make_device_mesh
    from fem_shell_tpu_torch.parallel.stencil_shard import check_spmv_rank

    rec = {"n": n, "dofs": 6 * (n + 1) ** 2}
    if meshgen is None:
        meshgen = start_shard_meshgen(n)
    gen, work, base = meshgen
    res, rec["meshgen_s"] = gen.wait()["meshgen"]
    gates.check(res.returncode == 0, f"13(b) meshgen q {n} {n}: exit {res.returncode} ({rec['meshgen_s']:.1f} s)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    # the CLI runs (gloo, and nccl with two GPUs) start here and are read
    # after the single-device reference, which runs beside their start
    clis = run_concurrently(
        {backend: ["fem_shell_tpu_torch.utils.cli", "-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh", base + ".xda",
                   "--devices", "2", "--precond", "mg", "--backend", backend, "--device", device]
         for backend in ["gloo"] + (["nccl"] if count >= 2 and device == "cuda" else [])}, work, env)

    mesh, forces = load_mesh_and_forces(base + ".xda")
    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    centre = mesh.n_nodes // 2
    t0 = time.perf_counter()
    mg1 = MultigridShellSystem(mesh, mat, device=device)
    u1 = mg1.solve(forces, rtol=1e-10, maxiter=2000)
    if device == "cuda":
        torch.cuda.synchronize()
    rec["single_s"] = time.perf_counter() - t0
    w1 = float(u1[centre, 2])
    fine = mg1.levels[0]
    b = mg1._staged_forces(forces) * fine.free_t
    b_norm = float(torch.linalg.vector_norm(b))

    def true_res(u):
        """(||b - A u|| / ||b||, ||b - A u|| / || |A| |u| ||), the residual
        compensated."""
        x = torch.zeros_like(b)
        x[:, : mesh.n_nodes] = torch.as_tensor(u, dtype=torch.float64, device=b.device).T
        rn = float(torch.linalg.vector_norm(stencil_resid_dd(fine.values, x, b, fine.offsets)))
        scale = float(torch.linalg.vector_norm(stencil_spmv(fine.values.abs(), x.abs(), fine.offsets)))
        return rn / b_norm, rn / scale

    tr1, be1 = true_res(u1.cpu().numpy())
    gate_tr = max(1e-9, 2 * tr1)
    rec["single"] = {"iters": int(mg1.last_cg.iters), "centre_w": w1, "true_residual": tr1,
                     "backward_error": be1, "true_residual_gate": gate_tr}
    print(f"  13(b) single-device MultigridShellSystem.solve {n}^2: {rec['single']} ({rec['single_s']:.1f} s)",
          flush=True)
    del u1
    dm = make_device_mesh(2, device=device, backend="gloo")  # its ranks start beside the CLI's
    cli_runs = []
    for backend, (res, secs) in clis.wait().items():
        m = re.search(r"Linear solve: (\d+) CG iterations, relative residual (\S+)", res.stdout)
        it, r = (int(m.group(1)), float(m.group(2))) if m else (None, float("nan"))
        gates.check(res.returncode == 0 and m is not None and it < 40 and r <= 1e-10,
                    f"13(b) cli --devices 2 --precond mg --backend {backend}: exit {res.returncode}, {it} "
                    f"iterations < 40, residual {r:.2e} <= 1e-10 ({secs:.1f} s)")
        cli_runs.append({"backend": backend, "returncode": res.returncode, "iters": it, "residual": r,
                         "seconds": secs, "stdout": res.stdout.strip().splitlines()[-4:],
                         "stderr": res.stderr[-2000:]})
        print(f"  13(b) cli {backend}: {cli_runs[-1]['stdout']}", flush=True)
    rec["cli"] = cli_runs
    with dm:
        runs = []
        for kind in ("ShardedMGShellSystem f64", "ShardedMGDFShellSystem solve_df"):
            dm.run(pcomm.peak_memory, [True] * dm.size)
            dm.reset_launches()
            t0 = time.perf_counter()
            if kind.startswith("ShardedMGShellSystem"):
                system = ShardedMGShellSystem(mesh, mat, dm, dtype=torch.float64)
                solve, rtol = system.solve, 1e-10
            else:
                system = ShardedMGDFShellSystem(mesh, mat, dm)
                solve, rtol = system.solve_df, 1e-9
            build_s = time.perf_counter() - t0
            build_launches = [dict(c) for c in dm.launches]
            dm.reset_launches()
            t0 = time.perf_counter()
            u = solve(forces, rtol=rtol, maxiter=300)
            times = [time.perf_counter() - t0]
            it, res = system.last_iters, system.last_residual
            solve_launches = [dict(c) for c in dm.launches]
            peaks = dm.run(pcomm.peak_memory, [False] * dm.size)
            w = float(u[centre, 2])
            tr, be = true_res(u)
            gate_res = max(gate_tr, 2 * rtol)
            mg = system if kind.startswith("ShardedMGShellSystem") else system.mg
            halo_b, psum_b = mg_iteration_bytes(mg, 8)
            gates.check(abs(w - KIRCHHOFF) < 1e-3 and abs(w - w1) <= 1e-6 * abs(w1),
                        f"13(b) {kind} {n}^2 on 2 gloo ranks: centre {w:.9f} within 1e-3 of {KIRCHHOFF} and "
                        f"{abs(w - w1) / abs(w1):.2e} <= 1e-6 of the single-device solve's {w1:.9f}")
            gates.check(tr <= gate_res and it < 40 and res <= rtol,
                        f"13(b) {kind}: true residual {tr:.2e} <= {gate_res:.2e} (single-device operator, "
                        f"compensated; backward error {be:.2e}), {it} iterations < 40, CG residual {res:.2e} <= "
                        f"{rtol:.0e}")
            row = {"system": kind, "build_s": build_s, "solve_s": times, "iters": it, "residual": res,
                   "s_per_iter": times[-1] / max(it, 1), "centre_w": w, "true_residual": tr,
                   "backward_error": be,
                   "levels": {"n_sharded": mg.n_sharded, "n_levels": mg.n_levels},
                   "halo_bytes_per_iter_per_rank": halo_b, "psum_bytes_per_iter_per_rank": psum_b,
                   "peak_bytes_per_rank": peaks, "build_launches_per_rank": build_launches,
                   "solve_launches_per_rank": solve_launches}
            # the per-rank product against its plain version, after the counts
            # are read; its launches are not the main path's
            counted = dict(pcomm.RANK_LAUNCHES)
            levels = [(f"fine {row['levels']}", mg.levels[0].sys.key)]
            if not kind.startswith("ShardedMGShellSystem"):
                levels.append(("fine f64", system.fine64.key))
            row["spmv_checks"] = []
            for what, key in levels:
                for r, chk in enumerate(dm.run(check_spmv_rank, [(key, 7, 20)] * dm.size)):
                    rel = chk["max_abs_err"] / chk["max_abs_y"]
                    gate = ERR_GATE[torch.float32 if "float32" in chk["dtype"] else torch.float64]
                    gates.check(rel <= gate, f"13(b) {kind} {what} rank {r}: stencil_spmv on the padded window "
                                             f"{chk['shape']} {chk['dtype']} vs matvec_plain {rel:.2e} <= {gate:.0e}")
                    row["spmv_checks"].append(dict(chk, rank=r, level=what))
            pcomm.RANK_LAUNCHES.update(counted)
            smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout.strip() if device == "cuda" else ""
            row["nvidia_smi_apps"] = smi
            runs.append(row)
            print(f"  13(b) {kind}: build_s={build_s:.2f} solve_s={['%.3f' % t for t in times]} iters={it} "
                  f"s/iter={row['s_per_iter'] * 1e3:.2f} ms w={w:.9f} true_res={tr:.2e} levels={row['levels']} "
                  f"halo_B/iter/rank={halo_b} psum_B/iter/rank={psum_b} peak/rank={peaks} "
                  f"launches/rank build={build_launches} solve={solve_launches} apps=[{smi}]", flush=True)
            del system, mg, u, solve  # the bound solve holds the system, and its ranks their state
        rec["runs"] = runs
        del mg1, fine, b
        if big is not None:  # 13(e) on these ranks; its plate is left for 13(d)
            t0 = time.perf_counter()
            rec["grid_sharded"], big["mesh"], big["forces"] = grid_sharded_phase(gates, dm, n=n, device=device)
            rec["grid_sharded_s"] = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)  # ~100 MB of mesh files
    return rec


def grid_sharded_phase(gates, dm, n=SHARD_N, device="cuda"):
    """13(e): GridShardedDFShellSystem(prec="mg") on (b)'s ranks: the
    operator from the sharded grid assembly (each rank's element rows, the
    fold row passed on), one solve_refined(rtol=1e-9) with the true
    residual from the class tables on this device. The plate is Test-G
    quad n^2 from meshgen.generate, not (b)'s .xda files: the class tables
    need a uniform grid, and the files' coordinates carry ~5e-6 of print
    rounding. Its references: the single-device f64
    MultigridShellSystem.solve, and the single-device class path
    (df_operator=True, solve_df_refined(rtol=1e-9)), which refines against
    the same class tables: the refined centre is held to the class path's
    (the f64-assembled operator's solution lies ~1e-5 from both at this
    size, its elements' f64 rounding amplified by the conditioning), the
    residual to the floor the class path reaches. Returns (record, mesh,
    forces)."""
    import gc
    import math

    from fem_shell_tpu_torch import Material, MultigridShellSystem
    from fem_shell_tpu_torch.ops.class_matvec import class_residual
    from fem_shell_tpu_torch.ops.class_stencil import class_stencil, class_stencil_plain
    from fem_shell_tpu_torch.parallel import comm as pcomm
    from fem_shell_tpu_torch.parallel.grid_asm_shard import GridShardedDFShellSystem, check_rowblock_rank
    from fem_shell_tpu_torch.parallel.stencil_shard import check_spmv_rank

    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    mesh, rows, fac = plate("q", n)
    forces = rows * fac
    centre = mesh.n_nodes // 2
    t0 = time.perf_counter()
    single = MultigridShellSystem(mesh, mat, device=device)
    u1 = single.solve(forces, rtol=1e-10, maxiter=2000)
    single_s = time.perf_counter() - t0
    w1 = float(u1[centre, 2])
    del single
    t0 = time.perf_counter()
    cls = MultigridShellSystem(mesh, mat, dtype=torch.float32, df_operator=True, smoother="chebyshev",
                               device=device)
    wc = float(cls.fetch_solution(cls.solve_df_refined(cls.stage_forces(forces), rtol=1e-9,
                                                       return_device=True))[centre, 2])
    class_ref = {"seconds": time.perf_counter() - t0, "centre_w": wc, "refine_history": list(cls.refine_history),
                 "inner_iters": list(cls.refine_inner_iters)}
    del cls
    gc.collect()  # the finalizers of (b)'s systems queue their ranks' state to be dropped
    dm.run(pcomm.peak_memory, [True] * dm.size)
    baseline = dm.run(pcomm.peak_memory, [True] * dm.size)  # what the ranks hold as (e) starts
    dm.reset_launches()
    t0 = time.perf_counter()
    gs = GridShardedDFShellSystem(mesh, mat, dm, prec="mg")
    build_s = time.perf_counter() - t0
    build_launches = [dict(c) for c in dm.launches]
    mgp = gs.mgp
    # elem_stiffness<4> per rank: one per grid strip of its rows (the fine
    # level, no scatter), one per chunk of its elements on each coarser
    # sharded level, one per chunk of each replicated level
    expected = [strips + sum(math.ceil(int((lvl.sys.quad_w[r] > 0).sum()) / lvl.sys.chunk)
                             for lvl in mgp.levels[1:mgp.n_sharded])
                + sum(math.ceil(len(lvl.mesh.quad) / mgp.chunk) for lvl in mgp.levels[mgp.n_sharded:])
                for r, strips in enumerate(gs.strips_per_rank())]
    gates.check([c["elem4"] for c in build_launches] == expected or device != "cuda",
                f"13(e) GridShardedDFShellSystem build: on the card elem_stiffness<4> launches per rank "
                f"{[c['elem4'] for c in build_launches]} == grid strips {gs.strips_per_rank()} + the coarser "
                f"levels' chunks = {expected} (no fine-level scatter)")
    dm.reset_launches()
    reset_launches()
    t0 = time.perf_counter()
    u = gs.solve_refined(forces, rtol=1e-9)
    solve_s = time.perf_counter() - t0
    ctrl = read_launches()
    solve_launches = [dict(c) for c in dm.launches]
    peaks = dm.run(pcomm.peak_memory, [False] * dm.size)
    inner, hist = list(gs.refine_inner_iters), list(gs.refine_history)
    w = float(u[centre, 2])
    # the class-table residual of the f64-assembled single-device solve,
    # for the record
    cdf = gs._class_parts()
    free = torch.as_tensor((~mesh.dirichlet_mask()).T, dtype=torch.float64, device=device)
    b = (torch.as_tensor(np.asarray(forces, np.float64).T, device=device) * free).contiguous()
    x1 = torch.as_tensor(u1, dtype=torch.float64, device=device).T.contiguous()
    floor = float(class_residual(cdf, x1, b)[1])
    gate_res = max(1e-9, 2 * class_ref["refine_history"][-1])
    gates.check(abs(w - KIRCHHOFF) < 1e-3 and abs(w - wc) <= 1e-6 * abs(wc),
                f"13(e) GridShardedDFShellSystem mg {mesh.n_nodes} nodes on 2 gloo ranks: centre {w:.9f} within "
                f"1e-3 of {KIRCHHOFF} and {abs(w - wc) / abs(wc):.2e} <= 1e-6 of the single-device class path's "
                f"{wc:.9f} ({abs(w - w1) / abs(w1):.2e} from the f64-assembled solve's {w1:.9f}, the class path "
                f"{abs(wc - w1) / abs(w1):.2e})")
    gates.check(max(inner) < 40 and bool(np.isfinite(hist).all()) and hist[-1] <= gate_res,
                f"13(e) solve_refined: inner iterations {inner} < 40 each, class-table true residual "
                f"{['%.2e' % h for h in hist]} <= max(1e-9, 2 x the single-device class path's final "
                f"{class_ref['refine_history'][-1]:.2e}) (the f64-assembled solve's: {floor:.2e})")
    gates.check((ctrl["class_f64"] == len(hist) and ctrl["class_f32"] == len(hist)) or device != "cuda",
                f"13(e) the residual on the card's class kernels: class_stencil<double> {ctrl['class_f64']} and "
                f"<float> {ctrl['class_f32']} == {len(hist)} passes")
    if device == "cuda":
        gates.check(all(p <= GRID_ASM_PEAK for p in peaks),
                    f"13(e) peak bytes per rank {peaks} <= {GRID_ASM_PEAK:.3g}")
    rec = {"single_s": single_s, "single_centre_w": w1, "class_path": class_ref, "baseline_bytes_per_rank": baseline,
           "build_s": build_s, "solve_s": solve_s,
           "inner_iters": inner, "refine_history": hist,
           "s_per_cg_iter": solve_s / max(sum(inner), 1), "centre_w": w, "rel_to_single": abs(w - w1) / abs(w1),
           "rel_to_class_path": abs(w - wc) / abs(wc),
           "single_class_residual": floor, "levels": {"n_sharded": mgp.n_sharded, "n_levels": mgp.n_levels},
           "row_starts": gs._row_starts, "strips_per_rank": gs.strips_per_rank(), "peak_bytes_per_rank": peaks,
           "build_launches_per_rank": build_launches, "solve_launches_per_rank": solve_launches,
           "controller_launches": {k: ctrl[k] for k in ("class_f32", "class_f64")}}
    # the checks against the plain versions and the single-device
    # operator, after the counts are read: their launches are not the
    # main path's
    counted = dict(pcomm.RANK_LAUNCHES)
    coords, free_t = np.asarray(mesh.coords), (~mesh.dirichlet_mask()).T.astype(np.float64)
    rows = dm.run(check_rowblock_rank, [(gs.sys.key, {"grid": gs.grid, "coords": coords, "free_t": free_t,
                                                       "mats": mat.matrices(), "thickness": mat.thickness,
                                                       "lane0": gs._row_starts[r] * gs.grid.nxp,
                                                       "owned": gs.blocks[r][2]})
                                        for r in range(dm.size)])
    for r, chk in enumerate(rows):
        gates.check(chk["off_fold"] == 0.0 and chk["on_fold"] <= 1e-14 * chk["max_abs"],
                    f"13(e) rank {r} rows against the single-device assemble_grid: {chk['off_fold']:.1e} off the "
                    f"fold row (bit for bit), {chk['on_fold'] / chk['max_abs']:.2e} of max|A| on it (<= 1e-14)")
    rec["rowblock_checks"] = rows
    rec["spmv_checks"] = []
    for what, key in (("fine f64", gs.sys.key), ("fine f32", mgp.levels[0].sys.key)):
        for r, chk in enumerate(dm.run(check_spmv_rank, [(key, 11, 20)] * dm.size)):
            rel = chk["max_abs_err"] / chk["max_abs_y"]
            gate = ERR_GATE[torch.float32 if "float32" in chk["dtype"] else torch.float64]
            gates.check(rel <= gate, f"13(e) {what} rank {r}: stencil_spmv on the padded window {chk['shape']} vs "
                                     f"matvec_plain {rel:.2e} <= {gate:.0e}")
            rec["spmv_checks"].append(dict(chk, rank=r, level=what))
    pcomm.RANK_LAUNCHES.update(counted)
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((6, cdf.npad), generator=g, dtype=torch.float64).to(device)
    rec["class_checks"] = []
    for what, table, xin in (("class_stencil<double> A64", cdf.a64, x), ("class_stencil<float> E", cdf.e,
                                                                       x.to(torch.float32))):
        y, yp = class_stencil(table, xin), class_stencil_plain(table, xin)
        rel = float((y - yp).abs().max()) / float(yp.abs().max())
        gate = ERR_GATE[xin.dtype]
        gates.check(rel <= gate, f"13(e) {what} on the {mesh.n_nodes}-node quad class tables vs its plain version "
                                 f"{rel:.2e} <= {gate:.0e}")
        rec["class_checks"].append({"what": what, "rel_err": rel})
    print(f"  13(e) GridShardedDFShellSystem mg: build_s={build_s:.2f} solve_s={solve_s:.2f} inner={inner} "
          f"s/CG iter={rec['s_per_cg_iter'] * 1e3:.1f} ms hist={['%.2e' % h for h in hist]} floor={floor:.2e} "
          f"w={w:.9f} class path {class_ref} peak/rank={peaks} (at the start {baseline}) launches/rank "
          f"build={build_launches} solve={solve_launches} controller={rec['controller_launches']}", flush=True)
    del gs, mgp, u, cdf, u1, x1
    return rec, mesh, forces


def grid2d_phase(gates, started, big, device="cuda"):
    """13(d): the 2-D process grid GRID2D_SHAPE on four gloo ranks sharing
    the card (``started``: the mesh of ranks, started beside (a)): Test-G
    quad GRID2D_SMALL^2 to rtol 1e-10 against the single-device f64
    multigrid solve, then (e)'s 1024^2 plate (``big``) over GRID2D_ITERS CG
    iterations, with each rank's tile product against the plain 9-slot
    loop."""
    import math

    from fem_shell_tpu_torch import Material, MultigridShellSystem
    from fem_shell_tpu_torch.ops.soa import _ceil_to
    from fem_shell_tpu_torch.parallel import comm as pcomm
    from fem_shell_tpu_torch.parallel.grid2d_shard import Sharded2DGridSystem, check_spmv_tile

    mat = Material(nu=0.3, em=1e7, thickness=0.5)
    t0 = time.perf_counter()
    dm = started.result()
    rec = {"shape": list(GRID2D_SHAPE), "mesh_wait_s": time.perf_counter() - t0}
    with dm:
        mesh, rows, fac = plate("q", GRID2D_SMALL)
        forces = rows * fac
        ref = MultigridShellSystem(mesh, mat, device=device).solve(forces, rtol=1e-10, maxiter=2000).cpu().numpy()
        t0 = time.perf_counter()
        system = Sharded2DGridSystem(mesh, mat, dm, dtype=torch.float64)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        u = system.solve(forces, rtol=1e-10, maxiter=20000)
        solve_s = time.perf_counter() - t0
        w = float(u[mesh.n_nodes // 2, 2])
        err = float(np.abs(u - ref).max()) / float(np.abs(ref).max())
        gates.check(system.last_residual <= 1e-10 and abs(w - GOLDEN["q"]) < 5e-5 and err <= 1e-8,
                    f"13(d) Sharded2DGridSystem {GRID2D_SHAPE} Test-G {GRID2D_SMALL}^2: {system.last_iters} "
                    f"iterations, residual {system.last_residual:.2e} <= 1e-10, centre {w:.7f} within 5e-5 of "
                    f"{GOLDEN['q']}, {err:.2e} <= 1e-8 of max|u| of the single-device multigrid solve")
        rec["small"] = {"n": GRID2D_SMALL, "build_s": build_s, "solve_s": solve_s, "iters": system.last_iters,
                        "ms_per_iter": solve_s / max(system.last_iters, 1) * 1e3, "centre_w": w, "rel_err": err,
                        "residual": system.last_residual}
        del system

        mesh, forces = big["mesh"], big["forces"]
        dm.run(pcomm.peak_memory, [True] * dm.size)
        dm.reset_launches()
        t0 = time.perf_counter()
        sys64 = Sharded2DGridSystem(mesh, mat, dm, dtype=torch.float64)
        build_s = time.perf_counter() - t0
        build_launches = [dict(c) for c in dm.launches]
        dm.reset_launches()
        t0 = time.perf_counter()
        u = sys64.solve(forces, rtol=1e-12, maxiter=GRID2D_ITERS)
        solve_s = time.perf_counter() - t0
        solve_launches = [dict(c) for c in dm.launches]
        peaks = dm.run(pcomm.peak_memory, [False] * dm.size)
        chunks = [math.ceil(q / sys64.chunk) for _, q in sys64.tile_elements]
        counts_ok = ([c["elem4"] for c in build_launches] == chunks
                     and all(c["spmv_f64"] == GRID2D_ITERS for c in solve_launches))
        gates.check(sys64.last_iters == GRID2D_ITERS and bool(np.isfinite(u).all())
                    and (counts_ok or device != "cuda"),
                    f"13(d) Sharded2DGridSystem {GRID2D_SHAPE} {mesh.n_nodes} nodes: {sys64.last_iters} CG "
                    f"iterations, finite (residual {sys64.last_residual:.3e}); on the card elem_stiffness<4> per rank "
                    f"{[c['elem4'] for c in build_launches]} == {chunks} chunks, stencil_spmv<double> "
                    f"{[c['spmv_f64'] for c in solve_launches]} == {GRID2D_ITERS}")
        strip = 2 * 6 * 8 * _ceil_to(sys64.grid.nxp + 1, 128)
        rec["big"] = {"nodes": mesh.n_nodes, "tile": [sys64.ly, sys64.lx], "build_s": build_s, "solve_s": solve_s,
                      "iters": sys64.last_iters, "ms_per_iter": solve_s / max(sys64.last_iters, 1) * 1e3,
                      "residual": sys64.last_residual, "halo_bytes_per_iter_per_rank": sys64.halo_bytes_per_iter(),
                      "strip_halo_bytes_per_iter_per_rank": strip, "peak_bytes_per_rank": peaks,
                      "build_launches_per_rank": build_launches, "solve_launches_per_rank": solve_launches}
        counted = dict(pcomm.RANK_LAUNCHES)
        rec["spmv_checks"] = []
        sys32 = sys64.rounded(torch.float32)
        for sys_ in (sys64, sys32):
            for r, chk in enumerate(dm.run(check_spmv_tile, [(sys_.key, 13, 20)] * dm.size)):
                rel = chk["max_abs_err"] / chk["max_abs_y"]
                gate = ERR_GATE[sys_.dtype]
                gates.check(rel <= gate, f"13(d) rank {r}: tile stencil_spmv on the window {chk['shape']} "
                                         f"{chk['dtype']} vs the 9-slot loop {rel:.2e} <= {gate:.0e}")
                rec["spmv_checks"].append(dict(chk, rank=r))
        pcomm.RANK_LAUNCHES.update(counted)
        print(f"  13(d) {GRID2D_SHAPE} grid: Test-G {GRID2D_SMALL}^2 {rec['small']}; {mesh.n_nodes} nodes: "
              f"{ {k: v for k, v in rec['big'].items() if 'launches' not in k} } "
              f"launches/rank build={build_launches} solve={solve_launches}", flush=True)
        del sys64, sys32, u
    return rec


def shard_tower_phase(gates, steps=SHARD_TOWER_STEPS, device="cuda"):
    """13(c): the tower demo with run_structure(devices=2) (two gloo ranks on
    the card) against devices=1: the same coupling iterations in every
    step, every step's solution within SHARD_TOWER_GATE of max|u|."""
    from fem_shell_tpu_torch.coupling.demo import run_demo

    t0 = time.perf_counter()
    one, _ = run_demo(max_timesteps=steps, verbose=False, device=device)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two, _ = run_demo(max_timesteps=steps, verbose=False, device=device, devices=2, backend="gloo")
    two_s = time.perf_counter() - t0
    scale = float(np.abs(one.solutions).max())
    diff = float(np.abs(two.solutions - one.solutions).max()) / scale
    gates.check(two.timesteps == one.timesteps == steps and two.step_iterations == one.step_iterations,
                f"13(c) tower run_structure(devices=2): {two.timesteps} steps, coupling iterations per step equal "
                f"to devices=1's ({sum(two.step_iterations)} vs {sum(one.step_iterations)})")
    gates.check(diff <= SHARD_TOWER_GATE,
                f"13(c) tower devices=2 vs devices=1: {diff:.2e} <= {SHARD_TOWER_GATE:.0e} of max|u|")
    rec = {"steps": steps, "one_s": one_s, "two_s": two_s, "rel_diff": diff,
           "coupling_solves": len(two.iterations), "cg_iters_mean": float(np.mean(two.iterations)),
           "cg_iters_mean_one": float(np.mean(one.iterations)),
           "solve_two": two.perf.stats("solve"), "solve_one": one.perf.stats("solve")}
    print(f"  13(c) tower: devices=1 {one_s:.1f} s, devices=2 {two_s:.1f} s, rel diff {diff:.2e}, "
          f"CG iters/solve {rec['cg_iters_mean']:.1f} (one device {rec['cg_iters_mean_one']:.1f})", flush=True)
    return rec


def phase13(gates, count, cpu_started, device="cuda", n=SHARD_N, steps=SHARD_TOWER_STEPS, parts="abdc"):
    """Phase 13 (the ``parts`` of "abdc", in that order; (e) runs inside (b),
    (d) needs (e)'s plate) with their seconds; the kernel launches of the
    ranks' main-path runs (comm.RANK_LAUNCHES, summed over ranks) under
    "rank_launches", and of this process's in (e) under
    "controller_launches"."""
    from concurrent.futures import ThreadPoolExecutor

    from fem_shell_tpu_torch.parallel import comm as pcomm
    from fem_shell_tpu_torch.parallel.grid2d_shard import make_device_mesh2d

    pcomm.reset_rank_launches()
    out, laps = {}, {}
    big = {} if "b" in parts else None
    meshgen = start_shard_meshgen(n) if "b" in parts else None  # beside 13(a)
    pool = ThreadPoolExecutor(1)
    grid_ranks = None
    if "d" in parts and "b" in parts:  # (d)'s four ranks start beside (a)
        grid_ranks = pool.submit(make_device_mesh2d, *GRID2D_SHAPE, device=device, backend="gloo")
    try:
        for part, key, fn in (("a", "dryrun", lambda: dryrun_phase(gates, cpu_started, count, device=device)),
                              ("b", "scale", lambda: shard_scale_phase(gates, count, n=n, device=device,
                                                                       meshgen=meshgen, big=big)),
                              ("d", "grid2d", lambda: grid2d_phase(gates, grid_ranks, big, device=device)),
                              ("c", "tower", lambda: shard_tower_phase(gates, steps=steps, device=device))):
            if part in parts and (part != "d" or grid_ranks is not None):
                t0 = time.perf_counter()
                out[key] = fn()
                laps[part] = time.perf_counter() - t0
    finally:
        pool.shutdown()
    if big is not None:
        big.clear()
    out["phase13_s"] = laps
    out["rank_launches"] = dict(pcomm.RANK_LAUNCHES)
    out["controller_launches"] = out.get("scale", {}).get("grid_sharded", {}).get(
        "controller_launches", {"class_f32": 0, "class_f64": 0})
    print(f"  phase13_s={sum(laps.values()):.1f} {laps} rank_launches={out['rank_launches']} "
          f"controller_launches={out['controller_launches']}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fem_shell_tpu_torch.ops import _build  # raises in a directory without the port

    gates = Gates()
    t_main = time.perf_counter()

    def header(*text, flush=True):
        """A phase's title with the seconds since the script's start."""
        print(*text, f"[{time.perf_counter() - t_main:.1f} s]", flush=flush)

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must stay off for f32 products")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    bandwidth, peaks = card_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()} host {platform.machine()} "
          f"longdouble eps {np.finfo(np.longdouble).eps}", flush=True)
    gpus, listed = gpu_counts()
    print(f"gpus: torch.cuda.device_count()={gpus} nvidia-smi -L={listed}", flush=True)

    # 13(a)'s CPU ranks, in the background from here: beside the card-bound
    # phases they cost the host little, beside phases 11-12 they slowed both
    cpu_dryrun = start_cpu_dryrun()
    header("phase 1: build", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
             for stem, info in built.items()}
    for stem, info in built.items():
        print(f"  built {stem} in {info['seconds']:.1f} s: {' | '.join(ptxas[stem])}", flush=True)
    print(f"  build_s={build_s:.2f}", flush=True)
    elem_ptxas = ptxas_by_kernel(built["elem_stiffness"]["log"])
    elem_sass = sass_counts(built["elem_stiffness"]["path"])
    for m, meta in ELEM_KERNELS.items():
        line = " | ".join(v for k, v in elem_ptxas.items() if meta["kernel"] in k)
        print(f"  ptxas {meta['name']}: {line}", flush=True)
        print(f"  sass {meta['name']}: "
              f"{[v for k, v in (elem_sass or {}).items() if meta['kernel'] in k]}", flush=True)
        if m == 4:
            gates.check("0 bytes spill stores, 0 bytes spill loads" in line,
                        f"ptxas {meta['name']}: no spills")

    header("phase 2: kernels against their plain versions", flush=True)
    shapes = [("q", 64), ("t", 64), ("t", 1024)]
    kern = kernel_phase(gates, shapes, {64: 200, 1024: 20}, bandwidth, peaks)

    header("phase 2 (mixed): stencil_spmv_f32v against its plain version", flush=True)
    f32v = f32v_kernel_phase(gates, shapes, {64: 200, 1024: 20}, bandwidth, peaks)

    header("phase 2b: class-stencil kernel against its plain version", flush=True)
    class_ptxas = ptxas_by_kernel(built["class_stencil"]["log"])
    class_sass = sass_counts(built["class_stencil"]["path"])
    for kname, line in class_ptxas.items():
        print(f"  ptxas {kname}: {line}", flush=True)
    for kname, counts in (class_sass or {}).items():
        print(f"  sass {kname}: {counts}", flush=True)
    ckern = class_kernel_phase(gates, shapes, {64: 200, 1024: 50}, bandwidth, peaks)

    header("phase 2c: pair-path kernels against their plain versions", flush=True)
    pkern = pair_kernel_phase(gates, shapes, {64: 200, 1024: 20}, bandwidth, peaks)

    header("phase 2d: element-stiffness kernel against its plain version", flush=True)
    ekern = elem_kernel_phase(gates, (("t", 1024, 5), ("q", 1024, 5), ("t", 64, 50), ("q", 64, 50)),
                              bandwidth, peaks)
    ecases = elem_case_phase(gates)

    header("phase 3: Test-G (64x64, rtol 1e-9)", flush=True)
    fields = {}  # (mesh, u) of the Test-G solves, for phase 11's stress recovery
    runs = [solve_phase(gates, et, 64, reps=3, golden=GOLDEN[et], jax_iters=JAX_F64_ITERS[et], keep=fields)
            for et in ("q", "t")]

    header("phase 4: scale (1024x1024 tri and quad)", flush=True)
    runs += [solve_phase(gates, et, 1024, reps=2, golden=KIRCHHOFF, gate_rel=1e-3, keep=fields)
             for et in ("t", "q")]

    header("phase 5: scale path, class operator (1024x1024 tri, solve_df_refined)", flush=True)
    class_runs = [class_solve_phase(gates, "t", 1024)]
    class_runs += [class_solve_phase(gates, et, 64, golden=GOLDEN[et], gate_rel=1e-4, steady=False)
                   for et in ("q", "t")]

    header("phase 6: pair path, materialized operator (1024x1024 tri, solve_df_refined)", flush=True)
    pair_runs = [class_solve_phase(gates, "t", 1024, pair=True)]
    pair_runs += [class_solve_phase(gates, et, 64, golden=GOLDEN[et], gate_rel=1e-4, steady=False,
                                    pair=True) for et in ("q", "t")]

    header("phase 7: grid assembly against the scatter assembly (1024x1024 tri and quad)", flush=True)
    grids = grid_phase(gates, 1024)

    header("phase 8: stand-alone solver (ShellSystem goldens A-G, MultigridShellSystem.solve, CLIs)", flush=True)
    goldens, golden_launches = golden_phase(gates)
    systems = [system_phase(gates, et, bandwidth) for et in ("q", "t")]
    ell_scale = ell_matvec_scale(bandwidth)
    mg_runs = [mg_solve_phase(gates, et, 64, jax=JAX_MG_G[et], golden=GOLDEN[et]) for et in ("q", "t")]
    mg_runs.append(mg_solve_phase(gates, "t", 1024, golden=KIRCHHOFF, gate_rel=1e-3))
    clis = cli_phase(gates)

    header("phase 9: curved shells (the Scordelis-Lo roof; Galerkin levels, the f64 df cycle, W/K cycles)",
          flush=True)
    roof_goldens = roof_golden_phase(gates)
    roof = roof_scale_phase(gates, 512)
    cycles = roof_cycle_phase(gates, 256)
    fused_gal = galerkin_fused_phase(gates)
    roof_pairs = [roof_pair_phase(gates, n, want) for n, want in ROOF_PAIR_CPU.items()]
    roof_runs = [roof] + cycles + fused_gal + roof_pairs

    header("phase 10: unstructured meshes (gather-mode assembly, AMG at 1,043,334 DOF, LargeShellSystem "
          "routes, CLIs)", flush=True)
    umesh, uforces, ucentre = unstructured_plate(416, 1)
    gather = gather_assembly_phase(gates, umesh, bandwidth)
    amg64, u64 = amg_scale_phase(gates, umesh, uforces, ucentre, bandwidth)
    amg32 = amg_refined_phase(gates, umesh, uforces, ucentre, u64, bandwidth)
    del u64, umesh
    large_routes = large_routes_phase(gates)
    ucli = unstructured_cli_phase(gates)
    unstructured = [gather, amg64, amg32] + large_routes

    header("phase 11: the coupled solver and stress recovery (the tower demo, the coupled CLIs over TCP, the "
          f"tower split {TOWER_SPLIT}x{TOWER_SPLIT}, recovery at 1024^2, the --stress CLI)", flush=True)
    t11, phase11_s = time.perf_counter(), {}

    def lap(key):
        nonlocal t11
        phase11_s[key] = time.perf_counter() - t11
        t11 = time.perf_counter()

    tower, tower_run = tower_demo_phase(gates)
    lap("a")
    coupled_cli = coupled_cli_phase(gates, tower_run)
    lap("b")
    del tower_run
    tower_scale = tower_scale_phase(gates)
    lap("c")
    recovery = recovery_phase(gates, fields)
    lap("d")
    del fields
    stress_cli = stress_cli_phase(gates)
    lap("e")
    print(f"  phase11_s={sum(phase11_s.values()):.1f} {phase11_s}", flush=True)
    coupled_elem3 = (sum(r["launches"]["elem3"] for r in tower["runs"] + tower_scale["runs"])
                     + tower_scale["direct_launches"]["elem3"])

    header("phase 12: the differentiable solve (gradients on the tower split "
          f"{TOWER_SPLIT}x{TOWER_SPLIT}) and the f32 systems ({F32_N}^2 Test-G, the --f32 CLI routes, the f32 "
          "coupled tower)", flush=True)
    p12 = phase12(gates)
    p12_launches = ([r["forward_launches"] for r in p12["grad"]["runs"]] + [r["launches"] for r in p12["f32"]]
                    + [p12["f32_tower"]["launches"]])

    header("phase 13: the sharded solvers (parallel/: the dry run's paths 1-7 over gloo and NCCL on the "
          f"card and over gloo on the CPU, Test-G {SHARD_N}^2 through the CLI's --devices 2 and the sharded grid "
          f"assembly, the 2-D process grid {GRID2D_SHAPE}, the tower with run_structure(devices=2))", flush=True)
    p13 = phase13(gates, gpus, cpu_dryrun)
    p13_launches = p13["rank_launches"]

    entries = []
    for dtype, meta in KERNELS.items():
        mine = [r for r in kern if r["dtype"] == str(dtype)[6:]]
        at = mine[-1]  # the scale shape: the largest the main path gives the kernel
        key = "spmv_f32" if dtype == torch.float32 else "spmv_f64"
        entries.append({
            "name": meta["name"], "route": "cuda", "source": SOURCE, "replaces": meta["replaces"],
            "launches": sum(r["launches"][key] for r in runs),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["rel_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "at": f"{at['shape']} K={at['k']} Npad={at['npad']}",
            "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                         for r in mine],
        })
        gates.check(entries[-1]["launches"] > 0, f"{meta['name']} launched on the main path")
    for dtype, meta in CLASS_KERNELS.items():
        form = "f64" if dtype == torch.float64 else "f32"
        mine = [r for r in ckern if r["dtype"] == str(dtype)[6:]]
        at = [r for r in mine if r["shape"] == "t1024" and r["form"] == form][0]
        key = "class_f64" if dtype == torch.float64 else "class_f32"
        entries.append({
            "name": meta["name"], "route": "cuda", "source": CLASS_SOURCE, "replaces": meta["replaces"],
            "launches": sum(r["launches"][key] for r in class_runs + pair_runs)
                        + p13["controller_launches"][key],  # 13(e)'s refinement residual
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["rel_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "at": f"{at['shape']} K={at['k']} Npad={at['npad']} {at['form']}",
            "by_shape": [{k: r[k] for k in ("shape", "form", "instance", "ms", "device_ms", "all_terms_ms",
                                            "plain_ms", "bound_ms", "library_ms")} for r in mine],
            "ptxas": {k: v for k, v in class_ptxas.items()
                      if ("IfLi" if dtype == torch.float32 else "IdLi") in k},
        })
        gates.check(entries[-1]["launches"] > 0, f"{meta['name']} launched on the main path")
    for entry in entries[:2]:  # the scale, pair, f64 multigrid and roof paths' levels run stencil_spmv
        key = "spmv_f32" if "float" in entry["name"] else "spmv_f64"
        entry["launches"] += sum(r["launches"][key] for r in class_runs + pair_runs + mg_runs)
        entry["launches"] += sum(r[key] for r in p12_launches)  # the f32 systems of phase 12
        entry["launches"] += sum(r["launches_total"][key] for r in roof_runs)
        entry["launches"] += sum(r["launches"][key] for r in large_routes)  # LargeShellSystem's stencil mode
        entry["launches"] += p13_launches[key]  # the ranks of phase 13's sharded solves
        if key == "spmv_f64":  # and every f64 V-cycle level, held against the plain version in phases 8-9
            checks = [l for r in mg_runs + [roof] for l in r["plain_checks"]["levels"]]
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [l["max_abs_err"] for l in checks])
            entry["max_rel_err"] = max([entry["max_rel_err"]] + [l["rel_err"] for l in checks])
    at = f32v[-1]
    entries.append({
        "name": "stencil_spmv_f32v", "route": "cuda", "source": SOURCE, "replaces": "fem_shell_tpu/ops/df.py:212",
        "note": "no TPU kernel: the port's instance of stencil_spmv for the f64 CG over an f32 operator, the "
                "counterpart of the XLA df_stencil_matvec_f32v",
        "launches": sum(r["spmv_f32v"] for r in p12_launches),
        "max_abs_err": max(r["max_abs_err"] for r in f32v), "max_rel_err": max(r["rel_err"] for r in f32v),
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"], "at": f"{at['shape']} K={at['k']} Npad={at['npad']}",
        "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms", "share_of_bound")}
                     for r in f32v],
    })
    gates.check(entries[-1]["launches"] > 0, "stencil_spmv_f32v launched on the main path")
    for form, meta in PAIR_KERNELS.items():
        mine = [r for r in pkern if r["form"] == form]
        at = [r for r in mine if r["shape"] == "t1024"][0]
        entries.append({
            "name": meta["name"], "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": (sum(r["launches"][meta["count"]] for r in pair_runs + large_routes)
                         + sum(r["launches_total"][meta["count"]] for r in roof_runs)),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["rel_err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "at": f"{at['shape']} K={at['k']} Npad={at['npad']}",
            "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                         for r in mine],
        })
        gates.check(entries[-1]["launches"] > 0, f"{meta['name']} launched on the main path")
    for m, meta in ELEM_KERNELS.items():
        mine = [r for r in ekern if r["m"] == m]
        cases = [r for r in ecases if r["m"] == m]
        at = max(mine, key=lambda r: r["elements"])  # the scale fine level
        key = f"elem{m}"
        entries.append({
            "name": meta["name"], "route": "cuda", "source": ELEM_SOURCE, "replaces": meta["replaces"],
            "launches": (sum(r["launches"][key] for r in runs + class_runs + pair_runs + grids + systems)
                         + sum(r["ctor_launches"][key] for r in mg_runs) + golden_launches[key]
                         + sum(r["launches"][key] for r in roof_goldens)
                         + sum(r["launches_total"][key] for r in roof_runs)
                         + gather["launches"][key] + amg64["ctor_launches"][key]
                         + amg32["ctor_launches"][key] + sum(r["launches"][key] for r in large_routes)
                         + (coupled_elem3 if m == 3 else 0) + sum(r[key] for r in p12_launches)
                         + p13_launches[key]),
            "max_abs_err": max(r["max_abs_err"] for r in mine + cases),
            "max_rel_err": max(r["rel_err"] for r in mine + cases),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": None,
            "at": f"{at['shape']} fine level, {at['launches_per_level']} launches of "
                  f"{at['strip_elements']} elements",
            "by_shape": [{k: r[k] for k in ("shape", "ms", "device_ms_per_launch", "plain_ms", "bound_ms",
                                            "library_ms")} for r in mine],
            "ptxas": " | ".join(v for k, v in elem_ptxas.items() if meta["kernel"] in k),
        })
        gates.check(entries[-1]["launches"] > 0, f"{meta['name']} launched on the main path")
    total_s = time.perf_counter() - t_main
    print(f"chip_smoke: {total_s:.1f} s", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "total_s": total_s, "build_s": build_s, "ptxas": ptxas, "class_ptxas": class_ptxas,
         "class_sass": class_sass, "elem_ptxas": elem_ptxas, "elem_sass": elem_sass, "longdouble_eps": float(np.finfo(np.longdouble).eps),
         "kernels": kern, "class_kernels": ckern, "pair_kernels": pkern, "elem_kernels": ekern,
         "solves": runs, "class_solves": class_runs, "pair_solves": pair_runs, "grid": grids,
         "elem_cases": ecases, "goldens": goldens, "systems": systems, "ell_matvec_scale": ell_scale,
         "mg_solves": mg_runs, "cli": clis, "roof_goldens": roof_goldens, "roof": roof,
         "roof_cycles": cycles, "galerkin_fused": fused_gal, "roof_pairs": roof_pairs,
         "unstructured": unstructured, "unstructured_cli": ucli,
         "coupled": {"phase11_s": phase11_s, "tower_demo": tower, "coupled_cli": coupled_cli,
                     "tower_scale": tower_scale, "recovery": recovery, "stress_cli": stress_cli},
         "f32v_kernel": f32v, "phase12": p12, "phase13": p13, "gpus": {"torch": gpus, "nvidia_smi": listed}},
        indent=1))
    if gates.failed:
        print(f"chip_smoke: {len(gates.failed)} gate(s) failed", file=sys.stderr)
        for what in gates.failed:
            print(f"  {what}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_background()
    sys.exit(rc)

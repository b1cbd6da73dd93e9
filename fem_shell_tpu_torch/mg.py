"""Geometric multigrid preconditioner for structured flat shell meshes —
port of the fused core of ``fem_shell_tpu/mg.py``.

- levels are shell operators re-assembled on every-2nd-node subsampled
  grids (SoA stencil form, ops/soa.py), detected from the connectivity
  (detect_structured_grid);
- transfers are bilinear node-grid prolongation P and its transpose,
  applied per dof component;
- smoothing is damped Jacobi (or Chebyshev) with per-level damping from a
  power iteration, symmetric pre/post, so the V-cycle is an SPD
  preconditioner inside CG;
- the coarsest level is solved with a Cholesky factor of the diagonally
  scaled dense operator.

These configurations are ported:

- ``MultigridShellSystem(mesh, material)`` (the JAX default,
  ``assemble=True``, dtype float64) builds every level in f64 in the
  constructor, with the per-level damping and the coarsest level's f64
  host inverse. ``solve(forces)`` runs f64 PCG over the fine operator,
  preconditioned by the all-f64 V-cycle; every level's matvec goes
  through ``ops/stencil_spmv.stencil_spmv`` in f64. ``solve_df`` runs the
  same f64 CG with the V-cycle on f32 copies of the levels (the JAX
  package's df CG, in native f64). ``reassemble`` rebuilds the levels.
- ``MultigridShellSystem(mesh, material, assemble=False).solve_fused(forces)``
  assembles every level in f64 on every call, builds the preconditioner
  and runs f64 PCG over the fine operator, preconditioned by the f32
  V-cycle. Every matvec goes through ``ops/stencil_spmv.stencil_spmv``:
  f64 for the outer CG, f32 in the V-cycle. (``solve_fused`` also runs on
  an assembled system.)
- ``MultigridShellSystem(mesh, material, dtype=torch.float32,
  df_operator=True, smoother="chebyshev")`` builds its levels in the
  constructor (the scale configuration): on a uniform grid the fine
  level is the matrix-free class-table operator (ops/class_matvec.py;
  no fine operator is assembled or stored), coarse levels are assembled
  in f64 and kept in f32. ``solve_df`` runs
  f64 PCG over the fine operator, ``solve_df_refined`` adds iterative
  refinement against the longdouble class tables; ``stage_forces`` /
  ``return_device`` / ``fetch_solution`` keep the fields on the device,
  and ``reassemble`` rebuilds every level. The class operator runs through
  ``ops/class_stencil.class_stencil`` (f64 for the CG and the residual,
  f32 with the fused smoother epilogue in the V-cycle); coarse levels
  through ``stencil_spmv`` in f32.
- Every assembled level, on either configuration and at every size, comes
  from the scatter-free grid pipeline (ops/assemble_grid.py, the element
  kernel ops/elem_stiffness.py on the card), so each assembly is bitwise
  repeatable. The JAX package takes that pipeline from 65,536 fine
  elements and scatters below (ROADMAP.md Queue 3, "Differences").
- With ``class_operator=False``, or on a non-uniform grid, the fine
  level is the materialized f64 operator (the pair path). Its CG matvec
  runs through ``ops/stencil_spmv_sym.stencil_spmv_sym`` from the
  operator's upper half (``sym_spmv``; else ``stencil_spmv`` in f64).
  ``solve_df_refined`` first swaps in the class-consistent operator
  A64 = fl64(t0 + t1) generated from the longdouble class tables
  (uniform grids only), so that the refinement residual is
  ``ops/stencil_resid.stencil_resid_dd(A64, x, b)`` (compensated) minus
  the f32 class-table term E x, E = A_true - A64.

- Curved shells (a non-planar grid, e.g. ``shells.scordelis_lo``) take
  Galerkin coarse levels (``coarse_op="galerkin"``, the default there):
  level l >= 1 is ``stencil_rap`` = P^T A P of level l-1's f64 values, a
  9-offset stencil, so only level 0 is assembled. ``df_cycle=True`` (with
  ``df_operator=True``) keeps every level in f64 and runs the whole
  V-cycle in f64 under the f64 CG: native f64 takes the place of the JAX
  package's two-float32 cycle (``mg_df.py``). ``cycle="W"`` adds a second
  coarse visit, ``cycle="K"`` solves each coarse system with two
  truncated flexible-CG steps (``k_depth`` bounds the K levels; the outer
  CG then runs flexible).

- ``MultigridShellSystem(mesh, material, dtype=torch.float32)`` (f32
  levels without ``df_operator``): every level is assembled (or RAP'd) in
  f64 and kept as its f32 cast, the coarsest with the f32 Cholesky factor
  of its scaled dense operator; the JAX package assembles them in f32 on
  re-centred coordinates (ROADMAP.md "Differences"). ``solve`` is f32 PCG
  with the f32 V-cycle, every matvec ``stencil_spmv`` in f32; ``solve_df``
  is f64 PCG over the same f32 fine values through
  ``ops/stencil_spmv.stencil_spmv_f32v``, preconditioned by that f32
  cycle (the JAX package's ``_solve_df_impl_f32``). ``solve_fused``
  assembles in f64 and refuses f32 systems, as the JAX package does.

On the TPU the JAX package runs the outer CG in two-float32 ("df")
arithmetic because its f64 is emulated; on a GPU f64 is native, so the
port's CG is f64 wherever the JAX package's is df. The level-0 class
operator on the coarsest level is not ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from fem_shell_tpu_torch import large
from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh, XDA_QUAD4, XDA_TRI3
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.ops.class_matvec import (
    ClassParts,
    build_class_parts,
    build_pair_ecorr,
    class_matvec_f32,
    class_matvec_f64,
    class_residual,
    pair_ecorr,
)
from fem_shell_tpu_torch.ops.exact_stencil import (
    build_exact_stencil,
    class_flat_tables,
    class_pair_flat,
)
from fem_shell_tpu_torch.ops.soa import _offsets_of, soa_diagonal
from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_f32v
from fem_shell_tpu_torch.ops.stencil_spmv_sym import (
    is_symmetric,
    prepare_sym_values,
    stencil_spmv_sym,
)
from fem_shell_tpu_torch.solver import pcg

# ----------------------------------------------------------------------
# structured-grid detection
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridInfo:
    """Row-major structured grid: node = iy*nxp + ix."""

    nxp: int  # nodes per row
    nyp: int  # node rows
    elem_type: str  # 'q' | 't'
    ul_lr: bool  # tri diagonal orientation (meshGen main_all.cpp:163-224)


def _grid_conn(nxp: int, nyp: int, elem_type: str, ul_lr: bool):
    """(elem_types, elem_conn) of the canonical row-major grid mesh — the
    numbering meshgen.generate emits."""
    nx, ny = nxp - 1, nyp - 1
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n_id = (xx + yy * nxp).reshape(-1).astype(np.int64)
    if elem_type == "q":
        conn = np.stack([n_id, n_id + 1, n_id + nxp + 1, n_id + nxp], axis=1)
        types = np.full(len(n_id), XDA_QUAD4, dtype=np.int32)
        conn4 = conn.astype(np.int32)
    else:
        if ul_lr:
            tri1 = np.stack([n_id, n_id + 1, n_id + nxp], axis=1)
            tri2 = np.stack([n_id + 1, n_id + nxp + 1, n_id + nxp], axis=1)
        else:
            tri1 = np.stack([n_id, n_id + nxp + 1, n_id + 1], axis=1)
            tri2 = np.stack([n_id + nxp + 1, n_id, n_id + nxp], axis=1)
        both = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
        conn4 = np.hstack([both, np.full((len(both), 1), -1, dtype=np.int64)]).astype(np.int32)
        types = np.full(len(both), XDA_TRI3, dtype=np.int32)
    return types, conn4


def detect_structured_grid(mesh: ShellMesh) -> Optional[GridInfo]:
    """Recognize a row-major structured grid from the connectivity alone:
    candidate row widths come from the stencil offsets and each is verified
    by rebuilding the canonical connectivity (tri stencils fit both
    diagonal orientations, so only the comparison decides)."""
    n = mesh.n_nodes
    if len(mesh.tri) and len(mesh.quad):
        return None
    elem_type = "q" if len(mesh.quad) else "t"
    conn = mesh.quad if elem_type == "q" else mesh.tri
    if len(conn) == 0:
        return None
    top = int(_offsets_of(mesh)[-1])
    if elem_type == "q":
        cands = [(top - 1, True)]  # quad offsets peak at nxp + 1
    else:
        cands = [(top, True), (top - 1, False)]  # ul_lr diag=nxp-1 | diag=nxp+1
    for nxp, ul_lr in cands:
        if nxp < 2 or n % nxp:
            continue
        nyp = n // nxp
        if nyp < 2:
            continue
        n_cells = (nxp - 1) * (nyp - 1)
        expect_e = n_cells if elem_type == "q" else 2 * n_cells
        if len(conn) != expect_e:
            continue
        _, conn4 = _grid_conn(nxp, nyp, elem_type, ul_lr)
        want = conn4[:, :4] if elem_type == "q" else conn4[:, :3]
        if conn.shape == want.shape and (conn == want).all():
            return GridInfo(nxp, nyp, elem_type, ul_lr)
    return None


@dataclasses.dataclass
class _Level:
    """One grid level: operator, masks, smoother and coarse-solve data."""

    values: Optional[torch.Tensor]  # [36, K, Npad]
    offsets: tuple
    free_t: torch.Tensor  # [6, Npad]
    inv_diag: Optional[torch.Tensor]  # [6, Npad]
    nyp: int  # node rows
    nxp: int  # node cols
    npad: int
    omega: Optional[torch.Tensor] = None  # per-level Jacobi damping (0-d)
    chol: Optional[torch.Tensor] = None  # coarsest: Cholesky of scaled dense
    chol_scale: Optional[torch.Tensor] = None  # d^-1/2 for the scaled factor
    lam: Optional[torch.Tensor] = None  # lambda_max(D^-1 A) estimate (0-d)
    cparts: Optional[ClassParts] = None  # matrix-free class operator (values None)
    dense_inv: Optional[torch.Tensor] = None  # coarsest f64 level: host inverse, uploaded


def _to_grid(x, lvl: _Level):
    return x[:, : lvl.nyp * lvl.nxp].reshape(6, lvl.nyp, lvl.nxp)


def _from_grid(g, lvl: _Level):
    flat = g.reshape(6, lvl.nyp * lvl.nxp)
    return F.pad(flat, (0, lvl.npad - lvl.nyp * lvl.nxp))


def _prolong(gc):
    """Bilinear coarse->fine on node grids: [6, nc, mc] -> [6, 2nc-1, 2mc-1]."""
    c = gc
    row_mid = 0.5 * (c[:, :-1, :] + c[:, 1:, :])
    rows = c.new_zeros((6, c.shape[1] + row_mid.shape[1], c.shape[2]))
    rows[:, 0::2, :] = c
    rows[:, 1::2, :] = row_mid
    col_mid = 0.5 * (rows[:, :, :-1] + rows[:, :, 1:])
    out = rows.new_zeros((6, rows.shape[1], rows.shape[2] + col_mid.shape[2]))
    out[:, :, 0::2] = rows
    out[:, :, 1::2] = col_mid
    return out


def _restrict(gf):
    """P^T on node grids: [6, 2nc-1, 2mc-1] -> [6, nc, mc]. Each coarse node
    collects its own fine value, 1/2 of its edge-midpoint neighbours and
    1/4 of its cell centres (columns first, as in the JAX package)."""
    odd = gf[:, :, 1::2]
    cols = gf[:, :, 0::2].clone()
    cols[:, :, :-1] += 0.5 * odd
    cols[:, :, 1:] += 0.5 * odd
    odd_r = cols[:, 1::2, :]
    out = cols[:, 0::2, :].clone()
    out[:, :-1, :] += 0.5 * odd_r
    out[:, 1:, :] += 0.5 * odd_r
    return out


def _is_planar(coords, tol: float = 1e-6) -> bool:
    """True when the node cloud lies in one plane (within tol, relative to
    the largest in-plane extent)."""
    c = np.asarray(coords, np.float64)
    c = c - c.mean(axis=0)
    w = np.linalg.eigvalsh(c.T @ c)
    if w[-1] <= 0:
        return True
    return float(np.sqrt(max(w[0], 0.0) / w[-1])) <= tol


class _RebuildProf:
    """Stage profiler of ``reassemble(profile=True)``: each ``mark``
    synchronizes the device (so the stage's kernels have finished) and
    records the wall seconds since the previous mark; ``absorb`` adds
    host timings measured inside a stage (indented, not summed)."""

    def __init__(self, on: bool, device=None):
        self.on = on
        self.cuda = on and device is not None and torch.device(device).type == "cuda"
        self.rows: list = []
        self._t = time.perf_counter() if on else 0.0

    def mark(self, name: str):
        if not self.on:
            return
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.rows.append((name, t - self._t))
        self._t = t

    def absorb(self, prefix: str, timings: dict):
        if not self.on:
            return
        for k, v in timings.items():
            self.rows.append((f"{prefix}{k}", v))

    def report(self):
        if not self.on:
            return
        tot = sum(d for n, d in self.rows if not n.startswith("  "))
        for name, d in self.rows:
            print(f"  rebuild-prof {name:36s} {d:8.3f} s", flush=True)
        print(f"  rebuild-prof {'TOTAL':36s} {tot:8.3f} s", flush=True)


def _offset_dydx(off: int, nxp: int):
    """Linear node offset -> (dy, dx) on a row-major grid, |dx| <= 1."""
    for dy in (-1, 0, 1):
        dx = off - dy * nxp
        if abs(dx) <= 1:
            return dy, dx
    raise ValueError(f"offset {off} not within the 3x3 stencil of nxp={nxp}")


def grid_rap_offsets(nxp_c: int):
    """The 9-point coarse stencil offsets stencil_rap emits."""
    return tuple(dy * nxp_c + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def stencil_rap(values, free_c, offsets_f, nyp_f, nxp_f, npad_c):
    """Galerkin coarse operator C = P^T A P in stencil space.

    ``values`` is a fine-level stencil operator ([36, K, Npad] or flat
    [36K, Npad]; block A(i, i+off_s) = v[a, b, s, i]) with K = 9 (quad) or
    7 (tri) offsets within the 3x3 node stencil; P is the bilinear
    node-grid prolongation (``_prolong``). With P's 3x3 support and A's
    3x3 reach, C closes within the 3x3 coarse stencil, so the result is a
    [36*9, npad_c] operator over ``grid_rap_offsets`` for the same
    smoother, matvec kernel and coarse solve as an assembled level.

    Why: coarse levels rediscretized on a subsampled CURVED grid (the
    Scordelis-Lo roof) make a coarse polyhedral surface whose
    inextensional-bending near-nullspace no longer matches the fine facet
    model, and the V-cycle stalls; the Galerkin operator inherits the fine
    energy by construction.

    Every transfer weight is a power of two, so each term is exact; the
    terms are summed in the JAX package's order (slot, d1y, d1x, Oy, Ox),
    so the result equals its ``stencil_rap`` bit for bit. Dirichlet: the
    fine values are BC-eliminated, so the coarse stencil is re-masked
    against ``free_c`` ([6, npad_c]) and given unit diagonals on
    constrained DOFs, the convention of the assemblers."""
    k = len(offsets_f)
    n_f = nyp_f * nxp_f
    nyc, nxc = (nyp_f + 1) // 2, (nxp_f + 1) // 2
    n_c = nyc * nxc
    S = values.reshape(6, 6, k, -1)[:, :, :, :n_f].reshape(6, 6, k, nyp_f, nxp_f)
    # zero-pad by 1 so sampling at fine node 2I + d1 is a strided slice
    Sp = F.pad(S, (1, 1, 1, 1))
    w = {-1: 0.5, 0: 1.0, 1: 0.5}
    acc = {(oy, ox): None for oy in (-1, 0, 1) for ox in (-1, 0, 1)}
    for s, off in enumerate(offsets_f):
        oy, ox = _offset_dydx(int(off), nxp_f)
        for d1y in (-1, 0, 1):
            ty = oy + d1y
            for d1x in (-1, 0, 1):
                tx = ox + d1x
                # S[s] sampled at fine (2Iy+d1y, 2Ix+d1x)
                samp = Sp[:, :, s, d1y + 1 : d1y + 2 * nyc : 2, d1x + 1 : d1x + 2 * nxc : 2]
                for Oy in range(ty // 2, (ty + 1) // 2 + 1):
                    d2y = ty - 2 * Oy
                    if abs(d2y) > 1:
                        continue
                    for Ox in range(tx // 2, (tx + 1) // 2 + 1):
                        d2x = tx - 2 * Ox
                        if abs(d2x) > 1:
                            continue
                        t = (w[d1y] * w[d1x] * w[d2y] * w[d2x]) * samp
                        prev = acc[(Oy, Ox)]
                        acc[(Oy, Ox)] = t if prev is None else prev + t
    del Sp, S
    out = torch.stack([acc[(oy, ox)] for oy in (-1, 0, 1) for ox in (-1, 0, 1)], dim=2)
    del acc
    # coarse Dirichlet elimination: zero rows/cols, unit diagonal
    fg = free_c[:, :n_c].reshape(6, nyc, nxc).to(out.dtype)
    fgp = F.pad(fg, (1, 1, 1, 1))
    nb = torch.stack(
        [fgp[:, 1 + oy : 1 + oy + nyc, 1 + ox : 1 + ox + nxc] for oy in (-1, 0, 1) for ox in (-1, 0, 1)],
        dim=1,
    )  # [6, 9, nyc, nxc]: the free mask of the node each slot points at
    out = out * fg[:, None, None] * nb[None, :, :]
    for a in range(6):
        out[a, a, 4] = torch.where(fg[a] > 0, out[a, a, 4], torch.ones_like(out[a, a, 4]))
    return F.pad(out.reshape(36 * 9, n_c), (0, npad_c - n_c))


class MultigridShellSystem:
    """Shell solver with a geometric multigrid preconditioner (any
    row-major structured grid mesh, flat or curved; nx, ny divisible by
    2^(levels-1))."""

    def __init__(
        self,
        mesh: Union[ShellMesh, MeshGenParams],
        material: Material,
        dtype=torch.float64,
        n_levels: Optional[int] = None,
        nu_smooth: int = 3,
        omega: Optional[float] = None,
        coarse_max: int = 8,
        chunk: int = 16384,
        df_operator: bool = False,
        assemble: bool = True,
        smoother: str = "jacobi",
        class_operator: Optional[bool] = None,
        coarse_op: Optional[str] = None,
        cycle: Optional[str] = None,
        sym_spmv: Optional[bool] = None,
        df_cycle: bool = False,
        k_depth: Optional[int] = None,
        strip_nodes: int = 65536,
        device=None,
    ):
        """With ``assemble`` (the default) every level is built here: in f64
        without ``df_operator`` (dtype float64; ``solve``, ``solve_df``), as
        f32 casts of f64 levels without ``df_operator`` (dtype float32; the
        f32 ``solve`` and ``solve_df``), or with ``df_operator=True`` (dtype float32) as f32 V-cycle levels
        beside the f64 CG (``solve_df``, ``solve_df_refined``), or with
        ``df_operator=True, df_cycle=True`` as f64 levels under an f64
        V-cycle (the JAX package's two-float32 cycle, in native f64).
        ``coarse_op``: "rediscretize" assembles every level on the
        subsampled grid, "galerkin" computes levels l >= 1 as
        ``stencil_rap`` of the level above (no assembly); None = galerkin
        on a non-planar mesh, else rediscretize. ``cycle``: "V" (None),
        "W" (two coarse visits) or "K" (two flexible-CG steps per coarse
        level down to level ``k_depth``, every level when None; the outer
        CG runs flexible). ``assemble=False`` (dtype float64) builds nothing here:
        ``solve_fused`` assembles every level on every call, the JAX
        package's fused configuration. ``class_operator`` picks the
        df_operator fine level: None = the class operator where
        ``build_exact_stencil`` accepts the mesh, else the materialized f64
        operator; True = require the class operator (raises on non-uniform
        grids); False = the materialized operator. ``omega`` fixes the
        Jacobi damping of every level (None: 4 / (3 lambda_max) per level
        from a power iteration, which Chebyshev smoothing always takes its
        interval from). ``sym_spmv`` keeps the materialized fine operator's
        upper half for the CG matvec (symmetric storage); None = on from
        ``large.GRID_MIN_ELEMENTS`` (65,536) elements, the JAX package's
        threshold, on any device. Every assembled level is built by the
        scatter-free grid pipeline (``LargeShellSystem.assemble_df``,
        ``strip_nodes`` nodes per strip) at every mesh size.
        ``device`` defaults to CUDA; pass ``"cpu"`` to run on the host."""
        if isinstance(mesh, MeshGenParams):
            mesh, _, _ = generate(mesh)
        if df_cycle and not df_operator:
            raise ValueError("df_cycle requires df_operator=True (the df cycle's levels "
                             "come from the df_operator assembly)")
        if df_operator:
            if dtype != torch.float32:
                raise ValueError(
                    "df_operator=True keeps f32 V-cycle levels beside the f64 CG: "
                    "construct MultigridShellSystem(..., dtype=torch.float32)"
                )
            if not assemble:
                raise ValueError("df_operator=True builds its levels in the constructor")
        elif dtype not in (torch.float64, torch.float32):
            raise ValueError(f"MultigridShellSystem(dtype={dtype}): torch.float64 or torch.float32")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if cycle not in (None, "V", "W", "K"):
            raise ValueError(f"unknown cycle {cycle!r}")
        self.device = resolve_device(device)
        self.material = material
        self.dtype = dtype
        self.df_operator = bool(df_operator)
        self.df_cycle = bool(df_cycle)
        # every level's values in f64: the f64 hierarchy, or the df cycle
        self._f64_levels = dtype == torch.float64 or self.df_cycle
        self.nu_smooth = nu_smooth
        self.omega = omega
        self.smoother = smoother
        self.cheby_lo = 0.25
        # None = V everywhere: W's composed coarse solver 2M - MAM is SPD
        # only while lambda_max(AM) < 2, which deep curved (Galerkin) f32
        # hierarchies violate (the JAX package's roof W runs diverged);
        # K is SPD at any depth but varies from call to call
        self.cycle = cycle or "V"
        self.k_depth = k_depth
        self._big = len(mesh.tri) + len(mesh.quad) >= large.GRID_MIN_ELEMENTS
        self.sym_spmv = self._big if sym_spmv is None else bool(sym_spmv)
        self._df_strip_nodes = int(strip_nodes)

        grid = detect_structured_grid(mesh)
        if grid is None:
            raise ValueError(
                "multigrid requires a row-major structured grid mesh "
                "(detect_structured_grid failed)"
            )
        self.grid = grid
        if coarse_op is None:
            coarse_op = "rediscretize" if _is_planar(mesh.coords) else "galerkin"
        if coarse_op not in ("rediscretize", "galerkin"):
            raise ValueError(f"unknown coarse_op {coarse_op!r}")
        if coarse_op == "galerkin" and class_operator:
            raise ValueError(
                "coarse_op='galerkin' needs materialized fine values as the "
                "RAP source; class_operator=True stores none"
            )
        if coarse_op == "galerkin" or self.df_cycle:
            class_operator = False  # the RAP source / the f64 cycle's fine level
        self.coarse_op = coarse_op

        if n_levels is None:
            n_levels = 1
            nx, ny = grid.nxp - 1, grid.nyp - 1
            while nx % 2 == 0 and ny % 2 == 0 and max(nx, ny) > 2 * coarse_max:
                nx //= 2
                ny //= 2
                n_levels += 1
        self.n_levels = n_levels

        # level geometry/BC: every-2nd-node subsampling of the FINE grid
        coords_g = np.asarray(mesh.coords, np.float64).reshape(grid.nyp, grid.nxp, 3)
        mask_g = mesh.dirichlet_mask().reshape(grid.nyp, grid.nxp, 6)
        self.levels: List[_Level] = []
        self._systems: List[LargeShellSystem] = []
        for l in range(n_levels):
            f = 2**l
            if (grid.nxp - 1) % f or (grid.nyp - 1) % f:
                raise ValueError(f"nx/ny not divisible by 2^{l}")
            cg, mg_ = coords_g[::f, ::f], mask_g[::f, ::f]
            nyp_l, nxp_l = cg.shape[0], cg.shape[1]
            types_l, conn_l = _grid_conn(nxp_l, nyp_l, grid.elem_type, grid.ul_lr)
            mesh_l = (
                mesh
                if l == 0
                else ShellMesh(cg.reshape(-1, 3), types_l, conn_l, np.zeros((0, 3), np.int32))
            )
            sys_l = LargeShellSystem(
                mesh_l,
                material,
                dtype=torch.float64,
                chunk=chunk if l == 0 else min(chunk, 4096),
                dirichlet_mask=mg_.reshape(-1, 6),
                device=self.device,
            )
            self._systems.append(sys_l)
            galerkin_l = l > 0 and coarse_op == "galerkin"
            self.levels.append(
                _Level(
                    values=None,
                    offsets=(grid_rap_offsets(nxp_l) if galerkin_l
                             else tuple(int(o) for o in sys_l.offsets)),
                    free_t=sys_l.free_t,
                    inv_diag=None,
                    nyp=nyp_l,
                    nxp=nxp_l,
                    npad=sys_l.pattern.n_pad,
                )
            )
        self._fine = self.levels[0]
        self._fine_mesh = mesh
        self._cdf: Optional[ClassParts] = None  # the fine class operator, if any
        self._fine64: Optional[torch.Tensor] = None  # the materialized fine operator, if any
        self._fine_sym: Optional[torch.Tensor] = None  # its upper half, if kept
        self._class_pair_done = False  # _fine64 is the class-consistent A64
        self._exact_st = None  # the fine grid's longdouble class tables, once built
        self._pair_tabs = None  # their flat (t0, t1, class) tables for the pair path
        # None = try the class operator, True = it is required, False = pair
        self._class_mode = class_operator if (df_operator and n_levels > 1) else False
        self._levels32: Optional[List[_Level]] = None  # solve_df's f32 copies of f64 levels
        if assemble:
            self._assemble_levels()

    # ------------------------------------------------------------------
    def _assemble_levels(self, prof: Optional[_RebuildProf] = None):
        """Build (or rebuild) every level, each old operator released before
        its level is rebuilt.

        - f64 levels (no df_operator, or df_cycle): values, diagonal and
          damping in f64, the coarsest with its f64 host inverse. The JAX
          package assembles these with ``assemble()``
          (fem_shell_tpu/mg.py:676), the port through the grid pipeline,
          whose sums have one order. With df_cycle, level 0's values are
          also the CG's fine operator (``_fine64``).
        - df_operator: the fine class operator, or the materialized f64 fine
          operator; the other levels built in f64 and kept in f32 with the
          diagonal of the f64 values (the JAX package's df-assembly hi
          part); the coarsest level's f32 factor.
        - Galerkin levels (l >= 1 with ``coarse_op="galerkin"``) are
          ``stencil_rap`` of level l-1's f64 values: nothing is assembled
          below level 0. On the df_operator pair path the RAP chain runs in
          f64: each level is kept as the f32 cast of its f64 values, which
          live on only until the next level is built from them (the JAX
          package RAPs the f32 hi part, ROADMAP.md "Differences").

        Then the fine operator's upper half (``_build_fine_sym``). Every
        assembled level comes from the grid pipeline (the JAX package does
        so from ``large.GRID_MIN_ELEMENTS`` fine elements,
        fem_shell_tpu/mg.py:658-662, and scatters below), and each level's
        damping from ``_level_omega``. ``prof`` marks each stage
        (``reassemble(profile=True)``)."""
        prof = prof or _RebuildProf(False)
        self._cdf = self._fine64 = self._fine_sym = None
        self._levels32 = None  # stale f32 copies of the old values
        self._class_pair_done = False
        dt = torch.float64 if self._f64_levels else torch.float32
        prev64 = None  # level l-1's f64 values: the next Galerkin level's source
        for l, sys_l in enumerate(self._systems):
            lvl = dataclasses.replace(self.levels[l], values=None, cparts=None, dense_inv=None,
                                      chol=None, chol_scale=None)
            self.levels[l] = lvl
            if l == 0:
                self._fine = lvl  # drop the old level-0 values with this alias too
            cparts = None
            if l == 0 and self._class_mode is not False:
                # matrix-free fine level: exact-stencil class tables instead
                # of a materialized operator (uniform grids only)
                tim = {} if prof.on else None
                try:
                    cparts, diag = self._build_class_level(self._fine_mesh, sys_l, timings=tim)
                except ValueError:
                    if self._class_mode:
                        raise
                    self._class_mode = False
                else:
                    self._class_mode = True
                    prof.absorb("  class/", tim or {})
                    prof.mark("class/build+upload")
            if cparts is not None:
                lvl = dataclasses.replace(
                    lvl, cparts=cparts, free_t=sys_l.free_t.to(dt),
                    inv_diag=torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)),
                )
                prof.mark("class/inv_diag")
            else:
                if l > 0 and self.coarse_op == "galerkin":
                    prev = self.levels[l - 1]
                    v64 = stencil_rap(prev64, sys_l.free_t, prev.offsets, prev.nyp, prev.nxp,
                                      lvl.npad).reshape(36, len(lvl.offsets), lvl.npad)
                    d64 = soa_diagonal(v64, offsets=lvl.offsets)
                    stage = "rap"
                else:
                    v64, d64 = sys_l.assemble_df(strip_nodes=self._df_strip_nodes, method="grid",
                                                 with_diag=True)
                    stage = "assemble"
                prof.mark(f"L{l}/{stage}")
                if l == 0 and self.df_operator:
                    self._fine64 = v64
                lvl = dataclasses.replace(
                    lvl, values=v64.to(dt), free_t=sys_l.free_t.to(dt),
                    inv_diag=torch.where(d64 != 0, 1.0 / d64, torch.ones_like(d64)).to(dt),
                )
                # the next Galerkin level's source: an alias of the f64
                # level, on the pair path kept beside the f32 copy until
                # the next level is built
                prev64 = v64 if (l + 1 < self.n_levels and self.coarse_op == "galerkin") else None
                del v64, d64
                prof.mark(f"L{l}/inv_diag")
            if l == self.n_levels - 1:
                lvl = self._coarse_factor(lvl)
                prof.mark("coarse/factor")
            else:
                om, lam = self._level_omega(lvl)
                lvl = dataclasses.replace(lvl, omega=om, lam=lam)
                prof.mark("class/omega" if lvl.cparts is not None else f"L{l}/omega")
            self.levels[l] = lvl
        self._fine = self.levels[0]
        self._cdf = self._fine.cparts
        self._build_fine_sym()
        prof.mark("fine/sym")

    def _build_fine_sym(self):
        """The materialized fine operator's off >= 0 slots for the CG
        matvec (``stencil_spmv_sym``), which needs ~55 % of the
        operator's values per iteration. Only with ``sym_spmv`` and a
        structurally symmetric stencil; an asymmetric one keeps full
        storage."""
        self._fine_sym = None
        offsets = self.levels[0].offsets
        if self.sym_spmv and self._fine64 is not None and is_symmetric(offsets):
            self._fine_sym = prepare_sym_values(self._fine64, offsets)

    def _build_class_level(self, mesh, sys_l, timings: Optional[dict] = None):
        """Host: exact-stencil tables -> the fine level's class operator
        and its f32 diagonal, on the system's device (raises ValueError
        off uniform grids). ``timings`` receives the host seconds of each
        stage of the tables and of ``class_parts``."""
        self._exact_st = build_exact_stencil(mesh, self.material, sys_l.offsets, grid=self.grid,
                                             timings=timings)
        t0 = time.perf_counter()
        out = build_class_parts(self._exact_st, sys_l.pattern.n_pad, device=self.device)
        if timings is not None:
            timings["class_parts"] = time.perf_counter() - t0
        return out

    def _coarse_factor(self, c: _Level) -> _Level:
        """Coarsest-level direct solve. f64 levels: the inverse of the
        dense operator, computed on the host in f64 and uploaded once per
        (re)assembly (the JAX package's f64 mode). df_operator levels: f32
        Cholesky of the diagonally scaled dense operator, with the JAX
        package's eps cascade: if the factor fails, the scaled operator
        (unit diagonal, so the shifts are relative) is shifted by 1e-5,
        then 1e-3; a shift on a preconditioner-only coarse solve is
        harmless. (solve_fused keeps its own unshifted factor.) The df
        cycle's f64 levels take the f64 inverse too: the JAX package's
        ``_coarse_factor_df`` inverts its full two-float32 pair in f64.
        The f64 inverse leaves out an exact null space
        (``_coarse_inverse``; ROADMAP.md Queue 3)."""
        if self._f64_levels:
            inv = _coarse_inverse(_densify(c).cpu().numpy())
            return dataclasses.replace(c, dense_inv=torch.as_tensor(inv, device=self.device))
        dense = _densify(c)
        d = torch.diagonal(dense)
        s = torch.where(d > 0, torch.rsqrt(d), torch.ones_like(d))
        scaled = (dense * s[None, :] * s[:, None]).to(torch.float32)
        eye = torch.eye(scaled.shape[0], dtype=torch.float32, device=scaled.device)
        chol, info = torch.linalg.cholesky_ex(scaled)
        for eps in (1e-5, 1e-3):
            if int(info) == 0 and bool(torch.isfinite(chol).all()):
                break
            chol, info = torch.linalg.cholesky_ex(scaled + eps * eye)
        return dataclasses.replace(c, chol=chol, chol_scale=s.to(torch.float32))

    def _mv(self, lvl: _Level, x):
        """Level matvec: the class-stencil kernel on the class level, the
        stencil block-SpMV kernel on assembled levels."""
        if lvl.cparts is not None:
            return class_matvec_f32(lvl.cparts, x)
        return stencil_spmv(lvl.values, x, lvl.offsets)

    def _wresid(self, lvl: _Level, x, b, w):
        """w * (b - A x), the smoother's correction: one fused kernel pass
        on the class level."""
        if lvl.cparts is not None:
            return class_matvec_f32(lvl.cparts, x, w=w, b=b)
        return w * (b - self._mv(lvl, x))

    def _level_omega(self, lvl: _Level):
        """(omega, lambda_max) of one level: omega = 4 / (3 lambda_max(D^-1
        A)) clipped to [0.2, 1], lambda_max from ``_power_lambda``. The
        constructor's ``omega`` overrides the damping; Chebyshev smoothing
        still takes lambda_max from the power iteration."""
        if self.omega is not None:
            lam = self._power_lambda(lvl) if self.smoother == "chebyshev" else None
            return torch.tensor(self.omega, dtype=lvl.inv_diag.dtype, device=lvl.inv_diag.device), lam
        lam = self._power_lambda(lvl)
        return torch.clamp(4.0 / (3.0 * lam), 0.2, 1.0), lam

    def _power_lambda(self, lvl: _Level):
        """lambda_max(D^-1 A) UPPER estimate for one level (0-d tensor):
        20 power steps on the symmetrized S = D^-1/2 A D^-1/2, then the
        Rayleigh quotient theta plus the Ritz residual norm ||S v - theta v||
        (a plain power estimate is a lower bound, and the Chebyshev
        smoother diverges outside its interval)."""
        n = lvl.npad
        dt, dev = lvl.inv_diag.dtype, lvl.inv_diag.device
        i = torch.arange(6 * n, dtype=dt, device=dev).reshape(6, n)
        v = (torch.sin(i * 0.7311) + 0.1) * lvl.free_t
        tiny = 1e-30
        # guard: a level whose DOFs are all constrained would hit 0/0
        v = v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=tiny)
        dis = torch.sqrt(lvl.inv_diag)

        def smv(v):
            return dis * self._mv(lvl, dis * v)

        for _ in range(20):
            w = smv(v)
            v = w / torch.clamp(torch.sqrt(torch.sum(w * w)), min=tiny)
        w = smv(v)
        vn2 = torch.clamp(torch.sum(v * v), min=tiny)
        theta = torch.sum(v * w) / vn2
        resid = torch.sqrt(torch.clamp(torch.sum((w - theta * v) ** 2) / vn2, min=0.0))
        return torch.clamp(theta + resid, min=tiny)

    def _smooth(self, lvl: _Level, x, b, sweeps):
        if self.smoother == "chebyshev" and lvl.lam is not None:
            return self._smooth_cheby(lvl, x, b, sweeps)
        w = lvl.omega * lvl.inv_diag
        for _ in range(sweeps):
            x = x + self._wresid(lvl, x, b, w)
        return x

    def _smooth_cheby(self, lvl: _Level, x, b, deg):
        """Degree-``deg`` Chebyshev smoothing on D^-1 A over
        [0.25, 1.05]*lam_max: a fixed polynomial in the preconditioned
        operator, so the V-cycle stays SPD."""
        lam = lvl.lam.to(lvl.inv_diag.dtype) * 1.05
        lmin = self.cheby_lo * lam
        theta = 0.5 * (lam + lmin)
        delta = 0.5 * (lam - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        z = self._wresid(lvl, x, b, lvl.inv_diag)
        p = z / theta
        x = x + p
        for _ in range(deg - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            z = self._wresid(lvl, x, b, lvl.inv_diag)
            p = (rho_new * rho) * p + (2.0 * rho_new / delta) * z
            x = x + p
            rho = rho_new
        return x

    def _vcycle(self, levels, li: int, b):
        lvl = levels[li]
        if lvl.chol is not None:
            # coarse solve: Cholesky of the diagonally scaled dense operator
            n_real = lvl.nyp * lvl.nxp
            rhs = (lvl.chol_scale * b[:, :n_real].reshape(-1))[:, None]
            y = torch.linalg.solve_triangular(lvl.chol, rhs, upper=False)
            z = torch.linalg.solve_triangular(lvl.chol.mT, y, upper=True)
            flat = (lvl.chol_scale * z[:, 0]).reshape(6, n_real)
            return F.pad(flat, (0, lvl.npad - n_real)) * lvl.free_t
        if lvl.dense_inv is not None:
            # the f64 inverse applied in its own dtype over the real nodes,
            # the result cast to the cycle's (its entries can span the f32
            # range on an ill-conditioned coarsest operator)
            n_real = lvl.nyp * lvl.nxp
            rhs = b[:, :n_real].reshape(-1).to(lvl.dense_inv.dtype)
            flat = torch.matmul(lvl.dense_inv, rhs).reshape(6, n_real).to(b.dtype)
            return F.pad(flat, (0, lvl.npad - n_real)) * lvl.free_t
        x = torch.zeros_like(b)
        x = self._smooth(lvl, x, b, self.nu_smooth)
        r = b - self._mv(lvl, x)
        nxt = levels[li + 1]
        rc = _from_grid(_restrict(_to_grid(r, lvl)), nxt) * nxt.free_t
        ec = self._coarse_visit(levels, li + 1, rc)
        x = x + _from_grid(_prolong(_to_grid(ec, nxt)), lvl) * lvl.free_t
        return self._smooth(lvl, x, b, self.nu_smooth)

    def _coarse_visit(self, levels, li: int, rc):
        """Coarse-level solve for the cycle type. "V": one recursive visit.
        "W": a second visit on the updated residual (the composed solver
        2M - MAM is symmetric, SPD only while lambda_max(AM) < 2). "K"
        (Notay's K-cycle): two truncated flexible-CG steps on the coarse
        system, preconditioned by the visit at that level, on levels down
        to ``k_depth``; each application is SPD but nonlinear in rc, so the
        outer CG runs flexible."""
        nxt = levels[li]
        direct = nxt.chol is not None or nxt.dense_inv is not None
        if (self.cycle == "K" and li < len(levels) - 1 and not direct
                and (self.k_depth is None or li <= self.k_depth)):
            return self._ksolve(levels, li, rc)
        ec = self._vcycle(levels, li, rc)
        if self.cycle == "W" and li < len(levels) - 1:
            rc2 = rc - self._mv(nxt, ec) * nxt.free_t
            ec = ec + self._vcycle(levels, li, rc2)
        return ec

    def _ksolve(self, levels, li: int, b):
        """Two truncated flexible-CG steps on A_li e = b, preconditioned by
        the cycle visit at this level (which recurses through
        ``_coarse_visit``, so every level below gets the same
        acceleration). The zero-guarded divisions keep a zero residual
        from turning into 0/0."""
        lvl = levels[li]

        def mv(x):
            return self._mv(lvl, x) * lvl.free_t

        def sdiv(a, d):
            return a / torch.where(d == 0, torch.ones_like(d), d)

        z1 = self._vcycle(levels, li, b)
        q1 = mv(z1)
        zq1 = torch.sum(z1 * q1)
        alpha1 = sdiv(torch.sum(z1 * b), zq1)
        r = b - alpha1 * q1
        z2 = self._vcycle(levels, li, r)
        q2 = mv(z2)
        beta = sdiv(torch.sum(z2 * q1), zq1)
        p = z2 - beta * z1
        qp = q2 - beta * q1
        alpha2 = sdiv(torch.sum(p * r), torch.sum(p * qp))
        return alpha1 * z1 + alpha2 * p

    # ------------------------------------------------------------------
    def _fused_impl(self, coords_list, tables_list, forces_t, rtol, maxiter, arith):
        """Assemble every level in f64 (Galerkin levels: ``stencil_rap`` of
        the level above, in f64), build the f32 V-cycle (Jacobi
        diagonals, power-iteration damping, coarse Cholesky) and run f64
        PCG over the fine operator. Returns (x [6, Npad] f64, iters,
        relative residual).

        Every level is assembled by the scatter-free grid pipeline
        (``assemble_df(method="grid")``) from each system's own
        coordinates, at every mesh size: every sum there has one order, so
        two calls give the same operator bit for bit, as the JAX package's
        deterministic scatter does. (``index_add_`` on CUDA sums colliding
        slots in no fixed order.) ``coords_list`` and ``tables_list``, the
        JAX signature's traced arguments, are not used."""
        if arith != "f64":
            raise ValueError(f"arith={arith!r}: the port runs arith='f64'")
        levels32 = []
        fine64 = prev64 = None
        for l, sys_l in enumerate(self._systems):
            base = self.levels[l]
            if l > 0 and self.coarse_op == "galerkin":
                prev = self.levels[l - 1]
                v64 = stencil_rap(prev64, base.free_t, prev.offsets, prev.nyp, prev.nxp,
                                  base.npad).reshape(36, len(base.offsets), base.npad)
                diag = soa_diagonal(v64, offsets=base.offsets)
            else:
                v64, diag = sys_l.assemble_df(strip_nodes=self._df_strip_nodes, method="grid",
                                              with_diag=True)
            prev64 = v64
            if l == 0:
                fine64 = v64
            inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
            lvl = dataclasses.replace(
                base,
                values=v64.to(torch.float32),
                free_t=base.free_t.to(torch.float32),
                inv_diag=inv_diag.to(torch.float32),
            )
            if l == self.n_levels - 1:
                dense = _densify(dataclasses.replace(lvl, values=v64))
                d = torch.diagonal(dense)
                s = torch.where(d > 0, 1.0 / torch.sqrt(d), torch.ones_like(d))
                scaled = (dense * s[None, :] * s[:, None]).to(torch.float32)
                lvl = dataclasses.replace(
                    lvl,
                    chol=torch.linalg.cholesky(scaled),
                    chol_scale=s.to(torch.float32),
                )
            else:
                lam = self._power_lambda(lvl)
                lvl = dataclasses.replace(
                    lvl, omega=torch.clamp(4.0 / (3.0 * lam), 0.2, 1.0), lam=lam
                )
            levels32.append(lvl)
            del v64
        del prev64

        fine = levels32[0]
        b64 = forces_t * self.levels[0].free_t

        def mv64(x):
            return stencil_spmv(fine64, x, fine.offsets)

        def prec64(r):
            return self._vcycle(levels32, 0, r.to(torch.float32)).to(torch.float64)

        res = pcg(mv64, b64, rtol=rtol, maxiter=maxiter, apply_prec=prec64,
                  flexible=self.cycle == "K")
        return res.x, res.iters, res.residual

    def solve_fused(self, forces, rtol: float = 1e-9, maxiter: int = 400, arith: str = "f64"):
        """Assembly + preconditioner setup + f64 PCG in one call. ``forces``
        is [n_nodes, 6] (numpy or tensor). Returns the displacements as an
        f64 tensor [n_nodes, 6] on the system's device; ``last_iters`` and
        ``last_residual`` hold the CG iteration count and final relative
        residual. ``arith='df'`` is the TPU's two-float32 CG: native f64
        replaces it on a GPU, so it is refused."""
        if arith == "df":
            raise ValueError(
                "arith='df' (two-float32 CG) exists because TPU f64 is emulated; "
                "on this device native f64 replaces it: use arith='f64'"
            )
        if self.dtype != torch.float64:
            raise ValueError("solve_fused assembles levels in f64: construct "
                             "MultigridShellSystem(..., dtype=torch.float64, assemble=False)")
        lvl = self._fine
        n = lvl.nyp * lvl.nxp
        f = torch.as_tensor(forces, dtype=torch.float64, device=self.device)
        f_t = torch.zeros((6, lvl.npad), dtype=torch.float64, device=self.device)
        f_t[:, :n] = f.T
        coords = [s.coords for s in self._systems]
        tables = [s._tables for s in self._systems]
        x64, iters, res = self._fused_impl(coords, tables, f_t, rtol, maxiter, arith)
        self.last_iters = int(iters)
        self.last_residual = float(res)
        return x64[:, :n].T.contiguous()

    def _require_levels(self, what: str):
        if self.df_operator:
            raise ValueError(f"{what} on f64 or f32 levels: df_operator=True systems solve with "
                             "solve_df / solve_df_refined")
        if self.levels[0].values is None:
            raise ValueError(f"{what} needs assembled levels: construct with assemble=True "
                             "(the default) or call reassemble()")

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 2000):
        """PCG in the levels' dtype to ``rtol`` over the fine operator,
        preconditioned by the V-cycle on the same levels (the JAX package's
        ``solve``): on f64 levels every matvec is ``stencil_spmv`` in f64
        and the coarsest solve the uploaded host inverse; on f32 levels all
        of it is f32, the coarsest solve the f32 Cholesky factor.
        ``forces`` is host [n, 6] or a staged [6, npad] tensor. Returns the
        displacements [n_nodes, 6] in the levels' dtype on the device; sets
        ``last_cg`` (``CGResult``, x in the [6, npad] layout). Nothing syncs
        the device but the CG's norm reads."""
        self._require_levels("solve")
        fine = self.levels[0]
        b = self._staged_forces(forces).to(self.dtype) * fine.free_t

        def mv(x):
            return stencil_spmv(fine.values, x, fine.offsets)

        def prec(r):
            return self._vcycle(self.levels, 0, r)

        res = pcg(mv, b, rtol=rtol, maxiter=maxiter, apply_prec=prec, flexible=self.cycle == "K")
        self.last_cg = res
        return self._out(res.x, False)

    def _ensure_f32_levels(self):
        """f32 copies of the f64 levels for ``solve_df``'s V-cycle, made once
        per (re)assembly. The coarsest level keeps its f64 inverse."""
        if self._levels32 is not None:
            return
        f32 = torch.float32
        self._levels32 = [
            dataclasses.replace(
                l, values=l.values.to(f32), free_t=l.free_t.to(f32), inv_diag=l.inv_diag.to(f32),
                omega=None if l.omega is None else l.omega.to(f32),
                lam=None if l.lam is None else l.lam.to(f32),
            )
            for l in self.levels
        ]

    # ------------------------------------------------------------------
    # df_operator solves: f64 PCG over the fine operator (the JAX
    # package's df CG, in native f64), preconditioned by the f32 V-cycle,
    # or with df_cycle by the f64 one (the JAX package's df-valued cycle)
    def _prec(self, r):
        if self.df_cycle:
            return self._vcycle(self.levels, 0, r)
        return self._vcycle(self.levels, 0, r.to(torch.float32)).to(torch.float64)

    def _inner_solve(self, b, rtol: float, maxiter: int):
        """MG-preconditioned f64 PCG on A x = b (the initial solve and every
        refinement correction): the class operator, or the materialized
        f64 fine operator. Returns (x [6, Npad] f64, iters, residual)."""
        if self._cdf is not None:
            cp = self._cdf

            def mv(x):
                return class_matvec_f64(cp, x)
        else:
            fine64, sym, offsets = self._fine64, self._fine_sym, self.levels[0].offsets

            def mv(x):
                if sym is not None:
                    return stencil_spmv_sym(sym, x, offsets)
                return stencil_spmv(fine64, x, offsets)

        res = pcg(mv, b, rtol=rtol, maxiter=maxiter, apply_prec=self._prec,
                  flexible=self.cycle == "K")
        return res.x, res.iters, res.residual

    def _refine_residual(self, x, b):
        """True residual r = b - A64 x - E x and its relative norm, E on x
        rounded to f32 (as the JAX package evaluates it). Class path: A64
        is the f64 class operator. Pair path: A64 is the class-consistent
        materialized operator, its term compensated (``stencil_resid_dd``,
        the JAX package's tf residual), E its class table."""
        if self._cdf is not None:
            return class_residual(self._cdf, x, b)
        r = stencil_resid_dd(self._fine64, x, b, self.levels[0].offsets)
        e = pair_ecorr(self._ecorr, x.to(torch.float32))
        r = r - e.to(torch.float64)
        return r, torch.sqrt(torch.sum(r * r)) / torch.sqrt(torch.sum(b * b))

    def _ensure_exact_stencil(self):
        """Host, once per system (kept across ``reassemble``, as in the JAX
        package): the longdouble class tables of the fine grid, their flat
        (t0, t1) tables and the E term of the pair path. Raises ValueError
        where ``build_exact_stencil`` refuses the grid."""
        if self._pair_tabs is not None:
            return
        if self._exact_st is None:
            self._exact_st = build_exact_stencil(self._fine_mesh, self.material,
                                                 self.levels[0].offsets, grid=self.grid)
        tfl0, tfl1, _, cls = class_flat_tables(self._exact_st)
        self._ecorr = build_pair_ecorr(self._exact_st, device=self.device)
        self._pair_tabs = (tfl0, tfl1, cls)

    def _ensure_class_pair(self):
        """Replace the assembled fine operator with the class-consistent
        one generated from the class tables (the same physics, rounded
        per class): the refinement correction E = A_true - A64 is then a
        class table. The old operator, its f32 level-0 values and its
        upper half are released first (two fine operators never
        coexist); level 0 takes the f32 t0 values (with df_cycle the
        f64 operator itself) and their Jacobi diagonal, keeps its damping,
        and the upper half is rebuilt."""
        if self._class_pair_done:
            return
        self._ensure_exact_stencil()
        lvl = dataclasses.replace(self.levels[0], values=None)
        self.levels[0] = self._fine = lvl
        self._fine64 = self._fine_sym = None
        a64, hi = class_pair_flat(*self._pair_tabs, lvl.npad, device=self.device)
        if self.df_cycle:  # the f64 cycle smooths on the f64 operator itself
            hi = a64
        diag = soa_diagonal(hi, offsets=lvl.offsets)
        self._fine64 = a64
        self.levels[0] = self._fine = dataclasses.replace(
            lvl, values=hi, inv_diag=torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)))
        self._class_pair_done = True
        self._build_fine_sym()

    def stage_forces(self, forces):
        """Upload a host [n, 6] force field once; returns the [6, npad] f64
        device tensor that solve_df / solve_df_refined accept in place of
        host forces."""
        fine = self._fine
        n = fine.nyp * fine.nxp
        f = torch.zeros((6, fine.npad), dtype=torch.float64, device=self.device)
        f[:, :n] = torch.as_tensor(forces, dtype=torch.float64).to(self.device).T
        return f

    def _staged_forces(self, forces):
        """Pass a staged [6, npad] tensor through; stage anything else."""
        if isinstance(forces, torch.Tensor) and tuple(forces.shape) == (6, self._fine.npad):
            return forces.to(self.device, torch.float64)
        return self.stage_forces(forces)

    def fetch_solution(self, x_t):
        """Host (numpy) [n, 6] copy of a device-resident [6, npad] solution."""
        fine = self._fine
        return x_t[:, : fine.nyp * fine.nxp].T.contiguous().cpu().numpy()

    def _out(self, x, return_device: bool):
        if return_device:
            return x
        fine = self._fine
        return x[:, : fine.nyp * fine.nxp].T.contiguous()

    def solve_df(self, forces, rtol: float = 1e-9, maxiter: int = 2000,
                 return_device: bool = False):
        """f64 PCG to ``rtol`` over the fine operator, preconditioned by the
        f32 V-cycle: the df_operator levels, f32 copies of the f64 levels
        (the JAX package's df CG over f64 levels, in native f64), or the
        f32 levels themselves, whose f32 fine values the CG reads through
        ``stencil_spmv_f32v`` (the JAX package's ``_solve_df_impl_f32``);
        with ``df_cycle`` by the f64 cycle on the f64 levels (the CG
        matvec from the fine operator's upper half where ``sym_spmv``).
        ``forces`` is host [n, 6] or a staged [6, npad] tensor. Returns the
        displacements as an f64 tensor [n_nodes, 6] on the device, or with
        ``return_device`` the [6, npad] solution vector; ``last_iters`` and
        ``last_residual`` hold the CG count and relative residual."""
        if not self.df_operator:
            # the f64 CG over the fine operator, the V-cycle on f32 levels:
            # f64 levels and their f32 copies (the JAX package's
            # _solve_df_impl, whose df CG native f64 replaces), or the f32
            # levels and their own fine values (_solve_df_impl_f32)
            self._require_levels("solve_df")
            fine = self.levels[0]
            if self.dtype == torch.float32:
                levels32 = self.levels

                def mv(x):
                    return stencil_spmv_f32v(fine.values, x, fine.offsets)
            else:
                self._ensure_f32_levels()
                levels32 = self._levels32

                def mv(x):
                    return stencil_spmv(fine.values, x, fine.offsets)
            b = self._staged_forces(forces) * fine.free_t.to(torch.float64)

            def prec32(r):
                return self._vcycle(levels32, 0, r.to(torch.float32)).to(torch.float64)

            res = pcg(mv, b, rtol=rtol, maxiter=maxiter, apply_prec=prec32, flexible=self.cycle == "K")
            x, it, res = res.x, res.iters, res.residual
        else:
            b = self._staged_forces(forces) * self._systems[0].free_t
            x, it, res = self._inner_solve(b, rtol, maxiter)
        self.last_iters = int(it)
        self.last_residual = float(res)
        return self._out(x, return_device)

    def solve_df_refined(self, forces, rtol: float = 1e-9, maxiter: int = 600,
                         n_refine: int = 6, inner_rtol: float = 1e-5,
                         inner_maxiter: int = 200, return_device: bool = False):
        """MG-preconditioned f64 CG plus iterative refinement against the
        longdouble class tables: drive the TRUE residual ||b - A x|| /
        ||b|| (A = A64 + E) toward ``rtol``. On the pair path the fine
        operator is first swapped for the class-consistent one
        (``_ensure_class_pair``; ValueError on a grid
        ``build_exact_stencil`` refuses). Inner solves run to
        ``inner_rtol``; the loop stops at ``rtol``, on a non-finite
        residual, or when a pass improves the residual by less than 10x
        (the representation floor of x). Native f64 puts that floor at
        ~kappa * eps53 instead of the JAX package's df eps49, so the
        history runs longer and lower. Sets ``last_iters`` (all inner
        iterations), ``last_residual``, ``refine_history`` (true residual
        per pass) and ``refine_inner_iters`` (iterations per inner solve).
        Returns as ``solve_df``."""
        if not self.df_operator:
            raise ValueError("solve_df_refined requires df_operator=True")
        if self._cdf is None:
            self._ensure_class_pair()
        b = self._staged_forces(forces) * self._systems[0].free_t
        x, it0, _ = self._inner_solve(b, inner_rtol, maxiter)
        inner = [int(it0)]
        hist = []
        for _ in range(n_refine):
            r, rn = self._refine_residual(x, b)
            rn = float(rn)
            hist.append(rn)
            if rn < rtol or not np.isfinite(rn):
                break
            # a healthy pass with inner_rtol=1e-5 contracts the true
            # residual by orders of magnitude; under 10x is the floor
            if len(hist) > 1 and rn > 0.1 * hist[-2]:
                break
            d, itk, _ = self._inner_solve(r, inner_rtol, inner_maxiter)
            x = x + d
            inner.append(int(itk))
        self.last_iters = sum(inner)
        self.last_residual = hist[-1] if hist else float("nan")
        self.refine_history = hist
        self.refine_inner_iters = inner
        return self._out(x, return_device)

    def reassemble(self, profile: bool = False):
        """Rebuild every level's operator: the class tables from the mesh on
        a class level, f64 assembly on level 0 and on rediscretized levels,
        ``stencil_rap`` of the rebuilt level above on Galerkin levels, then
        the damping and the coarsest factor (``solve_df``'s f32 copies are
        made again). On the pair path the next ``solve_df_refined`` swaps
        the class-consistent operator in again (its host tables are kept).
        A coupled FSI loop calls it when the geometry changes; benchmarks
        time it with the solve. ``profile=True`` prints the wall seconds of
        each stage (each ended by a device synchronize) and keeps them as
        ``rebuild_profile``, a list of (stage, seconds)."""
        prof = _RebuildProf(profile, self.device)
        self._assemble_levels(prof)
        prof.report()
        if profile:
            self.rebuild_profile = list(prof.rows)


def _coarse_inverse(dense: np.ndarray, rcond: float = 1e-12) -> np.ndarray:
    """Host f64 inverse of a symmetric coarsest operator A. With D its
    diagonal and S = D^-1/2 A D^-1/2: where every eigenvalue of S exceeds
    ``rcond`` times the largest, A is regular and this is
    ``np.linalg.inv(A)``, as in the JAX package (S's spectrum spans
    ~1e-3..4 on the plates, 7.6e-5..4 on the roof besides its null
    vector). Otherwise it is the pseudo-inverse D^-1/2 S^+ D^-1/2 without
    those eigenvalues: an exact null space (the Scordelis-Lo roof's rigid
    axial translation, eigenvalue ~1e-15) would have its rounding
    amplified ~1e15-fold into every coarse correction by the inverse
    (ROADMAP.md "Differences"). The inverse is tried first and kept when
    max|S^-1| certifies the spectrum (lambda_min(S) >= 1 / (n max|S^-1|),
    lambda_max(S) <= its largest absolute row sum); only a matrix that
    fails the test pays for the eigendecomposition."""
    d = np.diag(dense)
    s = np.where(d > 0, 1.0 / np.sqrt(np.where(d > 0, d, 1.0)), 1.0)
    scaled = dense * s[:, None] * s[None, :]
    try:
        inv = np.linalg.inv(dense)
    except np.linalg.LinAlgError:  # an exactly singular pivot
        inv = None
    if inv is not None:
        lam_max = np.abs(scaled).sum(axis=1).max()
        if len(d) * np.abs(inv / s[:, None] / s[None, :]).max() * lam_max * rcond < 1.0:
            return inv
    w, v = np.linalg.eigh(scaled)
    keep = np.abs(w) > rcond * np.abs(w).max()
    vk = v[:, keep]
    return ((vk / w[keep]) @ vk.T) * s[:, None] * s[None, :]


def _densify(lvl: _Level) -> torch.Tensor:
    """Dense [6n, 6n] matrix over the REAL nodes of a (small) stencil level;
    padded rows are decoupled identity and stay out of the dense solve.
    Rows and columns are component-major (a*n + i), matching [6, n]
    vectors flattened with reshape(-1)."""
    n = lvl.nyp * lvl.nxp
    k = len(lvl.offsets)
    v = lvl.values.reshape(6, 6, k, lvl.npad)[:, :, :, :n]
    dense = v.new_zeros((6, n, 6, n))
    dev = v.device
    cols = torch.arange(n, device=dev)
    a_idx = torch.arange(6, device=dev)[:, None, None]
    b_idx = torch.arange(6, device=dev)[None, :, None]
    for s, off in enumerate(lvl.offsets):
        tgt = cols + off
        ok = (tgt >= 0) & (tgt < n)
        i, t = cols[ok][None, None, :], tgt[ok][None, None, :]
        dense.index_put_((a_idx, i, b_idx, t), v[:, :, s, :][:, :, ok], accumulate=True)
    return dense.reshape(6 * n, 6 * n)

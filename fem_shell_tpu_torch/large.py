"""LargeShellSystem — the SoA operator of one mesh, in stencil or gather
mode, with its f64 assembly and its own solves. Port of
``fem_shell_tpu/large.py``.

- ``reorder="rcm"`` renumbers the nodes by reverse Cuthill-McKee before
  the operator is built; forces go in and solutions come out in the
  original numbering.
- ``assemble``: the element kernel ``csrc/elem_stiffness.cu`` (its plain
  version on the CPU), the deterministic pass-by-pass scatter of
  ``ops/soa.py`` and Dirichlet elimination, in either mode; two
  assemblies agree bit for bit on any device. ``assemble_df`` picks, on a
  structured grid of at least ``GRID_MIN_ELEMENTS`` elements, the
  scatter-free grid pipeline (``ops/assemble_grid.py``). Native f64 takes
  the place of the JAX package's two-float32 pair, so ``assemble_df``
  returns one f64 operator.
- ``solve``: PCG with Jacobi or 6x6 block-Jacobi (``ops/blockprec.py``);
  the matvec is ``ops/stencil_spmv.stencil_spmv`` in f64 in stencil mode
  and ``ops/soa.soa_matvec`` (PyTorch) in gather mode.
- ``solve_df``: the JAX package's df CG as a native f64 CG on the
  symmetrically diagonal-scaled operator D^-1/2 A D^-1/2 with the identity
  preconditioner.
- ``solve_df_refined``: that CG plus iterative refinement against the
  true residual. The JAX package's correction term E = A64 - (hi + lo) is
  zero here, because the stored operator is A64 itself, so the true
  residual is b - A64 x on the scaled operator, summed in double-double:
  ``ops/stencil_resid.stencil_resid_dd`` (the kernel on the card) in
  stencil mode, ``ops/soa.gather_resid_dd`` (PyTorch) in gather mode. The
  iterate is carried as a double-double x_hi + x_lo, as the JAX package
  carries a df pair, so the loop is not held at the residual of x rounded
  to f64 (~1e-7 of ||b|| on the 1M-DOF plate).

``dtype=torch.float32``: the operator is assembled in f64 as above and
cast to f32 once (one rounding per entry; the JAX package assembles in
f32 on re-centred two-float32 coordinates, ``exact_geom``). The
constructor accepts ``exact_geom`` for the JAX signature and ignores it:
the port's coordinates are f64, so there is nothing to re-centre. The
``dtype`` default stays f64 (the JAX package's is f32),
because an f32 operator is ~kappa eps32 off (4 % at 64^2; ROADMAP.md
"Differences").

- f32 ``solve``: f32 PCG, the matvec ``stencil_spmv`` in f32 (stencil
  mode: the JAX package's Pallas path) or ``soa_matvec`` in f32 (gather
  mode); block-Jacobi factors the self blocks by ``cholesky6`` in the
  system's dtype, as ``ShellSystem`` does in either dtype.
- f32 ``solve_df`` (stencil mode only, as in the JAX package): the f32
  values scaled in f32 by s = rsqrt(diag) (taken in f64, rounded once),
  then the f64 CG whose matvec reads them through
  ``ops/stencil_spmv.stencil_spmv_f32v`` (f32 values, f64 vectors), the
  counterpart of the JAX package's ``df_stencil_matvec_f32v``.
- ``solve_df_refined`` needs the f64 operator and raises on f32.

The strip-df pipeline (``assemble_soa_df``, ``build_strip_plan``,
``free_strip_cache``) has no counterpart, since native f64 needs no
strips (``assemble_df(method="strip")`` is the f64 assembly).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble_grid import assemble_grid
from fem_shell_tpu_torch.ops.blockprec import cholesky6, cholesky6_solve
from fem_shell_tpu_torch.ops.soa import (
    _col_values,
    apply_bc_soa,
    assemble_soa,
    build_soa_pattern,
    gather_resid_dd,
    scatter_passes,
    soa_diagonal,
    soa_matvec,
    soa_self_blocks,
)
from fem_shell_tpu_torch.ops.stencil_resid import stencil_resid_dd
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_f32v
from fem_shell_tpu_torch.solver import pcg, refine

# from this many elements a structured grid is assembled by the grid
# pipeline (assemble_df "auto"), and a multigrid hierarchy over such a
# fine mesh assembles every level that way (mg.py)
GRID_MIN_ELEMENTS = 65536

class LargeShellSystem:
    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        dtype=torch.float64,
        k_max: Optional[int] = None,
        chunk: int = 16384,
        exact_geom: Optional[bool] = None,
        dirichlet_mask: Optional[np.ndarray] = None,
        reorder: Optional[str] = None,
        device=None,
    ):
        """``k_max`` pads the neighbour slots (and forces gather mode when the
        mesh has more distinct offsets). ``dtype`` is the operator's and
        ``solve``'s (float64 or float32; the assembly is f64 either way).
        ``exact_geom`` is accepted for the JAX signature and ignored
        (module docstring). ``dirichlet_mask``
        overrides the mesh's own BC mask (multigrid coarse levels pass
        subsampled fine masks). ``reorder="rcm"`` renumbers the nodes
        first. ``device`` defaults to CUDA; pass ``"cpu"`` to run on the
        host."""
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"LargeShellSystem(dtype={dtype}): torch.float64 or torch.float32")
        self.device = resolve_device(device)
        self._order = None
        if reorder == "rcm":
            from fem_shell_tpu_torch.mesh import permute_nodes, rcm_order

            self._order = rcm_order(mesh)
            if dirichlet_mask is not None:
                dirichlet_mask = np.asarray(dirichlet_mask)[self._order]
            mesh = permute_nodes(mesh, self._order)
        elif reorder is not None:
            raise ValueError(f"unknown reorder {reorder!r} (use 'rcm' or None)")
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        self.chunk = int(chunk)
        dm, dp = material.matrices()
        self.dm = torch.as_tensor(dm, dtype=torch.float64, device=self.device)
        self.dp = torch.as_tensor(dp, dtype=torch.float64, device=self.device)
        self.thickness = material.thickness

        self.pattern = build_soa_pattern(mesh, k_max=k_max)
        p = self.pattern
        self.offsets = p.offsets  # host-side ints (stencil mode) or None
        self.adj_t = None if p.adj_t is None else torch.as_tensor(p.adj_t, dtype=torch.int64,
                                                                  device=self.device)

        free = np.ones((p.n_pad, 6), dtype=np.float64)
        mask = mesh.dirichlet_mask() if dirichlet_mask is None else np.asarray(dirichlet_mask, bool)
        free[: p.n_nodes] = ~mask
        free[p.n_nodes :] = 0.0
        self.free_t = torch.as_tensor(free.T.copy(), dtype=torch.float64, device=self.device)  # [6, Npad]
        self._tables_cache = None
        self._coords_cache = None
        self._passes_cache = None

    @property
    def coords(self):
        if self._coords_cache is None:
            self._coords_cache = torch.as_tensor(self.mesh.coords, dtype=torch.float64, device=self.device)
        return self._coords_cache

    @property
    def _tables(self):
        if self._tables_cache is None:
            def idx(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

            self._tables_cache = {
                "tri_conn": idx(self.mesh.tri),
                "quad_conn": idx(self.mesh.quad),
                "free_t": self.free_t,
                "adj_t": self.adj_t,
            }
        return self._tables_cache

    @property
    def _passes(self):
        """The scatter passes of both families at ``chunk``, on the device;
        built on the host at the first assembly."""
        if self._passes_cache is None:
            def dev(passes):
                return [(torch.as_tensor(src, device=self.device), torch.as_tensor(dest, device=self.device),
                         bounds) for src, dest, bounds in passes]

            p = self.pattern
            self._passes_cache = (dev(scatter_passes(p.tri_slot, self.chunk)),
                                  dev(scatter_passes(p.quad_slot, self.chunk)))
        return self._passes_cache

    def assemble(self, dtype=None):
        """BC-eliminated operator values [36, K, Npad] in ``dtype`` (default
        the system's): the f64 assembly, cast once to f32."""
        tables = self._tables
        tri_passes, quad_passes = self._passes
        values = assemble_soa(self.pattern, self.coords, tables["tri_conn"], tables["quad_conn"], tri_passes,
                              quad_passes, self.dm, self.dp, self.thickness, chunk=self.chunk)
        values = apply_bc_soa(values, tables["free_t"], offsets=self.offsets, adj_t=tables["adj_t"])
        return values.to(dtype or self.dtype)

    @functools.cached_property
    def grid(self):
        """The mesh's structured grid (mg.GridInfo) or None, detected once."""
        from fem_shell_tpu_torch.mg import detect_structured_grid  # mg imports this module

        return detect_structured_grid(self.mesh)

    def assemble_df(self, strip_nodes: int = 65536, method: str = "auto", with_diag: bool = False):
        """BC-eliminated operator values [36, K, Npad] in f64 (and with
        ``with_diag`` the [6, Npad] diagonal), the port's counterpart of the
        JAX package's df pair.

        - ``grid``: the scatter-free structured-grid pipeline
          (``ops/assemble_grid.py``), ``max(1, strip_nodes // nxp)`` element
          rows per strip; ValueError off a structured grid.
        - ``strip``: ``assemble()``, before its cast on an f32 system (the
          JAX package's strip-df pipeline is not ported; native f64 needs no
          strips).
        - ``auto``: ``grid`` on a structured grid of at least
          ``GRID_MIN_ELEMENTS`` elements, else ``strip``. The JAX package
          also keeps the CPU on ``strip``, because its CPU compiler
          contracts the two-float32 arithmetic; native f64 has no such
          hazard, so the port does not."""
        if method == "auto":
            n_elem = len(self.mesh.tri) + len(self.mesh.quad)
            method = ("grid" if n_elem >= GRID_MIN_ELEMENTS and self.offsets is not None
                      and self.grid is not None else "strip")
        if method == "grid":
            grid = self.grid
            if grid is None:
                raise ValueError("method='grid' requires a detected structured grid "
                                 "(detect_structured_grid returned None for this mesh)")
            return assemble_grid(grid, self.coords, self.free_t, self.offsets,
                                 self.pattern.n_pad, self.dm, self.dp, self.thickness,
                                 strip_rows=max(1, strip_nodes // grid.nxp), with_diag=with_diag)
        if method != "strip":
            raise ValueError(f"unknown method {method!r}: 'auto', 'grid' or 'strip'")
        values = self.assemble(torch.float64)
        if with_diag:
            return values, soa_diagonal(values, offsets=self.offsets, adj_t=self.adj_t)
        return values

    # ------------------------------------------------------------------
    # solves
    # ------------------------------------------------------------------
    def _matvec(self, values):
        if self.offsets is not None:
            offsets = self.offsets
            return lambda x: stencil_spmv(values, x, offsets)
        adj_t = self.adj_t
        return lambda x: soa_matvec(values, x, adj_t)

    def _forces_in(self, forces) -> torch.Tensor:
        """[6, Npad] f64 device forces in the system's numbering, zero on
        the padding and the constrained dofs."""
        f = torch.as_tensor(forces, dtype=torch.float64).to(self.device)
        if self._order is not None:
            f = f[torch.as_tensor(self._order, device=self.device)]
        p = self.pattern
        out = torch.zeros((6, p.n_pad), dtype=torch.float64, device=self.device)
        out[:, : p.n_nodes] = f.T
        return out * self.free_t

    def _solution_out(self, x_t) -> torch.Tensor:
        """[n_nodes, 6] of a [6, Npad] vector, in the original numbering."""
        return self.original_order(x_t[:, : self.pattern.n_nodes].T)

    def original_order(self, u) -> torch.Tensor:
        """A node-major [n_nodes, 6] field of the system's numbering in the
        mesh's original numbering (the field itself without reordering)."""
        if self._order is None:
            return u.contiguous()
        out = torch.empty_like(u)
        out[torch.as_tensor(self._order, device=u.device)] = u
        return out

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 20000, precond: str = "jacobi"):
        """Assemble, then PCG in ``dtype`` to ``rtol`` with ``precond``
        "jacobi" or "block_jacobi" (the 6x6 self blocks, Cholesky-factored
        once in ``dtype``). Returns the displacements [n_nodes, 6] in ``dtype``
        on the device in the original numbering; sets ``last_cg``."""
        values = self.assemble()
        b = self._forces_in(forces).to(self.dtype)
        if precond == "block_jacobi":
            l_blocks = cholesky6(soa_self_blocks(values, offsets=self.offsets, adj_t=self.adj_t))

            def apply_prec(r):
                return cholesky6_solve(l_blocks, r.T).T.contiguous()
            res = pcg(self._matvec(values), b, rtol=rtol, maxiter=maxiter, apply_prec=apply_prec)
        elif precond == "jacobi":
            diag = soa_diagonal(values, offsets=self.offsets, adj_t=self.adj_t)
            res = pcg(self._matvec(values), b, diag=diag, rtol=rtol, maxiter=maxiter)
        else:
            raise ValueError(f"unknown precond {precond!r}: 'jacobi' or 'block_jacobi'")
        self.last_cg = res
        return self._solution_out(res.x)

    def _scaled(self):
        """(S A S, s): the assembled operator symmetrically scaled by s =
        diag(A)^-1/2 (1 where the diagonal is not positive), rows first,
        as the JAX package scales it, in ``dtype`` (on f32, in f32 as the
        JAX package's ``_solve_df_impl_f32`` scales). On f32, s is rsqrt
        taken in f64 and rounded once: the f32 rsqrt of the card, of the
        CPU and of the JAX package each miss the correctly rounded value in
        a different share of entries, which moves the f32 solve's
        iterations (ROADMAP.md "Differences")."""
        values = self.assemble()
        diag = soa_diagonal(values, offsets=self.offsets, adj_t=self.adj_t)
        s = torch.where(diag > 0, torch.rsqrt(diag.double()).to(diag.dtype), torch.ones_like(diag))  # [6, Npad]
        return self._scale(values, s), s

    def _scale(self, values, s):
        """S A S for values [36, K, Npad] and s [6, Npad], rows first."""
        k, npad = values.shape[1], values.shape[2]
        v4 = values.reshape(6, 6, k, npad) * s[:, None, None, :]
        v4 = v4 * _col_values(s, self.offsets, self.adj_t)[None]
        return v4.reshape(36, k, npad)

    def _cg_identity(self, values, b, rtol, maxiter):
        """f64 CG on the scaled operator with the identity preconditioner
        (the JAX package's pcg_df with unit diagonal, in native f64); f32
        values go through ``stencil_spmv_f32v``."""
        if values.dtype == torch.float32:
            offsets = self.offsets

            def mv(x):
                return stencil_spmv_f32v(values, x, offsets)
        else:
            mv = self._matvec(values)
        return pcg(mv, b, diag=torch.ones_like(b), rtol=rtol, maxiter=maxiter)

    def solve_df(self, forces, rtol: float = 1e-10, maxiter: int = 20000):
        """f64 CG on D^-1/2 A D^-1/2 (D^1/2 u) = D^-1/2 f, the identity as
        preconditioner: Jacobi-PCG in exact arithmetic. On an f32 system
        (stencil mode only, as in the JAX package) the scaled operator is
        f32 and the CG f64. Sets ``last_iters`` and ``last_residual``;
        returns the f64 displacements as ``solve`` returns its."""
        if self.dtype == torch.float32 and self.offsets is None:
            raise NotImplementedError("f32 df solves require stencil mode (the JAX package's "
                                      "_solve_df_impl_f32 is stencil-only)")
        values, s = self._scaled()
        s = s.to(torch.float64)
        b = self._forces_in(forces) * s
        res = self._cg_identity(values, b, rtol, maxiter)
        self.last_iters = int(res.iters)
        self.last_residual = float(res.residual)
        return self._solution_out(res.x * s)

    def _true_residual(self, values, b):
        """r(x_hi, x_lo) = b - A (x_hi + x_lo) on the scaled operator: the
        term of x_hi compensated, that of x_lo (~eps |x_hi|) in f64."""
        mv = self._matvec(values)
        if self.offsets is not None:
            offsets = self.offsets
            return lambda x_hi, x_lo: stencil_resid_dd(values, x_hi, b, offsets) - mv(x_lo)
        adj_t = self.adj_t
        return lambda x_hi, x_lo: gather_resid_dd(values, x_hi, b, adj_t) - mv(x_lo)

    def solve_df_refined(self, forces, rtol: float = 1e-9, n_refine: int = 6, inner_rtol: float = 1e-5,
                         inner_maxiter: int = 20000, verbose: bool = False):
        """``solve_df``'s CG to ``inner_rtol`` plus iterative refinement on
        the true residual (module docstring; ``solver.refine``), on any
        mesh. Sets ``last_iters`` (all inner iterations), ``last_residual``,
        ``refine_history`` (true residual per pass) and
        ``refine_inner_iters``; returns as ``solve``. Needs the f64
        operator: an f32 system raises, as the JAX package's does."""
        if self.dtype != torch.float64:
            raise ValueError("solve_df_refined needs the f64 operator: construct "
                             "LargeShellSystem(..., dtype=torch.float64)")
        values, s = self._scaled()
        b = self._forces_in(forces) * s
        out = refine(lambda rhs, tol, it: self._cg_identity(values, rhs, tol, it), self._true_residual(values, b),
                     b, rtol, n_refine, inner_rtol, inner_maxiter, verbose)
        self.last_iters = sum(out.inner_iters)
        self.last_residual = out.history[-1] if out.history else float("nan")
        self.refine_history = out.history
        self.refine_inner_iters = out.inner_iters
        return self._solution_out(out.x * s)

"""ShellSystem — the stand-alone solver on any flat-shell mesh (block-ELL
operator, symmetric Dirichlet elimination, 6x6 block-Jacobi or Jacobi
PCG, dense direct solve), in f64 or f32, with the differentiable solve.
Port of ``fem_shell_tpu/system.py``.

The JAX package traces assembly and solve as one jitted program; here
they run eagerly. Assembly is ``ops/assemble.py``: the element kernel
(``csrc/elem_stiffness.cu`` on the card) once per element family present,
then the deterministic contributor-table scatter, so two assemblies agree
bit for bit on any device. PCG is ``solver.pcg`` (the residual norm read
on the host every iteration).

- ``dtype=torch.float32``: the operator is assembled in f64 (coordinates,
  material and element kernel all f64) and cast to f32 once, one rounding
  per entry; block-Jacobi, PCG and the dense solve then run in f32. The
  JAX f32 system runs the element math in f32, so its operator carries
  the f32 element error besides (ROADMAP.md "Differences").
- ``_solve_pcg_impl(..., differentiable=True)`` is the JAX
  ``lax.custom_linear_solve`` as a ``torch.autograd.Function``
  (``_AdjointSolve``): the forward is the assembly and PCG, the backward
  solves K lam = g with the same PCG (K is symmetric), and returns lam on
  the free dofs for the loads and ``ops/assemble.coords_gradient`` for the
  coordinates.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble import (
    BlockEllMatrix,
    apply_dirichlet_to_ell,
    build_ell_pattern,
    constrained_rhs,
    contributor_table,
    coords_gradient,
    corner_table,
    element_stiffnesses,
    scatter_to_ell,
)
from fem_shell_tpu_torch.ops.blockprec import cholesky6, cholesky6_solve
from fem_shell_tpu_torch.solver import CGResult, dense_solve, pcg


class _AdjointSolve(torch.autograd.Function):
    """x = K(coords)^-1 (forces * free) with K already assembled at coords:
    the forward is PCG, the backward the adjoint PCG on the incoming
    gradient with the same operator, tolerance and preconditioner."""

    @staticmethod
    def forward(ctx, coords, forces, system, a, apply_prec, rtol, maxiter):
        b = forces * system.free_mask
        x = pcg(a.matvec, b, rtol=rtol, maxiter=maxiter, apply_prec=apply_prec).x
        ctx.system, ctx.a, ctx.apply_prec = system, a, apply_prec
        ctx.rtol, ctx.maxiter = rtol, maxiter
        ctx.save_for_backward(coords, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        coords, x = ctx.saved_tensors
        s = ctx.system
        res = pcg(ctx.a.matvec, gx.contiguous(), rtol=ctx.rtol, maxiter=ctx.maxiter,
                  apply_prec=ctx.apply_prec)
        s.last_adjoint_cg = res
        lam = res.x * s.free_mask
        grad_coords = grad_forces = None
        if ctx.needs_input_grad[0]:
            grad_coords = coords_gradient(coords.detach().to(torch.float64), s.tri_conn, s.quad_conn,
                                          s.dm, s.dp, s.thickness, lam, x * s.free_mask,
                                          s._corners).to(coords.dtype)
        if ctx.needs_input_grad[1]:
            grad_forces = lam
        return grad_coords, grad_forces, None, None, None, None, None


class ShellSystem:
    """Linear-elastic flat-shell system on one device.

    Usage::

        sys = ShellSystem(mesh, Material(nu=0.3, em=1e7, thickness=0.5))
        u = sys.solve(forces)          # [N,6] displacements (+ rotations)
    """

    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        dtype=torch.float64,
        k_max: Optional[int] = None,
        device=None,
    ):
        """``dtype`` is the operator's and the solve's (float64 or
        float32); coordinates, material matrices and element stiffnesses
        stay f64. ``device`` defaults to CUDA; pass ``"cpu"`` to run on the
        host."""
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"ShellSystem(dtype={dtype}): torch.float64 or torch.float32")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        dm, dp = material.matrices()
        self.dm = torch.as_tensor(dm, dtype=torch.float64, device=self.device)
        self.dp = torch.as_tensor(dp, dtype=torch.float64, device=self.device)
        self.thickness = material.thickness

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=self.device)
        self.tri_conn = idx(mesh.tri)
        self.quad_conn = idx(mesh.quad)
        self.pattern = build_ell_pattern(mesh, k_max=k_max)
        self.adj = idx(self.pattern.adj)
        self._contrib = idx(contributor_table(self.pattern))
        free = ~mesh.dirichlet_mask()
        self.free_mask = torch.as_tensor(free, dtype=dtype, device=self.device)

    @functools.cached_property
    def _corners(self):
        """The nodal-sum table of the coordinate gradient (``corner_table``
        of the Tri-3 then Quad-4 corners), built at the first backward."""
        flat = np.concatenate([np.asarray(self.mesh.tri).ravel(), np.asarray(self.mesh.quad).ravel()])
        return torch.as_tensor(corner_table(flat, self.mesh.n_nodes), device=self.device)

    # ------------------------------------------------------------------
    def _assemble_at(self, coords) -> BlockEllMatrix:
        """The BC-constrained operator at node coordinates ``coords`` [N, 3]:
        assembled and eliminated in f64, then cast to ``dtype`` once."""
        coords = coords.detach().to(self.device, torch.float64).contiguous()
        ke_tri, ke_quad = element_stiffnesses(coords, self.tri_conn, self.quad_conn,
                                              self.dm, self.dp, self.thickness)
        n, k = self.pattern.adj.shape
        blocks = scatter_to_ell(ke_tri, ke_quad, n, k, self._contrib)
        del ke_tri, ke_quad
        blocks = apply_dirichlet_to_ell(blocks, self.adj, self.free_mask.to(torch.float64))
        return BlockEllMatrix(blocks.to(self.dtype), self.adj)

    def assemble(self) -> BlockEllMatrix:
        """Assembled, BC-constrained block-ELL operator in ``dtype``."""
        return self._assemble_at(self.coords)

    def _preconditioner(self, a: BlockEllMatrix, precond: str):
        if precond == "block_jacobi":
            # the 6x6 node-diagonal blocks, factored once: far stronger than
            # scalar Jacobi for the badly scaled shell operator (drilling
            # dofs are ~1000x softer than bending dofs by construction)
            l_blocks = cholesky6(a.diagonal_blocks())
            return lambda r: cholesky6_solve(l_blocks, r)
        if precond == "jacobi":
            diag = a.diagonal()
            inv_diag = torch.where(diag != 0, 1.0 / diag, 1.0)
            return lambda r: inv_diag * r
        raise ValueError(f"unknown precond {precond!r}: 'block_jacobi' or 'jacobi'")

    # ------------------------------------------------------------------
    def _solve_pcg_impl(self, coords, forces, rtol, maxiter, precond="block_jacobi",
                        differentiable=False) -> Tuple[torch.Tensor, CGResult]:
        """Assemble at ``coords`` [N, 3] and PCG-solve for ``forces`` [N, 6]
        (tensors on the system's device); returns (x [N, 6] in ``dtype``,
        ``CGResult``), the JAX signature. With ``differentiable=True`` x is
        differentiable in coords and forces (``_AdjointSolve``); as in the
        JAX package the iteration count is then -1 and the residual is
        recomputed with one more matvec. Without it, an input that requires
        grad raises: autograd through every CG iteration is not the
        gradient (the JAX ``while_loop`` is not reverse-differentiable)."""
        a = self._assemble_at(coords)
        apply_prec = self._preconditioner(a, precond)
        forces = torch.as_tensor(forces).to(self.device, self.dtype)
        if not differentiable:
            if torch.is_grad_enabled() and (coords.requires_grad or forces.requires_grad):
                raise ValueError("inputs require grad: pass differentiable=True for the adjoint gradient")
            res = pcg(a.matvec, constrained_rhs(forces, self.free_mask), rtol=rtol, maxiter=maxiter,
                      apply_prec=apply_prec)
            return res.x, res
        x = _AdjointSolve.apply(coords, forces, self, a, apply_prec, rtol, maxiter)
        with torch.no_grad():
            b = constrained_rhs(forces, self.free_mask)
            r = b - a.matvec(x)
            rel = float(torch.sqrt(torch.sum(r * r))) / max(float(torch.sqrt(torch.sum(b * b))), 1e-300)
        return x, CGResult(x, -1, rel)

    def solve(
        self,
        forces,
        method: str = "pcg",
        rtol: float = 1e-12,
        maxiter: int = 20000,
        precond: str = "block_jacobi",
        differentiable: bool = False,
    ) -> torch.Tensor:
        """Solve K u = f. ``forces``: [N, 6] nodal loads (numpy or tensor).
        Returns the displacements [N, 6] in ``dtype`` on the system's
        device; a ``pcg`` solve sets ``last_cg`` (``CGResult``).
        ``differentiable=True`` solves through ``_solve_pcg_impl`` at
        ``self.coords``: the result is differentiable in ``forces`` (a
        tensor that requires grad)."""
        if method == "dense":
            if differentiable:
                raise ValueError("the differentiable solve is method='pcg'")
            b = constrained_rhs(torch.as_tensor(forces, dtype=self.dtype).to(self.device), self.free_mask)
            return dense_solve(self.assemble().to_dense(), b.reshape(-1)).reshape(self.mesh.n_nodes, 6)
        if method != "pcg":
            raise ValueError(f"unknown method {method!r}: 'pcg' or 'dense'")
        x, self.last_cg = self._solve_pcg_impl(self.coords, forces, rtol, maxiter, precond, differentiable)
        return x

    # ------------------------------------------------------------------
    def make_repeat_solver(self, rtol: float = 1e-10, maxiter: int = 20000,
                           precond: str = "block_jacobi"):
        """For repeated solves with FIXED geometry (a coupling loop
        re-solves per coupling iteration): assemble and factor the
        preconditioner once, return ``forces [N, 6] -> (u [N, 6], iters,
        residual)``."""
        a = self.assemble()
        apply_prec = self._preconditioner(a, precond)

        def solve(forces):
            b = constrained_rhs(torch.as_tensor(forces, dtype=self.dtype).to(self.device), self.free_mask)
            res = pcg(a.matvec, b, rtol=rtol, maxiter=maxiter, apply_prec=apply_prec)
            return res.x, res.iters, res.residual

        return solve

    # ------------------------------------------------------------------
    def solution_vector(self, u) -> np.ndarray:
        """Flat [6N] solution ordered like the reference's
        build_solution_vector (6 values per node; fem-shell.cpp:163-169)."""
        if isinstance(u, torch.Tensor):
            u = u.detach().cpu().numpy()
        return np.asarray(u).reshape(-1)

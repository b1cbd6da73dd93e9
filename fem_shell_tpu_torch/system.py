"""ShellSystem — the stand-alone solver on any flat-shell mesh (block-ELL
operator, symmetric Dirichlet elimination, 6x6 block-Jacobi or Jacobi
PCG, dense direct solve). Port of ``fem_shell_tpu/system.py``.

The JAX package traces assembly and solve as one jitted program; here
they run eagerly. Assembly is ``ops/assemble.py``: the element kernel
(``csrc/elem_stiffness.cu`` on the card) once per element family present,
then the deterministic contributor-table scatter, so two assemblies agree
bit for bit on any device. PCG is ``solver.pcg`` (the residual norm read
on the host every iteration).

Not ported yet (ROADMAP.md Queue 1): ``dtype=torch.float32`` (the element
kernel exists only in f64) and the differentiable solve, whose coordinate
gradient needs d ke / d xyz, which no kernel computes.
"""
from __future__ import annotations

from typing import Optional

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
    element_stiffnesses,
    scatter_to_ell,
)
from fem_shell_tpu_torch.ops.blockprec import cholesky6, cholesky6_solve
from fem_shell_tpu_torch.solver import dense_solve, pcg

_ROADMAP = "not ported yet (ROADMAP.md, Queue 1)"


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
        """``device`` defaults to CUDA; pass ``"cpu"`` to run on the host."""
        if dtype != torch.float64:
            raise NotImplementedError(
                f"ShellSystem(dtype={dtype}): the element kernel is f64 only; the f32 system is {_ROADMAP}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        dm, dp = material.matrices()
        self.dm = torch.as_tensor(dm, dtype=dtype, device=self.device)
        self.dp = torch.as_tensor(dp, dtype=dtype, device=self.device)
        self.thickness = material.thickness

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.coords = torch.as_tensor(mesh.coords, dtype=dtype, device=self.device)
        self.tri_conn = idx(mesh.tri)
        self.quad_conn = idx(mesh.quad)
        self.pattern = build_ell_pattern(mesh, k_max=k_max)
        self.adj = idx(self.pattern.adj)
        self._contrib = idx(contributor_table(self.pattern))
        self.free_mask = torch.as_tensor(~mesh.dirichlet_mask(), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def assemble(self) -> BlockEllMatrix:
        """Assembled, BC-constrained block-ELL operator."""
        ke_tri, ke_quad = element_stiffnesses(self.coords, self.tri_conn, self.quad_conn,
                                              self.dm, self.dp, self.thickness)
        n, k = self.pattern.adj.shape
        blocks = scatter_to_ell(ke_tri, ke_quad, n, k, self._contrib)
        del ke_tri, ke_quad
        blocks = apply_dirichlet_to_ell(blocks, self.adj, self.free_mask)
        return BlockEllMatrix(blocks, self.adj)

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
        Returns the f64 displacements [N, 6] on the system's device; a
        ``pcg`` solve sets ``last_cg`` (``CGResult``)."""
        if differentiable:
            raise NotImplementedError(
                "the differentiable solve (coordinate gradients need d ke / d xyz, which no "
                f"kernel computes) is {_ROADMAP}")
        if method not in ("pcg", "dense"):
            raise ValueError(f"unknown method {method!r}: 'pcg' or 'dense'")
        b = constrained_rhs(torch.as_tensor(forces, dtype=self.dtype).to(self.device), self.free_mask)
        a = self.assemble()
        if method == "dense":
            return dense_solve(a.to_dense(), b.reshape(-1)).reshape(self.mesh.n_nodes, 6)
        res = pcg(a.matvec, b, rtol=rtol, maxiter=maxiter, apply_prec=self._preconditioner(a, precond))
        self.last_cg = res
        return res.x

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

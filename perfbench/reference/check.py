"""The plain reference that decides ``correct``: the plate's stiffness
worked out again from the mesh and the material, element by element, and
the program's displacements judged against it.

``Operator(plate, material)`` forms every element stiffness with the
frozen element math of ``reference/elements.py`` (f64) and applies the
global stiffness K element by element: (K u) = sum_e P_e^T ke_e P_e u. No
global matrix is assembled, so nothing of the program's layouts, orders
or scatters is shared. The Dirichlet rows are the mesh's constrained dofs:
a constrained dof carries no equation, and its displacement must be 0.

``Operator.compare(u, f)`` gives two numbers, both in the diagonally
scaled units in which every dof kind weighs alike (rows scaled by
s = d^-1/2, d = diag(K)), with r = f - K u on the free rows and, on each
constrained dof c, r_c = d_c u_c (its displacement must be 0):

- ``backward_err``, the normwise backward error of u as a solution of
  the constrained system,

      max_i |s_i r_i| / max_i s_i (|K| |u| + |f|)_i

  (|K| |u| is d_c |u_c| on a constrained row). It measures the residual
  against the size of the terms that cancel in it: an exact solution read
  in f64 gives a few units of f64 rounding (1.1e-16) whatever the mesh's
  size and conditioning; an f32 operator or solve gives f32's (6e-8) or
  worse, and a local error (one dof off, a displacement left on a
  constrained dof) shows at once. On a fine plate |K| |u| outweighs |f| by
  1e9 or more, so an error that is smooth over the plate (a stale or
  scaled field, a solve stopped early) leaves a residual of the size of f
  that this number does not see.
- ``residual``, the scaled residual against the load,

      || s r || / || s f ||   (2-norms; f on the free rows),

  which sees exactly those: a stale, scaled or half-converged field leaves
  a residual that is a fair share of the load. Its floor for an exact
  solution is the f64 rounding of K u, eps |K| |u|, which grows with the
  mesh (1e-6 to 1e-4 at a million dofs).

It imports nothing but torch and the element math beside it.
"""
from __future__ import annotations

import torch

from perfbench.reference.elements import quad_shell_stiffness, tri_shell_stiffness


def material_matrices(nu: float, em: float, thickness: float, device):
    """(Dm, Dp): the plane-stress membrane and plate matrices
    (fem-shell.cpp:273-294)."""
    base = torch.tensor([[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]],
                        dtype=torch.float64, device=device)
    return base * (em / (1.0 - nu * nu)), base * (em * thickness**3 / (12.0 * (1.0 - nu * nu)))


class Operator:
    def __init__(self, plate, material: dict, device, chunk: int = 131072):
        dm, dp = material_matrices(material["nu"], material["em"], material["thickness"], device)
        fn = tri_shell_stiffness if plate.elem == "t" else quad_shell_stiffness
        coords = torch.as_tensor(plate.coords, dtype=torch.float64, device=device)
        conn = torch.as_tensor(plate.conn, dtype=torch.int64, device=device)
        m = conn.shape[1]
        self.n = 6 * plate.n_nodes
        self.free = torch.as_tensor(~plate.fixed.reshape(-1), device=device)
        self.parts = []  # (global dofs [e, 6m], ke [e, 6m, 6m]) per chunk of elements
        diag = torch.zeros(self.n, dtype=torch.float64, device=device)
        for s in range(0, conn.shape[0], chunk):
            c = conn[s:s + chunk]
            dofs = (6 * c[:, :, None] + torch.arange(6, device=device)).reshape(-1, 6 * m)
            ke = fn(coords[c], dm, dp, material["thickness"])
            diag.index_add_(0, dofs.reshape(-1), torch.diagonal(ke, dim1=1, dim2=2).reshape(-1))
            self.parts.append((dofs, ke))
        ok = self.free & (diag > 0)
        self.scale = torch.where(ok, diag.clamp_min(1e-300).rsqrt(), torch.zeros_like(diag))
        self.fixed_root = torch.where(self.free, torch.zeros_like(diag), diag.clamp_min(0).sqrt())

    def apply(self, u: torch.Tensor, absolute: bool = False) -> torch.Tensor:
        """K u of the unconstrained stiffness (|K| |u| with ``absolute``)
        for a flat [6N] f64 vector."""
        y = torch.zeros_like(u)
        src = u.abs() if absolute else u
        for dofs, ke in self.parts:
            k = ke.abs() if absolute else ke
            y.index_add_(0, dofs.reshape(-1), torch.bmm(k, src[dofs][:, :, None]).reshape(-1))
        return y

    def compare(self, u: torch.Tensor, f: torch.Tensor) -> dict:
        """{"backward_err", "residual"} of displacements u [N, 6] under
        forces f [N, 6] (both on this operator's device); inf where u is not
        finite."""
        u = u.reshape(-1).to(torch.float64)
        if not bool(torch.isfinite(u).all()):
            return {"backward_err": float("inf"), "residual": float("inf")}
        f = f.reshape(-1).to(torch.float64)
        free = self.free.to(torch.float64)
        uf = u * free
        r = free * (f - self.apply(uf))
        d = free * (self.apply(uf, absolute=True) + f.abs())
        fixed = self.fixed_root * u.abs()  # d_c^1/2 |u_c|: scaled residual and term alike
        num = max(float((self.scale * r).abs().max()), float(fixed.max()))
        den = max(float((self.scale * d).max()), float(fixed.max()))
        load = float(torch.linalg.vector_norm(self.scale * f * free))
        res = float(torch.sqrt(torch.linalg.vector_norm(self.scale * r) ** 2
                               + torch.linalg.vector_norm(fixed) ** 2))
        return {"backward_err": num / den if den > 0 else float("inf"),
                "residual": res / load if load > 0 else float("inf")}

"""The production solver's strip partition — port of
``fem_shell_tpu/parallel/df_shard.py``, in native f64.

The JAX package runs this design in two-float32 ("df") arithmetic,
because f64 is emulated on its TPU: a df operator pair, df vectors whose
hi and lo parts travel together in each halo exchange, and emulated-f64
dots. A GPU has native f64, so here the operator, the vectors, the dots
and the CG are f64:

- ``ShardedDFShellSystem``: ``stencil_shard.ShardedStencilSystem`` in
  f64 (Jacobi-PCG; each matvec one halo exchange of [6, Wp] per
  direction and the ``stencil_spmv<double>`` kernel on the padded
  window);
- ``ShardedMGDFShellSystem``: the f64 CG over the f64 fine operator,
  preconditioned by the row-sharded f32 V-cycle of
  ``mg_shard.ShardedMGShellSystem`` applied to the residual rounded to
  f32 (the JAX ``prec`` applies it to the hi part): the distributed form
  of ``MultigridShellSystem.solve_df``. The fine operator is assembled
  once, in f64; the V-cycle's fine level is it rounded to f32.

``make_df_matvec`` and ``pcg_df_spmd`` keep their JAX names with this f64
meaning. ``split_df_vals``, ``df_matvec_window``, ``halo_exchange_df``
and ``_df_add``/``_df_scale`` have no counterpart: native f64 does their
work.
"""
from __future__ import annotations

import torch

from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.mg import detect_structured_grid
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem, strip_rows, vcycle
from fem_shell_tpu_torch.parallel.sharded import ShardedSystemBase, pcg_spmd
from fem_shell_tpu_torch.parallel.stencil_shard import ShardedStencilSystem, matvec_spmd

# the JAX name of the distributed CG, here in f64
pcg_df_spmd = pcg_spmd


def make_df_matvec(comm, st):
    """The per-iteration f64 matvec closure [6, L] -> [6, L] of a strip
    state, its halo exchange included."""
    if st.vals.dtype != torch.float64:
        raise TypeError(f"the df matvec runs on the f64 operator, got {st.vals.dtype}")
    return lambda x_l: matvec_spmd(comm, st, x_l)


def _solve_mgdf_rank(comm, arg):
    key64, key_mg, b, rtol, maxiter = arg
    st = comm.state[key64]
    mg = comm.state[key_mg]
    b = torch.as_tensor(b, dtype=torch.float64, device=comm.device) * st.free

    def prec(r):
        return vcycle(comm, mg, 0, r.to(torch.float32)).to(torch.float64)

    x, it, res = pcg_df_spmd(comm, make_df_matvec(comm, st), b, prec, rtol, maxiter)
    return x.cpu().numpy(), it, res


class ShardedDFShellSystem(ShardedStencilSystem):
    """Strip-partitioned shell solver on the f64 operator, Jacobi-PCG in
    f64 (the JAX package's df strips)."""

    def __init__(self, mesh, material, device_mesh: DeviceMesh, chunk: int = 8192, l_force=None,
                 dirichlet_mask=None, assemble: bool = True):
        super().__init__(mesh, material, device_mesh, dtype=torch.float64, chunk=chunk, l_force=l_force,
                         dirichlet_mask=dirichlet_mask, assemble=assemble)


class ShardedMGDFShellSystem(ShardedSystemBase):
    """The production solver over ranks: the f64 outer CG over the f64
    fine operator, preconditioned by the row-sharded f32 V-cycle. Per CG
    iteration: one [6, Wp] halo exchange per direction and the per-rank
    ``stencil_spmv<double>``, plus the V-cycle's halo exchanges and
    psum transfers."""

    def __init__(self, mesh, material, device_mesh: DeviceMesh, **kw):
        if isinstance(mesh, MeshGenParams):
            mesh, _, _ = generate(mesh)
        grid = detect_structured_grid(mesh)
        if grid is None:
            raise ValueError("sharded multigrid requires a row-major structured grid mesh")
        self._bind(device_mesh)
        self.mesh = mesh
        # the f64 fine operator is assembled once; the f32 fine level is it
        # rounded on each rank
        self.fine64 = ShardedStencilSystem(mesh, material, device_mesh, dtype=torch.float64,
                                           chunk=kw.get("chunk", 8192),
                                           l_force=strip_rows(grid.nyp, device_mesh.size) * grid.nxp)
        self.mg = ShardedMGShellSystem(mesh, material, device_mesh, dtype=torch.float32, fine_source=self.fine64,
                                       **kw)
        self.n_levels = self.mg.n_levels
        self.n_sharded = self.mg.n_sharded

    def solve_df(self, forces, rtol: float = 1e-9, maxiter: int = 300):
        """forces [N, 6] -> f64 displacements [N, 6] (numpy); sets
        ``last_iters`` and ``last_residual``."""
        parts = self._run_solve(_solve_mgdf_rank, [(self.fine64.key, self.mg.key, b, rtol, maxiter)
                                                   for b in self.fine64.split_forces(forces)])
        return self.fine64.join_solution(parts)

"""Sharded geometric multigrid: mesh-independent iterations on the
halo-exchange path — port of ``fem_shell_tpu/parallel/mg_shard.py``.

- every level fine enough to shard is a row-partitioned strip
  (``stencil_shard.ShardedStencilSystem``; rank s owns grid node rows
  [s*rows_l, (s+1)*rows_l), L_l = rows_l * nxp_l lanes) whose damped
  Jacobi smoother runs the halo-exchange ``stencil_spmv``;
- transfers are computed on each rank's own rows (rows_l is even, so a
  local row's parity is its global parity and the bilinear weights are
  fixed) and combined with one ``psum`` of the coarse level's full
  vector: the boundary rows' contributions of two ranks add in the psum,
  so the level partitions need no alignment;
- levels too narrow for halo strips (L < 2 * ceil(halo, 128)) run
  replicated: every rank smooths the same full coarse grid with the port's
  ``LargeShellSystem`` in stencil mode (its matvec ``stencil_spmv``);
- the coarsest level applies a replicated dense inverse
  (``torch.linalg.inv`` of ``mg._densify``, in f64 on each rank).

The outer solver is PCG with rank-ordered dot products
(``sharded.pcg_spmd``), preconditioned by the V-cycle. Every level is
assembled in f64 and rounded once to ``dtype`` when the system is built.
"""
from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.mg import _grid_conn, _prolong, _restrict, detect_structured_grid
from fem_shell_tpu_torch.ops.soa import _ceil_to
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.sharded import ShardedSystemBase, pcg_spmd
from fem_shell_tpu_torch.parallel.stencil_shard import ShardedStencilSystem, matvec_spmd


def strip_rows(nyp: int, s: int) -> int:
    """Grid rows per rank of a sharded level: ceil(nyp / s) rounded up to
    an even count, so a local row's parity is its global parity."""
    c = -(-nyp // s)
    return c + (c % 2)


class _ShardedLevel:
    """Row-partitioned level: a ShardedStencilSystem over whole grid rows,
    or ``source``'s f64 strips rounded to ``dtype``."""

    def __init__(self, mesh_l, material, device_mesh, dtype, grid_l, mask_l, chunk, source=None):
        s = device_mesh.size
        self.nxp, self.nyp = grid_l.nxp, grid_l.nyp
        self.rows = strip_rows(self.nyp, s)
        self.l = self.rows * self.nxp
        if source is not None:
            if source.l != self.l or source.mesh is not mesh_l:
                raise ValueError("the f64 fine strips must be this level's")
            self.sys = source.rounded(dtype)
        else:
            self.sys = ShardedStencilSystem(mesh_l, material, device_mesh, dtype=dtype, chunk=chunk,
                                            l_force=self.l, dirichlet_mask=mask_l)
        self.n_full = s * self.l  # padded full-vector length


class _ReplicatedLevel:
    """Full-grid level evaluated identically on every rank; built there."""

    def __init__(self, mesh_l, grid_l, mask_l):
        self.nxp, self.nyp = grid_l.nxp, grid_l.nyp
        self.mesh, self.mask = mesh_l, mask_l
        self.npad = _ceil_to(self.nyp * self.nxp, 4096)  # LargeShellSystem's n_pad


# ----------------------------------------------------------------------
# grid-shaped transfer helpers (on [6, rows, nxp] blocks)
# ----------------------------------------------------------------------


def _restrict_cols(g):
    """Bilinear P^T along each grid row: [6, R, 2m-1] -> [6, R, m]."""
    odd = g[:, :, 1::2]
    out = g[:, :, 0::2].clone()
    out[:, :, :-1] += 0.5 * odd
    out[:, :, 1:] += 0.5 * odd
    return out


def _prolong_cols(c):
    """[6, R, m] -> [6, R, 2m-1]."""
    out = c.new_zeros((c.shape[0], c.shape[1], 2 * c.shape[2] - 1))
    out[:, :, 0::2] = c
    out[:, :, 1::2] = 0.5 * (c[:, :, :-1] + c[:, :, 1:])
    return out


def _restrict_rows_local(g):
    """Row-axis P^T on a local block of even length starting at an even
    global row: [6, R, m] -> [6, R//2 + 1, m]; the last coarse row holds
    this rank's share of the neighbour-owned boundary row, merged by the
    psum."""
    even, odd = g[:, 0::2, :], g[:, 1::2, :]
    r2 = odd.shape[1]
    out = g.new_zeros((6, r2 + 1, g.shape[2]))
    out[:, :r2] = even
    out[:, :r2] += 0.5 * odd
    out[:, 1:r2 + 1] += 0.5 * odd
    return out


def _prolong_rows_local(cb, rows):
    """[6, R//2 + 1, m] coarse rows (the shared boundary row included) ->
    [6, R, m] fine rows of this rank."""
    out = cb.new_zeros((6, rows, cb.shape[2]))
    out[:, 0::2] = cb[:, :-1]
    out[:, 1::2] = 0.5 * (cb[:, :-1] + cb[:, 1:])
    return out


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def _build_rank(comm, arg):
    """The rank's view of the hierarchy: the sharded levels' states (built
    by their own systems) and the replicated tail, built here."""
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.mg import _densify, _Level
    from fem_shell_tpu_torch.ops.soa import soa_diagonal

    key, spec = arg
    dtype = spec["dtype"]
    levels = []
    for lv in spec["levels"]:
        if lv["kind"] == "sharded":
            levels.append(types.SimpleNamespace(st=comm.state[lv.pop("key")], **lv))
            continue
        sys_l = LargeShellSystem(lv["mesh"], spec["material"], dtype=dtype, chunk=spec["chunk"],
                                 dirichlet_mask=lv["mask"], device=comm.device)
        values = sys_l.assemble()
        diag = soa_diagonal(values, offsets=sys_l.offsets)
        levels.append(types.SimpleNamespace(
            kind="repl", nxp=lv["nxp"], nyp=lv["nyp"], npad=sys_l.pattern.n_pad, values=values,
            offsets=[int(o) for o in sys_l.offsets], free_t=sys_l.free_t.to(dtype),
            inv_diag=torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)), dense_inv=None))
    last = levels[-1]
    tmp = _Level(values=last.values, offsets=tuple(last.offsets), free_t=last.free_t, inv_diag=last.inv_diag,
                 nyp=last.nyp, nxp=last.nxp, npad=last.npad)
    # on the rank's device with its own threads (a rank's numpy BLAS would
    # start a thread per core in every rank)
    last.dense_inv = torch.linalg.inv(_densify(tmp).to(torch.float64)).to(dtype)
    comm.state[key] = types.SimpleNamespace(levels=levels, omega=spec["omega"], nu=spec["nu_smooth"])


def _smooth_sharded(comm, mg, lvl, x, b):
    for _ in range(mg.nu):
        r = b - matvec_spmd(comm, lvl.st, x)
        x = x + mg.omega * lvl.st.inv_diag * r
    return x


def _smooth_repl(mg, lvl, x, b):
    for _ in range(mg.nu):
        r = b - stencil_spmv(lvl.values, x, lvl.offsets)
        x = x + mg.omega * lvl.inv_diag * r
    return x


def _to_full_coarse(comm, fine, coarse, r_l):
    """Restriction: this rank's fine rows -> the psum'd full coarse vector
    [6, N_c_full], equal on every rank."""
    rows_f, nxp_f = fine.rows, fine.nxp
    nxp_c = (nxp_f + 1) // 2
    cb = _restrict_rows_local(_restrict_cols(r_l.reshape(6, rows_f, nxp_f)))
    n_full = coarse.n_full if coarse.kind == "sharded" else coarse.npad
    pad = (rows_f // 2 + 1) * nxp_c  # the last rank's boundary row may pass the coarse grid
    start = comm.axis_index() * (rows_f // 2) * nxp_c
    full = r_l.new_zeros((6, n_full + pad))
    full[:, start:start + pad] = cb.reshape(6, -1)
    return comm.psum(full[:, :n_full].contiguous())


def _from_full_coarse(comm, fine, coarse_full):
    """Prolongation: the full coarse vector -> this rank's fine rows."""
    rows_f, nxp_f = fine.rows, fine.nxp
    nxp_c = (nxp_f + 1) // 2
    need = (rows_f // 2 + 1) * nxp_c
    start = comm.axis_index() * (rows_f // 2) * nxp_c
    cb = F.pad(coarse_full, (0, need))[:, start:start + need].reshape(6, rows_f // 2 + 1, nxp_c)
    return _prolong_cols(_prolong_rows_local(cb, rows_f)).reshape(6, fine.l)


def _own_to_full(comm, x_l):
    """Every rank's lanes [6, L] -> the full [6, S*L]: the JAX psum of
    zero-padded blocks, whose supports are disjoint, is the gather."""
    return comm.all_gather(x_l.T.contiguous(), tiled=True).T


def vcycle(comm, mg, li: int, b):
    """One V-cycle from level ``li``: b is [6, L] on a sharded level, the
    full [6, npad] on a replicated one."""
    lvl = mg.levels[li]
    if lvl.kind == "repl":
        if lvl.dense_inv is not None:
            n_real = lvl.nyp * lvl.nxp
            flat = (lvl.dense_inv @ b[:, :n_real].reshape(-1)).reshape(6, n_real)
            return F.pad(flat, (0, lvl.npad - n_real)) * lvl.free_t
        x = _smooth_repl(mg, lvl, torch.zeros_like(b), b)
        r = b - stencil_spmv(lvl.values, x, lvl.offsets)
        nxt = mg.levels[li + 1]
        # replicated -> replicated: full-grid transfers
        rc = _restrict(r[:, : lvl.nyp * lvl.nxp].reshape(6, lvl.nyp, lvl.nxp)).reshape(6, -1)
        rc = F.pad(rc, (0, nxt.npad - rc.shape[1])) * nxt.free_t
        ec = vcycle(comm, mg, li + 1, rc)
        e = _prolong(ec[:, : nxt.nyp * nxt.nxp].reshape(6, nxt.nyp, nxt.nxp)).reshape(6, -1)
        x = x + F.pad(e, (0, lvl.npad - e.shape[1])) * lvl.free_t
        return _smooth_repl(mg, lvl, x, b)

    x = _smooth_sharded(comm, mg, lvl, torch.zeros_like(b), b)
    r = b - matvec_spmd(comm, lvl.st, x)
    nxt = mg.levels[li + 1]
    rc_full = _to_full_coarse(comm, lvl, nxt, r)
    if nxt.kind == "sharded":
        i = comm.axis_index()
        rc = rc_full[:, i * nxt.l:(i + 1) * nxt.l] * nxt.st.free
        ec_full = _own_to_full(comm, vcycle(comm, mg, li + 1, rc))
    else:
        ec_full = vcycle(comm, mg, li + 1, rc_full[:, : nxt.npad] * nxt.free_t)
    x = x + _from_full_coarse(comm, lvl, ec_full) * lvl.st.free
    return _smooth_sharded(comm, mg, lvl, x, b)


def _solve_rank(comm, arg):
    key, b, rtol, maxiter = arg
    mg = comm.state[key]
    fine = mg.levels[0].st
    b = torch.as_tensor(b, dtype=fine.vals.dtype, device=comm.device) * fine.free
    x, it, res = pcg_spmd(comm, lambda v: matvec_spmd(comm, fine, v), b, lambda r: vcycle(comm, mg, 0, r),
                          rtol, maxiter)
    return x.cpu().numpy(), it, res


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class ShardedMGShellSystem(ShardedSystemBase):
    """Multi-rank shell solver: halo-sharded fine levels, psum transfers, a
    replicated coarse tail, MG-preconditioned CG.

    ``fine_source``: the fine level's f64 strips, already built on these
    ranks (``l_force`` = the level's strip length); the fine level is then
    their operator rounded to ``dtype``, not a second assembly."""

    def __init__(
        self,
        mesh: Union[ShellMesh, MeshGenParams],
        material: Material,
        device_mesh: DeviceMesh,
        dtype=torch.float32,
        n_levels: Optional[int] = None,
        nu_smooth: int = 2,
        omega: float = 0.7,
        coarse_max: int = 8,
        chunk: int = 8192,
        fine_source: Optional[ShardedStencilSystem] = None,
    ):
        if isinstance(mesh, MeshGenParams):
            mesh, _, _ = generate(mesh)
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"ShardedMGShellSystem(dtype={dtype}): torch.float64 or torch.float32")
        grid = detect_structured_grid(mesh)
        if grid is None:
            raise ValueError("sharded multigrid requires a row-major structured grid mesh")
        self._bind(device_mesh)
        self.mesh = mesh
        self.grid = grid
        self.dtype = dtype
        self.nu_smooth = nu_smooth
        self.omega = omega
        self.chunk = chunk
        s = self.n_shards

        if n_levels is None:
            n_levels = 1
            nx, ny = grid.nxp - 1, grid.nyp - 1
            while nx % 2 == 0 and ny % 2 == 0 and max(nx, ny) > 2 * coarse_max:
                nx //= 2
                ny //= 2
                n_levels += 1
        self.n_levels = n_levels

        coords_g = np.asarray(mesh.coords, np.float64).reshape(grid.nyp, grid.nxp, 3)
        mask_g = mesh.dirichlet_mask().reshape(grid.nyp, grid.nxp, 6)
        self.levels: List = []
        still_sharding = True
        for l in range(n_levels):
            f = 2**l
            if (grid.nxp - 1) % f or (grid.nyp - 1) % f:
                raise ValueError(f"nx/ny not divisible by 2^{l}")
            cg, mg_ = coords_g[::f, ::f], mask_g[::f, ::f]
            nyp_l, nxp_l = cg.shape[0], cg.shape[1]
            grid_l = dataclasses.replace(grid, nxp=nxp_l, nyp=nyp_l)
            types_l, conn_l = _grid_conn(nxp_l, nyp_l, grid.elem_type, grid.ul_lr)
            mesh_l = (mesh if l == 0
                      else ShellMesh(cg.reshape(-1, 3), types_l, conn_l, np.zeros((0, 3), np.int32)))
            l_lanes = strip_rows(nyp_l, s) * nxp_l
            # halo strips need L >= 2 * ceil(halo, 128); narrower levels, and
            # every level below the first of them, are replicated
            w_pad = _ceil_to(nxp_l + 2, 128)
            if still_sharding and l_lanes >= 2 * w_pad and l < n_levels - 1:
                lvl = _ShardedLevel(mesh_l, material, device_mesh, dtype, grid_l, mg_.reshape(-1, 6), chunk,
                                    source=fine_source if l == 0 else None)
                prev = self.levels[-1] if self.levels else None
                if isinstance(prev, _ShardedLevel) and 2 * lvl.rows < prev.rows:
                    raise ValueError("coarse shard rows must cover the fine restriction window")
            else:
                still_sharding = False
                lvl = _ReplicatedLevel(mesh_l, grid_l, mg_.reshape(-1, 6))
            self.levels.append(lvl)
        if not isinstance(self.levels[0], _ShardedLevel):
            raise ValueError("mesh too small to shard the fine level; use MultigridShellSystem")
        if isinstance(self.levels[-1], _ShardedLevel):
            raise ValueError("coarsest level must be replicated (raise coarse_max)")
        self.n_sharded = next(i for i, lv in enumerate(self.levels) if isinstance(lv, _ReplicatedLevel))

        specs = []
        for lv in self.levels:
            if isinstance(lv, _ShardedLevel):
                specs.append({"kind": "sharded", "key": lv.sys.key, "rows": lv.rows, "nxp": lv.nxp,
                              "nyp": lv.nyp, "l": lv.l, "n_full": lv.n_full})
            else:
                specs.append({"kind": "repl", "nxp": lv.nxp, "nyp": lv.nyp, "mesh": lv.mesh, "mask": lv.mask})
        spec = {"levels": specs, "dtype": dtype, "material": material, "chunk": chunk, "omega": omega,
                "nu_smooth": nu_smooth}
        self.device_mesh.run(_build_rank, [(self.key, spec)] * s)

    def solve(self, forces, rtol: float = 1e-8, maxiter: int = 200) -> np.ndarray:
        """MG-preconditioned CG; forces [N, 6] -> displacements [N, 6]
        (numpy, in ``dtype``); sets ``last_iters`` and ``last_residual``."""
        fine = self.levels[0].sys
        parts = self._run_solve(_solve_rank, [(self.key, b, rtol, maxiter) for b in fine.split_forces(forces)])
        return fine.join_solution(parts)

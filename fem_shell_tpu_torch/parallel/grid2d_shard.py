"""2-D process-grid halo-exchange solver for structured shell grids — port
of ``fem_shell_tpu/parallel/grid2d_shard.py``.

The strip partition of ``stencil_shard`` generalised to a ``py x px``
tile partition of a detected row-major structured grid
(``mg.detect_structured_grid``): squarer subdomains cut the halo traffic
per iteration from a full grid row per neighbour to O(ly + lx) per rank.
Rank r = iy * px + ix holds tile (iy, ix).

- the [nyp, nxp] node grid is tiled into [py, px] tiles of [ly, lx] =
  [ceil(nyp / py), ceil(nxp / px)] nodes; pad nodes are fully
  constrained and carry no elements;
- assembly is element-parallel: each element goes to the tile of its
  minimum-corner node and adds its 6x6 blocks pass by pass
  (``sharded.scatter_elements``, the kernel ``csrc/elem_stiffness.cu`` on
  the card) into the halo-1 window [36, 9, ly+2, lx+2], slot = (dy+1)*3 +
  (dx+1); one reverse halo exchange, y first on the x-extended rows and
  then x, carries corner contributions diagonally and adds each in a
  fixed order;
- the matvec exchanges one node ring, x first and then y on the extended
  array (which carries the corners);
- CG scalars are rank-ordered sums over every rank (``psum_scalars``).

The exchanges are point-to-point messages to the four neighbours
(``Comm.ppermute_shift`` with the grid shape); the halos wrap around, which
is harmless because out-of-domain neighbours only multiply identically zero
blocks, as on the strips.

The per-rank product is the ``stencil_spmv`` kernel (``<float>`` or
``<double>`` by dtype) on the values laid out on the flattened haloed
window [36, 9, (ly+2)*(lx+2)], zero on the ring, with offsets dy*(lx+2) +
dx; the interior of its result is kept. ``matvec_plain`` is the JAX
``matvec_spmd``'s 9-slot slice-and-einsum loop, the plain version the
card's check (``check_spmv_tile``) holds it against.

The operator is assembled in f64 and rounded once to ``dtype`` (the JAX
package assembles an f32 system in f32). ``Sharded2DGridDFSystem`` is the
f64 system: the JAX df pair, its ``two_prod`` loop and ``split_df_vals``
have no counterpart, native f64 does their work.
"""
from __future__ import annotations

import copy
import types
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.sharded import (
    ShardedSystemBase,
    material_tensors,
    pcg_spmd,
    scatter_elements,
)
from fem_shell_tpu_torch.parallel.stencil_shard import compare_products

AXY = "ddy"
AXX = "ddx"
# the 9 (dy, dx) slots of a tile's stencil, slot = (dy+1)*3 + (dx+1)
SLOTS = tuple((s // 3 - 1, s % 3 - 1) for s in range(9))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def make_device_mesh2d(py: int, px: int, device=None, backend: Optional[str] = None,
                       ranks: Optional[DeviceMesh] = None) -> DeviceMesh:
    """A ``py x px`` process grid: ``py * px`` new ranks on ``device`` over
    ``backend`` (as ``sharded.make_device_mesh``), or, with ``ranks``, the
    grid laid over that open mesh's ranks (which keeps it until another is
    laid; systems built earlier keep theirs)."""
    py, px = int(py), int(px)
    if py < 1 or px < 1:
        raise ValueError(f"a process grid needs py, px >= 1, got {py}x{px}")
    if ranks is not None:
        if ranks.size != py * px:
            raise ValueError(f"need {py * px} devices, have {ranks.size}")
        mesh = ranks
    else:
        on_cuda = device is None or str(device).startswith("cuda")
        if (backend or ("nccl" if on_cuda else "gloo")) == "nccl" and py * px > torch.cuda.device_count():
            raise ValueError(f"need {py * px} devices, have {torch.cuda.device_count()}")
        mesh = DeviceMesh(py * px, device=device, backend=backend)
    mesh.grid2d = (py, px)
    return mesh


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def halo2d(comm, st, x):
    """x [C, ly, lx] -> [C, ly+2, lx+2]: the x edges first, then the y
    edges of the x-extended array (which carries the corners)."""
    left, right = comm.ppermute_shift(x[:, :, -1:], x[:, :, :1], st.grid, axis=1)
    xe = torch.cat([left, x, right], dim=2)
    top, bot = comm.ppermute_shift(xe[:, -1:, :], xe[:, :1, :], st.grid, axis=0)
    return torch.cat([top, xe, bot], dim=1)


def halo_reduce2d(comm, st, w):
    """Window contributions [C, ly+2, lx+2] -> the core [C, ly, lx] with the
    halo ring's contributions added into the owning neighbours: y first on
    the x-extended rows (the last row, then the first), then x (the last
    column, then the first); the reverse of ``halo2d``."""
    from_above, from_below = comm.ppermute_shift(w[:, -1:, :], w[:, :1, :], st.grid, axis=0)
    wy = w[:, 1:-1, :].clone()
    wy[:, -1:, :] += from_below
    wy[:, :1, :] += from_above
    from_left, from_right = comm.ppermute_shift(wy[:, :, -1:], wy[:, :, :1], st.grid, axis=1)
    core = wy[:, :, 1:-1].clone()
    core[:, :, -1:] += from_right
    core[:, :, :1] += from_left
    return core


def _tile_state(p):
    ly, lx = p["ly"], p["lx"]
    h, wd = ly + 2, lx + 2
    return types.SimpleNamespace(grid=tuple(p["grid"]), ly=ly, lx=lx, h=h, wd=wd,
                                 offsets=[dy * wd + dx for dy, dx in SLOTS])


def assemble_vals_spmd(comm, p):
    """One rank's tile: the BC-constrained f64 operator [6, 6, 9, ly, lx]
    and the free mask [6, ly, lx], then rounded once to p["dtype"] and laid
    out for the kernel (``_set_tile``)."""
    dev, f64 = comm.device, torch.float64
    st = _tile_state(p)
    ly, lx, h, wd = st.ly, st.lx, st.h, st.wd
    iy, ix = divmod(comm.rank, st.grid[1])
    oy0, ox0 = iy * ly, ix * lx
    nxp = p["nxp"]
    coords = torch.as_tensor(p["coords"], dtype=f64, device=dev)
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    win = torch.zeros((36, 9 * h * wd), dtype=f64, device=dev)
    for conn in p["families"]:
        # block (a, b): row node conn[a] at window (ry - oy0 + 1, rx - ox0 + 1),
        # slot of the grid step from conn[a] to conn[b]
        c = np.asarray(conn, np.int64)
        ry, rx = c // nxp, c % nxp
        slot = (ry[:, None, :] - ry[:, :, None] + 1) * 3 + (rx[:, None, :] - rx[:, :, None] + 1)
        wy, wx = (ry - oy0 + 1)[:, :, None], (rx - ox0 + 1)[:, :, None]
        scatter_elements(win, coords, c, (slot * h + wy) * wd + wx, dm, dp, t, chunk=p["chunk"])
    vals = halo_reduce2d(comm, st, win.view(36 * 9, h, wd)).view(6, 6, 9, ly, lx)
    del win

    # BC masking: rows by the local mask, columns by the haloed mask
    free_l = torch.as_tensor(p["free"], dtype=f64, device=dev)  # [6, ly, lx]
    free_ext = halo2d(comm, st, free_l)  # [6, ly+2, lx+2]
    vals.mul_(free_l[:, None, None])
    for s, (dy, dx) in enumerate(SLOTS):
        vals[:, :, s] *= free_ext[None, :, dy + 1:dy + 1 + ly, dx + 1:dx + 1 + lx]
    eye = torch.eye(6, dtype=f64, device=dev)
    vals[:, :, 4] += eye[:, :, None, None] * (1.0 - free_l)[None]
    return _set_tile(st, vals, free_l, p["dtype"])


def _set_tile(st, vals, free_l, dtype):
    """Round the masked f64 tile operator [6, 6, 9, ly, lx] once to
    ``dtype`` into ``st``: the values on the flattened haloed window [36, 9,
    (ly+2)*(lx+2)], zero on the ring, the Jacobi inverse diagonal and the
    free mask [6, ly, lx]."""
    vals = vals.to(dtype)
    diag = torch.diagonal(vals[:, :, 4], dim1=0, dim2=1).permute(2, 0, 1)  # [6, ly, lx]
    st.inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)).contiguous()
    st.vals = torch.zeros((36, 9, st.h, st.wd), dtype=dtype, device=vals.device)
    st.vals[:, :, 1:-1, 1:-1] = vals.reshape(36, 9, st.ly, st.lx)
    st.vals = st.vals.view(36, 9, st.h * st.wd)
    st.free = free_l.to(dtype)
    return st


def matvec_spmd(comm, st, x_l):
    """y = A x on this rank's tile, [6, ly, lx] -> [6, ly, lx]: one 2-D halo
    exchange, then ``stencil_spmv`` on the flattened window, of which the
    interior is kept."""
    x_ext = halo2d(comm, st, x_l).reshape(6, st.h * st.wd)
    return stencil_spmv(st.vals, x_ext, st.offsets).view(6, st.h, st.wd)[:, 1:-1, 1:-1].contiguous()


def matvec_plain(st, x_ext):
    """The JAX ``matvec_spmd``'s 9-slot slice-and-einsum loop on the haloed
    x [6, ly+2, lx+2]: the plain version of the per-rank product."""
    ly, lx = st.ly, st.lx
    v = st.vals.view(6, 6, 9, st.h, st.wd)[..., 1:-1, 1:-1]
    y = torch.zeros((6, ly, lx), dtype=x_ext.dtype, device=x_ext.device)
    for s, (dy, dx) in enumerate(SLOTS):
        y = y + torch.einsum("abyx,byx->ayx", v[:, :, s], x_ext[:, dy + 1:dy + 1 + ly, dx + 1:dx + 1 + lx])
    return y


def check_spmv_tile(comm, arg):
    """A rank command for the card's check, the twin of
    ``stencil_shard.check_spmv_rank``: on the tile state ``key``, the
    per-rank product (``stencil_spmv`` on the flattened window, its
    interior) against ``matvec_plain`` on one seeded haloed x."""
    key, seed, reps = arg
    st = comm.state[key]
    g = torch.Generator().manual_seed(seed + comm.rank)
    x_ext = torch.randn((6, st.h, st.wd), generator=g, dtype=torch.float64)
    x_ext = x_ext.to(device=comm.device, dtype=st.vals.dtype)
    flat = x_ext.reshape(6, -1)
    return compare_products(
        comm, lambda: stencil_spmv(st.vals, flat, st.offsets).view(6, st.h, st.wd)[:, 1:-1, 1:-1],
        lambda: matvec_plain(st, x_ext), reps,
        {"shape": [36, 9, st.h * st.wd], "tile": [st.ly, st.lx], "dtype": str(st.vals.dtype)})


def _build_rank(comm, arg):
    key, p = arg
    comm.state[key] = assemble_vals_spmd(comm, p)


def _round_rank(comm, arg):
    key, src_key, dtype = arg
    src = comm.state[src_key]
    st = types.SimpleNamespace(**{k: getattr(src, k) for k in ("grid", "ly", "lx", "h", "wd", "offsets")})
    core = src.vals.view(6, 6, 9, src.h, src.wd)[..., 1:-1, 1:-1]
    comm.state[key] = _set_tile(st, core, src.free, dtype)


def _solve_rank(comm, arg):
    key, b, rtol, maxiter = arg
    st = comm.state[key]
    b = torch.as_tensor(b, dtype=st.vals.dtype, device=comm.device) * st.free
    x, it, res = pcg_spmd(comm, lambda v: matvec_spmd(comm, st, v), b, lambda r: st.inv_diag * r,
                          rtol, maxiter)
    return x.cpu().numpy(), it, res


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class Sharded2DGridSystem(ShardedSystemBase):
    """Tile-partitioned shell solver with the 2-D halo-exchange stencil
    SpMV, Jacobi-PCG. ``device_mesh`` carries its process grid
    (``make_device_mesh2d``)."""

    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        device_mesh: DeviceMesh,
        dtype=torch.float32,
        chunk: int = 8192,
    ):
        from fem_shell_tpu_torch.mg import detect_structured_grid

        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"{type(self).__name__}(dtype={dtype}): torch.float64 or torch.float32")
        grid = detect_structured_grid(mesh)
        if grid is None:
            raise ValueError(
                "Sharded2DGridSystem requires a detected structured grid; "
                "use parallel.stencil_shard / parallel.sharded for "
                "unstructured meshes"
            )
        if getattr(device_mesh, "grid2d", None) is None:
            raise ValueError(f"device mesh must have axes ({AXY!r}, {AXX!r})")
        self._bind(device_mesh)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        self.grid = grid
        self.py, self.px = device_mesh.grid2d
        py, px = self.py, self.px
        nyp, nxp = grid.nyp, grid.nxp
        self.ly = _ceil_div(nyp, py)
        self.lx = _ceil_div(nxp, px)
        if self.ly < 2 or self.lx < 2:
            raise ValueError(f"tiles too small for halo exchange: {self.ly}x{self.lx}")
        self.nyt = self.ly * py
        self.nxt = self.lx * px
        self.chunk = int(chunk)

        # element partition: the tile of the minimum-corner node
        def part_elems(conn):
            if len(conn) == 0:
                return [conn] * (py * px)
            anchor = conn.min(axis=1)
            tid = ((anchor // nxp) // self.ly) * px + (anchor % nxp) // self.lx
            order = np.argsort(tid, kind="stable")
            bounds = np.concatenate([[0], np.cumsum(np.bincount(tid, minlength=py * px))])
            return [conn[order[bounds[i]:bounds[i + 1]]] for i in range(py * px)]

        tri_p, quad_p = part_elems(mesh.tri), part_elems(mesh.quad)
        self.tile_elements = [(len(t), len(q)) for t, q in zip(tri_p, quad_p)]  # (Tri-3, Quad-4) per rank
        free = np.zeros((6, self.nyt, self.nxt))
        free[:, :nyp, :nxp] = (~mesh.dirichlet_mask()).T.reshape(6, nyp, nxp)
        self.free = self._tile(free)  # [S, 6, ly, lx]
        common = {"grid": (py, px), "ly": self.ly, "lx": self.lx, "nxp": nxp, "coords": mesh.coords,
                  "mats": material.matrices(), "thickness": material.thickness, "chunk": self.chunk,
                  "dtype": dtype}
        self.device_mesh.run(_build_rank, [(self.key, dict(common, free=self.free[r], families=[tri_p[r], quad_p[r]]))
                                           for r in range(py * px)])

    def rounded(self, dtype) -> "Sharded2DGridSystem":
        """This system with its f64 operator rounded once to ``dtype`` on the
        ranks, without a second assembly."""
        if self.dtype != torch.float64:
            raise ValueError(f"rounded() starts from the f64 operator, not {self.dtype}")
        other = copy.copy(self)
        other._bind(self.device_mesh)
        other.dtype = dtype
        self.device_mesh.run(_round_rank, [(other.key, self.key, dtype)] * self.n_shards)
        return other

    def _tile(self, g):
        """[C, nyt, nxt] global grid -> per-rank [S, C, ly, lx] tiles."""
        c = g.shape[0]
        t = g.reshape(c, self.py, self.ly, self.px, self.lx).transpose(1, 3, 0, 2, 4)
        return np.ascontiguousarray(t.reshape(self.py * self.px, c, self.ly, self.lx))

    def _untile(self, tiles):
        """Per-rank [C, ly, lx] tiles -> [C, nyt, nxt]."""
        t = np.stack(tiles).reshape(self.py, self.px, -1, self.ly, self.lx)
        return t.transpose(2, 0, 3, 1, 4).reshape(-1, self.nyt, self.nxt)

    def halo_bytes_per_iter(self) -> int:
        """Bytes one rank sends per matvec's halo exchange: two [6, ly]
        columns, then two [6, lx+2] rows, in ``dtype`` (none along an axis
        of one tile)."""
        item = 8 if self.dtype == torch.float64 else 4
        return 2 * 6 * item * ((self.ly if self.px > 1 else 0) + (self.lx + 2 if self.py > 1 else 0))

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 20000) -> np.ndarray:
        """Jacobi-PCG; forces [N, 6] -> displacements [N, 6] (numpy, in
        ``dtype``); sets ``last_iters`` and ``last_residual``."""
        nyp, nxp = self.grid.nyp, self.grid.nxp
        g = np.zeros((6, self.nyt, self.nxt))
        g[:, :nyp, :nxp] = np.asarray(forces).T.reshape(6, nyp, nxp)
        parts = self._run_solve(_solve_rank, [(self.key, b, rtol, maxiter) for b in self._tile(g)])
        return self._untile(parts)[:, :nyp, :nxp].reshape(6, nyp * nxp).T.copy()


class Sharded2DGridDFSystem(Sharded2DGridSystem):
    """The 2-D tile partition's production solver (the JAX df system): the
    f64 system of the same class, Jacobi-PCG in f64 with an f64 inverse
    diagonal."""

    def __init__(self, mesh, material, device_mesh: DeviceMesh, chunk: int = 8192):
        super().__init__(mesh, material, device_mesh, dtype=torch.float64, chunk=chunk)

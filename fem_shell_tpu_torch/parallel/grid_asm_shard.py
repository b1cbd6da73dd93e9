"""Sharded scatter-free grid assembly: per-rank row blocks — port of
``fem_shell_tpu/parallel/grid_asm_shard.py``, in native f64.

The grid pipeline of ``ops/assemble_grid.py`` (element stiffnesses from
``ops/elem_stiffness``, the kernel ``csrc/elem_stiffness.cu`` on the card,
added as shifted windows, no scatter) runs on each rank over a 1-D
partition of the grid's node rows:

- rank s owns node rows [row_starts[s], row_starts[s+1]) and assembles
  the element rows aligned with them (``assemble_grid_rows``, in the
  strips the whole grid would use); element row e touches node rows e and
  e+1, so every rank but the last accumulates one bottom node row it does
  not own;
- the constrained unit diagonal is set on the owned rows only (the extra
  row is treated as free: its diagonal is its owner's), and the row
  masks use the grid's real free mask, so masked contributions arrive as
  exact zeros;
- the extra row, [36K, nxp] f64, goes to rank s+1 in one message and is
  added into its first row: a plain f64 add (the JAX package's
  ``_halo_fold`` renormalises with ``two_sum`` only for its two-float32
  pair). Off that row every entry is the single-device operator's bit for
  bit; on it the two parts are added in another order.

``assemble_grid_df_rowblocks`` is the controller-side form with the JAX
name, for the tests: it runs the same per-block code in the same order on
one device. ``GridShardedDFShellSystem`` builds the operator of a
strip system (``df_shard.ShardedDFShellSystem`` made without assembly)
this way on the ranks, and solves it with the f64 CG, Jacobi or
preconditioned by the row-sharded f32 V-cycle (``mg_shard``), whose fine
level is this operator rounded once to f32: the fine level is never
assembled by element scatter; only the coarser levels assemble per rank.
``solve_refined`` runs the inner solves sharded and the true residual on
the controller's device from the class tables (``class_residual``: the
``class_stencil<double>`` matvec minus the ``<float>`` E term).
"""
from __future__ import annotations

import math
import types
from typing import List, Optional, Sequence

import numpy as np
import torch

from fem_shell_tpu_torch.ops.assemble_grid import assemble_grid_rows, default_strip_rows
from fem_shell_tpu_torch.ops.soa import _self_slot, soa_diagonal
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.sharded import material_tensors
from fem_shell_tpu_torch.parallel.stencil_shard import _set_padded


def partition_rows(nyp: int, n_shards: int) -> List[int]:
    """Balanced node-row starts over the ny = nyp-1 element rows; every
    shard gets >=1 element row (n_shards is clamped down if needed)."""
    ny = nyp - 1
    n_shards = max(1, min(n_shards, ny))
    base, rem = divmod(ny, n_shards)
    starts = [0]
    for s in range(n_shards):
        starts.append(starts[-1] + base + (1 if s < rem else 0))
    starts[-1] = nyp  # last shard also owns the final node row
    return starts


def block_inputs(grid, cgrid, free_grid, ns: int, ns1: int, width: Optional[int] = None) -> dict:
    """Host inputs of the row block of node rows [ns, ns1) of a
    [nyp, nxp] grid: the element rows [e0, e1), the coordinate window
    [3, e1-e0+1, nxp] and the halo-padded free window [6, e1-e0+3, nxp+2]
    (f64 numpy, from the coordinate grid ``cgrid`` [3, nyp, nxp] and the
    free grid ``free_grid`` [6, nyp, nxp]), and ``diag_free`` [6, width]
    (the owned lanes' free mask, ones on the extra bottom row, zeros on
    lanes past both: the unit diagonal of padding). ``width`` defaults to
    the block's rows times nxp."""
    nyp, nxp = grid.nyp, grid.nxp
    last = ns1 == nyp
    e0, e1 = ns, (nyp - 1 if last else ns1)
    if e1 <= e0:
        raise ValueError(f"rows [{ns}, {ns1}) hold no element row")
    local_rows = e1 - e0 + 1
    width = local_rows * nxp if width is None else int(width)
    if width < (ns1 - ns) * nxp or (not last and width < local_rows * nxp):
        raise ValueError(f"width {width} does not hold rows [{ns}, {e1 + 1})")
    free_pad = np.pad(free_grid, ((0, 0), (1, 1), (1, 1)))
    diag_free = np.zeros((6, width))
    diag_free[:, :local_rows * nxp] = 1.0
    diag_free[:, :(ns1 - ns) * nxp] = free_grid[:, ns:ns1].reshape(6, -1)
    return {"e0": e0, "e1": e1, "owned": (ns1 - ns) * nxp, "last": last,
            "coords": np.ascontiguousarray(cgrid[:, e0:e1 + 1]),
            "free_pad": np.ascontiguousarray(free_pad[:, e0:e1 + 3]), "diag_free": diag_free}


def assemble_block(grid, inp: dict, offsets, dm, dp, thickness: float, strip_rows: Optional[int], device,
                   out=None):
    """The row block's f64 buffer [36, K, width] before the fold, new or
    ``out`` (the rank's and the controller form's one per-block code)."""
    f64 = torch.float64

    def put(a):
        return torch.as_tensor(a, dtype=f64).to(device)

    return assemble_grid_rows(grid, put(inp["coords"]), put(inp["free_pad"]), offsets, inp["e0"], inp["e1"],
                              put(inp["diag_free"]), dm, dp, thickness, strip_rows=strip_rows, out=out)


def _grids(grid, coords64, free):
    """(coordinate grid [3, nyp, nxp], free grid [6, nyp, nxp]) as f64 numpy
    from node coordinates [N, 3] and a free mask [6, >= N]."""
    nyp, nxp = grid.nyp, grid.nxp
    c = np.asarray(coords64, np.float64).reshape(nyp, nxp, 3).transpose(2, 0, 1)
    f = np.asarray(free, np.float64)[:, : nyp * nxp].reshape(6, nyp, nxp)
    return c, f


def assemble_grid_df_rowblocks(grid, coords64, free_t, offsets, dm, dp, thickness: float,
                               row_starts: Sequence[int], strip_rows: Optional[int] = None) -> List[torch.Tensor]:
    """Per-shard BC-constrained f64 operator row blocks on one device:
    ``blocks[s]`` [36, K, owned_rows_s * nxp], the rows of the flat
    operator (``assemble_grid``'s layout) for shard s's node rows, with the
    fold of each extra bottom row into the next block. ``free_t`` [6, >= N]
    (1 = free, numpy or tensor); ``dm``, ``dp`` [3, 3] f64 on the blocks'
    device."""
    nyp = grid.nyp
    nxp = grid.nxp
    row_starts = [int(r) for r in row_starts]
    if row_starts[0] != 0 or row_starts[-1] != nyp:
        raise ValueError(f"row starts {row_starts} do not span 0..{nyp}")
    device = dm.device
    if torch.is_tensor(free_t):
        free_t = free_t.cpu().numpy()
    cgrid, free_grid = _grids(grid, coords64, free_t)
    bufs, cuts = [], []
    for ns, ns1 in zip(row_starts[:-1], row_starts[1:]):
        inp = block_inputs(grid, cgrid, free_grid, ns, ns1)
        bufs.append(assemble_block(grid, inp, offsets, dm, dp, thickness, strip_rows, device))
        cuts.append(inp["owned"])
    # the extra bottom row of block s-1 -> the first row of block s
    for s in range(1, len(bufs)):
        bufs[s][:, :, :nxp] += bufs[s - 1][:, :, cuts[s - 1]:cuts[s - 1] + nxp]
    return [b[:, :, :cut] for b, cut in zip(bufs, cuts)]


def rowblocks_to_flat(blocks: Sequence[torch.Tensor], npad: int) -> torch.Tensor:
    """The row blocks concatenated into the flat [36, K, Npad] operator
    (zero-padded; the padding's diagonal NOT set: a test helper)."""
    flat = torch.cat(list(blocks), dim=2)
    if npad < flat.shape[2]:
        raise ValueError(f"npad {npad} < the blocks' {flat.shape[2]} lanes")
    return torch.nn.functional.pad(flat, (0, npad - flat.shape[2]))


def rowblocks_diag(blocks: Sequence[torch.Tensor], offsets) -> List[torch.Tensor]:
    """Per-shard operator diagonal [6, rows_s * nxp], taken after the fold,
    so boundary rows carry both shards' contributions."""
    return [soa_diagonal(b, offsets) for b in blocks]


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def _build_rank(comm, arg):
    """The rank's row block, assembled in place in the strip state's padded
    window [36, K, Wp+L+Wp] (a non-last rank's extra bottom row lies in the
    right pad: Wp > nxp), that row sent on and zeroed, the previous rank's
    added into the first row; then the strip state of ``key``."""
    key, p = arg
    dev, f64 = comm.device, torch.float64
    inp, offsets, nxp, k = p["block"], p["offsets"], p["nxp"], len(p["offsets"])
    l, wp = p["l"], p["wp"]
    width = inp["diag_free"].shape[1]
    if width > l + wp:
        raise ValueError(f"a row block of {width} lanes does not fit the window of L={l}, Wp={wp}")
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    padded = torch.zeros((36, k, l + 2 * wp), dtype=f64, device=dev)
    buf = assemble_block(p["grid"], inp, offsets, dm, dp, t, p["strip_rows"], dev, out=padded[:, :, wp:wp + width])
    cut = inp["owned"]
    got = comm.send_next(None if inp["last"] else buf[:, :, cut:cut + nxp], (36, k, nxp), f64)
    padded[:, :, wp + l:] = 0.0
    if got is not None:
        buf[:, :, :nxp] += got
    st = types.SimpleNamespace(wp=wp, l=l, offsets=offsets, k0=_self_slot(offsets))
    comm.state[key] = _set_padded(st, padded, torch.as_tensor(p["free"], dtype=f64, device=dev))


def check_rowblock_rank(comm, arg):
    """A rank command for the card's check: the rank's operator rows
    against the same rows of the single-device ``assemble_grid`` of the
    whole grid, assembled here. Returns the largest |difference| off the
    fold row (the first row of every rank but rank 0) and on it, and
    max|A| of the reference rows."""
    from fem_shell_tpu_torch.ops.assemble_grid import assemble_grid

    key, p = arg
    st = comm.state[key]
    dev = comm.device
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    free_t = torch.as_tensor(p["free_t"], dtype=torch.float64, device=dev)
    ref = assemble_grid(p["grid"], p["coords"], free_t, st.offsets, free_t.shape[1], dm, dp, t)
    r0, n_lanes, nxp = p["lane0"], p["owned"], p["grid"].nxp
    mine = st.vals[:, :, st.wp:st.wp + n_lanes]
    ref = ref[:, :, r0:r0 + n_lanes]
    diff = (mine - ref).abs()
    fold = nxp if comm.rank > 0 else 0
    return {"off_fold": float(diff[:, :, fold:].max()), "on_fold": float(diff[:, :, :fold].max()) if fold else 0.0,
            "max_abs": float(ref.abs().max()), "lanes": n_lanes}


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class GridShardedDFShellSystem:
    """Multi-rank solver on structured grids whose operator, too, is built
    by the sharded grid pipeline (no element scatter on the fine level).

    Row partition: R = ceil(nyp / S) node rows per rank (the last takes the
    rest and pads to L = R * nxp lanes with the unit diagonal), the strip
    layout of ``stencil_shard``; with ``prec="mg"`` the V-cycle's even row
    count (``mg_shard.strip_rows``), so the row blocks are the layout the
    V-cycle's fine level takes. The CG is the f64 strip CG
    (``df_shard.make_df_matvec``, ``pcg_df_spmd``), Jacobi or
    preconditioned by the f32 V-cycle on the residual rounded to f32."""

    def __init__(self, mesh, material, device_mesh: DeviceMesh, prec: str = "jacobi",
                 mg_kw: Optional[dict] = None):
        from fem_shell_tpu_torch.mg import detect_structured_grid
        from fem_shell_tpu_torch.parallel.df_shard import ShardedDFShellSystem
        from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem
        from fem_shell_tpu_torch.parallel.mg_shard import strip_rows as mg_rows

        grid = detect_structured_grid(mesh)
        if grid is None:
            raise ValueError("GridShardedDFShellSystem requires a structured grid mesh")
        if prec not in ("jacobi", "mg"):
            raise ValueError(f"prec must be 'jacobi' or 'mg', got {prec!r}")
        self.grid = grid
        self.mesh = mesh
        self.material = material
        s = device_mesh.size
        nyp, nxp = grid.nyp, grid.nxp
        r_rows = mg_rows(nyp, s) if prec == "mg" else -(-nyp // s)
        if (s - 1) * r_rows > nyp - 2:
            raise ValueError(
                f"grid too small for {s} shards: {nyp} node rows need "
                f">=1 element row on the last shard (R={r_rows})"
            )
        self._row_starts = [i * r_rows for i in range(s)] + [nyp]
        self.strip_rows = default_strip_rows(grid)
        self.sys = ShardedDFShellSystem(mesh, material, device_mesh, l_force=r_rows * nxp, assemble=False)
        sys_ = self.sys
        cgrid, free_grid = _grids(grid, mesh.coords, (~mesh.dirichlet_mask()).T)
        common = {"grid": grid, "offsets": sys_.offsets, "nxp": nxp, "mats": material.matrices(),
                  "thickness": material.thickness, "strip_rows": self.strip_rows, "l": sys_.l,
                  "wp": sys_.w_pad}
        self.blocks = []  # per rank: (element rows e0, e1, owned lanes)
        args = []
        for si in range(s):
            ns, ns1 = self._row_starts[si], self._row_starts[si + 1]
            last = si == s - 1
            inp = block_inputs(grid, cgrid, free_grid, ns, ns1, width=sys_.l if last else None)
            self.blocks.append((inp["e0"], inp["e1"], inp["owned"]))
            args.append((sys_.key, dict(common, block=inp, free=sys_.free[si])))
        device_mesh.run(_build_rank, args)
        self.mgp = None
        if prec == "mg":
            self.mgp = ShardedMGShellSystem(mesh, material, device_mesh, dtype=torch.float32, fine_source=sys_,
                                            **(mg_kw or {}))
            # the layout contract: a misaligned partition would build a
            # wrong but converging preconditioner
            fine = self.mgp.levels[0]
            if fine.l != sys_.l:
                raise ValueError(f"MG fine partition l={fine.l} != df partition l={sys_.l}")
            if tuple(fine.sys.offsets) != tuple(sys_.offsets):
                raise ValueError("MG fine stencil offsets != df system offsets")
        self.last_iters = 0
        self.last_residual = math.inf
        self._cdf = None

    def strips_per_rank(self) -> List[int]:
        """Grid strips each rank's fine-level assembly runs (one
        ``elem_stiffness`` launch per element family each)."""
        from fem_shell_tpu_torch.ops.assemble_grid import grid_strips

        return [len(grid_strips(self.grid.nyp - 1, self.strip_rows, e0, e1)) for e0, e1, _ in self.blocks]

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 20000) -> np.ndarray:
        """forces [N, 6] -> f64 displacements [N, 6] (numpy); sets
        ``last_iters`` and ``last_residual``."""
        from fem_shell_tpu_torch.parallel.df_shard import _solve_mgdf_rank

        sys_ = self.sys
        if self.mgp is None:
            u = sys_.solve(forces, rtol=rtol, maxiter=maxiter)
        else:
            parts = sys_._run_solve(_solve_mgdf_rank, [(sys_.key, self.mgp.key, b, rtol, maxiter)
                                                       for b in sys_.split_forces(forces)])
            u = sys_.join_solution(parts)
        self.last_iters, self.last_residual = sys_.last_iters, sys_.last_residual
        return u

    def _class_parts(self):
        """The class tables of the fine grid on the controller's device, once
        (host longdouble patch assembly, ``build_exact_stencil``)."""
        if self._cdf is None:
            from fem_shell_tpu_torch.ops.class_matvec import build_class_parts
            from fem_shell_tpu_torch.ops.exact_stencil import build_exact_stencil

            st = build_exact_stencil(self.mesh, self.material, self.sys.offsets, grid=self.grid)
            self._cdf, _ = build_class_parts(st, self.grid.nyp * self.grid.nxp,
                                             device=self.sys.device_mesh.device)
        return self._cdf

    def solve_refined(self, forces, rtol: float = 1e-9, n_refine: int = 6, inner_rtol: float = 1e-5,
                      inner_maxiter: int = 20000, verbose: bool = False) -> np.ndarray:
        """Iterative refinement on uniform grids: the inner solves run
        sharded; the true residual b - A x of each pass is the class tables'
        on the controller's device (``class_residual``, the class path of
        ``MultigridShellSystem``). Stops at ``rtol``, on a non-finite
        residual, or on a pass worse than 0.7x the last. Sets
        ``last_iters`` (all inner iterations), ``last_residual``,
        ``refine_history`` and ``refine_inner_iters``; returns f64 [N, 6]."""
        from fem_shell_tpu_torch.ops.class_matvec import class_residual

        cdf = self._class_parts()
        dev = self.sys.device_mesh.device
        n = self.grid.nyp * self.grid.nxp
        free = torch.as_tensor((~self.mesh.dirichlet_mask()).T, dtype=torch.float64, device=dev)
        b = torch.as_tensor(np.asarray(forces, np.float64).T, device=dev) * free
        u = self.solve(forces, rtol=inner_rtol, maxiter=inner_maxiter)
        inner = [self.last_iters]
        x = torch.as_tensor(u.T, dtype=torch.float64, device=dev).contiguous()
        hist = []
        for _ in range(n_refine):
            r, rn = class_residual(cdf, x, b.contiguous())
            rn = float(rn)
            hist.append(rn)
            if verbose:
                print(f"  refine[sharded]: true residual {rn:.3e} ({sum(inner)} inner iters)", flush=True)
            if rn < rtol or not np.isfinite(rn):
                break
            if len(hist) > 1 and rn > 0.7 * hist[-2]:
                break  # the representation floor of x
            d = self.solve(r[:, :n].T.cpu().numpy(), rtol=inner_rtol, maxiter=inner_maxiter)
            inner.append(self.last_iters)
            x = x + torch.as_tensor(d.T, dtype=torch.float64, device=dev)
        self.last_iters = sum(inner)
        self.last_residual = hist[-1] if hist else float("nan")
        self.refine_history = hist
        self.refine_inner_iters = inner
        return x.T.cpu().numpy()

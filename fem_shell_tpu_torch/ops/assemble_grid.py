"""Scatter-free assembly of the SoA stencil operator on a structured grid.

Port of ``fem_shell_tpu/ops/assemble_grid.py`` (``GridFamily``,
``grid_families``, ``assemble_grid_df``, flat layout). On a detected
row-major structured grid (mg.py ``detect_structured_grid``) the elements
incident to a node sit at fixed 2-D offsets, so adding
ke[la*6+a, lb*6+b] of every element into operator row (a*6+b), slot
slot(la, lb) is a static slice-add on the [rows, nxp] node grid: no
gather of coordinates, no scatter of element matrices. Per strip of
element rows:

- the element coordinates are windows of the [3, nyp, nxp] coordinate
  grid, one per element corner;
- every element stiffness comes from ``ops/elem_stiffness.elem_stiffness``
  (the CUDA kernel on the card), one call per element family;
- each (la, lb) block is added as a shifted window into its slot of a
  [36, K, rows_e + 1, nxp] strip buffer, in one fixed order;
- the strip's rows and columns are masked with windows of the 1-halo-padded
  free grid (no full-size temporary), and the strip is added into the
  operator with ``add_`` on a view; it overlaps the next strip by one node
  row.

The operator starts as the constrained unit diagonal (masked
contributions are exact zeros), so no pass over the whole operator follows.
The JAX package folds each strip into a two-float32 pair with two_sum; the
port's operator is native f64 and every sum has one order, so two
assemblies agree bit for bit (``index_add_`` on CUDA does not promise that).

The tile-major layout (``layout="tiled"``, ``tile_values``,
``untile_values``, ``soa_diagonal_tiled``) is a TPU Pallas layout and is
not ported: the port's operators are flat [36, K, Npad].
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness
from fem_shell_tpu_torch.ops.soa import _self_slot, soa_diagonal

# corner (dy, dx) tables per element family, matching mg.py:_grid_conn
_QUAD_CORNERS = ((0, 0), (0, 1), (1, 1), (1, 0))
_TRI_FAMS = {
    True: (((0, 0), (0, 1), (1, 0)), ((0, 1), (1, 1), (1, 0))),  # ul_lr
    False: (((0, 0), (1, 1), (0, 1)), ((1, 1), (0, 0), (1, 0))),
}


@dataclasses.dataclass(frozen=True)
class GridFamily:
    corners: Tuple[Tuple[int, int], ...]  # (dy, dx) per local node
    slots: Tuple[Tuple[int, ...], ...]  # [m][m] -> stencil slot index


def family_corners(elem_type: str, ul_lr: bool):
    """The (dy, dx) corner offsets of each element family of a grid."""
    return (_QUAD_CORNERS,) if elem_type == "q" else _TRI_FAMS[ul_lr]


def grid_families(elem_type: str, ul_lr: bool, nxp: int, offsets) -> List[GridFamily]:
    """The element families of a structured grid: each family's corner
    offsets and the stencil slot of every local node pair (la, lb)."""
    off_index = {int(o): i for i, o in enumerate(offsets)}
    fams = []
    for corners in family_corners(elem_type, ul_lr):
        m = len(corners)
        slots = tuple(
            tuple(
                off_index[(corners[lb][0] - corners[la][0]) * nxp + (corners[lb][1] - corners[la][1])]
                for lb in range(m)
            )
            for la in range(m)
        )
        fams.append(GridFamily(corners=corners, slots=slots))
    return fams


def _offsets_2d(offsets: Sequence[int], nxp: int) -> List[Tuple[int, int]]:
    """(dy, dx) of each flat stencil offset, |dy|, |dx| <= 1."""
    out = []
    for o in offsets:
        dy = int(np.round(o / nxp))
        dx = int(o - dy * nxp)
        if abs(dx) > 1 or abs(dy) > 1:
            raise ValueError(f"offset {o} is not a 3x3 neighbour on a grid {nxp} nodes wide")
        out.append((dy, dx))
    return out


def strip_bounds(ny: int, strip_rows: int) -> List[Tuple[int, int]]:
    """(first element row, element rows) of each strip, top to bottom."""
    return [(r0, min(strip_rows, ny - r0)) for r0 in range(0, ny, strip_rows)]


def family_coords(cgrid, corners, r0: int, rows_e: int):
    """[m, 3, rows_e * nx] node coordinates of one family's elements in
    element rows r0 .. r0 + rows_e - 1, from the [3, nyp, nxp] coordinate
    grid: one window per element corner, no gather."""
    nx = cgrid.shape[2] - 1
    return torch.stack([cgrid[:, r0 + dy : r0 + dy + rows_e, dx : dx + nx].reshape(3, rows_e * nx)
                        for dy, dx in corners])


def grid_coords(grid, coords64, device):
    """The [3, nyp, nxp] f64 coordinate grid of node coordinates [N, 3]."""
    c = torch.as_tensor(coords64, dtype=torch.float64).reshape(grid.nyp, grid.nxp, 3)
    return c.permute(2, 0, 1).to(device).contiguous()


def grid_strips(ny: int, strip_rows: int, e0: int, e1: int) -> List[Tuple[int, int]]:
    """The strips of element rows [e0, e1): the whole grid's strips
    (``strip_bounds``) cut to the range, so a range is assembled in the
    strips the whole grid would use."""
    out = []
    for r0, rows_e in strip_bounds(ny, strip_rows):
        lo, hi = max(r0, e0), min(r0 + rows_e, e1)
        if lo < hi:
            out.append((lo, hi - lo))
    return out


def default_strip_rows(grid) -> int:
    """Element rows per strip: max(1, min(ny, 65536 // nx)), as in the JAX
    package."""
    nx, ny = grid.nxp - 1, grid.nyp - 1
    return max(1, min(ny, 65536 // max(nx, 1)))


def assemble_grid_rows(grid, cgrid, free_pad, offsets, e0: int, e1: int, diag_free, dm, dp, thickness: float,
                       strip_rows: Optional[int] = None, out=None):
    """The contributions of element rows [e0, e1) of a structured grid to
    the BC-eliminated f64 operator, in a buffer [36, K, W] whose lane 0 is
    node row e0's first node (W = ``diag_free``'s width, at least
    (e1 - e0 + 1) * nxp): a new one, or ``out``, zeros the caller
    allocated (a view of a padded window). The buffer starts as the unit diagonal where
    ``diag_free`` [6, W] is 0 (the rows the caller owns and constrains);
    masked contributions are exact zeros, so it survives every strip.

    ``cgrid`` [3, e1 - e0 + 1, nxp]: the coordinate grid's node rows e0 ..
    e1; ``free_pad`` [6, e1 - e0 + 3, nxp + 2]: the 1-halo-padded free
    grid's rows for node rows e0 - 1 .. e1 + 1 (its rows and columns mask
    each strip's rows and columns); ``dm``, ``dp`` [3, 3] f64, all on the
    buffer's device. Per strip of ``grid_strips``: one ``elem_stiffness``
    call per element family, each (la, lb) block added as a shifted window
    in one fixed order, the masks, then one ``add_`` on a view of the
    buffer."""
    nxp = grid.nxp
    nx = nxp - 1
    offsets = tuple(int(o) for o in offsets)
    k = len(offsets)
    dev = diag_free.device
    f64 = torch.float64
    if strip_rows is None:
        strip_rows = default_strip_rows(grid)
    fams = grid_families(grid.elem_type, grid.ul_lr, nxp, offsets)
    off2d = _offsets_2d(offsets, nxp)

    values = torch.zeros((36, k, diag_free.shape[1]), dtype=f64, device=dev) if out is None else out
    k0 = _self_slot(offsets)
    for a in range(6):
        values[a * 6 + a, k0] = 1.0 - diag_free[a]

    for r0, rows_e in grid_strips(grid.nyp - 1, strip_rows, e0, e1):
        rl = r0 - e0  # the strip's first row in the windows and the buffer
        rows_n = rows_e + 1
        acc = torch.zeros((6, 6, k, rows_n, nxp), dtype=f64, device=dev)  # (a, b, slot, row, col)
        for fam in fams:
            m = len(fam.corners)
            xyz = family_coords(cgrid, fam.corners, rl, rows_e)
            ke = elem_stiffness(xyz, dm, dp, thickness).view(m, 6, m, 6, rows_e, nx)
            for la in range(m):
                dy, dx = fam.corners[la]
                for lb in range(m):
                    acc[:, :, fam.slots[la][lb], dy : dy + rows_e, dx : dx + nx] += ke[la, :, lb]
            del ke, xyz
        # Dirichlet masks from windows of the halo-padded free grid: row a
        # of slot s keeps free[a] at the node, column b keeps free[b] at
        # the node the slot points to
        acc *= free_pad[:, None, None, rl + 1 : rl + 1 + rows_n, 1 : 1 + nxp]
        col = torch.stack([free_pad[:, rl + 1 + dy : rl + 1 + dy + rows_n, 1 + dx : 1 + dx + nxp]
                           for dy, dx in off2d], dim=1)  # [6 (b), K, rows_n, nxp]
        acc *= col[None]
        start = rl * nxp
        values[:, :, start : start + rows_n * nxp].add_(acc.view(36, k, rows_n * nxp))
        del acc, col
    return values


def assemble_grid(grid, coords64, free_t, offsets, npad: int, dm, dp, thickness: float,
                  strip_rows: Optional[int] = None, with_diag: bool = False):
    """BC-eliminated f64 operator values [36, K, Npad] of a structured grid
    (unit diagonal on constrained DOFs), built without scatter:
    ``assemble_grid_rows`` over every element row.

    ``grid`` has ``nxp``, ``nyp``, ``elem_type`` and ``ul_lr``
    (mg.GridInfo); ``coords64`` [nyp*nxp, 3] node coordinates (numpy or
    tensor); ``free_t`` [6, Npad] (1 = free) on the operator's device;
    ``dm``, ``dp`` [3, 3] f64 on that device. ``strip_rows`` element rows
    per strip (default max(1, min(ny, 65536 // nx)), as in the JAX
    package). With ``with_diag`` also returns the [6, Npad] diagonal."""
    nyp, nxp = grid.nyp, grid.nxp
    if free_t.shape[1] != npad:
        raise ValueError(f"free_t has {free_t.shape[1]} lanes, not Npad = {npad}")
    cgrid = grid_coords(grid, coords64, free_t.device)
    free = free_t.to(torch.float64)
    free_pad = torch.nn.functional.pad(free[:, : nyp * nxp].reshape(6, nyp, nxp), (1, 1, 1, 1))
    values = assemble_grid_rows(grid, cgrid, free_pad, offsets, 0, nyp - 1, free, dm, dp, thickness,
                                strip_rows=strip_rows)
    if with_diag:
        return values, soa_diagonal(values, offsets)
    return values

"""Structured plate mesh generator — port of ``fem_shell_tpu/meshgen.py``
(analog of meshGen, src/meshgen/main_all.cpp:15-390).

Same node/element numbering, edge boundary-condition records and nodal
force rows as the reference tool:

- nodes row-major over an (nx+1)x(ny+1) grid, with a "dead axis" selecting
  the plane (x/y/z; main_all.cpp:141-160)
- quads ``[n, n+1, n+nx+2, n+nx+1]``; triangles split each cell in one of
  two diagonal orientations ``ul_lr`` (main_all.cpp:162-224)
- edge BC records for top/bottom/left/right with the reference's
  element/side numbering (main_all.cpp:283-338)
- force rows: loading 1 = unit force on node ``n_nodes//2``, loading 2 =
  uniform area load as equal nodal forces ``factor*dx*dy``
  (main_all.cpp:341-387), including the reference quirk of emitting only
  ``n_nodes-1`` rows (the last node's row is zero).

``write_files`` and the CLI ``main`` (``python -m
fem_shell_tpu_torch.meshgen``, the same 13 positional arguments as
meshGen) write ``<name>.xda`` and ``<name>_f``, byte for byte as the JAX
package's meshgen does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from fem_shell_tpu_torch.mesh import ShellMesh, XDA_QUAD4, XDA_TRI3, write_forces, write_xda

LOAD_NONE = 0
LOAD_CONCENTRATED = 1  # unit force on central node n_nodes//2
LOAD_UNIFORM = 2  # factor*dx*dy on every node (but the last; see quirk)


@dataclasses.dataclass(frozen=True)
class MeshGenParams:
    """CLI-equivalent parameter set (main_all.cpp:20-33)."""

    elem_type: str  # 'q' or 't'
    nx: int
    ny: int
    min_x: float
    min_y: float
    max_x: float
    max_y: float
    bcids: Tuple[int, int, int, int]  # (top, bottom, left, right); -1 = none
    factor: float = 1.0
    loading: int = LOAD_NONE
    ul_lr: bool = True
    dead_axis: str = "z"


def generate(p: MeshGenParams) -> Tuple[ShellMesh, np.ndarray, float]:
    """Build (mesh, unscaled force rows [n,6], force factor)."""
    if p.elem_type not in ("q", "t"):
        raise ValueError("elem_type must be 'q' or 't'")
    if p.dead_axis not in ("x", "y", "z"):
        raise ValueError("dead_axis must be one of x/y/z")
    nx, ny = p.nx, p.ny
    n_nodes = (nx + 1) * (ny + 1)
    fracx = (p.max_x - p.min_x) / nx
    fracy = (p.max_y - p.min_y) / ny

    # nodes, row-major (main_all.cpp:144-160)
    xs = p.min_x + fracx * np.arange(nx + 1)
    ys = p.min_y + fracy * np.arange(ny + 1)
    gx, gy = np.meshgrid(xs, ys)
    prim = gx.reshape(-1)
    sec = gy.reshape(-1)
    coords = np.zeros((n_nodes, 3), dtype=np.float64)
    if p.dead_axis == "z":
        coords[:, 0] = prim
        coords[:, 1] = sec
    elif p.dead_axis == "y":
        coords[:, 0] = prim
        coords[:, 2] = sec
    else:
        coords[:, 1] = prim
        coords[:, 2] = sec

    # elements (main_all.cpp:163-224)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n_id = (xx + yy * (nx + 1)).reshape(-1).astype(np.int64)
    if p.elem_type == "q":
        elem_conn = np.stack(
            [n_id, n_id + 1, n_id + nx + 2, n_id + nx + 1], axis=1
        ).astype(np.int32)
        elem_types = np.full(len(n_id), XDA_QUAD4, dtype=np.int32)
    else:
        if p.ul_lr:
            tri1 = np.stack([n_id, n_id + 1, n_id + nx + 1], axis=1)
            tri2 = np.stack([n_id + 1, n_id + nx + 2, n_id + nx + 1], axis=1)
        else:
            tri1 = np.stack([n_id, n_id + nx + 2, n_id + 1], axis=1)
            tri2 = np.stack([n_id + nx + 2, n_id, n_id + nx + 1], axis=1)
        both = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
        elem_conn = np.hstack(
            [both, np.full((len(both), 1), -1, dtype=np.int64)]
        ).astype(np.int32)
        elem_types = np.full(len(both), XDA_TRI3, dtype=np.int32)

    # boundary records (main_all.cpp:283-338), in the reference's emission
    # order: all top/bottom pairs first, then left/right pairs
    t_bc, b_bc, l_bc, r_bc = p.bcids
    bcs = []
    for i in range(nx):
        if p.elem_type == "t":
            if p.ul_lr:
                if b_bc >= 0:
                    bcs.append((2 * i, 0, b_bc))
                if t_bc >= 0:
                    bcs.append((2 * nx * ny - 2 * i - 1, 1, t_bc))
            else:
                if b_bc >= 0:
                    bcs.append((2 * i, 2, b_bc))
                if t_bc >= 0:
                    bcs.append((2 * nx * ny - 2 * i - 1, 2, t_bc))
        else:
            if b_bc >= 0:
                bcs.append((i, 0, b_bc))
            if t_bc >= 0:
                bcs.append((nx * ny - 1 - i, 2, t_bc))
    for i in range(ny):
        if p.elem_type == "t":
            if p.ul_lr:
                if l_bc >= 0:
                    bcs.append((2 * nx * i, 2, l_bc))
                if r_bc >= 0:
                    bcs.append((2 * nx * (i + 1) - 1, 0, r_bc))
            else:
                if l_bc >= 0:
                    bcs.append((2 * nx * i + 1, 1, l_bc))
                if r_bc >= 0:
                    bcs.append((2 * nx * (i + 1) - 2, 1, r_bc))
        else:
            if l_bc >= 0:
                bcs.append((nx * i, 3, l_bc))
            if r_bc >= 0:
                bcs.append((nx * (i + 1) - 1, 1, r_bc))
    boundary = np.array(bcs, dtype=np.int32).reshape(-1, 3)

    mesh = ShellMesh(coords, elem_types, elem_conn, boundary)

    # force rows (unscaled; factor returned separately) — main_all.cpp:341-387
    force_dir = {"x": 0, "y": 1, "z": 2}[p.dead_axis]
    rows = np.zeros((n_nodes, 6), dtype=np.float64)
    factor = p.factor
    if p.loading == LOAD_CONCENTRATED:
        target = n_nodes // 2
        if target < n_nodes - 1:  # rows 0..n_nodes-2 are written
            rows[target, force_dir] = 1.0
    elif p.loading == LOAD_UNIFORM:
        factor = p.factor * fracx * fracy
        rows[: n_nodes - 1, force_dir] = 1.0
    return mesh, rows, factor


def write_files(p: MeshGenParams, basename: str) -> ShellMesh:
    """Emit ``<basename>.xda`` (and ``<basename>_f`` when loading != 0) in
    the reference tool's format, with its ``n_nodes-1`` force rows."""
    mesh, rows, factor = generate(p)
    write_xda(mesh, basename + ".xda")
    if p.loading > 0:
        write_forces(basename + "_f", mesh.n_nodes, factor, rows, n_rows=mesh.n_nodes - 1)
    return mesh


def main(argv: Optional[list] = None) -> int:
    """CLI: the 13 positional arguments of the reference meshGen."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 13:
        print(
            "usage: femshell-meshgen type nx ny min_x min_y max_x max_y "
            "bcids factor loading ul_lr dead-axis filename"
        )
        return -1
    bc = tuple(int(v) for v in args[7].split(","))
    if len(bc) != 4:
        print("bcids must be a comma-separated list of 4 ids (use -1 for none)")
        return -1
    p = MeshGenParams(
        elem_type=args[0].lower(),
        nx=int(args[1]),
        ny=int(args[2]),
        min_x=float(args[3]),
        min_y=float(args[4]),
        max_x=float(args[5]),
        max_y=float(args[6]),
        bcids=bc,  # type: ignore[arg-type]
        factor=float(args[8]),
        loading=int(args[9]),
        ul_lr=int(args[10]) == 1,
        dead_axis=args[11],
    )
    write_files(p, args[12])
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

"""Plate meshes made from a configuration's recipe, in memory.

The benchmark makes its inputs itself and hands the same arrays to the
program and to the plain reference. A recipe (``configs/<name>.json``,
key ``mesh``) names a rectangular plate in the z = 0 plane:

- ``elem``: ``"t"`` (Tri-3, each cell split along its lower-left to
  upper-right diagonal as the reference's meshGen does with ``ul_lr``)
  or ``"q"`` (Quad-4);
- ``nx``, ``ny`` cells over ``lx`` x ``ly``;
- ``support``: ``"simply_supported"`` constrains u, v and w on every edge
  node (the reference's bc id 0, fem-shell.cpp:87-120);
- ``renumber_seed``: null keeps the row-major node order; an integer
  renumbers the nodes by ``numpy.random.default_rng(seed).permutation``,
  as an arbitrarily ordered mesh from a mesh generator would come.

Nodes are row-major (node = iy (nx + 1) + ix) before any renumbering.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Plate:
    coords: np.ndarray  # [N, 3] f64
    conn: np.ndarray  # [E, m] int64, m = 3 (Tri-3) or 4 (Quad-4)
    elem: str  # "t" | "q"
    fixed: np.ndarray  # [N, 6] bool, True where the dof is constrained to zero
    dx: float  # cell widths: the nodal tributary area of a uniform load is dx * dy
    dy: float
    lx: float
    ly: float

    @property
    def n_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def n_elems(self) -> int:
        return int(self.conn.shape[0])


def plate(recipe: dict) -> Plate:
    elem, nx, ny = recipe["elem"], int(recipe["nx"]), int(recipe["ny"])
    lx, ly = float(recipe["lx"]), float(recipe["ly"])
    if elem not in ("t", "q"):
        raise ValueError(f"mesh elem {elem!r}: 't' (Tri-3) or 'q' (Quad-4)")
    if recipe["support"] != "simply_supported":
        raise ValueError(f"mesh support {recipe['support']!r}: only 'simply_supported'")
    nxp = nx + 1
    dx, dy = lx / nx, ly / ny
    gx, gy = np.meshgrid(dx * np.arange(nx + 1), dy * np.arange(ny + 1))
    coords = np.zeros(((nx + 1) * (ny + 1), 3))
    coords[:, 0] = gx.reshape(-1)
    coords[:, 1] = gy.reshape(-1)
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n0 = (xx + yy * nxp).reshape(-1).astype(np.int64)
    if elem == "q":
        conn = np.stack([n0, n0 + 1, n0 + nxp + 1, n0 + nxp], axis=1)
    else:
        tri1 = np.stack([n0, n0 + 1, n0 + nxp], axis=1)
        tri2 = np.stack([n0 + 1, n0 + nxp + 1, n0 + nxp], axis=1)
        conn = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
    iy, ix = np.divmod(np.arange(coords.shape[0]), nxp)
    edge = (ix == 0) | (ix == nx) | (iy == 0) | (iy == ny)
    fixed = np.zeros((coords.shape[0], 6), dtype=bool)
    fixed[edge, 0:3] = True
    out = Plate(coords, conn, elem, fixed, dx, dy, lx, ly)
    seed: Optional[int] = recipe.get("renumber_seed")
    return out if seed is None else renumbered(out, np.random.default_rng(int(seed)).permutation(out.n_nodes))


def renumbered(p: Plate, order: np.ndarray) -> Plate:
    """The same plate with new node j = old node order[j]."""
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return dataclasses.replace(p, coords=p.coords[order], conn=rank[p.conn], fixed=p.fixed[order])

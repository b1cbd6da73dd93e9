"""Curved-shell benchmark geometry: the Scordelis-Lo roof — port of
``fem_shell_tpu/shells.py``.

The roof is built as a row-major structured Quad-4 grid, the layout
``mg.detect_structured_grid`` recognizes, so the multigrid solver runs on
it with Galerkin coarse levels (``mg.stencil_rap``; the class-table fine
operator needs affine coordinates and is not used on a curved grid).

Scordelis-Lo setup (canonical): cylindrical roof, radius 25, length 50,
80-degree opening, thickness 0.25, E = 4.32e8, nu = 0, self-weight 90 per
unit midsurface area downward; axial ends on rigid diaphragms (u_x = u_z
= 0), straight edges free. Target: vertical midside free-edge deflection
0.3024 (flat facets converge to it from below).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh

SCORDELIS_LO_GOLDEN_W = -0.3024  # MacNeal-Harder target (downward)
SCORDELIS_LO_MATERIAL = Material(nu=0.0, em=4.32e8, thickness=0.25)


def scordelis_lo(
    n_arc: int,
    n_axial: Optional[int] = None,
    radius: float = 25.0,
    length: float = 50.0,
    half_angle_deg: float = 40.0,
    load: float = -90.0,
) -> Tuple[ShellMesh, np.ndarray, int]:
    """Scordelis-Lo roof as a row-major structured Quad-4 grid: columns
    (the fast axis) run along the arc, rows along the cylinder axis (node
    = iy*nxp + ix). Returns ``(mesh, forces [N, 6], midside_node)``, the
    midside node being the free-edge node whose vertical displacement
    carries the 0.3024 golden; ``n_axial`` (default ``n_arc``) must be
    even so that the midside row is a node row."""
    from fem_shell_tpu_torch.mg import _grid_conn  # mg imports the mesh layer only

    if n_axial is None:
        n_axial = n_arc
    if n_axial % 2:
        raise ValueError("n_axial must be even (midside row must be a node row)")
    nxp, nyp = n_arc + 1, n_axial + 1
    phi0 = np.deg2rad(half_angle_deg)
    ix = np.arange(nxp)
    iy = np.arange(nyp)
    phi = phi0 * (2.0 * ix / (nxp - 1) - 1.0)
    x = radius * np.sin(phi)
    z = radius * np.cos(phi)
    y = length * iy / (nyp - 1)
    coords = np.stack(
        [
            np.broadcast_to(x[None, :], (nyp, nxp)),
            np.broadcast_to(y[:, None], (nyp, nxp)),
            np.broadcast_to(z[None, :], (nyp, nxp)),
        ],
        axis=-1,
    ).reshape(-1, 3)

    types, conn = _grid_conn(nxp, nyp, "q", True)

    # rigid diaphragms at the axial ends: u_x = u_z = 0, u_y and every
    # rotation free (no reference bc id says this: node_dirichlet_mask)
    mask = np.zeros((nxp * nyp, 6), bool)
    ends = np.concatenate([np.arange(nxp), np.arange(nxp) + (nyp - 1) * nxp])
    mask[ends, 0] = True
    mask[ends, 2] = True

    mesh = ShellMesh(coords, types, conn, np.zeros((0, 3), np.int32), node_dirichlet_mask=mask)

    # dead load per unit midsurface area: equal nodal shares of each
    # facet's area
    q = mesh.quad
    p0, p1, p2, p3 = (coords[q[:, k]] for k in range(4))
    area = 0.5 * np.linalg.norm(np.cross(p2 - p0, p3 - p1), axis=1)
    forces = np.zeros((nxp * nyp, 6))
    np.add.at(forces[:, 2], q.reshape(-1), np.repeat(load * area / 4.0, 4))

    midside = (n_axial // 2) * nxp  # ix = 0 free edge, middle row
    return mesh, forces, midside

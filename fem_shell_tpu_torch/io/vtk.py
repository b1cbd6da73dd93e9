"""Result export — the libMesh ExodusII/VTK writer analog
(fem-shell.cpp:1240-1251; fem-shell_precice.cpp:1526-1561). A copy of
``fem_shell_tpu/io/vtk.py``: the same mesh and the same ``u`` array give
the same bytes.

Writes ParaView-compatible files:
- XML UnstructuredGrid ``.vtu`` (modern, per-timestep series friendly)
- legacy ASCII ``.vtk`` (maximum-compatibility fallback)

The reference emits ExodusII ``.e``; Exodus is a netCDF container not
available in this environment, so the VTK family is the supported export
(ParaView reads both). Displacements/rotations are written as point data
vectors; the displaced geometry is written when ``displace=True``, matching
the reference's behavior of adding (u,v,w) to node coords before export
(fem-shell.cpp:171-175).
"""
from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np

from fem_shell_tpu_torch.mesh import ShellMesh, XDA_TRI3

_VTK_TRI = 5
_VTK_QUAD = 9


def _cells(mesh: ShellMesh):
    types = np.where(mesh.elem_types == XDA_TRI3, _VTK_TRI, _VTK_QUAD)
    sizes = np.where(mesh.elem_types == XDA_TRI3, 3, 4)
    conn = []
    for e in range(mesh.n_elems):
        conn.extend(int(v) for v in mesh.elem_conn[e, : sizes[e]])
    offsets = np.cumsum(sizes)
    return types, sizes, np.array(conn, dtype=np.int64), offsets


def write_vtu(
    mesh: ShellMesh,
    path: str,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    displacement: Optional[np.ndarray] = None,
    displace: bool = False,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write an XML .vtu file. ``displacement`` is the [N,6] solution; its
    translational part is exported as a 3-vector 'displacement' and the
    rotational part as 'rotation'. ``displace=True`` moves the geometry.
    ``cell_data`` arrays are per-element in MESH element order."""
    point_data = dict(point_data or {})
    cell_data = dict(cell_data or {})
    coords = mesh.coords.copy()
    if displacement is not None:
        displacement = np.asarray(displacement)
        point_data.setdefault("displacement", displacement[:, 0:3])
        point_data.setdefault("rotation", displacement[:, 3:6])
        if displace:
            coords = coords + displacement[:, 0:3]
    types, _, conn, offsets = _cells(mesh)

    buf = io.StringIO()
    w = buf.write
    w('<?xml version="1.0"?>\n')
    w('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
    w("  <UnstructuredGrid>\n")
    w(f'    <Piece NumberOfPoints="{mesh.n_nodes}" NumberOfCells="{mesh.n_elems}">\n')
    w("      <Points>\n")
    w('        <DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
    for p in coords:
        w(f"          {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
    w("        </DataArray>\n      </Points>\n")
    w("      <Cells>\n")
    w('        <DataArray type="Int64" Name="connectivity" format="ascii">\n')
    w("          " + " ".join(str(v) for v in conn) + "\n")
    w("        </DataArray>\n")
    w('        <DataArray type="Int64" Name="offsets" format="ascii">\n')
    w("          " + " ".join(str(int(v)) for v in offsets) + "\n")
    w("        </DataArray>\n")
    w('        <DataArray type="UInt8" Name="types" format="ascii">\n')
    w("          " + " ".join(str(int(v)) for v in types) + "\n")
    w("        </DataArray>\n      </Cells>\n")
    w("      <PointData>\n")
    for name, arr in point_data.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        ncomp = arr.shape[1]
        w(f'        <DataArray type="Float64" Name="{name}" NumberOfComponents="{ncomp}" format="ascii">\n')
        for row in arr:
            w("          " + " ".join(f"{v:.17g}" for v in row) + "\n")
        w("        </DataArray>\n")
    w("      </PointData>\n")
    if cell_data:
        w("      <CellData>\n")
        for name, arr in cell_data.items():
            arr = np.asarray(arr)
            if arr.ndim == 1:
                arr = arr[:, None]
            ncomp = arr.shape[1]
            w(f'        <DataArray type="Float64" Name="{name}" NumberOfComponents="{ncomp}" format="ascii">\n')
            for row in arr:
                w("          " + " ".join(f"{v:.17g}" for v in row) + "\n")
            w("        </DataArray>\n")
        w("      </CellData>\n")
    w("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")
    with open(path, "w") as fh:
        fh.write(buf.getvalue())


def write_legacy_vtk(
    mesh: ShellMesh,
    path: str,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    displacement: Optional[np.ndarray] = None,
    displace: bool = False,
) -> None:
    """Write a legacy ASCII .vtk file (same data model as write_vtu)."""
    point_data = dict(point_data or {})
    coords = mesh.coords.copy()
    if displacement is not None:
        displacement = np.asarray(displacement)
        point_data.setdefault("displacement", displacement[:, 0:3])
        point_data.setdefault("rotation", displacement[:, 3:6])
        if displace:
            coords = coords + displacement[:, 0:3]
    types, sizes, conn, offsets = _cells(mesh)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nfem_shell_tpu output\nASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {mesh.n_nodes} double\n")
        for p in coords:
            fh.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        total = int(sizes.sum()) + mesh.n_elems
        fh.write(f"CELLS {mesh.n_elems} {total}\n")
        start = 0
        for e in range(mesh.n_elems):
            s = int(sizes[e])
            ids = " ".join(str(int(v)) for v in conn[start : start + s])
            fh.write(f"{s} {ids}\n")
            start += s
        fh.write(f"CELL_TYPES {mesh.n_elems}\n")
        for t in types:
            fh.write(f"{int(t)}\n")
        if point_data:
            fh.write(f"POINT_DATA {mesh.n_nodes}\n")
            for name, arr in point_data.items():
                arr = np.asarray(arr)
                if arr.ndim == 1:
                    arr = arr[:, None]
                if arr.shape[1] == 3:
                    fh.write(f"VECTORS {name} double\n")
                    for row in arr:
                        fh.write(" ".join(f"{v:.17g}" for v in row) + "\n")
                else:
                    fh.write(f"SCALARS {name} double {arr.shape[1]}\n")
                    fh.write("LOOKUP_TABLE default\n")
                    for row in arr:
                        fh.write(" ".join(f"{v:.17g}" for v in row) + "\n")

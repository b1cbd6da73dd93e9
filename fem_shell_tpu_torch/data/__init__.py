"""Embedded hand-made example meshes (tests A/B/E fixtures) — copies of
``fem_shell_tpu/data``.

The structured meshes (C/D/F/G) are regenerated from parameters by
fem_shell_tpu_torch.meshgen; only the hand-made cantilever (A/B) and
I-beam (E) geometries are carried as data, transcribed from the reference
test fixtures (coordinates/connectivity/BCs/loads — data, not code). The
helpers below build ShellMesh objects from them, including the mixed
Tri-3/Quad-4 I-beam of the golden tests.
"""
import numpy as np

from fem_shell_tpu_torch.data import test_a, test_b, test_e  # noqa: F401
from fem_shell_tpu_torch.mesh import XDA_QUAD4, XDA_TRI3, ShellMesh


def mesh_from_tris(coords, tris, boundary_sides) -> ShellMesh:
    ne = tris.shape[0]
    conn = np.hstack([tris, np.full((ne, 1), -1, np.int32)])
    return ShellMesh(coords, np.full(ne, XDA_TRI3, np.int32), conn, boundary_sides)


def mesh_from_quads(coords, quads, boundary_sides) -> ShellMesh:
    ne = quads.shape[0]
    return ShellMesh(coords, np.full(ne, XDA_QUAD4, np.int32), quads, boundary_sides)


def mixed_ibeam_mesh() -> ShellMesh:
    """Test E's I-beam with both element families: the z=0 flanges keep
    the reference Tri-3 split, the web and the z=5 flanges are Quad-4
    panels (32 tris + 24 quads in one assembly)."""
    e = test_e
    types, conn, bsides = [], [], []
    tri_pairs = {
        1: lambda i: ([18 + i, 19 + i, i], [19 + i, i + 1, i]),
        2: lambda i: ([i, i + 1, 27 + i], [i + 1, 28 + i, 27 + i]),
    }
    for p in range(5):
        first = len(types)
        if p in (0, 3, 4):
            for i in range(8):
                types.append(XDA_QUAD4)
                conn.append(list(e._QUAD_PANELS[p](i)))
            bsides.append([first, 3, 0])
        else:
            for i in range(8):
                t1, t2 = tri_pairs[p](i)
                types += [XDA_TRI3, XDA_TRI3]
                conn += [t1 + [-1], t2 + [-1]]
            bsides.append([first, 2, 0])
    return ShellMesh(e.COORDS, np.array(types, np.int32), np.array(conn, np.int32),
                     np.array(bsides, np.int32))

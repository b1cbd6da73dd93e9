"""Gmsh MSH 2.x ASCII reader — the libMesh GmshIO analog for the subset
the reference supports (doc/implementation.tex:77-125):

- ``$Nodes``: 1-based node ids with xyz coordinates
- ``$Elements``: (index, type, n_tags, physical, geometrical, ...tags,
  node ids); type 2 = TRI3 and 3 = QUAD4 define the mesh; type 15 (point)
  and 1 (2-node line) define nodal boundary conditions, with the physical
  entity tag as the bc id (libMesh convention the reference relies on).

A copy of ``fem_shell_tpu/io/gmsh.py``: the same file gives the same
arrays.
"""
from __future__ import annotations

import numpy as np

from fem_shell_tpu_torch.mesh import ShellMesh, XDA_QUAD4, XDA_TRI3

_MSH_TRI = 2
_MSH_QUAD = 3
_MSH_LINE = 1
_MSH_POINT = 15


def read_msh(path: str) -> ShellMesh:
    with open(path, "r") as fh:
        lines = [l.strip() for l in fh]
    i = 0

    def find(tag):
        nonlocal i
        while i < len(lines) and lines[i] != tag:
            i += 1
        if i >= len(lines):
            raise ValueError(f"{path}: missing {tag} section")
        i += 1

    find("$Nodes")
    n_nodes = int(lines[i])
    i += 1
    ids = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3), dtype=np.float64)
    for j in range(n_nodes):
        parts = lines[i + j].split()
        ids[j] = int(parts[0])
        coords[j] = [float(parts[1]), float(parts[2]), float(parts[3])]
    i += n_nodes
    # map (possibly sparse, 1-based) msh node ids -> dense 0-based ids
    id_map = {int(v): k for k, v in enumerate(ids)}

    find("$Elements")
    n_elems = int(lines[i])
    i += 1
    etypes, conns = [], []
    bnodes = []
    for j in range(n_elems):
        parts = [int(p) for p in lines[i + j].split()]
        etype, n_tags = parts[1], parts[2]
        phys = parts[3] if n_tags >= 1 else 0
        node_ids = [id_map[p] for p in parts[3 + n_tags :]]
        if etype == _MSH_TRI:
            etypes.append(XDA_TRI3)
            conns.append(node_ids[:3] + [-1])
        elif etype == _MSH_QUAD:
            etypes.append(XDA_QUAD4)
            conns.append(node_ids[:4])
        elif etype in (_MSH_POINT, _MSH_LINE):
            for n in node_ids:
                bnodes.append((n, phys))
        else:
            raise ValueError(f"{path}: unsupported msh element type {etype}")
    return ShellMesh(
        coords,
        np.asarray(etypes, np.int32),
        np.asarray(conns, np.int32).reshape(-1, 4),
        np.zeros((0, 3), np.int32),
        boundary_nodes=np.asarray(bnodes, np.int32).reshape(-1, 2),
    )

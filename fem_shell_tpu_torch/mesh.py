"""Mesh data structures and XDA / force-file input.

Port of ``fem_shell_tpu/mesh.py``: the mesh is a set of flat numpy arrays
(coordinates ``[N,3]``, per-type connectivity ``tri [Et,3]`` /
``quad [Eq,4]``, boundary-side records ``[B,3]``) and the per-node
Dirichlet mask derived from them. Tensors for the device are built by the
assembler, not here.

File formats parsed (behavioural parity with the reference):
- libMesh XDA ASCII meshes (files written by src/meshgen/main_all.cpp:
  226-338). Element type codes: 3 = TRI3, 5 = QUAD4.
- ``<mesh>_f`` nodal force files (fem-shell.cpp:41-67): token stream
  ``n_forces factor`` then 6 values (Fx Fy Fz Mx My Mz) per node, each
  scaled by ``factor``. meshGen writes only ``n_nodes-1`` force rows
  (main_all.cpp:352,377); missing trailing values read as zero, exactly as
  the C++ ``operator>>`` at EOF leaves the zero-initialized DenseVector.

Boundary-condition semantics (fem-shell.cpp:87-120):
- side records project onto nodes (BoundaryInfo::build_node_list_from_side_list)
- bc ids {0, 20}: "simply supported" -> constrain u, v, w
- bc ids {1, 21}: "clamped"          -> constrain u, v, w, tx, ty, tz

Output: ``write_xda`` and ``write_forces`` write the dialect meshGen
writes, byte for byte as the JAX package's writers do.

Node reordering and refinement: ``rcm_order`` (reverse Cuthill-McKee,
scipy's or a pure-numpy fallback), ``permute_nodes``, ``refine_uniform``
and ``bandwidth``, element for element as the JAX package's.

Other formats the reference accepts (fem-shell.cpp:45-47): libMesh's XDR
binary encoding of the XDA record stream (``read_xdr``, ``write_xdr``)
and Gmsh 2.x ASCII (``io/gmsh.py``), chosen by ``read_mesh`` from the
file's extension.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Sequence, Tuple

import numpy as np

# libMesh element type codes as they appear in XDA files.
XDA_TRI3 = 3
XDA_QUAD4 = 5

# side -> (local node, local node), libMesh convention for TRI3/QUAD4 edges.
TRI_SIDES = ((0, 1), (1, 2), (2, 0))
QUAD_SIDES = ((0, 1), (1, 2), (2, 3), (3, 0))

# Dirichlet semantics (fem-shell.cpp:90-120)
SIMPLY_SUPPORTED_IDS = (0, 20)  # constrain u,v,w
CLAMPED_IDS = (1, 21)  # constrain all 6 dofs
COUPLING_IDS = (2, 20, 21)  # FSI interface node discovery


@dataclasses.dataclass
class ShellMesh:
    """Host-side mesh container (numpy).

    ``elem_types``/``elem_conn`` keep the file element order (boundary-side
    records refer to it); ``tri``/``quad`` are the per-type compacted
    connectivities the batched element kernels take.
    """

    coords: np.ndarray  # [N,3] float64
    elem_types: np.ndarray  # [E] int32, XDA type codes
    elem_conn: np.ndarray  # [E,4] int32, -1 padded for TRI3
    boundary_sides: np.ndarray  # [B,3] int32 rows (elem, side, bc_id)
    boundary_nodes: np.ndarray = None  # [M,2] int32 rows (node, bc_id)
    node_dirichlet_mask: np.ndarray = None  # optional [N,6] bool OR-ed into dirichlet_mask()

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)
        self.elem_types = np.asarray(self.elem_types, dtype=np.int32)
        self.elem_conn = np.asarray(self.elem_conn, dtype=np.int32)
        self.boundary_sides = np.asarray(self.boundary_sides, dtype=np.int32).reshape(-1, 3)
        if self.boundary_nodes is None:
            self.boundary_nodes = np.zeros((0, 2), dtype=np.int32)
        self.boundary_nodes = np.asarray(self.boundary_nodes, dtype=np.int32).reshape(-1, 2)
        tri_mask = self.elem_types == XDA_TRI3
        quad_mask = self.elem_types == XDA_QUAD4
        self.tri = self.elem_conn[tri_mask][:, :3].astype(np.int32)
        self.quad = self.elem_conn[quad_mask].astype(np.int32)

    @property
    def n_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def n_elems(self) -> int:
        return int(self.elem_types.shape[0])

    @property
    def n_dofs(self) -> int:
        return 6 * self.n_nodes

    def side_nodes(self, elem: int, side: int) -> Tuple[int, int]:
        """Global node ids of an element edge (libMesh side convention)."""
        if self.elem_types[elem] == XDA_TRI3:
            a, b = TRI_SIDES[side]
        else:
            a, b = QUAD_SIDES[side]
        return int(self.elem_conn[elem, a]), int(self.elem_conn[elem, b])

    def boundary_node_ids(self, bc_ids: Sequence[int]) -> np.ndarray:
        """Sorted unique node ids carrying any of ``bc_ids`` (side records
        projected onto their two nodes, plus nodal records)."""
        wanted = set(int(b) for b in bc_ids)
        nodes = set()
        for elem, side, bcid in self.boundary_sides:
            if int(bcid) in wanted:
                a, b = self.side_nodes(int(elem), int(side))
                nodes.add(a)
                nodes.add(b)
        for node, bcid in self.boundary_nodes:
            if int(bcid) in wanted:
                nodes.add(int(node))
        return np.array(sorted(nodes), dtype=np.int32)

    def dirichlet_mask(self) -> np.ndarray:
        """Boolean [N,6] mask, True where the dof is constrained to zero
        (the two DirichletBoundary objects of fem-shell.cpp:87-120)."""
        mask = np.zeros((self.n_nodes, 6), dtype=bool)
        ss = self.boundary_node_ids(SIMPLY_SUPPORTED_IDS)
        cl = self.boundary_node_ids(CLAMPED_IDS)
        if ss.size:
            mask[ss, 0:3] = True
        if cl.size:
            mask[cl, :] = True
        if self.node_dirichlet_mask is not None:
            mask |= np.asarray(self.node_dirichlet_mask, bool)
        return mask

    def coupling_node_ids(self) -> np.ndarray:
        """FSI interface nodes: bc ids 2/20/21 (fem-shell_precice.cpp:62-70)."""
        return self.boundary_node_ids(COUPLING_IDS)

    def adjacency_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """All (row, col) node-coupling pairs from the connectivity
        (duplicates included): the sparsity graph. Without elements, the
        diagonal."""
        rows, cols = [], []
        for conn in (self.tri, self.quad):
            if len(conn) == 0:
                continue
            m = conn.shape[1]
            for a in range(m):
                for b in range(m):
                    rows.append(conn[:, a])
                    cols.append(conn[:, b])
        if not rows:
            n = np.arange(self.n_nodes, dtype=np.int32)
            return n, n
        return np.concatenate(rows), np.concatenate(cols)

    def node_adjacency(self) -> List[np.ndarray]:
        """Per-node sorted neighbour lists (self included) from the
        connectivity."""
        n = self.n_nodes
        r, c = self.adjacency_coo()
        keys = np.unique(np.concatenate([r.astype(np.int64) * n + c,
                                         np.arange(n, dtype=np.int64) * (n + 1)]))
        cols = (keys % n).astype(np.int32)
        return np.split(cols, np.cumsum(np.bincount(keys // n, minlength=n))[:-1])



# ----------------------------------------------------------------------
# node reordering (bandwidth reduction) and uniform refinement
# ----------------------------------------------------------------------


def rcm_order(mesh: ShellMesh) -> np.ndarray:
    """Reverse Cuthill-McKee node order: ``order[new] = old``. Uses
    scipy.sparse.csgraph when available, else a pure-numpy BFS RCM (a
    minimum-degree root, neighbours visited in degree order, reversed)."""
    n = mesh.n_nodes
    r, c = mesh.adjacency_coo()
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        g = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n)).tocsr()
        return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), dtype=np.int64)
    except ImportError:  # pragma: no cover - scipy is installed wherever the port runs
        pass
    return _rcm_numpy(n, r, c)


def _rcm_numpy(n: int, r: np.ndarray, c: np.ndarray) -> np.ndarray:
    order_ind = np.lexsort((c, r))
    rs, cs = r[order_ind], c[order_ind]
    starts = np.searchsorted(rs, np.arange(n + 1))
    deg = np.diff(starts)
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    pos = 0
    while pos < n:
        root = int(np.argmin(np.where(visited, n + 1, deg)))
        queue = [root]
        visited[root] = True
        while queue:
            v = queue.pop(0)
            out[pos] = v
            pos += 1
            nbrs = cs[starts[v] : starts[v + 1]]
            nbrs = np.unique(nbrs[~visited[nbrs]])
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(x) for x in nbrs)
    return out[::-1].copy()


def permute_nodes(mesh: ShellMesh, order: np.ndarray) -> ShellMesh:
    """Relabelled mesh with ``new node j = old node order[j]``. Boundary
    side records are element-based and unaffected; nodal records relabel."""
    n = mesh.n_nodes
    order = np.asarray(order, np.int64)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    conn = mesh.elem_conn.copy()
    conn[conn >= 0] = rank[conn[conn >= 0]].astype(conn.dtype)
    bnodes = mesh.boundary_nodes.copy()
    if len(bnodes):
        bnodes[:, 0] = rank[bnodes[:, 0]].astype(bnodes.dtype)
    nmask = (None if mesh.node_dirichlet_mask is None
             else np.asarray(mesh.node_dirichlet_mask, bool)[order])
    return ShellMesh(mesh.coords[order], mesh.elem_types, conn, mesh.boundary_sides,
                     bnodes, node_dirichlet_mask=nmask)


def refine_uniform(mesh: ShellMesh, levels: int = 1) -> ShellMesh:
    """Uniform midpoint refinement, ``levels`` times: every TRI3 splits
    into 4 TRI3, every QUAD4 into 4 QUAD4 (edge midpoints and quad
    centres). Boundary side records go to the two child sides along each
    parent side; nodal records keep the original nodes and add the
    midpoints of edges whose two ends carry the same bc id."""
    m = mesh
    for _ in range(levels):
        m = _refine_once(m)
    return m


def _refine_once(mesh: ShellMesh) -> ShellMesh:
    conn = mesh.elem_conn
    types = mesh.elem_types
    n = mesh.n_nodes

    edges = []  # every element side, unique undirected edges below
    for e in range(mesh.n_elems):
        for a, b in (TRI_SIDES if types[e] == XDA_TRI3 else QUAD_SIDES):
            edges.append((conn[e, a], conn[e, b]))
    edges = np.asarray(edges, np.int64)
    key = np.minimum(edges[:, 0], edges[:, 1]) * (n + 1) + np.maximum(edges[:, 0], edges[:, 1])
    ukey = np.unique(key)
    mid_of = {int(k): n + i for i, k in enumerate(ukey)}
    ua = (ukey // (n + 1)).astype(np.int64)
    ub = (ukey % (n + 1)).astype(np.int64)
    mid_coords = 0.5 * (mesh.coords[ua] + mesh.coords[ub])

    def mid(i, j):
        i, j = int(i), int(j)
        return mid_of[min(i, j) * (n + 1) + max(i, j)]

    new_conn, new_types, centers = [], [], []
    child_of = {}  # (parent element, slot) -> child element
    for e in range(mesh.n_elems):
        if types[e] == XDA_TRI3:
            a, b, c = (int(v) for v in conn[e, :3])
            d, ee, f = mid(a, b), mid(b, c), mid(c, a)
            kids = [(a, d, f, -1), (d, b, ee, -1), (f, ee, c, -1), (d, ee, f, -1)]
            tt = XDA_TRI3
        else:
            a, b, c, dd = (int(v) for v in conn[e])
            ce = len(centers) + n + len(ukey)
            centers.append(0.25 * (mesh.coords[[a, b, c, dd]].sum(axis=0)))
            e0, f0, g0, h0 = mid(a, b), mid(b, c), mid(c, dd), mid(dd, a)
            kids = [(a, e0, ce, h0), (e0, b, f0, ce), (ce, f0, c, g0), (h0, ce, g0, dd)]
            tt = XDA_QUAD4
        for slot, kid in enumerate(kids):
            child_of[(e, slot)] = len(new_conn)
            new_conn.append(kid)
            new_types.append(tt)

    coords = np.vstack([mesh.coords, mid_coords] + ([np.asarray(centers)] if centers else []))
    bs = []  # parent side s -> (child s, side s) and (child (s+1) % ns, side s)
    for e, s, bc in mesh.boundary_sides:
        ns = 3 if types[e] == XDA_TRI3 else 4
        bs.append((child_of[(int(e), int(s))], int(s), int(bc)))
        bs.append((child_of[(int(e), (int(s) + 1) % ns)], int(s), int(bc)))
    bs = np.asarray(bs, np.int32).reshape(-1, 3)

    bn = mesh.boundary_nodes
    if len(bn):
        per_node = {}
        for node, bc in bn:
            per_node.setdefault(int(bc), set()).add(int(node))
        extra = []
        for bc, nodes in per_node.items():
            for i, (ka, kb) in enumerate(zip(ua, ub)):
                if int(ka) in nodes and int(kb) in nodes:
                    extra.append((n + i, bc))
        bn = np.vstack([bn, np.asarray(extra, np.int32).reshape(-1, 2)]) if extra else bn

    return ShellMesh(coords, np.asarray(new_types, np.int32), np.asarray(new_conn, np.int32), bs, bn)


def bandwidth(mesh: ShellMesh) -> int:
    """Max |i - j| over coupled node pairs (0 for a point cloud)."""
    r, c = mesh.adjacency_coo()
    return int(np.abs(r.astype(np.int64) - c.astype(np.int64)).max()) if len(r) else 0


_NODES_PER_TYPE = {XDA_TRI3: 3, XDA_QUAD4: 4}


def _strip_comment(line: str) -> str:
    return line.split("#", 1)[0].strip()


def read_xda(path: str) -> ShellMesh:
    """Parse a libMesh ASCII XDA mesh (the subset meshGen writes)."""
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    if not lines or not lines[0].startswith("libMesh"):
        raise ValueError(f"{path}: not a libMesh XDA file")
    n_elem = int(_strip_comment(lines[1]).split()[0])
    n_nodes = int(_strip_comment(lines[2]).split()[0])
    # lines[3..6]: bc / subdomain / processor / p-level spec files;
    # lines[7]: n_elem at level 0
    idx = 8
    elem_types = np.empty(n_elem, dtype=np.int32)
    elem_conn = np.full((n_elem, 4), -1, dtype=np.int32)
    for e in range(n_elem):
        parts = _strip_comment(lines[idx + e]).split()
        t = int(parts[0])
        if t not in _NODES_PER_TYPE:
            raise ValueError(f"{path}: unsupported XDA element type {t}")
        nn = _NODES_PER_TYPE[t]
        elem_types[e] = t
        elem_conn[e, :nn] = [int(p) for p in parts[1 : 1 + nn]]
    idx += n_elem
    coords = np.empty((n_nodes, 3), dtype=np.float64)
    for i in range(n_nodes):
        parts = _strip_comment(lines[idx + i]).split()
        coords[i] = [float(parts[0]), float(parts[1]), float(parts[2])]
    idx += n_nodes
    n_bc = (
        int(_strip_comment(lines[idx]).split()[0])
        if idx < len(lines) and _strip_comment(lines[idx])
        else 0
    )
    idx += 1
    bcs = np.zeros((n_bc, 3), dtype=np.int32)
    for b in range(n_bc):
        parts = _strip_comment(lines[idx + b]).split()
        bcs[b] = [int(parts[0]), int(parts[1]), int(parts[2])]
    return ShellMesh(coords, elem_types, elem_conn, bcs)


def _fmt_g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{x:.6g}"


def write_xda(mesh: ShellMesh, path: str) -> None:
    """Write the mesh in the XDA dialect meshGen produces
    (main_all.cpp:232-338), so outputs stay loadable by the reference."""
    out = [
        "libMesh-0.7.0+",
        f"{mesh.n_elems}      # number of elements",
        f"{mesh.n_nodes}      # number of nodes",
        ".        # boundary condition specification file",
        "n/a      # subdomain id specification file",
        "n/a      # processor id specification file",
        "n/a      # p-level specification file",
        f"{mesh.n_elems}      # n_elem at level 0, [ type (n0 ... nN-1) ]",
    ]
    for e in range(mesh.n_elems):
        t = int(mesh.elem_types[e])
        conn = " ".join(str(int(v)) for v in mesh.elem_conn[e, : _NODES_PER_TYPE[t]])
        out.append(f"{t} {conn}")
    for x, y, z in mesh.coords:
        out.append(f"{_fmt_g(x)} {_fmt_g(y)} {_fmt_g(z)}")
    out.append(f"{len(mesh.boundary_sides)}        # number of boundary conditions")
    for elem, side, bcid in mesh.boundary_sides:
        out.append(f"{int(elem)} {int(side)} {int(bcid)}")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def write_forces(path: str, n_nodes: int, factor: float, rows: np.ndarray, n_rows: int | None = None) -> None:
    """Write a ``_f`` file. ``rows`` is [n,6] *unscaled* per-node rows;
    ``n_rows`` lets the caller reproduce the meshGen ``n_nodes-1`` quirk."""
    rows = np.asarray(rows)
    if n_rows is None:
        n_rows = rows.shape[0]
    out = [f"{n_nodes}", _fmt_g(factor)]
    for i in range(n_rows):
        out.append(" ".join(_fmt_g(v) for v in rows[i]))
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def force_path_for(mesh_path: str) -> str:
    """``<mesh>_f`` naming convention (fem-shell.cpp:42-50)."""
    base, ext = os.path.splitext(mesh_path)
    if ext in (".xda", ".xdr", ".msh"):
        return base + "_f"
    return mesh_path + "_f"


def read_forces(path: str, n_nodes: int) -> np.ndarray:
    """Read a ``_f`` nodal force file into an [N,6] array; missing trailing
    tokens read as zero (see the module docstring)."""
    with open(path, "r") as fh:
        toks = fh.read().split()
    if not toks:
        return np.zeros((n_nodes, 6), dtype=np.float64)
    n_forces = int(float(toks[0]))
    factor = float(toks[1]) if len(toks) > 1 else 1.0
    vals = np.zeros(n_forces * 6, dtype=np.float64)
    data = toks[2 : 2 + n_forces * 6]
    vals[: len(data)] = [float(t) for t in data]
    forces = vals.reshape(n_forces, 6) * factor
    if n_forces < n_nodes:
        forces = np.vstack([forces, np.zeros((n_nodes - n_forces, 6))])
    return forces[:n_nodes]


# ----------------------------------------------------------------------
# XDR (binary XDA) reader / writer
# ----------------------------------------------------------------------
#
# .xdr is libMesh's XDR-binary encoding of the record stream the ASCII XDA
# carries. Encoding follows RFC 4506 primitives as libMesh's Xdr class
# uses them: 4-byte big-endian ints, 8-byte big-endian IEEE doubles,
# strings as (u32 length + bytes + zero padding to a 4-byte boundary).


def _xdr_pack_str(s: str) -> bytes:
    b = s.encode()
    pad = (-len(b)) % 4
    return struct.pack(">i", len(b)) + b + b"\0" * pad


class _XdrReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def ints(self, n: int):
        out = struct.unpack_from(f">{n}i", self.data, self.pos)
        self.pos += 4 * n
        return out

    def doubles(self, n: int):
        out = struct.unpack_from(f">{n}d", self.data, self.pos)
        self.pos += 8 * n
        return out

    def string(self) -> str:
        (n,) = self.ints(1)
        s = self.data[self.pos : self.pos + n].decode()
        self.pos += n + ((-n) % 4)
        return s


def write_xdr(mesh: ShellMesh, path: str) -> None:
    """Binary XDR counterpart of write_xda: the same record stream,
    XDR-encoded. Round-trips bit-exactly (coordinates are stored as raw
    f64, unlike the 6-significant-digit ASCII formatting)."""
    out = [_xdr_pack_str("libMesh-0.7.0+")]
    out.append(struct.pack(">2i", mesh.n_elems, mesh.n_nodes))
    for s in (".", "n/a", "n/a", "n/a"):
        out.append(_xdr_pack_str(s))
    out.append(struct.pack(">i", mesh.n_elems))
    for e in range(mesh.n_elems):
        t = int(mesh.elem_types[e])
        nn = _NODES_PER_TYPE[t]
        conn = [int(v) for v in mesh.elem_conn[e, :nn]]
        out.append(struct.pack(f">{1 + nn}i", t, *conn))
    out.append(struct.pack(f">{3 * mesh.n_nodes}d", *mesh.coords.reshape(-1)))
    out.append(struct.pack(">i", len(mesh.boundary_sides)))
    if len(mesh.boundary_sides):
        out.append(struct.pack(f">{3 * len(mesh.boundary_sides)}i",
                               *mesh.boundary_sides.astype(np.int64).reshape(-1)))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def read_xdr(path: str) -> ShellMesh:
    """Parse the XDR-binary mesh format written by write_xdr."""
    with open(path, "rb") as fh:
        r = _XdrReader(fh.read())
    header = r.string()
    if not header.startswith("libMesh"):
        raise ValueError(f"{path}: not a libMesh XDR file (header {header!r})")
    n_elem, n_nodes = r.ints(2)
    for _ in range(4):
        r.string()  # bc / subdomain / processor / p-level spec files
    (n_elem0,) = r.ints(1)
    if n_elem0 != n_elem:
        raise ValueError(f"{path}: level-0 element count mismatch")
    elem_types = np.empty(n_elem, dtype=np.int32)
    elem_conn = np.full((n_elem, 4), -1, dtype=np.int32)
    for e in range(n_elem):
        (t,) = r.ints(1)
        if t not in _NODES_PER_TYPE:
            raise ValueError(f"{path}: unsupported XDR element type {t}")
        nn = _NODES_PER_TYPE[t]
        elem_types[e] = t
        elem_conn[e, :nn] = r.ints(nn)
    coords = np.array(r.doubles(3 * n_nodes), dtype=np.float64).reshape(n_nodes, 3)
    (n_bc,) = r.ints(1)
    bcs = (np.array(r.ints(3 * n_bc), dtype=np.int32).reshape(n_bc, 3) if n_bc
           else np.zeros((0, 3), np.int32))
    return ShellMesh(coords, elem_types, elem_conn, bcs)


def read_mesh(path: str) -> ShellMesh:
    """Format-dispatching mesh reader: .xda (libMesh ASCII), .xdr
    (libMesh binary), or .msh (Gmsh 2.x), the formats the reference
    accepts (fem-shell.cpp:45-47)."""
    if path.endswith(".msh"):
        from fem_shell_tpu_torch.io.gmsh import read_msh

        return read_msh(path)
    if path.endswith(".xdr"):
        return read_xdr(path)
    return read_xda(path)


def load_mesh_and_forces(mesh_path: str) -> Tuple[ShellMesh, np.ndarray]:
    """Load a mesh plus its conventional ``_f`` force file (zeros if absent)."""
    mesh = read_mesh(mesh_path)
    fpath = force_path_for(mesh_path)
    if os.path.exists(fpath):
        forces = read_forces(fpath, mesh.n_nodes)
    else:
        forces = np.zeros((mesh.n_nodes, 6), dtype=np.float64)
    return mesh, forces

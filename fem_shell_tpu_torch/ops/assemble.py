"""Assembly into the block-ELL operator — port of
``fem_shell_tpu/ops/assemble.py``.

Per node, a padded list of neighbour nodes and one 6x6 block each:

1. element stiffnesses of both families, batch-last, from the element
   kernel ``ops/elem_stiffness.py`` (``csrc/elem_stiffness.cu`` on the
   card, its plain PyTorch version on the CPU), on any 3D element
   positions;
2. a deterministic scatter of their 6x6 node-pair blocks into the
   block-ELL values, through a contributor table built once on the host
   from the static slots: pass c adds the c-th contribution of every slot,
   so no two adds of a pass meet and every sum has one order, the JAX
   package's CPU scatter order (all Tri-3 blocks by element and node pair,
   then all Quad-4 ones). ``index_add_`` is not used: on CUDA it sums
   colliding slots in no fixed order;
3. symmetric zero-Dirichlet elimination with a unit diagonal on the first
   self slot.

``coords_gradient`` is the reverse of steps 1-3 for the differentiable
solve: the gradient of -<lam, A(coords) x> in the node coordinates,
through ``ops/elem_stiffness.elem_stiffness_vjp`` per element and a
nodal sum in a fixed order (``corner_table``). The autograd backward of
``coords[conn]`` would be a scatter-add, whose order on CUDA is not
fixed.

DOF numbering: ``dof = 6*node + var`` (node-major).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness, elem_stiffness_vjp


@dataclasses.dataclass
class EllPattern:
    """Static block-ELL sparsity pattern of the node-pair graph (numpy).

    - ``adj [N, K]``: neighbour node ids per node (self included), sorted,
      padded with the node's own id (padding blocks stay zero).
    - ``valid [N, K]``: True for real neighbours.
    - ``tri_slot [Et, 3, 3]`` / ``quad_slot [Eq, 4, 4]``: for element e and
      local node pair (a, b), the flat destination ``node_a * K + slot`` of
      block (node_a, node_b).
    """

    adj: np.ndarray
    valid: np.ndarray
    tri_slot: np.ndarray
    quad_slot: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def k_max(self) -> int:
        return self.adj.shape[1]


def build_ell_pattern(mesh: ShellMesh, k_max: Optional[int] = None) -> EllPattern:
    """The block-ELL pattern from the connectivity, vectorised: the sorted
    unique node pairs of ``adjacency_coo`` (plus every node's self pair)
    give each node's neighbour list, ``searchsorted`` each element block's
    slot. Equal to the JAX package's pattern."""
    n = mesh.n_nodes
    r, c = mesh.adjacency_coo()
    keys = np.unique(np.concatenate([r.astype(np.int64) * n + c,
                                     np.arange(n, dtype=np.int64) * (n + 1)]))
    rows = keys // n
    counts = np.bincount(rows, minlength=n)
    start = np.cumsum(counts) - counts
    k_req = int(counts.max()) if n else 1
    k = k_req if k_max is None else max(k_max, k_req)
    pos = np.arange(len(keys)) - start[rows]
    adj = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    valid = np.zeros((n, k), dtype=bool)
    adj[rows, pos] = (keys % n).astype(np.int32)
    valid[rows, pos] = True

    def slots(conn, m):
        if len(conn) == 0:
            return np.zeros((0, m, m), np.int32)
        ia = conn.astype(np.int64)[:, :, None]
        ib = conn.astype(np.int64)[:, None, :]
        s = np.searchsorted(keys, ia * n + ib) - start[ia]
        return (ia * k + s).astype(np.int32)

    return EllPattern(adj, valid, slots(mesh.tri, 3), slots(mesh.quad, 4))


def contributor_table(pattern: EllPattern) -> np.ndarray:
    """[C_max, N*K] int64: entry (c, s) is the c-th block added into flat
    slot s, -1 for none. Blocks are numbered in the JAX scatter's order:
    Tri-3 block (e, a, b) is ``9e + 3a + b``, Quad-4 block (e, a, b) is
    ``9 Et + 16e + 4a + b``."""
    dest = np.concatenate([pattern.tri_slot.reshape(-1), pattern.quad_slot.reshape(-1)]).astype(np.int64)
    nk = pattern.adj.size
    if dest.size == 0:
        return np.full((0, nk), -1, np.int64)
    order = np.argsort(dest, kind="stable")  # by slot, then by block number
    counts = np.bincount(dest, minlength=nk)
    start = np.cumsum(counts) - counts
    ds = dest[order]
    rank = np.arange(len(ds)) - start[ds]
    table = np.full((int(counts.max()), nk), -1, np.int64)
    table[rank, ds] = order
    return table


def corner_table(flat_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """[C_max, N] int64: entry (c, n) is the c-th position p with
    ``flat_nodes[p] == n``, in increasing p, padded with
    ``len(flat_nodes)`` (the index of an appended zero row). Summing the
    gathered rows pass by pass adds each node's values in the order
    ``np.add.at`` adds them."""
    flat_nodes = np.asarray(flat_nodes, np.int64)
    order = np.argsort(flat_nodes, kind="stable")
    nodes = flat_nodes[order]
    counts = np.bincount(nodes, minlength=n_nodes)
    start = np.cumsum(counts) - counts
    rank = np.arange(len(nodes)) - start[nodes]
    table = np.full((max(1, int(counts.max(initial=0))), n_nodes), len(flat_nodes), np.int64)
    table[rank, nodes] = order
    return table


def sum_by_table(rows, table) -> torch.Tensor:
    """[N, ...] node sums of ``rows`` (whose last row is zero) through a
    ``corner_table`` on the rows' device: one gather and one add per pass,
    in ``np.add.at``'s order on any device."""
    acc = rows.new_zeros((table.shape[1],) + tuple(rows.shape[1:]))
    for c in range(table.shape[0]):
        acc = acc + rows[table[c]]
    return acc


def _first_self(adj):
    """[N, K] bool: each node's first self slot (padding repeats the self
    id after it)."""
    is_self = adj == torch.arange(adj.shape[0], device=adj.device)[:, None]
    return (torch.cumsum(is_self.to(torch.int32), dim=1) * is_self) == 1


def ell_matvec(blocks, adj, x):
    """y[i] = sum_k blocks[i, k] @ x[adj[i, k]] with blocks [N, K, 6, 6],
    adj [N, K] and x [N', 6]: a gather, an elementwise product and one sum
    over the slots and columns (on the card faster than a batched matmul,
    which cuBLAS runs as a batched gemv)."""
    return (blocks * x[adj][..., None, :]).sum(dim=(-1, 1))


@dataclasses.dataclass
class BlockEllMatrix:
    """Assembled block-ELL operator: y = A @ x with x, y of shape [N, 6]."""

    blocks: torch.Tensor  # [N, K, 6, 6]
    adj: torch.Tensor  # [N, K] int64

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 6] -> [N, 6]."""
        return ell_matvec(self.blocks, self.adj, x)

    def diagonal(self) -> torch.Tensor:
        """[N, 6] diagonal (Jacobi). Padding repeats the self id with zero
        blocks, so a masked sum over the self slots is exact."""
        n = self.blocks.shape[0]
        is_self = self.adj == torch.arange(n, device=self.adj.device)[:, None]
        diag_blocks = torch.diagonal(self.blocks, dim1=-2, dim2=-1)  # [N, K, 6]
        return torch.where(is_self[..., None], diag_blocks, 0.0).sum(dim=1)

    def diagonal_blocks(self) -> torch.Tensor:
        """[N, 6, 6] self-coupling blocks (block-Jacobi)."""
        return torch.where(_first_self(self.adj)[:, :, None, None], self.blocks, 0.0).sum(dim=1)

    def to_dense(self) -> torch.Tensor:
        """[6N, 6N] dense operator; padding slots add their zero blocks onto
        the self block."""
        n, k = self.adj.shape
        dense = self.blocks.new_zeros((n, n, 6, 6))
        rows = torch.arange(n, device=self.adj.device).repeat_interleave(k)
        dense.index_put_((rows, self.adj.reshape(-1)), self.blocks.reshape(n * k, 6, 6), accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def element_stiffnesses(coords, tri_conn, quad_conn, dm, dp, thickness):
    """Element stiffnesses of both families, batch-last: (ke_tri [18, 18,
    Et], ke_quad [24, 24, Eq]). Each family present is one
    ``elem_stiffness`` call on xyz [m, 3, E] gathered from ``coords[conn]``
    (the kernel on CUDA tensors, the plain version on CPU ones); an absent
    family gives an empty batch and launches nothing."""
    def family(conn, m):
        if conn.shape[0] == 0:
            return coords.new_zeros((6 * m, 6 * m, 0))
        xyz = coords[conn].permute(1, 2, 0).contiguous()  # [m, 3, E]
        return elem_stiffness(xyz, dm, dp, thickness)

    return family(tri_conn, 3), family(quad_conn, 4)


def element_cotangents(lam, x, conn) -> torch.Tensor:
    """-lam_e x_e^T [6m, 6m, E], batch-last, for the elements ``conn [E, m]``
    and node fields lam, x [N, 6] (element dofs node-major, as in ke): the
    cotangent of ke_e in -<lam, A x>."""
    e, m = conn.shape
    le = lam[conn].reshape(e, 6 * m)
    xe = x[conn].reshape(e, 6 * m)
    return (-(le[:, :, None] * xe[:, None, :])).permute(1, 2, 0).contiguous()


def coords_gradient(coords, tri_conn, quad_conn, dm, dp, thickness, lam, x, table,
                    chunk: int = 65536) -> torch.Tensor:
    """d(-<lam, A(coords) x>)/d coords [N, 3] f64 for the assembled and
    Dirichlet-eliminated operator A, with lam and x [N, 6] already masked
    by the free dofs (the elimination zeroes constrained rows and columns,
    and its unit diagonal does not depend on coords). Per element family
    and chunk of ``chunk`` elements: ``element_cotangents``, then
    ``elem_stiffness_vjp``; then the nodal sum of the corner rows (Tri-3
    elements, then Quad-4, each element's corners in order) through
    ``table = corner_table(concat(tri.ravel(), quad.ravel()), N)``, on the
    device."""
    lam = lam.to(torch.float64)
    x = x.to(torch.float64)
    rows = []
    for conn in (tri_conn, quad_conn):
        for lo in range(0, conn.shape[0], chunk):
            c = conn[lo:lo + chunk]
            xyz = coords[c].permute(1, 2, 0).contiguous()  # [m, 3, E]
            g = elem_stiffness_vjp(xyz, dm, dp, thickness, element_cotangents(lam, x, c))
            rows.append(g.permute(2, 0, 1).reshape(-1, 3))
    rows.append(coords.new_zeros((1, 3)))
    return sum_by_table(torch.cat(rows), table)


def scatter_to_ell(ke_tri, ke_quad, n_nodes: int, k: int, table) -> torch.Tensor:
    """Add the element blocks into the block-ELL values ``[N, K, 6, 6]``,
    straight from the batch-last ke, one pass per row of the contributor
    table (``contributor_table``, on the device): pass c gathers the c-th
    block of every slot (zero where there is none) and adds it. No slot
    is written twice in a pass, so the sums are the JAX scatter's, in its
    order, on any device."""
    n_tri = 9 * ke_tri.shape[2]
    fams = [(f, m, lo) for f, m, lo in ((ke_tri, 3, 0), (ke_quad, 4, n_tri)) if f.shape[2]]
    flat = torch.zeros((n_nodes * k, 6, 6), dtype=ke_tri.dtype, device=table.device)
    for c in range(table.shape[0]):
        idx = table[c]
        gathered = None
        for ke, m, lo in fams:
            mm = m * m
            rel = idx - lo
            mine = (rel >= 0) & (rel < mm * ke.shape[2])
            rel = torch.where(mine, rel, 0)
            e = rel // mm
            a = (rel - e * mm) // m
            b = rel - e * mm - a * m
            g = ke.view(m, 6, m, 6, -1)[a, :, b, :, e]  # [N*K, 6, 6]
            g = torch.where(mine[:, None, None], g, 0.0)
            gathered = g if gathered is None else gathered + g
        flat += gathered
    return flat.reshape(n_nodes, k, 6, 6)


def apply_dirichlet_to_ell(blocks, adj, free_mask) -> torch.Tensor:
    """Symmetric zero-Dirichlet elimination on the block-ELL values:
    constrained rows and columns zeroed, 1 on each constrained diagonal
    entry of the first self slot. ``free_mask`` [N, 6] float (1 free, 0
    constrained)."""
    blocks = blocks * free_mask[:, None, :, None] * free_mask[adj][:, :, None, :]
    first_self = _first_self(adj).to(blocks.dtype)
    eye = torch.eye(6, dtype=blocks.dtype, device=blocks.device)
    constrained = 1.0 - free_mask  # [N, 6]
    return blocks + first_self[:, :, None, None] * (eye[None, None] * constrained[:, None, :, None])


def constrained_rhs(forces, free_mask) -> torch.Tensor:
    """RHS with constrained dofs zeroed (zero-valued Dirichlet)."""
    return forces * free_mask

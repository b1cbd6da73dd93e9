"""Domain decomposition of arbitrary (unstructured) meshes with
communication proportional to the partition boundary — port of
``fem_shell_tpu/parallel/unstructured_shard.py``.

- **Partition** (host): reverse Cuthill-McKee order, then contiguous row
  chunks; on shell surface meshes the RCM bands keep the chunk
  separators ~O(bandwidth), the locality a graph partitioner buys.
- **Assembly** (per rank, no communication): every element with a corner
  in a rank's rows is evaluated on that rank (``ops/elem_stiffness``, the
  kernel ``csrc/elem_stiffness.cu`` on the card), and only the blocks of
  its own rows are added, pass by pass through local slot tables; the
  blocks of rows it does not own go to a trash slot.
- **Halo exchange** (per CG iteration): each rank publishes the compact
  list of its nodes that another rank references (its export interface,
  padded to B = the largest); one all-gather of [B, 6] moves S*B*6
  values, proportional to the partition boundary and not to N. The
  neighbour values are then gathered into the operator's local indexing.
- **CG**: Jacobi-PCG with rank-ordered dot products.
"""
from __future__ import annotations

import dataclasses
import types
from typing import List, Optional

import numpy as np
import torch

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh, permute_nodes, rcm_order
from fem_shell_tpu_torch.ops.assemble import _first_self, build_ell_pattern, ell_matvec
from fem_shell_tpu_torch.ops.soa import _ceil_to
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.sharded import (
    ShardedSystemBase,
    material_tensors,
    pcg_spmd,
    scatter_elements,
)


@dataclasses.dataclass
class _HaloTables:
    """Static per-shard tables (host numpy); equal to the JAX package's."""

    rps: int                 # owned rows per shard (padded)
    b: int                   # export slots per shard (max interface size)
    export_idx: np.ndarray   # [S, B] local row ids each shard publishes
    adj_l: np.ndarray        # [S, rps, K] ext indices (own < rps, halo >= rps)
    tri_xyz: np.ndarray      # [S, Et_l, 3, 3] per-element corner coords
    tri_lslot: np.ndarray    # [S, Et_l, 3, 3] local slots (trash = rps*K)
    quad_xyz: np.ndarray     # [S, Eq_l, 4, 3]
    quad_lslot: np.ndarray   # [S, Eq_l, 4, 4]
    free_l: np.ndarray       # [S, rps, 6] 1 = free (owned rows)
    col_free: np.ndarray     # [S, rps, K, 6] column mask per slot
    n_boundary: int          # true total export count (before padding)


def build_halo_tables(mesh: ShellMesh, pattern, n_shards: int) -> _HaloTables:
    n = mesh.n_nodes
    k = pattern.k_max
    rps = _ceil_to(n, n_shards) // n_shards
    n_pad = rps * n_shards

    adj = np.empty((n_pad, k), np.int64)
    adj[:n] = pattern.adj
    adj[n:] = np.arange(n, n_pad)[:, None]
    owner = adj // rps

    # exports: shard o's nodes referenced from rows it does not own
    row_owner = np.repeat(np.arange(n_shards), rps)[:, None]
    foreign = owner != row_owner
    exports: List[np.ndarray] = [np.unique(adj[foreign & (owner == o)]) for o in range(n_shards)]
    n_boundary = int(sum(len(e) for e in exports))
    b = max(1, _ceil_to(max((len(e) for e in exports), default=1), 8))
    export_idx = np.zeros((n_shards, b), np.int32)
    pos_of = np.full(n_pad, -1, np.int64)
    for o, e in enumerate(exports):
        export_idx[o, : len(e)] = (e - o * rps).astype(np.int32)
        pos_of[e] = o * b + np.arange(len(e))

    # adjacency in local ext indexing: own -> row - row0; halo -> rps + pos
    adj_l = np.where(foreign, rps + pos_of[adj], adj - row_owner * rps).astype(np.int32).reshape(n_shards, rps, k)

    free = np.ones((n_pad, 6), np.float64)
    free[:n] = ~mesh.dirichlet_mask()
    free[n:] = 0.0
    free_l = free.reshape(n_shards, rps, 6)
    col_free = free[adj].reshape(n_shards, rps, k, 6)

    # per-shard element lists: every element with at least one owned corner
    coords = np.asarray(mesh.coords, np.float64)

    def split(conn, slot, m):
        if conn.shape[0] == 0:
            return np.zeros((n_shards, 0, m, 3), np.float64), np.zeros((n_shards, 0, m, m), np.int32)
        eo = conn // rps  # [E, m] owner per corner
        trash = rps * k
        xyz_l, slot_l = [], []
        for s in range(n_shards):
            mine = np.nonzero((eo == s).any(axis=1))[0]
            sl = slot[mine].astype(np.int64)  # global row*k + kslot
            # block (la, lb) goes to corner la's row: kept where this shard
            # owns that row, else routed to the trash slot
            owned_row = (eo[mine] == s)[:, :, None]
            xyz_l.append(coords[conn[mine]])
            slot_l.append(np.where(owned_row, sl - s * rps * k, trash).astype(np.int32))
        e_l = max(len(x) for x in xyz_l)
        xyz_p = np.zeros((n_shards, e_l, m, 3), np.float64)
        slot_p = np.full((n_shards, e_l, m, m), rps * k, np.int32)
        for s in range(n_shards):
            e = len(xyz_l[s])
            xyz_p[s, :e] = xyz_l[s]
            slot_p[s, :e] = slot_l[s]
            if e < e_l:  # padding elements: real geometry, trash slots
                xyz_p[s, e:] = xyz_l[s][0] if e else coords[conn[0]]
        return xyz_p, slot_p

    tri_xyz, tri_lslot = split(mesh.tri.astype(np.int64), pattern.tri_slot, 3)
    quad_xyz, quad_lslot = split(mesh.quad.astype(np.int64), pattern.quad_slot, 4)
    return _HaloTables(rps=rps, b=b, export_idx=export_idx, adj_l=adj_l, tri_xyz=tri_xyz, tri_lslot=tri_lslot,
                       quad_xyz=quad_xyz, quad_lslot=quad_lslot, free_l=free_l, col_free=col_free,
                       n_boundary=n_boundary)


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def _build_rank(comm, arg):
    key, p = arg
    dev, f64 = comm.device, torch.float64
    rps, k = p["rps"], p["k"]
    trash = rps * k
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    flat = torch.zeros((36, rps * k + 1), dtype=f64, device=dev)
    for xyz, lslot in p["families"]:
        # padding elements route every block to the trash slot: skip them
        real = (lslot != trash).any(axis=(1, 2))
        xyz, lslot = xyz[real], lslot[real]
        e, m = lslot.shape[:2]
        coords = torch.as_tensor(xyz.reshape(-1, 3), dtype=f64, device=dev)
        scatter_elements(flat, coords, np.arange(e * m).reshape(e, m), lslot, dm, dp, t)
    blocks = flat[:, :-1].reshape(6, 6, rps, k).permute(2, 3, 0, 1)  # [rps, K, 6, 6]

    # BC masking and a unit diagonal on the constrained owned rows
    adj = torch.as_tensor(p["adj_l"], dtype=torch.int64, device=dev)
    free_l = torch.as_tensor(p["free_l"], dtype=f64, device=dev)
    col_free = torch.as_tensor(p["col_free"], dtype=f64, device=dev)
    blocks = blocks * free_l[:, None, :, None] * col_free[:, :, None, :]
    first_self = _first_self(adj)
    eye = torch.eye(6, dtype=f64, device=dev)
    blocks = blocks + first_self.to(f64)[:, :, None, None] * (eye[None, None] * (1.0 - free_l)[:, None, :, None])
    blocks = blocks.contiguous()
    diag = torch.where(first_self[..., None], torch.diagonal(blocks, dim1=-2, dim2=-1), 0.0).sum(dim=1)
    comm.state[key] = types.SimpleNamespace(
        blocks=blocks, adj=adj, free_l=free_l, inv_diag=torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)),
        export=torch.as_tensor(p["export_idx"], dtype=torch.int64, device=dev))


def _matvec(comm, st, x_l):
    """Compact-boundary halo exchange (S*B*6 values), then the block-ELL
    product in the local ext indexing."""
    allbuf = comm.all_gather(x_l[st.export])  # [S, B, 6]
    ext = torch.cat([x_l, allbuf.reshape(-1, 6)], dim=0)
    return ell_matvec(st.blocks, st.adj, ext)


def _solve_rank(comm, arg):
    key, b, rtol, maxiter = arg
    st = comm.state[key]
    b = torch.as_tensor(b, dtype=torch.float64, device=comm.device) * st.free_l
    x, it, res = pcg_spmd(comm, lambda v: _matvec(comm, st, v), b, lambda r: st.inv_diag * r, rtol, maxiter)
    return x.cpu().numpy(), it, res


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class HaloShardedShellSystem(ShardedSystemBase):
    """Arbitrary-mesh domain decomposition with O(boundary) communication,
    in f64. ``reorder='rcm'`` (default) renumbers the nodes before
    chunking; solutions come back in the original numbering."""

    def __init__(self, mesh: ShellMesh, material: Material, device_mesh: DeviceMesh,
                 dtype=torch.float64, reorder: Optional[str] = "rcm"):
        if dtype != torch.float64:
            raise ValueError(f"HaloShardedShellSystem(dtype={dtype}): the port runs it in torch.float64")
        self._order = None
        if reorder == "rcm":
            self._order = rcm_order(mesh)
            mesh = permute_nodes(mesh, self._order)
        elif reorder is not None:
            raise ValueError(f"unknown reorder {reorder!r}")
        self._bind(device_mesh)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        self.pattern = build_ell_pattern(mesh)
        self.k = self.pattern.k_max
        t = build_halo_tables(mesh, self.pattern, self.n_shards)
        self.tables = t
        common = {"rps": t.rps, "k": self.k, "mats": material.matrices(), "thickness": material.thickness}
        self.device_mesh.run(_build_rank, [
            (self.key, dict(common, families=[(t.tri_xyz[s], t.tri_lslot[s]), (t.quad_xyz[s], t.quad_lslot[s])],
                            adj_l=t.adj_l[s], free_l=t.free_l[s], col_free=t.col_free[s],
                            export_idx=t.export_idx[s]))
            for s in range(self.n_shards)])
        self.last_iters = 0
        self.last_residual = np.inf

    @property
    def comm_floats_per_iter(self) -> int:
        """Values exchanged per iteration over all ranks, S * B * 6: the
        O(boundary) count against the all-gather's N * 6."""
        return self.n_shards * self.tables.b * 6

    def solve(self, forces, rtol: float = 1e-12, maxiter: int = 20000) -> np.ndarray:
        t = self.tables
        f = np.zeros((self.n_shards * t.rps, 6))
        fin = np.asarray(forces)
        if self._order is not None:
            fin = fin[self._order]
        f[: self.mesh.n_nodes] = fin
        parts = self._run_solve(_solve_rank, [(self.key, f[s * t.rps:(s + 1) * t.rps], rtol, maxiter)
                                              for s in range(self.n_shards)])
        u = np.concatenate(parts)[: self.mesh.n_nodes]
        if self._order is None:
            return u
        out = np.empty_like(u)
        out[self._order] = u
        return out

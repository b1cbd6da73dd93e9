"""Host-side partitioning for the row-block domain decomposition — port of
``fem_shell_tpu/parallel/partition.py``.

Elements and node rows are block-partitioned across the ranks: rows are
padded to ``n_pad = n_shards * rows_per_shard`` and shard s owns rows
[s*rps, (s+1)*rps); each element family is padded with copies of element
0 carrying a zero weight, then block-partitioned. For meshGen-style
row-major meshes contiguous blocks are the strip decomposition a graph
partitioner would produce. Host numpy only; the arrays equal the JAX
package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble import EllPattern
from fem_shell_tpu_torch.ops.soa import _ceil_to


@dataclasses.dataclass
class Partition:
    """Static partition tables for an ``n_shards``-way decomposition."""

    n_shards: int
    n_nodes: int
    rows_per_shard: int
    tri_shard: np.ndarray  # [S, Et_l, 3] connectivity per shard
    tri_weight: np.ndarray  # [S, Et_l] 1.0 for real elements, 0.0 padding
    tri_slot: np.ndarray  # [S, Et_l, 3, 3] ELL slots (into padded rows)
    quad_shard: np.ndarray  # [S, Eq_l, 4]
    quad_weight: np.ndarray  # [S, Eq_l]
    quad_slot: np.ndarray  # [S, Eq_l, 4, 4]
    adj: np.ndarray  # [n_pad, K] neighbour ids (padded rows self-refer)
    valid: np.ndarray  # [n_pad, K]

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows_per_shard


def build_partition(mesh: ShellMesh, pattern: EllPattern, n_shards: int) -> Partition:
    n = mesh.n_nodes
    rps = _ceil_to(n, n_shards) // n_shards
    n_pad = rps * n_shards
    k = pattern.k_max

    # padded adjacency: pad rows are isolated self-loops
    adj = np.empty((n_pad, k), dtype=np.int32)
    adj[:n] = pattern.adj
    adj[n:] = np.arange(n, n_pad, dtype=np.int32)[:, None]
    valid = np.zeros((n_pad, k), dtype=bool)
    valid[:n] = pattern.valid

    def split(conn, slot, m):
        e = conn.shape[0]
        if e == 0:
            # empty family: zero-length per-shard blocks (a padding element
            # would be a degenerate [0,0,0] element with a NaN stiffness)
            return (
                np.zeros((n_shards, 0, m), np.int32),
                np.zeros((n_shards, 0), np.float64),
                np.zeros((n_shards, 0, m, m), np.int32),
            )
        e_l = _ceil_to(e, n_shards) // n_shards
        conn_p = np.zeros((n_shards * e_l, m), dtype=np.int32)
        slot_p = np.zeros((n_shards * e_l, m, m), dtype=np.int32)
        w = np.zeros(n_shards * e_l, dtype=np.float64)
        conn_p[:e] = conn
        slot_p[:e] = slot
        w[:e] = 1.0
        # padding elements reuse element 0's data with zero weight
        conn_p[e:] = conn[0]
        slot_p[e:] = slot[0]
        return (
            conn_p.reshape(n_shards, e_l, m),
            w.reshape(n_shards, e_l),
            slot_p.reshape(n_shards, e_l, m, m),
        )

    tri_shard, tri_w, tri_slot = split(mesh.tri, pattern.tri_slot, 3)
    quad_shard, quad_w, quad_slot = split(mesh.quad, pattern.quad_slot, 4)
    # slots index node * K + s on unpadded rows; padding only appends rows,
    # so they stay valid
    return Partition(
        n_shards=n_shards,
        n_nodes=n,
        rows_per_shard=rps,
        tri_shard=tri_shard,
        tri_weight=tri_w,
        tri_slot=tri_slot,
        quad_shard=quad_shard,
        quad_weight=quad_w,
        quad_slot=quad_slot,
        adj=adj,
        valid=valid,
    )

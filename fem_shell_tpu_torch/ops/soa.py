"""Structure-of-arrays stencil operator: pattern, assembly, Dirichlet
elimination and diagonal.

Port of ``fem_shell_tpu/ops/soa.py``, stencil mode. The layouts are the
JAX package's:

- operator values ``[36, K, Npad]`` (viewed as [6,6,K,Npad]): slot k of
  node n holds the 6x6 block coupling n to node ``n + offsets[k]``;
- vectors ``[6, Npad]``.

The matvec on these layouts is ``ops/stencil_spmv.py``.

Only the stencil addressing mode is ported; the general gather mode
(explicit neighbour tables for unstructured meshes) raises
NotImplementedError (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_shell_tpu_torch.ops.elements import batched_quad_stiffness, batched_tri_stiffness


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class SoAPattern:
    """Host-side static data of the stencil operator."""

    n_nodes: int
    n_pad: int
    k: int
    offsets: np.ndarray  # [K] int64, ascending, includes 0
    tri_slot: np.ndarray  # [Et, 3, 3] flat slot s*Npad + n
    quad_slot: np.ndarray  # [Eq, 4, 4]


def _offsets_of(mesh) -> np.ndarray:
    offs = {0}
    for conn in (mesh.tri, mesh.quad):
        if len(conn) == 0:
            continue
        c = conn.astype(np.int64)
        m = c.shape[1]
        for a in range(m):
            for b in range(m):
                offs.update(np.unique(c[:, b] - c[:, a]).tolist())
    return np.array(sorted(offs), dtype=np.int64)


def build_soa_pattern(mesh, pad_to: int = 4096, max_stencil: int = 32) -> SoAPattern:
    """Stencil pattern of ``mesh``: offsets and the flat slot of every
    element block. ``pad_to=4096`` keeps Npad a multiple of 4096, as in the
    JAX package."""
    n = mesh.n_nodes
    n_pad = _ceil_to(n, pad_to)
    offsets = _offsets_of(mesh)
    if len(offsets) > max_stencil:
        raise NotImplementedError(
            f"{len(offsets)} stencil offsets: the gather-mode SoA operator for "
            "unstructured meshes is not ported yet (ROADMAP.md, Queue 1)"
        )

    def slots(conn):
        if len(conn) == 0:
            mm = conn.shape[1]
            return np.zeros((0, mm, mm), np.int64)
        c = conn.astype(np.int64)
        m = c.shape[1]
        out = np.empty((len(c), m, m), dtype=np.int64)
        for a in range(m):
            for b in range(m):
                s = np.searchsorted(offsets, c[:, b] - c[:, a])
                out[:, a, b] = s * n_pad + c[:, a]
        return out

    return SoAPattern(
        n_nodes=n,
        n_pad=n_pad,
        k=len(offsets),
        offsets=offsets,
        tri_slot=slots(mesh.tri),
        quad_slot=slots(mesh.quad),
    )


# ----------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------


def _chunked_scatter(values_flat, coords, conn, slot, kernel, dm, dp, t, chunk):
    """Add one element family into values_flat [36, K*Npad], ``chunk``
    elements at a time (bounds the transient element-matrix memory).
    ``index_add_`` on CUDA sums colliding slots in no fixed order, so the
    assembled values may differ from run to run in the last bits."""
    e = conn.shape[0]
    m = conn.shape[1]
    for start in range(0, e, chunk):
        cc = conn[start : start + chunk]
        sc = slot[start : start + chunk]
        c = cc.shape[0]
        ke = kernel(coords, cc, dm, dp, t)  # [C, 6m, 6m]
        kb = ke.reshape(c, m, 6, m, 6).permute(2, 4, 0, 1, 3).reshape(36, c * m * m)
        values_flat.index_add_(1, sc.reshape(-1), kb)
    return values_flat


def assemble_soa(pattern: SoAPattern, coords, tri_conn, quad_conn, tri_slot, quad_slot,
                 dm, dp, thickness, chunk: int = 16384):
    """Operator values [36, K, Npad] before Dirichlet elimination, from
    plain coordinates ``coords`` [N,3] (its dtype is the working dtype)."""
    npad, k = pattern.n_pad, pattern.k
    flat = torch.zeros((36, npad * k), dtype=coords.dtype, device=coords.device)
    flat = _chunked_scatter(flat, coords, tri_conn, tri_slot, batched_tri_stiffness,
                            dm, dp, thickness, chunk)
    flat = _chunked_scatter(flat, coords, quad_conn, quad_slot, batched_quad_stiffness,
                            dm, dp, thickness, chunk)
    # slot index = s*Npad + n, so this reshape is a free view
    return flat.reshape(36, k, npad)


def _self_slot(offsets) -> int:
    return int(np.searchsorted(np.asarray(offsets), 0))


def apply_bc_soa(values, free_t, offsets):
    """Zero constrained rows/cols and set unit diagonals.
    values [36,K,Npad] viewed [6,6,K,Npad]; free_t [6,Npad] (1 = free).
    Column masks are lane rolls of free_t, as in the JAX package: a wrapped
    target only meets blocks that are identically zero."""
    k, npad = values.shape[1], values.shape[2]
    v = values.reshape(6, 6, k, npad)
    col_free = torch.stack([torch.roll(free_t, -int(o), dims=1) for o in offsets], dim=1)
    v = v * free_t[:, None, None, :] * col_free[None, :, :, :]
    k0 = _self_slot(offsets)
    constrained = 1.0 - free_t  # [6, Npad]
    eye = torch.eye(6, dtype=v.dtype, device=v.device)
    v[:, :, k0, :] = v[:, :, k0, :] + eye[:, :, None] * constrained[None, :, :]
    return v.reshape(36, k, npad)


def soa_diagonal(values, offsets):
    """[6, Npad] diagonal of the operator (values [36,K,Npad] or flat
    [36K, Npad])."""
    k = len(offsets)
    npad = values.shape[-1]
    v4 = values.reshape(6, 6, k, npad)
    k0 = _self_slot(offsets)
    return torch.stack([v4[a, a, k0] for a in range(6)])

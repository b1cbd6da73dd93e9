"""Structure-of-arrays block-ELL operator: pattern, assembly, Dirichlet
elimination, diagonal, self blocks and the gather-mode matvec.

Port of ``fem_shell_tpu/ops/soa.py``. The layouts are the JAX package's:

- operator values ``[36, K, Npad]`` (viewed as [6,6,K,Npad]);
- vectors ``[6, Npad]``;
- two column-addressing modes. **Stencil** (``offsets``): slot k of node
  n holds the 6x6 block coupling n to node ``n + offsets[k]``; its matvec
  is ``ops/stencil_spmv.py``. **Gather** (``adj_t [K, Npad]``, for
  unstructured or renumbered meshes with more than ``max_stencil`` or
  ``k_max`` offsets): slot k of node n couples n to ``adj_t[k, n]``;
  padded slots point at the node itself and hold zero blocks.

Assembly (``assemble_soa``) computes the element stiffnesses with
``ops/elem_stiffness.elem_stiffness`` (``csrc/elem_stiffness.cu`` on the
card, its plain version on the CPU), one call per element family present
per chunk of elements, and adds their blocks into the flat slots
``s*Npad + n`` pass by pass (``scatter_passes``): no slot is written twice
in a pass, so every sum has one order, the JAX package's CPU scatter
order (all Tri-3 blocks by element and node pair, then all Quad-4 ones),
and two assemblies agree bit for bit on any device. ``index_add_`` is not
used: on CUDA it sums colliding slots in no fixed order.

The gather-mode matvec (``soa_matvec``) is PyTorch, a gather and a
batched 6x6 product, as the JAX package computes it in XLA outside any
Pallas kernel. Assembly is f64; ``apply_bc_soa``, ``soa_self_blocks``,
``soa_diagonal`` and ``soa_matvec`` work in the dtype of the values they
are given, so an f32 system (``large.LargeShellSystem(dtype=float32)``)
runs them on the f32 cast of the f64 operator. The strip-df assembly
(``assemble_soa_df``, ``build_strip_plan``) has no counterpart: native
f64 needs no strips.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness
from fem_shell_tpu_torch.ops.stencil_resid import resid_dd


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class SoAPattern:
    """Host-side static data of the SoA operator (stencil or gather
    mode)."""

    n_nodes: int
    n_pad: int
    k: int
    adj_t: Optional[np.ndarray]  # [K, Npad] int32; None in stencil mode
    offsets: Optional[np.ndarray]  # [K] int64, ascending, includes 0; None in gather mode
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


def build_soa_pattern(mesh, k_max: Optional[int] = None, pad_to: int = 4096,
                      max_stencil: int = 32) -> SoAPattern:
    """Pattern of ``mesh``: stencil mode where the mesh has at most
    ``max_stencil`` (and ``k_max``) distinct node offsets, else gather mode
    on the block-ELL pattern (``ops/assemble.build_ell_pattern``) with
    slot-major flat slots. ``pad_to=4096`` keeps Npad a multiple of 4096,
    as in the JAX package."""
    n = mesh.n_nodes
    n_pad = _ceil_to(n, pad_to)
    offsets = _offsets_of(mesh)
    if len(offsets) <= max_stencil and (k_max is None or len(offsets) <= k_max):

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

        return SoAPattern(n_nodes=n, n_pad=n_pad, k=len(offsets), adj_t=None, offsets=offsets,
                          tri_slot=slots(mesh.tri), quad_slot=slots(mesh.quad))

    from fem_shell_tpu_torch.ops.assemble import build_ell_pattern

    p = build_ell_pattern(mesh, k_max=k_max)
    n, k = p.adj.shape
    adj = np.empty((n_pad, k), dtype=np.int32)
    adj[:n] = p.adj
    adj[n:] = np.arange(n, n_pad, dtype=np.int32)[:, None]

    def to_slot_major(slot):
        # block-ELL slots are node-major (n*K + s); the SoA flat buffer is
        # slot-major (s*Npad + n), so reshape -> [36, K, Npad] is a view
        s = slot % k
        node = slot // k
        return s.astype(np.int64) * n_pad + node

    return SoAPattern(n_nodes=n, n_pad=n_pad, k=k, adj_t=np.ascontiguousarray(adj.T), offsets=None,
                      tri_slot=to_slot_major(p.tri_slot), quad_slot=to_slot_major(p.quad_slot))


# ----------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------


def scatter_passes(slot: np.ndarray, chunk: int) -> List[Tuple[np.ndarray, np.ndarray, List[int]]]:
    """Per chunk of ``chunk`` elements of one family (slots [E, m, m]):
    ``(src, dest, bounds)``, the chunk's blocks (``e*m*m + a*m + b``, e
    local to the chunk) sorted into passes. Pass c, ``src[bounds[c] :
    bounds[c+1]]``, holds the c-th block of the chunk into each flat slot
    ``dest``, so no slot appears twice in a pass and each slot receives
    its blocks in block order."""
    out = []
    e = slot.shape[0]
    for start in range(0, e, chunk):
        dest = slot[start : start + chunk].reshape(-1).astype(np.int64)
        order = np.argsort(dest, kind="stable")  # by slot, then by block
        ds = dest[order]
        new = np.ones(len(ds), bool)
        new[1:] = ds[1:] != ds[:-1]
        first = np.maximum.accumulate(np.where(new, np.arange(len(ds)), 0))
        rank = np.arange(len(ds)) - first
        by_pass = np.argsort(rank, kind="stable")
        counts = np.bincount(rank)
        bounds = [0] + np.cumsum(counts).tolist()
        out.append((order[by_pass], ds[by_pass], bounds))
    return out


def _scatter_family(flat, coords, conn, passes, chunk, dm, dp, thickness):
    """Add one element family into flat [36, K*Npad]: per chunk one
    ``elem_stiffness`` call (xyz [m, 3, C] -> ke [6m, 6m, C]), then its
    passes of gather, add and write on distinct slots."""
    e, m = conn.shape
    for i, start in enumerate(range(0, e, chunk)):
        cc = conn[start : start + chunk]
        c = cc.shape[0]
        xyz = coords[cc].permute(1, 2, 0).contiguous()  # [m, 3, C]
        ke = elem_stiffness(xyz, dm, dp, thickness)  # [6m, 6m, C]
        # (a r, b c, e) -> (r c, e a b): column e*m*m + a*m + b of kb
        kb = ke.view(m, 6, m, 6, c).permute(1, 3, 4, 0, 2).reshape(36, c * m * m)
        del ke
        src, dest, bounds = passes[i]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            d = dest[lo:hi]
            flat[:, d] = flat[:, d] + kb[:, src[lo:hi]]
    return flat


def assemble_soa(pattern: SoAPattern, coords, tri_conn, quad_conn, tri_passes, quad_passes,
                 dm, dp, thickness, chunk: int = 16384):
    """Operator values [36, K, Npad] before Dirichlet elimination, from
    plain coordinates ``coords`` [N,3] f64. ``tri_passes`` /
    ``quad_passes`` are ``scatter_passes`` of the pattern's slots at this
    ``chunk``, as device tensors."""
    npad, k = pattern.n_pad, pattern.k
    flat = torch.zeros((36, npad * k), dtype=coords.dtype, device=coords.device)
    for conn, passes in ((tri_conn, tri_passes), (quad_conn, quad_passes)):
        if conn.shape[0]:
            _scatter_family(flat, coords, conn, passes, chunk, dm, dp, thickness)
    # slot index = s*Npad + n, so this reshape is a free view
    return flat.reshape(36, k, npad)


# ----------------------------------------------------------------------
# Dirichlet elimination, diagonal, self blocks, matvec
# ----------------------------------------------------------------------


def _self_slot(offsets) -> int:
    return int(np.searchsorted(np.asarray(offsets), 0))


def _col_values(x, offsets, adj_t):
    """[6, K, Npad] column values of x per stored slot: lane rolls in
    stencil mode (a wrapped target only meets blocks that are identically
    zero), a gather in gather mode."""
    if offsets is not None:
        return torch.stack([torch.roll(x, -int(o), dims=1) for o in offsets], dim=1)
    return x[:, adj_t]


def _first_self(adj_t, dtype):
    """[K, Npad] 1.0 at the first self slot of each node in gather mode
    (padding repeats the node's own id after its real self slot, and only
    the first may take a unit diagonal)."""
    node_ids = torch.arange(adj_t.shape[1], dtype=adj_t.dtype, device=adj_t.device)
    is_self = (adj_t == node_ids[None, :]).to(torch.int32)
    return ((torch.cumsum(is_self, dim=0) * is_self) == 1).to(dtype)


def apply_bc_soa(values, free_t, offsets=None, adj_t=None):
    """Zero constrained rows/cols and set unit diagonals on the first self
    slot. values [36,K,Npad] viewed [6,6,K,Npad]; free_t [6,Npad] (1 =
    free); ``offsets`` (stencil mode) or ``adj_t`` (gather mode)."""
    k, npad = values.shape[1], values.shape[2]
    v = values.reshape(6, 6, k, npad)
    col_free = _col_values(free_t, offsets, adj_t)
    v = v * free_t[:, None, None, :] * col_free[None, :, :, :]
    constrained = 1.0 - free_t  # [6, Npad]
    eye = torch.eye(6, dtype=v.dtype, device=v.device)
    if offsets is not None:
        k0 = _self_slot(offsets)
        v[:, :, k0, :] = v[:, :, k0, :] + eye[:, :, None] * constrained[None, :, :]
    else:
        first = _first_self(adj_t, v.dtype)
        v = v + eye[:, :, None, None] * constrained[None, :, None, :] * first[None, None]
    return v.reshape(36, k, npad)


def soa_self_blocks(values, offsets=None, adj_t=None):
    """[Npad, 6, 6] per-node self-coupling blocks (the block-Jacobi
    source): the first self slot's block. Values [36,K,Npad] or flat
    [36K, Npad]."""
    npad = values.shape[-1]
    k = len(offsets) if offsets is not None else adj_t.shape[0]
    v4 = values.reshape(6, 6, k, npad)
    if offsets is not None:
        blocks = v4[:, :, _self_slot(offsets)]
    else:
        slot = _first_self(adj_t, values.dtype).argmax(dim=0)  # [Npad]
        blocks = v4[:, :, slot, torch.arange(npad, device=values.device)]
    return blocks.permute(2, 0, 1).contiguous()


def soa_diagonal(values, offsets=None, adj_t=None):
    """[6, Npad] diagonal of the operator (values [36,K,Npad] or flat
    [36K, Npad])."""
    return torch.diagonal(soa_self_blocks(values, offsets, adj_t), dim1=1, dim2=2).T.contiguous()


def soa_matvec(values, x, adj_t):
    """y = A x in gather mode, x and y [6, Npad]: the K column gathers of x
    and one batched 6x6 product per node and slot, summed over the slots.
    (Stencil mode: ``ops/stencil_spmv.stencil_spmv``.)"""
    k, npad = adj_t.shape
    v4 = values.reshape(6, 6, k, npad)
    xg = x[:, adj_t]  # [6, K, Npad]
    return (v4 * xg[None]).sum(dim=(1, 2))


def gather_resid_dd(values, x, b, adj_t):
    """r = b - A x in gather mode, summed in double-double as
    ``ops/stencil_resid.stencil_resid_dd`` sums in stencil mode (slot by
    slot, column by column, rounded once)."""
    k, npad = adj_t.shape
    v4 = values.reshape(6, 6, k, npad)
    xg = x[:, adj_t]  # [6, K, Npad]
    return resid_dd(b, ((v4[:, bb, j], xg[bb, j]) for j in range(k) for bb in range(6)))

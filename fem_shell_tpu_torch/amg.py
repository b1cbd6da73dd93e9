"""Smoothed-aggregation AMG over the 6x6 block structure: the
preconditioner for unstructured shell meshes. Port of
``fem_shell_tpu/amg.py``.

- Set-up (host, numpy, a copy of the JAX package's): greedy node
  aggregation on the strength-filtered block graph; the tentative
  prolongator from the per-aggregate QR of the rigid-body modes (3
  translations, 3 rotations); Jacobi-smoothed P; Galerkin RAP by chunked
  sorted-key reduction. ``setup_timings`` holds the seconds of each stage.
- The fine operator is ``LargeShellSystem(..., reorder=reorder).assemble()``
  on the system's device, so on the card it runs the element kernel
  (``csrc/elem_stiffness.cu``) and the deterministic scatter; it is then
  copied to the host for the set-up. (The JAX package assembles it on the
  host CPU because the TPU's memory ran out.)
- Cycle (device, PyTorch): block-ELL levels in ``dtype``, damped
  block-Jacobi smoothing, the W or V cycle, prolongation by gather and
  restriction by a gather table built once on the host (the transpose of
  P; the JAX package scatter-adds, whose order is not fixed on a GPU), so
  two solves agree bit for bit. The coarsest level is solved with an f64
  Cholesky factor and two f64 triangular solves, cast back to ``dtype``.
- Solves: ``solve`` is PCG with the cycle; ``df=True`` builds the
  hierarchy on the symmetrically diagonal-scaled operator, for
  ``solve_df`` (the JAX package's df outer CG as a native f64 CG over the
  scaled f64 fine operator, preconditioned by the cycle in ``dtype``) and
  ``solve_df_refined`` (``solver.refine``, the loop of
  ``large.LargeShellSystem.solve_df_refined``, on the true residual
  compensated by ``ops/soa.gather_resid_dd``; E = A64 - (hi + lo) is zero
  in native f64, and the iterate is a double-double).

The block-ELL products (level matvecs, prolongation) are
``ops/assemble.ell_matvec``, ``ShellSystem``'s matvec: elementwise
products and sums, which TF32 does not touch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble import ell_matvec
from fem_shell_tpu_torch.ops.soa import gather_resid_dd
from fem_shell_tpu_torch.solver import pcg, refine

# ----------------------------------------------------------------------
# host-side setup
# ----------------------------------------------------------------------


def _block_graph(adj, n):
    """Neighbor lists (excluding self) from the ELL adjacency [n, K]."""
    nbrs = []
    for i in range(n):
        row = adj[i]
        nbrs.append(row[(row != i) & (row < n)])
    return nbrs


def _strong_graph(lvl: "_HostLevel", theta: float):
    """Strength-filtered neighbor lists: keep edge (i, j) when
    ||A_ij||_F >= theta * sqrt(||A_ii||_F ||A_jj||_F)."""
    n = lvl.n
    fro = np.sqrt((lvl.blocks**2).sum(axis=(2, 3)))  # [n, K]
    dia = fro[np.arange(n), _self_slot(lvl)]
    dia = np.where(dia > 0, dia, 1.0)
    nbrs = []
    for i in range(n):
        row = lvl.adj[i]
        ok = (row != i) & (row < n)
        j = row[ok]
        s = fro[i, ok] >= theta * np.sqrt(dia[i] * dia[j])
        nbrs.append(j[s])
    return nbrs


def aggregate(adj, n, nbrs=None) -> np.ndarray:
    """Greedy root aggregation (standard SA): pass 1 seeds aggregates at
    nodes whose neighborhood is untouched; pass 2 attaches leftovers to
    an adjacent aggregate; pass 3 makes singletons."""
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    if nbrs is None:
        nbrs = _block_graph(adj, n)
    for i in range(n):
        if agg[i] < 0 and (agg[nbrs[i]] < 0).all():
            agg[i] = n_agg
            agg[nbrs[i]] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] < 0:
            owned = agg[nbrs[i]]
            owned = owned[owned >= 0]
            if len(owned):
                agg[i] = owned[0]
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _rigid_modes(coords) -> np.ndarray:
    """[n, 6, 6] rigid-body nullspace candidates (about the origin):
    columns = (Tx, Ty, Tz, Rx, Ry, Rz); rows = (u, v, w, tx, ty, tz)."""
    n = len(coords)
    b = np.zeros((n, 6, 6))
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    for c in range(3):
        b[:, c, c] = 1.0  # translations
        b[:, 3 + c, 3 + c] = 1.0  # rotations map to rotations
    # u += Ry*z - Rz*y ; v += Rz*x - Rx*z ; w += Rx*y - Ry*x
    b[:, 0, 4] = z
    b[:, 0, 5] = -y
    b[:, 1, 5] = x
    b[:, 1, 3] = -z
    b[:, 2, 3] = y
    b[:, 2, 4] = -x
    return b


def _tentative(nullspace, agg, n_agg):
    """Per-aggregate QR of the stacked nullspace rows.

    Returns (p0_blocks [n, 6, 6], coarse nullspace [n_agg, 6, 6]):
    P0[i] maps aggregate-coarse dofs -> node i dofs; rank-deficient
    aggregates (rare tiny ones) get the economy Q with zeroed defect
    columns."""
    n = len(nullspace)
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=n_agg)
    p0 = np.zeros((n, 6, 6))
    nc = np.zeros((n_agg, 6, 6))
    pos = 0
    for a in range(n_agg):
        c = counts[a]
        idx = order[pos : pos + c]
        pos += c
        stack = nullspace[idx].reshape(c * 6, 6)
        q, r = np.linalg.qr(stack)
        # fix signs for determinism (diagonal of R >= 0)
        s = np.sign(np.diag(r))
        s[s == 0] = 1.0
        q = q * s[None, :]
        r = r * s[:, None]
        p0[idx] = q.reshape(c, 6, 6)
        nc[a] = r
    return p0, nc


@dataclasses.dataclass
class _HostLevel:
    adj: np.ndarray  # [n, K] block column ids (self included)
    blocks: np.ndarray  # [n, K, 6, 6]
    n: int
    self_slot: Optional[np.ndarray] = None  # [n]; None: each node's first slot holding its id


def _self_slot(lvl: _HostLevel) -> np.ndarray:
    """[n] each node's self slot. A stencil-mode fine level names it (the
    offset-0 slot): there node 0's out-of-range negative offsets, clipped to
    0, hold its id with zero blocks before it. Elsewhere padding repeats
    the id after the real self slot, so the first one is it."""
    if lvl.self_slot is not None:
        return lvl.self_slot
    return np.argmax(lvl.adj == np.arange(lvl.n)[:, None], axis=1)


def _ell_matvec(lvl: _HostLevel, x):
    return np.einsum("nkab,nkb->na", lvl.blocks, x[lvl.adj])


def _lam_max(lvl: _HostLevel, inv_diag, iters=12, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((lvl.n, 6))
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = np.einsum("nab,nb->na", inv_diag, _ell_matvec(lvl, v))
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    return lam


def _block_inv_diag(lvl: _HostLevel):
    d = lvl.blocks[np.arange(lvl.n), _self_slot(lvl)]
    # regularize empty/constrained blocks
    bad = np.abs(np.diagonal(d, axis1=1, axis2=2)).max(axis=1) == 0
    d[bad] = np.eye(6)
    return np.linalg.inv(d)


def _smooth_p(lvl: _HostLevel, p0, agg, omega, inv_diag):
    """P = (I - omega D^-1 A) P0 as block COO (rows -> per-row lists)."""
    n = lvl.n
    k = lvl.adj.shape[1]
    # candidate coarse columns per row: own agg + neighbor aggs
    cols = agg[lvl.adj]  # [n, K]
    dinva = np.einsum("nab,nkbc->nkac", inv_diag, lvl.blocks)
    contrib = -omega * np.einsum("nkab,nkbc->nkac", dinva, p0[lvl.adj])
    # add the identity term at each row's self slot: += p0[i]
    self_slot = _self_slot(lvl)
    has_self = lvl.adj[np.arange(n), self_slot] == np.arange(n)
    rows_s = np.nonzero(has_self)[0]
    contrib[rows_s, self_slot[rows_s]] += p0[rows_s]
    # dedupe columns per row
    order = np.argsort(cols, axis=1, kind="stable")
    cols_s = np.take_along_axis(cols, order, axis=1)
    contrib_s = np.take_along_axis(contrib, order[..., None, None], axis=1)
    new_col = np.ones_like(cols_s, bool)
    new_col[:, 1:] = cols_s[:, 1:] != cols_s[:, :-1]
    slot = np.cumsum(new_col, axis=1) - 1
    pk = int(slot.max()) + 1
    pcol = np.zeros((n, pk), np.int64)
    pblk = np.zeros((n, pk, 6, 6))
    rows = np.repeat(np.arange(n), k)
    np.maximum.at(pcol, (rows, slot.reshape(-1)), cols_s.reshape(-1))
    np.add.at(pblk, (rows, slot.reshape(-1)), contrib_s.reshape(-1, 6, 6))
    valid = np.zeros((n, pk), bool)
    valid[rows, slot.reshape(-1)] = True
    pcol[~valid] = 0  # padded entries carry zero blocks already
    return pcol, pblk


def _rap(lvl: _HostLevel, pcol, pblk, n_agg, chunk=65536):
    """C = P^T A P by chunked sorted-key reduction (block COO).

    Per chunk: AP's K*PK candidate coarse columns are deduped PER ROW
    first (sorted-segment reduction, the _smooth_p trick) so the outer
    P^T product and the key reduction run over the ~Q unique columns
    (Q ~ 9-16) instead of all K*PK ~ 36-72 candidates — the triple
    product is the set-up's dominant cost. Broadcast matmul replaces
    np.einsum for the 6x6 block products."""
    n, k = lvl.adj.shape
    pk = pcol.shape[1]
    keys_all = []
    vals_all = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        C = e - s
        # AP over the chunk, then per-row column dedupe
        j = lvl.adj[s:e]  # [C, K]
        ap_col = pcol[j].reshape(C, k * pk)
        ap_blk = np.matmul(lvl.blocks[s:e][:, :, None], pblk[j]).reshape(
            C, k * pk, 6, 6
        )
        order = np.argsort(ap_col, axis=1, kind="stable")
        col_s = np.take_along_axis(ap_col, order, axis=1)
        blk_s = np.take_along_axis(ap_blk, order[..., None, None], axis=1)
        new = np.ones_like(col_s, bool)
        new[:, 1:] = col_s[:, 1:] != col_s[:, :-1]
        slot = np.cumsum(new, axis=1) - 1
        q = int(slot.max()) + 1
        apc = np.zeros((C, q), np.int64)
        apb = np.zeros((C, q, 6, 6))
        rows = np.repeat(np.arange(C), k * pk)
        np.maximum.at(apc, (rows, slot.reshape(-1)), col_s.reshape(-1))
        np.add.at(apb, (rows, slot.reshape(-1)), blk_s.reshape(-1, 6, 6))
        # unused trailing slots (rows with < q unique columns) carry
        # zero blocks at column 0 — same as the padded-P convention,
        # pruned by the magnitude filter below
        # P^T(i) x AP(i): [C, PK, 6, 6]^T @ [C, Q, 6, 6] -> [C, PK, Q]
        left = np.matmul(
            np.swapaxes(pblk[s:e], -1, -2)[:, :, None], apb[:, None]
        )
        kI = np.broadcast_to(pcol[s:e][:, :, None], (C, pk, q))
        kJ = np.broadcast_to(apc[:, None, :], (C, pk, q))
        key = (kI.astype(np.int64) * n_agg + kJ).reshape(-1)
        val = left.reshape(-1, 6, 6)
        uk, inv = np.unique(key, return_inverse=True)
        red = np.zeros((len(uk), 6, 6))
        np.add.at(red, inv, val)
        keys_all.append(uk)
        vals_all.append(red)
    key = np.concatenate(keys_all)
    val = np.concatenate(vals_all)
    uk, inv = np.unique(key, return_inverse=True)
    red = np.zeros((len(uk), 6, 6))
    np.add.at(red, inv, val)
    # prune numerically-zero couplings: padded P slots (zero blocks at
    # column 0) otherwise give every aggregate a fake edge to aggregate
    # 0, whose neighborhood then swallows the whole next aggregation
    mag = np.abs(red).max(axis=(1, 2))
    keep = mag > 1e-13 * max(mag.max(), 1e-300)
    uk, red = uk[keep], red[keep]
    ci = (uk // n_agg).astype(np.int64)
    cj = (uk % n_agg).astype(np.int64)
    # to block ELL
    counts = np.bincount(ci, minlength=n_agg)
    kc = int(counts.max())
    adj_c = np.tile(np.arange(n_agg)[:, None], (1, kc))
    blk_c = np.zeros((n_agg, kc, 6, 6))
    slot = np.zeros(n_agg, np.int64)
    order = np.argsort(ci, kind="stable")
    for t in order:
        i = ci[t]
        adj_c[i, slot[i]] = cj[t]
        blk_c[i, slot[i]] = red[t]
        slot[i] += 1
    return _HostLevel(adj_c, blk_c, n_agg)


# ----------------------------------------------------------------------
# device levels and the cycle
# ----------------------------------------------------------------------


@dataclasses.dataclass
class _DeviceLevel:
    adj: torch.Tensor  # [n, K] int64
    blocks: torch.Tensor  # [n, K, 6, 6]
    inv_diag: torch.Tensor  # [n, 6, 6] block-Jacobi inverse
    omega: float
    pcol: Optional[torch.Tensor] = None  # [n, PK] (to the next level)
    pblk: Optional[torch.Tensor] = None  # [n, PK, 6, 6]
    rsrc: Optional[torch.Tensor] = None  # [n_coarse, RK] restriction gather table
    n_coarse: int = 0
    chol: Optional[torch.Tensor] = None  # coarsest: f64 lower Cholesky factor
    chol_scale: Optional[torch.Tensor] = None  # f64 [6 n]


def restriction_table(pcol: np.ndarray, pblk: np.ndarray, n_coarse: int) -> np.ndarray:
    """[n_coarse, RK] int64: for coarse node j, the flat indices i*PK + p of
    the nonzero blocks of P with pcol[i, p] == j, in index order, padded
    with n*PK (the index of an appended zero row). P^T r is then a gather
    and a sum over RK, in one order on any device."""
    n, pk = pcol.shape
    flat = np.nonzero(np.abs(pblk).reshape(n * pk, 36).max(axis=1) > 0)[0]
    col = pcol.reshape(-1)[flat]
    order = np.argsort(col, kind="stable")
    col, flat = col[order], flat[order]
    counts = np.bincount(col, minlength=n_coarse)
    start = np.cumsum(counts) - counts
    rank = np.arange(len(col)) - start[col]
    table = np.full((n_coarse, max(1, int(counts.max(initial=0)))), n * pk, np.int64)
    table[col, rank] = flat
    return table


def _coarse_factor(hl: _HostLevel):
    """(f64 lower Cholesky factor, scaling) of the coarsest level's dense
    operator, diagonally scaled, exactly symmetrized and shifted by 1e-10
    I. The factor stays f64 whatever the cycle's dtype: an SA coarsest
    level can be near-singular, where an f32 factor is noise."""
    dense = np.zeros((hl.n * 6, hl.n * 6))
    for i in range(hl.n):
        for s in range(hl.adj.shape[1]):
            j = hl.adj[i, s]
            dense[6 * i : 6 * i + 6, 6 * j : 6 * j + 6] += hl.blocks[i, s]
    d = np.diagonal(dense).copy()
    d[d <= 0] = 1.0
    sc = 1.0 / np.sqrt(d)
    scaled = dense * sc[:, None] * sc[None, :]
    scaled = 0.5 * (scaled + scaled.T) + 1e-10 * np.eye(len(d))
    return np.linalg.cholesky(scaled), sc


def device_levels(h_levels: List[_HostLevel], transfers, dtype, device) -> List[_DeviceLevel]:
    """The cycle's levels on ``device`` from the host levels and transfers
    ((pcol, pblk, n_coarse) per level but the last): blocks, inverse
    diagonal blocks and P in ``dtype``, the damping 4 / (3 lambda_max) from
    the seeded power iteration, the restriction table, and on the last
    level the f64 Cholesky factor."""
    out = []
    for li, hl in enumerate(h_levels):
        inv_d = _block_inv_diag(hl)
        lam = _lam_max(hl, inv_d)
        dl = _DeviceLevel(
            adj=torch.as_tensor(np.asarray(hl.adj, np.int64), device=device),
            blocks=torch.as_tensor(hl.blocks, dtype=dtype, device=device),
            inv_diag=torch.as_tensor(inv_d, dtype=dtype, device=device),
            omega=float(4.0 / (3.0 * max(lam, 1e-30))),
        )
        if li < len(transfers):
            pcol, pblk, n_agg = transfers[li]
            pcol, pblk = np.asarray(pcol, np.int64), np.asarray(pblk)
            dl.pcol = torch.as_tensor(pcol, device=device)
            dl.pblk = torch.as_tensor(pblk, dtype=dtype, device=device)
            dl.rsrc = torch.as_tensor(restriction_table(pcol, pblk, int(n_agg)), device=device)
            dl.n_coarse = int(n_agg)
        else:
            chol, sc = _coarse_factor(hl)
            dl.chol = torch.as_tensor(chol, dtype=torch.float64, device=device)
            dl.chol_scale = torch.as_tensor(sc, dtype=torch.float64, device=device)
        out.append(dl)
    return out


def _block_apply(m, r):
    """[n, 6, 6] @ [n, 6] per node."""
    return (m * r[:, None, :]).sum(dim=2)


def _smooth(dl: _DeviceLevel, x, b, sweeps: int, x_zero: bool = False):
    for i in range(sweeps):
        # b - A 0 is b exactly: the first sweep from zero skips its matvec
        r = b if (x_zero and i == 0) else b - ell_matvec(dl.blocks, dl.adj, x)
        x = x + dl.omega * _block_apply(dl.inv_diag, r)
    return x


def amg_cycle(levels: List[_DeviceLevel], b, nu_smooth: int = 3, cycle: str = "W", li: int = 0):
    """One cycle from level ``li`` on the rhs b [n_li, 6]: pre-smoothing
    from zero, restriction, the coarse correction (visited twice on the
    W cycle unless the next level is the coarsest), prolongation and
    post-smoothing; the coarsest level solves with its f64 factor."""
    dl = levels[li]
    if dl.chol is not None:
        rhs = (dl.chol_scale * b.reshape(-1).to(torch.float64))[:, None]
        y = torch.linalg.solve_triangular(dl.chol, rhs, upper=False)
        z = torch.linalg.solve_triangular(dl.chol.T, y, upper=True)
        return (dl.chol_scale * z[:, 0]).to(b.dtype).reshape(b.shape)
    x = _smooth(dl, torch.zeros_like(b), b, nu_smooth, x_zero=True)
    r = b - ell_matvec(dl.blocks, dl.adj, x)
    # restrict: r_c = P^T r, gathered per coarse node
    contrib = (dl.pblk * r[:, None, :, None]).sum(dim=2).reshape(-1, 6)  # [n*PK, 6]
    contrib = torch.cat([contrib, contrib.new_zeros((1, 6))])
    rc = contrib[dl.rsrc].sum(dim=1)
    ec = amg_cycle(levels, rc, nu_smooth, cycle, li + 1)
    if cycle == "W" and levels[li + 1].chol is None:
        rc2 = rc - ell_matvec(levels[li + 1].blocks, levels[li + 1].adj, ec)
        ec = ec + amg_cycle(levels, rc2, nu_smooth, cycle, li + 1)
    # prolong: e = P e_c
    x = x + ell_matvec(dl.pblk, dl.pcol, ec)
    return _smooth(dl, x, b, nu_smooth)


# ----------------------------------------------------------------------


class AMGShellSystem:
    """Shell solver with a smoothed-aggregation AMG preconditioner
    (arbitrary meshes; 6-dof block aggregation with rigid-mode tentative
    prolongation)."""

    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        dtype=torch.float64,
        coarse_max: int = 200,
        max_levels: int = 12,
        nu_smooth: int = 3,
        omega_sa: float = 4.0 / 3.0,
        strength: float = 0.06,
        cycle: str = "W",
        reorder: Optional[str] = "rcm",
        df: bool = False,
        verbose_setup: bool = False,
        device=None,
    ):
        """``df=True`` builds the hierarchy on the symmetrically
        diagonal-scaled operator and keeps the scaled f64 fine operator for
        ``solve_df`` / ``solve_df_refined``; pass dtype=torch.float32 with
        it for the production setting (f32 cycle, f64 outer CG).
        ``device`` defaults to CUDA; pass ``"cpu"`` to run on the host."""
        if cycle not in ("V", "W"):
            raise ValueError(f"unknown cycle {cycle!r}")
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        self.nu_smooth = nu_smooth
        self.cycle = cycle
        self.setup_timings = {
            k: 0.0
            for k in ("assemble", "strong", "aggregate", "tentative",
                      "smooth_p", "rap", "upload", "total")
        }
        _t_all = time.perf_counter()
        _t0 = time.perf_counter()
        self.sys = LargeShellSystem(mesh, material, dtype=torch.float64, reorder=reorder, device=device)
        self.device = self.sys.device
        vals = self.sys.assemble().cpu().numpy()
        self.setup_timings["assemble"] = time.perf_counter() - _t0
        pat = self.sys.pattern
        n = mesh.n_nodes
        if pat.offsets is not None:
            # stencil mode: the ELL adjacency from the offsets
            offs = np.asarray(pat.offsets)
            raw = np.arange(pat.n_pad)[:, None] + offs[None, :]
            adj = raw.clip(0, pat.n_pad - 1)
            k = len(offs)
            blocks = np.transpose(vals.reshape(6, 6, k, pat.n_pad), (3, 2, 0, 1))  # [Npad, K, 6, 6]
            blocks[(raw < 0) | (raw >= pat.n_pad)] = 0.0  # out-of-range (clipped) couplings
            self_slot = np.full(n, int(np.searchsorted(offs, 0)))
        else:
            adj = np.asarray(pat.adj_t).T  # [Npad, K]
            k = adj.shape[1]
            blocks = np.transpose(vals.reshape(6, 6, k, pat.n_pad), (3, 2, 0, 1))
            self_slot = None
        del vals
        lvl0 = _HostLevel(adj[:n].astype(np.int64).clip(0, n - 1), np.ascontiguousarray(blocks[:n]), n,
                          self_slot)
        del blocks

        coords = np.asarray(self.sys.mesh.coords, np.float64)  # after reordering
        nullspace = _rigid_modes(coords)

        self._s_df = None
        self._fine64 = None
        if df:
            # per-dof diagonal of the BC-applied operator; constrained rows
            # carry the unit diagonal, so s = 1 there
            self_mask = lvl0.adj == np.arange(n)[:, None]
            dblk = (lvl0.blocks * self_mask[:, :, None, None]).sum(1)
            d = np.einsum("naa->na", dblk).copy()
            d[d <= 0] = 1.0
            s = 1.0 / np.sqrt(d)  # [n, 6]
            lvl0.blocks = lvl0.blocks * s[:, None, :, None] * s[lvl0.adj][:, :, None, :]
            nullspace = nullspace / s[:, :, None]  # the nullspace of S A S is S^-1 B
            self._s_df = torch.as_tensor(s, device=self.device)
            self._fine64 = (torch.as_tensor(lvl0.blocks, device=self.device),
                            torch.as_tensor(lvl0.adj, device=self.device))

        self.h_levels: List[_HostLevel] = [lvl0]
        self.transfers = []  # (pcol, pblk, n_coarse)
        lvl = lvl0
        tm = self.setup_timings

        def _mark(key, t0):
            t1 = time.perf_counter()
            tm[key] += t1 - t0
            return t1

        while lvl.n > coarse_max and len(self.h_levels) < max_levels:
            _t0 = time.perf_counter()
            nbrs = _strong_graph(lvl, strength) if strength > 0 else None
            _t0 = _mark("strong", _t0)
            agg, n_agg = aggregate(lvl.adj, lvl.n, nbrs)
            _t0 = _mark("aggregate", _t0)
            if n_agg >= lvl.n:  # no coarsening progress
                break
            p0, nullspace = _tentative(nullspace, agg, n_agg)
            _t0 = _mark("tentative", _t0)
            inv_diag = _block_inv_diag(lvl)
            lam = _lam_max(lvl, inv_diag)
            pcol, pblk = _smooth_p(lvl, p0, agg, omega_sa / max(lam, 1e-30), inv_diag)
            _t0 = _mark("smooth_p", _t0)
            nxt = _rap(lvl, pcol, pblk, n_agg)
            _mark("rap", _t0)
            self.transfers.append((pcol, pblk, n_agg))
            self.h_levels.append(nxt)
            lvl = nxt

        _t0 = time.perf_counter()
        self.levels = device_levels(self.h_levels, self.transfers, dtype, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tm["upload"] = time.perf_counter() - _t0
        tm["total"] = time.perf_counter() - _t_all
        if verbose_setup:
            print("# amg setup timings: " + " ".join(f"{k}={v:.2f}s" for k, v in tm.items()), flush=True)

    # ------------------------------------------------------------------
    def _prec(self, r):
        return amg_cycle(self.levels, r, self.nu_smooth, self.cycle)

    def _rhs(self, forces):
        """[n, 6] f64 forces in the system's numbering, constrained dofs
        zeroed."""
        return self.sys._forces_in(forces)[:, : self.mesh.n_nodes].T

    def _out(self, x):
        """f64 [n_nodes, 6] in the original numbering, unscaled."""
        u = x.to(torch.float64)
        if self._s_df is not None:
            u = u * self._s_df
        return self.sys.original_order(u)

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 1000):
        """PCG in ``dtype`` over the fine level, preconditioned by one cycle.
        Sets ``last_cg``, ``last_iters``, ``last_residual``; returns the f64
        displacements [n_nodes, 6] on the device."""
        b = self._rhs(forces).to(self.dtype)
        if self._s_df is not None:  # the hierarchy is scaled (df=True)
            b = b * self._s_df.to(self.dtype)
        fine = self.levels[0]
        res = pcg(lambda x: ell_matvec(fine.blocks, fine.adj, x), b, rtol=rtol, maxiter=maxiter,
                  apply_prec=self._prec)
        self.last_cg = res
        self.last_iters = int(res.iters)
        self.last_residual = float(res.residual)
        return self._out(res.x)

    # ------------------------------------------------------------------
    def _require_df(self):
        if self._fine64 is None:
            raise ValueError("construct AMGShellSystem with df=True for solve_df / solve_df_refined")

    def _inner(self, b, rtol: float, maxiter: int):
        """f64 CG over the scaled f64 fine operator, preconditioned by the
        cycle in ``dtype``."""
        blocks, adj = self._fine64
        return pcg(lambda x: ell_matvec(blocks, adj, x), b, rtol=rtol, maxiter=maxiter,
                   apply_prec=lambda r: self._prec(r.to(self.dtype)).to(torch.float64))

    def solve_df(self, forces, rtol: float = 1e-10, maxiter: int = 2000):
        """The JAX package's df solve in native f64: CG over the scaled f64
        operator with the ``dtype`` cycle (construct with df=True). Sets
        ``last_iters`` and ``last_residual``; returns as ``solve``."""
        self._require_df()
        res = self._inner(self._rhs(forces) * self._s_df, rtol, maxiter)
        self.last_iters = int(res.iters)
        self.last_residual = float(res.residual)
        return self._out(res.x)

    def solve_df_refined(self, forces, rtol: float = 1e-9, n_refine: int = 6, inner_rtol: float = 1e-5,
                         inner_maxiter: int = 2000, verbose: bool = False):
        """``solve_df`` to ``inner_rtol`` plus iterative refinement
        (``solver.refine``) on the compensated true residual of the scaled
        f64 operator (``ops/soa.gather_resid_dd`` on a view of the
        node-major blocks), the iterate a double-double. Sets
        ``last_iters``, ``last_residual``, ``refine_history`` and
        ``refine_inner_iters``; returns as ``solve``."""
        self._require_df()
        blocks, adj = self._fine64
        b = self._rhs(forces) * self._s_df
        # [n, K, 6, 6] / [n, K] / [n, 6] viewed as the SoA [6, 6, K, n] / [K, n] / [6, n]
        values, adj_t, b_t = blocks.permute(2, 3, 1, 0), adj.T, b.T

        def resid(x_hi, x_lo):
            return gather_resid_dd(values, x_hi.T, b_t, adj_t).T - ell_matvec(blocks, adj, x_lo)

        out = refine(self._inner, resid, b, rtol, n_refine, inner_rtol, inner_maxiter, verbose)
        self.last_iters = sum(out.inner_iters)
        self.last_residual = out.history[-1] if out.history else float("nan")
        self.refine_history = out.history
        self.refine_inner_iters = out.inner_iters
        return self._out(out.x)

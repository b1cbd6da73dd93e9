"""Exact-stencil row-class tables for uniform structured grids — port of
``fem_shell_tpu/ops/exact_stencil.py`` (host-side construction).

On a uniform grid every interior node has the SAME stencil row, so any
rounding of the operator is a constant-coefficient perturbation,
perfectly correlated across the mesh, and plate bending amplifies it by
the condition number (kappa ~ n^4). The refinement operator therefore
comes from the true row classes computed once in extended precision:
a node's stencil row depends only on its clamped boundary distances
(0, 1, >=2 per side), because element incidence is complete at distance
>= 1 and Dirichlet column elimination reaches distance 1 only. A 6x6-node
patch with the big grid's spacing and BC pattern reproduces every row
class exactly; its interior redundancy (patch nodes 2 and 3 per axis)
doubles as a consistency check.

The patch is assembled in numpy longdouble from ``ops/elements_ld.py``
(the JAX package runs its traced kernels through a longdouble jaxpr
interpreter instead), and the class tables are split into a triple of
float32 tables t0 + t1 + t2 that represents the longdouble table to
~2^-72 relative. ``ops/class_matvec.py`` turns them into the matrix-free
operator; ``class_flat_tables`` / ``class_pair_flat`` generate the
class-consistent materialized operator of the pair path from them (the
JAX package's tile-major ``class_pair_tiled`` is a TPU layout and is not
ported).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.ops.elements_ld import LD, quad_shell_stiffness, tri_shell_stiffness

_P = 6  # patch nodes per dimension (classes 0, 1, interior, interior, -2, -1)


def _class_idx(n: int) -> np.ndarray:
    """Class index per grid position: 0,1 near the low edge, 2 (or the
    redundant 3) interior, 4,5 near the high edge."""
    ix = np.arange(n)
    cls = np.full(n, 2, np.int32)
    cls[ix < 2] = ix[ix < 2]
    hi = n - 1 - ix
    cls[hi < 3] = 5 - hi[hi < 3]
    cls[ix == 2] = 2
    return cls


def _split_offsets(offsets, nxp: int):
    """Flat SoA offsets -> [(dy, dx)] with dy, dx in {-1, 0, 1}."""
    out = []
    for o in offsets:
        o = int(o)
        for dy in (-1, 0, 1):
            dx = o - dy * nxp
            if abs(dx) <= 1:
                out.append((dy, dx))
                break
        else:
            raise ValueError(f"offset {o} is not a 9-point neighbor for nxp={nxp}")
    return tuple(out)


def _material_ld(nu: float, em: float, thickness: float):
    nu = LD(nu)
    em = LD(em)
    t = LD(thickness)
    base = np.array(
        [[LD(1), nu, LD(0)], [nu, LD(1), LD(0)], [LD(0), LD(0), (LD(1) - nu) / LD(2)]],
        dtype=LD,
    )
    dm = base * (em / (LD(1) - nu * nu))
    dp = base * (em * t**3 / (LD(12) * (LD(1) - nu * nu)))
    return dm, dp


@dataclasses.dataclass
class ExactStencil:
    """Triple-f32 true stencil tables + class maps for one structured
    grid system. ``t0+t1+t2`` represents the longdouble row-class table
    to ~2^-72 relative."""

    offsets: tuple  # flat SoA offsets (ints)
    offs2d: tuple  # [(dy, dx)] per offset
    t0: np.ndarray  # [K, 6, 6, P, P] f32
    t1: np.ndarray
    t2: np.ndarray
    cy_idx: np.ndarray  # [nyp] int32
    cx_idx: np.ndarray  # [nxp] int32
    nyp: int
    nxp: int


def build_exact_stencil(mesh, material, offsets, dirichlet_mask=None,
                        grid=None, timings=None) -> ExactStencil:
    """Host-side: longdouble patch assembly -> row-class tables.

    ``mesh`` must be a uniform structured grid (coords affine in (ix, iy)
    to f64 rounding). Raises ValueError when the grid is not structured,
    not uniform, smaller than the patch, or its Dirichlet mask is not
    class-consistent, and AssertionError when the patch's two interior
    representatives disagree. ``grid`` (optional GridInfo) skips the
    connectivity re-verification when the caller already detected it.
    ``timings`` (optional dict) receives the host seconds of each stage.
    """
    from fem_shell_tpu_torch.mg import _grid_conn, detect_structured_grid

    t_last = time.perf_counter()

    def mark(name):
        nonlocal t_last
        if timings is not None:
            t = time.perf_counter()
            timings[name] = t - t_last
            t_last = t

    if grid is None:
        grid = detect_structured_grid(mesh)
    if grid is None:
        raise ValueError("exact stencil requires a structured grid mesh")
    nxp, nyp = grid.nxp, grid.nyp
    if nxp < _P or nyp < _P:
        raise ValueError(f"grid {nyp}x{nxp} smaller than the {_P}x{_P} class patch")
    mark("grid_detect")

    # uniformity check in plain f64 (its own rounding, ~3 ulp, sits far
    # inside the 64-eps gate)
    coords = np.asarray(mesh.coords, np.float64).reshape(nyp, nxp, 3)
    ex64 = (coords[0, -1] - coords[0, 0]) / (nxp - 1)
    ey64 = (coords[-1, 0] - coords[0, 0]) / (nyp - 1)
    iy, ix = np.meshgrid(np.arange(nyp), np.arange(nxp), indexing="ij")
    ideal64 = (
        coords[0, 0][None, None, :]
        + ix[:, :, None] * ex64[None, None, :]
        + iy[:, :, None] * ey64[None, None, :]
    )
    scale = float(np.max(np.abs(coords)))
    dev = float(np.max(np.abs(ideal64 - coords)))
    if dev > 64 * np.finfo(np.float64).eps * max(scale, 1.0):
        raise ValueError(f"mesh is not a uniform grid (max deviation {dev:.3e})")
    c00 = coords[0, 0].astype(LD)
    ex = (coords[0, -1].astype(LD) - c00) / LD(nxp - 1)
    ey = (coords[-1, 0].astype(LD) - c00) / LD(nyp - 1)
    mark("ideal_check")

    mask = np.asarray(
        mesh.dirichlet_mask() if dirichlet_mask is None else dirichlet_mask, bool
    ).reshape(nyp, nxp, 6)
    cy_idx = _class_idx(nyp)
    cx_idx = _class_idx(nxp)
    rep_y = np.array([0, 1, 2, nyp - 3, nyp - 2, nyp - 1])
    rep_x = np.array([0, 1, 2, nxp - 3, nxp - 2, nxp - 1])
    mask_patch = mask[rep_y][:, rep_x]  # [P, P, 6]
    if not (mask == mask_patch[cy_idx][:, cx_idx]).all():
        raise ValueError("Dirichlet mask is not class-consistent with the patch")
    mark("mask_check")

    # ---- longdouble patch assembly ----------------------------------
    dm_ld, dp_ld = _material_ld(material.nu, material.em, material.thickness)
    _, conn4 = _grid_conn(_P, _P, grid.elem_type, grid.ul_lr)
    m = 3 if grid.elem_type == "t" else 4
    conn = conn4[:, :m]
    pyy, pxx = np.meshgrid(np.arange(_P), np.arange(_P), indexing="ij")
    pc = (
        pxx[:, :, None].astype(LD) * ex[None, None, :]
        + pyy[:, :, None].astype(LD) * ey[None, None, :]
    ).reshape(_P * _P, 3)

    kern = tri_shell_stiffness if m == 3 else quad_shell_stiffness
    kmat = np.zeros((_P * _P * 6, _P * _P * 6), LD)
    for nodes in conn:
        ke = kern(pc[nodes], dm_ld, dp_ld, float(material.thickness))
        for i, ni in enumerate(nodes):
            for j, nj in enumerate(nodes):
                kmat[6 * ni : 6 * ni + 6, 6 * nj : 6 * nj + 6] += ke[
                    6 * i : 6 * i + 6, 6 * j : 6 * j + 6
                ]
    cdof = np.nonzero(mask_patch.reshape(-1))[0]
    kmat[cdof, :] = LD(0)
    kmat[:, cdof] = LD(0)
    kmat[cdof, cdof] = LD(1)
    mark("patch_ld_assembly")

    # ---- extract class tables ----------------------------------------
    offs2d = _split_offsets(offsets, nxp)
    k = len(offs2d)
    table = np.zeros((k, 6, 6, _P, _P), LD)
    for s, (dy, dx) in enumerate(offs2d):
        for py in range(_P):
            for px in range(_P):
                qy, qx = py + dy, px + dx
                if 0 <= qy < _P and 0 <= qx < _P:
                    q = py * _P + px
                    qq = qy * _P + qx
                    table[s, :, :, py, px] = kmat[6 * q : 6 * q + 6, 6 * qq : 6 * qq + 6]
    # interior redundancy check: patch columns/rows 2 and 3 are both
    # interior representatives and must agree to longdouble rounding
    tnorm = float(np.max(np.abs(table.astype(np.float64)))) or 1.0
    dx_err = float(np.max(np.abs((table[:, :, :, 2:4, 2] - table[:, :, :, 2:4, 3]).astype(np.float64))))
    dy_err = float(np.max(np.abs((table[:, :, :, 2, 2:4] - table[:, :, :, 3, 2:4]).astype(np.float64))))
    if max(dx_err, dy_err) > 1e-14 * tnorm:
        raise AssertionError(f"patch interior rows inconsistent ({dx_err:.3e}, {dy_err:.3e})")

    t0 = table.astype(np.float32)
    rem = table - t0.astype(LD)
    t1 = rem.astype(np.float32)
    t2 = (rem - t1.astype(LD)).astype(np.float32)
    mark("table_extract")
    return ExactStencil(
        offsets=tuple(int(o) for o in offsets),
        offs2d=offs2d,
        t0=t0,
        t1=t1,
        t2=t2,
        cy_idx=cy_idx,
        cx_idx=cx_idx,
        nyp=nyp,
        nxp=nxp,
    )


def class_flat_tables(stencil: ExactStencil):
    """(tfl0, tfl1, tfl2, cls_flat): the tables in the SoA row order (row
    (a*6+b)*K + s, as the operator's values) as [36K, P*P] f32, and the
    per-node class index [nyp*nxp] int32."""
    k = len(stencil.offs2d)

    def tfl(t):
        return np.ascontiguousarray(np.transpose(t, (1, 2, 0, 3, 4)).reshape(36 * k, _P * _P))

    cls_flat = (stencil.cy_idx[:, None] * _P + stencil.cx_idx[None, :]).reshape(-1).astype(np.int32)
    return tfl(stencil.t0), tfl(stencil.t1), tfl(stencil.t2), cls_flat


def class_pair_flat(tfl0, tfl1, cls_flat, npad: int, device=None):
    """Device: the class-consistent materialized fine operator, generated
    from the (t0, t1) tables by per-node class index, zero on the padding:
    (a64, hi), each [36, K, Npad]. ``a64`` = fl64(t0 + t1) in f64 (the
    JAX package's df pair (hi, lo) as one f64 operator: the CG operator
    and the refinement residual's main term), ``hi`` = t0 in f32 (the
    level-0 V-cycle values). A padded node takes an appended all-zero
    class column, so each operator is one gather with no temporary."""
    dev = resolve_device(device)
    k = tfl0.shape[0] // 36
    cls = torch.full((npad,), _P * _P, dtype=torch.int64)
    cls[: len(cls_flat)] = torch.from_numpy(np.asarray(cls_flat, np.int64))
    cls = cls.to(dev)

    def gen(t):
        tz = torch.from_numpy(np.pad(t, ((0, 0), (0, 1)))).to(dev)
        return torch.index_select(tz, 1, cls).reshape(36, k, npad)

    a64 = gen(np.asarray(tfl0, np.float64) + np.asarray(tfl1, np.float64))
    return a64, gen(np.asarray(tfl0, np.float32))


def exact_matvec_ld(stencil: ExactStencil, x64):
    """Host oracle: y = A_true x in longdouble from the class tables, x64
    [6, nyp*nxp] (numpy); returns longdouble [6, nyp*nxp]. A neighbour
    outside the grid contributes nothing."""
    nyp, nxp = stencil.nyp, stencil.nxp
    t = stencil.t0.astype(LD) + stencil.t1.astype(LD) + stencil.t2.astype(LD)  # [K,6,6,P,P]
    xg = np.asarray(x64).astype(LD).reshape(6, nyp, nxp)
    y = np.zeros((6, nyp, nxp), LD)
    for s, (dy, dx) in enumerate(stencil.offs2d):
        xs = np.zeros_like(xg)
        ys0, ys1 = max(0, -dy), min(nyp, nyp - dy)
        xs0, xs1 = max(0, -dx), min(nxp, nxp - dx)
        xs[:, ys0:ys1, xs0:xs1] = xg[:, ys0 + dy : ys1 + dy, xs0 + dx : xs1 + dx]
        coeff = t[s][:, :, stencil.cy_idx][:, :, :, stencil.cx_idx]  # [6,6,nyp,nxp]
        y += np.einsum("abyx,byx->ayx", coeff, xs)
    return y.reshape(6, nyp * nxp)

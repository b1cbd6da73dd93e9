"""Matrix-free class-table operator for uniform structured grids — port
of ``fem_shell_tpu/ops/class_matvec.py``.

On a uniform grid the stiffness operator has O(1) distinct stencil rows
(6 boundary-distance classes per axis, ops/exact_stencil.py), so a
materialized per-node operator (2.12 GB in f64 at 1024^2 tri) stores and
streams the same few hundred numbers a million times over. This module
keeps the operator AS its classes and evaluates

    y = A x  =  (interior constant stencil) x  +  (boundary-band deltas) x

on the fly, through one kernel (ops/class_stencil.py): the interior term
needs no coefficient traffic at all, and the per-class corrections live
only on the 2-node-wide boundary bands, precomputed on the host as exact
longdouble deltas.

Precision. The JAX package runs this operator in two-float32 ("df")
arithmetic because TPU f64 is emulated; the port keeps its operators and
does the arithmetic in native f64:

- the CG operator is the JAX package's A_df = t0 + t1, taken per
  coefficient as fl64(t0 + t1) (``class_matvec_f64``);
- the refinement correction is its E = t2 (``class_ecorr``, interior t2
  plus the band e-deltas), evaluated in f32 on x rounded to f32 as the
  JAX package does: |E| ~ 2^-48 |A|, so that error sits near 2^-72 |A||x|;
- the V-cycle's level-0 operator stays the f32 t0 table
  (``class_matvec_f32``, with the fused w * (b - A x) form).

The refinement residual r = b - A x - E x of the JAX class path is only
df-accurate (its ``class_matvec_df``), so plain f64 accumulation matches
or beats it, and this path needs no double-double kernel; the
compensated residual (TPU kernel 5) belongs to the materialized-pair
path.

Not ported: the padded (8,128) lane layout of ``ops/pallas_class.py``
(``_PadGridSpec``, ``to_pad_grid``, ``from_pad_grid``, ``pad_core``,
``pad_embed``, ``pad_ring_mask``); the port works on the flat [6, Npad]
vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.ops.class_stencil import ClassTable, class_stencil
from fem_shell_tpu_torch.ops.elements_ld import LD
from fem_shell_tpu_torch.ops.exact_stencil import _P, ExactStencil


@dataclasses.dataclass
class ClassParts:
    """The class-table operator on one device: three coefficient sets
    (``hi`` = t0 in f32, ``a64`` = fl64(t0 + t1), ``e`` = t2 in f32), the
    grid, and the structural mask the kernel skips by: ``masks`` [K]
    uint64 (host), bit a*6+b of masks[s] set where (a, b, s) has a nonzero
    interior scalar in any of t0/t1/t2 (the JAX package's ``nzmask``) or
    a nonzero band delta."""

    hi: ClassTable
    a64: ClassTable
    e: ClassTable
    offs2d: Tuple[Tuple[int, int], ...]
    nyp: int
    nxp: int
    npad: int
    masks: np.ndarray


def _split3(d_ld):
    """Longdouble -> (f32, f32, f32) triple split (exact residual chain)."""
    h = d_ld.astype(np.float32)
    r = d_ld - h.astype(LD)
    l = r.astype(np.float32)
    e = (r - l.astype(LD)).astype(np.float32)
    return h, l, e


def build_class_parts(st: ExactStencil, npad: int, device=None):
    """Host: exact-stencil tables -> (ClassParts, diag [6, npad] f32),
    uploaded to ``device`` (CUDA unless "cpu" is asked for).

    A_true is t0 + t1 + t2 in longdouble, so the interior + delta split
    rounds only at the triple-f32 floor (~2^-72 relative)."""
    dev = resolve_device(device)
    nyp, nxp = st.nyp, st.nxp
    if nyp < _P or nxp < _P:
        raise ValueError(f"grid {nyp}x{nxp} smaller than the class patch")
    a_ld = st.t0.astype(LD) + st.t1.astype(LD) + st.t2.astype(LD)  # [K,6,6,P,P]
    a_int = a_ld[:, :, :, 2, 2]
    cy, cx = st.cy_idx, st.cx_idx

    def band_rows(rows):
        d = a_ld[:, :, :, cy[rows], :][:, :, :, :, cx] - a_int[..., None, None]
        return _split3(d)  # [K,6,6,2,nxp]

    def band_cols(cols):
        d = a_ld[:, :, :, cy, :][:, :, :, :, cx[cols]] - a_int[..., None, None]
        d[:, :, :, (0, 1, nyp - 2, nyp - 1), :] = LD(0)  # corners: row bands own them
        return _split3(np.swapaxes(d, 3, 4))  # [K,6,6,2,nyp]

    bands = (band_rows(np.array([0, 1])), band_rows(np.array([nyp - 2, nyp - 1])),
             band_cols(np.array([0, 1])), band_cols(np.array([nxp - 2, nxp - 1])))

    k0 = st.offs2d.index((0, 0))
    aa = np.arange(6)
    # the [6, P, P] diagonal class table expands in f64: its only use is a
    # preconditioner diagonal, where an f32 double-rounding tie is harmless
    diag_tab = a_ld[k0, aa, aa].astype(np.float64)  # [6, P, P]
    diag = np.zeros((6, npad), np.float32)
    diag[:, : nyp * nxp] = diag_tab[:, cy, :][:, :, cx].reshape(6, -1).astype(np.float32)

    ih = np.asarray(st.t0[:, :, :, 2, 2], np.float32)
    il = np.asarray(st.t1[:, :, :, 2, 2], np.float32)
    i2 = np.asarray(st.t2[:, :, :, 2, 2], np.float32)
    parts = class_parts_of(ih, il, i2, bands, st.offs2d, nyp, nxp, npad, dev)
    return parts, torch.from_numpy(diag).to(dev)


def class_parts_of(ih, il, i2, bands, offs2d, nyp: int, nxp: int, npad: int, device):
    """ClassParts from the f32 triple tables: interior ``ih``/``il``/``i2``
    [K, 6, 6] and ``bands`` = four (h, l, e) triples of [K, 6, 6, 2, L]
    delta tables (top, bottom, left, right)."""
    nz = (ih != 0) | (il != 0) | (i2 != 0)  # [K, 6, 6]
    for band in bands:
        for part in band:
            nz = nz | (np.asarray(part) != 0).any(axis=(3, 4))
    bits = (1 << np.arange(36, dtype=np.uint64)).reshape(6, 6)
    masks = np.array([int(bits[nz[s]].sum()) for s in range(len(offs2d))], np.uint64)

    def f64(h, l):
        return np.asarray(h, np.float64) + np.asarray(l, np.float64)

    return ClassParts(
        hi=ClassTable.from_numpy(ih, *(bd[0] for bd in bands), device=device),
        a64=ClassTable.from_numpy(f64(ih, il), *(f64(bd[0], bd[1]) for bd in bands), device=device),
        e=ClassTable.from_numpy(i2, *(bd[2] for bd in bands), device=device),
        offs2d=tuple(tuple(int(v) for v in o) for o in offs2d),
        nyp=int(nyp),
        nxp=int(nxp),
        npad=int(npad),
        masks=masks,
    )


def _apply(cp: ClassParts, table: ClassTable, x, w=None, b=None):
    return class_stencil(table, x, cp.offs2d, cp.masks, cp.nyp, cp.nxp, w=w, b=b)


def class_matvec_f64(cp: ClassParts, x):
    """y = A_df x in f64, A_df = fl64(t0 + t1) per class coefficient;
    x/y [6, npad] f64. The counterpart of the JAX package's
    ``class_matvec_df``: the fine CG operator."""
    return _apply(cp, cp.a64, x)


def class_matvec_f32(cp: ClassParts, x, w=None, b=None):
    """y = A_hi x in f32 (t0 table only): the V-cycle level-0 smoother and
    power-iteration operator. With ``w`` and ``b``: y = w * (b - A_hi x)
    in the same kernel pass (the smoother's correction)."""
    return _apply(cp, cp.hi, x, w=w, b=b)


def class_ecorr(cp: ClassParts, x32):
    """y = E x in f32, E = A_true - A_df (the t2-class third term), on
    x rounded to f32: the refinement residual's correction term."""
    return _apply(cp, cp.e, x32)

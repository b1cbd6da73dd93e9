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
compensated residual (TPU kernel 5, ops/stencil_resid.py) belongs to the
materialized-pair path, whose E term is ``build_pair_ecorr`` /
``pair_ecorr`` below: the same kernel on a table of E = A_true - A64.

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
    grid, and the structural mask that picks the kernel's term pattern:
    ``masks`` [K] uint64 (host), bit a*6+b of masks[s] set where (a, b, s)
    has a nonzero interior scalar in any of t0/t1/t2 (the JAX package's
    ``nzmask``) or a nonzero band delta. Each table carries the offsets,
    the masks and its packed launch arguments."""

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


def _band_deltas(tab, st: ExactStencil):
    """Per-node deltas of a [K, 6, 6, P, P] class table to its interior
    class (2, 2) on the four 2-node-wide bands, in the table's type: top
    and bottom [K, 6, 6, 2, nxp], then left and right [K, 6, 6, 2, nyp],
    zero on the four band rows (corners: the row bands own them)."""
    nyp, nxp, cy, cx = st.nyp, st.nxp, st.cy_idx, st.cx_idx
    t_int = tab[:, :, :, 2, 2][..., None, None]

    def rows(r):
        return tab[:, :, :, cy[r], :][:, :, :, :, cx] - t_int

    def cols(c):
        d = tab[:, :, :, cy, :][:, :, :, :, cx[c]] - t_int
        d[:, :, :, (0, 1, nyp - 2, nyp - 1), :] = 0
        return np.swapaxes(d, 3, 4)

    return (rows(np.array([0, 1])), rows(np.array([nyp - 2, nyp - 1])),
            cols(np.array([0, 1])), cols(np.array([nxp - 2, nxp - 1])))


def _masks(nz):
    """[K] uint64 kernel masks from a [K, 6, 6] bool table of accumulated
    (s, a, b): bit a*6+b of masks[s]."""
    bits = (1 << np.arange(36, dtype=np.uint64)).reshape(6, 6)
    return np.array([int(bits[nz[s]].sum()) for s in range(nz.shape[0])], np.uint64)


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
    bands = tuple(_split3(d) for d in _band_deltas(a_ld, st))
    cy, cx = st.cy_idx, st.cx_idx

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
    masks = _masks(nz)
    offs2d = tuple(tuple(int(v) for v in o) for o in offs2d)

    def f64(h, l):
        return np.asarray(h, np.float64) + np.asarray(l, np.float64)

    def table(interior, parts):
        return ClassTable.from_numpy(interior, *parts, offs2d=offs2d, masks=masks, device=device)

    return ClassParts(
        hi=table(ih, [bd[0] for bd in bands]),
        a64=table(f64(ih, il), [f64(bd[0], bd[1]) for bd in bands]),
        e=table(i2, [bd[2] for bd in bands]),
        offs2d=offs2d,
        nyp=int(nyp),
        nxp=int(nxp),
        npad=int(npad),
        masks=masks,
    )


def class_matvec_f64(cp: ClassParts, x):
    """y = A_df x in f64, A_df = fl64(t0 + t1) per class coefficient;
    x/y [6, npad] f64. The counterpart of the JAX package's
    ``class_matvec_df``: the fine CG operator."""
    return class_stencil(cp.a64, x)


def class_matvec_f32(cp: ClassParts, x, w=None, b=None):
    """y = A_hi x in f32 (t0 table only): the V-cycle level-0 smoother and
    power-iteration operator. With ``w`` and ``b``: y = w * (b - A_hi x)
    in the same kernel pass (the smoother's correction)."""
    return class_stencil(cp.hi, x, w=w, b=b)


def class_ecorr(cp: ClassParts, x32):
    """y = E x in f32, E = A_true - A_df (the t2-class third term), on
    x rounded to f32: the refinement residual's correction term."""
    return class_stencil(cp.e, x32)


def class_residual(cp: ClassParts, x, b):
    """The true residual r = b - A_df x - E x of the class operator, E on x
    rounded to f32 (as the JAX package evaluates it), and ||r|| / ||b||;
    x, b [6, npad] f64. The refinement residual of the class path
    (``MultigridShellSystem``) and of the sharded grid system
    (``parallel/grid_asm_shard``)."""
    r = b - class_matvec_f64(cp, x)
    e = class_ecorr(cp, x.to(torch.float32))
    r = r - e.to(torch.float64)
    return r, torch.sqrt(torch.sum(r * r)) / torch.sqrt(torch.sum(b * b))


@dataclasses.dataclass
class PairECorr:
    """The pair path's refinement correction E = A_true - A64 as a class
    table in f32, A64 = fl64(t0 + t1) per class (the operator
    ``exact_stencil.class_pair_flat`` generates), with its grid and the
    kernel's masks (as ``ClassParts.masks``)."""

    table: ClassTable
    offs2d: Tuple[Tuple[int, int], ...]
    nyp: int
    nxp: int
    masks: np.ndarray


def build_pair_ecorr(st: ExactStencil, device=None) -> PairECorr:
    """Host: E(class) = A_true(class) - fl64(t0 + t1)(class) in
    longdouble, as interior scalars (class (2, 2)) and band deltas, each
    rounded once to f32, uploaded to ``device``.

    E is t2 wherever fl64(t0 + t1) is exact; where t1 is so much smaller
    than t0 that the sum spans more than 53 bits, fl64 rounds it, and E
    carries that rounding too, so the residual A64 x + E x stays exact to
    the f32 rounding of E (|E| ~ 2^-48 |A|: ~2^-72 |A||x|)."""
    dev = resolve_device(device)
    a64 = (st.t0.astype(np.float64) + st.t1.astype(np.float64)).astype(LD)
    e_ld = st.t0.astype(LD) + st.t1.astype(LD) + st.t2.astype(LD) - a64  # [K,6,6,P,P]
    interior = e_ld[:, :, :, 2, 2].astype(np.float32)
    bands = tuple(d.astype(np.float32) for d in _band_deltas(e_ld, st))
    nz = interior != 0
    for band in bands:
        nz = nz | (band != 0).any(axis=(3, 4))
    offs2d = tuple(tuple(int(v) for v in o) for o in st.offs2d)
    masks = _masks(nz)
    return PairECorr(
        table=ClassTable.from_numpy(interior, *bands, offs2d=offs2d, masks=masks, device=dev),
        offs2d=offs2d,
        nyp=int(st.nyp),
        nxp=int(st.nxp),
        masks=masks,
    )


def pair_ecorr(ec: PairECorr, x32):
    """y = E x in f32 on x rounded to f32 ([6, npad]): the pair path's
    refinement residual correction, one class-stencil launch (the JAX
    package's ``class_stencil_matvec_f32`` on its t2 table)."""
    return class_stencil(ec.table, x32)

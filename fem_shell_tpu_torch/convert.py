"""Carry state across from the JAX package to the port.

The functions take the JAX package's objects (or anything with the same
fields) and read every array through ``numpy.asarray``, so this module —
like the whole port — imports nothing of JAX. With them a test feeds the
same mesh, material, assembled operator and multigrid levels to both
packages, the same exact-stencil tables and class operator, so the
kernel-and-plain parity stands apart from the longdouble table build, and
the same AMG hierarchy, so the port's cycle runs on the JAX set-up.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from fem_shell_tpu_torch.amg import _DeviceLevel, _HostLevel, device_levels
from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.mg import _Level
from fem_shell_tpu_torch.ops.class_matvec import ClassParts, class_parts_of
from fem_shell_tpu_torch.ops.exact_stencil import ExactStencil


def mesh_from_jax(mesh) -> ShellMesh:
    """A JAX-package ``ShellMesh`` as the port's ``ShellMesh``."""
    extra = getattr(mesh, "node_dirichlet_mask", None)
    return ShellMesh(
        np.asarray(mesh.coords, np.float64),
        np.asarray(mesh.elem_types, np.int32),
        np.asarray(mesh.elem_conn, np.int32),
        np.asarray(mesh.boundary_sides, np.int32),
        boundary_nodes=np.asarray(getattr(mesh, "boundary_nodes", np.zeros((0, 2))), np.int32),
        node_dirichlet_mask=None if extra is None else np.asarray(extra, bool),
    )


def material_from_jax(material) -> Material:
    """A JAX-package ``Material`` as the port's ``Material``."""
    return Material(float(material.nu), float(material.em), float(material.thickness))


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.array(np.asarray(a))).to(device)  # owned, writable copy


def level_from_jax(lvl, device=None) -> _Level:
    """One JAX-package multigrid ``_Level`` as the port's ``_Level``, each
    array in its own dtype.

    Carries ``values`` ([36, K, Npad], or flat [36K, Npad], which is
    reshaped), ``offsets``, ``free_t``, ``inv_diag``, ``nyp``, ``nxp``,
    ``npad``, ``omega``, ``lam``, ``chol``, ``chol_scale`` and the class
    operator ``cparts``. A tile-major
    (4-D) Pallas value layout is a TPU artefact and is refused.
    """
    dev = resolve_device(device)
    offsets = tuple(int(o) for o in lvl.offsets)
    values = None
    if lvl.values is not None:
        v = np.asarray(lvl.values)
        if v.ndim == 4:
            raise ValueError("tile-major (TPU Pallas) values layout: untile it first")
        values = _tensor(v.reshape(36, len(offsets), int(lvl.npad)), dev)
    return _Level(
        values=values,
        offsets=offsets,
        free_t=_tensor(lvl.free_t, dev),
        inv_diag=_tensor(lvl.inv_diag, dev),
        nyp=int(lvl.nyp),
        nxp=int(lvl.nxp),
        npad=int(lvl.npad),
        omega=_tensor(lvl.omega, dev),
        chol=_tensor(lvl.chol, dev),
        chol_scale=_tensor(lvl.chol_scale, dev),
        lam=_tensor(lvl.lam, dev),
        cparts=None if getattr(lvl, "cparts", None) is None else class_parts_from_jax(lvl.cparts, dev),
    )


def df_pair_from_jax(pair, device=None) -> torch.Tensor:
    """A JAX-package df operator pair (``hi``, ``lo``: flat [36K, Npad]
    f32) as the port's f64 operator [36, K, Npad] = fl64(hi) + fl64(lo).
    A tile-major (4-D) Pallas layout is a TPU artefact and is refused."""
    hi, lo = np.asarray(pair.hi), np.asarray(pair.lo)
    if hi.ndim != 2 or lo.shape != hi.shape or hi.shape[0] % 36:
        raise ValueError(f"want a flat [36K, Npad] pair, got {hi.shape} / {lo.shape} "
                         "(tile-major (TPU Pallas) layout: untile it first)")
    v = hi.astype(np.float64) + lo.astype(np.float64)
    return torch.from_numpy(v.reshape(36, hi.shape[0] // 36, hi.shape[1])).to(resolve_device(device))


def levels_from_jax(levels: Iterable, device=None) -> List[_Level]:
    """A whole JAX-package level stack (finest first)."""
    return [level_from_jax(lvl, device=device) for lvl in levels]


def exact_stencil_from_jax(st) -> ExactStencil:
    """A JAX-package ``ExactStencil`` (triple-f32 row-class tables) as the
    port's."""
    return ExactStencil(
        offsets=tuple(int(o) for o in st.offsets),
        offs2d=tuple((int(dy), int(dx)) for dy, dx in st.offs2d),
        t0=np.array(np.asarray(st.t0), np.float32),
        t1=np.array(np.asarray(st.t1), np.float32),
        t2=np.array(np.asarray(st.t2), np.float32),
        cy_idx=np.array(np.asarray(st.cy_idx), np.int32),
        cx_idx=np.array(np.asarray(st.cx_idx), np.int32),
        nyp=int(st.nyp),
        nxp=int(st.nxp),
    )


def class_parts_from_jax(cp, device=None) -> ClassParts:
    """A JAX-package ``ClassParts`` as the port's: the f32 hi and e tables
    as they are, the f64 operator as fl64(hi + lo) of its (hi, lo)
    tables."""
    def a(v):
        return np.asarray(v, np.float32)

    bands = [(a(h), a(l), a(e)) for h, l, e in (
        (cp.bt_h, cp.bt_l, cp.bt_e), (cp.bb_h, cp.bb_l, cp.bb_e),
        (cp.bl_h, cp.bl_l, cp.bl_e), (cp.br_h, cp.br_l, cp.br_e))]
    return class_parts_of(a(cp.ih), a(cp.il), a(cp.i2), bands, cp.offs2d, cp.nyp, cp.nxp,
                          cp.npad, resolve_device(device))


def amg_from_jax(amg, device=None) -> List[_DeviceLevel]:
    """A JAX-package ``AMGShellSystem``'s host levels and transfers as the
    port's device levels (``amg.device_levels``) in the JAX system's dtype:
    the same blocks, P and coarsest factor, the damping from the same
    seeded power iteration."""
    h_levels = [_HostLevel(np.array(l.adj, np.int64), np.array(l.blocks, np.float64), int(l.n))
                for l in amg.h_levels]  # owned, writable copies
    transfers = [(np.array(pcol, np.int64), np.array(pblk, np.float64), int(nc))
                 for pcol, pblk, nc in amg.transfers]
    dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[np.dtype(amg.dtype)]
    return device_levels(h_levels, transfers, dtype, resolve_device(device))

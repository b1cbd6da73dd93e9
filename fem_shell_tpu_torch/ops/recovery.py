"""Stress/strain recovery and von Mises fields.

Post-processing from the displacement solution: per-element membrane
strains/stresses, bending moments/curvatures, surface stresses and von
Mises — quantities the thesis derives from the same B-matrices used in
assembly (reference doc/shellelements.tex; the reference executable
itself only writes displacements, fem-shell.cpp:1240-1251 — recovery is
an extension the validation study performed offline).

Evaluation point: the element center (centroid l1=l2=1/3 for Specht
triangles, xi=eta=0 for DKQ quads) — the optimal (superconvergent)
stress point for these low-order elements.

Conventions:
- membrane stress sigma_m = Dm @ eps           [force/area]
- bending moments    M    = Dp @ kappa         [force]
- surface bending stress  sigma_b = 6 M / t^2  (z = +-t/2)
- von Mises on each surface from sigma_m +- sigma_b; `vm` is the
  pointwise max of the two surfaces.

Port of ``fem_shell_tpu/ops/recovery.py``. Where the JAX package vmaps a
single-element function, each family here is batched over elements in
PyTorch on the frames and B-matrices of ``ops/elements.py`` (the
assembly's own, so recovered fields are consistent with the assembled
operator), in chunks of ``CHUNK`` elements so no [E, ...] temporary grows
with the mesh. ``recover_stresses`` and ``recover_stresses_nodal`` run on
``device`` (CUDA unless the caller names another) and return host numpy
fields. The nodal average sums each node's corner values in the JAX
package's order (element by element, tri before quad) through a
node-to-corner table, one gather and add per pass, so it is the same on
every device and two calls agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import XDA_TRI3
from fem_shell_tpu_torch.ops.assemble import corner_table, sum_by_table
from fem_shell_tpu_torch.ops.elements import (
    _GAUSS_ROOT,
    _QUAD_QPS,
    _TRI_QPS,
    _dkq_coeffs,
    _dkq_jacobian_inv,
    _eval_b_quad,
    _eval_b_tri,
    _quad_frame,
    _quad_membrane_b,
    _tri_curvature_map,
    _tri_frame,
    _tri_membrane_b,
)

# elements per batch of the recovery math (~0.1 GB of f64 temporaries for
# Tri-3 at this size)
CHUNK = 1 << 17


@dataclasses.dataclass
class StressField:
    """Per-element center recovery (concatenated tri-then-quad order).

    sigma_m [E,3]  membrane stress (sx, sy, txy), local frame
    moments [E,3]  bending moments (Mx, My, Mxy)
    vm_top/vm_bot [E]  surface von Mises
    vm [E]         max(vm_top, vm_bot)
    """

    sigma_m: np.ndarray
    moments: np.ndarray
    vm_top: np.ndarray
    vm_bot: np.ndarray

    @property
    def vm(self) -> np.ndarray:
        return np.maximum(self.vm_top, self.vm_bot)


def _von_mises(sig):
    sx, sy, txy = sig[..., 0], sig[..., 1], sig[..., 2]
    return torch.sqrt(torch.clamp(sx * sx - sx * sy + sy * sy + 3.0 * txy * txy, min=0.0))


def _apply(mat, vec):
    """mat [3,3] or [E,3,n] applied to vec [E,n] -> [E,3]."""
    return (mat @ vec[..., None])[..., 0]


def _local_dofs(trafo, u_elem):
    """Rotate nodal dofs into the element frame. u_elem [E, m, 6] ->
    (membrane [E, 2m] interleaved (u_i, v_i), plate [E, 3m] (w_i, tx_i,
    ty_i))."""
    e = u_elem.shape[0]
    disp = u_elem[:, :, :3] @ trafo.transpose(1, 2)  # rows = local (u, v, w)
    rot = u_elem[:, :, 3:] @ trafo.transpose(1, 2)  # local (tx, ty, tz)
    mem = torch.stack([disp[..., 0], disp[..., 1]], dim=-1).reshape(e, -1)
    plate = torch.stack([disp[..., 2], rot[..., 0], rot[..., 1]], dim=-1).reshape(e, -1)
    return mem, plate


def _tri_recover(xyz, u_elem, dm, dp, points):
    """Tri-3 recovery at area coordinates ``points`` ((l1, l2), ...):
    (sigma_m [E,Q,3], moments [E,Q,3]). The CST membrane strain is
    constant; it is replicated per point."""
    trafo, dphi, area = _tri_frame(xyz)
    mem, plate = _local_dofs(trafo, u_elem)
    sigma = _apply(dm, _apply(_tri_membrane_b(dphi, area), mem))
    side_sq = (dphi**2).sum(dim=-1)
    y = _tri_curvature_map(dphi, area)
    moments = torch.stack(
        [_apply(dp, _apply(y @ _eval_b_tri(side_sq, l1, l2, dphi), plate)) for l1, l2 in points], dim=1)
    return sigma[:, None, :].expand(-1, len(points), -1), moments


def _quad_recover(xyz, u_elem, dm, dp, points):
    """Quad-4 recovery at (r, s) ``points``: (sigma_m [E,Q,3], moments
    [E,Q,3]), the membrane from the bilinear B, the plate from the DKQ B."""
    trafo, local_xy, dphi = _quad_frame(xyz)
    mem, plate = _local_dofs(trafo, u_elem)
    h = _dkq_coeffs(dphi)
    sig, mom = [], []
    for r, s in points:
        b_m, _ = _quad_membrane_b(local_xy, r, s)
        sig.append(_apply(dm, _apply(b_m, mem)))
        jinv, _ = _dkq_jacobian_inv(dphi, r, s)
        mom.append(_apply(dp, _apply(_eval_b_quad(h, r, s, jinv), plate)))
    return torch.stack(sig, dim=1), torch.stack(mom, dim=1)


_CENTER = {3: ((1.0 / 3.0, 1.0 / 3.0),), 4: ((0.0, 0.0),)}
# the assembly's quadrature points: Specht interior points, 2x2 Gauss in
# _QUAD_QPS order
_QPS = {3: _TRI_QPS, 4: tuple((r * _GAUSS_ROOT, s * _GAUSS_ROOT) for r, s in _QUAD_QPS)}


def _families(mesh, material: Material, u, dtype, device, points):
    """Per family present, in tri-then-quad order: (conn [E, m] numpy,
    sigma_m [E,Q,3], moments [E,Q,3]) at ``points[m]``, on ``device``."""
    dev = resolve_device(device)
    dm, dp = (torch.as_tensor(a, dtype=dtype, device=dev) for a in material.matrices())
    coords = torch.as_tensor(mesh.coords, dtype=dtype).to(dev)
    u = torch.as_tensor(u, dtype=dtype).to(dev)
    out = []
    for conn, fn in ((mesh.tri, _tri_recover), (mesh.quad, _quad_recover)):
        if len(conn) == 0:
            continue
        m = conn.shape[1]
        c = torch.as_tensor(np.asarray(conn, np.int64), device=dev)
        parts = [fn(coords[c[i : i + CHUNK]], u[c[i : i + CHUNK]], dm, dp, points[m])
                 for i in range(0, len(conn), CHUNK)]
        out.append((conn, torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])))
    return out


def recover_stresses(mesh, material: Material, u, dtype=torch.float64, device=None) -> StressField:
    """Element-center stress recovery for the whole mesh.

    ``u`` [N, 6] nodal displacements (global frame; numpy or a tensor).
    Elements are reported tri-first then quad, matching ``mesh.tri`` /
    ``mesh.quad`` row order."""
    fams = _families(mesh, material, u, dtype, device, _CENTER)
    sigma_m = torch.cat([f[1][:, 0] for f in fams])
    moments = torch.cat([f[2][:, 0] for f in fams])
    t = material.thickness
    sigma_b = 6.0 * moments / (t * t)
    return StressField(
        sigma_m=sigma_m.cpu().numpy(),
        moments=moments.cpu().numpy(),
        vm_top=_von_mises(sigma_m + sigma_b).cpu().numpy(),
        vm_bot=_von_mises(sigma_m - sigma_b).cpu().numpy(),
    )


# ----------------------------------------------------------------------
# Gauss-point recovery + extrapolated nodal fields
# ----------------------------------------------------------------------
# The assembly quadrature points (ops/elements.py: _TRI_QPS interior
# points for Specht, 2x2 Gauss for DKQ/membrane) are the element's
# optimal sampling points; nodal fields are recovered by evaluating
# stress there and extrapolating the qp values to the element corners
# with the inverse of the (bi)linear map qp -> corners, then averaging
# contributions across elements sharing each node (the classical
# Hinton-Campbell local projection; the reference validation study
# performed the same projection offline, doc/validation.tex).

_TRI_QPS_R = np.array(_TRI_QPS)
# corners in (l1, l2): node1 = (1,0), node2 = (0,1), node3 = (0,0)
_TRI_CORNERS_R = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
# linear extrapolation: value(l) = [1, l1, l2] @ coeff, coeff from qps
_TRI_EXTRAP = np.hstack([np.ones((3, 1)), _TRI_CORNERS_R]) @ np.linalg.inv(
    np.hstack([np.ones((3, 1)), _TRI_QPS_R])
)

# quad corners (r,s) in connectivity order (see _quad_shape_derivs):
# node1 (-1,-1), node2 (1,-1), node3 (1,1), node4 (-1,1); Gauss points
# at signs _QUAD_QPS = ((+,+),(+,-),(-,+),(-,-)) scaled by 1/sqrt(3).
_QUAD_CORNER_SIGNS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_QUAD_QP_SIGNS = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float64)
_QUAD_EXTRAP = 0.25 * (
    (1.0 + math.sqrt(3.0) * np.outer(_QUAD_CORNER_SIGNS[:, 0], _QUAD_QP_SIGNS[:, 0]))
    * (1.0 + math.sqrt(3.0) * np.outer(_QUAD_CORNER_SIGNS[:, 1], _QUAD_QP_SIGNS[:, 1]))
)
_EXTRAP = {3: _TRI_EXTRAP, 4: _QUAD_EXTRAP}


@dataclasses.dataclass
class NodalStressField:
    """Extrapolated nodal recovery (local element frames averaged per
    node — exact for coplanar meshes, the usual caveat for folded
    shells).

    sigma_m [N,3]  membrane stress, moments [N,3] bending moments,
    vm_top/vm_bot/vm [N]  surface von Mises from the nodal components.
    """

    sigma_m: np.ndarray
    moments: np.ndarray
    vm_top: np.ndarray
    vm_bot: np.ndarray

    @property
    def vm(self) -> np.ndarray:
        return np.maximum(self.vm_top, self.vm_bot)


def recover_stresses_nodal(mesh, material: Material, u, dtype=torch.float64,
                           device=None) -> NodalStressField:
    """Gauss-point stress recovery extrapolated to nodes.

    Evaluates membrane stress and bending moments at each element's
    assembly quadrature points, extrapolates them to the element's
    corner nodes ((bi)linear inverse map), and averages over all
    elements sharing the node. Superconvergent-sampling projection: one
    order more accurate at nodes than evaluating the element fields
    there directly."""
    fams = _families(mesh, material, u, dtype, device, _QPS)
    vals, idx = [], []
    for conn, sig_qp, mom_qp in fams:
        ex = torch.as_tensor(_EXTRAP[conn.shape[1]], dtype=dtype, device=sig_qp.device)
        sig_n = torch.einsum("cq,eqk->eck", ex, sig_qp)  # [E,corners,3]
        mom_n = torch.einsum("cq,eqk->eck", ex, mom_qp)
        vals.append(torch.cat([sig_n, mom_n], dim=-1).reshape(-1, 6))
        idx.append(np.asarray(conn).ravel())
    rows = torch.cat(vals + [vals[0].new_zeros((1, 6))])
    table = torch.as_tensor(corner_table(np.concatenate(idx), mesh.n_nodes), device=rows.device)
    acc = sum_by_table(rows, table)
    cnt = (table < rows.shape[0] - 1).sum(dim=0).to(dtype)
    acc = acc / torch.clamp(cnt, min=1.0)[:, None]
    sigma_m, moments = acc[:, :3], acc[:, 3:]
    t = material.thickness
    sigma_b = 6.0 * moments / (t * t)
    return NodalStressField(
        sigma_m=sigma_m.cpu().numpy(),
        moments=moments.cpu().numpy(),
        vm_top=_von_mises(sigma_m + sigma_b).cpu().numpy(),
        vm_bot=_von_mises(sigma_m - sigma_b).cpu().numpy(),
    )


def nodal_average(mesh, elem_field: np.ndarray) -> np.ndarray:
    """Average a per-element field to nodes (tri-then-quad element
    order), for point-data export. Host numpy, as in the JAX package."""
    acc = np.zeros(mesh.n_nodes, np.float64)
    cnt = np.zeros(mesh.n_nodes, np.float64)
    e0 = 0
    for conn in (mesh.tri, mesh.quad):
        if len(conn) == 0:
            continue
        vals = np.asarray(elem_field[e0 : e0 + len(conn)], np.float64)
        np.add.at(acc, np.asarray(conn).ravel(), np.repeat(vals, conn.shape[1]))
        np.add.at(cnt, np.asarray(conn).ravel(), 1.0)
        e0 += len(conn)
    return acc / np.maximum(cnt, 1.0)


def to_mesh_order(mesh, elem_field: np.ndarray) -> np.ndarray:
    """Reorder a tri-then-quad per-element field into the mesh's element
    order (what VTU cell data expects)."""
    elem_field = np.asarray(elem_field)
    out = np.empty((mesh.n_elems,) + elem_field.shape[1:], dtype=elem_field.dtype)
    tri_idx = np.where(mesh.elem_types == XDA_TRI3)[0]
    quad_idx = np.where(mesh.elem_types != XDA_TRI3)[0]
    out[tri_idx] = elem_field[: len(tri_idx)]
    out[quad_idx] = elem_field[len(tri_idx) :]
    return out

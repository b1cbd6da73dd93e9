"""Flat-shell element stiffness (Tri-3 and Quad-4) in plain PyTorch,
batched over elements: the benchmark's frozen copy of the element math.

Each element is a membrane element plus a plate bending element plus a
stabilized drilling dof, formed in a local frame and congruence-
transformed to global axes, as the reference program fem-shell forms it:

- local frame + edge-difference table: fem-shell.cpp:306-433 (initElement)
- Tri-3 membrane (CST):               fem-shell.cpp:445-468 (calcPlane)
- Quad-4 membrane (bilinear, 2x2 GQ): fem-shell.cpp:469-541
- Tri-3 plate (Specht 1988 basis):    fem-shell.cpp:555-603, 698-891
- Quad-4 plate (DKQ, Batoz 1982):     fem-shell.cpp:604-688, 901-990
- superposition + drilling DOF:       fem-shell.cpp:999-1053
- local->global congruence:           fem-shell.cpp:1061-1102

Every per-element scalar is a tensor ``[E]`` and every small matrix
``[E, r, c]``; the element dof layout is node-major ([u, v, w, tx, ty, tz]
per node). The reference's quirk in the Specht auxiliary matrix, Y(2, 1)
from x31 * x31 (fem-shell.cpp:586), is kept: the golden values depend on
it. The quadrature point order is the reference's: (+,+), (+,-), (-,+),
(-,-).

This file imports nothing but torch: the benchmark's comparison holds the
program to it, so it may not come from the program.
"""
from __future__ import annotations

import math

import torch

# 2x2 Gauss points at +-sqrt(1/3), w = 1; the literal matches the C++
# `sqrt(1.0/3.0)` (fem-shell.cpp:472) bit-for-bit.
_GAUSS_ROOT = math.sqrt(1.0 / 3.0)
_QUAD_QPS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))
# Specht plate interior points, weight 1/6 (fem-shell.cpp:557-562)
_TRI_QPS = ((1.0 / 6.0, 1.0 / 6.0), (2.0 / 3.0, 1.0 / 6.0), (1.0 / 6.0, 2.0 / 3.0))


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _cross(u, v):
    return torch.linalg.cross(u, v, dim=-1)


def _btdb(b, d):
    """b^T d b for b [E, 3, m] and d [3, 3] -> [E, m, m]."""
    return b.transpose(1, 2) @ (d @ b)


# ----------------------------------------------------------------------
# Local frames (initElement)
# ----------------------------------------------------------------------


def _tri_frame(xyz):
    """(trafo [E,3,3], dphi [E,3,2], area [E]) for TRI3 node coords
    [E,3,3]. dphi rows hold the local edge differences
    ((x12,y12),(x31,y31),(x23,y23)); fem-shell.cpp:403-411."""
    a, b, c = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    u_vec = b - a
    v_vec = c - a
    w_vec = _cross(u_vec, v_vec)
    area = 0.5 * _norm(w_vec)
    e_x = u_vec / _norm(u_vec)[:, None]
    e_z = w_vec / _norm(w_vec)[:, None]
    e_y = _cross(e_z, e_x)
    trafo = torch.stack([e_x, e_y, e_z], dim=1)  # rows are local axes
    lb = (trafo @ u_vec[:, :, None])[:, :, 0]  # local coords of node B
    lc = (trafo @ v_vec[:, :, None])[:, :, 0]  # local coords of node C
    dphi = torch.stack(
        [
            torch.stack([-lb[:, 0], -lb[:, 1]], dim=-1),  # x12, y12
            torch.stack([lc[:, 0], lc[:, 1]], dim=-1),  # x31, y31
            torch.stack([lb[:, 0] - lc[:, 0], lb[:, 1] - lc[:, 1]], dim=-1),  # x23, y23
        ],
        dim=1,
    )
    return trafo, dphi, area


def _quad_frame(xyz):
    """(trafo [E,3,3], local_xy [E,2,4], dphi [E,4,2]) for QUAD4 node
    coords [E,4,3]; fem-shell.cpp:342-432."""
    a, b, c, d = xyz[:, 0], xyz[:, 1], xyz[:, 2], xyz[:, 3]
    mid_ab = a + 0.5 * (b - a)
    mid_bc = b + 0.5 * (c - b)
    mid_cd = c + 0.5 * (d - c)
    mid_da = d + 0.5 * (a - d)
    e_x = mid_bc - mid_da
    e_x = e_x / _norm(e_x)[:, None]
    v_r = mid_cd - mid_ab
    e_z = _cross(e_x, v_r)
    e_z = e_z / _norm(e_z)[:, None]
    e_y = _cross(e_z, e_x)
    trafo = torch.stack([e_x, e_y, e_z], dim=1)
    local = trafo @ xyz.transpose(1, 2)  # [E,3,4]
    lx, ly = local[:, 0], local[:, 1]
    dphi = torch.stack(
        [
            torch.stack([lx[:, i] - lx[:, j], ly[:, i] - ly[:, j]], dim=-1)
            for i, j in ((0, 1), (1, 2), (2, 3), (3, 0))  # x12, x23, x34, x41
        ],
        dim=1,
    )
    return trafo, local[:, :2], dphi


# ----------------------------------------------------------------------
# Membrane kernels (calcPlane)
# ----------------------------------------------------------------------


def _tri_membrane_b(dphi, area):
    """CST strain matrix B [E,3,6] over (u1,v1,u2,v2,u3,v3); fem-shell.cpp:445-468."""
    x12, y12 = dphi[:, 0, 0], dphi[:, 0, 1]
    x31, y31 = dphi[:, 1, 0], dphi[:, 1, 1]
    x23, y23 = dphi[:, 2, 0], dphi[:, 2, 1]
    z = torch.zeros_like(x12)
    return torch.stack(
        [
            torch.stack([y23, z, y31, z, y12, z], dim=-1),
            torch.stack([z, -x23, z, -x31, z, -x12], dim=-1),
            torch.stack([-x23, y23, -x31, y31, -x12, y12], dim=-1),
        ],
        dim=1,
    ) / (2.0 * area)[:, None, None]


def _tri_membrane(dphi, area, dm, thickness):
    """CST membrane [E,6,6] over (u1,v1,u2,v2,u3,v3); fem-shell.cpp:445-468."""
    return (thickness * area)[:, None, None] * _btdb(_tri_membrane_b(dphi, area), dm)


def _quad_shape_derivs(r: float, s: float):
    """Bilinear shape-function derivatives wrt (r, s) at one point, as
    4-tuples of floats; fem-shell.cpp:494-502."""
    dhdr = (-0.25 * (1 - s), 0.25 * (1 - s), 0.25 * (1 + s), -0.25 * (1 + s))
    dhds = (-0.25 * (1 - r), -0.25 * (1 + r), 0.25 * (1 + r), 0.25 * (1 - r))
    return dhdr, dhds


def _quad_membrane_b(local_xy, r: float, s: float):
    """Bilinear isoparametric strain matrix B [E,3,8] (interleaved (u_i,
    v_i)) and Jacobian determinant [E] at (r, s); fem-shell.cpp:469-541."""
    lx, ly = local_xy[:, 0], local_xy[:, 1]
    dtype, device = local_xy.dtype, local_xy.device
    dhdr, dhds = (torch.tensor(d, dtype=dtype, device=device) for d in _quad_shape_derivs(r, s))
    j00 = lx @ dhdr
    j01 = ly @ dhdr
    j10 = lx @ dhds
    j11 = ly @ dhds
    det = j00 * j11 - j01 * j10
    z = torch.zeros_like(det)
    b3x4 = torch.stack(
        [
            torch.stack([j11, -j01, z, z], dim=-1),
            torch.stack([z, z, -j10, j00], dim=-1),
            torch.stack([-j10, j00, j11, -j01], dim=-1),
        ],
        dim=1,
    ) / det[:, None, None]
    g = torch.zeros((4, 8), dtype=dtype, device=device)
    g[0, 0::2] = dhdr
    g[1, 0::2] = dhds
    g[2, 1::2] = dhdr
    g[3, 1::2] = dhds
    return b3x4 @ g, det


def _quad_membrane(local_xy, dm, thickness):
    """Bilinear isoparametric membrane [E,8,8], interleaved (u_i, v_i);
    2x2 Gauss loop of fem-shell.cpp:469-541."""
    out = None
    for r0, s0 in _QUAD_QPS:
        b_m, det = _quad_membrane_b(local_xy, r0 * _GAUSS_ROOT, s0 * _GAUSS_ROOT)
        term = (det * thickness)[:, None, None] * _btdb(b_m, dm)
        out = term if out is None else out + term
    return out


# ----------------------------------------------------------------------
# Tri-3 plate kernel (Specht element; calcPlate TRI3 branch + evalBTri)
# ----------------------------------------------------------------------


def _eval_b_tri(side_sq, l1, l2, dphi):
    """Second-derivative strain matrix B [E,3,9] of the 9-dof Specht
    triangle at area coordinates (l1, l2); fem-shell.cpp:698-891."""
    mu1 = (side_sq[:, 0] - side_sq[:, 1]) / side_sq[:, 2]
    mu2 = (side_sq[:, 2] - side_sq[:, 0]) / side_sq[:, 1]
    mu3 = (side_sq[:, 1] - side_sq[:, 2]) / side_sq[:, 0]

    l3 = 1.0 - l1 - l2
    f13mu1 = 1 + 3 * mu1
    f13mu2 = 1 + 3 * mu2
    f13mu3 = 1 + 3 * mu3
    f1m3mu3 = 1 - 3 * mu3
    fm13mu2 = -1 + 3 * mu2
    fm1m3mu3 = -1 - 3 * mu3
    f1mmu1 = 1 - mu1
    f1mmu2 = 1 - mu2
    f1mmu3 = 1 - mu3

    a = 3 * f1mmu3 * l1 - f13mu3 * l2 + f13mu3 * l3
    b = 3 * f1mmu2 * l3 - f13mu2 * l1 + f13mu2 * l2
    c = 3 * f1mmu1 * l2 - f13mu1 * l3 + f13mu1 * l1

    d00, d01 = dphi[:, 0, 0], dphi[:, 0, 1]  # x12, y12
    d10, d11 = dphi[:, 1, 0], dphi[:, 1, 1]  # x31, y31
    d20, d21 = dphi[:, 2, 0], dphi[:, 2, 1]  # x23, y23

    # row 0: d2/dL1^2 terms
    r0c0 = 6 + l2 * (-4 - 2 * a) + 4 * f1m3mu3 * (l2 * l3 - l1 * l2) - 12 * l1 \
        + 2 * l2 * b + 8 * (l2 * l3 - l1 * l2)
    t_b = -2 + 6 * l1 + 4 * l2 - l2 * b - 4 * l2 * l3 + 4 * l1 * l2
    t_a = 2 * l2 - l2 * a + l2 * l3 * 2 * f1m3mu3 - l1 * l2 * 2 * f1m3mu3
    r0c1 = -d11 * t_b - d01 * t_a
    r0c2 = d10 * t_b + d00 * t_a
    r0c3 = -2 * l2 * c + 4 * f13mu1 * (l2 * l3 - l1 * l2) - 4 * l2 + 2 * l2 * a \
        + 4 * f1m3mu3 * (-l2 * l3 + l1 * l2)
    t_c = -l2 * c + l2 * l3 * 2 * f13mu1 - l1 * l2 * 2 * f13mu1
    r0c4 = -d01 * t_a - d21 * t_c
    r0c5 = d00 * t_a + d20 * t_c
    r0c6 = -6 + 12 * l1 + 8 * l2 - 2 * l2 * b + 8 * (l1 * l2 - l2 * l3) \
        + 2 * l2 * c + 4 * f13mu1 * (l1 * l2 - l2 * l3)
    t_b4 = -4 + 6 * l1 + 4 * l2 - l2 * b - 4 * l2 * l3 + 4 * l1 * l2
    r0c7 = -d21 * t_c - d11 * t_b4
    r0c8 = d20 * t_c + d10 * t_b4

    # row 1: d2/dL2^2 terms
    r1c0 = -2 * l1 * a + 2 * l1 * l3 * 2 * fm1m3mu3 - 2 * l1 * l2 * 2 * fm1m3mu3 \
        - 4 * l1 + 2 * l1 * b - 2 * l1 * l3 * 2 * fm13mu2 + 2 * l1 * l2 * 2 * fm13mu2
    s_b = 2 * l1 - l1 * b + l1 * l3 * 2 * fm13mu2 - l1 * l2 * 2 * fm13mu2
    s_a = -l1 * a + l1 * l3 * 2 * fm1m3mu3 - l1 * l2 * 2 * fm1m3mu3
    r1c1 = -d11 * s_b - d01 * s_a
    r1c2 = d10 * s_b + d00 * s_a
    r1c3 = 6 - 12 * l2 - 4 * l1 - 2 * l1 * c + 8 * l3 * l1 - 8 * l1 * l2 \
        + 2 * l1 * a - 2 * l1 * l3 * 2 * fm1m3mu3 + 2 * l1 * l2 * 2 * fm1m3mu3
    s_c2 = -6 * l2 + 2 - 2 * l1 - l1 * c + 4 * l3 * l1 - 4 * l1 * l2
    r1c4 = -d01 * s_a - d21 * s_c2
    r1c5 = d00 * s_a + d20 * s_c2
    r1c6 = -6 + 8 * l1 - 2 * l1 * b + 2 * l1 * l3 * 2 * fm13mu2 \
        - 2 * l1 * l2 * 2 * fm13mu2 + 12 * l2 + 2 * l1 * c - 8 * l3 * l1 + 8 * l1 * l2
    s_c4 = -6 * l2 + 4 - 2 * l1 - l1 * c + 4 * l3 * l1 - 4 * l1 * l2
    r1c7 = -d21 * s_c4 - d11 * s_b
    r1c8 = d20 * s_c4 + d10 * s_b

    # row 2: mixed d2/dL1dL2 terms (doubled at the end, fem-shell.cpp:888-890)
    r2c0 = 2 - 4 * l1 + l3 * a - l2 * a + l2 * l3 * 2 * fm1m3mu3 - l1 * a \
        - l1 * l2 * 2 * fm1m3mu3 + l1 * l3 * 2 * f1m3mu3 - l1 * l2 * 2 * f1m3mu3 \
        - 4 * l2 - l3 * b + l2 * b - l2 * l3 * 2 * fm13mu2 + l1 * b \
        + l1 * l2 * 2 * fm13mu2 + 4 * l3 * l1 - 4 * l1 * l2
    m_b = -1 + 4 * l1 + 2 * l2 + 0.5 * l3 * b - 0.5 * l2 * b \
        + 0.5 * l2 * l3 * 2 * fm13mu2 - 0.5 * l1 * b - 0.5 * l1 * l2 * 2 * fm13mu2 \
        - 2 * l3 * l1 + 2 * l1 * l2
    m_a = 2 * l1 + 0.5 * l3 * a - 0.5 * l2 * a + 0.5 * l2 * l3 * 2 * fm1m3mu3 \
        - 0.5 * l1 * a - 0.5 * l1 * l2 * 2 * fm1m3mu3 + 0.5 * l1 * l3 * 2 * f1m3mu3 \
        - 0.5 * l1 * l2 * 2 * f1m3mu3
    r2c1 = -d11 * m_b - d01 * m_a
    r2c2 = d10 * m_b + d00 * m_a
    r2c3 = 2 - 4 * l2 + l3 * c - l2 * c + 4 * l2 * l3 - l1 * c - 4 * l1 * l2 \
        + l1 * l3 * 2 * f13mu1 - l1 * l2 * 2 * f13mu1 - 4 * l1 - l3 * a + l2 * a \
        + l1 * a - l2 * l3 * 2 * fm1m3mu3 + l1 * l2 * 2 * fm1m3mu3 \
        - l1 * l3 * 2 * f1m3mu3 + l1 * l2 * 2 * f1m3mu3
    m_c = -2 * l2 + 0.5 * l3 * c - 0.5 * l2 * c + 2 * l2 * l3 - 0.5 * l1 * c \
        - 2 * l1 * l2 + 0.5 * l1 * l3 * 2 * f13mu1 - 0.5 * l1 * l2 * 2 * f13mu1
    r2c4 = -d01 * (m_a - 1) - d21 * m_c
    r2c5 = d00 * (m_a - 1) + d20 * m_c
    r2c6 = -4 + 8 * l1 + 8 * l2 + l3 * b - l2 * b + l2 * l3 * 2 * fm13mu2 \
        - l1 * b - l1 * l2 * 2 * fm13mu2 - 4 * l3 * l1 + 8 * l1 * l2 - l3 * c \
        + l2 * c - 4 * l2 * l3 + l1 * c - l1 * l3 * 2 * f13mu1 + l1 * l2 * 2 * f13mu1
    m_b2 = -2 + 4 * l1 + 2 * l2 + 0.5 * l3 * b - 0.5 * l2 * b \
        + 0.5 * l2 * l3 * 2 * fm13mu2 - 0.5 * l1 * b - 0.5 * l1 * l2 * 2 * fm13mu2 \
        - 2 * l3 * l1 + 2 * l1 * l2
    r2c7 = -d21 * (m_c + 1) - d11 * m_b2
    r2c8 = d20 * (m_c + 1) + d10 * m_b2

    row0 = torch.stack([r0c0, r0c1, r0c2, r0c3, r0c4, r0c5, r0c6, r0c7, r0c8], dim=-1)
    row1 = torch.stack([r1c0, r1c1, r1c2, r1c3, r1c4, r1c5, r1c6, r1c7, r1c8], dim=-1)
    row2 = 2.0 * torch.stack([r2c0, r2c1, r2c2, r2c3, r2c4, r2c5, r2c6, r2c7, r2c8], dim=-1)
    return torch.stack([row0, row1, row2], dim=1)


def _tri_curvature_map(dphi, area):
    """The Specht auxiliary matrix Y [E,3,3] mapping area-coordinate second
    derivatives to physical curvatures. NOTE: Y[2,1] matches the reference
    literally (fem-shell.cpp:586 uses dphi(1,0)*dphi(1,0))."""
    x31, y31 = dphi[:, 1, 0], dphi[:, 1, 1]
    x23, y23 = dphi[:, 2, 0], dphi[:, 2, 1]
    return torch.stack(
        [
            torch.stack([y23**2, y31**2, y23 * y31], dim=-1),
            torch.stack([x23**2, x31**2, x31 * x23], dim=-1),
            torch.stack(
                [-2.0 * x23 * y23, -2.0 * x31 * x31, -x23 * y31 - x31 * y23], dim=-1
            ),
        ],
        dim=1,
    ) / (4.0 * area**2)[:, None, None]


def _tri_plate(dphi, area, dp):
    """Specht plate bending [E,9,9] over (w_i, tx_i, ty_i); fem-shell.cpp:555-603."""
    side_sq = (dphi**2).sum(dim=-1)  # AB, AC, BC
    y = _tri_curvature_map(dphi, area)
    ke = None
    for l1, l2 in _TRI_QPS:
        yb = y @ _eval_b_tri(side_sq, l1, l2, dphi)
        term = (1.0 / 6.0) * _btdb(yb, dp)
        ke = term if ke is None else ke + term
    return (2.0 * area)[:, None, None] * ke


# ----------------------------------------------------------------------
# Quad-4 plate kernel (DKQ; calcPlate QUAD4 branch + evalBQuad)
# ----------------------------------------------------------------------


def _eval_b_quad(h, xi, eta, jinv):
    """DKQ strain matrix B [E,3,12] at (xi, eta); fem-shell.cpp:901-990.
    ``h`` is the [E,5,4] coefficient table [a,b,c,d,e] x sides (5,6,7,8)."""
    n_xi = [
        0.25 * (2 * xi + eta) * (1 - eta),
        0.25 * (2 * xi - eta) * (1 - eta),
        0.25 * (2 * xi + eta) * (1 + eta),
        0.25 * (2 * xi - eta) * (1 + eta),
        -xi * (1 - eta),
        0.5 * (1 - eta**2),
        -xi * (1 + eta),
        -0.5 * (1 - eta**2),
    ]
    n_eta = [
        0.25 * (2 * eta + xi) * (1 - xi),
        0.25 * (2 * eta - xi) * (1 + xi),
        0.25 * (2 * eta + xi) * (1 + xi),
        0.25 * (2 * eta - xi) * (1 - xi),
        -0.5 * (1 - xi**2),
        -eta * (1 + xi),
        0.5 * (1 - xi**2),
        -eta * (1 - xi),
    ]
    a, b, c, d, e = 0, 1, 2, 3, 4

    def h_vectors(n):
        """Hx and Hy [E,12] for one derivative direction (n = N_xi|N_eta)."""
        hx, hy = [], []
        for i in range(4):
            m = 4 + i  # mid-side node on side i (5,6,7,8 in Batoz numbering)
            p = 4 + ((i + 3) % 4)  # preceding mid-side node (8,5,6,7)
            im, ip = i, (i + 3) % 4
            hx.append(1.5 * (h[:, a, im] * n[m] - h[:, a, ip] * n[p]))
            hx.append(h[:, b, im] * n[m] + h[:, b, ip] * n[p])
            hx.append(n[i] - h[:, c, im] * n[m] - h[:, c, ip] * n[p])
            hy.append(1.5 * (h[:, d, im] * n[m] - h[:, d, ip] * n[p]))
            hy.append(-n[i] + h[:, e, im] * n[m] + h[:, e, ip] * n[p])
            hy.append(-(h[:, b, im] * n[m] + h[:, b, ip] * n[p]))
        return torch.stack(hx, dim=-1), torch.stack(hy, dim=-1)

    hx_xi, hy_xi = h_vectors(n_xi)
    hx_eta, hy_eta = h_vectors(n_eta)
    j00, j01 = jinv[:, 0, 0, None], jinv[:, 0, 1, None]
    j10, j11 = jinv[:, 1, 0, None], jinv[:, 1, 1, None]
    row0 = j00 * hx_xi + j01 * hx_eta
    row1 = j10 * hy_xi + j11 * hy_eta
    row2 = j00 * hy_xi + j01 * hy_eta + j10 * hx_xi + j11 * hx_eta
    return torch.stack([row0, row1, row2], dim=1)


def _dkq_coeffs(dphi):
    """The DKQ coefficient table h [E,5,4] ([a,b,c,d,e] x sides) from the
    local edge differences; fem-shell.cpp:613-621."""
    side_sq = (dphi**2).sum(dim=-1)  # squared side lengths AB,BC,CD,DA
    dx, dy = dphi[:, :, 0], dphi[:, :, 1]
    return torch.stack(
        [
            -dx / side_sq,  # a_k
            0.75 * dx * dy / side_sq,  # b_k
            (0.25 * dx**2 - 0.5 * dy**2) / side_sq,  # c_k
            -dy / side_sq,  # d_k
            (0.25 * dy**2 - 0.5 * dx**2) / side_sq,  # e_k
        ],
        dim=1,
    )


def _dkq_jacobian_inv(dphi, r: float, s: float):
    """Inverse Jacobian [E,2,2] and determinant [E] of the DKQ
    parametrization at (r, s)."""
    dx, dy = dphi[:, :, 0], dphi[:, :, 1]
    j00 = 0.25 * ((dx[:, 0] + dx[:, 2]) * s - dx[:, 0] + dx[:, 2])
    j01 = 0.25 * ((dy[:, 0] + dy[:, 2]) * s - dy[:, 0] + dy[:, 2])
    j10 = 0.25 * ((dx[:, 0] + dx[:, 2]) * r - dx[:, 1] + dx[:, 3])
    j11 = 0.25 * ((dy[:, 0] + dy[:, 2]) * r - dy[:, 1] + dy[:, 3])
    det = j00 * j11 - j01 * j10
    jinv = torch.stack(
        [torch.stack([j11, -j01], dim=-1), torch.stack([-j10, j00], dim=-1)], dim=1
    ) / det[:, None, None]
    return jinv, det


def _quad_plate(dphi, dp):
    """DKQ plate bending [E,12,12] over (w_i, tx_i, ty_i); fem-shell.cpp:604-688."""
    h = _dkq_coeffs(dphi)
    ke = None
    for r0, s0 in _QUAD_QPS:
        r = r0 * _GAUSS_ROOT
        s = s0 * _GAUSS_ROOT
        jinv, det = _dkq_jacobian_inv(dphi, r, s)
        b = _eval_b_quad(h, r, s, jinv)
        term = det[:, None, None] * _btdb(b, dp)
        ke = term if ke is None else ke + term
    return ke


# ----------------------------------------------------------------------
# Superposition, drilling DOF, and local->global transform
# ----------------------------------------------------------------------


def _superpose(ke_m, ke_p, n_nodes):
    """Interleave membrane/plate blocks into the [E,6n,6n] shell matrix and
    add the stabilized drilling DOF (max submatrix diagonal / 1000);
    fem-shell.cpp:999-1053."""
    n = n_nodes
    e = ke_m.shape[0]
    k = ke_m.new_zeros((e, 6 * n, 6 * n))
    base = 6 * torch.arange(n, device=ke_m.device)
    mem_ids = (base[:, None] + torch.tensor([0, 1], device=ke_m.device)).reshape(-1)
    plate_ids = (base[:, None] + torch.tensor([2, 3, 4], device=ke_m.device)).reshape(-1)
    k[:, mem_ids[:, None], mem_ids[None, :]] = ke_m
    k[:, plate_ids[:, None], plate_ids[None, :]] = ke_p
    # drilling stabilization: per (i,j) node pair, max over the diagonal
    # entries of the 6x6 sub-block's membrane/plate contributions, / 1000
    drill = torch.maximum(ke_m[:, 0::2, 0::2], ke_m[:, 1::2, 1::2])
    drill = torch.maximum(drill, ke_p[:, 0::3, 0::3])
    drill = torch.maximum(drill, ke_p[:, 1::3, 1::3])
    drill = torch.maximum(drill, ke_p[:, 2::3, 2::3])
    drill = drill / 1000.0
    drill_ids = base + 5
    k[:, drill_ids[:, None], drill_ids[None, :]] = drill
    return k


def _to_global(ke, trafo, n_nodes):
    """Blockwise congruence K_global = T6^T K_local T6 per 6x6 node pair,
    with T6 = blockdiag(trafo, trafo); fem-shell.cpp:1061-1102."""
    e = ke.shape[0]
    t6 = ke.new_zeros((e, 6, 6))
    t6[:, :3, :3] = trafo
    t6[:, 3:, 3:] = trafo
    k4 = ke.reshape(e, n_nodes, 6, n_nodes, 6)
    kg = torch.einsum("eca,eicjd->eiajd", t6, k4)
    kg = torch.einsum("eiajd,edb->eiajb", kg, t6)
    return kg.reshape(e, 6 * n_nodes, 6 * n_nodes)


# ----------------------------------------------------------------------
# Public batched kernels
# ----------------------------------------------------------------------


def tri_shell_stiffness(xyz, dm, dp, thickness):
    """Global-axes [E,18,18] stiffness of TRI3 flat shell elements with
    node coordinates ``xyz`` [E,3,3]. DOF order: node-major."""
    trafo, dphi, area = _tri_frame(xyz)
    ke_m = _tri_membrane(dphi, area, dm, thickness)
    ke_p = _tri_plate(dphi, area, dp)
    return _to_global(_superpose(ke_m, ke_p, 3), trafo, 3)


def quad_shell_stiffness(xyz, dm, dp, thickness):
    """Global-axes [E,24,24] stiffness of QUAD4 flat shell elements with
    node coordinates ``xyz`` [E,4,3]."""
    trafo, local_xy, dphi = _quad_frame(xyz)
    ke_m = _quad_membrane(local_xy, dm, thickness)
    ke_p = _quad_plate(dphi, dp)
    return _to_global(_superpose(ke_m, ke_p, 4), trafo, 4)


def batched_tri_stiffness(coords, tri_conn, dm, dp, thickness):
    """[Et,18,18] element stiffnesses; coords [N,3], tri_conn [Et,3] int."""
    return tri_shell_stiffness(coords[tri_conn], dm, dp, thickness)


def batched_quad_stiffness(coords, quad_conn, dm, dp, thickness):
    """[Eq,24,24] element stiffnesses; coords [N,3], quad_conn [Eq,4] int."""
    return quad_shell_stiffness(coords[quad_conn], dm, dp, thickness)

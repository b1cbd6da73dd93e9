"""Flat-shell element stiffness of ONE element in numpy ``np.longdouble``.

The exact-stencil tables (ops/exact_stencil.py) need the element
matrices of a 6x6-node patch in extended precision: plate bending
amplifies correlated operator rounding by the condition number, so the
refinement operator's entries must be better than f64. The JAX package
gets them by re-running its traced f64 kernels through a longdouble
jaxpr interpreter; the port writes the same kernels out in numpy
longdouble instead. Function by function this mirrors
``ops/elements.py`` (same reference lines, the Specht Y[2,1] quirk, the
quadrature order), for one element at a time: only the <= 50 elements
of the patch ever come through here, so clarity beats speed.

Every literal is the f64 value the f64 kernels use (e.g. 1/6 and
sqrt(1/3) rounded to f64), converted to longdouble, as the interpreter
converts the traced constants; all arithmetic on them is longdouble.
``np.longdouble`` is the 80-bit x87 format on x86-64 (eps 2^-63) and
IEEE quad on aarch64, which is only more precise.
"""
from __future__ import annotations

import math

import numpy as np

LD = np.longdouble

_GAUSS_ROOT = LD(math.sqrt(1.0 / 3.0))  # the f64 literal, fem-shell.cpp:472
_QUAD_QPS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))
_TRI_QPS = ((1.0 / 6.0, 1.0 / 6.0), (2.0 / 3.0, 1.0 / 6.0), (1.0 / 6.0, 2.0 / 3.0))
_SIXTH = LD(1.0 / 6.0)


def _norm(v):
    return np.sqrt(np.sum(v * v))


def _cross(u, v):
    return np.array(
        [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]],
        dtype=LD,
    )


def _btdb(b, d):
    """b^T d b for b [3, m] and d [3, 3]."""
    return (b.T @ d) @ b


# ----------------------------------------------------------------------
# Local frames (initElement)
# ----------------------------------------------------------------------


def _tri_frame(xyz):
    """(trafo [3,3], dphi [3,2], area) for TRI3 node coords [3,3]; dphi
    rows are ((x12,y12),(x31,y31),(x23,y23)), fem-shell.cpp:403-411."""
    a, b, c = xyz[0], xyz[1], xyz[2]
    u_vec = b - a
    v_vec = c - a
    w_vec = _cross(u_vec, v_vec)
    area = LD(0.5) * _norm(w_vec)
    e_x = u_vec / _norm(u_vec)
    e_z = w_vec / _norm(w_vec)
    e_y = _cross(e_z, e_x)
    trafo = np.stack([e_x, e_y, e_z])  # rows are local axes
    lb = trafo @ u_vec  # local coords of node B (A at origin)
    lc = trafo @ v_vec  # local coords of node C
    dphi = np.array(
        [[-lb[0], -lb[1]], [lc[0], lc[1]], [lb[0] - lc[0], lb[1] - lc[1]]], dtype=LD
    )
    return trafo, dphi, area


def _quad_frame(xyz):
    """(trafo [3,3], local_xy [2,4], dphi [4,2]) for QUAD4 node coords
    [4,3]; fem-shell.cpp:342-432."""
    a, b, c, d = xyz[0], xyz[1], xyz[2], xyz[3]
    half = LD(0.5)
    mid_ab = a + half * (b - a)
    mid_bc = b + half * (c - b)
    mid_cd = c + half * (d - c)
    mid_da = d + half * (a - d)
    e_x = mid_bc - mid_da
    e_x = e_x / _norm(e_x)
    v_r = mid_cd - mid_ab
    e_z = _cross(e_x, v_r)
    e_z = e_z / _norm(e_z)
    e_y = _cross(e_z, e_x)
    trafo = np.stack([e_x, e_y, e_z])
    local = trafo @ np.stack([a, b, c, d], axis=1)  # [3,4]
    lx, ly = local[0], local[1]
    dphi = np.array(
        [[lx[i] - lx[j], ly[i] - ly[j]] for i, j in ((0, 1), (1, 2), (2, 3), (3, 0))],
        dtype=LD,
    )
    return trafo, local[:2], dphi


# ----------------------------------------------------------------------
# Membrane kernels (calcPlane)
# ----------------------------------------------------------------------


def _tri_membrane(dphi, area, dm, thickness):
    """CST membrane [6,6] over (u1,v1,u2,v2,u3,v3); fem-shell.cpp:445-468."""
    x12, y12 = dphi[0]
    x31, y31 = dphi[1]
    x23, y23 = dphi[2]
    z = LD(0)
    b_m = np.array(
        [
            [y23, z, y31, z, y12, z],
            [z, -x23, z, -x31, z, -x12],
            [-x23, y23, -x31, y31, -x12, y12],
        ],
        dtype=LD,
    ) / (LD(2.0) * area)
    return LD(thickness) * area * _btdb(b_m, dm)


def _quad_membrane(local_xy, dm, thickness):
    """Bilinear isoparametric membrane [8,8], interleaved (u_i, v_i);
    2x2 Gauss loop of fem-shell.cpp:469-541."""
    lx, ly = local_xy[0], local_xy[1]
    q = LD(0.25)
    out = None
    for r0, s0 in _QUAD_QPS:
        r = LD(r0) * _GAUSS_ROOT
        s = LD(s0) * _GAUSS_ROOT
        # bilinear shape-function derivatives wrt (r,s); fem-shell.cpp:494-502
        dhdr = np.array([-q * (1 - s), q * (1 - s), q * (1 + s), -q * (1 + s)], dtype=LD)
        dhds = np.array([-q * (1 - r), -q * (1 + r), q * (1 + r), q * (1 - r)], dtype=LD)
        j00 = dhdr @ lx
        j01 = dhdr @ ly
        j10 = dhds @ lx
        j11 = dhds @ ly
        det = j00 * j11 - j01 * j10
        z = LD(0)
        b3x4 = np.array(
            [[j11, -j01, z, z], [z, z, -j10, j00], [-j10, j00, j11, -j01]], dtype=LD
        ) / det
        g = np.zeros((4, 8), LD)
        g[0, 0::2] = dhdr
        g[1, 0::2] = dhds
        g[2, 1::2] = dhdr
        g[3, 1::2] = dhds
        b_m = b3x4 @ g
        term = det * LD(thickness) * _btdb(b_m, dm)
        out = term if out is None else out + term
    return out


# ----------------------------------------------------------------------
# Tri-3 plate kernel (Specht element; calcPlate TRI3 branch + evalBTri)
# ----------------------------------------------------------------------


def _eval_b_tri(side_sq, l1, l2, dphi):
    """Second-derivative strain matrix B [3,9] of the 9-dof Specht
    triangle at area coordinates (l1, l2); fem-shell.cpp:698-891. The
    expressions are those of ops/elements.py, term for term; integer
    literals are exact and 0.5 is exact in both types."""
    mu1 = (side_sq[0] - side_sq[1]) / side_sq[2]
    mu2 = (side_sq[2] - side_sq[0]) / side_sq[1]
    mu3 = (side_sq[1] - side_sq[2]) / side_sq[0]

    l3 = 1 - l1 - l2
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

    d00, d01 = dphi[0]  # x12, y12
    d10, d11 = dphi[1]  # x31, y31
    d20, d21 = dphi[2]  # x23, y23
    h = LD(0.5)

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
    m_b = -1 + 4 * l1 + 2 * l2 + h * l3 * b - h * l2 * b \
        + h * l2 * l3 * 2 * fm13mu2 - h * l1 * b - h * l1 * l2 * 2 * fm13mu2 \
        - 2 * l3 * l1 + 2 * l1 * l2
    m_a = 2 * l1 + h * l3 * a - h * l2 * a + h * l2 * l3 * 2 * fm1m3mu3 \
        - h * l1 * a - h * l1 * l2 * 2 * fm1m3mu3 + h * l1 * l3 * 2 * f1m3mu3 \
        - h * l1 * l2 * 2 * f1m3mu3
    r2c1 = -d11 * m_b - d01 * m_a
    r2c2 = d10 * m_b + d00 * m_a
    r2c3 = 2 - 4 * l2 + l3 * c - l2 * c + 4 * l2 * l3 - l1 * c - 4 * l1 * l2 \
        + l1 * l3 * 2 * f13mu1 - l1 * l2 * 2 * f13mu1 - 4 * l1 - l3 * a + l2 * a \
        + l1 * a - l2 * l3 * 2 * fm1m3mu3 + l1 * l2 * 2 * fm1m3mu3 \
        - l1 * l3 * 2 * f1m3mu3 + l1 * l2 * 2 * f1m3mu3
    m_c = -2 * l2 + h * l3 * c - h * l2 * c + 2 * l2 * l3 - h * l1 * c \
        - 2 * l1 * l2 + h * l1 * l3 * 2 * f13mu1 - h * l1 * l2 * 2 * f13mu1
    r2c4 = -d01 * (m_a - 1) - d21 * m_c
    r2c5 = d00 * (m_a - 1) + d20 * m_c
    r2c6 = -4 + 8 * l1 + 8 * l2 + l3 * b - l2 * b + l2 * l3 * 2 * fm13mu2 \
        - l1 * b - l1 * l2 * 2 * fm13mu2 - 4 * l3 * l1 + 8 * l1 * l2 - l3 * c \
        + l2 * c - 4 * l2 * l3 + l1 * c - l1 * l3 * 2 * f13mu1 + l1 * l2 * 2 * f13mu1
    m_b2 = -2 + 4 * l1 + 2 * l2 + h * l3 * b - h * l2 * b \
        + h * l2 * l3 * 2 * fm13mu2 - h * l1 * b - h * l1 * l2 * 2 * fm13mu2 \
        - 2 * l3 * l1 + 2 * l1 * l2
    r2c7 = -d21 * (m_c + 1) - d11 * m_b2
    r2c8 = d20 * (m_c + 1) + d10 * m_b2

    row0 = [r0c0, r0c1, r0c2, r0c3, r0c4, r0c5, r0c6, r0c7, r0c8]
    row1 = [r1c0, r1c1, r1c2, r1c3, r1c4, r1c5, r1c6, r1c7, r1c8]
    row2 = [2 * v for v in (r2c0, r2c1, r2c2, r2c3, r2c4, r2c5, r2c6, r2c7, r2c8)]
    return np.array([row0, row1, row2], dtype=LD)


def _tri_plate(dphi, area, dp):
    """Specht plate bending [9,9] over (w_i, tx_i, ty_i); fem-shell.cpp:555-603."""
    side_sq = np.sum(dphi * dphi, axis=1)  # AB, AC, BC
    x31, y31 = dphi[1]
    x23, y23 = dphi[2]
    # auxiliary matrix mapping area-coordinate 2nd derivatives to physical
    # curvatures. NOTE: Y[2,1] matches the reference literally
    # (fem-shell.cpp:586 uses dphi(1,0)*dphi(1,0)).
    y = np.array(
        [
            [y23 * y23, y31 * y31, y23 * y31],
            [x23 * x23, x31 * x31, x31 * x23],
            [-2 * x23 * y23, -2 * x31 * x31, -x23 * y31 - x31 * y23],
        ],
        dtype=LD,
    ) / (LD(4.0) * (area * area))
    ke = None
    for l1, l2 in _TRI_QPS:
        yb = y @ _eval_b_tri(side_sq, LD(l1), LD(l2), dphi)
        term = _SIXTH * _btdb(yb, dp)
        ke = term if ke is None else ke + term
    return LD(2.0) * area * ke


# ----------------------------------------------------------------------
# Quad-4 plate kernel (DKQ; calcPlate QUAD4 branch + evalBQuad)
# ----------------------------------------------------------------------


def _eval_b_quad(h, xi, eta, jinv):
    """DKQ strain matrix B [3,12] at (xi, eta); fem-shell.cpp:901-990.
    ``h`` is the [5,4] coefficient table [a,b,c,d,e] x sides (5,6,7,8)."""
    q, half, th = LD(0.25), LD(0.5), LD(1.5)
    n_xi = [
        q * (2 * xi + eta) * (1 - eta),
        q * (2 * xi - eta) * (1 - eta),
        q * (2 * xi + eta) * (1 + eta),
        q * (2 * xi - eta) * (1 + eta),
        -xi * (1 - eta),
        half * (1 - eta * eta),
        -xi * (1 + eta),
        -half * (1 - eta * eta),
    ]
    n_eta = [
        q * (2 * eta + xi) * (1 - xi),
        q * (2 * eta - xi) * (1 + xi),
        q * (2 * eta + xi) * (1 + xi),
        q * (2 * eta - xi) * (1 - xi),
        -half * (1 - xi * xi),
        -eta * (1 + xi),
        half * (1 - xi * xi),
        -eta * (1 - xi),
    ]
    a, b, c, d, e = 0, 1, 2, 3, 4

    def h_vectors(n):
        """Hx and Hy [12] for one derivative direction (n = N_xi|N_eta)."""
        hx, hy = [], []
        for i in range(4):
            m = 4 + i  # mid-side node on side i (5,6,7,8 in Batoz numbering)
            p = 4 + ((i + 3) % 4)  # preceding mid-side node (8,5,6,7)
            im, ip = i, (i + 3) % 4
            hx.append(th * (h[a, im] * n[m] - h[a, ip] * n[p]))
            hx.append(h[b, im] * n[m] + h[b, ip] * n[p])
            hx.append(n[i] - h[c, im] * n[m] - h[c, ip] * n[p])
            hy.append(th * (h[d, im] * n[m] - h[d, ip] * n[p]))
            hy.append(-n[i] + h[e, im] * n[m] + h[e, ip] * n[p])
            hy.append(-(h[b, im] * n[m] + h[b, ip] * n[p]))
        return np.array(hx, dtype=LD), np.array(hy, dtype=LD)

    hx_xi, hy_xi = h_vectors(n_xi)
    hx_eta, hy_eta = h_vectors(n_eta)
    row0 = jinv[0, 0] * hx_xi + jinv[0, 1] * hx_eta
    row1 = jinv[1, 0] * hy_xi + jinv[1, 1] * hy_eta
    row2 = jinv[0, 0] * hy_xi + jinv[0, 1] * hy_eta + jinv[1, 0] * hx_xi + jinv[1, 1] * hx_eta
    return np.stack([row0, row1, row2])


def _quad_plate(dphi, dp):
    """DKQ plate bending [12,12] over (w_i, tx_i, ty_i); fem-shell.cpp:604-688."""
    side_sq = np.sum(dphi * dphi, axis=1)  # squared side lengths AB,BC,CD,DA
    dx, dy = dphi[:, 0], dphi[:, 1]
    q, half, tq = LD(0.25), LD(0.5), LD(0.75)
    h = np.stack(
        [
            -dx / side_sq,  # a_k
            tq * dx * dy / side_sq,  # b_k
            (q * (dx * dx) - half * (dy * dy)) / side_sq,  # c_k
            -dy / side_sq,  # d_k
            (q * (dy * dy) - half * (dx * dx)) / side_sq,  # e_k
        ]
    )
    ke = None
    for r0, s0 in _QUAD_QPS:
        r = LD(r0) * _GAUSS_ROOT
        s = LD(s0) * _GAUSS_ROOT
        j00 = q * ((dx[0] + dx[2]) * s - dx[0] + dx[2])
        j01 = q * ((dy[0] + dy[2]) * s - dy[0] + dy[2])
        j10 = q * ((dx[0] + dx[2]) * r - dx[1] + dx[3])
        j11 = q * ((dy[0] + dy[2]) * r - dy[1] + dy[3])
        det = j00 * j11 - j01 * j10
        jinv = np.array([[j11, -j01], [-j10, j00]], dtype=LD) / det
        b = _eval_b_quad(h, r, s, jinv)
        term = det * _btdb(b, dp)
        ke = term if ke is None else ke + term
    return ke


# ----------------------------------------------------------------------
# Superposition, drilling DOF, and local->global transform
# ----------------------------------------------------------------------


def _superpose(ke_m, ke_p, n_nodes):
    """Interleave membrane/plate blocks into the [6n,6n] shell matrix and
    add the stabilized drilling DOF (max submatrix diagonal / 1000);
    fem-shell.cpp:999-1053."""
    n = n_nodes
    k = np.zeros((6 * n, 6 * n), LD)
    base = 6 * np.arange(n)
    mem_ids = (base[:, None] + np.array([0, 1])[None, :]).reshape(-1)
    plate_ids = (base[:, None] + np.array([2, 3, 4])[None, :]).reshape(-1)
    k[np.ix_(mem_ids, mem_ids)] = ke_m
    k[np.ix_(plate_ids, plate_ids)] = ke_p
    drill = np.maximum(ke_m[0::2, 0::2], ke_m[1::2, 1::2])
    drill = np.maximum(drill, ke_p[0::3, 0::3])
    drill = np.maximum(drill, ke_p[1::3, 1::3])
    drill = np.maximum(drill, ke_p[2::3, 2::3])
    drill = drill / LD(1000.0)
    drill_ids = base + 5
    k[np.ix_(drill_ids, drill_ids)] = drill
    return k


def _to_global(ke, trafo, n_nodes):
    """Blockwise congruence K_global = T6^T K_local T6 per 6x6 node pair,
    with T6 = blockdiag(trafo, trafo); fem-shell.cpp:1061-1102."""
    t6 = np.zeros((6, 6), LD)
    t6[:3, :3] = trafo
    t6[3:, 3:] = trafo
    k4 = ke.reshape(n_nodes, 6, n_nodes, 6)
    kg = np.einsum("ca,icjd->iajd", t6, k4)
    kg = np.einsum("iajd,db->iajb", kg, t6)
    return kg.reshape(6 * n_nodes, 6 * n_nodes)


# ----------------------------------------------------------------------
# Public per-element kernels
# ----------------------------------------------------------------------


def tri_shell_stiffness(xyz, dm, dp, thickness):
    """Global-axes [18,18] longdouble stiffness of one TRI3 flat shell
    element; ``xyz`` [3,3], ``dm``/``dp`` [3,3] (longdouble), DOF order
    node-major."""
    xyz = np.asarray(xyz, LD)
    trafo, dphi, area = _tri_frame(xyz)
    ke_m = _tri_membrane(dphi, area, dm, thickness)
    ke_p = _tri_plate(dphi, area, dp)
    return _to_global(_superpose(ke_m, ke_p, 3), trafo, 3)


def quad_shell_stiffness(xyz, dm, dp, thickness):
    """Global-axes [24,24] longdouble stiffness of one QUAD4 flat shell
    element; ``xyz`` [4,3]."""
    xyz = np.asarray(xyz, LD)
    trafo, local_xy, dphi = _quad_frame(xyz)
    ke_m = _quad_membrane(local_xy, dm, thickness)
    ke_p = _quad_plate(dphi, dp)
    return _to_global(_superpose(ke_m, ke_p, 4), trafo, 4)

"""Port parity: stress recovery (fem_shell_tpu_torch/ops/recovery.py)
against the JAX package's ops/recovery.py, on the CPU.

- ``recover_stresses``, ``recover_stresses_nodal``, ``nodal_average`` and
  ``to_mesh_order`` on seeded random displacements of an 8x8 tri plate, an
  8x8 quad plate and the Test-E I-beam (three planes, so the element
  frames turn): every field within 1e-12 of its largest magnitude; two
  calls equal bit for bit;
- the physics cases of tests/test_recovery.py on the port alone: membrane
  patch (element centres and nodes), rigid-body motion, and the
  Kirchhoff centre moments of the simply supported plate.

The CLI's ``--stress`` output is held against the JAX CLI's in
tests/test_torch_cli.py. Each JAX recovery call traces its vmapped
element function op by op (~4 s on the CPU), so each is one test.
"""
import numpy as np
import pytest

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import ShellMesh as JShellMesh
from fem_shell_tpu.ops import recovery as jrec
from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem, generate
from fem_shell_tpu_torch.data import mesh_from_tris
from fem_shell_tpu_torch.data import test_e as E
from fem_shell_tpu_torch.ops.recovery import (
    corner_table,
    nodal_average,
    recover_stresses,
    recover_stresses_nodal,
    to_mesh_order,
)

E0 = 1e7
NU = 0.3
MAT = Material(nu=NU, em=E0, thickness=0.5)
FIELDS = ("sigma_m", "moments", "vm_top", "vm_bot", "vm")


def _plate_mesh(et, n):
    pm = MeshGenParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    mesh, rows, fac = generate(pm)
    return mesh, rows * fac


def _case(name):
    if name == "ibeam":
        return mesh_from_tris(E.COORDS, E.TRIS, E.BOUNDARY_SIDES), Material(nu=0.25, em=10000, thickness=0.25)
    return _plate_mesh(name[0], 8)[0], MAT


def _close(got, want, gate=1e-12):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= gate * np.abs(want).max()


@pytest.mark.parametrize("nodal", [False, True], ids=["centre", "nodal"])
@pytest.mark.parametrize("name", ["t8", "q8", "ibeam"])
def test_recovery_matches_jax(name, nodal):
    mesh, mat = _case(name)
    jmesh = JShellMesh(mesh.coords, mesh.elem_types, mesh.elem_conn, mesh.boundary_sides)
    jmat = JMaterial(nu=mat.nu, em=mat.em, thickness=mat.thickness)
    u = np.random.default_rng(7).normal(size=(mesh.n_nodes, 6)) * [1e-3, 1e-3, 1e-2, 1e-3, 1e-3, 1e-4]
    port, jax = ((recover_stresses_nodal, jrec.recover_stresses_nodal) if nodal
                 else (recover_stresses, jrec.recover_stresses))
    got, again, want = port(mesh, mat, u, device="cpu"), port(mesh, mat, u, device="cpu"), jax(jmesh, jmat, u)
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(again, f))
    if not nodal:
        np.testing.assert_array_equal(nodal_average(mesh, got.vm), jrec.nodal_average(jmesh, got.vm))
        for f in ("vm", "moments"):
            np.testing.assert_array_equal(to_mesh_order(mesh, getattr(got, f)),
                                          jrec.to_mesh_order(jmesh, getattr(got, f)))


def test_corner_table_sums_in_add_at_order():
    """The node-to-corner table adds each node's rows in the order
    np.add.at adds them: the device sum equals the host one bit for bit."""
    import torch

    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, size=300)
    vals = rng.normal(size=(300, 6))
    want = np.zeros((45, 6))
    np.add.at(want, idx, vals)
    table = torch.as_tensor(corner_table(idx, 45))
    rows = torch.as_tensor(np.vstack([vals, np.zeros((1, 6))]))
    got = torch.zeros((45, 6), dtype=torch.float64)
    for c in range(table.shape[0]):
        got = got + rows[table[c]]
    np.testing.assert_array_equal(got.numpy(), want)
    assert table.shape == (np.bincount(idx).max(), 45) and (table[:, 40:] == 300).all()


def _uniaxial(mesh, e0):
    c = np.asarray(mesh.coords)
    u = np.zeros((mesh.n_nodes, 6))
    u[:, 0] = e0 * c[:, 0]
    u[:, 1] = -NU * e0 * c[:, 1]
    return u


@pytest.mark.parametrize("nodal", [False, True], ids=["centre", "nodal"])
@pytest.mark.parametrize("et", ["q", "t"])
def test_membrane_patch_uniaxial(et, nodal):
    """Linear in-plane field u = e0*x, v = -nu*e0*y => principal stresses
    {E*e0, 0}, von Mises E*e0, zero moments: exact for CST and bilinear,
    at element centres and through extrapolation and nodal averaging."""
    mesh, _ = _plate_mesh(et, 4)
    e0 = 1e-4
    fn = recover_stresses_nodal if nodal else recover_stresses
    f = fn(mesh, MAT, _uniaxial(mesh, e0), device="cpu")
    sx, sy, txy = f.sigma_m[:, 0], f.sigma_m[:, 1], f.sigma_m[:, 2]
    mid = 0.5 * (sx + sy)
    rad = np.sqrt((0.5 * (sx - sy)) ** 2 + txy**2)
    assert np.abs(mid + rad - E0 * e0).max() < 1e-6 * E0 * e0
    assert np.abs(mid - rad).max() < 1e-6 * E0 * e0
    assert np.abs(f.moments).max() < 1e-6 * E0 * e0
    assert np.abs(f.vm - E0 * e0).max() < 1e-5 * E0 * e0


@pytest.mark.parametrize("et", ["q", "t"])
def test_rigid_body_motion_is_stress_free(et):
    mesh, _ = _plate_mesh(et, 4)
    c = np.asarray(mesh.coords)
    u = np.zeros((mesh.n_nodes, 6))
    w = 1e-4
    u[:, 0] = 0.3 - w * c[:, 1]
    u[:, 1] = -0.2 + w * c[:, 0]
    u[:, 2] = 0.05
    u[:, 5] = w
    f = recover_stresses(mesh, MAT, u, device="cpu")
    scale = E0 * w
    assert np.abs(f.sigma_m).max() < 1e-6 * scale
    assert np.abs(f.moments).max() < 1e-6 * scale


@pytest.mark.parametrize("et,tol", [("q", 0.02), ("t", 0.05)])
def test_moments_vs_kirchhoff(et, tol):
    """SS square plate under uniform q (Timoshenko Table 8): the element
    centre peak moment and the extrapolated nodal centre moments hit
    Mmax = 0.0479 q a^2; the nodal vm maximum sits at the corners
    (twisting moment Mxy = 0.0325 q a^2)."""
    mesh, forces = _plate_mesh(et, 16)
    u = ShellSystem(mesh, MAT, device="cpu").solve(forces).numpy()
    m_exact = 0.0479 * 300.0 * 10.0**2
    f = recover_stresses(mesh, MAT, u, device="cpu")
    m_peak = np.abs(f.moments[:, :2]).max()
    assert abs(m_peak - m_exact) < 0.05 * m_exact
    assert f.vm.max() > 6 * m_peak / MAT.thickness**2 * 0.9
    nv = nodal_average(mesh, f.vm)
    assert nv.shape == (mesh.n_nodes,) and np.isfinite(nv).all() and nv.max() > 0
    n = recover_stresses_nodal(mesh, MAT, u, device="cpu")
    centre = mesh.n_nodes // 2
    assert abs(abs(n.moments[centre, 0]) - m_exact) < tol * m_exact
    assert abs(abs(n.moments[centre, 1]) - m_exact) < tol * m_exact
    vm_centre = 6.0 * m_exact / MAT.thickness**2
    assert abs(n.vm[centre] - vm_centre) < tol * vm_centre
    vm_corner = np.sqrt(3.0) * 6.0 * 0.0325 * 300.0 * 10.0**2 / MAT.thickness**2
    assert abs(n.vm.max() - vm_corner) < 0.06 * vm_corner

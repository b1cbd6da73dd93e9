"""Port parity: the Scordelis-Lo roof of fem_shell_tpu_torch/shells.py
against fem_shell_tpu/shells.py, and its ShellSystem goldens.

- ``scordelis_lo``: coordinates, connectivity, the diaphragm mask, the
  forces and the midside node equal to the JAX ones bit for bit (n = 8,
  16, and a rectangular 8 x 12 grid); an odd ``n_axial`` raises.
- ``ShellSystem`` (block-ELL, block-Jacobi PCG to rtol 1e-12) on the roof
  at n = 8, 16: the midside deflection within 1e-4 of the pinned goldens
  of tests/test_shells.py, converging from below toward the canonical
  0.3024 inside the JAX test's 6 % band, and within 1e-10 of the JAX
  package's own ShellSystem solve.
"""
import functools

import numpy as np
import pytest
import torch

from fem_shell_tpu import shells as jshells
from fem_shell_tpu.system import ShellSystem as JShellSystem
from fem_shell_tpu_torch import ShellSystem, shells

# tests/test_shells.py:20
PINNED = {8: -0.28523, 16: -0.29379, 32: -0.29844}


@pytest.mark.parametrize("n_arc,n_axial", [(8, None), (16, None), (8, 12)])
def test_scordelis_lo_matches_jax(n_arc, n_axial):
    jmesh, jf, jmid = jshells.scordelis_lo(n_arc, n_axial)
    mesh, f, mid = shells.scordelis_lo(n_arc, n_axial)
    assert mid == jmid
    assert np.array_equal(mesh.coords, jmesh.coords)
    assert np.array_equal(mesh.elem_types, jmesh.elem_types)
    assert np.array_equal(mesh.elem_conn, jmesh.elem_conn)
    assert np.array_equal(mesh.quad, jmesh.quad) and len(mesh.tri) == 0
    assert np.array_equal(mesh.node_dirichlet_mask, jmesh.node_dirichlet_mask)
    assert np.array_equal(mesh.dirichlet_mask(), jmesh.dirichlet_mask())
    assert np.array_equal(f, jf)
    assert shells.SCORDELIS_LO_GOLDEN_W == jshells.SCORDELIS_LO_GOLDEN_W
    m, jm = shells.SCORDELIS_LO_MATERIAL, jshells.SCORDELIS_LO_MATERIAL
    assert (m.nu, m.em, m.thickness) == (jm.nu, jm.em, jm.thickness)


def test_odd_axial_raises():
    with pytest.raises(ValueError, match="n_axial must be even"):
        shells.scordelis_lo(8, 9)


@functools.lru_cache(maxsize=None)
def _jax_shell_solve(n):
    jmesh, jf, jmid = jshells.scordelis_lo(n)
    u = JShellSystem(jmesh, jshells.SCORDELIS_LO_MATERIAL).solve(jf, rtol=1e-12, maxiter=100000)
    return np.asarray(u)


@pytest.mark.parametrize("n", [8, 16])
def test_scordelis_lo_shell_system_golden(n):
    mesh, f, mid = shells.scordelis_lo(n)
    system = ShellSystem(mesh, shells.SCORDELIS_LO_MATERIAL, device="cpu")
    u = system.solve(f, rtol=1e-12, maxiter=100000)
    assert u.dtype == torch.float64 and system.last_cg.residual < 1e-12
    w = float(u[mid, 2])
    np.testing.assert_allclose(w, PINNED[n], rtol=1e-4)
    assert shells.SCORDELIS_LO_GOLDEN_W < w < 0.94 * shells.SCORDELIS_LO_GOLDEN_W
    ref = _jax_shell_solve(n)
    assert abs(w - ref[mid, 2]) <= 1e-10 * abs(ref[mid, 2])

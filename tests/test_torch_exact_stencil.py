"""Port parity: the longdouble element kernels (ops/elements_ld.py) and the
exact-stencil row-class tables (ops/exact_stencil.py) of
fem_shell_tpu_torch against the JAX package, which evaluates its traced
f64 kernels through a longdouble jaxpr interpreter (ops/ld_interp.py), on
the CPU.

Both sides run every operation in longdouble (eps 2^-63 on x86-64) in the
same order up to the association of a few products, so the element
matrices and the tables are held to 1e-17 of their largest entry: tight
enough to tell longdouble from f64 (whose rounding alone is ~1e-16).
"""
import numpy as np
import pytest

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import elements as jel
from fem_shell_tpu.ops import exact_stencil as jes
from fem_shell_tpu.ops.ld_interp import ld_function
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops import elements_ld as tel
from fem_shell_tpu_torch.ops import exact_stencil as tes

LD = np.longdouble
JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
LD_TOL = 1e-17


def _case(et, n):
    p = JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, _, _ = jgenerate(p)
    return jmesh, mesh_from_jax(jmesh), JLarge(jmesh, JMAT).offsets


def _elements(m, seed):
    """Seeded element geometries: a grid-like element and a distorted,
    tilted one (out of the xy plane, so every frame term is live)."""
    rng = np.random.default_rng(seed)
    if m == 3:
        base = np.array([[0.0, 0.0, 0.0], [0.3125, 0.0, 0.0], [0.0, 0.3125, 0.0]])
    else:
        base = np.array([[0.0, 0.0, 0.0], [0.3125, 0.0, 0.0], [0.3125, 0.3125, 0.0],
                         [0.0, 0.3125, 0.0]])
    tilted = base + 0.05 * rng.standard_normal(base.shape)
    if m == 4:  # keep the quad planar: project its nodes onto one plane
        tilted[:, 2] = 0.3 * tilted[:, 0] - 0.2 * tilted[:, 1]
    return [base.astype(LD), tilted.astype(LD)]


@pytest.mark.parametrize("m", [3, 4])
def test_element_kernels_match_jax_ld(m):
    jkern = jel.tri_shell_stiffness if m == 3 else jel.quad_shell_stiffness
    tkern = tel.tri_shell_stiffness if m == 3 else tel.quad_shell_stiffness
    fn = ld_function(lambda p, dm, dp: jkern(p, dm, dp, 0.5))
    dm, dp = tes._material_ld(0.3, 1e7, 0.5)
    for xyz in _elements(m, seed=7 + m):
        ref = fn(xyz, dm, dp)
        got = tkern(xyz, dm, dp, 0.5)
        assert got.dtype == LD and got.shape == (6 * m, 6 * m)
        scale = float(np.max(np.abs(ref)))
        assert float(np.max(np.abs(got - ref))) <= LD_TOL * scale


@pytest.mark.parametrize("et,n", [("t", 12), ("q", 12), ("t", 17), ("q", 17)])
def test_exact_stencil_tables_match_jax(et, n):
    jmesh, tmesh, offsets = _case(et, n)
    ref = jes.build_exact_stencil(jmesh, JMAT, offsets)
    got = tes.build_exact_stencil(tmesh, TMAT, offsets)
    a_ref = ref.t0.astype(LD) + ref.t1 + ref.t2
    a_got = got.t0.astype(LD) + got.t1 + got.t2
    assert float(np.max(np.abs(a_got - a_ref))) <= LD_TOL * float(np.max(np.abs(a_ref)))
    assert got.offs2d == ref.offs2d and got.offsets == ref.offsets
    np.testing.assert_array_equal(got.cy_idx, ref.cy_idx)
    np.testing.assert_array_equal(got.cx_idx, ref.cx_idx)
    assert (got.nyp, got.nxp) == (ref.nyp, ref.nxp) == (n + 1, n + 1)
    for t in (got.t0, got.t1, got.t2):
        assert t.dtype == np.float32 and t.shape == (len(offsets), 6, 6, 6, 6)


def test_non_uniform_grid_rejected_as_in_jax():
    jmesh, tmesh, offsets = _case("t", 8)
    coords = np.asarray(jmesh.coords).copy()
    coords[10, 0] += 0.01
    from fem_shell_tpu.mesh import ShellMesh as JShellMesh

    jwarp = JShellMesh(coords, jmesh.elem_types, jmesh.elem_conn, jmesh.boundary_sides)
    twarp = ShellMesh(coords, tmesh.elem_types, tmesh.elem_conn, tmesh.boundary_sides)
    with pytest.raises(ValueError, match="uniform"):
        jes.build_exact_stencil(jwarp, JMAT, offsets)
    with pytest.raises(ValueError, match="uniform"):
        tes.build_exact_stencil(twarp, TMAT, offsets)


def test_class_inconsistent_mask_rejected_as_in_jax():
    jmesh, tmesh, offsets = _case("q", 8)
    mask = jmesh.dirichlet_mask().copy()
    mask[4 * 9 + 4, 2] = True  # an interior node's w: no class holds it
    with pytest.raises(ValueError, match="class-consistent"):
        jes.build_exact_stencil(jmesh, JMAT, offsets, dirichlet_mask=mask)
    with pytest.raises(ValueError, match="class-consistent"):
        tes.build_exact_stencil(tmesh, TMAT, offsets, dirichlet_mask=mask)


def test_inconsistent_patch_interior_raises(monkeypatch):
    """A position-dependent element kernel makes the patch's two interior
    representatives disagree: the redundancy check raises AssertionError,
    in both packages."""
    jmesh, tmesh, offsets = _case("q", 8)
    jreal, treal = jel.quad_shell_stiffness, tel.quad_shell_stiffness
    monkeypatch.setattr(jel, "quad_shell_stiffness",
                        lambda xyz, dm, dp, t: jreal(xyz, dm, dp, t) * (1.0 + xyz[0, 0]))
    monkeypatch.setattr(tes, "quad_shell_stiffness",
                        lambda xyz, dm, dp, t: treal(xyz, dm, dp, t) * (LD(1) + xyz[0, 0]))
    with pytest.raises(AssertionError, match="inconsistent"):
        jes.build_exact_stencil(jmesh, JMAT, offsets)
    with pytest.raises(AssertionError, match="inconsistent"):
        tes.build_exact_stencil(tmesh, TMAT, offsets)


def test_grid_smaller_than_patch_rejected():
    _, tmesh, offsets = _case("q", 4)
    with pytest.raises(ValueError, match="smaller"):
        tes.build_exact_stencil(tmesh, TMAT, offsets)

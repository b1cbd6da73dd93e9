"""Port parity: the stand-alone solver (fem_shell_tpu_torch.system.ShellSystem,
ops/assemble.py, ops/blockprec.py) against the JAX package's ShellSystem,
on the CPU.

- The non-slow goldens A-F of tests/test_golden.py through the port's
  ShellSystem, at that file's tolerances and parametrisations (30 cases);
  meshes from the port's own data copies and meshgen.
- Parity at 8x8 quad and tri and on Test E's mixed Tri-3/Quad-4 I-beam:
  the block-ELL pattern equal exactly, assembled blocks to 1e-13 of
  max|A| (the element stiffnesses of the two frameworks differ in the
  last bits), cholesky6 and its solve to 1e-13, block-Jacobi and Jacobi
  iteration counts within one (another summation order) and the
  displacements to 1e-10 of max|u| at rtol 1e-12, the dense solve against
  PCG.
- The scatter is the JAX package's sequential scatter in its order
  (bit for bit against numpy's unbuffered ``add.at``) and never calls
  ``index_add_``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.data import test_e as JE
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops.assemble import build_ell_pattern as jbuild_ell_pattern
from fem_shell_tpu.ops.blockprec import cholesky6 as jcholesky6, cholesky6_solve as jcholesky6_solve
from fem_shell_tpu.system import ShellSystem as JShellSystem
from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem, generate
from fem_shell_tpu_torch.convert import mesh_from_jax
from fem_shell_tpu_torch.data import mesh_from_quads, mesh_from_tris, mixed_ibeam_mesh
from fem_shell_tpu_torch.data import test_a as A
from fem_shell_tpu_torch.data import test_b as B
from fem_shell_tpu_torch.data import test_e as E
from fem_shell_tpu_torch.ops import assemble as tassemble
from fem_shell_tpu_torch.ops.blockprec import cholesky6, cholesky6_solve


def solve(mesh, forces, nu, em, t, method="pcg", rtol=1e-12, maxiter=50000):
    system = ShellSystem(mesh, Material(nu=nu, em=em, thickness=t), device="cpu")
    u = system.solve(forces, method=method, rtol=rtol, maxiter=maxiter)
    return u.numpy(), system


def plate_case(elem_type, n, bcid, loading, factor, domain=(0, 0, 10, 10), ul_lr=False):
    p = MeshGenParams(elem_type, n, n, domain[0], domain[1], domain[2], domain[3],
                      (bcid, bcid, bcid, bcid), factor, loading, ul_lr, "z")
    mesh, rows, fac = generate(p)
    return mesh, rows * fac


# ----------------------------------------------------------------------
# goldens A-F (tests/test_golden.py, the non-slow cases)
# ----------------------------------------------------------------------


def test_a_tri_membrane_cantilever():
    mesh = mesh_from_tris(A.COORDS, A.TRIS, A.BOUNDARY_SIDES)
    u, _ = solve(mesh, A.FORCES, nu=0.25, em=30000, t=1.0)
    np.testing.assert_allclose(u[22, 0], -0.0255988, rtol=1e-5)
    np.testing.assert_allclose(u[22, 1], 0.0629549, rtol=1e-5)
    np.testing.assert_allclose(u[26, 0], -0.0342621, rtol=1e-5)
    np.testing.assert_allclose(u[26, 1], 0.1944070, rtol=1e-5)


def test_a_dense_matches_pcg():
    mesh = mesh_from_tris(A.COORDS, A.TRIS, A.BOUNDARY_SIDES)
    u1, _ = solve(mesh, A.FORCES, nu=0.25, em=30000, t=1.0, method="dense")
    u2, _ = solve(mesh, A.FORCES, nu=0.25, em=30000, t=1.0, method="pcg")
    np.testing.assert_allclose(u1, u2, atol=1e-10)


def test_b_quad_membrane_cantilever():
    mesh = mesh_from_quads(B.COORDS, B.QUADS, B.BOUNDARY_SIDES)
    u, _ = solve(mesh, B.FORCES, nu=0.25, em=30000, t=1.0)
    np.testing.assert_allclose(u[22, 0], -0.0427728, rtol=1e-5)
    np.testing.assert_allclose(u[22, 1], 0.1012620, rtol=1e-5)
    np.testing.assert_allclose(u[26, 0], -0.0570728, rtol=1e-5)
    np.testing.assert_allclose(u[26, 1], 0.3160560, rtol=1e-5)


@pytest.mark.parametrize("n,golden", [(4, 1.06723), (16, 1.15169)])
def test_c_tri_plate_center_deflection(n, golden):
    mesh, forces = plate_case("t", n, bcid=0, loading=1, factor=1.0, ul_lr=False)
    u, _ = solve(mesh, forces, nu=0.3, em=10.92, t=1.0)
    np.testing.assert_allclose(u[mesh.n_nodes // 2, 2], golden, rtol=1e-5)


@pytest.mark.parametrize("n,golden", [(4, 0.106032), (8, 0.106405), (16, 0.106454)])
def test_d_quad_plate_uniform(n, golden):
    mesh, forces = plate_case("q", n, bcid=0, loading=2, factor=300.0)
    u, _ = solve(mesh, forces, nu=0.3, em=1e7, t=0.5)
    np.testing.assert_allclose(u[mesh.n_nodes // 2, 2], golden, rtol=1e-5)


@pytest.mark.parametrize("n,golden", [(4, 0.332677), (8, 0.312851), (16, 0.306664)])
def test_d_quad_plate_concentrated(n, golden):
    mesh, forces = plate_case("q", n, bcid=0, loading=1, factor=30000.0)
    u, _ = solve(mesh, forces, nu=0.3, em=1e7, t=0.5)
    np.testing.assert_allclose(u[mesh.n_nodes // 2, 2], golden, rtol=1e-5)


def test_e_tri_shell_ibeam():
    """The code-faithful goldens of tests/test_golden.py (the thesis table
    predates the shipped code) and the thesis magnitudes to 5 %."""
    mesh = mesh_from_tris(E.COORDS, E.TRIS, E.BOUNDARY_SIDES)
    u, _ = solve(mesh, E.FORCES, nu=0.25, em=10000, t=0.25)
    np.testing.assert_allclose(u[35, :3], [0.01605314, 0.08948797, -0.15605938], rtol=1e-6)
    np.testing.assert_allclose(u[44, :3], [0.01544426, -0.08905332, 0.14949037], rtol=1e-6)
    np.testing.assert_allclose(np.abs(u[44, :3]), [0.0152698, 0.0879212, 0.1543450], rtol=0.05)


def test_e_quad_shell_ibeam():
    mesh = mesh_from_quads(E.COORDS, E.QUADS, E.QUAD_BOUNDARY_SIDES)
    u, _ = solve(mesh, E.FORCES, nu=0.25, em=10000, t=0.25)
    np.testing.assert_allclose(u[35, :3], [0.02527736, 0.13915961, -0.23064233], rtol=1e-6)
    np.testing.assert_allclose(u[44, :3], [0.02527736, -0.13915961, 0.23064233], rtol=1e-6)
    np.testing.assert_allclose(np.abs(u[35, :3]), [0.0246001, 0.1373650, 0.2320180], rtol=0.05)


def test_e_mixed_tri_quad_ibeam():
    mesh = mixed_ibeam_mesh()
    assert len(mesh.tri) == 32 and len(mesh.quad) == 24
    u_d, _ = solve(mesh, E.FORCES, nu=0.25, em=10000, t=0.25, method="dense")
    u_p, _ = solve(mesh, E.FORCES, nu=0.25, em=10000, t=0.25, method="pcg")
    np.testing.assert_allclose(u_p, u_d, atol=1e-10)
    np.testing.assert_allclose(u_d[35, :3], [0.01584023, 0.08818383, -0.19393935], rtol=1e-6)
    np.testing.assert_allclose(u_d[44, :3], [0.02568137, -0.14142868, 0.19104298], rtol=1e-6)


F_DOMAIN = (0, 0, 10, 2)
F_GOLDEN = {
    (0, 2): {2: 14.4005, 4: 12.6269, 8: 12.8565, 16: 12.9431},
    (1, 2): {2: 3.82366, 4: 2.45355, 8: 2.60137, 16: 2.60384},
    (0, 1): {2: 11.5204, 4: 17.3048, 8: 18.1158, 16: 17.4961},
    (1, 1): {2: 3.05893, 4: 6.06564, 8: 7.78902, 16: 7.66573},
}


@pytest.mark.parametrize("bcid", [0, 1])
@pytest.mark.parametrize("loading", [2, 1])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_f_convergence(bcid, loading, n):
    factor = 1e-4 if loading == 2 else 4e-4
    mesh, forces = plate_case("q", n, bcid=bcid, loading=loading, factor=factor, domain=F_DOMAIN)
    u, _ = solve(mesh, forces, nu=0.3, em=1.7472e7, t=0.01)
    np.testing.assert_allclose(u[mesh.n_nodes // 2, 2], F_GOLDEN[(bcid, loading)][n] * 1e-6, rtol=1e-4)


# ----------------------------------------------------------------------
# parity with the JAX ShellSystem
# ----------------------------------------------------------------------

CASES = ("q8", "t8", "e_mixed")


def _jax_mixed_mesh():
    from fem_shell_tpu.mesh import ShellMesh

    m = mixed_ibeam_mesh()
    return ShellMesh(JE.COORDS, m.elem_types, m.elem_conn, m.boundary_sides)


def _case(name):
    """(JAX mesh, forces, JAX material) of a parity case."""
    if name == "e_mixed":
        return _jax_mixed_mesh(), JE.FORCES, JMaterial(nu=0.25, em=10000, thickness=0.25)
    et = name[0]
    jmesh, rows, fac = jgenerate(JParams(et, 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, False, "z"))
    return jmesh, rows * fac, JMaterial(nu=0.3, em=1e7, thickness=0.5)


@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    """The JAX ShellSystem's assembly, block-Jacobi factor and PCG solves
    of one case, computed once per test process."""
    jmesh, forces, jmat = _case(name)
    jsys = JShellSystem(jmesh, jmat)
    a = jsys.assemble()
    dblocks = a.diagonal_blocks()
    out = {"blocks": np.asarray(a.blocks), "diag_blocks": np.asarray(dblocks),
           "chol": np.asarray(jcholesky6(dblocks))}
    for pc in ("block_jacobi", "jacobi"):
        u = np.asarray(jsys.solve(forces, rtol=1e-12, maxiter=20000, precond=pc))
        out[pc] = (u, int(jsys.last_cg.iters))
    return out


def _port(name):
    jmesh, forces, jmat = _case(name)
    mat = Material(nu=jmat.nu, em=jmat.em, thickness=jmat.thickness)
    return ShellSystem(mesh_from_jax(jmesh), mat, device="cpu"), forces


@pytest.mark.parametrize("name", CASES)
def test_pattern_equals_jax(name):
    jmesh, _, _ = _case(name)
    ref = jbuild_ell_pattern(jmesh)
    got = tassemble.build_ell_pattern(mesh_from_jax(jmesh))
    for field in ("adj", "valid", "tri_slot", "quad_slot"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), field
    wide = tassemble.build_ell_pattern(mesh_from_jax(jmesh), k_max=ref.k_max + 3)
    assert np.array_equal(wide.adj, jbuild_ell_pattern(jmesh, k_max=ref.k_max + 3).adj)


@pytest.mark.parametrize("name", CASES)
def test_assembly_matches_jax(name):
    ref = _jax_ref(name)
    tsys, _ = _port(name)
    a = tsys.assemble()
    got = a.blocks.numpy()
    assert got.shape == ref["blocks"].shape
    assert np.abs(got - ref["blocks"]).max() <= 1e-13 * np.abs(ref["blocks"]).max()
    np.testing.assert_array_equal(a.diagonal_blocks().numpy()[:, range(6), range(6)],
                                  a.diagonal().numpy())
    # padding slots repeat the self id with zero blocks; to_dense adds them onto it
    dense = a.to_dense().numpy()
    n = tsys.mesh.n_nodes
    blk = dense.reshape(n, 6, n, 6).transpose(0, 2, 1, 3)[np.arange(n), np.arange(n)]
    np.testing.assert_array_equal(blk, a.diagonal_blocks().numpy())
    assert np.abs(dense - dense.T).max() <= 1e-13 * np.abs(dense).max()


@pytest.mark.parametrize("name", CASES)
def test_cholesky6_matches_jax(name):
    ref = _jax_ref(name)
    lt = cholesky6(torch.tensor(ref["diag_blocks"]))
    assert np.abs(lt.numpy() - ref["chol"]).max() <= 1e-13 * np.abs(ref["chol"]).max()
    r = np.random.default_rng(3).normal(size=(ref["chol"].shape[0], 6))
    zj = np.asarray(jcholesky6_solve(jnp.asarray(ref["chol"]), jnp.asarray(r)))
    zt = cholesky6_solve(lt, torch.from_numpy(r)).numpy()
    assert np.abs(zt - zj).max() <= 1e-13 * np.abs(zj).max()


@pytest.mark.parametrize("precond", ["block_jacobi", "jacobi"])
@pytest.mark.parametrize("name", CASES)
def test_pcg_matches_jax(name, precond):
    ref_u, ref_it = _jax_ref(name)[precond]
    tsys, forces = _port(name)
    u = tsys.solve(forces, rtol=1e-12, maxiter=20000, precond=precond).numpy()
    assert abs(tsys.last_cg.iters - ref_it) <= 1 and tsys.last_cg.residual < 1e-12
    assert np.abs(u - ref_u).max() <= 1e-10 * np.abs(ref_u).max()


@pytest.mark.parametrize("name", CASES)
def test_dense_and_repeat_solver_match_pcg(name):
    tsys, forces = _port(name)
    u = tsys.solve(forces, rtol=1e-12)
    ud = tsys.solve(forces, method="dense")
    assert np.abs((ud - u).numpy()).max() <= 1e-10 * float(u.abs().max())
    x, iters, res = tsys.make_repeat_solver(rtol=1e-12)(forces)
    assert torch.equal(x, u) and iters == tsys.last_cg.iters and res == tsys.last_cg.residual
    assert np.array_equal(tsys.solution_vector(u), u.numpy().reshape(-1))


def test_scatter_is_the_sequential_scatter():
    """scatter_to_ell adds each slot's blocks in the JAX scatter's order
    (all Tri-3 blocks by element and node pair, then all Quad-4 ones):
    equal bit for bit to numpy's unbuffered sequential add.at."""
    mesh = mixed_ibeam_mesh()
    pat = tassemble.build_ell_pattern(mesh)
    rng = np.random.default_rng(11)
    ke_t = rng.normal(size=(18, 18, len(mesh.tri)))
    ke_q = rng.normal(size=(24, 24, len(mesh.quad)))
    n, k = pat.adj.shape
    ref = np.zeros((n * k, 6, 6))
    for ke, slot, m in ((ke_t, pat.tri_slot, 3), (ke_q, pat.quad_slot, 4)):
        kb = ke.transpose(2, 0, 1).reshape(-1, m, 6, m, 6).transpose(0, 1, 3, 2, 4)
        np.add.at(ref, slot.reshape(-1), kb.reshape(-1, 6, 6))
    table = tassemble.contributor_table(pat)
    assert table.shape == (np.bincount(np.concatenate([pat.tri_slot.ravel(), pat.quad_slot.ravel()])).max(), n * k)
    got = tassemble.scatter_to_ell(torch.from_numpy(ke_t), torch.from_numpy(ke_q), n, k,
                                   torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy().reshape(n * k, 6, 6), ref)


def test_assembly_never_calls_index_add(monkeypatch):
    """The block scatter runs without index_add_ (on CUDA it sums
    colliding slots in no fixed order); two assemblies agree bit for bit."""
    tsys, forces = _port("e_mixed")
    first = tsys.assemble().blocks

    def refuse(*args, **kw):
        raise AssertionError("index_add_ called")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    assert torch.equal(tsys.assemble().blocks, first)
    u = tsys.solve(forces)
    assert tsys.last_cg.residual < 1e-12 and bool(torch.isfinite(u).all())


def test_empty_family_gives_empty_batch():
    tsys, _ = _port("q8")
    ke_t, ke_q = tassemble.element_stiffnesses(tsys.coords, tsys.tri_conn, tsys.quad_conn,
                                               tsys.dm, tsys.dp, tsys.thickness)
    assert tuple(ke_t.shape) == (18, 18, 0) and tuple(ke_q.shape) == (24, 24, 64)


def test_unported_paths_raise():
    tsys, forces = _port("q8")
    mesh, mat = tsys.mesh, tsys.material
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        ShellSystem(mesh, mat, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="method='pcg'"):
        tsys.solve(forces, method="dense", differentiable=True)
    with pytest.raises(ValueError, match="precond"):
        tsys.solve(forces, precond="mg")
    bad = torch.eye(6, dtype=torch.float64).repeat(3, 1, 1)
    bad[1, 2, 2] = -1.0
    with pytest.raises(ValueError, match="block 1"):
        cholesky6(bad)

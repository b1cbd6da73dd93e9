"""Port parity: the f32 systems (``ShellSystem``, ``LargeShellSystem`` and
``MultigridShellSystem`` with ``dtype=torch.float32``) against the JAX
package, on the CPU.

The port assembles in f64 and casts the operator to f32 once; the JAX
package assembles in f32. So:

- each f32 operator of the port (``ShellSystem`` 8x8, ``LargeShellSystem``
  16x16, both levels of a two-level ``MultigridShellSystem`` 16x16) lies
  within 2^-24 max|A| of the JAX f64 operator (one rounding per entry,
  plus the f64 assemblies' ~1e-16 disagreement), and the multigrid levels
  are the f32 casts of the port's own f64 levels bit for bit; the JAX f32
  operator lies in its 1e-9 ... 1e-6 band (tests/test_df_assembly.py:38),
  farther than the port's.
- the f32 solves (``ShellSystem`` 8x8 to rtol 1e-6; ``LargeShellSystem``
  ``solve`` to 1e-6 and ``solve_df`` to 1e-9, ``MultigridShellSystem``
  ``solve`` to 1e-6 and ``solve_df`` to 1e-9, at 16x16) lie within
  F32_SOLVE_GATE of max|u| of the JAX f64 ``ShellSystem`` solve and of the
  JAX f32 solve of the same system (quad; the tri plates against the f64
  solve only, the JAX f32 multigrid costing ~30 s a family). The gate is
  kappa eps32 class: on these plates every f32 solve of either package
  departs 1.2e-4 to 1.2e-3 of max|u| from the f64 one (the port's f32
  quad operator, a cast of identical element matrices, rounds coherently
  over the grid: -4.3e-4 at the centre against the JAX f32 system's
  +1.2e-4). Multigrid iteration counts within 2 of the JAX ones.
- at 32x32 the f32 ``ShellSystem``'s centre departs from the f64 centre by
  at most F32_JAX_RATIO times the JAX f32 system's departure in the same
  test (measured on the CPU: the port 3.0x the JAX package's on the quad
  plate, -6.9e-3 against +2.3e-3, 0.48x on the tri plate, 4.6e-3 against
  9.6e-3), a guard against a further loss of f32 accuracy against the
  reference.
- ``solve_df_refined`` on an f32 ``LargeShellSystem`` raises
  (tests/test_refined_ecorr.py:51), and so does the f32 ``solve_df`` in
  gather mode (the JAX package's is stencil-only);
- ``stencil_spmv_f32v``'s plain version (the card holds the kernel against
  it in chip_smoke.py phase 2) equals the f64 product of the widened
  values bit for bit, and the wrapper refuses other dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import ShellMesh as JShellMesh
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.mg import MultigridShellSystem as JMG
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.mesh import permute_nodes
from fem_shell_tpu_torch.mg import MultigridShellSystem
from fem_shell_tpu_torch.system import ShellSystem

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
ROUNDING = 2.0**-24 + 1e-12  # of max|A|: one f32 rounding plus f64 noise
F32_SOLVE_GATE = 2e-3  # of max|u|
F32_JAX_RATIO = 4.0  # the port's f32 centre departure over the JAX f32 one, at 32x32


def _plate(et, n):
    jmesh, rows, fac = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
    return jmesh, rows * fac


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("which", ["shell", "large", "mg"])
def test_f32_operators_within_one_rounding(which):
    if which == "shell":
        jmesh, _ = _plate("q", 8)
        ref = np.asarray(JSystem(jmesh, JMAT).assemble().blocks)
        got = ShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, device="cpu").assemble().blocks
        assert got.dtype == torch.float32 and _rel(got, ref) <= ROUNDING
        return
    jmesh, _ = _plate("q", 16)
    if which == "large":
        ref = np.asarray(JLarge(jmesh, JMAT, dtype=jnp.float64).assemble())
        got = LargeShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, device="cpu").assemble()
        jax32 = np.asarray(JLarge(jmesh, JMAT, dtype=jnp.float32).assemble())
        assert got.dtype == torch.float32 and _rel(got, ref) <= ROUNDING
        assert 1e-9 < _rel(jax32, ref) < 1e-6 and _rel(got, ref) < _rel(jax32, ref)
        return
    mg32 = MultigridShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, n_levels=2, device="cpu")
    mg64 = MultigridShellSystem(mesh_from_jax(jmesh), TMAT, n_levels=2, device="cpu")
    for l32, l64, sys_l in zip(mg32.levels, mg64.levels, mg32._systems):
        assert torch.equal(l32.values, l64.values.to(torch.float32))
        m = sys_l.mesh
        mask = (sys_l.free_t[:, : m.n_nodes] == 0).T.numpy()
        jm = JShellMesh(m.coords, m.elem_types, m.elem_conn, m.boundary_sides)
        ref = np.asarray(JLarge(jm, JMAT, dtype=jnp.float64, dirichlet_mask=mask).assemble())
        assert _rel(l32.values, ref) <= ROUNDING


@pytest.mark.parametrize("et", ["q", "t"])
def test_f32_shell_system_solve(et):
    jmesh, forces = _plate(et, 8)
    u64 = np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-12))
    ju = np.asarray(JSystem(jmesh, JMAT, dtype=jnp.float32).solve(forces, rtol=1e-6))
    ts = ShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, device="cpu")
    u = ts.solve(forces, rtol=1e-6)
    assert u.dtype == torch.float32 and ts.last_cg.residual <= 1e-6
    assert _rel(u, u64) <= F32_SOLVE_GATE and _rel(u, ju) <= F32_SOLVE_GATE
    dense = ts.solve(forces, method="dense")
    assert dense.dtype == torch.float32 and _rel(dense, u64) <= F32_SOLVE_GATE
    rep = ts.make_repeat_solver(rtol=1e-6)
    x, iters, res = rep(forces)
    assert x.dtype == torch.float32 and res <= 1e-6 and torch.equal(x, u)


@pytest.mark.parametrize("et", ["q", "t"])
def test_f32_shell_departure_against_jax_32(et):
    """At 32x32 (765 iterations for the JAX f32 quad solve) the port's
    f32 centre departure from the f64 centre stays within F32_JAX_RATIO of
    the JAX f32 system's; the f64 centre is the port's f64 solve (within
    1e-10 of the JAX one, tests/test_torch_system.py)."""
    jmesh, forces = _plate(et, 32)
    c = jmesh.n_nodes // 2
    mesh = mesh_from_jax(jmesh)
    w64 = float(ShellSystem(mesh, TMAT, device="cpu").solve(forces, rtol=1e-12)[c, 2])
    w32 = float(ShellSystem(mesh, TMAT, dtype=torch.float32, device="cpu").solve(forces, rtol=1e-6)[c, 2])
    jw32 = float(JSystem(jmesh, JMAT, dtype=jnp.float32).solve(forces, rtol=1e-6)[c, 2])
    port, jax_ = abs(w32 - w64) / abs(w64), abs(jw32 - w64) / abs(w64)
    assert 0.0 < jax_ < 0.05 and port <= F32_JAX_RATIO * jax_, (port, jax_)


@pytest.mark.parametrize("et", ["q", "t"])
def test_f32_large_system_solves(et):
    jmesh, forces = _plate(et, 16)
    u64 = np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-12))
    ts = LargeShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, device="cpu")
    out = {}
    for pc in ("jacobi", "block_jacobi"):
        out[pc] = ts.solve(forces, rtol=1e-6, precond=pc)
        assert out[pc].dtype == torch.float32 and ts.last_cg.residual <= 1e-6
    out["df"] = ts.solve_df(forces, rtol=1e-9)
    assert out["df"].dtype == torch.float64 and ts.last_residual <= 1e-9
    refs = [u64]
    if et == "q":
        js = JLarge(jmesh, JMAT, dtype=jnp.float32)
        refs += [np.asarray(js.solve(forces, rtol=1e-6)), np.asarray(js.solve_df(forces, rtol=1e-9))]
    for u in out.values():
        assert max(_rel(u, r) for r in refs) <= F32_SOLVE_GATE


@pytest.mark.parametrize("et", ["q", "t"])
def test_f32_multigrid_solves(et):
    jmesh, forces = _plate(et, 16)
    u64 = np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-12))
    ts = MultigridShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, n_levels=2, device="cpu")
    u = ts.solve(forces, rtol=1e-6)
    assert u.dtype == torch.float32 and ts.last_cg.residual <= 1e-6
    d = ts.solve_df(forces, rtol=1e-9)
    assert d.dtype == torch.float64 and ts.last_residual <= 1e-9
    assert _rel(u, u64) <= F32_SOLVE_GATE and _rel(d, u64) <= F32_SOLVE_GATE
    assert torch.equal(ts.solve(forces, rtol=1e-6), u)
    with pytest.raises(ValueError, match="f64"):
        ts.solve_fused(forces)
    if et == "q":
        js = JMG(jmesh, JMAT, dtype=jnp.float32, n_levels=2)
        ju = np.asarray(js.solve(forces, rtol=1e-6))
        assert abs(int(js.last_cg.iters) - int(ts.last_cg.iters)) <= 2
        jd = np.asarray(js.solve_df(forces, rtol=1e-9))
        assert abs(int(js.last_iters) - int(ts.last_iters)) <= 2
        assert _rel(u, ju) <= F32_SOLVE_GATE and _rel(d, jd) <= F32_SOLVE_GATE


def test_f32_large_refusals():
    jmesh, forces = _plate("q", 8)
    mesh = mesh_from_jax(jmesh)
    ts = LargeShellSystem(mesh, TMAT, dtype=torch.float32, exact_geom=True, device="cpu")
    off = LargeShellSystem(mesh, TMAT, dtype=torch.float32, exact_geom=False, device="cpu")
    assert torch.equal(ts.assemble(), off.assemble())  # exact_geom changes nothing
    with pytest.raises(ValueError, match="f64"):
        ts.solve_df_refined(forces)
    perm = np.random.default_rng(3).permutation(mesh.n_nodes)
    gather = LargeShellSystem(permute_nodes(mesh, perm), TMAT, dtype=torch.float32, device="cpu")
    assert gather.offsets is None
    with pytest.raises(NotImplementedError, match="stencil mode"):
        gather.solve_df(forces[perm])
    u = gather.solve(forces[perm], rtol=1e-6, precond="block_jacobi")
    assert gather.last_cg.residual <= 1e-6 and bool(torch.isfinite(u).all())


def test_stencil_spmv_f32v_plain_and_checks():
    """The mixed instance's plain version on the CPU: f32 values widened
    exactly, so y equals the f64 product of the widened values bit for
    bit; no launch is counted; other dtypes raise."""
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv_f32v, stencil_spmv_plain

    jmesh, _ = _plate("t", 8)
    ts = LargeShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, device="cpu")
    v = ts.assemble()
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(6, v.shape[2])))
    before = stencil_spmv_f32v.launches
    y = stencil_spmv_f32v(v, x, ts.offsets)
    assert y.dtype == torch.float64 and stencil_spmv_f32v.launches == before
    assert torch.equal(y, stencil_spmv_plain(v.to(torch.float64), x, ts.offsets))
    with pytest.raises(TypeError, match="float32 values and float64 x"):
        stencil_spmv_f32v(v.to(torch.float64), x, ts.offsets)
    with pytest.raises(TypeError, match="float32 values and float64 x"):
        stencil_spmv_f32v(v, x.to(torch.float32), ts.offsets)

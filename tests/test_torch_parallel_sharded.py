"""Port parity of the row-block and strip designs (parallel/sharded.py,
parallel/stencil_shard.py) on the CPU over gloo, against the JAX package:

- ``ShardedShellSystem`` (Jacobi PCG, rtol 1e-12) within 1e-12 of max|u|
  of the JAX f64 ``ShellSystem`` solve on the 16x16 quad plate (2 ranks),
  the 8x8 tri plate (81 nodes over 3 ranks) and the mixed Tri-3/Quad-4
  I-beam (2 ranks), its iterations within one of the JAX
  ``ShardedShellSystem``'s at the same shard count, and a repeated solve
  bitwise equal (the quad plate);
- ``ShardedStencilSystem`` (f64) on the 8 x 32 strip plate of the dry
  run's path 2 within 1e-12 of the JAX f64 ``ShellSystem`` solve, its
  strip length, halo width and element tables equal to the JAX system's,
  and a strip narrower than two halos refused.

The JAX ``ShellSystem`` references run once per module. Tracing the JAX
``ShardedShellSystem`` costs 1.3-2.4 s per mesh here, so its counts are
pinned, produced with

    python -c "import sys; sys.path.insert(0, 'tests'); import conftest
      from fem_shell_tpu.data import test_e as E; from fem_shell_tpu.materials import Material
      from fem_shell_tpu.mesh import ShellMesh; from fem_shell_tpu.meshgen import MeshGenParams, generate
      from fem_shell_tpu.parallel.sharded import ShardedShellSystem as S, make_device_mesh
      from fem_shell_tpu_torch.data import mixed_ibeam_mesh
      p = Material(nu=0.3, em=1e7, thickness=0.5); b = Material(nu=0.25, em=10000, thickness=0.25)
      for et, n, s in (('q', 16, 2), ('t', 8, 3)):
        m, r, f = generate(MeshGenParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == 'q', 'z'))
        x = S(m, p, make_device_mesh(s)); x.solve(r * f); print(et, n, s, x.last_iters)
      m = mixed_ibeam_mesh(); m = ShellMesh(m.coords, m.elem_types, m.elem_conn, m.boundary_sides)
      x = S(m, b, make_device_mesh(2)); x.solve(E.FORCES); print('ibeam', x.last_iters)"
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.data import test_e as JE
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import ShellMesh as JMesh
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.parallel.sharded import make_device_mesh as jmake_mesh
from fem_shell_tpu.parallel.stencil_shard import ShardedStencilSystem as JStencil
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.data import mixed_ibeam_mesh
from fem_shell_tpu_torch.parallel.sharded import ShardedShellSystem
from fem_shell_tpu_torch.parallel.stencil_shard import ShardedStencilSystem
from torch_parallel_meshes import StartingMeshes

PLATE = JMaterial(nu=0.3, em=1e7, thickness=0.5)
BEAM = JMaterial(nu=0.25, em=10000, thickness=0.25)
# the JAX ShardedShellSystem.solve counts (rtol 1e-12) at each case's shard count (above)
JAX_SHARDED_ITERS = {"quad16": 85, "tri8": 66, "ibeam": 202}
_REF = {}


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2, 3)
    yield started
    started.close()


def _case(name):
    """(jax mesh, forces, material, shards, JAX ShellSystem u, the JAX
    sharded iterations), once per module."""
    if name not in _REF:
        if name == "ibeam":
            m = mixed_ibeam_mesh()
            jmesh, forces, mat, s = JMesh(m.coords, m.elem_types, m.elem_conn, m.boundary_sides), JE.FORCES, BEAM, 2
        else:
            et, n, s = {"quad16": ("q", 16, 2), "tri8": ("t", 8, 3)}[name]
            jmesh, rows, fac = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
            forces, mat = rows * fac, PLATE
        u = np.asarray(JSystem(jmesh, mat).solve(forces, rtol=1e-13, maxiter=50000))
        _REF[name] = (jmesh, forces, mat, s, u, JAX_SHARDED_ITERS[name])
    return _REF[name]


@pytest.mark.parametrize("name", ["quad16", "tri8", "ibeam"])
def test_sharded_system_matches_jax(meshes, name):
    jmesh, forces, mat, s, ref, jiters = _case(name)
    system = ShardedShellSystem(mesh_from_jax(jmesh), material_from_jax(mat), meshes[s])
    u = system.solve(forces)
    assert system.last_residual < 1e-12
    assert np.abs(u - ref).max() <= 1e-12 * np.abs(ref).max()
    assert abs(system.last_iters - jiters) <= 1, (system.last_iters, jiters)
    if name == "quad16":
        np.testing.assert_array_equal(system.solve(forces), u)


def test_stencil_strip_matches_jax(meshes):
    p = JParams("q", 8, 32, 0, 0, 1, 4, (0, 0, 0, 0), 1.0, 2, True, "z")
    jmesh, rows, fac = jgenerate(p)
    forces = rows * fac
    ref = np.asarray(JSystem(jmesh, PLATE).solve(forces, rtol=1e-13, maxiter=50000))
    want = JStencil(jmesh, PLATE, jmake_mesh(2), dtype=jnp.float64, chunk=256)
    system = ShardedStencilSystem(mesh_from_jax(jmesh), material_from_jax(PLATE), meshes[2], dtype=torch.float64,
                                  chunk=256)
    assert (system.l, system.w_pad, system.offsets) == (want.l, want.w_pad, want.offsets)
    for got, exp in ((system.tri_conn, want.tri_conn), (system.quad_conn, want.quad_conn),
                     (system.quad_w, want.quad_w), (system.free, want.free)):
        np.testing.assert_array_equal(got, np.asarray(exp))
    u = system.solve(forces, rtol=1e-12)
    assert system.last_residual < 1e-12
    assert np.abs(u - ref).max() <= 1e-12 * np.abs(ref).max()


def test_narrow_strips_refused(meshes):
    mesh = mesh_from_jax(jgenerate(JParams("q", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))[0])
    with pytest.raises(ValueError, match="strips too narrow"):
        ShardedStencilSystem(mesh, material_from_jax(PLATE), meshes[3], dtype=torch.float64)

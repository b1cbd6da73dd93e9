"""Port parity of the production solver's strips (parallel/df_shard.py,
native f64 in the port) on the CPU over 2 gloo ranks, at rtol 1e-12:

- ``ShardedDFShellSystem`` (f64 Jacobi-PCG) on the 8 x 64 strip plate of
  tests/test_df_shard.py;
- ``ShardedMGDFShellSystem`` (f64 CG, the f32 sharded V-cycle) on the
  32x32 Test-G quad plate;

each within 1e-10 of max|u| of the JAX f64 ``ShellSystem`` solve. The
JAX df systems run two-float32 arithmetic that the CPU compiler
contracts (ROADMAP.md Queue 3, "Differences"), so their answers are held
apart (1e-6 of max|u| off the f64 solve on the strip). The MG-df count is
within 3 of the JAX ``ShardedMGDFShellSystem``'s at the same shard count
(24; the V-cycle bounds the damage). That system takes ~9 s here to
build and solve, mostly tracing, so its count is pinned, produced with

    python -c "import sys; sys.path.insert(0, 'tests'); import conftest
      from fem_shell_tpu.materials import Material; from fem_shell_tpu.meshgen import MeshGenParams, generate
      from fem_shell_tpu.parallel.df_shard import ShardedMGDFShellSystem as S
      from fem_shell_tpu.parallel.sharded import make_device_mesh
      m, r, f = generate(MeshGenParams('q', 32, 32, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, 'z'))
      s = S(m, Material(nu=0.3, em=1e7, thickness=0.5), make_device_mesh(2))
      s.solve_df(r * f, rtol=1e-12, maxiter=300); print(s.last_iters, s.last_residual)"

The strip's Jacobi-PCG count is held within 3 of the same design in f64,
the JAX ``ShardedStencilSystem`` at 2 shards (208), because the JAX df
strip's count on the CPU is the contracted arithmetic's (447 at rtol
1e-12, 272 at 1e-9, where the f64 design takes 198). The other JAX
references run once per module."""
import jax.numpy as jnp
import numpy as np
import pytest

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.parallel.sharded import make_device_mesh as jmake_mesh
from fem_shell_tpu.parallel.stencil_shard import ShardedStencilSystem as JStencil
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.parallel.df_shard import ShardedDFShellSystem, ShardedMGDFShellSystem
from torch_parallel_meshes import StartingMeshes

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
CASES = {"strip": ("q", 8, 64, 1, 8, 1.0), "mgdf": ("q", 32, 32, 10, 10, 300.0)}
# the JAX ShardedMGDFShellSystem.solve_df count on 2 shards, rtol 1e-12 (above)
JAX_MGDF_ITERS = 24
_REF = {}


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2)
    yield started
    started.close()


def _jax(name):
    if name not in _REF:
        et, nx, ny, lx, ly, q = CASES[name]
        jmesh, rows, fac = jgenerate(JParams(et, nx, ny, 0, 0, lx, ly, (0, 0, 0, 0), q, 2, True, "z"))
        forces = rows * fac
        u64 = np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-13, maxiter=50000))
        if name == "strip":
            js = JStencil(jmesh, JMAT, jmake_mesh(2), dtype=jnp.float64)
            js.solve(forces, rtol=1e-12, maxiter=20000)
            assert js.last_residual < 1e-12
            iters = js.last_iters
        else:
            iters = JAX_MGDF_ITERS
        _REF[name] = (jmesh, forces, u64, iters)
    return _REF[name]


@pytest.mark.parametrize("name", list(CASES))
def test_df_systems_match_jax(meshes, name):
    jmesh, forces, u64, jiters = _jax(name)
    mesh, mat = mesh_from_jax(jmesh), material_from_jax(JMAT)
    if name == "strip":
        system = ShardedDFShellSystem(mesh, mat, meshes[2])
        u = system.solve(forces, rtol=1e-12, maxiter=20000)
    else:
        system = ShardedMGDFShellSystem(mesh, mat, meshes[2])
        assert (system.n_sharded, system.n_levels) == (1, 2)
        u = system.solve_df(forces, rtol=1e-12, maxiter=300)
    assert u.dtype == np.float64 and system.last_residual < 1e-12
    assert np.abs(u - u64).max() <= 1e-10 * np.abs(u64).max()
    assert abs(system.last_iters - jiters) <= 3, (system.last_iters, jiters)

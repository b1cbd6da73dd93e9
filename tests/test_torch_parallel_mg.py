"""Port parity of the sharded geometric multigrid
(parallel/mg_shard.py) on the CPU over gloo: ``ShardedMGShellSystem`` in
f64 on the 32x32 Test-G quad plate (two levels: the fine level sharded,
the 17x17 coarsest replicated with its dense inverse) against the JAX
package's at 2 shards, rtol 1e-10: the displacements within 1e-9 of
max|u| and the iteration count within one. On 3 ranks (33 node rows:
12-row strips, the last one padded) the solve stays within 1e-9 of the
2-rank one, with the count within one; a repeated solve is bitwise
equal. The JAX reference runs once per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.parallel.mg_shard import ShardedMGShellSystem as JShardedMG
from fem_shell_tpu.parallel.sharded import make_device_mesh as jmake_mesh
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem
from torch_parallel_meshes import StartingMeshes

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
_REF = {}


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2, 3)
    yield started
    started.close()


def _jax():
    if not _REF:
        jmesh, rows, fac = jgenerate(JParams("q", 32, 32, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        js = JShardedMG(jmesh, JMAT, jmake_mesh(2), dtype=jnp.float64)
        u = js.solve(rows * fac, rtol=1e-10, maxiter=100)
        _REF.update(mesh=jmesh, forces=rows * fac, u=u, iters=js.last_iters, levels=(js.n_sharded, js.n_levels))
    return _REF


def test_sharded_mg_matches_jax(meshes):
    ref = _jax()
    mg = ShardedMGShellSystem(mesh_from_jax(ref["mesh"]), material_from_jax(JMAT), meshes[2], dtype=torch.float64)
    assert (mg.n_sharded, mg.n_levels) == ref["levels"] == (1, 2)
    u = mg.solve(ref["forces"], rtol=1e-10, maxiter=100)
    assert mg.last_residual < 1e-10
    scale = np.abs(ref["u"]).max()
    assert np.abs(u - ref["u"]).max() <= 1e-9 * scale
    assert abs(mg.last_iters - ref["iters"]) <= 1, (mg.last_iters, ref["iters"])
    np.testing.assert_array_equal(mg.solve(ref["forces"], rtol=1e-10, maxiter=100), u)

    mg3 = ShardedMGShellSystem(mesh_from_jax(ref["mesh"]), material_from_jax(JMAT), meshes[3], dtype=torch.float64)
    assert mg3.levels[0].rows == 12
    u3 = mg3.solve(ref["forces"], rtol=1e-10, maxiter=100)
    assert mg3.last_residual < 1e-10
    assert np.abs(u3 - u).max() <= 1e-9 * scale
    assert abs(mg3.last_iters - mg.last_iters) <= 1


def test_unstructured_mesh_refused(meshes):
    from fem_shell_tpu_torch.data import mixed_ibeam_mesh
    from fem_shell_tpu_torch.materials import Material

    with pytest.raises(ValueError, match="structured grid"):
        ShardedMGShellSystem(mixed_ibeam_mesh(), Material(0.25, 1e4, 0.25), meshes[2])

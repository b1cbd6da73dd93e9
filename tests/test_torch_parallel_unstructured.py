"""Port parity of the unstructured halo decomposition
(parallel/unstructured_shard.py) on the CPU over gloo: the mixed
Tri-3/Quad-4 I-beam refined once (RCM-renumbered inside), on 2 ranks and
on 3 (187 nodes: 63-row chunks, the last one padded), against the JAX
f64 ``LargeShellSystem`` Jacobi solve at rtol 1e-10: the displacements
within 1e-9 of max|u|, the iterations within max(3, 5 %) of its count,
and ``comm_floats_per_iter`` equal to the JAX ``HaloShardedShellSystem``'s
at the same shard count. The JAX references run once per module."""
import jax.numpy as jnp
import numpy as np
import pytest

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import ShellMesh as JMesh, refine_uniform as jrefine
from fem_shell_tpu.parallel.sharded import make_device_mesh as jmake_mesh
from fem_shell_tpu.parallel.unstructured_shard import HaloShardedShellSystem as JHalo
from fem_shell_tpu_torch.convert import material_from_jax
from fem_shell_tpu_torch.data import mixed_ibeam_mesh
from fem_shell_tpu_torch.mesh import refine_uniform
from fem_shell_tpu_torch.parallel.unstructured_shard import HaloShardedShellSystem
from torch_parallel_meshes import StartingMeshes

JMAT = JMaterial(nu=0.25, em=10000, thickness=0.25)
_REF = {}


def _forces(n):
    f = np.zeros((n, 6))
    f[35, 1] = 1.6
    f[44, 1] = -1.6
    return f


def _jax():
    if not _REF:
        m = mixed_ibeam_mesh()
        jmesh = jrefine(JMesh(m.coords, m.elem_types, m.elem_conn, m.boundary_sides), 1)
        f = _forces(jmesh.n_nodes)
        js = JLarge(jmesh, JMAT, dtype=jnp.float64)
        u = np.asarray(js.solve(f, rtol=1e-10, maxiter=50000))
        _REF.update(u=u, iters=int(js.last_cg.iters), forces=f,
                    comm={s: JHalo(jmesh, JMAT, jmake_mesh(s)).comm_floats_per_iter for s in (2, 3)})
    return _REF


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2, 3)
    yield started
    started.close()


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_halo_sharded_matches_jax(meshes, n_ranks):
    ref = _jax()
    mesh = refine_uniform(mixed_ibeam_mesh(), 1)
    hs = HaloShardedShellSystem(mesh, material_from_jax(JMAT), meshes[n_ranks])
    u = hs.solve(ref["forces"], rtol=1e-10, maxiter=50000)
    assert hs.last_residual < 1e-10
    assert np.abs(u - ref["u"]).max() <= 1e-9 * np.abs(ref["u"]).max()
    assert abs(hs.last_iters - ref["iters"]) <= max(3, 0.05 * ref["iters"]), (hs.last_iters, ref["iters"])
    assert hs.comm_floats_per_iter == ref["comm"][n_ranks]

"""Host tables of the sharded solvers against the JAX package's, for 2, 3
and 8 shards (numpy only, no rank starts): ``parallel.partition.build_partition``
on the mixed Tri-3/Quad-4 I-beam and the 8x8 Tri-3 plate (81 nodes,
divisible by none of 2 and 8), and ``parallel.unstructured_shard.build_halo_tables``
on the I-beam refined once and renumbered by RCM, as
``HaloShardedShellSystem`` builds them. Every array equal."""
import dataclasses

import numpy as np
import pytest

from fem_shell_tpu.mesh import ShellMesh as JMesh, permute_nodes as jpermute, rcm_order as jrcm
from fem_shell_tpu.mesh import refine_uniform as jrefine
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops.assemble import build_ell_pattern as jpattern
from fem_shell_tpu.parallel.partition import build_partition as jbuild_partition
from fem_shell_tpu.parallel.unstructured_shard import build_halo_tables as jbuild_halo_tables
from fem_shell_tpu_torch.convert import mesh_from_jax
from fem_shell_tpu_torch.data import mixed_ibeam_mesh
from fem_shell_tpu_torch.mesh import permute_nodes, rcm_order, refine_uniform
from fem_shell_tpu_torch.ops.assemble import build_ell_pattern
from fem_shell_tpu_torch.parallel.partition import build_partition
from fem_shell_tpu_torch.parallel.unstructured_shard import build_halo_tables

SHARDS = [2, 3, 8]


def _jax_mesh(m):
    return JMesh(m.coords, m.elem_types, m.elem_conn, m.boundary_sides)


def _meshes():
    tri, _, _ = jgenerate(JParams("t", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, False, "z"))
    ibeam = mixed_ibeam_mesh()
    return {"ibeam": (ibeam, _jax_mesh(ibeam)), "tri8": (mesh_from_jax(tri), tri)}


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", ["ibeam", "tri8"])
def test_partition_matches_jax(case, n_shards):
    mesh, jmesh = _meshes()[case]
    got = build_partition(mesh, build_ell_pattern(mesh), n_shards)
    want = jbuild_partition(jmesh, jpattern(jmesh), n_shards)
    assert got.n_pad == want.n_pad
    _assert_same(got, want)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_halo_tables_match_jax(n_shards):
    mesh = refine_uniform(mixed_ibeam_mesh(), 1)
    jmesh = jrefine(_jax_mesh(mixed_ibeam_mesh()), 1)
    mesh, jmesh = permute_nodes(mesh, rcm_order(mesh)), jpermute(jmesh, jrcm(jmesh))
    np.testing.assert_array_equal(mesh.coords, jmesh.coords)
    got = build_halo_tables(mesh, build_ell_pattern(mesh), n_shards)
    want = jbuild_halo_tables(jmesh, jpattern(jmesh), n_shards)
    _assert_same(got, want)
    assert got.n_boundary > 0

"""Port parity of the sharded grid assembly (parallel/grid_asm_shard.py) on
the CPU:

- ``partition_rows`` equal to the JAX function over a table of (nyp, S);
- ``assemble_grid_df_rowblocks`` against the JAX row blocks' hi + lo
  (``eager=False``) within 1e-11 of max|A|, on the warped quad 8^2 over 2
  shards. The JAX df element program compiles once per strip shape
  (with a cold compilation cache 43.6 s for quad 12^2 / 3 shards, 51.0 s
  tri 12^2 / 3 shards, 108.7 s warped tri 10^2 / 2 shards, 25.8 s warped
  quad 8^2 / 2 shards, whose two shards share one shape; 8.9 s warm), so
  one case runs against it;
  the tri, quad and warped cases over 2 and 3 shards are held against the
  port's single-device ``assemble_grid`` (which
  tests/test_torch_assemble_grid.py holds against the JAX grid pipeline at
  1e-13): bit for bit off the fold rows, within 1e-14 of max|A| on them;
- one shard bit for bit ``assemble_grid``; ``rowblocks_diag`` against the
  single-device diagonal;
- ``GridShardedDFShellSystem`` on the 16x64 quad plate on 1 and 2 gloo
  ranks: Jacobi and ``prec="mg"`` within 1e-8 of max|u| of the JAX f64
  ``ShellSystem``, ``mg`` in at most 60 iterations (the JAX gate), no
  element scatter on the fine level (the ranks count what
  ``scatter_elements`` adds), ``solve_refined`` within 1e-9 with a
  non-empty ``refine_history``; the JAX ValueErrors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import ShellMesh as JMesh
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.mg import detect_structured_grid as jdetect
from fem_shell_tpu.parallel import grid_asm_shard as jga
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.mg import detect_structured_grid
from fem_shell_tpu_torch.ops.assemble_grid import assemble_grid
from fem_shell_tpu_torch.ops.soa import soa_diagonal
from fem_shell_tpu_torch.parallel.grid_asm_shard import (
    GridShardedDFShellSystem,
    assemble_grid_df_rowblocks,
    partition_rows,
    rowblocks_diag,
    rowblocks_to_flat,
)
from torch_parallel_meshes import StartingMeshes

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
# (element type, n, warped, shards, strip rows), as tests/test_grid_asm_shard.py
BLOCK_CASES = [("q", 12, False, 3, 3), ("t", 12, False, 3, 3), ("t", 12, True, 2, None), ("q", 10, True, 2, 3),
               ("t", 8, False, 2, 2)]
_REF = {}


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(1, 2)
    yield started
    started.close()


def _jmesh(et, n, warp):
    jmesh, _, _ = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 1, 0, 1), 300.0, 2, True, "z"))
    if warp:
        c = np.asarray(jmesh.coords, np.float64).copy()
        c[:, 2] = 0.3 * np.sin(c[:, 0]) * np.cos(0.7 * c[:, 1])
        jmesh = JMesh(c, jmesh.elem_types, jmesh.elem_conn, jmesh.boundary_sides)
    return jmesh


def _port(jmesh):
    mesh = mesh_from_jax(jmesh)
    s = LargeShellSystem(mesh, TMAT, device="cpu")
    return mesh, s, detect_structured_grid(mesh)


def _blocks(mesh, s, grid, starts, strip_rows=None):
    return assemble_grid_df_rowblocks(grid, mesh.coords, s.free_t, s.offsets, s.dm, s.dp, s.thickness, starts,
                                      strip_rows=strip_rows)


def _plate():
    """The 16x64 quad plate and the JAX f64 ShellSystem's solution, once."""
    if "plate" not in _REF:
        jmesh, rows, fac = jgenerate(JParams("q", 16, 64, 0, 0, 2.5, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        forces = rows * fac
        _REF["plate"] = (mesh_from_jax(jmesh), forces,
                         np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-13, maxiter=50000)))
    return _REF["plate"]


def count_scatter(comm, on):
    """A rank command: with ``on``, count the elements the strip systems'
    ``scatter_elements`` adds on this rank (wrapping it in place); without,
    return the count and unwrap."""
    from fem_shell_tpu_torch.parallel import stencil_shard

    if on:
        inner = stencil_shard.scatter_elements
        comm.state["scatter_count"] = [0, inner]

        def counted(flat, coords, conn, *a, **kw):
            comm.state["scatter_count"][0] += len(conn)
            return inner(flat, coords, conn, *a, **kw)

        stencil_shard.scatter_elements = counted
        return None
    count, inner = comm.state.pop("scatter_count")
    stencil_shard.scatter_elements = inner
    return count


def test_partition_rows_matches_jax():
    for nyp in (2, 3, 9, 13, 65, 129, 1025):
        for s in (1, 2, 3, 4, 8, 16):
            assert partition_rows(nyp, s) == jga.partition_rows(nyp, s), (nyp, s)


def test_rowblocks_match_jax_blocks():
    jmesh = _jmesh("q", 8, True)
    js = JLarge(jmesh, JMAT, dtype=jnp.float64, chunk=64)
    jgrid = jdetect(jmesh)
    starts = jga.partition_rows(jgrid.nyp, 2)
    jblocks = jga.assemble_grid_df_rowblocks(jgrid, np.asarray(jmesh.coords, np.float64),
                                             js.free_t.astype(jnp.float32), js.offsets, js._grid_kernel_fn(4),
                                             starts, eager=False)
    mesh, s, grid = _port(jmesh)
    blocks = _blocks(mesh, s, grid, starts)
    k = len(s.offsets)
    for b, jb in zip(blocks, jblocks):
        want = (np.asarray(jb.hi, np.float64) + np.asarray(jb.lo, np.float64)).reshape(36, k, -1)
        assert b.shape == want.shape
        assert np.abs(b.numpy() - want).max() <= 1e-11 * np.abs(want).max()


@pytest.mark.parametrize("et,n,warp,n_shards,strip_rows", BLOCK_CASES)
def test_rowblocks_match_single_device(et, n, warp, n_shards, strip_rows):
    mesh, s, grid = _port(_jmesh(et, n, warp))
    starts = partition_rows(grid.nyp, n_shards)
    blocks = _blocks(mesh, s, grid, starts, strip_rows)
    ref = assemble_grid(grid, mesh.coords, s.free_t, s.offsets, s.pattern.n_pad, s.dm, s.dp, s.thickness,
                        strip_rows=strip_rows)
    nxp, n_nodes = grid.nxp, grid.nyp * grid.nxp
    flat = rowblocks_to_flat(blocks, s.pattern.n_pad)
    assert flat.shape == ref.shape
    fold = np.zeros(n_nodes, bool)
    for ns in starts[1:-1]:
        fold[ns * nxp:(ns + 1) * nxp] = True
    assert torch.equal(flat[:, :, :n_nodes][:, :, ~fold], ref[:, :, :n_nodes][:, :, ~fold])
    scale = float(ref.abs().max())
    assert float((flat[:, :, :n_nodes][:, :, fold] - ref[:, :, :n_nodes][:, :, fold]).abs().max()) <= 1e-14 * scale


def test_one_shard_bitwise_and_diag():
    mesh, s, grid = _port(_jmesh("t", 8, True))
    ref = assemble_grid(grid, mesh.coords, s.free_t, s.offsets, s.pattern.n_pad, s.dm, s.dp, s.thickness)
    n_nodes = grid.nyp * grid.nxp
    (one,) = _blocks(mesh, s, grid, [0, grid.nyp])
    assert torch.equal(one, ref[:, :, :n_nodes])
    blocks = _blocks(mesh, s, grid, partition_rows(grid.nyp, 3))
    diag = torch.cat(rowblocks_diag(blocks, s.offsets), dim=1)
    want = soa_diagonal(ref, s.offsets)[:, :n_nodes]
    assert float((diag - want).abs().max()) <= 1e-14 * float(want.abs().max())


@pytest.mark.parametrize("prec", ["jacobi", "mg"])
@pytest.mark.parametrize("ranks", [1, 2])
def test_grid_sharded_system(meshes, ranks, prec):
    mesh, forces, u64 = _plate()
    dm = meshes[ranks]
    dm.run(count_scatter, [True] * ranks)
    try:
        system = GridShardedDFShellSystem(mesh, TMAT, dm, prec=prec)
    finally:
        scattered = dm.run(count_scatter, [False] * ranks)
    if prec == "mg":
        coarse = sum(len(lvl.sys.mesh.quad) for lvl in system.mgp.levels[1:system.mgp.n_sharded])
        assert sum(scattered) == coarse  # the coarser sharded levels only, each element once
    else:
        assert scattered == [0] * ranks
    assert system.strips_per_rank() == [1] * ranks
    u = system.solve(forces, rtol=1e-10 if prec == "jacobi" else 1e-9, maxiter=20000)
    assert u.dtype == np.float64 and np.abs(u - u64).max() <= 1e-8 * np.abs(u64).max()
    if prec == "mg":
        assert system.last_iters <= 60, system.last_iters


@pytest.mark.parametrize("prec", ["jacobi", "mg"])
def test_solve_refined(meshes, prec):
    mesh, forces, u64 = _plate()
    system = GridShardedDFShellSystem(mesh, TMAT, meshes[2], prec=prec)
    u = system.solve_refined(forces, rtol=1e-10, inner_rtol=1e-6)
    assert len(system.refine_history) >= 1 and system.refine_history[-1] < 1e-10
    assert system.last_iters == sum(system.refine_inner_iters)
    assert np.abs(u - u64).max() <= 1e-9 * np.abs(u64).max()


def test_value_errors(meshes):
    from fem_shell_tpu_torch.data import test_a as A
    from fem_shell_tpu_torch.mesh import ShellMesh

    mesh, _, _ = _plate()
    with pytest.raises(ValueError, match="prec must be"):
        GridShardedDFShellSystem(mesh, TMAT, meshes[2], prec="amg")
    small = mesh_from_jax(jgenerate(JParams("q", 4, 2, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))[0])
    with pytest.raises(ValueError, match="grid too small for 2 shards"):
        GridShardedDFShellSystem(small, TMAT, meshes[2])
    ne = A.TRIS.shape[0]
    tris = ShellMesh(A.COORDS, np.full(ne, 3, np.int32), np.hstack([A.TRIS, np.full((ne, 1), -1, np.int32)]),
                     A.BOUNDARY_SIDES)
    with pytest.raises(ValueError, match="structured grid"):
        GridShardedDFShellSystem(tris, TMAT, meshes[2])

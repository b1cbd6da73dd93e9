"""Port parity of the 2-D process-grid solver (parallel/grid2d_shard.py) on
the CPU over gloo ranks:

- ``Comm.ppermute_shift`` on 2x2, 1x2 and 2x1 grids against numpy's rolls
  (an axis of size 2 sends both messages to one peer, an axis of size 1
  returns a rank's own edges);
- ``Sharded2DGridSystem`` in f64 on 2x2 (quad 20^2, uneven tiles: 21 nodes
  pad to 22, and tri 20^2, whose (dy=+1, dx=-1) slots cross tile corners)
  and on 1x2 and 2x1 (quad 24^2): within 1e-12 of max|u| of the JAX system
  on the same process grid, its iteration count within 1 % of JAX's;
- ``Sharded2DGridDFSystem``: bit for bit the port's f64 system, and
  within 1e-4 of max|u| of the JAX df system (the JAX test's gate: its
  two-float32 arithmetic is contracted by the CPU compiler);
- the tiles, untiled and mapped to the SoA offsets, against the
  single-device ``LargeShellSystem.assemble()``: 1e-13 of max|A|;
- the flattened-window product (``stencil_spmv``, its plain version on
  the CPU) against the JAX 9-slot loop (``check_spmv_tile``);
- the JAX ValueErrors.

Each JAX reference jit-compiles its own shard_map program (~1.5-6 s), so
each test computes only its own; the tests against JAX come first, so the
ranks start in the background while the first reference compiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.parallel import grid2d_shard as jg
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.parallel.grid2d_shard import (
    SLOTS,
    Sharded2DGridDFSystem,
    Sharded2DGridSystem,
    check_spmv_tile,
    make_device_mesh2d,
)
from torch_parallel_meshes import StartingMeshes

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
# (element type, n, py, px)
CASES = {"quad20_2x2": ("q", 20, 2, 2), "tri20_2x2": ("t", 20, 2, 2),
         "quad24_1x2": ("q", 24, 1, 2), "quad24_2x1": ("q", 24, 2, 1)}


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2, 4)
    yield started
    started.close()


def _plate(et, n):
    jmesh, rows, fac = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
    return jmesh, rows * fac


def _grid(meshes, py, px):
    return make_device_mesh2d(py, px, ranks=meshes[py * px])


def shifts(comm, grid):
    """Both axes' shifts of this rank's seeded [2, 3, 4] block (a rank
    command, imported by name on the ranks)."""
    x = torch.as_tensor(np.random.default_rng(7 + comm.rank).normal(size=(2, 3, 4)))
    out = {}
    for axis in (0, 1):
        edge = (slice(None), slice(-1, None)) if axis == 0 else (slice(None), slice(None), slice(-1, None))
        first = (slice(None), slice(0, 1)) if axis == 0 else (slice(None), slice(None), slice(0, 1))
        a, b = comm.ppermute_shift(x[edge], x[first], grid, axis=axis)
        out[axis] = (a.numpy(), b.numpy())
    return out


def tile_operator(comm, key):
    """The rank's tile operator, interior of the window, as f64 numpy
    [6, 6, 9, ly, lx] (a rank command)."""
    st = comm.state[key]
    return st.vals.view(6, 6, 9, st.h, st.wd)[..., 1:-1, 1:-1].to(torch.float64).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_2d_grid_matches_jax(meshes, name):
    et, n, py, px = CASES[name]
    jmesh, forces = _plate(et, n)
    js = jg.Sharded2DGridSystem(jmesh, JMAT, jg.make_device_mesh2d(py, px), dtype=jnp.float64, chunk=256)
    uj = np.asarray(js.solve(forces))
    system = Sharded2DGridSystem(mesh_from_jax(jmesh), TMAT, _grid(meshes, py, px), dtype=torch.float64,
                                 chunk=256)
    u = system.solve(forces)
    assert (system.ly, system.lx) == (js.ly, js.lx)
    assert u.dtype == np.float64 and system.last_residual < 1e-10
    assert np.abs(u - uj).max() <= 1e-12 * np.abs(uj).max()
    assert abs(system.last_iters - js.last_iters) <= 0.01 * js.last_iters, (system.last_iters, js.last_iters)


def test_2d_grid_df_system(meshes):
    jmesh, forces = _plate("q", 20)
    js = jg.Sharded2DGridDFSystem(jmesh, JMAT, jg.make_device_mesh2d(2, 2), chunk=256)
    uj = np.asarray(js.solve(forces, rtol=1e-9, maxiter=20000))
    mesh = mesh_from_jax(jmesh)
    dm = _grid(meshes, 2, 2)
    f64 = Sharded2DGridSystem(mesh, TMAT, dm, dtype=torch.float64, chunk=256)
    df = Sharded2DGridDFSystem(mesh, TMAT, dm, chunk=256)
    u64 = f64.solve(forces, rtol=1e-9, maxiter=20000)
    u = df.solve(forces, rtol=1e-9, maxiter=20000)
    assert np.array_equal(u, u64) and df.last_iters == f64.last_iters
    assert df.last_residual < 1e-9
    assert np.abs(u - uj).max() < 1e-4 * np.abs(uj).max()


@pytest.mark.parametrize("grid", [(2, 2), (1, 2), (2, 1)], ids=["2x2", "1x2", "2x1"])
def test_shift_exchange_matches_numpy(meshes, grid):
    py, px = grid
    out = meshes[py * px].run(shifts, [grid] * (py * px))
    blocks = np.stack([np.random.default_rng(7 + r).normal(size=(2, 3, 4)) for r in range(py * px)])
    blocks = blocks.reshape(py, px, 2, 3, 4)
    for r, got in enumerate(out):
        iy, ix = divmod(r, px)
        up, down = blocks[(iy - 1) % py, ix], blocks[(iy + 1) % py, ix]
        left, right = blocks[iy, (ix - 1) % px], blocks[iy, (ix + 1) % px]
        assert np.array_equal(got[0][0], up[:, -1:]) and np.array_equal(got[0][1], down[:, :1])
        assert np.array_equal(got[1][0], left[:, :, -1:]) and np.array_equal(got[1][1], right[:, :, :1])


@pytest.mark.parametrize("et", ["q", "t"])
def test_tiles_match_single_device_operator(meshes, et):
    jmesh, _ = _plate(et, 20)
    mesh = mesh_from_jax(jmesh)
    system = Sharded2DGridSystem(mesh, TMAT, _grid(meshes, 2, 2), dtype=torch.float64, chunk=256)
    tiles = meshes[4].run(tile_operator, [system.key] * 4)
    full = system._untile([t.reshape(36 * 9, system.ly, system.lx) for t in tiles])  # [324, nyt, nxt]
    nyp, nxp = system.grid.nyp, system.grid.nxp
    full = full.reshape(36, 9, system.nyt, system.nxt)[:, :, :nyp, :nxp].reshape(36, 9, nyp * nxp)
    ref = LargeShellSystem(mesh, TMAT, device="cpu").assemble().numpy()  # [36, K, Npad]
    offsets = list(LargeShellSystem(mesh, TMAT, device="cpu").offsets)
    scale = np.abs(ref).max()
    for s, (dy, dx) in enumerate(SLOTS):
        o = dy * nxp + dx
        if o in offsets:
            want = ref[:, offsets.index(o), :nyp * nxp]
        else:  # a tri grid's two empty slots
            want = np.zeros_like(full[:, s])
        assert np.abs(full[:, s] - want).max() <= 1e-13 * scale, (s, dy, dx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_window_product_matches_slot_loop(meshes, dtype):
    jmesh, _ = _plate("t", 20)
    system = Sharded2DGridSystem(mesh_from_jax(jmesh), TMAT, _grid(meshes, 2, 2), dtype=dtype, chunk=256)
    for chk in meshes[4].run(check_spmv_tile, [(system.key, 3, 1)] * 4):
        gate = 1e-14 if dtype == torch.float64 else 1e-6
        assert chk["max_abs_err"] <= gate * chk["max_abs_y"], chk
        assert chk["tile"] == [11, 11] and chk["shape"] == [36, 9, 13 * 13]


def test_value_errors(meshes):
    from fem_shell_tpu_torch.data import test_a as A
    from fem_shell_tpu_torch.mesh import ShellMesh

    ne = A.TRIS.shape[0]
    tris = ShellMesh(A.COORDS, np.full(ne, 3, np.int32), np.hstack([A.TRIS, np.full((ne, 1), -1, np.int32)]),
                     A.BOUNDARY_SIDES)
    with pytest.raises(ValueError, match="structured grid"):
        Sharded2DGridSystem(tris, TMAT, _grid(meshes, 2, 2))
    jmesh, _ = _plate("q", 1)  # 2 x 2 nodes: tiles of 1 x 1
    with pytest.raises(ValueError, match="tiles too small"):
        Sharded2DGridSystem(mesh_from_jax(jmesh), TMAT, _grid(meshes, 2, 2))
    meshes[2].grid2d = None
    with pytest.raises(ValueError, match="must have axes"):
        Sharded2DGridSystem(mesh_from_jax(jmesh), TMAT, meshes[2])
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_device_mesh2d(2, 2, ranks=meshes[2])


def test_rounded_system_matches_f32_build(meshes):
    jmesh, forces = _plate("q", 20)
    mesh = mesh_from_jax(jmesh)
    dm = _grid(meshes, 2, 2)
    built = Sharded2DGridSystem(mesh, TMAT, dm, dtype=torch.float32, chunk=256)
    rounded = Sharded2DGridSystem(mesh, TMAT, dm, dtype=torch.float64, chunk=256).rounded(torch.float32)
    u, u_r = built.solve(forces, rtol=1e-5), rounded.solve(forces, rtol=1e-5)
    assert u.dtype == np.float32 and np.array_equal(u, u_r) and built.last_iters == rounded.last_iters

"""Port parity: smoothed-aggregation AMG (fem_shell_tpu_torch/amg.py)
against the JAX package's fem_shell_tpu/amg.py, on the CPU.

- Set-up: from the JAX fine level of a randomly renumbered 24x24 plate,
  the port's strength graph, aggregates, tentative P, smoothed P and RAP
  (a copy of the JAX numpy code) give the JAX hierarchy exactly; the
  port's own fine level (assembled by LargeShellSystem) is within 1e-13 of
  max|A| of JAX's and aggregates the same way.
- Cycle: ``convert.amg_from_jax`` carries the JAX host levels over; one W
  and one V cycle on a seeded vector within 1e-12 of max|z| of the JAX
  cycles (f64; restriction by a gather table here, a scatter-add there).
- Solves on a renumbered 40x40 plate (tests/test_amg.py): ``solve`` in
  JAX's iteration count and within 1e-9 of max|u| of ShellSystem;
  ``df=True`` with the f32 cycle, ``solve_df`` and ``solve_df_refined``
  within 1e-8; the Test-E I-beam refined twice within 1e-7 of
  ShellSystem (tests/test_amg.py:36-55).
- Stencil mode (the I-beam refined once keeps constant offsets after RCM):
  the port takes node 0's offset-0 slot as its self slot, where the JAX
  first-match rule takes a clipped zero block (ROADMAP.md "Differences");
  with that slot moved first, the JAX set-up gives the port's hierarchy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu import amg as jamg
from fem_shell_tpu.data import test_e as JE
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import permute_nodes as jpermute, refine_uniform as jrefine
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu_torch import ShellSystem, amg as tamg
from fem_shell_tpu_torch.convert import amg_from_jax, material_from_jax, mesh_from_jax

from helpers import mesh_from_tris

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
_CACHE = {}


def _plate(n, seed):
    jmesh, rows, fac = jgenerate(JParams("q", n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    perm = np.random.default_rng(seed).permutation(jmesh.n_nodes)
    return jpermute(jmesh, perm), (rows * fac)[perm]


def _small():
    if "small" not in _CACHE:
        jmesh, forces = _plate(24, 0)
        _CACHE["small"] = (jmesh, forces, jamg.AMGShellSystem(jmesh, JMAT))
    return _CACHE["small"]


def _solve40():
    if "solve40" not in _CACHE:
        jmesh, forces = _plate(40, 5)
        ja = jamg.AMGShellSystem(jmesh, JMAT)
        ja.solve(forces, rtol=1e-10)
        ref = ShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu").solve(forces, rtol=1e-13).numpy()
        _CACHE["solve40"] = (jmesh, forces, int(ja.last_iters), ref)
    return _CACHE["solve40"]


def test_setup_from_the_jax_fine_level_is_the_jax_hierarchy():
    _, _, ja = _small()
    # the JAX arrays as they are: numpy's batched matmul rounds by memory
    # layout, and the JAX fine blocks are a transposed view
    lvl = tamg._HostLevel(ja.h_levels[0].adj, ja.h_levels[0].blocks, ja.h_levels[0].n)
    null = tamg._rigid_modes(np.asarray(ja.sys.mesh.coords, np.float64))
    for li, (jpcol, jpblk, jn) in enumerate(ja.transfers):
        nbrs = tamg._strong_graph(lvl, 0.06)
        agg, n_agg = tamg.aggregate(lvl.adj, lvl.n, nbrs)
        p0, null = tamg._tentative(null, agg, n_agg)
        inv_diag = tamg._block_inv_diag(lvl)
        lam = tamg._lam_max(lvl, inv_diag)
        pcol, pblk = tamg._smooth_p(lvl, p0, agg, (4.0 / 3.0) / max(lam, 1e-30), inv_diag)
        assert n_agg == jn
        np.testing.assert_array_equal(pcol, jpcol)
        np.testing.assert_array_equal(pblk, jpblk)
        lvl = tamg._rap(lvl, pcol, pblk, n_agg)
        jl = ja.h_levels[li + 1]
        np.testing.assert_array_equal(lvl.adj, jl.adj)
        np.testing.assert_array_equal(lvl.blocks, jl.blocks)
    assert len(ja.transfers) >= 1


def test_port_fine_level_and_aggregates_match_jax():
    jmesh, _, ja = _small()
    ta = tamg.AMGShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu")
    j0, t0 = ja.h_levels[0], ta.h_levels[0]
    np.testing.assert_array_equal(t0.adj, j0.adj)
    assert np.abs(t0.blocks - j0.blocks).max() <= 1e-13 * np.abs(j0.blocks).max()
    assert [l.n for l in ta.h_levels] == [l.n for l in ja.h_levels]
    for (tp, _, _), (jp, _, _) in zip(ta.transfers, ja.transfers):
        np.testing.assert_array_equal(tp, jp)
    assert set(ta.setup_timings) == {"assemble", "strong", "aggregate", "tentative", "smooth_p", "rap",
                                     "upload", "total"}


@pytest.mark.parametrize("cycle", ["W", "V"])
def test_cycle_on_the_jax_hierarchy_matches_jax(cycle):
    _, _, ja = _small()
    levels = amg_from_jax(ja, device="cpu")
    assert levels[-1].chol is not None and levels[0].rsrc is not None
    b = np.random.default_rng(9).normal(size=(ja.h_levels[0].n, 6))
    saved = ja.cycle
    try:
        ja.cycle = cycle
        want = np.asarray(ja._vcycle(ja.levels, 0, jnp.asarray(b)))
    finally:
        ja.cycle = saved
    got = tamg.amg_cycle(levels, torch.from_numpy(b), ja.nu_smooth, cycle).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    for tl, jl in zip(levels, ja.levels):
        assert tl.omega == jl.omega


def test_restriction_table_is_p_transpose():
    _, _, ja = _small()
    pcol, pblk, nc = ja.transfers[0]
    table = tamg.restriction_table(pcol, pblk, nc)
    r = np.random.default_rng(2).normal(size=(pcol.shape[0], 6))
    contrib = np.einsum("npab,na->npb", pblk, r).reshape(-1, 6)
    want = np.zeros((nc, 6))
    np.add.at(want, pcol.reshape(-1), contrib)
    got = np.concatenate([contrib, np.zeros((1, 6))])[table].sum(axis=1)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_solve_matches_jax_iterations_and_shellsystem():
    jmesh, forces, jit, ref = _solve40()
    ta = tamg.AMGShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu")
    u = ta.solve(forces, rtol=1e-10)
    assert ta.last_iters == jit and ta.last_residual <= 1e-10
    assert u.dtype == torch.float64 and np.abs(u.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    assert torch.equal(ta.solve(forces, rtol=1e-10), u)


def test_df_solves_with_the_f32_cycle():
    jmesh, forces, _, ref = _solve40()
    ta = tamg.AMGShellSystem(mesh_from_jax(jmesh), TMAT, dtype=torch.float32, df=True, device="cpu")
    assert ta.levels[0].blocks.dtype == torch.float32 and ta.levels[-1].chol.dtype == torch.float64
    scale = np.abs(ref).max()
    u = ta.solve_df(forces, rtol=1e-10, maxiter=400).numpy()
    assert ta.last_residual <= 1e-10 and ta.last_iters < 60
    assert np.abs(u - ref).max() <= 1e-8 * scale
    u = ta.solve_df_refined(forces, rtol=1e-11, inner_rtol=1e-6).numpy()
    assert ta.refine_history[-1] < 1e-11 and np.abs(u - ref).max() <= 1e-8 * scale
    with pytest.raises(ValueError, match="df=True"):
        tamg.AMGShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu").solve_df(forces)


def test_refined_ibeam():
    mat = JMaterial(nu=0.25, em=10000, thickness=0.25)
    fine = jrefine(mesh_from_tris(JE.COORDS, JE.TRIS, JE.BOUNDARY_SIDES), 2)
    f = np.zeros((fine.n_nodes, 6))
    f[: JE.COORDS.shape[0]] = JE.FORCES
    tmesh = mesh_from_jax(fine)
    ta = tamg.AMGShellSystem(tmesh, material_from_jax(mat), device="cpu")
    u = ta.solve(f, rtol=1e-10, maxiter=300).numpy()
    assert ta.last_residual < 1e-10 and ta.last_iters < 120
    ref = ShellSystem(tmesh, material_from_jax(mat), device="cpu").solve(f).numpy()
    assert np.abs(u - ref).max() <= 1e-7 * np.abs(ref).max()


def test_stencil_mode_self_slot_against_jax():
    mat = material_from_jax(JMaterial(nu=0.25, em=10000, thickness=0.25))
    mesh = mesh_from_jax(jrefine(mesh_from_tris(JE.COORDS, JE.TRIS, JE.BOUNDARY_SIDES), 1))
    ta = tamg.AMGShellSystem(mesh, mat, coarse_max=50, device="cpu")
    l0, offsets = ta.h_levels[0], ta.sys.offsets
    k0 = int(np.searchsorted(offsets, 0))
    # stencil mode, and node 0's clipped negative offsets repeat its id before slot k0
    assert offsets is not None and (l0.adj[0, :k0] == 0).any() and len(ta.h_levels) >= 2
    assert not ta.sys.mesh.dirichlet_mask()[0].all()
    inv0 = np.linalg.inv(l0.blocks[0, k0])
    assert np.abs(ta.levels[0].inv_diag[0].numpy() - inv0).max() <= 1e-13 * np.abs(inv0).max()
    # the JAX rule on the same level: node 0's inverse diagonal is the identity
    jl = jamg._HostLevel(l0.adj, l0.blocks, l0.n)
    np.testing.assert_array_equal(jamg._block_inv_diag(jl)[0], np.eye(6))
    # node 0's real self slot first: the JAX set-up gives the port's
    order = np.r_[k0, np.delete(np.arange(l0.adj.shape[1]), k0)]
    adj, blocks = l0.adj.copy(), l0.blocks.copy()
    adj[0], blocks[0] = adj[0, order], blocks[0, order]
    jl = jamg._HostLevel(adj, blocks, l0.n)
    null = jamg._rigid_modes(np.asarray(ta.sys.mesh.coords, np.float64))
    agg, n_agg = jamg.aggregate(jl.adj, jl.n, jamg._strong_graph(jl, 0.06))
    p0, _ = jamg._tentative(null, agg, n_agg)
    inv_diag = jamg._block_inv_diag(jl)
    np.testing.assert_array_equal(inv_diag, tamg._block_inv_diag(l0))
    pcol, pblk = jamg._smooth_p(jl, p0, agg, (4.0 / 3.0) / jamg._lam_max(jl, inv_diag), inv_diag)
    tpcol, tpblk, tn = ta.transfers[0]
    assert n_agg == tn
    np.testing.assert_array_equal(pcol, tpcol)
    assert np.abs(pblk - tpblk).max() <= 1e-13 * np.abs(pblk).max()
    j1, t1 = jamg._rap(jl, pcol, pblk, n_agg), ta.h_levels[1]
    np.testing.assert_array_equal(j1.adj, t1.adj)
    assert np.abs(j1.blocks - t1.blocks).max() <= 1e-13 * np.abs(j1.blocks).max()
    f = np.zeros((mesh.n_nodes, 6))
    f[: JE.COORDS.shape[0]] = JE.FORCES
    u = ta.solve(f, rtol=1e-10, maxiter=300).numpy()
    ref = ShellSystem(mesh, mat, device="cpu").solve(f).numpy()
    assert ta.last_residual < 1e-10 and np.abs(u - ref).max() <= 1e-7 * np.abs(ref).max()

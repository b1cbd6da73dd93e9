"""Port parity: Galerkin coarse levels, the W and K cycles and the f64 df
cycle of fem_shell_tpu_torch.mg against the JAX package's
MultigridShellSystem, on the CPU (JAX with x64), on the Scordelis-Lo roof
(16x16 with n_levels=2, 32x32 with n_levels=3: the default coarse_max=8
leaves 16x16 a single direct level) and on flat 16x16 plates.

- ``stencil_rap``: the port's RAP of an assembled f64 fine operator equals
  the JAX ``stencil_rap`` of the same operator bit for bit (roof, quad
  plate, and a tri plate: 7 offsets in, 9 out), with zero constrained
  rows and columns and unit diagonals; a two-RAP chain at 32x32 too.
- The f64 hierarchy with auto Galerkin levels, cycles V, W, K and K with
  ``k_depth=0``: iterations within one of the JAX solve with the same
  arguments, displacements within 1e-10 of max|u|. The roof's diaphragms
  fix u_x and u_z only, so a rigid axial translation (u_y = const) is a
  null vector of every level. The port's coarsest f64 inverse is then the
  pseudo-inverse (``_coarse_inverse``); the JAX reference gets the same
  coarsest inverse, everything else as the JAX package builds it. CG
  leaves in the null vector whatever the rounding puts there (3.7e-5 of
  u_y between the two packages at 32x32 with the JAX inverse), so
  displacements are compared with their mean u_y removed.
- ``reassemble()`` repeats the solve bit for bit; rediscretized coarse
  levels stall on the roof (residual > 1e-4 after 40 iterations).
- ``df_cycle=True``: every level f64, the f64 V-cycle under the f64 CG.
  Against the JAX f64 solve with the same smoother on the same hierarchy
  (1e-10 of max|u|, iterations within one); against the JAX ``solve_df``
  with ``df_cycle=True`` at the configuration of tests/test_mg_df.py
  (roof 16x16, one level) within that test's own CPU tolerance, 5e-2: the
  JAX df arithmetic is FMA-contracted by the CPU compiler and its CG
  stalls at ~1e-2. (At 16x16 with two levels the JAX CPU df cycle ends
  400 iterations at residual 87, w 8 % off; at 32x32 one solve takes
  more than 7 minutes, so neither is a usable reference here.)
- ``solve_fused(coarse_op="galerkin")``: plates within 1e-8 of max|u| and
  one iteration of the JAX ``solve_fused(arith="f64")``. On the roof the
  JAX fused solve stalls (400 iterations, residual 5.1e-6, on the CPU),
  so the port (90 iterations, pinned) is held to the JAX f64 ``solve``.
- The pair path (``df_operator=True``, no ``df_cycle``) with Galerkin
  levels: the port RAPs in f64 and casts each level to f32, where the
  JAX package RAPs the f32 hi part (ROADMAP.md "Differences"). Its f64
  chain equals the JAX f64 ``stencil_rap`` chain bit for bit; each JAX
  f32 level equals the port's ``stencil_rap`` run in f32 on the JAX level
  above (the JAX order), lies within the f32 summation bound of the same
  RAP in f64 (81 terms at most: 81 * 2^-24 of the sum of |terms|), and
  level 1 lies within 1e-6 of max|C| of the port's. The port's
  ``solve_df`` count is pinned (67 to rtol 1e-6); the JAX one on the CPU
  runs 2000 iterations to residual 5.3 (FMA-contracted df CG).
- ``reassemble(profile=True)``: the stage names of the JAX profile, and
  the next solve unchanged.

Each JAX reference runs once per test process (``functools.lru_cache``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu import mg as jmg
from fem_shell_tpu import shells as jshells
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu_torch import mg as tmg
from fem_shell_tpu_torch import shells
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax

JROOF = jshells.SCORDELIS_LO_MATERIAL
ROOF = shells.SCORDELIS_LO_MATERIAL
JPLATE = JMaterial(nu=0.3, em=1e7, thickness=0.5)
PLATE = material_from_jax(JPLATE)
# the port's pair-path solve_df on the 32x32 roof (n_levels=3, Chebyshev,
# rtol 1e-6); the JAX one on the CPU: 2000 iterations, residual 5.3
PAIR_ITERS = 67
# the port's solve_fused on the 16x16 roof (n_levels=2, rtol 1e-9)
FUSED_ROOF_ITERS = 90


def _roof(n):
    jmesh, forces, mid = jshells.scordelis_lo(n)
    return jmesh, mesh_from_jax(jmesh), forces, mid


def _plate(et, n=16):
    jmesh, rows, fac = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z"))
    return jmesh, mesh_from_jax(jmesh), rows * fac


def _rigid_free(u):
    """u [n, 6] with its mean axial displacement removed (the roof's null
    mode, see the module docstring)."""
    u = np.array(u, dtype=np.float64, copy=True)
    u[:, 1] -= u[:, 1].mean()
    return u


def _close(u, ref, tol):
    u, ref = _rigid_free(u), _rigid_free(ref)
    return np.abs(u - ref).max() <= tol * np.abs(ref).max()


# ----------------------------------------------------------------------
# stencil_rap
# ----------------------------------------------------------------------
def _case_mesh(case):
    if case == "roof16":
        _, mesh, _, _ = _roof(16)
        return mesh, ROOF
    _, mesh, _ = _plate(case[0])
    return mesh, PLATE


def _check_bc(values, lvl):
    """Constrained rows and columns zero, unit diagonals."""
    n = lvl.nyp * lvl.nxp
    v = values.reshape(6, 6, 9, -1)[..., :n]
    free = lvl.free_t.numpy()[:, :n] > 0
    for a in range(6):
        cons = ~free[a]
        rows = v[a][:, :, cons].copy()
        rows[a, 4] -= 1.0
        assert np.abs(rows).max(initial=0.0) == 0.0
    for s, off in enumerate(lvl.offsets):
        tgt = np.arange(n) + off
        ok = (tgt >= 0) & (tgt < n)
        for b in range(6):
            cons_col = np.zeros(n, bool)
            cons_col[ok] = ~free[b][tgt[ok]]
            col = v[:, b, s][:, cons_col].copy()
            if s == 4:
                col[b] = 0.0  # the unit diagonal, checked above
            assert np.abs(col).max(initial=0.0) == 0.0


@pytest.mark.parametrize("case", ["roof16", "q16", "t16"])
def test_stencil_rap_matches_jax(case):
    mesh, mat = _case_mesh(case)
    tsys = tmg.MultigridShellSystem(mesh, mat, n_levels=2, coarse_op="galerkin", device="cpu")
    l0, l1 = tsys.levels
    assert len(l0.offsets) == (7 if case == "t16" else 9)
    assert l1.offsets == tmg.grid_rap_offsets(l1.nxp) == jmg.grid_rap_offsets(l1.nxp)
    assert all(tmg._offset_dydx(o, l0.nxp) == jmg._offset_dydx(o, l0.nxp) for o in l0.offsets)
    got = tmg.stencil_rap(l0.values, l1.free_t, l0.offsets, l0.nyp, l0.nxp, l1.npad).numpy()
    want = np.asarray(jmg.stencil_rap(jnp.asarray(l0.values.numpy()), jnp.asarray(l1.free_t.numpy()),
                                      l0.offsets, l0.nyp, l0.nxp, l1.npad))
    assert got.shape == want.shape == (36 * 9, l1.npad)
    assert np.array_equal(got, want)
    assert np.array_equal(l1.values.numpy().reshape(36 * 9, -1), want)  # the level the system built
    _check_bc(got, l1)


def test_stencil_rap_chain_matches_jax():
    _, mesh, _, _ = _roof(32)
    tsys = tmg.MultigridShellSystem(mesh, ROOF, n_levels=3, device="cpu")
    assert tsys.coarse_op == "galerkin" and tsys.cycle == "V"
    v = jnp.asarray(tsys.levels[0].values.numpy())
    for prev, lvl in zip(tsys.levels[:-1], tsys.levels[1:]):
        v = jmg.stencil_rap(v, jnp.asarray(lvl.free_t.numpy()), prev.offsets, prev.nyp, prev.nxp, lvl.npad)
        assert np.array_equal(lvl.values.numpy().reshape(36 * 9, -1), np.asarray(v))
        _check_bc(lvl.values.numpy(), lvl)


# ----------------------------------------------------------------------
# the f64 hierarchy: V, W, K cycles
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_roof32():
    """The JAX f64 hierarchy of the 32x32 roof, its coarsest inverse
    swapped for the port's (``_coarse_inverse``: the operator is singular,
    see test_singular_coarsest_operator_is_pseudo_inverted); everything
    else as the JAX package builds it."""
    jmesh, _, forces, _ = _roof(32)
    jsys = jmg.MultigridShellSystem(jmesh, JROOF, n_levels=3)
    dense = np.asarray(jmg._densify(jsys.levels[-1]), np.float64)
    jsys.levels[-1] = dataclasses.replace(jsys.levels[-1], dense_inv=jnp.asarray(tmg._coarse_inverse(dense)))
    return jsys, forces


@functools.lru_cache(maxsize=None)
def _jax_solve(cycle, k_depth, smoother):
    """The JAX f64 solve of the 32x32 roof (n_levels=3) with these
    arguments. One hierarchy serves every cycle: ``cycle``, ``k_depth``
    and ``smoother`` are read when the solve is traced, so each set gets
    a freshly traced solve."""
    jsys, forces = _jax_roof32()
    jsys.cycle, jsys.k_depth, jsys.smoother = cycle, k_depth, smoother
    jsys._solve_jit = jax.jit(jsys._solve_impl, static_argnums=(2, 3))
    u = np.asarray(jsys.solve(forces, rtol=1e-10))
    return u, int(jsys.last_cg.iters)


def _port_roof32(**kw):
    _, mesh, forces, _ = _roof(32)
    return tmg.MultigridShellSystem(mesh, ROOF, n_levels=3, device="cpu", **kw), forces


def test_galerkin_solve_matches_jax():
    ref, ref_it = _jax_solve("V", None, "jacobi")
    tsys, forces = _port_roof32()
    assert tsys.coarse_op == "galerkin" and tsys.cycle == "V"
    assert all(l.values.dtype == torch.float64 for l in tsys.levels)
    assert tsys.levels[-1].dense_inv is not None
    u = tsys.solve(forces, rtol=1e-10)
    assert abs(tsys.last_cg.iters - ref_it) <= 1 and tsys.last_cg.residual < 1e-10
    assert _close(u.numpy(), ref, 1e-10)
    tsys.reassemble()
    assert torch.equal(tsys.solve(forces, rtol=1e-10), u)


def test_singular_coarsest_operator_is_pseudo_inverted():
    """The roof's diaphragms fix u_x and u_z only: a rigid axial
    translation is a null vector of every level (P carries constants), so
    the coarsest operator is singular. ``np.linalg.inv`` (the JAX
    package's) amplifies rounding along it ~1e15-fold: on the 64x64 roof
    the port's f64 solve with it ends 600 iterations at residual 1.3e3,
    while the JAX package's, on its own rounding, converges in 75.
    ``_coarse_inverse`` drops the null eigenvalue (the pseudo-inverse),
    and leaves a regular operator's inverse as np.linalg.inv's."""
    tsys, forces = _port_roof32()
    c = tsys.levels[-1]
    dense = tmg._densify(c).numpy()
    d = 1.0 / np.sqrt(np.diag(dense))
    w = np.linalg.eigvalsh(dense * d[:, None] * d[None, :])
    assert np.sum(np.abs(w) < 1e-12 * np.abs(w).max()) == 1
    n = c.nyp * c.nxp
    rigid = np.zeros((6, n))
    rigid[1] = 1.0
    rigid = rigid.reshape(-1)
    assert np.abs(dense @ rigid).max() <= 1e-12 * np.abs(dense).max()
    # the pseudo-inverse of the scaled operator annihilates D times the
    # null vector: no coarse correction carries a rigid component
    inv, drigid = c.dense_inv.numpy(), np.diag(dense) * rigid
    assert np.abs(inv @ drigid).max() <= 1e-12 * np.abs(inv).max() * np.abs(drigid).max()
    u = tsys.solve(forces, rtol=1e-10)
    assert abs(float(u[:, 1].mean())) <= 1e-10 * float(u.abs().max())
    _, pmesh, _ = _plate("q")
    p = tmg.MultigridShellSystem(pmesh, PLATE, coarse_max=4, device="cpu").levels[-1]
    pd = tmg._densify(p).numpy()
    assert np.array_equal(tmg._coarse_inverse(pd), np.linalg.inv(pd))


def test_rediscretized_levels_stall_on_the_roof():
    _, mesh, forces, mid = _roof(16)
    good = tmg.MultigridShellSystem(mesh, ROOF, n_levels=2, coarse_op="galerkin", device="cpu")
    u = good.solve(forces, rtol=1e-10, maxiter=250)
    assert good.last_cg.iters < 160 and good.last_cg.residual < 1e-9
    np.testing.assert_allclose(float(u[mid, 2]), -0.29379, rtol=1e-4)
    bad = tmg.MultigridShellSystem(mesh, ROOF, n_levels=2, coarse_op="rediscretize", device="cpu")
    bad.solve(forces, rtol=1e-10, maxiter=40)
    assert bad.last_cg.residual > 1e-4


@pytest.mark.parametrize("cycle,k_depth", [("W", None), ("K", None), ("K", 0)])
def test_cycles_match_jax(cycle, k_depth):
    ref, ref_it = _jax_solve(cycle, k_depth, "jacobi")
    tsys, forces = _port_roof32(cycle=cycle, k_depth=k_depth)
    assert tsys.cycle == cycle and tsys.k_depth == k_depth
    u = tsys.solve(forces, rtol=1e-10)
    assert abs(tsys.last_cg.iters - ref_it) <= 1 and tsys.last_cg.residual < 1e-10
    assert _close(u.numpy(), ref, 1e-10)


# ----------------------------------------------------------------------
# df_cycle: the f64 cycle under the f64 CG
# ----------------------------------------------------------------------
def _port_df_cycle(**kw):
    return _port_roof32(dtype=torch.float32, df_operator=True, df_cycle=True, **kw)


@pytest.mark.parametrize("cycle,smoother", [("V", "chebyshev"), ("K", "jacobi")])
def test_df_cycle_matches_jax_f64_solve(cycle, smoother):
    ref, ref_it = _jax_solve(cycle, None, smoother)
    tsys, forces = _port_df_cycle(cycle=cycle, smoother=smoother)
    assert tsys._cdf is None and tsys.levels[0].values is tsys._fine64
    assert all(l.values.dtype == torch.float64 for l in tsys.levels)
    assert tsys.levels[-1].dense_inv.dtype == torch.float64
    u = tsys.solve_df(forces, rtol=1e-10, maxiter=2000)
    assert abs(tsys.last_iters - ref_it) <= 1 and tsys.last_residual < 1e-10
    assert _close(u.numpy(), ref, 1e-10)


@functools.lru_cache(maxsize=None)
def _jax_df_cycle16():
    jmesh, _, forces, mid = _roof(16)
    jsys = jmg.MultigridShellSystem(jmesh, JROOF, dtype=jnp.float32, df_operator=True, df_cycle=True,
                                    use_pallas=False, smoother="chebyshev")
    u = np.asarray(jsys.solve_df(forces, rtol=1e-6, maxiter=400))
    return u, float(jsys.last_residual), jsys.n_levels


def test_df_cycle_against_jax_df_cycle():
    ref, ref_res, ref_levels = _jax_df_cycle16()
    _, mesh, forces, mid = _roof(16)
    tsys = tmg.MultigridShellSystem(mesh, ROOF, dtype=torch.float32, df_operator=True, df_cycle=True,
                                    smoother="chebyshev", device="cpu")
    assert tsys.n_levels == ref_levels and tsys.coarse_op == "galerkin"
    u = tsys.solve_df(forces, rtol=1e-6, maxiter=400)
    assert tsys.last_residual < 1e-6 and ref_res < 5e-2
    assert abs(float(u[mid, 2]) - ref[mid, 2]) < 5e-2 * abs(ref[mid, 2])


def test_df_cycle_and_galerkin_argument_errors():
    _, mesh, _, _ = _roof(16)
    with pytest.raises(ValueError, match="df_cycle requires df_operator"):
        tmg.MultigridShellSystem(mesh, ROOF, df_cycle=True, device="cpu")
    _, pmesh, _ = _plate("q")
    with pytest.raises(ValueError, match="class_operator=True stores none"):
        tmg.MultigridShellSystem(pmesh, PLATE, dtype=torch.float32, df_operator=True, coarse_op="galerkin",
                                 class_operator=True, coarse_max=4, device="cpu")
    with pytest.raises(ValueError, match="unknown cycle"):
        tmg.MultigridShellSystem(mesh, ROOF, cycle="F", device="cpu")


# ----------------------------------------------------------------------
# solve_fused with Galerkin levels
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_fused_plate(et):
    jmesh, _, forces = _plate(et)
    jsys = jmg.MultigridShellSystem(jmesh, JPLATE, assemble=False, coarse_op="galerkin", coarse_max=4)
    u = np.asarray(jsys.solve_fused(forces, rtol=1e-9, maxiter=400, arith="f64"))
    return u, int(jsys.last_iters), jsys.n_levels


@functools.lru_cache(maxsize=None)
def _jax_roof16_solve():
    jmesh, _, forces, _ = _roof(16)
    jsys = jmg.MultigridShellSystem(jmesh, JROOF, n_levels=2)
    return np.asarray(jsys.solve(forces, rtol=1e-12))


@pytest.mark.parametrize("case", ["q16", "t16", "roof16"])
def test_solve_fused_galerkin_matches_jax(case):
    if case == "roof16":
        _, mesh, forces, _ = _roof(16)
        tsys = tmg.MultigridShellSystem(mesh, ROOF, assemble=False, n_levels=2, device="cpu")
        ref, ref_it = _jax_roof16_solve(), FUSED_ROOF_ITERS
    else:
        _, mesh, forces = _plate(case[0])
        tsys = tmg.MultigridShellSystem(mesh, PLATE, assemble=False, coarse_op="galerkin", coarse_max=4,
                                        device="cpu")
        ref, ref_it, levels = _jax_fused_plate(case[0])
        assert tsys.n_levels == levels
    assert tsys.coarse_op == "galerkin" and all(len(l.offsets) == 9 for l in tsys.levels[1:])
    u = tsys.solve_fused(forces, rtol=1e-9, maxiter=400)
    assert abs(tsys.last_iters - ref_it) <= 1 and tsys.last_residual < 1e-9
    assert _close(u.numpy(), ref, 1e-8)


# ----------------------------------------------------------------------
# the pair path with Galerkin levels
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_pair_levels():
    jmesh, _, _, _ = _roof(32)
    jsys = jmg.MultigridShellSystem(jmesh, JROOF, dtype=jnp.float32, df_operator=True, smoother="chebyshev",
                                    n_levels=3)
    assert jsys._cdf is None and jsys.coarse_op == "galerkin"
    return [np.asarray(l.values) for l in jsys.levels]


def test_pair_path_galerkin_levels():
    jvals = _jax_pair_levels()
    tsys, forces = _port_roof32(dtype=torch.float32, df_operator=True, smoother="chebyshev")
    assert tsys._cdf is None and tsys._fine64 is not None
    assert all(l.values.dtype == torch.float32 for l in tsys.levels)
    # the f64 RAP chain, and its f32 casts as the levels
    v64 = tsys._fine64
    jv64 = jnp.asarray(v64.numpy())
    for prev, lvl in zip(tsys.levels[:-1], tsys.levels[1:]):
        v64 = tmg.stencil_rap(v64, lvl.free_t, prev.offsets, prev.nyp, prev.nxp, lvl.npad)
        jv64 = jmg.stencil_rap(jv64, jnp.asarray(lvl.free_t.numpy(), jnp.float64), prev.offsets, prev.nyp,
                               prev.nxp, lvl.npad)
        assert np.array_equal(v64.numpy(), np.asarray(jv64))
        assert torch.equal(lvl.values.reshape(36 * 9, -1), v64.to(torch.float32))
    # the JAX levels: f32 RAPs of the f32 level above, in the JAX order
    for l, (prev, lvl) in enumerate(zip(tsys.levels[:-1], tsys.levels[1:]), start=1):
        src = torch.from_numpy(np.array(jvals[l - 1]).reshape(36, len(prev.offsets), -1))
        c32 = tmg.stencil_rap(src, lvl.free_t, prev.offsets, prev.nyp, prev.nxp, lvl.npad)
        assert c32.dtype == torch.float32 and np.array_equal(c32.numpy(), jvals[l])
        c64 = tmg.stencil_rap(src.double(), lvl.free_t, prev.offsets, prev.nyp, prev.nxp, lvl.npad)
        mag = tmg.stencil_rap(src.double().abs(), torch.ones_like(lvl.free_t), prev.offsets, prev.nyp,
                              prev.nxp, lvl.npad)
        assert bool(((c32.double() - c64).abs() <= 81 * 2.0**-24 * mag + 1e-300).all())
    c1, j1 = tsys.levels[1].values.numpy().reshape(36 * 9, -1), jvals[1]
    assert np.abs(c1 - j1).max() <= 1e-6 * np.abs(j1).max()
    tsys.solve_df(forces, rtol=1e-6, maxiter=2000)
    assert abs(tsys.last_iters - PAIR_ITERS) <= 1 and tsys.last_residual <= 1e-6


# ----------------------------------------------------------------------
# reassemble(profile=True)
# ----------------------------------------------------------------------
def test_reassemble_profile_keys_and_solve_unchanged(capsys):
    _, mesh, forces, _ = _roof(16)
    tsys = tmg.MultigridShellSystem(mesh, ROOF, n_levels=2, device="cpu")
    u = tsys.solve(forces, rtol=1e-10)
    tsys.reassemble(profile=True)
    names = [n for n, _ in tsys.rebuild_profile]
    assert names == ["L0/assemble", "L0/inv_diag", "L0/omega", "L1/rap", "L1/inv_diag", "coarse/factor",
                     "fine/sym"]
    assert all(s >= 0.0 for _, s in tsys.rebuild_profile)
    assert "rebuild-prof TOTAL" in capsys.readouterr().out
    assert torch.equal(tsys.solve(forces, rtol=1e-10), u)


def test_reassemble_profile_on_the_class_path():
    _, mesh, forces = _plate("t", 12)
    tsys = tmg.MultigridShellSystem(mesh, PLATE, dtype=torch.float32, df_operator=True, smoother="chebyshev",
                                    coarse_max=4, device="cpu")
    assert tsys._cdf is not None
    x = tsys.solve_df(forces, rtol=1e-9, return_device=True)
    tsys.reassemble(profile=True)
    names = [n for n, _ in tsys.rebuild_profile]
    assert names == ["  class/grid_detect", "  class/ideal_check", "  class/mask_check",
                     "  class/patch_ld_assembly", "  class/table_extract", "  class/class_parts",
                     "class/build+upload", "class/inv_diag", "class/omega", "L1/assemble", "L1/inv_diag",
                     "coarse/factor", "fine/sym"]
    assert torch.equal(tsys.solve_df(forces, rtol=1e-9, return_device=True), x)
